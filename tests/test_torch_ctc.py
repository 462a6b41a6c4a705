"""The port's CTC (``ops/ctc.py`` and ``ops/kernels/ctc.py``) against the
JAX package's, on the same numpy inputs.

The port's plain loop (autograd gives its gradient) and the fused
Function's twin (the hand-derived gradient) are held against JAX
``ctc_loss`` (the scan) and ``ctc_loss_fused(impl="kernel",
interpret=True)`` (the Pallas kernel run as the JAX package's own tests
run it), in both ``normalize`` modes, with ragged input lengths, a
zero-length label and an infeasible row.

Tolerances (f32 round-off: the hand gradient against autodiff of the
scan, another order of the log-adds; measured on the CPU in brackets):
losses rtol 1e-5 [2.1e-7], gradients rtol 1e-4 and atol 1e-5 [4.6e-6
abs]; the tables and the greedy decode equal bit for bit; the float64
``gradcheck`` at its defaults."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax
from paddle_tpu.ops import ctc as jctc
from paddle_tpu_torch.ops import ctc as tctc
from paddle_tpu_torch.ops.kernels import ctc as KC

JK = importlib.import_module("paddle_tpu.ops.pallas.ctc")


def inputs(b, t=12, v=7, l=5, seed=0):
    """Logits [B, T, V], labels [B, L] (blank = V-1 never drawn), ragged
    input and label lengths.  With b >= 3, row 1 has a zero-length label
    and row 2 is infeasible (3 distinct labels in 2 frames)."""
    rng = np.random.default_rng(seed + b)
    logits = rng.normal(size=(b, t, v)).astype(np.float32)
    labels = rng.integers(0, v - 1, size=(b, l)).astype(np.int32)
    llen = rng.integers(1, l + 1, size=b).astype(np.int32)
    ilen = rng.integers(2 * l + 1, t + 1, size=b).astype(np.int32)
    ilen[0] = t
    labels[0, 1] = labels[0, 0]                  # a repeat: no skip there
    if b >= 3:
        llen[1] = 0
        labels[2, :3] = [0, 1, 2]
        llen[2], ilen[2] = 3, 2
    return logits, labels, ilen, llen


def jax_loss_and_grad(fn, x, *rest):
    xs = jnp.asarray(x)
    args = [jnp.asarray(a) for a in rest]
    loss = fn(xs, *args)
    # the sentinel rows carry no gradient; sum the finite ones
    grad = jax.grad(lambda a: jnp.sum(jnp.where(
        loss < 1e29, fn(a, *args), 0.0)))(xs)
    return np.asarray(loss), np.asarray(grad)


def torch_loss_and_grad(fn, x, *rest):
    xt = torch.tensor(x, requires_grad=True)
    loss = fn(xt, *(torch.tensor(a) for a in rest))
    (grad,) = torch.autograd.grad(loss[loss < 1e29].sum(), (xt,))
    return loss.detach().numpy(), grad.numpy()


@pytest.mark.parametrize("b", [1, 3, 6, 16])
@pytest.mark.parametrize("normalize", [False, True])
def test_ctc_loss_matches_jax(b, normalize):
    logits, labels, ilen, llen = inputs(b)
    x = logits if normalize else np.asarray(
        jax.nn.log_softmax(jnp.asarray(logits), -1))
    blank = logits.shape[-1] - 1
    j_fused = jax_loss_and_grad(
        lambda a, il, lb, ll: JK.ctc_loss_fused(
            a, il, lb, ll, blank=blank, normalize=normalize, impl="kernel",
            interpret=True), x, ilen, labels, llen)
    j_scan = jax_loss_and_grad(
        lambda a, il, lb, ll: JK.ctc_loss_fused_reference(
            a, il, lb, ll, blank=blank, normalize=normalize),
        x, ilen, labels, llen)
    t_fused = torch_loss_and_grad(
        lambda a, il, lb, ll: KC.ctc_loss_fused(
            a, il, lb, ll, blank=blank, normalize=normalize),
        x, ilen, labels, llen)
    t_scan = torch_loss_and_grad(
        lambda a, il, lb, ll: KC.ctc_loss_fused_reference(
            a, il, lb, ll, blank=blank, normalize=normalize),
        x, ilen, labels, llen)
    for got in (t_fused, t_scan):
        for want in (j_fused, j_scan):
            np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
            np.testing.assert_allclose(got[1], want[1], rtol=1e-4,
                                       atol=1e-5)


def test_infeasible_row_pins_at_the_sentinel_with_zero_gradient():
    """A zero-length label is the pure-blank path; 3 distinct labels in 2
    frames are infeasible: the loss is float32(1e30) and the row's
    gradient exactly zero, on both of the port's paths, as in JAX."""
    logits, labels, ilen, llen = inputs(3)
    x = torch.log_softmax(torch.tensor(logits), -1)
    for fn in (KC.ctc_loss_fused, KC.ctc_loss_fused_reference):
        xt = x.clone().requires_grad_()
        loss = fn(xt, torch.tensor(ilen), torch.tensor(labels),
                  torch.tensor(llen), blank=6)
        (grad,) = torch.autograd.grad(loss.sum(), (xt,))
        assert loss[2].item() == np.float32(1e30)
        assert torch.count_nonzero(grad[2]) == 0
        assert torch.count_nonzero(grad[1]) > 0
        # the pure-blank path of row 1
        blank_ll = x[1, :ilen[1], 6].sum()
        assert torch.allclose(loss[1], -blank_ll, rtol=1e-6)
        # frames past a row's input length get no gradient
        assert torch.count_nonzero(grad[1, ilen[1]:]) == 0


def test_ctc_tables_equal_jax_on_bucket_padded_labels():
    """Labels of 2..6 bucketed to a 16-slot (S = 33) by the feeder, as the
    CRNN's trainer feeds them: the same tables; ``llen``, not L, bounds
    the valid span."""
    from paddle_tpu.reader.feeder import DataFeeder as JFeeder
    from paddle_tpu_torch.layers.data_type import integer_value_sequence
    from paddle_tpu_torch.reader.feeder import DataFeeder as TFeeder

    JD = importlib.import_module("paddle_tpu.layers.data_type")
    rng = np.random.default_rng(3)
    batch = [(list(rng.integers(0, 26, size=n)),) for n in (5, 2, 6, 5, 3)]
    tfeed = TFeeder({"label": integer_value_sequence(26)}, device="cpu")(batch)
    jfeed = JFeeder({"label": JD.integer_value_sequence(26)})(batch)
    assert tfeed["label"].max_len == 16
    for blank in (0, 26):
        got = tctc.ctc_tables(tfeed["label"].data, tfeed["label"].length,
                              blank)
        want = jctc.ctc_tables(jfeed["label"].data, jfeed["label"].length,
                               blank)
        assert got[0].shape == (5, 33)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("blank", ["first", "last"])
def test_greedy_decode_equals_jax_bit_for_bit(blank):
    """Ties (small integer scores), repeats and ragged lengths, through the
    fused decode's twin and the reference, against JAX's fused decode
    (interpret) and reference."""
    rng = np.random.default_rng(9)
    b, t, v = 6, 20, 5
    x = rng.integers(0, 3, size=(b, t, v)).astype(np.float32)
    ilen = rng.integers(0, t + 1, size=b).astype(np.int32)
    blank = 0 if blank == "first" else v - 1
    want = JK.ctc_greedy_decode_fused(jnp.asarray(x), jnp.asarray(ilen),
                                      blank=blank, impl="kernel",
                                      interpret=True)
    want_ref = jctc.ctc_greedy_decode(jnp.asarray(x), jnp.asarray(ilen),
                                      blank)
    for fn in (KC.ctc_greedy_decode_fused, KC.ctc_greedy_decode_fused_reference):
        got = fn(torch.tensor(x), torch.tensor(ilen), blank)
        for g, w, r in zip(got, want, want_ref):
            assert g.dtype == torch.int32
            assert np.array_equal(g.numpy(), np.asarray(w))
            assert np.array_equal(g.numpy(), np.asarray(r))


def decode_case(case, blank_at, seed=21):
    """Scores [B, T, V] of small integers (many ties and repeats), ragged
    int32 lengths with a zero-length and a full row, and the blank index
    (``blank_at``: "first" or "last"); ``all_blank``: rows 1 and 2 have
    the blank win every frame."""
    b, t, v = {"v37": (5, 40, 37), "v100_t300": (3, 300, 100),
               "all_blank": (4, 33, 37), "t1": (3, 1, 5)}[case]
    rng = np.random.default_rng(seed + b + t + v)
    x = rng.integers(0, 3, size=(b, t, v)).astype(np.float32)
    ilen = rng.integers(0, t + 1, size=b).astype(np.int32)
    ilen[0], ilen[-1] = t, 0
    blank = 0 if blank_at == "first" else v - 1
    if case == "all_blank":
        x[1:3, :, blank] = 3.0
    return x, ilen, blank


@pytest.mark.parametrize("case", ["v37", "v100_t300", "all_blank", "t1"])
@pytest.mark.parametrize("blank_at", ["first", "last"])
def test_greedy_decode_cases_equal_jax_bit_for_bit(case, blank_at):
    """The fused decode's CPU twin (``_decode_plain`` then
    ``compact_decoded``, the contract the card's one-launch kernel is held
    to) against JAX's fused decode (interpret) and reference, bit for bit:
    V wider than one 32-lane run (37, 100), T 300 (past the kernel's
    256-frame chunk), zero-length and all-blank rows, blank first and
    last, ties and repeats throughout."""
    x, ilen, blank = decode_case(case, blank_at)
    want = JK.ctc_greedy_decode_fused(jnp.asarray(x), jnp.asarray(ilen),
                                      blank=blank, impl="kernel",
                                      interpret=True)
    want_ref = jctc.ctc_greedy_decode(jnp.asarray(x), jnp.asarray(ilen),
                                      blank)
    got = KC.ctc_greedy_decode_fused(torch.tensor(x), torch.tensor(ilen),
                                     blank)
    for g, w, r in zip(got, want, want_ref):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert np.array_equal(g.numpy(), np.asarray(r))
    if case == "all_blank":
        assert got[1][1:3].tolist() == [0, 0]
        assert (got[0][1:3] == -1).all()


@pytest.mark.parametrize("normalize", [False, True])
def test_float64_gradcheck(normalize):
    logits, labels, ilen, llen = inputs(3, t=8, v=5, l=3)
    x = torch.tensor(logits, dtype=torch.float64)
    if not normalize:
        x = torch.log_softmax(x, -1)
    x.requires_grad_()
    keep = torch.tensor([True, True, False])     # the sentinel row is flat

    def loss(a):
        return KC.ctc_loss_fused(a, torch.tensor(ilen), torch.tensor(labels),
                                 torch.tensor(llen), blank=4,
                                 normalize=normalize)[keep]

    assert torch.autograd.gradcheck(loss, (x,))


@pytest.mark.parametrize("norm_by_times", [False, True])
def test_ctc_layer_matches_jax(norm_by_times):
    """``layer.ctc`` over softmax probabilities (blank = size - 1) in both
    packages: the cost and its gradient by the probabilities."""
    import paddle_tpu as jpaddle
    import paddle_tpu_torch as tpaddle
    from paddle_tpu.core.lod import SequenceBatch as JSeq
    from paddle_tpu.layers import extras as jextras
    from paddle_tpu.layers.base import reset_name_counters as jax_reset
    from paddle_tpu_torch.core.lod import SequenceBatch as TSeq
    from paddle_tpu_torch.layers import extras as textras
    from paddle_tpu_torch.layers.base import reset_name_counters

    logits, labels, ilen, llen = inputs(6, l=4)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    costs = []
    for pkg, ex, seq, reset in (
            (jpaddle, jextras, JSeq, jax_reset),
            (tpaddle, textras, TSeq, reset_name_counters)):
        reset()
        D = importlib.import_module(pkg.__name__ + ".layers.data_type")
        p = pkg.layer.data(name="p", type=D.dense_vector_sequence(7))
        y = pkg.layer.data(name="y", type=D.integer_value_sequence(6))
        costs.append((ex.ctc(input=p, label=y, size=7,
                             norm_by_times=norm_by_times), seq))
    (jc, JS), (tc, TS) = costs
    keep = np.ones(6, bool)
    keep[2] = False                          # the sentinel row
    probs, ilen, labels, llen = (a[keep] for a in (probs, ilen, labels, llen))

    def jcost(pr):
        return jc.fn(None, {}, {}, JS(pr, jnp.asarray(ilen)),
                     JS(jnp.asarray(labels), jnp.asarray(llen)))

    jval, jgrad = jax.value_and_grad(jcost)(jnp.asarray(probs))
    pt = torch.tensor(probs, requires_grad=True)
    tval = tc.fn(None, {}, {}, TS(pt, torch.tensor(ilen)),
                 TS(torch.tensor(labels), torch.tensor(llen)))
    (tgrad,) = torch.autograd.grad(tval, (pt,))
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-5)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-4,
                               atol=1e-5)
    assert tc.attrs == jc.attrs == {"blank": 6,
                                    "norm_by_times": norm_by_times}

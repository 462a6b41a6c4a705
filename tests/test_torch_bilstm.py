"""The port's fused-input BiLSTM (``ops/kernels/lstm.bilstm_seq``, its
plain twin on the CPU, and ``layer.bilstm``) against the JAX package's
``bilstm_seq`` (the Pallas kernel in interpret mode, as the JAX
package's own tests run it) and ``bilstm_seq_reference``, on the same
numpy inputs: hs_f, hs_b, (h_T, c_T) of both directions and the gradient
of every input, with ragged lengths and nonzero peepholes and initial
states.

The port's Function always recomputes the gates in its backward (remat,
as the JAX package's TPU branch runs); it is held against the JAX kernel
in both of its remat forms, and against the ``lstm_seq`` Function run
per direction over the projected input.

Tolerances (f32 round-off of another summation order over at most 9
steps; measured on the CPU in brackets): 2e-5 absolute [1.4e-6]; the
per-direction ``lstm_seq`` composition equal bit for bit; the float64
``gradcheck`` at its defaults."""

import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.config.topology import Topology as JTopology
from paddle_tpu.layers.base import reset_name_counters as jax_reset
from paddle_tpu_torch.config.topology import Topology as TTopology
from paddle_tpu_torch.layers.base import reset_name_counters
from paddle_tpu_torch.ops.kernels import lstm as LK

JL = importlib.import_module("paddle_tpu.ops.pallas.lstm")
TOL = 2e-5
E = 16


def inputs(b, t, d, seed=0):
    """x, mask (ragged lengths, row 0 full) and, per direction, w_x, b,
    w_h, peep; then h0/c0 of both directions; and output cotangents."""
    rng = np.random.default_rng(seed + 13 * b + t + d)
    f = lambda *s, k=0.5: (k * rng.normal(size=s)).astype(np.float32)  # noqa
    lens = rng.integers(1, t + 1, size=b)
    lens[0] = t
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    per_dir = lambda: [f(E, 4 * d, k=E ** -0.5), f(4 * d, k=0.1),  # noqa
                       f(d, 4 * d, k=d ** -0.5), f(3, d, k=0.3)]
    args = ([f(b, t, E), mask] + per_dir() + per_dir()
            + [f(b, d) for _ in range(4)])
    cts = [f(b, t, d, k=1.0), f(b, t, d, k=1.0)] + [f(b, d, k=1.0)
                                                    for _ in range(4)]
    return args, cts


def jax_outs_and_grads(fn, args, cts):
    grad_idx = [i for i in range(len(args)) if i != 1]

    def loss(*diff):
        full = list(args)
        for i, v in zip(grad_idx, diff):
            full[i] = v
        hf, hb, (htf, ctf), (htb, ctb) = fn(*map(jnp.asarray, full))
        outs = (hf, hb, htf, ctf, htb, ctb)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cts)), outs

    (_, outs), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(grad_idx))), has_aux=True)(
            *(jnp.asarray(args[i]) for i in grad_idx))
    return [np.asarray(o) for o in outs] + [np.asarray(g) for g in grads]


def torch_outs_and_grads(fn, args, cts):
    leaves = [torch.tensor(a, requires_grad=i != 1)
              for i, a in enumerate(args)]
    hf, hb, (htf, ctf), (htb, ctb) = fn(*leaves)
    outs = (hf, hb, htf, ctf, htb, ctb)
    loss = sum((o * torch.tensor(c)).sum() for o, c in zip(outs, cts))
    grads = torch.autograd.grad(loss, [v for i, v in enumerate(leaves)
                                       if i != 1])
    return [o.detach().numpy() for o in outs] + [g.numpy() for g in grads]


@pytest.mark.parametrize("b,t,d", [(3, 7, 8), (5, 9, 32)])
@pytest.mark.parametrize("jax_remat", [True, False])
def test_bilstm_seq_matches_jax(b, t, d, jax_remat):
    args, cts = inputs(b, t, d)
    want_kernel = jax_outs_and_grads(
        lambda *a: JL.bilstm_seq(*a, interpret=True, remat=jax_remat), args,
        cts)
    want_ref = jax_outs_and_grads(JL.bilstm_seq_reference, args, cts)
    got = torch_outs_and_grads(LK.bilstm_seq, args, cts)
    got_ref = torch_outs_and_grads(LK.bilstm_seq_reference, args, cts)
    assert len(got) == 6 + 13
    for g, gr, wk, wr in zip(got, got_ref, want_kernel, want_ref):
        for w in (wk, wr):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
        np.testing.assert_allclose(gr, wr, atol=TOL, rtol=0)


def _two_lstm_seq_runs(x, mask, w_x_f, b_f, w_h_f, peep_f, w_x_b, b_b,
                       w_h_b, peep_b, h0f, c0f, h0b, c0b):
    """Each direction as the ``lstm_seq`` Function (remat on) over the
    projection ``x @ W_x + b``."""
    hs_f, last_f = LK.lstm_seq(LK._project_xw(x, w_x_f, b_f), mask, w_h_f,
                               peep_f, h0f, c0f, reverse=False, remat=True)
    hs_b, last_b = LK.lstm_seq(LK._project_xw(x, w_x_b, b_b), mask, w_h_b,
                               peep_b, h0b, c0b, reverse=True, remat=True)
    return hs_f, hs_b, last_f, last_b


def test_bilstm_seq_equals_two_lstm_seq_runs():
    """On the CPU the BiLSTM Function is the two directions of the
    ``lstm_seq`` Function over the projected input, bit for bit: the same
    forward twin, the same remat backward twin, the same products."""
    args, cts = inputs(4, 8, 16)
    got = torch_outs_and_grads(LK.bilstm_seq, args, cts)
    want = torch_outs_and_grads(_two_lstm_seq_runs, args, cts)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("lengths", ["ragged", "full"])
def test_float64_gradcheck(lengths):
    args, _ = inputs(3, 4, 4)
    if lengths == "full":
        args[1] = np.ones_like(args[1])
    leaves = [torch.tensor(a, dtype=torch.float64, requires_grad=i != 1)
              for i, a in enumerate(args)]

    def fn(*a):
        hf, hb, (htf, ctf), (htb, ctb) = LK.bilstm_seq(*a)
        return hf, hb, htf, ctf, htb, ctb

    assert torch.autograd.gradcheck(fn, tuple(leaves))


@pytest.fixture
def _fresh_names():
    reset_name_counters()
    jax_reset()
    yield


def _bilstm_net(pkg, d):
    D = importlib.import_module(pkg.__name__ + ".layers.data_type")
    x = pkg.layer.data(name="x", type=D.dense_vector_sequence(E))
    return pkg.layer.bilstm(input=x, size=d, name="bi")


def test_bilstm_layer_params_and_values_match_jax(_fresh_names):
    """``layer.bilstm``: the same parameter names, shapes, attrs and
    initializer laws (zeros where JAX has zeros; the xavier bound and the
    1/sqrt(d) scale of the weights), and, with the JAX package's initial
    values carried by name (the bias bundles made nonzero), the same
    output and parameter gradients."""
    d, b, t = 8, 3, 7
    jnode, tnode = _bilstm_net(jpaddle, d), _bilstm_net(tpaddle, d)
    jtopo, ttopo = JTopology(jnode), TTopology(tnode)
    assert ttopo.digest() == jtopo.digest()
    names = [s.name for s in ttopo.param_specs()]
    assert names == [s.name for s in jtopo.param_specs()] == [
        f"_bi_{k}{s}" for k in ("fw", "bw")
        for s in ("_transform.w0", "_transform.wbias", ".w0", ".wbias")]
    jinit = jpaddle.parameters.create(jtopo)
    tinit = tpaddle.parameters.create(ttopo)
    for n in names:
        jv, tv = np.asarray(jinit[n]), tinit[n]
        assert jv.shape == tv.shape
        if n.endswith("wbias"):
            assert not tv.any() and not jv.any()
        elif "_transform" in n:            # xavier uniform, fans (E, 4d)
            lim = (6.0 / (E + 4 * d)) ** 0.5
            assert np.abs(tv).max() <= lim and np.abs(jv).max() <= lim
            np.testing.assert_allclose(tv.std(), jv.std(), rtol=0.15)
        else:                              # N(0, 1/d)
            np.testing.assert_allclose(tv.std(), d ** -0.5, rtol=0.15)
            np.testing.assert_allclose(jv.std(), d ** -0.5, rtol=0.15)

    rng = np.random.default_rng(1)
    carried = {n: np.asarray(jinit[n]) for n in names}
    for n in names:
        if n.endswith("wbias"):
            carried[n] = (0.1 * rng.normal(size=carried[n].shape)).astype(
                np.float32)
    x = rng.normal(size=(b, t, E)).astype(np.float32)
    lens = np.array([t, 4, 1])
    r = rng.normal(size=(b, t, 2 * d)).astype(np.float32)
    from paddle_tpu.core.lod import SequenceBatch as JSeq
    from paddle_tpu_torch.core.lod import SequenceBatch as TSeq

    def jloss(p):
        vals, _ = jtopo.forward(p, {}, {"x": JSeq(jnp.asarray(x),
                                                  jnp.asarray(lens))},
                                True, jax.random.key(0))
        return jnp.sum(vals["bi"].data * r), vals["bi"].data

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
        {n: jnp.asarray(v) for n, v in carried.items()})
    params = {n: torch.tensor(v, requires_grad=True)
              for n, v in carried.items()}
    vals, _ = ttopo.forward(params, {}, {"x": TSeq(torch.tensor(x),
                                                   torch.tensor(lens))},
                            True)
    out = vals["bi"]
    assert out.data.shape == (b, t, 2 * d)
    assert torch.equal(out.length, torch.tensor(lens))
    np.testing.assert_allclose(out.data.detach().numpy(), np.asarray(jout),
                               atol=TOL, rtol=0)
    tg = torch.autograd.grad((out.data * torch.tensor(r)).sum(),
                             list(params.values()))
    for n, g in zip(params, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[n]), atol=TOL,
                                   rtol=0, err_msg=n)


# -- the f32 kernel's cluster plan (csrc/bilstm_seq.cu), decided on the CPU --

H100 = (132, 232448)      # SMs, shared-memory bytes a CTA may opt in to


def _single_block_took(e, d, sms, optin):
    """Whether the single-block f32 kernel this plan replaced took E, D:
    W_h and a 4-row tile in one block's shared memory, and the backward's
    tiling (D a multiple of 4, ceil(D / SMs) <= 16 units a block)."""
    smem = 4 * (4 * d * d + 4 * (e + 6 * d))
    return d % 4 == 0 and smem <= optin and -(-d // sms) <= 16


def test_bi_plan_at_the_crnn_shapes():
    """The OCR CRNN (B 64, E 256, D 64): clusters of 4, 4-row tiles, W_x's
    slice resident, 128 CTAs on 132 SMs; its batch-2 witness step and the
    convergence recipe's D 32 keep W_x resident too."""
    p = LK.bi_plan(64, 256, 64, *H100)
    assert (p.cluster, p.rows, p.resident, p.ctas) == (4, 4, True, 128)
    # [W_h + W_x slices 64 + 16 KB] + x rows, h buffers, c, the partial
    # sums of 16 shares, the bias and peephole slices, two steps' mask
    assert p.smem_bytes == 4 * ((256 + 64) * 64 + 4 * 256 + 2 * 4 * 64
                                + 4 * 16 + 2 * 16 * 4 * 64 + 64 + 3 * 16
                                + 2 * 4)
    assert LK.bi_plan(2, 256, 64, *H100)[:3] == (8, 4, True)
    assert LK.bi_plan(32, 256, 32, *H100)[:4] == (8, 4, True, 128)


def test_bi_plan_keeps_to_the_clusters_the_card_holds():
    """With the clusters an H100 holds at once at the CRNN's shapes
    (``cudaOccupancyMaxActiveClusters`` through ``_max_clusters``, read on
    an H100 80GB HBM3): 30 clusters of 4, not 33, so the CRNN's 32
    clusters of 4 rows and 4 CTAs would run in two waves; the plan takes
    the one-wave 16 clusters of 8 CTAs and 8 rows.  A card whose GPCs
    held only 15 clusters of 8 would get 2-CTA clusters instead."""
    held = {(8, 4): 30, (4, 4): 30, (2, 4): 66, (1, 4): 132, (8, 8): 30,
            (4, 8): 30, (2, 8): 66, (1, 8): 132}
    p = LK.bi_plan(64, 256, 64, *H100, lambda c, r, res: held[c, r])
    assert (p.cluster, p.rows, p.resident, p.ctas) == (8, 8, True, 128)
    fewer = {**held, (8, 8): 15}
    p = LK.bi_plan(64, 256, 64, *H100, lambda c, r, res: fewer[c, r])
    assert (p.cluster, p.rows, p.resident, p.ctas) == (2, 4, True, 64)


@pytest.mark.parametrize("card", [H100, (132, 101376), (16, 49152)])
def test_bi_plan_takes_all_the_single_block_kernel_took(card):
    """At every (B, E, D) of a grid over the single-block kernel's edges
    (E to its shared-memory limit at D 4, D to 120): whatever it took, the
    plan takes; each plan's cluster divides D into whole units, is at most
    8, and its CTA fits the opt-in; the grid is the row tiles times both
    directions times the cluster."""
    sms, optin = card
    taken = 0
    for e in (1, 3, 16, 18, 64, 256, 1024, 4096, 8192, 14000, 14488, 14500):
        for d in range(4, 124, 4):
            if not _single_block_took(e, d, sms, optin):
                continue
            for b in (1, 2, 5, 64, 1000):
                p = LK.bi_plan(b, e, d, sms, optin)
                taken += 1
                assert d % p.cluster == 0 and p.cluster <= 8
                assert p.rows in (4, 8)
                assert p.smem_bytes == 4 * LK.bi_smem_floats(
                    e, d, p.cluster, p.rows, p.resident) <= optin
                assert p.ctas == 2 * p.cluster * -(-b // p.rows)
    assert taken > 100


def test_bi_plan_admits_wider_d_and_names_its_limit():
    """D 128 at E 256 (past the single-block kernel's 116) runs with W_x
    resident; past the plan's limit the refusal says how much shared
    memory it needed, against what, and the widest D it takes at that E."""
    assert not _single_block_took(256, 128, *H100)
    assert LK.bi_plan(64, 256, 128, *H100)[:3] == (8, 8, True)
    widest = LK.bi_plan(64, 256, 304, *H100)
    assert widest.cluster == 8 and not widest.resident
    from paddle_tpu_torch.core.enforce import EnforceError

    with pytest.raises(EnforceError, match=r"E=256, D=312 needs at least "
                       r"236372 bytes of shared memory .* more than the "
                       r"232448 the card allows; at E=256 the widest D it "
                       r"takes is 304"):
        LK.bi_plan(64, 256, 312, *H100)
    with pytest.raises(EnforceError, match="multiple of 4"):
        LK.bi_plan(64, 256, 66, *H100)


def test_bi_plan_mirrors_the_kernel_constants():
    """The plan's thread count, cluster cap and shares are the kernel's."""
    src = (Path(LK.__file__).parent / "csrc" / "bilstm_seq.cu").read_text()
    assert f"constexpr int kClThreads = {LK._BI_THREADS};" in src
    assert f"constexpr int kMaxCluster = {LK._BI_MAX_CLUSTER};" in src
    assert f"constexpr int kMaxSplits = {LK._BI_MAX_SPLITS};" in src

"""The port's GRU sequence Functions (``paddle_tpu_torch/ops/kernels/gru.py``,
their plain twins on the CPU) against the JAX package's ``gru_seq`` and
``bigru_seq`` (their Pallas kernels in interpret mode, remat on and off)
and ``gru_seq_reference`` / ``bigru_seq_reference``, on the same numpy
inputs, with ragged lengths (a length-1 row among them) in both
directions.

Compared: hs, h_T and every input gradient (dxw, dw_h, dw_hc, dh0; for
the BiGRU dx, dw_x, db, dw_h, dw_hc, dh0 of both directions) for a random
cotangent of every output.  Tolerance 2e-5 absolute (f32 round-off of
another summation order through up to 7 recurrent steps; measured
2.4e-7 at worst).  The port's two backward forms are held to the same
bits, and the BiGRU to two ``gru_seq`` runs, one a direction, bit for
bit."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import rnn as TR
from paddle_tpu_torch.ops.kernels import gru as GK
from paddle_tpu_torch.ops.kernels import lstm as LK

JG = importlib.import_module("paddle_tpu.ops.pallas.gru")

TOL = 2e-5


def lengths(rng, b, t):
    """Ragged lengths in [1, t], one full row and one of length 1."""
    lens = rng.integers(1, t + 1, size=b)
    lens[0] = t
    lens[-1] = 1
    return lens


def inputs(b, t, d, seed, e=None):
    rng = np.random.default_rng(seed)
    lens = lengths(rng, b, t)
    f = np.float32
    x = dict(mask=(np.arange(t)[None, :] < lens[:, None]).astype(f),
             w_h=(rng.normal(size=(d, 2 * d)) / np.sqrt(d)).astype(f),
             w_hc=(rng.normal(size=(d, d)) / np.sqrt(d)).astype(f),
             h0=(0.5 * rng.normal(size=(b, d))).astype(f))
    if e is None:
        x["xw"] = rng.normal(size=(b, t, 3 * d)).astype(f)
        x["ct"] = [rng.normal(size=s).astype(f) for s in ((b, t, d), (b, d))]
    else:
        x["x"] = rng.normal(size=(b, t, e)).astype(f)
        for k in ("w_h", "w_hc", "h0"):
            x[k + "_b"] = (rng.permutation(x[k].ravel()).reshape(x[k].shape)
                           * 0.9).astype(f)
        for s in ("", "_b"):
            x["w_x" + s] = (rng.normal(size=(e, 3 * d)) / np.sqrt(e)).astype(f)
            x["b" + s] = (0.2 * rng.normal(size=3 * d)).astype(f)
        x["ct"] = [rng.normal(size=s).astype(f)
                   for s in ((b, t, d), (b, t, d), (b, d), (b, d))]
    return x


DIFF = ("xw", "w_h", "w_hc", "h0")
NAMES = ("hs", "h_T") + tuple("d" + k for k in DIFF)


def jax_run(x, reverse, remat=None):
    """(hs, h_T, grads of DIFF) of the JAX kernel (remat True/False) or,
    with remat None, of ``gru_seq_reference``."""
    def f(xw, w_h, w_hc, h0):
        m = jnp.asarray(x["mask"])
        if remat is None:
            return JG.gru_seq_reference(xw, m, w_h, w_hc, h0, reverse)
        return JG.gru_seq(xw, m, w_h, w_hc, h0, reverse, True, remat)

    out, vjp = jax.vjp(f, *(jnp.asarray(x[k]) for k in DIFF))
    grads = vjp(tuple(jnp.asarray(c) for c in x["ct"]))
    return [np.asarray(v) for v in (*out, *grads)]


def torch_run(x, reverse, remat, fn=None, dtype=torch.float32):
    leaves = {k: torch.tensor(x[k], dtype=dtype).requires_grad_()
              for k in DIFF}
    mask = torch.tensor(x["mask"], dtype=dtype)
    args = (leaves["xw"], mask, leaves["w_h"], leaves["w_hc"], leaves["h0"])
    if fn is None:
        outs = GK.gru_seq(*args, reverse=reverse, remat=remat)
    else:
        outs = fn(*args, reverse)
    grads = torch.autograd.grad(outs, [leaves[k] for k in DIFF],
                                [torch.tensor(c, dtype=dtype)
                                 for c in x["ct"]])
    return [v.detach().numpy() for v in (*outs, *grads)]


@pytest.mark.parametrize("b,t,d", [(2, 4, 8), (3, 7, 16), (5, 7, 8)])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_seq_matches_jax_both_remat_modes(b, t, d, reverse):
    x = inputs(b, t, d, seed=b * 100 + t * 10 + d)
    want_ref = jax_run(x, reverse)
    got = {remat: torch_run(x, reverse, remat) for remat in (False, True)}
    for remat in (False, True):
        want = jax_run(x, reverse, remat)
        for name, g, w, r in zip(NAMES, got[remat], want, want_ref):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=name)
            np.testing.assert_allclose(g, r, atol=TOL, rtol=0, err_msg=name)
        for name, a, c in zip(NAMES, got[remat], got[not remat]):
            assert np.array_equal(a, c), f"{name}: remat {remat} vs stored"


def test_frozen_rows_keep_their_state_in_both_directions():
    """A row past its length keeps h (the reverse direction holds h0
    through its padded tail) and passes dh through."""
    x = inputs(3, 6, 8, seed=2)
    x["mask"][1] = [1, 1, 0, 0, 0, 0]
    for reverse in (False, True):
        hs, h_t, _, _, _, dh0 = torch_run(x, reverse, True)
        if reverse:
            assert np.array_equal(hs[1, 2:], np.repeat(x["h0"][1:2], 4, 0))
            assert np.array_equal(h_t[1], hs[1, 0])
        else:
            assert np.array_equal(hs[1, 2:], np.repeat(hs[1, 1:2], 4, 0))
            assert np.array_equal(h_t[1], hs[1, 1])
        assert np.isfinite(dh0).all()


def test_reference_is_the_plain_scan_with_autograd():
    """``gru_seq_reference`` (autograd through the plain scan) against the
    Function: the hand-written backward is the scan's exact adjoint."""
    x = inputs(4, 7, 8, seed=5)
    for reverse in (False, True):
        got = torch_run(x, reverse, True)
        want = torch_run(x, reverse, None, fn=GK.gru_seq_reference)
        for name, g, w in zip(NAMES, got, want):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("remat", [False, True])
def test_gru_seq_float64_gradcheck(remat):
    rng = np.random.default_rng(3)
    b, t, d = 2, 4, 3
    mask = torch.tensor([[1, 1, 1, 1], [1, 0, 0, 0]], dtype=torch.float64)
    args = [torch.from_numpy(rng.normal(size=s)).requires_grad_()
            for s in ((b, t, 3 * d), (d, 2 * d), (d, d), (b, d))]
    for reverse in (False, True):
        assert torch.autograd.gradcheck(
            lambda xw, w_h, w_hc, h0: GK.gru_seq(
                xw, mask, w_h, w_hc, h0, reverse=reverse, remat=remat),
            args, fast_mode=True)


def test_gru_cell_is_the_kernels_step():
    """``ops/rnn.gru_cell`` (the ``gru_step_layer`` cell) is one step of
    the twin, and equals the JAX package's ``gru_cell``."""
    jrnn = importlib.import_module("paddle_tpu.ops.rnn")
    x = inputs(3, 1, 8, seed=7)
    args = [x["xw"][:, 0], x["h0"], x["w_h"], x["w_hc"]]
    got = TR.gru_cell(*(torch.from_numpy(a) for a in args)).numpy()
    want = np.asarray(jrnn.gru_cell(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    hs, _ = GK.gru_seq_reference(torch.from_numpy(x["xw"]),
                                 torch.ones(3, 1),
                                 *(torch.from_numpy(x[k])
                                   for k in ("w_h", "w_hc", "h0")))
    assert np.array_equal(hs[:, 0].numpy(), got)


# -- the bidirectional, fused-input entry ------------------------------------

BI_DIFF = ("x", "w_x", "b", "w_h", "w_hc", "w_x_b", "b_b", "w_h_b", "w_hc_b",
           "h0", "h0_b")
BI_NAMES = ("hs_f", "hs_b", "h_T_f", "h_T_b") + tuple("d" + k
                                                      for k in BI_DIFF)


def _bi_order(v):
    """The entries of BI_DIFF in the entry points' argument order."""
    return (v["x"], v["w_x"], v["b"], v["w_h"], v["w_hc"], v["w_x_b"],
            v["b_b"], v["w_h_b"], v["w_hc_b"], v["h0"], v["h0_b"])


def bi_jax(x, remat=None):
    def f(*a):
        m = jnp.asarray(x["mask"])
        if remat is None:
            return JG.bigru_seq_reference(a[0], m, *a[1:])
        return JG.bigru_seq(a[0], m, *a[1:], True, remat)

    out, vjp = jax.vjp(f, *(jnp.asarray(v) for v in _bi_order(x)))
    grads = vjp(tuple(jnp.asarray(c) for c in x["ct"]))
    return [np.asarray(v) for v in (*out, *grads)]


def bi_torch(x, fn):
    leaves = {k: torch.from_numpy(x[k]).requires_grad_() for k in BI_DIFF}
    a = _bi_order(leaves)
    outs = fn(a[0], torch.from_numpy(x["mask"]), *a[1:])
    grads = torch.autograd.grad(outs, a, [torch.from_numpy(c)
                                          for c in x["ct"]])
    return [v.detach().numpy() for v in (*outs, *grads)]


def composed(x, mask, w_x_f, b_f, w_h_f, w_hc_f, w_x_b, b_b, w_h_b, w_hc_b,
             h0f, h0b):
    """Two ``gru_seq`` runs (remat, as the BiGRU's backward runs them) over
    the projected input, one a direction."""
    outs = []
    for w_x, b, w_h, w_hc, h0, reverse in ((w_x_f, b_f, w_h_f, w_hc_f, h0f,
                                            False),
                                           (w_x_b, b_b, w_h_b, w_hc_b, h0b,
                                            True)):
        outs.append(GK.gru_seq(LK._project_xw(x, w_x, b), mask, w_h, w_hc,
                               h0, reverse=reverse, remat=True))
    (hs_f, h_t_f), (hs_b, h_t_b) = outs
    return hs_f, hs_b, h_t_f, h_t_b


@pytest.mark.parametrize("b,t,e,d", [(3, 7, 12, 8), (5, 4, 8, 16)])
def test_bigru_seq_matches_jax_and_two_gru_runs(b, t, e, d):
    x = inputs(b, t, d, seed=b + t + e + d, e=e)
    got = bi_torch(x, GK.bigru_seq)
    for want in (bi_jax(x, False), bi_jax(x, True), bi_jax(x)):
        for name, g, w in zip(BI_NAMES, got, want):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=name)
    for fn in (GK.bigru_seq_reference, composed):
        for name, g, w in zip(BI_NAMES, got, bi_torch(x, fn)):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=name)
    # the forward twin is the composition itself, bit for bit
    for name, g, w in zip(BI_NAMES[:4], got, bi_torch(x, composed)):
        assert np.array_equal(g, w), name


def test_bigru_seq_float64_gradcheck():
    rng = np.random.default_rng(4)
    b, t, e, d = 2, 3, 4, 2
    mask = torch.tensor([[1, 1, 1], [1, 0, 0]], dtype=torch.float64)
    shapes = [(b, t, e)] + [(e, 3 * d), (3 * d,), (d, 2 * d), (d, d)] * 2 \
        + [(b, d)] * 2
    args = [torch.from_numpy(rng.normal(size=s)).requires_grad_()
            for s in shapes]
    assert torch.autograd.gradcheck(
        lambda x, *w: GK.bigru_seq(x, mask, *w), args, fast_mode=True)


def test_bigru_fused_matches_the_jax_composition():
    """``ops/rnn.bigru_fused`` against the JAX package's (its unfused
    composition off the TPU: the projection and ``gru_fused`` a
    direction), biases and no biases."""
    from paddle_tpu.core.lod import SequenceBatch as JSeq
    from paddle_tpu_torch.core.lod import SequenceBatch as TSeq

    jrnn = importlib.import_module("paddle_tpu.ops.rnn")
    x = inputs(4, 6, 8, seed=9, e=12)
    lens = x["mask"].sum(1).astype(np.int64)
    for with_bias in (True, False):
        fw = (x["w_x"], x["b"] if with_bias else None, x["w_h"], x["w_hc"])
        bw = (x["w_x_b"], x["b_b"] if with_bias else None, x["w_h_b"],
              x["w_hc_b"])
        jw = [tuple(None if a is None else jnp.asarray(a) for a in w)
              for w in (fw, bw)]
        tw = [tuple(None if a is None else torch.from_numpy(a) for a in w)
              for w in (fw, bw)]
        want = jrnn.bigru_fused(JSeq(jnp.asarray(x["x"]),
                                     jnp.asarray(lens.astype(np.int32))),
                                *jw)
        got = TR.bigru_fused(TSeq(torch.from_numpy(x["x"]),
                                  torch.from_numpy(lens)), *tw)
        np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                                   atol=TOL, rtol=0)

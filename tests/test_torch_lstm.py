"""The port's LSTM sequence Function (``paddle_tpu_torch/ops/kernels/lstm.py``,
its plain twins on the CPU) against the JAX package's ``lstm_seq`` (its
Pallas kernels in interpret mode, remat on and off) and
``lstm_seq_reference``, on the same numpy inputs.

Compared: hs, h_T, c_T and every input gradient (dxw, dw_h, dpeep, dh0,
dc0) for a random cotangent of all three outputs.  Tolerance 2e-5
absolute (f32 round-off of another summation order through up to 9
recurrent steps; measured 6.2e-6 at worst).  The port's two backward forms
are held to the same bits, as the JAX contract holds its own."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import lstm as LK

JL = importlib.import_module("paddle_tpu.ops.pallas.lstm")

TOL = 2e-5


def inputs(b, t, d, reverse, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, t + 1, size=b)
    lens[0] = t
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    f = np.float32
    return dict(
        xw=rng.normal(size=(b, t, 4 * d)).astype(f),
        mask=mask,
        w_h=(rng.normal(size=(d, 4 * d)) / np.sqrt(d)).astype(f),
        peep=(0.3 * rng.normal(size=(3, d))).astype(f),
        h0=(0.5 * rng.normal(size=(b, d))).astype(f),
        c0=(0.5 * rng.normal(size=(b, d))).astype(f),
        ct=[rng.normal(size=s).astype(f)
            for s in ((b, t, d), (b, d), (b, d))])


DIFF = ("xw", "w_h", "peep", "h0", "c0")


def jax_run(x, reverse, remat=None):
    """(hs, h_T, c_T, grads of DIFF) of the JAX kernel (remat True/False)
    or, with remat None, of ``lstm_seq_reference``."""
    def f(xw, w_h, peep, h0, c0):
        m = jnp.asarray(x["mask"])
        if remat is None:
            hs, (h_t, c_t) = JL.lstm_seq_reference(xw, m, w_h, peep, h0, c0,
                                                   reverse)
        else:
            hs, (h_t, c_t) = JL.lstm_seq(xw, m, w_h, peep, h0, c0, reverse,
                                         True, remat)
        return hs, h_t, c_t

    out, vjp = jax.vjp(f, *(jnp.asarray(x[k]) for k in DIFF))
    grads = vjp(tuple(jnp.asarray(c) for c in x["ct"]))
    return [np.asarray(v) for v in (*out, *grads)]


def torch_run(x, reverse, remat, fn=None):
    leaves = {k: torch.from_numpy(x[k]).requires_grad_() for k in DIFF}
    mask = torch.from_numpy(x["mask"])
    if fn is None:
        hs, (h_t, c_t) = LK.lstm_seq(leaves["xw"], mask, leaves["w_h"],
                                     leaves["peep"], leaves["h0"],
                                     leaves["c0"], reverse=reverse,
                                     remat=remat)
    else:
        hs, (h_t, c_t) = fn(leaves["xw"], mask, leaves["w_h"],
                            leaves["peep"], leaves["h0"], leaves["c0"],
                            reverse)
    outs = (hs, h_t, c_t)
    grads = torch.autograd.grad(outs, [leaves[k] for k in DIFF],
                                [torch.from_numpy(c) for c in x["ct"]])
    return [v.detach().numpy() for v in (*outs, *grads)]


NAMES = ("hs", "h_T", "c_T") + tuple("d" + k for k in DIFF)


@pytest.mark.parametrize("b,t,d", [(3, 7, 8), (5, 9, 32), (300, 7, 8)])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_seq_matches_jax_both_remat_modes(b, t, d, reverse):
    """B=300 passes the JAX kernels' 256-row batch block: the port, which
    does not block the batch that way, gives the same result."""
    x = inputs(b, t, d, reverse, seed=b * 100 + t * 10 + d)
    want_ref = jax_run(x, reverse)
    got = {remat: torch_run(x, reverse, remat) for remat in (False, True)}
    for remat in (False, True):
        want = jax_run(x, reverse, remat)
        for name, g, w, r in zip(NAMES, got[remat], want, want_ref):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=name)
            np.testing.assert_allclose(g, r, atol=TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_stored_and_remat_backward_give_the_same_bits(reverse):
    x = inputs(5, 9, 32, reverse, seed=11)
    stored, remat = (torch_run(x, reverse, r) for r in (False, True))
    for name, a, b in zip(NAMES, stored, remat):
        assert np.array_equal(a, b), name


def test_reference_is_the_plain_scan_with_autograd():
    """``lstm_seq_reference`` (autograd through the plain scan) against
    the Function: the hand-written backward is the scan's exact adjoint."""
    x = inputs(4, 7, 8, False, seed=5)
    for reverse in (False, True):
        got = torch_run(x, reverse, True)
        want = torch_run(x, reverse, None, fn=LK.lstm_seq_reference)
        for name, g, w in zip(NAMES, got, want):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("remat", [False, True])
def test_float64_gradcheck(remat):
    rng = np.random.default_rng(3)
    b, t, d = 2, 4, 3
    mask = torch.tensor([[1, 1, 1, 1], [1, 1, 0, 0]], dtype=torch.float64)
    args = [torch.from_numpy(rng.normal(size=s)).requires_grad_()
            for s in ((b, t, 4 * d), (d, 4 * d), (3, d), (b, d), (b, d))]

    def f(xw, w_h, peep, h0, c0):
        hs, (h_t, c_t) = LK.lstm_seq(xw, mask, w_h, peep, h0, c0,
                                     reverse=True, remat=remat)
        return hs, h_t, c_t

    assert torch.autograd.gradcheck(f, args, fast_mode=True)


def test_shift_prev_matches_jax():
    rng = np.random.default_rng(0)
    stack = rng.normal(size=(3, 5, 4)).astype(np.float32)
    boot = rng.normal(size=(3, 4)).astype(np.float32)
    for reverse in (False, True):
        want = np.swapaxes(np.asarray(JL._shift_prev(
            jnp.swapaxes(jnp.asarray(stack), 0, 1), jnp.asarray(boot),
            reverse)), 0, 1)
        got = LK._shift_prev(torch.from_numpy(stack), torch.from_numpy(boot),
                             reverse).numpy()
        assert np.array_equal(got, want)

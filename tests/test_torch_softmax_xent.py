"""The port's fused softmax cross-entropy (``paddle_tpu_torch/ops/kernels/
softmax_xent.py``, its plain twins on the CPU) against the JAX package's
``softmax_xent`` (its Pallas kernels in interpret mode) and
``softmax_xent_reference``, on the same numpy inputs, at N and V that are
multiples of nothing (N 1, 37; V 3, 1,003), with targets at both ends of
the vocabulary.

The per-row NLL is held at rtol 1e-5 (f32 log-sum-exp in another
summation order) and the logits' gradient under a random per-row
cotangent at atol 1e-6 (its entries are at most |g| ~ 1).  A float64
``gradcheck`` tests the hand-written backward twin."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import softmax_xent as SX

JX = importlib.import_module("paddle_tpu.ops.pallas.softmax_xent")

NLL_RTOL = 1e-5
GRAD_ATOL = 1e-6


def inputs(n, v, seed):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.normal(size=(n, v))).astype(np.float32)
    targets = rng.integers(0, v, size=n)
    targets[0] = v - 1
    if n > 1:
        targets[1] = 0
    g = rng.normal(size=n).astype(np.float32)
    return logits, targets, g


def jax_run(logits, targets, g, kernel):
    def f(x):
        t = jnp.asarray(targets.astype(np.int32))
        if kernel:
            return JX.softmax_xent(x, t, interpret=True)
        return JX.softmax_xent_reference(x, t)

    nll, vjp = jax.vjp(f, jnp.asarray(logits))
    return np.asarray(nll), np.asarray(vjp(jnp.asarray(g))[0])


def torch_run(logits, targets, g, fn=SX.softmax_xent):
    x = torch.from_numpy(logits).requires_grad_()
    nll = fn(x, torch.from_numpy(targets))
    (dx,) = torch.autograd.grad(nll, x, torch.from_numpy(g))
    return nll.detach().numpy(), dx.numpy()


@pytest.mark.parametrize("n", [1, 37])
@pytest.mark.parametrize("v", [3, 1003])
def test_softmax_xent_matches_jax(n, v):
    logits, targets, g = inputs(n, v, seed=n * 10 + v)
    got = torch_run(logits, targets, g)
    assert got[0].shape == (n,) and got[0].dtype == np.float32
    for want in (jax_run(logits, targets, g, True),
                 jax_run(logits, targets, g, False),
                 torch_run(logits, targets, g, SX.softmax_xent_reference)):
        np.testing.assert_allclose(got[0], want[0], rtol=NLL_RTOL, atol=0)
        np.testing.assert_allclose(got[1], want[1], atol=GRAD_ATOL, rtol=0)


def test_backward_twin_is_softmax_minus_onehot():
    """The backward twin writes (softmax - onehot) * g out, and the row's
    gradient sums to 0 times g."""
    logits, targets, g = inputs(5, 11, seed=1)
    x = torch.from_numpy(logits)
    t = torch.from_numpy(targets)
    nll, lse = SX._fwd_plain(x, t)
    d = SX._bwd_plain(x, t, lse, torch.from_numpy(g))
    want = torch.softmax(x, -1)
    want[torch.arange(5), t] -= 1.0
    np.testing.assert_allclose(d.numpy(), (want * torch.from_numpy(g)[:, None])
                               .numpy(), atol=GRAD_ATOL, rtol=0)
    np.testing.assert_allclose(d.sum(-1).numpy(), 0.0, atol=GRAD_ATOL)


def test_out_of_range_targets_give_nan_and_no_onehot():
    """A target outside [0, V) reads no logit: its row's NLL is NaN (the
    JAX package's gather fills past V with NaN) and its gradient is
    softmax * g; the other rows are untouched."""
    logits, targets, g = inputs(4, 9, seed=5)
    targets[1], targets[2] = 9, -1
    nll, dx = torch_run(logits, targets, g)
    assert np.isnan(nll[1]) and np.isnan(nll[2])
    assert np.isfinite(nll[[0, 3]]).all()
    want_nll, want_dx = torch_run(logits[[0, 3]], targets[[0, 3]], g[[0, 3]])
    np.testing.assert_array_equal(nll[[0, 3]], want_nll)
    np.testing.assert_allclose(dx[[0, 3]], want_dx, atol=GRAD_ATOL, rtol=0)
    soft = torch.softmax(torch.from_numpy(logits[1:3]), -1).numpy()
    np.testing.assert_allclose(dx[1:3], soft * g[1:3, None], atol=GRAD_ATOL,
                               rtol=0)
    jnll, _ = jax_run(logits[[1]], targets[[1]], g[[1]], kernel=False)
    assert np.isnan(jnll).all()


def test_softmax_xent_float64_gradcheck():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(4, 7))).requires_grad_()
    t = torch.tensor([6, 0, 3, 3])
    assert torch.autograd.gradcheck(lambda z: SX.softmax_xent(z, t), (x,))


def test_softmax_xent_mean_is_the_lm_loss():
    """The mean of the NLL equals the port's LM loss chain
    (``transformer.loss_fn``: logsumexp - gather, the mean) on the same
    logits, value and gradient."""
    logits, targets, _ = inputs(2 * 9, 50, seed=3)
    x = torch.from_numpy(logits).requires_grad_()
    t = torch.from_numpy(targets)
    loss = SX.softmax_xent(x, t).mean()
    (got,) = torch.autograd.grad(loss, x)
    y = x.detach().clone().requires_grad_()
    want_loss = torch.mean(torch.logsumexp(y, -1)
                           - torch.gather(y, -1, t[:, None])[:, 0])
    (want,) = torch.autograd.grad(want_loss, y)
    np.testing.assert_allclose(loss.item(), want_loss.item(), rtol=NLL_RTOL)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=GRAD_ATOL)


def test_softmax_xent_refuses_bad_shapes():
    from paddle_tpu_torch.core.enforce import EnforceError

    with pytest.raises(EnforceError, match="softmax_xent"):
        SX.softmax_xent(torch.zeros(3, 4), torch.zeros(2, dtype=torch.long))
    with pytest.raises(EnforceError, match="softmax_xent"):
        SX.softmax_xent(torch.zeros(4), torch.zeros(4, dtype=torch.long))

"""``paddle_tpu_torch.ops.kernels.conv`` (direct conv and the fused
conv + BN + act, with their autograd) against the JAX package's
``tpp.conv2d_direct`` / ``tpp.conv2d_bn_act`` run as ``tests/test_tpp.py``
runs them on the CPU: the Pallas kernels in interpret mode, their
``custom_vjp`` backward through ``jax.grad``.

The five configs are those of ``tests/test_tpp.py``: the ResNet 3x3, the
strided 3x3, the 1x1 (BRGEMM route), the strided 1x1 and the 7x7 stem, on
the odd 13x14 input.

Tolerance: forward atol = rtol = 2e-5 (f32 summation order); gradients
and BN outputs atol = rtol = 2e-4 — the bound ``tests/test_tpp.py`` holds
the Pallas kernel's gradients to, since the BN vjp divides by the batch
standard deviation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import tpp
from paddle_tpu_torch.ops import nn as nn_ops
from paddle_tpu_torch.ops.kernels import conv as CV

CFGS = [(3, 1, 1), (3, 2, 1), (1, 1, 0), (1, 2, 0), (7, 2, 3)]
IDS = ["3x3s1", "3x3s2", "1x1s1", "1x1s2", "7x7s2p3"]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _arrays(rng, k, cin=5, cout=9):
    x = rng.normal(size=(2, 13, 14, cin)).astype(np.float32)
    w = (rng.normal(size=(k, k, cin, cout)) * 0.3).astype(np.float32)
    return x, w


def _bn_arrays(rng, c):
    ga = (rng.normal(size=(c,)) * 0.2 + 1).astype(np.float32)
    be = (rng.normal(size=(c,)) * 0.2).astype(np.float32)
    rm = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    rv = (np.abs(rng.normal(size=(c,))) + 0.5).astype(np.float32)
    return ga, be, rm, rv


def _leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
def test_conv2d_direct_and_grads_match_jax(cfg):
    k, s, p = cfg
    x, w = _arrays(np.random.default_rng(k * 10 + s), k)
    tx, tw = _leaves(x, w)
    y = CV.conv2d_direct(tx, tw, stride=s, padding=p)
    gx, gw = torch.autograd.grad((y * y).sum(), (tx, tw))

    def jfn(xx, ww):
        return tpp.conv2d_direct(xx, ww, stride=s, padding=p, impl="kernel",
                                 interpret=True)

    jx, jw = jnp.asarray(x), jnp.asarray(w)
    want = jfn(jx, jw)
    assert tuple(y.shape) == want.shape
    _close(y, want, 2e-5)
    _close(y, tpp.conv2d_direct_reference(jx, jw, stride=s, padding=p), 2e-5)
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(jfn(a, b) ** 2),
                        argnums=(0, 1))(jx, jw)
    _close(gx, jgx, 2e-4)
    _close(gw, jgw, 2e-4)


@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("act", ["relu", None])
def test_conv2d_bn_act_and_grads_match_jax(cfg, is_train, act):
    k, s, p = cfg
    rng = np.random.default_rng(k * 100 + s * 10 + is_train)
    x, w = _arrays(rng, k, cin=4, cout=8)
    ga, be, rm, rv = _bn_arrays(rng, 8)
    tx, tw, tga, tbe = _leaves(x, w, ga, be)
    y, nm, nv = CV.conv2d_bn_act(tx, tw, tga, tbe, torch.from_numpy(rm),
                                 torch.from_numpy(rv), is_train, stride=s,
                                 padding=p, act=act)
    # a random cotangent: sum(y**2) of a normalized output is nearly
    # constant in w, and its gradient is cancellation noise
    r = rng.normal(size=tuple(y.shape)).astype(np.float32)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum(),
                                (tx, tw, tga, tbe))

    def jfn(xx, ww, gg, bb):
        return tpp.conv2d_bn_act(xx, ww, gg, bb, jnp.asarray(rm),
                                 jnp.asarray(rv), is_train, stride=s,
                                 padding=p, act=act, impl="kernel",
                                 interpret=True)

    jargs = [jnp.asarray(a) for a in (x, w, ga, be)]
    jy, jnm, jnv = jfn(*jargs)
    _close(y, jy, 2e-4)
    _close(nm, jnm, 2e-5)
    _close(nv, jnv, 2e-5)
    jgrads = jax.grad(lambda *a: jnp.sum(jfn(*a)[0] * jnp.asarray(r)),
                      argnums=(0, 1, 2, 3))(*jargs)
    for g, jg in zip(grads, jgrads):
        _close(g, jg, 2e-4)


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
def test_fused_equals_unfused_composition(is_train):
    """The fused entry and its plain oracle (conv -> batch_norm -> relu)
    agree on the CPU, outputs and running statistics."""
    rng = np.random.default_rng(3)
    x, w = _arrays(rng, 3, cin=4, cout=8)
    args = [torch.from_numpy(a) for a in (x, w, *_bn_arrays(rng, 8))]
    got = CV.conv2d_bn_act(*args, is_train, stride=2, padding=1)
    want = CV.conv2d_bn_act_reference(*args, is_train, stride=2, padding=1)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-5)


def test_running_stats_use_the_biased_variance_and_momentum():
    """new = m * running + (1 - m) * batch, with the variance divided by
    the count (not torch's unbiased update with the weights swapped)."""
    rng = np.random.default_rng(4)
    x, w = _arrays(rng, 1, cin=3, cout=2)
    y_conv = nn_ops.conv2d_xla(torch.from_numpy(x), torch.from_numpy(w))
    yc = y_conv.reshape(-1, 2).double()
    rm, rv = torch.zeros(2), torch.ones(2)
    _, nm, nv = CV.conv2d_bn_act(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.ones(2), torch.zeros(2), rm, rv, True,
                                 momentum=0.8)
    np.testing.assert_allclose(nm.numpy(), (0.2 * yc.mean(0)).numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(
        nv.numpy(), (0.8 + 0.2 * yc.var(0, unbiased=False)).numpy(),
        rtol=1e-5)


def test_act_other_than_relu_or_linear_is_refused():
    x = torch.zeros(1, 3, 3, 2)
    with pytest.raises(ValueError, match="relu"):
        CV.conv2d_bn_act(x, torch.zeros(1, 1, 2, 2), torch.ones(2),
                         torch.zeros(2), torch.zeros(2), torch.ones(2), True,
                         act="tanh")

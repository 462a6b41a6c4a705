"""``paddle_tpu_torch.ops.kernels.flash_attention`` against the
JAX package: the port's plain path (the padded [B*H, Tp, D] problem the
CUDA kernel solves, with its padding and transposes) vs
``flash_attention`` in interpret mode and ``flash_attention_reference``,
o and lse, causal and not, T a block multiple and not.  Tolerance 2e-5
(atol and rtol): f32 round-off of different summation orders."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_attention as FA

# the JAX package re-exports the flash_attention FUNCTION under the
# submodule's name, so reach the module itself through importlib
JFA = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

TOL = dict(rtol=2e-5, atol=2e-5)

SHAPES = [
    # b, t_q, t_k, h, d
    (2, 64, 64, 2, 16),    # one 64-row tile
    (1, 100, 100, 2, 32),  # ragged: padded to 128
    (2, 130, 130, 1, 16),  # three tiles, ragged
    (1, 40, 90, 2, 16),    # t_q != t_k
]


def _qkv(rng, b, t_q, t_k, h, d):
    q = rng.normal(size=(b, t_q, h, d)).astype(np.float32)
    k = rng.normal(size=(b, t_k, h, d)).astype(np.float32)
    v = rng.normal(size=(b, t_k, h, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,t_q,t_k,h,d", SHAPES)
def test_forward_matches_jax_kernel_interpreted(b, t_q, t_k, h, d, causal,
                                                rng_np):
    q, k, v = _qkv(rng_np, b, t_q, t_k, h, d)
    # 32-row tiles put the JAX kernel on its tiled (online-softmax) path
    jo, jlse, _ = JFA._fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal, None, 32, 32, True)
    want_o = np.asarray(JFA._from_bh(jo, b, h, t_q, d))
    want_lse = np.asarray(jlse)[:, :t_q]
    o, lse = FA.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal)
    assert tuple(o.shape) == (b, t_q, h, d)
    assert tuple(lse.shape) == (b * h, t_q, 1)
    np.testing.assert_allclose(o.numpy(), want_o, **TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)
    # the public entry (default blocks) agrees too
    np.testing.assert_allclose(
        o.numpy(), np.asarray(JFA.flash_attention(q, k, v, causal,
                                                  interpret=True)), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,t_q,t_k,h,d", SHAPES[:2])
def test_references_agree(b, t_q, t_k, h, d, causal, rng_np):
    q, k, v = _qkv(rng_np, b, t_q, t_k, h, d)
    want = np.asarray(JFA.flash_attention_reference(q, k, v, causal))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    np.testing.assert_allclose(
        FA.flash_attention_reference(tq, tk, tv, causal).numpy(), want,
        **TOL)
    np.testing.assert_allclose(
        FA.flash_attention(tq, tk, tv, causal).numpy(), want, **TOL)


def test_padding_is_masked_and_sliced():
    """Padded keys carry no weight and padded query rows are dropped:
    a ragged T gives what the unpadded exact softmax gives."""
    t = 70
    q, k, v = (torch.ones(1, t, 1, 16) for _ in range(3))
    qp, kp, vp = FA._prep(q, k, v)
    assert qp.shape == (1, 128, 16) and qp.is_contiguous()
    assert not qp[:, t:].any()
    o, lse = FA.flash_attention_fwd(q, k, v, causal=False)
    # uniform scores over t real keys: lse = s + log(t), o = v
    np.testing.assert_allclose(lse.numpy(), 16 ** -0.5 * 16 + np.log(t),
                               rtol=1e-6)
    np.testing.assert_allclose(o.numpy(), 1.0, rtol=1e-6)


def test_wrapper_takes_the_plain_path_for_cpu_tensors(rng_np):
    q, k, v = map(torch.from_numpy, _qkv(rng_np, 1, 20, 20, 2, 16))
    before = FA.KERNEL.launches
    FA.flash_attention(q, k, v, causal=True)
    assert FA.KERNEL.launches == before
    with pytest.raises(Exception, match="differ"):
        FA.flash_attention(q, k[..., :1, :], v[..., :1, :])


# -- backward -------------------------------------------------------------------
#
# The port's gradient (``_FlashAttention``'s backward: on CPU tensors the
# plain twin ``_bwd_plain`` of the dQ and dK/dV kernels) against the JAX
# package's ``_flash_bwd`` in interpret mode, on both its branches: the
# default blocks give the fused single-tile kernel, blocks of 32 the tiled
# dQ and dK/dV pair.  Tolerance 2e-5 as above: f32 round-off of another
# summation order, with cotangents and values of order 1.


def _grads_port(q, k, v, g, causal):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = FA.flash_attention(tq, tk, tv, causal)
    return torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(g))


@pytest.mark.parametrize("block", [1024, 32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,t_q,t_k,h,d", SHAPES)
def test_backward_matches_jax_kernel_interpreted(b, t_q, t_k, h, d, causal,
                                                 block, rng_np):
    q, k, v = _qkv(rng_np, b, t_q, t_k, h, d)
    g = rng_np.normal(size=(b, t_q, h, d)).astype(np.float32)
    _, res = JFA._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal, None, block, block, True)
    want = JFA._flash_bwd(causal, None, block, block, True, res,
                          jnp.asarray(g))
    for got, w, name in zip(_grads_port(q, k, v, g, causal), want, "qkv"):
        assert tuple(got.shape) == w.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,t_q,t_k,h,d", SHAPES)
def test_backward_matches_jax_grad_of_the_reference(b, t_q, t_k, h, d,
                                                    causal, rng_np):
    q, k, v = _qkv(rng_np, b, t_q, t_k, h, d)
    g = rng_np.normal(size=(b, t_q, h, d)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda q, k, v: JFA.flash_attention_reference(q, k, v, causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, w, name in zip(_grads_port(q, k, v, g, causal),
                            vjp(jnp.asarray(g)), "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"d{name}")


def test_gradient_goes_through_the_function(rng_np):
    """On the CPU the gradient is the Function's: its grad_fn, and grads
    equal to ``_bwd_plain`` on the padded problem bit for bit (not autograd
    through the forward's einsums)."""
    b, t_q, t_k, h, d = 2, 70, 90, 2, 16
    q, k, v = map(torch.from_numpy, _qkv(rng_np, b, t_q, t_k, h, d))
    g = torch.from_numpy(rng_np.normal(size=(b, t_q, h, d)).astype(np.float32))
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    o, lse = FA.flash_attention_fwd(tq, tk, tv, causal=True)
    assert o.grad_fn._forward_cls is FA._FlashAttention
    assert not lse.requires_grad
    got = torch.autograd.grad(o, (tq, tk, tv), g)
    qp, kp, vp = FA._prep(q, k, v)
    op, lsep = FA._fwd_plain(qp, kp, vp, t_k, True, d ** -0.5)
    dop = torch.nn.functional.pad(g.permute(0, 2, 1, 3).reshape(b * h, t_q, d),
                                  (0, 0, 0, qp.shape[1] - t_q))
    want = FA._bwd_plain(qp, kp, vp, op, lsep, dop, t_k, True, d ** -0.5)
    for x, y, t in zip(got, want, (t_q, t_k, t_k)):
        assert torch.equal(x, FA._from_bh(y, b, h, t, d))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t_q,t_k", [(5, 5), (3, 7), (9, 4)])
def test_gradcheck_in_float64(t_q, t_k, causal):
    """The plain twins keep float64, so ``torch.autograd.gradcheck``
    (finite differences against the analytic backward, along random
    directions: ``fast_mode``) applies."""
    gen = torch.Generator().manual_seed(t_q + t_k)
    q, k, v = (torch.randn(1, t, 2, 16, generator=gen, dtype=torch.float64,
                           requires_grad=True) for t in (t_q, t_k, t_k))
    assert torch.autograd.gradcheck(
        lambda q, k, v: FA.flash_attention(q, k, v, causal), (q, k, v),
        fast_mode=True)

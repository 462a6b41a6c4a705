"""``paddle_tpu_torch.ops.kernels.flash_attention`` (forward) against the
JAX package: the port's plain path (the padded [B*H, Tp, D] problem the
CUDA kernel solves, with its padding and transposes) vs
``flash_attention`` in interpret mode and ``flash_attention_reference``,
o and lse, causal and not, T a block multiple and not.  Tolerance 2e-5
(atol and rtol): f32 round-off of different summation orders."""

import importlib

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

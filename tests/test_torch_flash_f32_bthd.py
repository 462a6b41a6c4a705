"""The f32 flash route in place on [B, T, H, D] (PERF.md row 2 f32 and
row 3 f32), on the CPU, where its host functions (``_fwd_bthd``,
``_bwd_bthd``) run the plain twins on the padded problem: forward,
backward and the no-grad prefill equal the padded twin bit for bit and
agree with the JAX package's ``flash_attention`` and its gradient in
interpret mode, at ragged T, t_q != t_k, causal and not, with q, k, v
sliced from one fused projection and an upstream gradient the kernels
cannot read as it lies; the stride and alignment rule the kernels read
by; the padded rows' lse.  Tolerance 2e-5 (atol and rtol) against JAX:
f32 round-off of different summation orders.  The CUDA kernels are held
to the same twins on the card (``test_torch_cuda.py``,
``chip_smoke.py``)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.ops.kernels import flash_attention as FA

JFA = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

TOL = dict(rtol=2e-5, atol=2e-5)

SHAPES = [
    # b, t_q, t_k, h, d
    (2, 64, 64, 2, 16),     # one tile
    (1, 130, 130, 2, 32),   # ragged: padded to 192
    (2, 40, 90, 1, 16),     # t_q < t_k
    (1, 150, 70, 2, 16),    # t_q > t_k
]


def _np(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _problem(rng, b, t_q, t_k, h, d):
    return (_np(rng, b, t_q, h, d), _np(rng, b, t_k, h, d),
            _np(rng, b, t_k, h, d), _np(rng, b, t_q, h, d))


def _padded_twin(q, k, v, causal, scale):
    """(o [B, Tq, H, D], lse [B*H, Tqp, 1]) of the twin on the padded
    problem."""
    b, t_q, h, d = q.shape
    o, lse = FA._fwd_plain(*FA._prep(q, k, v), k.shape[1], causal, scale)
    return FA._from_bh(o, b, h, t_q, d), lse


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,t_q,t_k,h,d", SHAPES)
def test_f32_route_forward_equals_the_twin_and_jax(b, t_q, t_k, h, d,
                                                   causal, rng_np):
    """The f32 forward takes the in-place route, as a no-grad call (the
    prefill's) and under autograd: o [B, Tq, H, D] contiguous and lse
    [B*H, Tq, 1] equal the padded twin's bit for bit, and agree with
    JAX's ``flash_attention`` in interpret mode."""
    q, k, v, _ = map(torch.from_numpy, _problem(rng_np, b, t_q, t_k, h, d))
    scale = d ** -0.5
    assert FA._takes_bthd(q)
    want_o, want_lse = _padded_twin(q, k, v, causal, scale)
    with torch.no_grad():
        o, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
    assert o.is_contiguous() and o.shape == (b, t_q, h, d)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse[:, :t_q])
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o2, lse2 = FA.flash_attention_fwd(*leaves, causal=causal)
    assert o2.grad_fn is not None
    assert torch.equal(o2.detach(), want_o) and torch.equal(lse2, lse)
    jo = JFA.flash_attention(q.numpy(), k.numpy(), v.numpy(), causal,
                             block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,t_q,t_k,h,d", SHAPES)
def test_f32_route_backward_equals_the_twin_and_jax(b, t_q, t_k, h, d,
                                                    causal, rng_np):
    """The gradients through the Function on the in-place route: dq, dk,
    dv [B, T, H, D] contiguous, equal to the padded route's
    ``_bwd_plain`` cut to the valid rows bit for bit, and agreeing with
    the gradient of JAX's ``flash_attention`` (its tiled dQ and dK/dV
    kernels at 64 x 64 blocks, interpret mode)."""
    q, k, v, g = _problem(rng_np, b, t_q, t_k, h, d)
    scale = d ** -0.5
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(FA.flash_attention(*leaves, causal=causal),
                              leaves, torch.from_numpy(g))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    qp, kp, vp = FA._prep(tq, tk, tv)
    op, lse = FA._fwd_plain(qp, kp, vp, t_k, causal, scale)
    want = FA._bwd_plain(qp, kp, vp, op, lse, FA._to_bh(tg), t_k, causal,
                         scale)
    for x, w, t in zip(got, want, (t_q, t_k, t_k)):
        assert x.shape == (b, t, h, d) and x.is_contiguous()
        assert torch.equal(x, FA._from_bh(w, b, h, t, d))
    _, vjp = jax.vjp(lambda q, k, v: JFA.flash_attention(
        q, k, v, causal, block_q=64, block_k=64, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for x, w in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), **TOL)


def test_f32_route_reads_views_and_copies_an_untakeable_gradient(rng_np):
    """q, k, v as strided views of one [B, T, 3, H, D] projection, as the
    LM's attention makes them, and an expanded upstream gradient (strides
    0, which the kernels cannot read): the route's forward and gradients
    equal those of contiguous copies bit for bit, and the gradient is the
    one operand the backward copies."""
    b, t, h, d = 2, 70, 2, 16
    qkv = torch.from_numpy(_np(rng_np, b, t, 3, h, d))
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous() and FA._bthd_ok(q)
    g = torch.ones(()).expand(b, t, h, d)
    assert not FA._bthd_ok(g) and FA._bthd_ok(g.contiguous())
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    views = [qkv.clone().requires_grad_()]
    o = FA.flash_attention(*views[0].unbind(2), causal=True)
    got = torch.autograd.grad(o, views, g)[0].unbind(2)
    o2 = FA.flash_attention(*leaves, causal=True)
    want = torch.autograd.grad(o2, leaves, g.contiguous())
    assert torch.equal(o, o2)
    for x, w in zip(got, want):
        assert torch.equal(x, w)
    lse = FA._fwd_bthd(q, k, v, True, d ** -0.5)[1]
    for x, w in zip(FA._bwd_bthd(q, k, v, o2.detach(), lse, g, True,
                                 d ** -0.5), want):
        assert torch.equal(x, w)


def test_f32_strides_rule_is_the_16_byte_rule():
    """What the f32 kernels read as it lies: d contiguous, every stepped
    (b, t, h) stride a multiple of 4 floats (16 bytes), the base 16-byte
    aligned; a dimension of size 1 is never stepped.  An operand that
    breaks it is refused (``_bthd_strides``), never copied."""
    x = torch.zeros(2, 9, 3, 16)
    assert FA._bthd_ok(x)
    assert FA._bthd_strides(x, "q") == (9 * 3 * 16, 3 * 16, 16)
    assert FA._bthd_ok(x[:, :, :1])                        # h of size 1
    assert FA._bthd_strides(x[:1, :, :1], "q") == (4, 3 * 16, 4)
    assert FA._bthd_ok(torch.zeros(2, 9, 3, 20)[..., :16])  # h stride 20
    bad = {
        "d strided": x.permute(0, 1, 3, 2).contiguous().permute(0, 1, 3, 2),
        "base off 16": torch.zeros(2, 9, 3, 18)[..., 2:18],
        "h stride 18": torch.zeros(2, 9, 3, 18)[..., :16],
        "t stride 3 x 17": torch.zeros(2, 9, 3, 17)[..., :16],
    }
    for name, y in bad.items():
        assert not FA._bthd_ok(y), name
        with pytest.raises(EnforceError, match="16 bytes"):
            FA._bthd_strides(y, "k")
    # the bf16 form's rule is the same in bytes: 8 elements
    assert FA._bthd_ok(torch.zeros(2, 9, 3, 72, dtype=torch.bfloat16)
                       [..., :64])
    assert not FA._bthd_ok(torch.zeros(2, 9, 3, 68, dtype=torch.bfloat16)
                           [..., :64])


@pytest.mark.parametrize("causal", [True, False])
def test_f32_padded_rows_lse_is_finite_and_the_padded_problems(causal,
                                                              rng_np):
    """The in-place forward returns lse for all Tqp rows: the padded query
    rows (q = 0) finite and equal to the padded problem's, since the
    backward recomputes P = exp(S scale - lse) there and multiplies it by
    a zero dO (an infinite lse would give NaN)."""
    b, t, h, d = 2, 70, 2, 16
    q, k, v, _ = map(torch.from_numpy, _problem(rng_np, b, t, t, h, d))
    o, lse = FA._fwd_bthd(q, k, v, causal, d ** -0.5)
    assert lse.shape == (b * h, 128, 1)
    assert torch.isfinite(lse).all()
    want = _padded_twin(q, k, v, causal, d ** -0.5)[1]
    assert torch.equal(lse, want)
    # q = 0 on a padded row: uniform scores over the keys it may see
    seen = np.minimum(np.arange(t, 128) + 1, t) if causal else t
    np.testing.assert_allclose(lse.view(b * h, 128)[:, t:].numpy(),
                               np.broadcast_to(np.log(seen), (b * h, 128 - t)),
                               rtol=1e-6)


def test_f32_route_refuses_other_head_dims_on_the_kernel_path():
    """The in-place forms' dtype and head-dim rule (the card's kernels
    take f32 at every head dim of HEAD_DIMS, bf16 at WGMMA_HEAD_DIMS);
    mixed dtypes are refused."""
    f32 = torch.zeros(1, 64, 1, 48)
    with pytest.raises(EnforceError, match="head_dim"):
        FA._bthd_kernels((f32,) * 3, 48)
    assert FA._bthd_kernels((f32,) * 3, 64) == FA.FORMS[torch.float32]
    with pytest.raises(EnforceError, match="one dtype"):
        FA._bthd_kernels((f32, f32.bfloat16(), f32), 64)
    bf = torch.zeros(1, 64, 1, 32, dtype=torch.bfloat16)
    with pytest.raises(EnforceError, match="head_dim"):
        FA._bthd_kernels((bf,) * 3, 32)

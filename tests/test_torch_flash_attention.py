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


# -- bf16 -----------------------------------------------------------------------
#
# bf16 q, k, v: the port's bf16 twins (the arithmetic of the bf16 kernels)
# against the JAX kernels given bf16 operands, in interpret mode.  At
# block_q = block_k = 64 JAX's tiled kernels round where the port rounds
# (P against the running max of 64-key tiles, dS, the outputs once), so
# the two agree up to f32 order: ``chip_smoke.bf16_agrees`` with
# ``FLASH_BF16_FLIP`` (unequal on at most 1% of the elements, each within
# one bf16 ulp at the larger magnitude plus 2^-7 of its sum of |terms|, a
# rounded P or dS flipped one ulp the other way).  At JAX's default block
# (one tile up to T = 1024) JAX rounds P against the row's global max, so
# both are held against float64 instead.

BF16_SHAPES = SHAPES + [(1, 200, 200, 2, 64)]  # causal past three tiles


def _bf16_inputs(rng, b, t_q, t_k, h, d):
    """The same bf16 q, k, v and cotangent for both packages:
    ((jax arrays), (torch tensors))."""
    js, ts = [], []
    for t in (t_q, t_k, t_k, t_q):
        x = jnp.asarray(rng.normal(size=(b, t, h, d)).astype(np.float32),
                        jnp.bfloat16)
        js.append(x)
        ts.append(_torch_bf16(x))
    return js, ts


def _torch_bf16(x):
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32))
                            ).to(torch.bfloat16)


def _port_bf16(q, k, v, g, causal):
    """(o, dq, dk, dv) of the port's Function on bf16 CPU tensors."""
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = FA.flash_attention(*leaves, causal=causal)
    return (o.detach(), *torch.autograd.grad(o, leaves, g))


def _jax_bf16(jq, jk, jv, jg, causal, block):
    jo, res = JFA._flash_fwd(jq, jk, jv, causal, None, block, block, True)
    want = (jo, *JFA._flash_bwd(causal, None, block, block, True, res, jg))
    return [_torch_bf16(w) for w in want], res[4]


def _bf16_mags(q, k, v, g, causal):
    """``chip_smoke.flash_bf16_mags`` of o, dq, dk, dv in [B, T, H, D]."""
    import chip_smoke as S

    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    scale = d ** -0.5
    qp, kp, vp = FA._prep(q, k, v)
    dop = FA._prep(g, g, g)[0]
    o, lse = FA._fwd_plain(qp, kp, vp, t_k, causal, scale)
    mags = S.flash_bf16_mags(qp, kp, vp, o, lse, dop, t_k, causal, scale)
    return [FA._from_bh(m, b, h, t, d)
            for m, t in zip(mags, (t_q, t_q, t_k, t_k))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,t_q,t_k,h,d", BF16_SHAPES)
def test_bf16_matches_jax_kernels_at_64_blocks(b, t_q, t_k, h, d, causal,
                                               rng_np):
    """o, dq, dk, dv in bf16 against JAX's tiled kernels at 64 x 64
    blocks by ``bf16_agrees`` [measured: unequal on at most 0.19% of an
    output's elements, at most 0.15 of the per-element bound]; lse within
    2e-5 (f32)."""
    import chip_smoke as S

    js, ts = _bf16_inputs(rng_np, b, t_q, t_k, h, d)
    want, jlse = _jax_bf16(*js, causal, 64)
    got = _port_bf16(*ts, causal)
    mags = _bf16_mags(*ts, causal)
    for name, x, w, m in zip(("o", "dq", "dk", "dv"), got, want, mags):
        assert x.dtype == torch.bfloat16 and x.shape == w.shape, name
        a = S.bf16_agreement(x, w, m, coef=S.FLASH_BF16_FLIP)
        assert S.bf16_agrees(x, w, m, coef=S.FLASH_BF16_FLIP), (name, a)
    lse = FA.flash_attention_fwd(*ts[:3], causal=causal)[1]
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :t_q], **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,t_q,t_k,h,d", BF16_SHAPES)
def test_bf16_forward_twin_matches_jax_at_the_hopper_tiles(b, t_q, t_k, h,
                                                          d, causal, rng_np):
    """The Hopper form's tiles (``csrc/flash_attention.cu``, ``hop``): 128
    query rows a block, 64 keys a tile.  JAX's tiled forward at
    ``block_q=128, block_k=64`` (interpret mode) rounds P against the
    running max of the same 64-key tiles, so the twin's o agrees with it by
    ``bf16_agrees`` [as at 64 x 64: equal but for f32 order] and its lse
    within 2e-5."""
    import chip_smoke as S

    js, ts = _bf16_inputs(rng_np, b, t_q, t_k, h, d)
    jo, jlse, _ = JFA._fwd_impl(*js[:3], causal, None, 128, 64, True)
    want = _torch_bf16(JFA._from_bh(jo, b, h, t_q, d))
    o, lse = FA.flash_attention_fwd(*ts[:3], causal=causal)
    mag = _bf16_mags(*ts, causal)[0]
    assert o.dtype == torch.bfloat16 and o.shape == want.shape
    assert S.bf16_agrees(o, want, mag, coef=S.FLASH_BF16_FLIP), \
        S.bf16_agreement(o, want, mag, coef=S.FLASH_BF16_FLIP)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :t_q], **TOL)


def _share_of_flip_bound(got, want, mag) -> float:
    """The largest |got - want| / (one bf16 ulp at the larger magnitude +
    2^-7 mag), element by element (``want`` in any float dtype)."""
    import chip_smoke as S

    g, w = got.double(), want.double()
    top = torch.maximum(g.abs(), w.abs())
    ulp = torch.ldexp(torch.ones_like(top), torch.frexp(top)[1] - 8)
    return float(((g - w).abs() / (ulp + S.FLASH_BF16_FLIP * mag)).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,t_q,t_k,h,d", BF16_SHAPES)
def test_bf16_against_float64_beside_jax_at_its_default_block(
        b, t_q, t_k, h, d, causal, rng_np):
    """At JAX's default block (one tile: P rounded against the row's
    global max, where the port rounds against the running max of 64-key
    tiles) both packages against exact attention in float64 of the same
    bf16 values: each of o, dq, dk, dv within 2^-8 relative norm [measured:
    3.0e-3 at most] and the port within 1.1x JAX's [1.02x], and every
    element within one bf16 ulp at the larger magnitude plus 2^-7 of its
    sum of |terms| [at most 0.43 of it]."""
    js, ts = _bf16_inputs(rng_np, b, t_q, t_k, h, d)
    want, _ = _jax_bf16(*js, causal, 1024)
    got = _port_bf16(*ts, causal)
    wide = [x.double().requires_grad_() for x in ts[:3]]
    o64 = FA.flash_attention_reference(*wide, causal=causal)
    exact = (o64.detach(), *torch.autograd.grad(o64, wide, ts[3].double()))
    mags = _bf16_mags(*ts, causal)
    for name, x, w, e, m in zip(("o", "dq", "dk", "dv"), got, want, exact,
                                mags):
        err_p = float(torch.linalg.norm(x.double() - e) / torch.linalg.norm(e))
        err_j = float(torch.linalg.norm(w.double() - e) / torch.linalg.norm(e))
        assert err_p <= 2.0 ** -8 and err_p <= 1.1 * err_j, (name, err_p,
                                                             err_j)
        assert _share_of_flip_bound(x, e, m) <= 1.0, name
        assert _share_of_flip_bound(w, e, m) <= 1.0, name


def test_bf16_planted_faults_fail_the_criterion(rng_np):
    """``chip_smoke.flash_bf16_faults`` (an accumulator rounded to bf16
    every 16 terms, delta dropped, the diagonal tile's mask off) each fail
    ``bf16_agrees`` against the twins on every output they move [measured:
    unequal on 45-58% (the accumulator) and 97-99% of the elements]; JAX's
    tiled kernels pass it
    (``test_bf16_matches_jax_kernels_at_64_blocks``)."""
    import chip_smoke as S

    b, t, h, d = 2, 200, 2, 64
    _, (q, k, v, g) = _bf16_inputs(rng_np, b, t, t, h, d)
    scale = d ** -0.5
    qp, kp, vp = FA._prep(q, k, v)
    dop = FA._prep(g, g, g)[0]
    o, lse = FA._fwd_plain(qp, kp, vp, t, True, scale)
    args = (qp, kp, vp, lse, dop, FA._delta(dop, o), t, True, scale)
    want = {"o": o, "dq": FA._bwd_dq_plain(*args)}
    want["dk"], want["dv"] = FA._bwd_dkv_plain(*args)
    mags = dict(zip(("o", "dq", "dk", "dv"), S.flash_bf16_mags(
        qp, kp, vp, o, lse, dop, t, True, scale)))
    faults = S.flash_bf16_faults(*args)
    assert sorted(faults) == sorted(S.FLASH_BF16_FAULTS)
    for fault, outs in S.FLASH_BF16_FAULTS.items():
        assert sorted(faults[fault]) == sorted(outs)
        for n in outs:
            bad, w, m = (x[:, :t] for x in (faults[fault][n], want[n],
                                            mags[n]))
            assert not S.bf16_agrees(bad, w, m, coef=S.FLASH_BF16_FLIP), (
                fault, n, S.bf16_agreement(bad, w, m,
                                           coef=S.FLASH_BF16_FLIP))


def test_bf16_twins_round_where_the_kernels_do(rng_np):
    """The bf16 forward twin is the online softmax over 64-key tiles: at
    T <= 64 (one tile) it equals the single softmax of the same f32
    scores with P rounded once; past one tile P is rounded against the
    running max, which differs from the global max's rounding.  The f32
    twin keeps its single softmax.  bf16 CPU tensors take the twins and
    launch nothing; lse and delta stay f32; the outputs are bf16."""
    _, (q, k, v, g) = _bf16_inputs(rng_np, 1, 130, 130, 2, 16)
    scale = 16 ** -0.5
    qp, kp, vp = FA._prep(q, k, v)
    o, lse = FA._fwd_plain(qp, kp, vp, 130, True, scale)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    s = torch.einsum("bqd,bkd->bqk", qp.float(), kp.float()) * scale
    valid = FA._valid(qp.shape[1], kp.shape[1], 130, True, qp.device)
    s = torch.where(valid[None], s, s.new_tensor(-1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    once = (torch.einsum("bqk,bkd->bqd", p.to(torch.bfloat16).float(),
                         vp.float()) / p.sum(-1, keepdim=True)
            ).to(torch.bfloat16)
    assert torch.equal(o[:, :64], once[:, :64])    # one tile: the same
    assert not torch.equal(o[:, 64:130], once[:, 64:130])
    counts = [kern.launches for form in FA.FORMS.values() for kern in form]
    got = _port_bf16(q, k, v, g, True)
    assert [kern.launches for form in FA.FORMS.values()
            for kern in form] == counts
    assert all(x.dtype == torch.bfloat16 for x in got)
    dop = FA._prep(g, g, g)[0]
    assert FA._delta(dop, o).dtype == torch.float32

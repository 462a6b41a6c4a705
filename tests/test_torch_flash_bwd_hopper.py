"""The host side of the flash backward's redesigned forms (PERF.md row 3),
on the CPU: the Hopper bf16 route (``flash_attention._bwd_bthd``: delta
from dO and o as they lie in [B, T, H, D], the forward's lse rows read
in place, dq, dk, dv written [B, T, H, D]) against the padded route's
twin bit for bit, and a numpy model of the f32 form's 3xTF32 products
against float64.  The CUDA kernels themselves are held to the same twins
on the card (``test_torch_cuda.py``, ``chip_smoke.py``)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_attention as FA

JFA = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

SHAPES = [
    # b, t_q, t_k, h, d, causal
    (2, 64, 64, 2, 64, True),     # one tile
    (1, 130, 130, 2, 64, True),   # ragged: padded to 192
    (1, 100, 100, 2, 128, False),
    (2, 40, 90, 1, 64, True),     # t_q < t_k
    (1, 150, 70, 2, 64, False),   # t_q > t_k
]


def _bf16(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        torch.bfloat16)


def _problem(rng, b, t_q, t_k, h, d):
    q = _bf16(rng, b, t_q, h, d)
    k, v = _bf16(rng, b, t_k, h, d), _bf16(rng, b, t_k, h, d)
    g = _bf16(rng, b, t_q, h, d)
    return q, k, v, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t_q,t_k,h,d,causal", SHAPES)
def test_delta_from_bthd_equals_the_padded_delta(b, t_q, t_k, h, d, causal,
                                                 dtype, rng_np):
    """delta from dO and o as they lie, [B*H, Tqp] with the padded rows
    0, equals ``_delta`` on the padded route bit for bit."""
    do, o = (x.to(dtype) for x in _problem(rng_np, b, t_q, t_k, h, d)[::3])
    tqp = FA.round_up(t_q, FA.BLOCK)
    got = FA._delta_bthd(do, o, tqp)
    want = FA._delta(FA._to_bh(do), FA._to_bh(o))
    assert got.shape == (b * h, tqp) and got.is_contiguous()
    assert got.dtype == torch.float32
    assert torch.equal(got, want.reshape(b * h, tqp))
    assert not got.view(b, h, tqp)[:, :, t_q:].any()


@pytest.mark.parametrize("b,t_q,t_k,h,d,causal", SHAPES)
def test_bthd_route_equals_the_padded_twin(b, t_q, t_k, h, d, causal,
                                           rng_np):
    """The Hopper route's host side on CPU tensors (its wrappers take the
    twins there): dq, dk, dv [B, T, H, D] contiguous from the forward's
    whole lse [B*H, Tqp, 1], equal to the padded route's ``_bwd_plain``
    cut to the valid rows, bit for bit, at ragged T and t_q != t_k."""
    q, k, v, g = _problem(rng_np, b, t_q, t_k, h, d)
    scale = d ** -0.5
    qp, kp, vp = FA._prep(q, k, v)
    op, lse = FA._fwd_plain(qp, kp, vp, t_k, causal, scale)
    o = FA._from_bh(op, b, h, t_q, d)
    got = FA._bwd_bthd(q, k, v, o, lse, g, causal, scale)
    want = FA._bwd_plain(qp, kp, vp, op, lse, FA._to_bh(g), t_k, causal,
                         scale)
    for x, w, t in zip(got, want, (t_q, t_k, t_k)):
        assert x.shape == (b, t, h, d) and x.is_contiguous()
        assert x.dtype == torch.bfloat16
        assert torch.equal(x, FA._from_bh(w, b, h, t, d))


def test_bthd_route_reads_views_and_copies_an_untakeable_gradient(rng_np):
    """q, k, v as strided views of one [B, T, 3, H, D] projection and an
    expanded upstream gradient (strides 0, which TMA cannot read): the
    route gives what it gives on contiguous copies, and the expanded
    gradient is the one the wrapper copies."""
    b, t, h, d = 1, 70, 2, 64
    qkv = _bf16(rng_np, b, t, 3, h, d)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous() and FA._bthd_ok(q)
    g = torch.ones((), dtype=torch.bfloat16).expand(b, t, h, d)
    assert not FA._bthd_ok(g)
    scale = d ** -0.5
    qp, kp, vp = FA._prep(q, k, v)
    op, lse = FA._fwd_plain(qp, kp, vp, t, True, scale)
    o = FA._from_bh(op, b, h, t, d)
    got = FA._bwd_bthd(q, k, v, o, lse, g, True, scale)
    want = FA._bwd_bthd(*(x.contiguous() for x in (q, k, v, o)), lse,
                         g.contiguous(), True, scale)
    for x, w in zip(got, want):
        assert torch.equal(x, w)


def test_tma_ok_names_what_tma_reads():
    """TMA's rule for a [B, T, H, D] bf16 operand: d contiguous, stepped
    (b, t, h) strides multiples of 8 elements (16 bytes); a dimension of
    size 1 is never stepped."""
    x = torch.zeros(2, 9, 3, 64, dtype=torch.bfloat16)
    assert FA._bthd_ok(x)
    assert FA._bthd_ok(x[:, :, :1])                       # h of size 1
    assert not FA._bthd_ok(x.permute(0, 1, 3, 2).contiguous()
                          .permute(0, 1, 3, 2))           # d strided
    assert not FA._bthd_ok(torch.zeros(2, 9, 3, 68, dtype=torch.bfloat16)
                          [..., 2:66])                    # base off 16
    wide = torch.zeros(2, 9, 3, 68, dtype=torch.bfloat16)[..., :64]
    assert not FA._bthd_ok(wide)                           # h stride 68
    assert FA._bthd_ok(torch.zeros(2, 9, 3, 72, dtype=torch.bfloat16)
                      [..., :64])                         # h stride 72


def test_bthd_route_matches_the_jax_backward(rng_np):
    """The route on the CPU against JAX's ``_flash_bwd`` in interpret mode
    on the same bf16 inputs (its tiled dQ and dK/dV kernels at 64 x 64
    blocks, whose rounding points the twins share): dq, dk, dv agree
    within one bf16 ulp plus 2^-7 of their size, as the twins do."""
    b, t, h, d = 1, 130, 2, 64
    q, k, v, g = _problem(rng_np, b, t, t, h, d)
    scale = d ** -0.5
    jq, jk, jv, jg = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                      for x in (q, k, v, g))
    _, res = JFA._flash_fwd(jq, jk, jv, True, scale, 64, 64, True)
    want = JFA._flash_bwd(True, scale, 64, 64, True, res, jg)
    qp, kp, vp = FA._prep(q, k, v)
    op, lse = FA._fwd_plain(qp, kp, vp, t, True, scale)
    got = FA._bwd_bthd(q, k, v, FA._from_bh(op, b, h, t, d), lse, g, True,
                        scale)
    for x, w in zip(got, want):
        w = torch.from_numpy(np.array(w.astype(jnp.float32)))
        gap = (x.float() - w).abs()
        assert (gap <= 2 ** -8 * w.abs() + 2 ** -7 * w.abs().max()).all()


# -- the f32 form's products: a numpy model of 3xTF32 ------------------------


def _tf32(x):
    """f32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds (finite values)."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _chunked(a, b, passes):
    """a @ b as the m16n8k8 tensor-core form sums it: 8-deep slices of the
    reduction, each pass's slice product (exact in float64) added to one
    f32 accumulator and rounded, the passes in order."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for pa, pb in passes:
            part = pa[:, k0:k0 + 8].astype(np.float64) @ \
                pb[k0:k0 + 8].astype(np.float64)
            acc = (acc.astype(np.float64) + part).astype(np.float32)
    return acc


def _fma_chain(a, b):
    """a @ b as f32 FMAs in order, one rounding a term (the CUDA-core
    form this replaces)."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    for i in range(a.shape[1]):
        acc = (acc.astype(np.float64)
               + a64[:, i:i + 1] * b64[i:i + 1]).astype(np.float32)
    return acc


def _rel(x, want):
    return float(np.linalg.norm(x.astype(np.float64) - want)
                 / np.linalg.norm(want))


@pytest.mark.parametrize("product", ["S = Q K^T", "dV = P^T dO"])
def test_3xtf32_model_stays_near_f32_and_one_pass_does_not(product, rng_np):
    """At the LM's magnitudes (q, k, dO ~ N(0, 1); P a causal softmax row
    set over 1024 keys, each row summing to 1): hi = tf32(a) and lo =
    tf32(a - hi), both rounded to nearest, and hi.hi + hi.lo + lo.hi
    summed in f32 lie within 4x of f32 FMAs' error against float64;
    one pass of TF32 (hi.hi) lies at least 100x above it."""
    if product == "S = Q K^T":
        a = rng_np.normal(size=(64, 64)).astype(np.float32)
        b = rng_np.normal(size=(64, 64)).astype(np.float32)
    else:
        # S scale ~ N(0, 1) over 1024 queries x 1024 keys, causal; P's
        # rows normalised over their keys; P^T of the first 64 keys
        s = rng_np.normal(size=(1024, 1024))
        s = np.where(np.tri(1024, dtype=bool), s, -np.inf)
        p = np.exp(s - s.max(axis=1, keepdims=True))
        p /= p.sum(axis=1, keepdims=True)
        a = p[:, :64].T.astype(np.float32)            # P^T [64, 1024]
        b = rng_np.normal(size=(1024, 64)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    f32 = _rel(_fma_chain(a, b), want)
    three = _rel(_chunked(a, b, [(al, bh), (ah, bl), (ah, bh)]), want)
    one = _rel(_chunked(a, b, [(ah, bh)]), want)
    assert 0 < three <= 4 * f32, (three, f32)
    assert one >= 100 * f32, (one, f32)


def _truncated(x):
    """float64 -> f32 toward zero: how the tensor cores round the sums
    they add into an f32 accumulator."""
    f = x.astype(np.float32)
    return np.where(np.abs(f.astype(np.float64)) > np.abs(x),
                    np.nextafter(f, np.float32(0)), f)


def _causal_softmax(rng, t):
    """A causal softmax row set over t keys, scores ~ N(0, 1): [t, t]."""
    s = rng.normal(size=(t, t))
    s = np.where(np.tri(t, dtype=bool), s, -np.inf)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    return p / p.sum(axis=1, keepdims=True)


def _slice_sums(a, b, passes):
    """a @ b over 8-deep slices as the tensor cores sum it, each sum they
    round truncated: (every slice's passes chained into one accumulator,
    each slice's passes summed apart from zero and added to the
    accumulator to nearest as the kernels' ``mma3_add`` does)."""
    shape = (a.shape[0], b.shape[1])
    chained = np.zeros(shape, np.float32)
    apart = np.zeros(shape, np.float32)
    for k0 in range(0, a.shape[1], 8):
        part = np.zeros(shape, np.float32)
        for pa, pb in passes:
            x = pa[:, k0:k0 + 8].astype(np.float64) @ \
                pb[k0:k0 + 8].astype(np.float64)
            chained = _truncated(chained.astype(np.float64) + x)
            part = _truncated(part.astype(np.float64) + x)
        apart = (apart.astype(np.float64) + part).astype(np.float32)
    return chained, apart


def _three_passes(a, b):
    ah, bh = _tf32(a), _tf32(b)
    return [(_tf32(a - ah), bh), (ah, _tf32(b - bh)), (ah, bh)]


def test_3xtf32_long_sums_need_each_slice_summed_apart(rng_np):
    """The tensor cores truncate each sum they round.  dV = P^T dO over
    1024 queries as 128 slices of three passes chained into one
    accumulator drifts toward zero: >= 5x f32 FMAs' error against
    float64 (the first 3xTF32 backward's 1.1e-5 on the card); each
    slice's passes summed apart from zero and added to the accumulator
    to nearest (the kernels' ``mma3_add``) stay within 2x of it."""
    t = 1024
    a = _causal_softmax(rng_np, t)[:, :64].T.astype(np.float32)
    b = rng_np.normal(size=(t, 64)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    chained, apart = _slice_sums(a, b, _three_passes(a, b))
    f32 = _rel(_fma_chain(a, b), want)
    assert _rel(chained, want) >= 5 * f32
    assert _rel(apart, want) <= 2 * f32


def test_3xtf32_forward_o_needs_each_slice_summed_apart(rng_np):
    """The f32 forward's O = P V over T 1024 keys (P the last 64 query
    rows of a causal softmax row set, which see every key; V ~ N(0, 1)):
    each slice's three passes summed apart and added to O to nearest (the
    forward's ``mma3_add``) stay within 2x of f32 FMAs' error against
    float64; chained into O they drift >= 5x above it (the planted
    ``o_chained`` fault), and one TF32 pass (hi.hi, ``one_pass_tf32``)
    lies >= 100x above it."""
    t = 1024
    a = _causal_softmax(rng_np, t)[-64:].astype(np.float32)   # P [64, T]
    b = rng_np.normal(size=(t, 64)).astype(np.float32)          # V [T, 64]
    want = a.astype(np.float64) @ b.astype(np.float64)
    chained, apart = _slice_sums(a, b, _three_passes(a, b))
    one_pass = _slice_sums(a, b, [(_tf32(a), _tf32(b))])[1]
    f32 = _rel(_fma_chain(a, b), want)
    assert _rel(apart, want) <= 2 * f32
    assert _rel(chained, want) >= 5 * f32
    assert _rel(one_pass, want) >= 100 * f32


@pytest.mark.parametrize("source,name", [
    ("flash_attention", "FLASH_WGMMA_FAULTS"),
    ("flash_attention_bwd", "FLASH_WGMMA_BWD_FAULTS"),
    ("flash_attention_bwd", "FLASH_TF32_FAULTS"),
    ("flash_attention", "FLASH_TF32_FWD_FAULTS"),
    ("paged_attention", "PAGED_F32_FAULTS"),
])
def test_planted_fault_lines_are_once_in_the_sources(source, name):
    """Every line a planted fault of the flash and paged sources changes
    (``chip_smoke.source_fault_builds`` builds them on the card) stands
    exactly once in the source or in one shared header, so each fault
    changes what it names and nothing else."""
    import chip_smoke as S
    from paddle_tpu_torch.ops.kernels import _build

    files = {p.name: p.read_text() for p in
             [_build.CSRC / f"{source}.cu", *_build.CSRC.glob("*.cuh")]}
    faults = getattr(S, name)
    assert faults
    for fault, edits in faults.items():
        for line, planted in edits:
            where = [f for f, text in files.items() if line in text]
            assert len(where) == 1, (fault, line, where)
            assert files[where[0]].count(line) == 1, (fault, line)
            assert planted != line

"""Flash attention, forward and backward (the port of
``paddle_tpu/ops/pallas/flash_attention.py``).

Public layout [B, T, H, D], as in the JAX package.  CUDA tensors launch
``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(the dQ and the dK/dV kernels).  Two routes:

- In place (:func:`_takes_bthd`: float32 at every head dim of
  ``HEAD_DIMS``, bfloat16 at ``WGMMA_HEAD_DIMS``): the kernels read q, k,
  v and dO where they lie in [B, T, H, D] (16-byte copies, so the rule of
  :func:`_bthd_ok`) and write o, dq, dk and dv there: no padded copy and
  no transpose on either pass (:func:`_fwd_bthd`, :func:`_bwd_bthd`).
  The float32 forms, ``KERNEL``, ``KERNEL_BWD_DQ`` and
  ``KERNEL_BWD_DKV``, take every product on the tensor cores as 3xTF32
  (each operand split into two TF32 parts, hi.hi + hi.lo + lo.hi); the
  bfloat16 forms, ``KERNEL_WGMMA``, ``KERNEL_BWD_DQ_WGMMA`` and
  ``KERNEL_BWD_DKV_WGMMA``, are ``wgmma`` fed by TMA.  CPU float32
  tensors take the same host functions, which run the plain twins on the
  padded problem there.
- Padded (bfloat16 at head_dim 16 and 32 on the card, and the CPU's
  other dtypes): [B*H, T, D] with T zero-padded to the kernels' 64-row
  tiles, the padding and the transposes done here; CPU tensors run the
  plain versions (:func:`_fwd_plain`, :func:`_bwd_plain`), CUDA tensors
  the ``mma.sync`` forms ``KERNEL_BF16``, ``KERNEL_BWD_DQ_BF16`` and
  ``KERNEL_BWD_DKV_BF16``.

Padded keys are masked inside every kernel; padded query rows are sliced
off.  Each form has its own launch count.  The bf16 forms have
tensor-core products with f32 sums and round where the JAX kernels round
with bf16 operands: P
before P.V and P^T dO, dS before dS K and dS^T Q, the outputs once; lse
and delta stay f32.  Their plain twins round at the same points
(:func:`_fwd_plain_tiled` runs the kernel's online softmax over 64-key
tiles, so P is rounded against the running max, as JAX's tiled
``_fwd_kernel`` does).  A bf16 CUDA tensor launches the bf16 kernels or
raises; nothing casts it to f32.

The forward writes ``o`` and ``lse`` (log-sum-exp per query row).  The
backward recomputes the probabilities from ``lse``, as the JAX
package's ``_flash_bwd`` does, with ``delta = rowsum(dO * O)`` computed
outside the kernels (:func:`_delta`; :func:`_delta_bthd` on the in-place
route).  :class:`_FlashAttention` is the ``torch.autograd.Function``
that ties the two (the JAX ``custom_vjp``); :func:`flash_attention` and
:func:`flash_attention_fwd` go through it on both devices (a call that
wants no gradient on the in-place route takes :func:`_fwd_bthd`
directly)."""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.core.dtype import at_least_f32
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops.kernels import NEG_INF, round_up
from paddle_tpu_torch.ops.kernels._build import Kernel

BLOCK = 64  # query rows per block and key rows per tile of the kernels
HEAD_DIMS = (16, 32, 64, 128)  # the head_dim values the kernels are built for

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# q, k, v, o, lse | bh, tqp, tkp, t_k, d, causal, scale, stream
_FWD_ARGS = [_P] * 5 + [_I] * 6 + [_F, _P]
# q, k, v | their (b, t, h) element strides | o, lse | b, h, t_q, t_k,
# tqp, d, causal | scale, stream
_BTHD_ARGS = ([_P] * 3 + [ctypes.c_longlong] * 9 + [_P] * 2 + [_I] * 7
              + [_F, _P])
# q, k, v, do, lse, delta, dq | the same scalars
_DQ_ARGS = [_P] * 7 + [_I] * 6 + [_F, _P]
# q, k, v, do, lse, delta, dk, dv | the same scalars
_DKV_ARGS = [_P] * 8 + [_I] * 6 + [_F, _P]
# q, k, v, do | their (b, t, h) element strides | lse, delta, dq (dk, dv)
# | b, h, t_q, t_k, tqp, d, causal | scale, stream
_BWD_BTHD_ARGS = [_P] * 4 + [ctypes.c_longlong] * 12 + [_P] * 3
_BWD_BTHD_TAIL = [_I] * 7 + [_F, _P]
#: the f32 forms: 3xTF32 on the tensor cores, in place on [B, T, H, D]
KERNEL = Kernel("flash_attention", "flash_attention_fwd_tf32x3", _BTHD_ARGS)
KERNEL_BWD_DQ = Kernel("flash_attention_bwd", "flash_attention_bwd_dq_tf32x3",
                       _BWD_BTHD_ARGS + _BWD_BTHD_TAIL)
KERNEL_BWD_DKV = Kernel("flash_attention_bwd",
                        "flash_attention_bwd_dkv_tf32x3",
                        _BWD_BTHD_ARGS + [_P] + _BWD_BTHD_TAIL)
KERNEL_BF16 = Kernel("flash_attention", "flash_attention_fwd_bf16",
                     _FWD_ARGS)
KERNEL_BWD_DQ_BF16 = Kernel("flash_attention_bwd",
                            "flash_attention_bwd_dq_bf16", _DQ_ARGS)
KERNEL_BWD_DKV_BF16 = Kernel("flash_attention_bwd",
                             "flash_attention_bwd_dkv_bf16", _DKV_ARGS)
#: the Hopper form of the bf16 forward, and the head dims it takes (the
#: others keep ``KERNEL_BF16``)
KERNEL_WGMMA = Kernel("flash_attention", "flash_attention_fwd_wgmma",
                      _BTHD_ARGS)
#: the Hopper forms of the bf16 backward (the head dims of KERNEL_WGMMA)
KERNEL_BWD_DQ_WGMMA = Kernel("flash_attention_bwd",
                             "flash_attention_bwd_dq_wgmma",
                             _BWD_BTHD_ARGS + _BWD_BTHD_TAIL)
KERNEL_BWD_DKV_WGMMA = Kernel("flash_attention_bwd",
                              "flash_attention_bwd_dkv_wgmma",
                              _BWD_BTHD_ARGS + [_P] + _BWD_BTHD_TAIL)
WGMMA_HEAD_DIMS = (64, 128)
#: {dtype: (forward, dQ, dK/dV)} kernel forms: f32's in place at every
#: head dim of HEAD_DIMS; bf16's the mma.sync forms on the padded problem
#: (its Hopper forms, at WGMMA_HEAD_DIMS, are BTHD_FORMS')
FORMS = {torch.float32: (KERNEL, KERNEL_BWD_DQ, KERNEL_BWD_DKV),
         torch.bfloat16: (KERNEL_BF16, KERNEL_BWD_DQ_BF16,
                          KERNEL_BWD_DKV_BF16)}
#: {dtype: ((forward, dQ, dK/dV), head dims)}: the in-place forms
BTHD_FORMS = {torch.float32: (FORMS[torch.float32], HEAD_DIMS),
              torch.bfloat16: ((KERNEL_WGMMA, KERNEL_BWD_DQ_WGMMA,
                                KERNEL_BWD_DKV_WGMMA), WGMMA_HEAD_DIMS)}


def _to_bh(x):
    """[B, T, H, D] -> contiguous, T-padded [B*H, Tp, D]."""
    b, t, h, d = x.shape
    x = x.permute(0, 2, 1, 3).reshape(b * h, t, d)
    return torch.nn.functional.pad(
        x, (0, 0, 0, round_up(t, BLOCK) - t)).contiguous()


def _prep(q, k, v):
    """[B, T, H, D] -> contiguous, T-padded [B*H, Tp, D], each of the
    three."""
    return _to_bh(q), _to_bh(k), _to_bh(v)


def _from_bh(x, b, h, t, d):
    return x[:, :t].reshape(b, h, t, d).permute(0, 2, 1, 3)


def _valid(tqp, tkp, t_k, causal, device):
    """[Tqp, Tkp] bool: key in range and, if causal, key <= query (absolute
    positions, as the JAX kernels' ``_causal_valid``)."""
    qi = torch.arange(tqp, device=device)[:, None]
    ki = torch.arange(tkp, device=device)[None, :]
    valid = ki < t_k
    if causal:
        valid = valid & (qi >= ki)
    return valid


def _fwd_plain(qp, kp, vp, t_k, causal, scale):
    """Plain twin of the forward kernel on the padded [BH, Tp, D] problem:
    (o [BH, Tqp, D], lse [BH, Tqp, 1]).  Computes in f32, or in the input
    dtype where it is wider; bf16 inputs take :func:`_fwd_plain_tiled`,
    the bf16 kernel's own rounding."""
    if qp.dtype == torch.bfloat16:
        return _fwd_plain_tiled(qp, kp, vp, t_k, causal, scale)
    s = torch.einsum("bqd,bkd->bqk", at_least_f32(qp), at_least_f32(kp))
    s = s * scale
    valid = _valid(qp.shape[1], kp.shape[1], t_k, causal, qp.device)
    s = torch.where(valid[None], s, s.new_tensor(NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    safe_l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bqk,bkd->bqd", p, at_least_f32(vp)) / safe_l
    return o.to(qp.dtype), m + torch.log(safe_l)


def _fwd_plain_tiled(qp, kp, vp, t_k, causal, scale):
    """Plain twin of the bf16 forward kernel: the online softmax over
    64-key tiles in f32, as JAX's tiled ``_fwd_kernel`` runs it
    (``flash_attention.py:66-80``), with P = exp(S - m_running) rounded to
    the operands' dtype before P.V and o rounded once at the end; lse in
    f32.  Causal tiles above the diagonal are skipped per 64-row query
    block, as the kernel never loads them."""
    bh, tqp, d = qp.shape
    q, k, v = qp.float(), kp.float(), vp.float()
    valid = _valid(tqp, kp.shape[1], t_k, causal, qp.device)
    m = q.new_full((bh, tqp, 1), NEG_INF)
    l = q.new_zeros((bh, tqp, 1))
    acc = q.new_zeros((bh, tqp, d))
    for j in range(kp.shape[1] // BLOCK):
        rows = slice(j * BLOCK if causal else 0, None)  # blocks at or below
        keys = slice(j * BLOCK, (j + 1) * BLOCK)
        s = torch.einsum("bqd,bkd->bqk", q[:, rows], k[:, keys]) * scale
        s = torch.where(valid[None, rows, keys], s, s.new_tensor(NEG_INF))
        m_prev = m[:, rows]
        m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m_prev - m_new)
        l[:, rows] = l[:, rows] * corr + p.sum(dim=-1, keepdim=True)
        acc[:, rows] = acc[:, rows] * corr + torch.einsum(
            "bqk,bkd->bqd", p.to(qp.dtype).float(), v[:, keys])
        m[:, rows] = m_new
    safe_l = torch.clamp(l, min=1e-30)
    return (acc / safe_l).to(qp.dtype), m + torch.log(safe_l)


def _delta(do, o):
    """delta_i = sum_d dO_i * O_i, [BH, Tqp, 1] (padded rows have dO = 0,
    so delta = 0 there); the products in f32 or the wider dtype (a bf16 o
    is widened inside the product, not copied)."""
    return (at_least_f32(do) * o).sum(dim=-1, keepdim=True)


def _probs(qp, kp, lse, t_k, causal, scale):
    """P = exp(S - lse) with the mask, recomputed from the forward's lse."""
    s = torch.einsum("bqd,bkd->bqk", qp, kp) * scale
    valid = _valid(qp.shape[1], kp.shape[1], t_k, causal, qp.device)
    return torch.exp(torch.where(valid[None], s, s.new_tensor(NEG_INF)) - lse)


def _ds(qp, kp, vp, lse, do, delta, t_k, causal, scale):
    """(P, dS = P * (dO V^T - delta) * scale), each [BH, Tqp, Tkp]."""
    p = _probs(qp, kp, lse, t_k, causal, scale)
    dp = torch.einsum("bqd,bkd->bqk", do, vp)
    return p, p * (dp - delta) * scale


def _rounded(x, dtype):
    """``x`` rounded to ``dtype`` where that is bf16 (the operand of a
    bf16 product), kept in ``x``'s dtype; else ``x`` as it is."""
    return x.to(dtype).to(x.dtype) if dtype == torch.bfloat16 else x


def _bwd_dq_plain(qp, kp, vp, lse, do, delta, t_k, causal, scale):
    """Plain twin of the dQ kernel: dQ = dS K in the operands' dtype, with
    products of bf16 operands in f32 and dS rounded to bf16 before dS K
    (JAX ``_dq_kernel`` :116)."""
    dt = qp.dtype
    q, k, v, do = map(at_least_f32, (qp, kp, vp, do))
    _, ds = _ds(q, k, v, lse, do, delta, t_k, causal, scale)
    return torch.einsum("bqk,bkd->bqd", _rounded(ds, dt), k).to(dt)


def _bwd_dkv_plain(qp, kp, vp, lse, do, delta, t_k, causal, scale):
    """Plain twin of the dK/dV kernel: dK = dS^T Q, dV = P^T dO in the
    operands' dtype, P and dS rounded to bf16 for bf16 operands (JAX
    ``_dkv_kernel`` :152, :156)."""
    dt = qp.dtype
    q, k, v, do = map(at_least_f32, (qp, kp, vp, do))
    p, ds = _ds(q, k, v, lse, do, delta, t_k, causal, scale)
    return (torch.einsum("bqk,bqd->bkd", _rounded(ds, dt), q).to(dt),
            torch.einsum("bqk,bqd->bkd", _rounded(p, dt), do).to(dt))


def _bwd_plain(qp, kp, vp, o, lse, do, t_k, causal, scale):
    """Plain twin of the backward on the padded problem: (dq, dk, dv) in
    the inputs' dtype, computed in f32 or the wider input dtype."""
    args = (lse.to(at_least_f32(qp).dtype), do, _delta(do, o), t_k, causal,
            scale)
    return (_bwd_dq_plain(qp, kp, vp, *args),
            *_bwd_dkv_plain(qp, kp, vp, *args))


def _check(q, k, v):
    """The public entries' checks; the messages are formatted only on a
    refusal (the checks run on every call)."""
    if not (q.dim() == 4 and k.dim() == 4 and k.shape == v.shape):
        enforce(False, f"q/k/v must be [B, T, H, D] with k.shape == v.shape,"
                f" got {tuple(q.shape)} / {tuple(k.shape)} / "
                f"{tuple(v.shape)}")
    if not (q.shape[0] == k.shape[0] and q.shape[2:] == k.shape[2:]):
        enforce(False, f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                f"in B, H or D")
    if not q.dtype == k.dtype == v.dtype:
        enforce(False, f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    if not q.device == k.device == v.device:
        enforce(False, f"q/k/v on several devices: {q.device} {k.device} "
                f"{v.device}")


def _check_kernel_args(*xs):
    """What the CUDA kernels take on the padded problem: bfloat16 (float32
    takes its in-place forms, :func:`_fwd_bthd`), all of one dtype,
    head_dim in HEAD_DIMS, contiguous [BH, Tp, D] with Tp a multiple of
    64, 16-byte aligned (16-byte copies).  Returns the bf16 forms
    (``FORMS``)."""
    enforce(xs[0].device.type == "cuda", f"no kernel for device {xs[0].device}")
    if not all(x.dtype == torch.bfloat16 for x in xs):
        enforce(False, f"the padded flash kernels take bfloat16 (float32 "
                f"reads [B, T, H, D] in place), one dtype, got "
                f"{[str(x.dtype) for x in xs]}")
    d = xs[0].shape[-1]
    enforce(d in HEAD_DIMS, f"head_dim {d} not in {HEAD_DIMS}")
    enforce(all(x.is_contiguous() and x.shape[1] % BLOCK == 0 for x in xs),
            "the flash kernels need contiguous, 64-row padded inputs")
    enforce(all(x.data_ptr() % 16 == 0 for x in xs),
            "the flash kernels need 16-byte aligned inputs")
    return FORMS[torch.bfloat16]


def _fwd_kernel(qp, kp, vp, t_k, causal, scale):
    """The bf16 CUDA forward kernel on the padded [BH, Tp, D] problem (the
    same contract as :func:`_fwd_plain`)."""
    kernel = _check_kernel_args(qp, kp, vp)[0]
    bh, tqp, d = qp.shape
    o = torch.empty_like(qp)
    lse = torch.empty((bh, tqp, 1), dtype=torch.float32, device=qp.device)
    if bh:
        kernel.launch_on(qp.device.index, qp.data_ptr(), kp.data_ptr(),
                         vp.data_ptr(), o.data_ptr(), lse.data_ptr(), bh,
                         tqp, kp.shape[1], t_k, d, int(bool(causal)),
                         float(scale))
    return o, lse


def _takes_bthd(q) -> bool:
    """The rule between the routes: the in-place one for a float32 q (on
    the card every head dim of ``HEAD_DIMS``; on the CPU its host code
    with the twins) and a bf16 CUDA q whose head_dim the Hopper form
    takes (``WGMMA_HEAD_DIMS``); the padded one for the rest."""
    return q.dtype == torch.float32 or (
        q.dtype == torch.bfloat16 and q.device.type == "cuda"
        and q.shape[-1] in WGMMA_HEAD_DIMS)


def _bthd_ok(x) -> bool:
    """Whether the in-place kernels read the [B, T, H, D] ``x`` as it lies
    (bf16 by TMA, f32 by 16-byte cp.async): d contiguous, every stepped
    (b, t, h) stride a multiple of 16 bytes (8 bf16, 4 floats), the base
    16-byte aligned."""
    st, unit = x.stride(), 16 // x.element_size()
    return (st[3] == 1 and x.data_ptr() % 16 == 0
            and all(s % unit == 0 for s, n in zip(st[:3], x.shape[:3])
                    if n > 1))


def _bthd_strides(x, name: str) -> tuple:
    """(b, t, h) element strides of a [B, T, H, D] operand as the in-place
    kernels take them (:func:`_bthd_ok`), or a refusal: q, k and v are
    never copied (a caller holding another layout makes its own copy).  A
    dimension of size 1 is never stepped, so any stride stands for it."""
    if not _bthd_ok(x):
        enforce(False, f"the in-place flash kernels read {name} as it lies: "
                f"d must be contiguous, the base 16-byte aligned and the "
                f"(b, t, h) strides multiples of 16 bytes, got strides "
                f"{x.stride()} at {x.data_ptr() % 16} bytes past 16")
    unit = 16 // x.element_size()
    return tuple(s if n > 1 else unit for s, n in zip(x.stride()[:3],
                                                      x.shape[:3]))


def _bthd_kernels(xs, d: int) -> tuple:
    """The in-place forms (forward, dQ, dK/dV) of the operands' dtype
    (``BTHD_FORMS``): all of one dtype, float32 with head_dim in
    ``HEAD_DIMS`` or bfloat16 with head_dim in ``WGMMA_HEAD_DIMS``; or a
    refusal."""
    dt = xs[0].dtype
    form = BTHD_FORMS.get(dt)
    if form is None or d not in form[1] or any(x.dtype != dt for x in xs):
        enforce(False, f"the in-place flash kernels take float32 with "
                f"head_dim in {HEAD_DIMS} or bfloat16 with head_dim in "
                f"{WGMMA_HEAD_DIMS}, one dtype; got "
                f"{[str(x.dtype) for x in xs]}, head_dim {d}")
    return form[0]


def _fwd_bthd(q, k, v, causal, scale):
    """The forward on [B, T, H, D] views as they lie: (o [B, Tq, H, D]
    contiguous, lse [B*H, Tqp, 1] f32 with Tqp = Tq rounded up to 64, the
    padded rows' lse as the padded problem's).  CUDA tensors launch the
    in-place form of their dtype (``KERNEL``: f32, 3xTF32; ``KERNEL_WGMMA``:
    bf16), which reads q, k and v where they lie or refuses
    (:func:`_bthd_strides`); CPU tensors take :func:`_fwd_plain` on the
    padded problem."""
    b, t_q, h, d = q.shape
    if q.device.type == "cpu":
        qp, kp, vp = _prep(q, k, v)
        o, lse = _fwd_plain(qp, kp, vp, k.shape[1], causal, scale)
        return _from_bh(o, b, h, t_q, d).contiguous(), lse
    kernel = _bthd_kernels((q, k, v), d)[0]
    strides = (*_bthd_strides(q, "q"), *_bthd_strides(k, "k"),
               *_bthd_strides(v, "v"))
    tqp = round_up(t_q, BLOCK)
    o = torch.empty((b, t_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, tqp, 1), dtype=torch.float32, device=q.device)
    if b * h and t_q and k.shape[1]:
        kernel.launch_on(
            q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *strides, o.data_ptr(), lse.data_ptr(), b, h, t_q, k.shape[1],
            tqp, d, int(bool(causal)), float(scale))
    return o, lse


def _bwd_launch(which, qp, kp, vp, lse, do, delta, t_k, causal, scale):
    """Launch the bf16 backward kernel ``which`` (1: dQ, 2: dK/dV) on the
    padded problem."""
    kernel = _check_kernel_args(qp, kp, vp, do)[which]
    enforce(all(x.dtype == torch.float32 and x.is_contiguous()
                for x in (lse, delta)),
            "the flash backward takes the forward's f32 lse and an f32 delta")
    outs = ((torch.empty_like(qp),) if which == 1 else
            (torch.empty_like(kp), torch.empty_like(vp)))
    bh, tqp, d = qp.shape
    if bh:
        kernel.launch_on(qp.device.index,
                         *(x.data_ptr() for x in (qp, kp, vp, do, lse,
                                                  delta, *outs)),
                         bh, tqp, kp.shape[1], t_k, d, int(bool(causal)),
                         float(scale))
    return outs


def _bwd_dq_kernel(qp, kp, vp, lse, do, delta, t_k, causal, scale):
    """The dQ kernel (the contract of :func:`_bwd_dq_plain`): one block per
    64-query tile walks the key tiles up to the diagonal."""
    return _bwd_launch(1, qp, kp, vp, lse, do, delta, t_k, causal, scale)[0]


def _bwd_dkv_kernel(qp, kp, vp, lse, do, delta, t_k, causal, scale):
    """The dK/dV kernel (the contract of :func:`_bwd_dkv_plain`): one block
    per 64-key tile walks the query tiles from the diagonal down."""
    return _bwd_launch(2, qp, kp, vp, lse, do, delta, t_k, causal, scale)


def _bwd_kernel(qp, kp, vp, o, lse, do, t_k, causal, scale):
    """The two CUDA backward kernels on the padded problem (the contract
    of :func:`_bwd_plain`); each output is written by one block, no
    atomics."""
    _check_kernel_args(o)
    args = (lse, do, _delta(do, o).contiguous(), t_k, causal, scale)
    return (_bwd_dq_kernel(qp, kp, vp, *args),
            *_bwd_dkv_kernel(qp, kp, vp, *args))


def _delta_bthd(do, o, tqp):
    """delta_i = sum_d dO_i * O_i from [B, T, H, D] dO and o, as the
    contiguous [B*H, Tqp] f32 rows the Hopper backward reads: the values
    :func:`_delta` gives on the padded problem (the same products and sum
    over d), the padded rows 0."""
    b, t, h, _ = do.shape
    out = torch.zeros((b, h, tqp), dtype=torch.float32, device=do.device)
    out[:, :, :t] = (at_least_f32(do) * o).sum(dim=-1).transpose(1, 2)
    return out.view(b * h, tqp)


def _bthd_bwd_args(q, k, v, lse, do, delta):
    """The in-place backward's checks: q, k, v, dO of one dtype and a
    head_dim that its form takes (:func:`_bthd_kernels`), [B, T, H, D]
    with k.shape == v.shape and do.shape == q.shape, each readable as it
    lies (:func:`_bthd_strides`); lse and delta the contiguous f32
    [B*H, Tqp] (or [B*H, Tqp, 1]) rows, Tqp = Tq rounded up to 64.
    Returns (the forms, the pointers and strides of q, k, v, dO, Tqp)."""
    b, t_q, h, d = q.shape
    if not (k.shape == v.shape and do.shape == q.shape
            and k.shape[0] == b and k.shape[2:] == q.shape[2:]):
        enforce(False, f"the in-place flash backward takes [B, T, H, D] q, "
                f"k, v, dO with k.shape == v.shape and do.shape == q.shape,"
                f" got {[tuple(x.shape) for x in (q, k, v, do)]}")
    kernels = _bthd_kernels((q, k, v, do), d)
    tqp = round_up(t_q, BLOCK)
    for name, x in (("lse", lse), ("delta", delta)):
        if not (x.dtype == torch.float32 and x.is_contiguous()
                and x.numel() == b * h * tqp and x.shape[0] == b * h
                and x.data_ptr() % 16 == 0):
            enforce(False, f"the in-place flash backward takes {name} as "
                    f"contiguous f32 [{b * h}, {tqp}] rows, got "
                    f"{tuple(x.shape)} {x.dtype}")
    strides = [s for x, name in ((q, "q"), (k, "k"), (v, "v"), (do, "dO"))
               for s in _bthd_strides(x, name)]
    return kernels, [x.data_ptr() for x in (q, k, v, do)] + strides, tqp


def _bwd_dq_bthd(q, k, v, lse, do, delta, causal, scale):
    """The dQ kernel on [B, T, H, D] q, k, v, dO as they lie, with the
    forward's lse and :func:`_delta_bthd`'s rows: dq [B, Tq, H, D]
    contiguous (the contract of :func:`_bwd_dq_plain` on the padded
    problem).  CPU tensors take that twin."""
    b, t_q, h, d = q.shape
    if q.device.type == "cpu":
        qp, kp, vp = _prep(q, k, v)
        dq = _bwd_dq_plain(qp, kp, vp, lse.reshape(b * h, -1, 1), _to_bh(do),
                           delta.reshape(b * h, -1, 1), k.shape[1], causal,
                           scale)
        return _from_bh(dq, b, h, t_q, d).contiguous()
    kernels, ptrs, tqp = _bthd_bwd_args(q, k, v, lse, do, delta)
    dq = torch.empty((b, t_q, h, d), dtype=q.dtype, device=q.device)
    if b * h and t_q and k.shape[1]:
        kernels[1].launch_on(
            q.device.index, *ptrs, lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), b, h, t_q, k.shape[1], tqp, d, int(bool(causal)),
            float(scale))
    return dq


def _bwd_dkv_bthd(q, k, v, lse, do, delta, causal, scale):
    """The dK/dV kernel on the same operands: (dk, dv), each
    [B, Tk, H, D] contiguous (the contract of :func:`_bwd_dkv_plain` on
    the padded problem).  CPU tensors take that twin."""
    b, t_k, h, d = k.shape
    if q.device.type == "cpu":
        qp, kp, vp = _prep(q, k, v)
        dk, dv = _bwd_dkv_plain(qp, kp, vp, lse.reshape(b * h, -1, 1),
                                _to_bh(do), delta.reshape(b * h, -1, 1), t_k,
                                causal, scale)
        return (_from_bh(dk, b, h, t_k, d).contiguous(),
                _from_bh(dv, b, h, t_k, d).contiguous())
    kernels, ptrs, tqp = _bthd_bwd_args(q, k, v, lse, do, delta)
    dk, dv = (torch.empty((b, t_k, h, d), dtype=k.dtype, device=k.device)
              for _ in range(2))
    if b * h and q.shape[1] and t_k:
        kernels[2].launch_on(
            q.device.index, *ptrs, lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, q.shape[1], t_k, tqp, d,
            int(bool(causal)), float(scale))
    return dk, dv


def _bwd_bthd(q, k, v, o, lse, g, causal, scale):
    """The backward after the in-place forward: (dq, dk, dv) [B, T, H, D]
    contiguous from q, k, v, o as they lie, the forward's lse [B*H, Tqp,
    1] and the upstream gradient ``g``: delta from dO and o in [B, T, H, D]
    (:func:`_delta_bthd`), then the two kernels of q's dtype.  Nothing is
    padded or transposed.  ``g`` is read as it lies where
    :func:`_bthd_ok` takes it; one that the kernels cannot read (d not
    contiguous, a stride that is not a multiple of 16 bytes, as an
    expanded gradient's 0, or a base off 16 bytes), or one of another
    dtype, is copied once into a contiguous [B, T, H, D] tensor of q's
    dtype.  No other kernel is taken."""
    do = g.to(q.dtype)
    if not _bthd_ok(do):
        do = do.contiguous()
    delta = _delta_bthd(do, o, lse.shape[1])
    args = (lse, do, delta, causal, scale)
    return (_bwd_dq_bthd(q, k, v, *args), *_bwd_dkv_bthd(q, k, v, *args))


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its backward (JAX: ``flash_attention``'s
    ``custom_vjp``).  Saves the residuals ``_flash_fwd`` keeps: on the
    in-place route q, k, v and o as they lie and lse, which the backward
    (:func:`_bwd_bthd`) reads without a copy; on the padded route the
    padded q, k, v, o and lse.  CPU tensors take the plain versions, CUDA
    tensors the kernels (or raise)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        b, t_q, h, d = q.shape
        ctx.meta = (b, t_q, k.shape[1], h, d, causal, scale)
        ctx.padded = not _takes_bthd(q)
        if ctx.padded:
            qp, kp, vp = _prep(q, k, v)
            fwd = _fwd_plain if q.device.type == "cpu" else _fwd_kernel
            o, lse = fwd(qp, kp, vp, k.shape[1], causal, scale)
            ctx.save_for_backward(qp, kp, vp, o, lse)
            out = _from_bh(o, b, h, t_q, d)
        else:
            out, lse = _fwd_bthd(q, k, v, causal, scale)
            ctx.save_for_backward(q, k, v, out, lse)
        lse_out = lse[:, :t_q]
        ctx.mark_non_differentiable(lse_out)
        return out, lse_out

    @staticmethod
    def backward(ctx, g, _g_lse):
        qp, kp, vp, o, lse = ctx.saved_tensors
        b, t_q, t_k, h, d, causal, scale = ctx.meta
        if not ctx.padded:
            return (*_bwd_bthd(qp, kp, vp, o, lse, g, causal, scale), None,
                    None)
        do = g.permute(0, 2, 1, 3).reshape(b * h, t_q, d)
        do = torch.nn.functional.pad(
            do, (0, 0, 0, qp.shape[1] - t_q)).to(qp.dtype).contiguous()
        bwd = _bwd_plain if qp.device.type == "cpu" else _bwd_kernel
        dq, dk, dv = bwd(qp, kp, vp, o, lse, do, t_k, causal, scale)
        return (_from_bh(dq, b, h, t_q, d), _from_bh(dk, b, h, t_k, d),
                _from_bh(dv, b, h, t_k, d), None, None)


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """(o [B, Tq, H, D], lse [B*H, Tq, 1]) of softmax attention; ``o``
    carries the gradient of :class:`_FlashAttention`, ``lse`` none.

    CPU tensors take the plain versions; CUDA tensors launch the kernels
    of their dtype (float32 or bfloat16, head_dim in ``HEAD_DIMS``) or
    raise.  On the in-place route (:func:`_takes_bthd`) q, k and v are read
    as they lie: d contiguous, the base 16-byte aligned and the (b, t, h)
    strides multiples of 16 bytes (:func:`_bthd_ok`), else a refusal."""
    _check(q, k, v)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if _takes_bthd(q) and not (torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad)):
        # no gradient wanted (serving's prefill): the in-place forward
        # alone, without the autograd Function's host time
        o, lse = _fwd_bthd(q, k, v, causal, scale)
        return o, lse[:, :q.shape[1]]
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale))


def flash_attention(q, k, v, causal=False, scale=None):
    """Flash attention on [B, T, H, D] tensors: equal (to fp tolerance) to
    exact masked softmax attention."""
    return flash_attention_fwd(q, k, v, causal, scale)[0]


def flash_attention_reference(q, k, v, causal=False, scale=None):
    """Plain twin of :func:`flash_attention`: exact masked softmax
    attention on [B, T, H, D], f32 accumulation (or the input dtype where
    it is wider); autograd through it is the backward's witness."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", at_least_f32(q), at_least_f32(k))
    s = s * scale
    if causal:
        t_q, t_k = s.shape[-2], s.shape[-1]
        ok = (torch.arange(t_q, device=q.device)[:, None]
              >= torch.arange(t_k, device=q.device)[None, :])
        s = torch.where(ok[None, None], s, s.new_tensor(NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, at_least_f32(v)).to(q.dtype)

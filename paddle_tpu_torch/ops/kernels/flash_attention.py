"""Flash attention, forward (the port of
``paddle_tpu/ops/pallas/flash_attention.py``'s forward).

Public layout [B, T, H, D], as in the JAX package; the kernel runs on
[B*H, T, D] with T zero-padded to the kernel's 64-row tiles.  The padding
and the transposes are done here, in Python, so the CPU tests reach
them: CPU tensors run the same padded problem through the plain version
(:func:`_fwd_plain`), CUDA tensors launch ``csrc/flash_attention.cu``.
Padded keys are masked inside both; padded query rows are sliced off.

The forward writes ``o`` and ``lse`` (log-sum-exp per query row, the
residual a backward pass recomputes probabilities from).  The backward
kernels are a later slice."""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops.kernels import NEG_INF, round_up
from paddle_tpu_torch.ops.kernels._build import Kernel

BLOCK = 64  # query rows per block and key rows per tile of the kernel
HEAD_DIMS = (16, 32, 64, 128)  # the head_dim values the kernel is built for

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel("flash_attention", "flash_attention_fwd_f32",
                [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                 ctypes.c_float, _P])


def _prep(q, k, v):
    """[B, T, H, D] -> contiguous, T-padded [B*H, Tp, D]."""
    b, _, h, d = q.shape

    def to_bh(x):
        t = x.shape[1]
        x = x.permute(0, 2, 1, 3).reshape(b * h, t, d)
        return torch.nn.functional.pad(
            x, (0, 0, 0, round_up(t, BLOCK) - t)).contiguous()

    return to_bh(q), to_bh(k), to_bh(v)


def _from_bh(x, b, h, t, d):
    return x[:, :t].reshape(b, h, t, d).permute(0, 2, 1, 3)


def _fwd_plain(qp, kp, vp, t_k, causal, scale):
    """Plain twin of the kernel on the padded [BH, Tp, D] problem:
    (o [BH, Tqp, D], lse [BH, Tqp, 1])."""
    s = torch.einsum("bqd,bkd->bqk", qp.float(), kp.float()) * scale
    qi = torch.arange(qp.shape[1], device=qp.device)[:, None]
    ki = torch.arange(kp.shape[1], device=qp.device)[None, :]
    valid = ki < t_k
    if causal:
        valid = valid & (qi >= ki)
    s = torch.where(valid[None], s, s.new_tensor(NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    safe_l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bqk,bkd->bqd", p, vp.float()) / safe_l
    return o.to(qp.dtype), m + torch.log(safe_l)


def _check(q, k, v):
    enforce(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
            f"q/k/v must be [B, T, H, D] with k.shape == v.shape, got "
            f"{tuple(q.shape)} / {tuple(k.shape)} / {tuple(v.shape)}")
    enforce(q.shape[0] == k.shape[0] and q.shape[2:] == k.shape[2:],
            f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in B, H or D")
    enforce(q.dtype == k.dtype == v.dtype,
            f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    enforce(q.device == k.device == v.device,
            f"q/k/v on several devices: {q.device} {k.device} {v.device}")


def _fwd_kernel(qp, kp, vp, t_k, causal, scale):
    """The CUDA kernel on the padded [BH, Tp, D] problem (the same
    contract as :func:`_fwd_plain`)."""
    enforce(qp.device.type == "cuda", f"no kernel for device {qp.device}")
    enforce(qp.dtype == torch.float32,
            f"the flash kernel takes float32, got {qp.dtype}")
    bh, tqp, d = qp.shape
    enforce(d in HEAD_DIMS, f"head_dim {d} not in {HEAD_DIMS}")
    enforce(all(x.is_contiguous() for x in (qp, kp, vp))
            and tqp % BLOCK == 0 and kp.shape[1] % BLOCK == 0,
            "the flash kernel needs contiguous, 64-row padded inputs")
    o = torch.empty_like(qp)
    lse = torch.empty((bh, tqp, 1), dtype=torch.float32, device=qp.device)
    if bh:
        stream = torch.cuda.current_stream(qp.device).cuda_stream
        with torch.cuda.device(qp.device):
            KERNEL.launch(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                          o.data_ptr(), lse.data_ptr(), bh, tqp, kp.shape[1],
                          t_k, d, int(bool(causal)), float(scale), stream)
    return o, lse


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """(o [B, Tq, H, D], lse [B*H, Tq, 1] f32) of softmax attention.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32, head_dim in ``HEAD_DIMS``) or raise."""
    _check(q, k, v)
    b, t_q, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    fwd = _fwd_plain if q.device.type == "cpu" else _fwd_kernel
    o, lse = fwd(*_prep(q, k, v), k.shape[1], causal, scale)
    return _from_bh(o, b, h, t_q, d), lse[:, :t_q]


def flash_attention(q, k, v, causal=False, scale=None):
    """Flash attention on [B, T, H, D] tensors: equal (to fp tolerance) to
    exact masked softmax attention."""
    return flash_attention_fwd(q, k, v, causal, scale)[0]


def flash_attention_reference(q, k, v, causal=False, scale=None):
    """Plain twin of :func:`flash_attention`: exact masked softmax
    attention on [B, T, H, D], f32 accumulation."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t_q, t_k = s.shape[-2], s.shape[-1]
        ok = (torch.arange(t_q, device=q.device)[:, None]
              >= torch.arange(t_k, device=q.device)[None, :])
        s = torch.where(ok[None, None], s, s.new_tensor(NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)

"""Per-channel (sum, sum of squares): the training-mode batch-norm
moments from one read (the port of ``paddle_tpu/ops/pallas/tpp/conv.py``'s
``channel_stats``).

:func:`channel_stats` sums over every axis but the last, in f32: one
launch of ``csrc/channel_stats.cu`` (two passes over fixed row blocks, no
atomics, the same bits on a rerun) for a CUDA tensor, the plain twin
:func:`channel_stats_reference` for a CPU one.  Its gradient is
:func:`channel_stats_grad`, ``dx = g_s + 2 x g_ss`` in plain torch, as the
JAX package's vjp is jnp and not Pallas."""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.core.dtype import at_least_f32
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops.kernels._build import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
KERNEL = Kernel("channel_stats", "channel_stats_f32",
                [_P, _L, _I, _L, _I, _P, _P, _P, _P])

ROWS_PER_BLOCK = 256   # the least rows a block of pass 1 takes
MAX_BLOCKS = 512       # the most row blocks (pass 2 sums at most this many)


def plan(rows: int) -> tuple[int, int]:
    """(P, rows_per_block) of pass 1 for ``rows`` rows: a function of the
    row count alone, so the summation order (and the bits) do not depend
    on the card.  The P blocks cover the rows exactly."""
    p = min(MAX_BLOCKS, -(-rows // ROWS_PER_BLOCK))
    per = -(-rows // p)
    return -(-rows // per), per


def channel_stats_reference(x):
    """Plain twin: (sum [C], sum of squares [C]) over all leading axes, in
    f32 (float64 stays wide)."""
    x2 = at_least_f32(x).reshape(-1, x.shape[-1])
    return x2.sum(dim=0), (x2 * x2).sum(dim=0)


def channel_stats_grad(x, g_s, g_ss):
    """The vjp: ``dx = g_s + 2 x g_ss`` (either cotangent may be None),
    in ``x``'s dtype."""
    tensors = [t for t in (x, g_s, g_ss) if t is not None]
    enforce(len({t.device for t in tensors}) == 1,
            f"channel_stats operands on several devices: "
            f"{[str(t.device) for t in tensors]}")
    xf = at_least_f32(x)
    dx = torch.zeros_like(xf)
    if g_s is not None:
        dx = dx + g_s.to(xf.dtype)
    if g_ss is not None:
        dx = dx + 2.0 * xf * g_ss.to(xf.dtype)
    return dx.to(x.dtype)


def _launch(x):
    enforce(x.device.type == "cuda", f"no kernel for device {x.device}")
    enforce(x.dtype == torch.float32,
            f"the channel_stats kernel takes float32, got {x.dtype}")
    enforce(x.is_contiguous(), "the channel_stats kernel needs a "
            "contiguous (channels-last) input")
    enforce(x.dim() >= 1 and x.numel() > 0,
            f"channel_stats needs a non-empty input, got {tuple(x.shape)}")
    c = x.shape[-1]
    r = x.numel() // c
    p, per = plan(r)
    part = torch.empty(2, p, c, dtype=torch.float32, device=x.device)
    s = torch.empty(c, dtype=torch.float32, device=x.device)
    ss = torch.empty(c, dtype=torch.float32, device=x.device)
    KERNEL.launch(x.data_ptr(), r, c, per, p, part.data_ptr(), s.data_ptr(),
                  ss.data_ptr(), torch.cuda.current_stream().cuda_stream)
    return s, ss


class _ChannelStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _launch(x)

    @staticmethod
    def backward(ctx, g_s, g_ss):
        (x,) = ctx.saved_tensors
        return channel_stats_grad(x, g_s, g_ss)


def channel_stats(x):
    """(sum [C], sum of squares [C]) of ``x`` over every axis but the last,
    accumulated in f32; differentiable.  A CPU tensor takes the plain
    twin; a CUDA tensor launches the kernel (float32, contiguous) or
    raises."""
    if x.device.type == "cpu":
        return channel_stats_reference(x)
    return _ChannelStats.apply(x)

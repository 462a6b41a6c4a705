"""Per-channel (sum, sum of squares): the training-mode batch-norm
moments from one read (the port of ``paddle_tpu/ops/pallas/tpp/conv.py``'s
``channel_stats``).

:func:`channel_stats` sums over every axis but the last, in f32: one
launch of ``csrc/channel_stats.cu`` (fixed row blocks whose partials the
last block of each column chunk adds in order: no float atomics, the same
bits on a rerun) for a CUDA tensor, the plain twin
:func:`channel_stats_reference` for a CPU one.  A float32 input launches
the f32 form (``KERNEL``: 4 channels a 16-byte read), a bfloat16 one the
bf16 form (``KERNEL_BF16``: 8 channels a 16-byte read, f32 sums); either
reads a channel a thread where C or the pointer does not allow 16 bytes.
Its gradient is :func:`channel_stats_grad`, ``dx = g_s + 2 x g_ss`` in
plain torch and in x's dtype, as the JAX package's vjp is jnp and not
Pallas.

The host path of a call: the plan and the parameter block are prepared
once per (R, C, dtype, form); the partials' scratch and the finish's
tickets are kept per (device, stream) (``_kept``) and grown when a larger
call comes; one ``torch.empty`` a call, the [2, C] output whose rows are
returned."""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from paddle_tpu_torch.core.dtype import at_least_f32
from paddle_tpu_torch.core.enforce import EnforceError, enforce
from paddle_tpu_torch.ops.kernels._build import Kernel
from paddle_tpu_torch.ops.kernels._kept import keep

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


class StatsParams(ctypes.Structure):
    """The launch's parameter block: ``struct StatsParams`` of
    ``csrc/channel_stats.cu``, field for field."""
    _fields_ = [("x", _P), ("out", _P), ("part", _P), ("tickets", _P),
                ("R", _L), ("rows_per_block", _L), ("C", _I), ("P", _I),
                ("lanes", _I), ("vec", _I)]


#: every C entry: the parameter block's address, the stream
ENTRY_ARGS = [_P, _P]
KERNEL = Kernel("channel_stats", "channel_stats_f32", ENTRY_ARGS)
KERNEL_BF16 = Kernel("channel_stats", "channel_stats_bf16", ENTRY_ARGS)
KERNELS = {torch.float32: KERNEL, torch.bfloat16: KERNEL_BF16}

#: channels a thread reads at once: the 16-byte forms by dtype, and the
#: scalar form of either
VEC = {torch.float32: 4, torch.bfloat16: 8}
SCALAR = 1

THREADS = 256       # a block's threads (kThreads)
MAX_LANES = 32      # the most column lanes of a block: a warp's width
VEC_LANES = 4       # the 16-byte forms' lanes: 64 bytes of a row a warp
TARGET_BLOCKS = 256  # the least blocks a call takes where the work allows
MIN_ROW_CHANNELS = 8  # the least channels of a row a warp reads at once


class Plan(NamedTuple):
    """One launch's grid: ``col_chunks`` x ``row_blocks`` blocks of
    ``lanes`` column lanes, each row block ``rows_per_block`` rows."""
    lanes: int
    row_blocks: int
    rows_per_block: int
    col_chunks: int

    @property
    def blocks(self) -> int:
        return self.col_chunks * self.row_blocks


def plan(rows: int, cols: int, vec: int) -> Plan:
    """The grid of one launch over [rows, cols] in the form that reads
    ``vec`` channels a thread (4: f32 in 16 bytes, 8: bf16 in 16 bytes,
    1: a channel a thread): a function of these three alone, never of
    the card, so the summation order (and the bits) are the same on every
    card.

    The least blocks: :data:`TARGET_BLOCKS`, or where the view has fewer
    reads than a read for each thread of that many blocks, one block for
    each :data:`THREADS` reads.
    - Where a row's reads alone give that many column chunks, each of
      at least :data:`MIN_ROW_CHANNELS` channels (a sector of f32), one
      row block takes all the rows (no partials, no ticket: at
      small_vgg's [128, 512], where the chain of a finish would take
      longer than the reads), with the widest lanes that keep the
      chunks.
    - Else the 16-byte forms take :data:`VEC_LANES` (64 bytes of each row
      a warp reads), the scalar form :data:`MAX_LANES` (either no more
      than the channels need), and row blocks that cover the rows exactly
      and with the chunks make the least blocks, no shorter than a
      block's row groups."""
    reads = -(-cols // vec)
    least = min(TARGET_BLOCKS, max(1, rows * reads // THREADS))
    lanes = min(MAX_LANES, 1 << max(0, (reads // least).bit_length() - 1))
    if reads >= least and lanes * vec >= MIN_ROW_CHANNELS:
        return Plan(lanes, 1, rows, -(-reads // lanes))
    lanes = min(MAX_LANES if vec == SCALAR else VEC_LANES,
                1 << (reads - 1).bit_length())
    chunks = -(-reads // lanes)
    p = max(1, min(-(-least // chunks), -(-rows // (THREADS // lanes))))
    per = -(-rows // p)
    return Plan(lanes, -(-rows // per), per, chunks)


def channel_stats_reference(x):
    """Plain twin: (sum [C], sum of squares [C]) over all leading axes, in
    f32 (float64 stays wide)."""
    x2 = at_least_f32(x).reshape(-1, x.shape[-1])
    return x2.sum(dim=0), (x2 * x2).sum(dim=0)


def channel_stats_grad(x, g_s, g_ss):
    """The vjp: ``dx = g_s + 2 x g_ss`` (either cotangent may be None),
    in ``x``'s dtype, from one temporary: 2 x, times g_ss, plus g_s, each
    rounded as the expression would be."""
    index = x.get_device()
    for g in (g_s, g_ss):
        if g is not None and g.get_device() != index:
            raise EnforceError(
                f"channel_stats operands on several devices: "
                f"{[str(t.device) for t in (x, g_s, g_ss) if t is not None]}")
    xf = at_least_f32(x)
    if g_ss is not None:
        dx = torch.mul(xf, 2.0)
        dx.mul_(g_ss.to(xf.dtype))
        if g_s is not None:
            dx.add_(g_s.to(xf.dtype))
    elif g_s is not None:
        dx = g_s.to(xf.dtype).expand(xf.shape).contiguous()
    else:
        dx = torch.zeros_like(xf)
    return dx.to(x.dtype)


class Prepared:
    """One (device, R, C, dtype, form) of the kernel: the C entry, the
    parameter block with every scalar set (the pointers are rewritten a
    call) and the scratch it needs.  A call rewrites the block it owns, so
    one thread launches through it at a time (the port's steps run from
    one thread)."""

    __slots__ = ("kernel", "params", "addr", "c", "part", "chunks", "index",
                 "device")

    def __init__(self, index, r, c, dtype, vec):
        p = plan(r, c, vec)
        self.kernel, self.c = KERNELS[dtype], c
        self.index, self.device = index, torch.device("cuda", index)
        self.params = StatsParams(R=r, rows_per_block=p.rows_per_block, C=c,
                                  P=p.row_blocks, lanes=p.lanes,
                                  vec=int(vec != SCALAR))
        self.addr = ctypes.addressof(self.params)
        self.part, self.chunks = 2 * p.row_blocks * c, p.col_chunks

    def __call__(self, ptr):
        index = self.index
        stream = torch._C._cuda_getCurrentRawStream(index)
        kept = keep(self.device, stream, self.part, self.chunks)
        out = torch.empty((2, self.c), dtype=torch.float32,
                          device=self.device)
        prm = self.params
        prm.x, prm.out = ptr, out.data_ptr()
        prm.part, prm.tickets = kept.part_ptr, kept.tickets_ptr
        self.kernel.launch_on(index, self.addr)
        return out[0], out[1]


_PREPARED: dict = {}


def _refuse(x):
    """Raises for the first of the kernel's conditions ``x`` fails."""
    enforce(x.is_cuda, "no kernel for device %s", x.device)
    enforce(x.dtype in KERNELS, "the channel_stats kernel takes float32 or "
            "bfloat16, got %s", x.dtype)
    enforce(x.is_contiguous(), "the channel_stats kernel needs a "
            "contiguous (channels-last) input")
    enforce(x.dim() >= 1 and x.numel() > 0,
            "channel_stats needs a non-empty input, got %s", tuple(x.shape))


def _launch(x):
    dtype = x.dtype
    if not (dtype in KERNELS and x.is_cuda and x.is_contiguous()
            and x.dim() and x.numel()):
        _refuse(x)
    c = x.shape[-1]
    ptr = x.data_ptr()
    vec = VEC[dtype]
    if c % vec or ptr & 15:
        vec = SCALAR
    key = (x.get_device(), x.numel() // c, c, dtype, vec)
    prep = _PREPARED.get(key)
    if prep is None:
        prep = _PREPARED[key] = Prepared(*key)
    return prep(ptr)


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
    twin; a CUDA tensor launches the kernel (float32 or bfloat16,
    contiguous) or raises."""
    if x.is_cuda:
        return _ChannelStats.apply(x)
    if x.device.type == "cpu":
        return channel_stats_reference(x)
    return _launch(x)   # refuses the device

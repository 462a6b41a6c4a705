"""Batch-reduce GEMM with a fused epilogue (the port of
``paddle_tpu/ops/pallas/tpp/brgemm.py``).

``brgemm(a, b)`` computes ``sum_g a[g] @ b[g]`` for a [G, M, K] and
b [G, K, N] with an f32 accumulator, then, before the one write of y:

- affine: ``y * scale + shift`` per output column (the inference-mode
  batch-norm fold);
- relu;
- stats: per-column ``sum`` / ``sum of squares`` of the PRE-epilogue
  accumulator (the training-mode batch-norm moments), reduced in a fixed
  order, so a rerun gives the same bits.

:func:`conv1x1` is the same kernel on the pixel rows of an NHWC image: a
1x1 convolution without padding, whose stride is an index map over the
rows (no ``x[:, ::s, ::s]`` copy).  ResNet-50 runs 36 of them per forward
pass.

CPU tensors take :func:`brgemm_reference`; CUDA tensors launch
``csrc/brgemm.cu`` (f32, contiguous) or raise.  Every launch adds one to
``KERNEL.launches``."""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.core.dtype import at_least_f32
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops.kernels._build import Kernel

BLOCK_M = 128  # output rows per block: the stats have one partial per tile

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel("brgemm", "brgemm_f32",
                [_P, _P, _P] + [_I] * 10 + [_P, _P, _I, _P, _P, _P, _P])


def epilogue(acc, scale=None, shift=None, act=None):
    """The fused epilogue on an f32 accumulator: affine, then relu."""
    if scale is not None:
        acc = acc * scale + shift
    if act == "relu":
        acc = torch.relu(acc)
    return acc


def check_epilogue(scale, shift, act):
    if act not in (None, "relu"):
        raise ValueError(f"the fused epilogue act must be None or 'relu', "
                         f"got {act!r}")
    if (scale is None) != (shift is None):
        raise ValueError("the affine epilogue needs both scale and shift")


def brgemm_reference(a, b, scale=None, shift=None, act=None, stats=False):
    """Plain twin: a [G, M, K] @ b [G, K, N] summed over G in f32, the
    epilogue applied last.  Returns y [M, N] (and (col_sum [N],
    col_sumsq [N]) of the pre-epilogue accumulator when ``stats``)."""
    acc = torch.einsum("gmk,gkn->mn", at_least_f32(a), at_least_f32(b))
    y = epilogue(acc, scale, shift, act)
    if not stats:
        return y
    return y, acc.sum(dim=0), (acc * acc).sum(dim=0)


def _launch(a, b, g, m, k, n, rows, scale, shift, act, stats):
    """One kernel call; ``rows`` = (img_h, img_w, out_h, out_w, sh, sw) is
    the row map of A (see ``csrc/brgemm.cu``)."""
    enforce(a.device.type == "cuda", f"no kernel for device {a.device}")
    tensors = [a, b] + ([scale, shift] if scale is not None else [])
    enforce(all(t.dtype == torch.float32 for t in tensors),
            "the brgemm kernel takes float32 operands")
    enforce(all(t.is_contiguous() for t in tensors),
            "the brgemm kernel needs contiguous operands")
    enforce(len({t.device for t in tensors}) == 1,
            f"operands on several devices: {[t.device for t in tensors]}")
    enforce(min(g, m, k, n) > 0, "the brgemm kernel takes non-empty "
            f"operands, got G={g} M={m} K={k} N={n}")
    return launch_gemm(KERNEL, a.device, m, n, stats, scale, shift, act,
                       a.data_ptr(), b.data_ptr(), g, m, k, n, *rows)


def launch_gemm(kernel, device, m, n, stats, scale, shift, act, *args):
    """Allocate y [M, N] (and the stats partials and outputs), launch
    ``kernel(*args, y, ..., epilogue pointers, stream)`` and return y or
    (y, sum, sumsq).  The C entry points of ``brgemm.cu`` and
    ``conv2d_direct.cu`` share this tail of arguments."""
    y = torch.empty((m, n), dtype=torch.float32, device=device)
    s = ss = partial = None
    if stats:
        partial = torch.empty((2, -(-m // BLOCK_M), n), dtype=torch.float32,
                              device=device)
        s = torch.empty(n, dtype=torch.float32, device=device)
        ss = torch.empty(n, dtype=torch.float32, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        kernel.launch(args[0], args[1], y.data_ptr(), *args[2:], ptr(scale),
                      ptr(shift), int(act == "relu"), ptr(partial), ptr(s),
                      ptr(ss), stream)
    return (y, s, ss) if stats else y


def brgemm(a, b, scale=None, shift=None, act=None, stats=False):
    """Batch-reduce GEMM with fused epilogue.

    a: [G, M, K]; b: [G, K, N]; scale/shift: optional [N] f32 affine
    epilogue; act: None | "relu"; stats: also return per-column
    (sum, sumsq) of the pre-epilogue f32 accumulator."""
    check_epilogue(scale, shift, act)
    enforce(a.dim() == 3 and b.dim() == 3 and a.shape[0] == b.shape[0]
            and a.shape[2] == b.shape[1],
            f"brgemm needs a [G, M, K] and b [G, K, N], got "
            f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device.type == "cpu":
        return brgemm_reference(a, b, scale, shift, act, stats)
    g, m, k = a.shape
    return _launch(a, b, g, m, k, b.shape[2], (1, m, 1, m, 1, 1),
                   scale, shift, act, stats)


def conv1x1(x, w, stride=(1, 1), scale=None, shift=None, act=None,
            stats=False):
    """1x1 convolution without padding, NHWC x [N, H, W, Cin] and HWIO
    w [1, 1, Cin, Cout], through the BRGEMM kernel: y [N, OH, OW, Cout]
    (and the per-channel (sum, sumsq) when ``stats``)."""
    check_epilogue(scale, shift, act)
    enforce(x.dim() == 4 and tuple(w.shape[:3]) == (1, 1, x.shape[3]),
            f"conv1x1 needs x [N, H, W, Cin] and w [1, 1, Cin, Cout], got "
            f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    sh, sw = stride
    oh, ow = (h - 1) // sh + 1, (wd - 1) // sw + 1
    if x.device.type == "cpu":
        xs = x[:, ::sh, ::sw] if (sh, sw) != (1, 1) else x
        out = brgemm_reference(xs.reshape(1, n * oh * ow, cin),
                               w.reshape(1, cin, cout), scale, shift, act,
                               stats)
    else:
        out = _launch(x, w, 1, n * oh * ow, cin, cout, (h, wd, oh, ow, sh, sw),
                      scale, shift, act, stats)
    if stats:
        return out[0].reshape(n, oh, ow, cout), out[1], out[2]
    return out.reshape(n, oh, ow, cout)

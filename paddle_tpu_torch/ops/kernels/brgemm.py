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
``csrc/brgemm.cu`` or raise: its f32 form on f32 operands, counted by
``KERNEL.launches``, and its bf16 form (the tensor-core tile of
``csrc/gemm_bf16.cuh``: bf16 operands, f32 accumulators and epilogue, y
in bf16) on bf16 operands, counted by ``KERNEL_BF16.launches``.  The
epilogue's scale and shift are f32 in both forms, as are the stats.

:func:`plan` picks the tile and the copy form of every launch of the
shared GEMM tiles (``csrc/gemm_f32.cuh``, ``csrc/gemm_bf16.cuh``), here
and for the direct conv, from the form's table (:data:`F32`,
:data:`BF16`); the launch hands the plan to the kernel and sizes the
stats partials by it, so tile geometry has one source."""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from paddle_tpu_torch.core.dtype import at_least_f32
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops.kernels._build import Kernel, load

MIN_WAVES = 8        # a tile larger than the smallest fills the card so often
MIN_SPLIT_SLICES = 16   # a split of the reduction keeps at least this many
MAX_SPLITS = 8


@dataclasses.dataclass(frozen=True, eq=False)
class Form:
    """One operand dtype's tile family: the tiles its header instantiates
    (largest first; ``gemm::dispatch`` in ``csrc/gemm_f32.cuh`` names the
    same), the blocks an H100 SM holds of each in each copy form
    ({(block_m, block_n, vec): blocks}), the depth of a ring slice, and
    the elements of one 16-byte copy.  :func:`resident` asks the CUDA
    runtime for the blocks of every instantiation, and the card's tests
    and ``chip_smoke.py`` hold the table to it."""
    tiles: tuple
    resident: dict
    block_k: int
    vec_elems: int


#: the f32 SIMT tile (``csrc/gemm_f32.cuh``): 8 x 8 outputs a thread at
#: 167-168 registers (ptxas, no spills), so the 128 x 64 tile's 128
#: threads fit three times an SM and the 64 x 64 tile's 64 six times (its
#: 32 KB ring six times too), in either copy form; 16-deep ring slices.
F32 = Form(((128, 64), (64, 64)),
           {(128, 64, True): 3, (128, 64, False): 3,
            (64, 64, True): 6, (64, 64, False): 6}, 16, 4)
#: the bf16 tensor-core tile (``csrc/gemm_bf16.cuh``): 4 warps of
#: mma.sync m16n8k16, a 3-slice ring of 32-deep slices.  128 x 64 at 110
#: registers (16-byte copies) fits 4 blocks an SM, at 178 (the
#: register-staged form's staging and cursors) 2; 64 x 64 at 80 fits 6,
#: at 126 4 (ptxas, no spills; the runtime's occupancy, held to it).
BF16 = Form(F32.tiles, {(128, 64, True): 4, (128, 64, False): 2,
                        (64, 64, True): 6, (64, 64, False): 4}, 32, 8)
FORMS = {torch.float32: F32, torch.bfloat16: BF16}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P] + [_I] * 14 + [_P] * 3 + [_I] + [_P] * 4
KERNEL = Kernel("brgemm", "brgemm_f32", _ARGS)
KERNEL_BF16 = Kernel("brgemm", "brgemm_bf16", _ARGS)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of the shared tile: ``block_m`` x ``block_n`` outputs a
    block of block_m * block_n / 64 threads; the copy form, ``vec``: 4
    consecutive reduction elements (or 4 columns of B) a 16-byte copy,
    else a 4-byte copy each; and ``splits`` of the reduction, summed in
    order by a second pass."""
    block_m: int
    block_n: int
    vec: bool
    splits: int = 1

    def row_tiles(self, m: int) -> int:
        """Row tiles of an M-row output: the stats partials' count."""
        return -(-m // self.block_m)

    def blocks(self, m: int, n: int) -> int:
        return self.row_tiles(m) * -(-n // self.block_n) * self.splits


@functools.lru_cache(maxsize=4096)
def _tile(m: int, n: int, kred: int, sms: int, form: Form,
          vec: bool) -> tuple:
    for t in form.tiles[:-1]:
        if Plan(*t, True).blocks(m, n) >= (MIN_WAVES * sms
                                           * form.resident[t + (vec,)]):
            return t + (1,)
    t = form.tiles[-1]
    wave = sms * form.resident[t + (vec,)]
    splits = min(wave // Plan(*t, True).blocks(m, n), MAX_SPLITS,
                 -(-kred // form.block_k) // MIN_SPLIT_SLICES)
    return t + (max(1, splits),)


def plan(m: int, n: int, kred: int, run: int, ptrs, sms: int,
         form: Form = F32) -> Plan:
    """The tile, copy form and split of one GEMM launch with M rows, N
    columns and a reduction of ``kred`` elements whose contiguous run in
    A is ``run`` (a conv's Cin, the BRGEMM's K), on a card of ``sms``
    SMs, in the operand dtype's ``form``.

    - The 16-byte form needs ``run`` and N to be multiples of a copy's
      elements (4 in f32, 8 in bf16) and every operand pointer in
      ``ptrs`` 16-byte aligned; else the 4-byte form (f32) or the
      register-staged one (bf16).
    - The tile: the largest of the form's tiles whose grid fills the card's
      resident blocks at least :data:`MIN_WAVES` times, else the
      smallest: a few waves of a large tile leave SMs idle in the last
      one.
    - The split: where the smallest tile's grid holds fewer blocks than
      the card, the reduction is cut into as many whole multiples as fit
      (at most :data:`MAX_SPLITS`, each at least
      :data:`MIN_SPLIT_SLICES` slices): res5's 3x3 at batch 64 (392
      blocks for 792) takes 2, small_vgg's last group (256) 3 (f32)."""
    e = form.vec_elems
    vec = run % e == 0 and n % e == 0 and all(p % 16 == 0 for p in ptrs)
    bm, bn, splits = _tile(m, n, kred, sms, form, vec)
    return Plan(bm, bn, vec, splits)


def resident(kernel: Kernel, block_m: int, block_n: int, vec: bool) -> int:
    """Blocks of ``kernel``'s (the BRGEMM's or the direct conv's)
    block_m x block_n tile in the copy form ``vec`` that one SM of the
    current card holds at once, from the CUDA runtime's occupancy of that
    instantiation (the C entry ``<symbol>_resident``)."""
    fn = getattr(load(kernel.source), kernel.symbol + "_resident")
    fn.argtypes, fn.restype = [_I] * 3, _I
    n = fn(block_m, block_n, int(vec))
    enforce(n > 0, "%s_resident(%d, %d, %d): CUDA error %d", kernel.symbol,
            block_m, block_n, int(vec), -n)
    return n


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    """Plain twin: a [G, M, K] @ b [G, K, N] summed over G in f32 (a
    product of two bf16 values is exact there), the epilogue applied
    last, y rounded once to a's dtype.  Returns y [M, N] (and (col_sum
    [N], col_sumsq [N]) of the pre-epilogue f32 accumulator when
    ``stats``)."""
    acc = torch.einsum("gmk,gkn->mn", at_least_f32(a), at_least_f32(b))
    y = epilogue(acc, scale, shift, act).to(a.dtype)
    if not stats:
        return y
    return y, acc.sum(dim=0), (acc * acc).sum(dim=0)


def _launch(a, b, g, m, k, n, rows, scale, shift, act, stats):
    """One kernel call; ``rows`` = (img_h, img_w, out_h, out_w, sh, sw) is
    the row map of A (see ``csrc/brgemm.cu``)."""
    form = check_operands("brgemm", [a, b],
                          [] if scale is None else [scale, shift])
    enforce(min(g, m, k, n) > 0, "the brgemm kernel takes non-empty "
            "operands, got G=%d M=%d K=%d N=%d", g, m, k, n)
    p = plan(m, n, g * k, k, (a.data_ptr(), b.data_ptr()),
             sm_count(a.device), form)
    return launch_gemm(KERNEL_BF16 if form is BF16 else KERNEL, a.device,
                       m, n, p, stats, scale, shift, act, a.data_ptr(),
                       b.data_ptr(), g, m, k, n, *rows, dtype=a.dtype)


def check_operands(name, operands, epilogue=()) -> Form:
    """The kernels take contiguous operands on one CUDA device, all f32
    (the f32 form) or all bf16 (the bf16 form), and f32 epilogue vectors;
    returns the form."""
    tensors = [*operands, *epilogue]
    dev = tensors[0].device
    enforce(dev.type == "cuda", "no kernel for device %s", dev)
    dtype = operands[0].dtype
    enforce(dtype in FORMS and all(t.dtype == dtype for t in operands),
            f"the {name} kernel takes float32 or bfloat16 operands of one "
            f"dtype, got {[t.dtype for t in operands]}")
    enforce(all(t.dtype == torch.float32 for t in epilogue),
            f"the {name} kernel's epilogue takes float32 scale and shift")
    enforce(all(t.is_contiguous() for t in tensors),
            f"the {name} kernel needs contiguous operands")
    enforce(all(t.device == dev for t in tensors),
            "operands on several devices: %s", [t.device for t in tensors])
    return FORMS[dtype]


def launch_gemm(kernel, device, m, n, p, stats, scale, shift, act, *args,
                dtype=torch.float32):
    """Allocate y [M, N] in ``dtype`` (and the split's f32 scratch, the
    stats partials and outputs), launch ``kernel(*args, y, ..., the plan
    p, epilogue pointers, stream)`` and return y or (y, sum, sumsq).  The
    C entry points of ``brgemm.cu`` and ``conv2d_direct.cu``, both forms,
    share this tail of arguments."""
    y = torch.empty((m, n), dtype=dtype, device=device)
    ws = s = ss = partial = None
    if p.splits > 1:
        ws = torch.empty((p.splits, m, n), dtype=torch.float32,
                         device=device)
    if stats:   # one allocation: partials [2, tiles, N], then sum, sumsq
        tiles = p.row_tiles(m)
        buf = torch.empty(2 * (tiles + 1) * n, dtype=torch.float32,
                          device=device)
        partial, s, ss = buf.split([2 * tiles * n, n, n])

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        kernel.launch(args[0], args[1], y.data_ptr(), *args[2:], p.block_m,
                      p.block_n, int(p.vec), p.splits, ptr(ws), ptr(scale),
                      ptr(shift), int(act == "relu"), ptr(partial), ptr(s),
                      ptr(ss), stream)
    return (y, s, ss) if stats else y


def brgemm(a, b, scale=None, shift=None, act=None, stats=False):
    """Batch-reduce GEMM with fused epilogue.

    a: [G, M, K]; b: [G, K, N], both f32 or both bf16 (y in their
    dtype); scale/shift: optional [N] f32 affine epilogue; act: None |
    "relu"; stats: also return per-column (sum, sumsq) of the
    pre-epilogue f32 accumulator."""
    check_epilogue(scale, shift, act)
    enforce(a.dim() == 3 and b.dim() == 3 and a.shape[0] == b.shape[0]
            and a.shape[2] == b.shape[1],
            "brgemm needs a [G, M, K] and b [G, K, N], got %s and %s",
            tuple(a.shape), tuple(b.shape))
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
            "conv1x1 needs x [N, H, W, Cin] and w [1, 1, Cin, Cout], got "
            "%s and %s", tuple(x.shape), tuple(w.shape))
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

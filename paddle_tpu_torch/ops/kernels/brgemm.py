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
``KERNEL.launches``; on bf16 operands (f32 accumulators and epilogue, y
in bf16) the Hopper tile of ``csrc/gemm_wgmma.cuh`` (wgmma, TMA, a
warp-specialised mbarrier ring, persistent) where its copies can be 16
bytes wide, counted by ``KERNEL_WGMMA.launches``, else the mma.sync tile
of ``csrc/gemm_bf16.cuh``, counted by ``KERNEL_BF16.launches``.  The
epilogue's scale and shift are f32 in every form, as are the stats.

:func:`plan` picks the tile, the copy form and the split of every launch
of the shared GEMM tiles (``csrc/gemm_f32.cuh``, ``csrc/gemm_bf16.cuh``,
``csrc/gemm_wgmma.cuh``), here and for the direct conv, from the form's
table (:data:`F32`, :data:`BF16`, :data:`WGMMA`); the launch hands the
plan to the kernel and sizes the stats partials by it, so tile geometry
has one source.  :func:`launch_gemm` is the host path every call of
rows 14 and 15 takes: a parameter block prepared once per shape, dtype
and plan (:class:`Prepared`) with only its pointers rewritten, y and one
f32 scratch allocation, the stream, one ctypes call."""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from paddle_tpu_torch.core.dtype import at_least_f32
from paddle_tpu_torch.core.enforce import EnforceError, enforce
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
#: the bf16 mma.sync tile (``csrc/gemm_bf16.cuh``): 4 warps of
#: mma.sync m16n8k16, a 3-slice ring of 32-deep slices staged through
#: registers, for the bf16 shapes 16-byte copies cannot read (the WGMMA
#: tile takes the rest).  128 x 64 at 178 registers fits 2 blocks an SM,
#: 64 x 64 at 126 4 (ptxas, no spills; the runtime's occupancy, held to
#: it).
BF16 = Form(F32.tiles, {(128, 64, False): 2, (64, 64, False): 4}, 32, 8)
#: the Hopper bf16 tile (``csrc/gemm_wgmma.cuh``, ``wgmma::dispatch``):
#: 128 x BN, two consumer warpgroups and a producer (384 threads), a ring
#: of 64-deep stages (6 at BN 64 and 128, 4 at 256: 165-225 KB of shared
#: memory with the stats and output staging), so one block an SM; the
#: 16-byte form only.
WGMMA = Form(((128, 256), (128, 128), (128, 64)),
             {(128, 256, True): 1, (128, 128, True): 1, (128, 64, True): 1},
             64, 8)
FORMS = {torch.float32: F32, torch.bfloat16: BF16}

_P = ctypes.c_void_p
_I = ctypes.c_int


class BrgemmParams(ctypes.Structure):
    """The launch's parameter block: ``struct BrgemmParams`` of
    ``csrc/brgemm.cu``, field for field."""
    _fields_ = ([(f, _P) for f in ("a", "b", "y", "ws", "scale", "shift",
                                   "partial", "sum", "sumsq")]
                + [(f, _I) for f in ("G", "M", "K", "N", "img_h", "img_w",
                                     "out_h", "out_w", "sh", "sw",
                                     "block_m", "block_n", "vec", "splits",
                                     "relu")])


#: every C entry of the shared tiles: the parameter block's address, the
#: stream
ENTRY_ARGS = [_P, _P]
KERNEL = Kernel("brgemm", "brgemm_f32", ENTRY_ARGS)
KERNEL_BF16 = Kernel("brgemm", "brgemm_bf16", ENTRY_ARGS)
KERNEL_WGMMA = Kernel("brgemm", "brgemm_wgmma", ENTRY_ARGS)


@dataclasses.dataclass(frozen=True, eq=False)
class Entries:
    """One source's C entries by tile (``brgemm.cu``'s, or
    ``conv2d_direct.cu``'s) and their parameter block, whose first two
    fields are the operands."""
    f32: Kernel
    bf16: Kernel
    wgmma: Kernel
    params: type

    def kernel(self, p: "Plan", dtype) -> Kernel:
        if dtype == torch.float32:
            return self.f32
        return self.wgmma if p.wgmma else self.bf16


BRGEMM = Entries(KERNEL, KERNEL_BF16, KERNEL_WGMMA, BrgemmParams)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of a shared tile: ``block_m`` x ``block_n`` outputs a
    block; the copy form, ``vec``: a 16-byte copy of consecutive
    reduction elements (or columns of B), else a 4-byte copy each (f32)
    or register staging (bf16); ``splits`` of the reduction, summed in
    order by a second pass; ``wgmma``: the Hopper tile (bf16, 16-byte
    form, persistent), else the form's own."""
    block_m: int
    block_n: int
    vec: bool
    splits: int = 1
    wgmma: bool = False

    def row_tiles(self, m: int) -> int:
        """Row tiles of an M-row output: the stats partials' count."""
        return -(-m // self.block_m)

    def blocks(self, m: int, n: int) -> int:
        return self.row_tiles(m) * -(-n // self.block_n) * self.splits


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


#: the Hopper tile's cost model (:func:`_wgmma_tile`), fitted to the
#: alone times of ``chip_ab.py --sweep`` on an H100 (every width and split
#: at seven ResNet-50 and small_vgg shapes): a 64-deep stage of a 128 x BN
#: tile takes WGMMA_STAGE_US + WGMMA_STAGE_US_PER_COL x BN (its copies
#: and hand-off through the ring, then its products), a tile's epilogue
#: WGMMA_EPI_US + WGMMA_EPI_US_PER_COL x its columns inside N; a split's
#: second pass moves (4 splits + 2) bytes an output at
#: WGMMA_REDUCE_BYTES_PER_US (its f32 partials written and read back, y
#: written)
WGMMA_STAGE_US, WGMMA_STAGE_US_PER_COL = 0.57, 0.0019
WGMMA_EPI_US, WGMMA_EPI_US_PER_COL = 0.9, 0.02
WGMMA_REDUCE_BYTES_PER_US = 0.33e6


@functools.lru_cache(maxsize=4096)
def _wgmma_tile(m: int, n: int, kred: int, sms: int) -> tuple:
    """(block_n, splits) of the Hopper tile: of every width in
    ``WGMMA.tiles`` and split of the reduction (up to :data:`MAX_SPLITS`,
    each at least :data:`MIN_SPLIT_SLICES` stages unless whole), the one
    the cost model finishes first on the persistent grid (``sms`` x
    ``WGMMA.resident`` blocks, each walking ceil(work / grid) tiles);
    ties go to the wider tile and the fewer splits."""
    slices = -(-kred // WGMMA.block_k)
    best = None
    for bm, bn in WGMMA.tiles:
        grid = sms * WGMMA.resident[(bm, bn, True)]
        tiles = -(-m // bm) * -(-n // bn)
        epilogue = WGMMA_EPI_US + WGMMA_EPI_US_PER_COL * min(bn, n)
        for splits in range(1, MAX_SPLITS + 1):
            if splits > 1 and slices // splits < MIN_SPLIT_SLICES:
                break
            stages = -(-slices // splits)
            us = -(-tiles * splits // grid) * (
                stages * (WGMMA_STAGE_US + WGMMA_STAGE_US_PER_COL * bn)
                + epilogue)
            if splits > 1:
                us += (4 * splits + 2) * m * n / WGMMA_REDUCE_BYTES_PER_US
            if best is None or us < best[0]:
                best = (us, bn, splits)
    return best[1:]


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
      blocks for 792) takes 2, small_vgg's last group (256) 3 (f32).
    - bf16 in the 16-byte form takes the Hopper tile (:data:`WGMMA`),
      its width and split from :func:`_wgmma_tile`'s cost model on the
      persistent grid; every other bf16 shape the mma.sync tile."""
    return _plan(m, n, kred, run, not any(p & 15 for p in ptrs), sms, form)


@functools.lru_cache(maxsize=4096)
def _plan(m: int, n: int, kred: int, run: int, aligned: bool, sms: int,
          form: Form) -> Plan:
    e = form.vec_elems
    vec = aligned and run % e == 0 and n % e == 0
    if form is BF16 and vec:
        bn, splits = _wgmma_tile(m, n, kred, sms)
        return Plan(WGMMA.tiles[0][0], bn, True, splits, True)
    bm, bn, splits = _tile(m, n, kred, sms, form, vec)
    return Plan(bm, bn, vec, splits)


def resident(kernel: Kernel, block_m: int, block_n: int, vec: bool) -> int:
    """Blocks of ``kernel``'s (the BRGEMM's or the direct conv's, in any
    tile) block_m x block_n tile in the copy form ``vec`` that one SM of
    the current card holds at once, from the CUDA runtime's occupancy of
    that instantiation (the C entry ``<symbol>_resident``)."""
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


def _launch(a, b, g, m, k, n, rows, scale, shift, act, stats, shape):
    """One kernel call; ``rows`` = (img_h, img_w, out_h, out_w, sh, sw) is
    the row map of A (see ``csrc/brgemm.cu``), ``shape`` y's shape (M x N
    elements)."""
    form = check_operands("brgemm", a, b, scale, shift)
    if min(g, m, k, n) <= 0:
        raise EnforceError(f"the brgemm kernel takes non-empty operands, "
                           f"got G={g} M={m} K={k} N={n}")
    pa, pb, dev = a.data_ptr(), b.data_ptr(), a.device
    p = plan(m, n, g * k, k, (pa, pb), sm_count(dev), form)
    return launch_gemm(BRGEMM, dev, a.dtype, shape, p, stats, scale, shift,
                       act, pa, pb, (g, m, k, n, *rows))


def check_operands(name, a, b, scale=None, shift=None) -> Form:
    """The kernels take contiguous operands on one CUDA device, both f32
    (the f32 form) or both bf16 (the bf16 forms), and f32 epilogue
    vectors; returns the dtype's form.  A message is built only when a
    check fails."""
    if not a.is_cuda:
        raise EnforceError(f"no kernel for device {a.device}")
    dtype = a.dtype
    if b.dtype != dtype or dtype not in FORMS:
        raise EnforceError(f"the {name} kernel takes float32 or bfloat16 "
                           f"operands of one dtype, got {[a.dtype, b.dtype]}")
    tensors = (a, b)
    if scale is not None:
        if scale.dtype != torch.float32 or shift.dtype != torch.float32:
            raise EnforceError(f"the {name} kernel's epilogue takes float32 "
                               f"scale and shift")
        tensors = (a, b, scale, shift)
    index = a.get_device()
    for t in tensors:
        if not t.is_contiguous():
            raise EnforceError(f"the {name} kernel needs contiguous "
                               f"operands")
        if t.get_device() != index:
            raise EnforceError(f"operands on several devices: "
                               f"{[u.device for u in tensors]}")
    return FORMS[dtype]


class Prepared:
    """One shape, dtype, plan and epilogue of a source's entries: the C
    entry, the parameter block with every scalar set (only the pointers
    are rewritten a call) and the layout of the call's one f32 scratch
    buffer: the split's partial sums [splits, M, N], then the stats
    partials [2, row tiles, N], sum [N] and sumsq [N].  A call rewrites
    the block it owns, so one thread launches through it at a time (the
    port's steps issue from one thread)."""

    __slots__ = ("kernel", "params", "addr", "shape", "n", "dtype",
                 "device", "index", "operands", "scratch", "ws", "partial",
                 "stats")

    def __init__(self, entries, device, dtype, shape, p, stats, relu, dims):
        self.kernel = entries.kernel(p, dtype)
        self.shape, self.dtype, self.device = shape, dtype, device
        n = self.n = shape[-1]
        m = math.prod(shape) // n
        self.index = device.index
        fields = [f for f, _ in entries.params._fields_]
        self.operands = fields[:2]
        ints = fields[9:]
        self.params = entries.params(**dict(zip(ints, (
            *dims, p.block_m, p.block_n, int(p.vec), p.splits, int(relu)))))
        self.addr = ctypes.addressof(self.params)
        self.ws = p.splits * m * n if p.splits > 1 else 0
        tiles = p.row_tiles(m) if stats else 0
        self.stats = stats
        self.partial = 2 * tiles * n
        self.scratch = self.ws + (self.partial + 2 * n if stats else 0)

    def __call__(self, a_ptr, b_ptr, scale, shift):
        n = self.n
        y = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        prm = self.params
        setattr(prm, self.operands[0], a_ptr)
        setattr(prm, self.operands[1], b_ptr)
        prm.y = y.data_ptr()
        if scale is not None:
            prm.scale, prm.shift = scale.data_ptr(), shift.data_ptr()
        s = ss = None
        if self.scratch:
            buf = torch.empty(self.scratch, dtype=torch.float32,
                              device=self.device)
            base = buf.data_ptr()
            if self.ws:
                prm.ws = base
            if self.stats:
                at = self.ws + self.partial
                prm.partial = base + 4 * self.ws
                prm.sum, prm.sumsq = base + 4 * at, base + 4 * (at + n)
                s, ss = buf[at:at + n], buf[at + n:]
        self.kernel.launch_on(self.index, self.addr)
        return (y, s, ss) if self.stats else y


_PREPARED: dict = {}


def launch_gemm(entries, device, dtype, shape, p, stats, scale, shift, act,
                a_ptr, b_ptr, dims):
    """Launch ``entries``' C entry for plan ``p`` on operands at
    ``a_ptr``, ``b_ptr`` with the shape ``dims`` (the parameter block's
    integer fields before the plan's), y of ``shape`` (M x N elements, N
    last) in ``dtype`` and the epilogue: returns y or (y, sum, sumsq).
    The parameter block is prepared once per (entries, device, dtype,
    shape, plan, epilogue)."""
    key = (entries, device, dtype, dims, p, stats, scale is not None, act)
    prep = _PREPARED.get(key)
    if prep is None:
        prep = _PREPARED[key] = Prepared(entries, device, dtype, shape, p,
                                         stats, act == "relu", dims)
    return prep(a_ptr, b_ptr, scale, shift)


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
    n = b.shape[2]
    return _launch(a, b, g, m, k, n, (1, m, 1, m, 1, 1), scale, shift, act,
                   stats, (m, n))


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
    if x.device.type != "cpu":
        return _launch(x, w, 1, n * oh * ow, cin, cout,
                       (h, wd, oh, ow, sh, sw), scale, shift, act, stats,
                       (n, oh, ow, cout))
    xs = x[:, ::sh, ::sw] if (sh, sw) != (1, 1) else x
    out = brgemm_reference(xs.reshape(1, n * oh * ow, cin),
                           w.reshape(1, cin, cout), scale, shift, act, stats)
    if stats:
        return out[0].reshape(n, oh, ow, cout), out[1], out[2]
    return out.reshape(n, oh, ow, cout)

"""The f32 LSTM backward's plan (``csrc/lstm_seq.cu``, ``lstm_bwd_kernel``)
on the CPU: how its dh_{t-1} product on the tensor cores (``dh_share``)
and its sum over the blocks' partials ((B)) cut the work, in numpy models
with the kernel's index arithmetic.

- ``dh_share``: m16n8k8 tiles of 16 rows by 8 k, warp w taking (row tile,
  group of 8 k tiles) pairs w, w + warps, ...; the 4U columns in 8-deep
  slices, zero past 4U.  Every output (k < D, row < rows) is written once
  by that walk, and the 3xTF32 product (each slice's three passes summed
  apart from zero, the tensor cores truncating the sums they round) lies
  within 2x of f32 FMAs' error against float64 at the text step's widths;
  one TF32 pass (the planted ``tf32_one_pass``) lies 100x above it.
- (B): four rows a 16-byte load (``part``'s rows padded to a multiple of
  4 by the wrapper), the blocks' partials in ``groups`` ranges (2 at the
  text shape), each in block order, the ranges added in order, ``per``
  quads a round: every partial summed once, every row below B written
  once and no padded row; leaving a range out (the planted
  ``range_left_out``) misses.
- Every line a planted fault of the LSTM backward and of the bf16 paged
  form changes stands once in its source or in one shared header."""

import numpy as np
import pytest

import chip_smoke as S
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import lstm as LK

K_TILES = 8      # csrc/lstm_seq.cu kTilesK


def _tf32(x):
    """f32 rounded to TF32 to nearest, ties away from zero (the kernels'
    two integer operations)."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _truncated(x):
    """float64 -> f32 toward zero: how the tensor cores round the sums
    they add into an f32 accumulator."""
    f = x.astype(np.float32)
    return np.where(np.abs(f.astype(np.float64)) > np.abs(x),
                    np.nextafter(f, np.float32(0)), f)


def _slices_apart(a, b, passes):
    """a @ b over 8-deep slices (zero-padded), each slice's passes summed
    from zero with every sum truncated, added to the accumulator to
    nearest (``mma3_add``), the slices in order."""
    k = a.shape[1]
    pad = -k % 8
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, k + pad, 8):
        part = np.zeros_like(acc)
        for pa, pb in passes:
            pa = np.pad(pa, ((0, 0), (0, pad)))[:, k0:k0 + 8]
            pb = np.pad(pb, ((0, pad), (0, 0)))[k0:k0 + 8]
            x = pa.astype(np.float64) @ pb.astype(np.float64)
            part = _truncated(part.astype(np.float64) + x)
        acc = (acc.astype(np.float64) + part).astype(np.float32)
    return acc


def _three_passes(a, b):
    ah, bh = _tf32(a), _tf32(b)
    return [(_tf32(a - ah), bh), (ah, _tf32(b - bh)), (ah, bh)]


def _fma_chain(a, b):
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    for i in range(a.shape[1]):
        acc = (acc.astype(np.float64)
               + a64[:, i:i + 1] * b64[i:i + 1]).astype(np.float32)
    return acc


def _rel(x, want):
    return float(np.linalg.norm(x.astype(np.float64) - want)
                 / np.linalg.norm(want))


def dh_share_walk(d, units, rows):
    """{(k, row): times written} of ``dh_share``'s walk: warps = U (32U
    threads), groups of K_TILES k tiles, row tiles up to ``rows``; lane
    (g, t) writes rows g, g + 8 and k 2t, 2t + 1 of each of its tiles."""
    warps = units
    groups = -(-d // (8 * K_TILES))
    mtiles = -(-rows // 16)
    writes = np.zeros((d, 64), int)
    for w in range(warps):
        for i in range(w, mtiles * groups, warps):
            mt, k0 = i // groups, (i % groups) * 8 * K_TILES
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for j in range(K_TILES):
                    for e in range(4):
                        k = k0 + 8 * j + 2 * t + (e & 1)
                        rr = mt * 16 + g + 8 * (e >> 1)
                        if k < d and rr < rows:
                            writes[k, rr] += 1
    return writes


@pytest.mark.parametrize("d,units,rows", [
    (1280, 10, 64),   # the text shape: 10 warps, 20 groups of 64 k
    (64, 1, 64),      # the OCR CRNN's: one warp
    (300, 3, 5),      # 3 warps, 5 rows, a ragged last group
    (40, 1, 17),
])
def test_dh_share_writes_every_output_once(d, units, rows):
    writes = dh_share_walk(d, units, rows)
    assert (writes[:, :rows] == 1).all()
    assert (writes[:, rows:] == 0).all()


def test_3xtf32_dh_product_stays_near_f32_and_one_pass_does_not(rng_np):
    """dh_{t-1}'s share at the text step's widths: dgates [64, 40] (one
    block's 4U columns, magnitudes of a cell's cotangents, ~0.1) against
    W_h's slice [40, 1280] ~ N(0, 1 / D): the kernel's 3xTF32 slices
    (five of 8) lie within 2x of f32 FMAs' error against float64; one
    TF32 pass lies at least 100x above it.  Odd U (4U = 12: the last slice
    half zero) too."""
    for cols in (40, 12):
        a = (0.1 * rng_np.normal(size=(64, cols))).astype(np.float32)
        b = (rng_np.normal(size=(cols, 1280)) / np.sqrt(1280)).astype(
            np.float32)
        want = a.astype(np.float64) @ b.astype(np.float64)
        f32 = _rel(_fma_chain(a, b), want)
        three = _rel(_slices_apart(a, b, _three_passes(a, b)), want)
        one = _rel(_slices_apart(a, b, [(_tf32(a), _tf32(b))]), want)
        assert 0 < three <= 2 * f32, (cols, three, f32)
        assert one >= 100 * f32, (cols, one, f32)


def sum_groups(nblk, threads, nq):
    """(B)'s ranges: as many as twice the quads fit in the threads (at
    most 4, else 1), each ``span`` blocks."""
    groups = min(4, threads // nq) if 2 * nq <= threads else 1
    span = -(-nblk // groups)
    return [range(g * span, min(nblk, (g + 1) * span)) for g in range(groups)]


@pytest.mark.parametrize("nblk,threads,nq,groups", [
    (128, 320, 160, 2),   # the text shape: 10 units x 16 quads of rows
    (64, 32, 16, 2),      # the OCR CRNN's: 1 unit x 16 quads
    (100, 96, 3 * 75, 1),
    (8, 512, 64, 4),
])
def test_sum_ranges_take_every_partial_once(nblk, threads, nq, groups):
    ranges = sum_groups(nblk, threads, nq)
    assert len(ranges) == groups
    assert sorted(k for r in ranges for k in r) == list(range(nblk))


@pytest.mark.parametrize("units,b", [
    (10, 64),    # the text shape: one round of 160 quads
    (1, 64),     # the OCR CRNN's
    (10, 5),     # rows padded to 8
    (3, 130),    # three rounds, the last short
    (10, 257),   # groups 1, rows padded to 260
])
def test_sum_rounds_write_every_row_once(units, b):
    """The kernel's rounds: B4 = B rounded up to 4, nq = units * B4 / 4
    quads, ``per`` = threads / groups a round; thread i takes quad
    q0 + i % per in range i // per, and the threads of range 0 write the
    quad's rows below B."""
    threads, b4 = 32 * units, -(-b // 4) * 4
    bq = b4 // 4
    nq = units * bq
    groups = len(sum_groups(128, threads, nq))
    per = threads // groups
    summed = np.zeros((groups, nq), int)
    written = np.zeros((units, b4), int)
    for q0 in range(0, nq, per):
        for i in range(threads):
            q, grp = q0 + i % per, i // per
            if grp < groups and q < nq:
                summed[grp, q] += 1
        for i in range(per):
            q = q0 + i
            if q < nq:
                for v in range(4):
                    if 4 * (q % bq) + v < b:
                        written[q // bq, 4 * (q % bq) + v] += 1
    assert (summed == 1).all()
    assert (written[:, :b] == 1).all() and (written[:, b:] == 0).all()
    assert LK._part_floats(128, 1280, b) == 2 * 128 * 1280 * b4


def test_sum_in_ranges_equals_the_sum_and_a_range_left_out_misses(rng_np):
    parts = rng_np.normal(size=(128, 160, 4)).astype(np.float32)
    ranges = sum_groups(128, 320, 160)
    sums = [parts[list(r)].sum(0, dtype=np.float64) for r in ranges]
    want = parts.astype(np.float64).sum(0)
    np.testing.assert_allclose(sums[0] + sums[1], want, rtol=1e-12,
                               atol=1e-12)
    assert np.abs(sums[0] - want).max() > 1.0       # range 1 left out


def test_backward_keeps_the_forwards_shared_memory_plan():
    """The new product and sum use no shared memory beyond the staging
    area the plan already holds: at the text shape on an H100 the block
    takes the whole opt-in with three stages, as before."""
    assert 4 * LK._smem_floats(1280, 10, 3) == 232448


def _count_in_sources(source, line):
    paths = [_build.CSRC / f"{source}.cu", *sorted(_build.CSRC.glob("*.cuh"))]
    return sum(p.read_text().count(line) for p in paths)


@pytest.mark.parametrize("source,name", [
    ("lstm_seq", "LSTM_BWD_FAULTS"),
    ("paged_attention", "PAGED_BF16_FAULTS"),
])
def test_planted_fault_lines_are_once_in_the_sources(source, name):
    for edits in getattr(S, name).values():
        for line, _ in edits if isinstance(edits, list) else [edits]:
            assert _count_in_sources(source, line) == 1, line


@pytest.mark.parametrize("source,name,variants", [
    ("lstm_seq", "LSTM_BWD_VARIANTS", None),
    ("paged_attention", "PAGED_BF16_VARIANTS", None),
    # the split's variants of this source (the others are the FMA form's)
    ("lstm_seq", "LSTM_BWD_SPLIT",
     ("no_remat_product", "no_dh_share", "no_range_sum",
      "no_grid_barrier_tf32")),
])
def test_chip_ab_variant_lines_are_once_in_the_sources(source, name,
                                                      variants):
    """``chip_ab.py``'s variant builds of this tree's kernels stay live:
    every line they change stands once in the source or a header."""
    import chip_ab

    table = getattr(chip_ab, name)
    for variant in variants or table:
        for line, _ in table[variant]:
            assert _count_in_sources(source, line) == 1, (variant, line)

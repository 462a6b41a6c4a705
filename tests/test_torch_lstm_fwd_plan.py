"""The f32 LSTM forward product's plan (``csrc/lstm_seq.cu``, ``tc_gates``
under ``gemm_gates``: the forward over xw, its fused-input form and the
remat backward) on the CPU, in numpy models with the kernel's index
arithmetic.

- The two walks of a 64-row chunk: by rows (the forward below U 7: 8
  jobs of an m16 row tile and a K half, every n8 tile) and by columns
  (the forward from U 7 and the remat backward: 2 ceil(U / 2) jobs of an
  n8 tile and a K half, all four row tiles, job j on warp j % warps, at
  most 2 a warp).  For U 1-16 and rows 1-64, at the forward's width and
  the backward's (32U threads), every (half, row below ``rows``, gate
  column below 4U) is written once and nothing else, every (row tile, K
  half, n8 tile) is taken by one job, and the cell threads (half, rg, uu)
  read every (row, unit) once.
- The 3xTF32 product (each slice's three passes summed apart from zero,
  the tensor cores truncating the sums they round, added to the half's
  sum to nearest; half 0 + half 1) lies within 2x of f32 FMAs' error
  against float64 at the text (K 1280, U 10), row 6 (K 512 and 128, U 4)
  and OCR CRNN (K 64, U 1) widths; one TF32 pass (the planted
  ``fwd_tf32_one_pass``) lies 100x above it.
- The shared-memory plan ``_smem_floats`` equals ``Plan`` as the source
  defines it at the three shapes.
- Every line a planted fault of the forward product and a
  ``--lstm-fwd-split`` variant changes stands once in the source."""

import re

import numpy as np
import pytest

import chip_smoke as S
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import lstm as LK
from test_torch_lstm_bwd_plan import (_count_in_sources, _fma_chain, _rel,
                                      _tf32, _three_passes, _truncated)

ROW_JOBS = 8        # csrc/lstm_seq.cu kRowJobs: 4 row tiles x 2 K halves
COLUMNS_FROM = 7    # kColumnsFrom: the forward walks by n8 tiles from U 7
ROW_TILES_HELD = 4  # the row walk's accumulators: n8 tiles a job holds
SOURCE = (_build.CSRC / "lstm_seq.cu").read_text()


def _fwd_threads(units):
    """The forward's block: 32U threads, and the warps its walk wants."""
    nt = -(-units // 2)
    return 32 * max(units, ROW_JOBS if units < COLUMNS_FROM else 2 * nt)


def _write(writes, kh, r, col, rows, ok):
    for rr in (r, r + 8):
        sel = ok & (rr < rows)
        np.add.at(writes, (kh, rr[sel], col[sel]), 1)
        np.add.at(writes, (kh, rr[sel], col[sel] + 1), 1)


def rows_walk(units, rows):
    """(writes [2, 64, 4U + 4] of the sums, (row tile, K half, n8 tile)
    [4, 2, 8] taken) of ``gates_rows``: job j < 8 on warp j takes row tile
    j % 4, K half j / 4 and every n8 tile, in its ROW_TILES_HELD
    accumulators."""
    cols, nt = 4 * units, -(-units // 2)
    assert nt <= ROW_TILES_HELD, units
    writes = np.zeros((2, 64, cols + 4), int)
    taken = np.zeros((4, 2, 8), int)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for job in range(ROW_JOBS):
        mt, kh = job & 3, job // 4
        taken[mt, kh, :nt] += 1
        for j in range(nt):
            col = 8 * j + 2 * t
            _write(writes, kh, 16 * mt + g, col, rows, col < cols)
    return writes, taken


def cols_walk(units, rows, threads):
    """The same of ``gates_cols``: 2 ceil(U / 2) jobs, job j on warp j %
    warps (J = ceil(jobs / warps) <= 2 a warp) taking n8 tile j / 2 and K
    half j % 2 for all four row tiles."""
    warps, cols, nt = threads // 32, 4 * units, -(-units // 2)
    jobs = 2 * nt
    assert -(-jobs // warps) <= 2, (units, threads)
    writes = np.zeros((2, 64, cols + 4), int)
    taken = np.zeros((4, 2, 8), int)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for w in range(warps):
        for i in range(2):
            job = w + warps * i
            if job >= jobs:
                continue
            kh, tile = job % 2, job // 2
            taken[:, kh, tile] += 1
            col = 8 * tile + 2 * t
            for mt in range(4):
                _write(writes, kh, 16 * mt + g, col, rows, col < cols)
    return writes, taken


@pytest.mark.parametrize("units", range(1, 17))
def test_tile_walk_writes_every_sum_once(units):
    """Both walks, as the forward (its block) and the remat backward (32U
    threads) take them."""
    cols, nt = 4 * units, -(-units // 2)
    for rows in range(1, 65):
        for writes, taken in (
                rows_walk(units, rows) if units < COLUMNS_FROM
                else cols_walk(units, rows, _fwd_threads(units)),
                cols_walk(units, rows, 32 * units)):
            assert (writes[:, :rows, :cols] == 1).all(), rows
            assert writes.sum() == 2 * rows * cols, rows
            assert (taken[:, :, :nt] == 1).all(), rows
            assert (taken[:, :, nt:] == 0).all(), rows


@pytest.mark.parametrize("units", range(1, 17))
def test_cell_threads_read_every_row_and_unit_once(units):
    """Thread (half, rg, uu) of the first 32U runs rows rg + 16 (2 half +
    i), i < 2, of unit uu; the forward's threads past 32U none."""
    reads = np.zeros((64, units), int)
    for tid in range(_fwd_threads(units)):
        half, loc = tid // (16 * units), tid % (16 * units)
        rg, uu = loc % 16, loc // 16
        for i in range(2):
            r = rg + 16 * (2 * half + i)
            if r < 64:
                reads[r, uu] += 1
    assert (reads == 1).all()


def _halves(a, b, passes):
    """a @ b as ``tc_gates`` sums it: 8-deep slices (zero-padded), slice s
    in half s % 2; each slice's passes summed from zero with every sum
    truncated, added to its half's sum to nearest, the slices in order;
    then half 0 + half 1 to nearest."""
    k = a.shape[1]
    pad = -k % 8
    acc = np.zeros((2, a.shape[0], b.shape[1]), np.float32)
    for s, k0 in enumerate(range(0, k + pad, 8)):
        part = np.zeros(acc.shape[1:], np.float32)
        for pa, pb in passes:
            pa = np.pad(pa, ((0, 0), (0, pad)))[:, k0:k0 + 8]
            pb = np.pad(pb, ((0, pad), (0, 0)))[k0:k0 + 8]
            x = pa.astype(np.float64) @ pb.astype(np.float64)
            part = _truncated(part.astype(np.float64) + x)
        acc[s % 2] = (acc[s % 2].astype(np.float64) + part).astype(np.float32)
    return (acc[0].astype(np.float64) + acc[1]).astype(np.float32)


@pytest.mark.parametrize("k,units", [
    (1280, 10),   # the text step: h_{t-1} W_h
    (512, 4),     # row 6: h_{t-1} W_h
    (128, 4),     # row 6: x_t W_x
    (64, 1),      # the OCR CRNN's remat backward
])
def test_3xtf32_product_stays_near_f32_and_one_pass_does_not(rng_np, k,
                                                             units):
    """A chunk's 64 rows of h (|h| < 1, a tanh's) or x (N(0, 1) for W_x)
    against the block's [K, 4U] slice ~ N(0, 1 / K)."""
    cols = 4 * units
    for scale in ((1.0,) if k == 128 else (0.5, 1.0)):
        a = (np.tanh(rng_np.normal(size=(64, k))) * scale if k != 128 else
             rng_np.normal(size=(64, k))).astype(np.float32)
        b = (rng_np.normal(size=(k, cols)) / np.sqrt(k)).astype(np.float32)
        want = a.astype(np.float64) @ b.astype(np.float64)
        f32 = _rel(_fma_chain(a, b), want)
        three = _rel(_halves(a, b, _three_passes(a, b)), want)
        one = _rel(_halves(a, b, [(_tf32(a), _tf32(b))]), want)
        assert 0 < three <= 2 * f32, (k, three, f32)
        assert one >= 100 * f32, (k, one, f32)


def _constants():
    """The source's tiling constants that ``Plan`` reads."""
    return {name: int(v) for name, v in re.findall(
        r"constexpr int (kRows|kRG|kK|kMaxUnits) = (\d+);", SOURCE)}


def _plan_floats(k, units, stages):
    """``Plan(K, U, stages).total`` of csrc/lstm_seq.cu from its own
    constants: K rows of [U][4] weights, then the larger of the staging
    ring (``kLda`` = kK + 4 floats a row), the halves' sums [2][kRows][4U
    + 4] and the backward's tiles [kRows][4U + 4] + [3][2 kRG][U]."""
    c = _constants()
    assert "constexpr int kLda = kK + 4;" in SOURCE
    ld = 4 * units + 4
    ring = stages * c["kRows"] * (c["kK"] + 4)
    return k * 4 * units + max(ring, 2 * c["kRows"] * ld,
                               c["kRows"] * ld + 3 * 2 * c["kRG"] * units)


@pytest.mark.parametrize("k,units,stages,optin_stages", [
    (1280, 10, 3, 3),    # the text step: the whole opt-in
    (128 + 512, 4, 3, 3),  # row 6's fused-input block (E + D rows)
    (64, 1, 3, 3),       # the OCR CRNN's remat backward
])
def test_smem_plan_is_the_sources_plan(k, units, stages, optin_stages):
    assert LK._smem_floats(k, units, stages) == _plan_floats(k, units, stages)
    fits = [s for s in (3, 2) if 4 * _plan_floats(k, units, s) <= 232448]
    assert fits[0] == optin_stages
    # the halves' sums fit the staging area the plan already holds
    assert 2 * 64 * (4 * units + 4) <= _plan_floats(k, units, 2) - 4 * k * units


def test_walks_are_the_sources():
    """The constants the models above read, as the source has them."""
    assert f"constexpr int kRowJobs = {ROW_JOBS};" in SOURCE
    assert f"constexpr int kColumnsFrom = {COLUMNS_FROM};" in SOURCE
    assert (f"constexpr int TPJ = {ROW_TILES_HELD}, G = 2;" in SOURCE)
    assert ("32 * max(U, U < kColumnsFrom ? kRowJobs : 2 * ((U + 1) / 2))"
            in SOURCE)
    assert _constants()["kMaxUnits"] == LK._MAX_UNITS == 16


def test_planted_fault_lines_are_once_in_the_source():
    for edits in S.LSTM_FWD_FAULTS.values():
        for line, _ in edits:
            assert _count_in_sources("lstm_seq", line) == 1, line


@pytest.mark.parametrize("name,variants", [
    # the split's variants of this source (the others are the FMA form's)
    ("LSTM_FWD_SPLIT", ("no_h_product_tf32", "no_x_product_tf32",
                        "no_grid_barrier_3xtf32", "no_cell")),
    ("LSTM_FWD_VARIANTS", None),
])
def test_chip_ab_forward_variant_lines_are_once_in_the_source(name,
                                                              variants):
    import chip_ab

    table = getattr(chip_ab, name)
    for variant in variants or table:
        for line, _ in table[variant]:
            assert _count_in_sources("lstm_seq", line) == 1, (variant, line)

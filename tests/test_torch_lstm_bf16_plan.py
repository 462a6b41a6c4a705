"""The bf16 LSTM forms' plan (``csrc/lstm_seq.cu``: ``lstm_bwd_bf16_kernel``
and ``lstm_fwd_bf16_kernel``) on the CPU, in numpy models with the
kernels' own index arithmetic.

- The backward's exchange: each first-half lane writes the rounded dgates
  of its (row, unit) cells to the bf16 scratch X[b][4 u + g] (every entry
  below B and 4D written once a step, by one block).  After a grid barrier
  the dh product's first pass (``dh_part``): the blocks in groups of P (8
  at the text shape), block kk of a group taking X's chunks [kk nch / P,
  (kk + 1) nch / P) of 32 k for every unit of the group against its part
  of W_h (built by the kernel from W_h), warp w the rows b0 + 8w .. + 7, four
  chunks' loads in flight: every chunk loaded and multiplied once, every X
  entry read once a group, every partial written once; a lane's 16-byte
  loads feed two MMAs with the chunk's k permuted alike in A and B.  After
  a second barrier the second pass (``dh_sum``) adds the group's P
  partials of each own output in block order: every dh_{t-1} output
  written once, and the two passes are X W_h^T.  A part left out (the
  planted ``part_left_out``) misses.
- The forward's ring (``product_bf16``): slices of ``KC`` k staged by
  ``load_slice_a`` (every row and k of A once), slot c % S refilled only
  after slice c - 1 was read, each 16-deep step of a row tile taken by one
  warp half.
- ``_bf16_fwd_bytes``, ``_bf16_bwd_bytes``, ``_bf16_split`` and
  ``fi_bf16_smem_bytes`` are ``PlanFwdBf16``, ``PlanBwdBf16`` and
  ``SplitBf16`` of the source at the text, CRNN and row 6 shapes.
- Every line the bf16 splits, variants, probes and planted faults change
  stands once in the source."""

import re

import numpy as np
import pytest

import chip_smoke as S
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import lstm as LK
from test_torch_lstm_bwd_plan import _count_in_sources

SOURCE = (_build.CSRC / "lstm_seq.cu").read_text()
OPTIN = 232448      # an H100's shared memory a block may opt in to


def _constants():
    """The bf16 forms' tiling constants as the source has them."""
    return {name: int(v) for name, v in re.findall(
        r"constexpr int (kRows|kWarpsB|kKCF|kKCB|kChunkK|kGroupK|kMaxUnits)"
        r" = (\d+);", SOURCE)}


def _ld(k):
    return 16 * -(-k // 16) + 8


def split(d, units, blocks):
    """``SplitBf16`` from the source's constants: (P, MP, KR, LDP)."""
    c = _constants()
    assert "LDP = 64 * ((KR + 63) / 64) + 32;" in SOURCE
    p = next((q for q in range(c["kGroupK"], 1, -1) if blocks % q == 0), 1)
    kr = c["kChunkK"] * -(-(4 * d // c["kChunkK"]) // p)
    return p, p * units, kr, 64 * -(-kr // 64) + 32


def fwd_bytes(d, units, stages, e=0):
    """``PlanFwdBf16``: W_x's and W_h's slices [4U][LDK] bf16, then the
    larger of the ring of ``stages`` slices [64][kKCF + 8] and the halves'
    f32 sums [64][4U]."""
    c = _constants()
    assert "constexpr int stage_elems(int KC) {\n  return kRows * (KC + 8);" \
        in SOURCE
    return (4 * units * (_ld(e) if e else 0) * 2 + 4 * units * _ld(d) * 2
            + max(stages * c["kRows"] * (c["kKCF"] + 8) * 2,
                  c["kRows"] * 4 * units * 4))


def bwd_bytes(d, units, stages, remat, part):
    """``PlanBwdBf16``: W_h's column slice (remat), the region (the remat
    ring [64][kKCB + 8] a stage, or the halves' sums and the dpeep terms
    [3][64][U]), then the block's part of W_h where ``part``."""
    c = _constants()
    _, mp, _, ldp = split(d, units, -(-d // units))
    return ((4 * units * _ld(d) * 2 if remat else 0)
            + max(stages * c["kRows"] * (c["kKCB"] + 8) * 2 if remat else 0,
                  c["kRows"] * 4 * units * 4 + 3 * c["kRows"] * units * 4)
            + (mp * ldp * 2 if part else 0))


def fwd_stages(d, units, e=0):
    """``stages_fwd_bf16``: the most stages up to 3 that fit, else 0."""
    assert ("  for (int s = 3; s >= 2; --s)\n    if (PlanFwdBf16(D, U, s, E)"
            in SOURCE)
    return next((s for s in (3, 2) if fwd_bytes(d, units, s, e) <= OPTIN), 0)


def bwd_plan(d, units, remat):
    """``plan_bwd_bf16``: (stages, part in shared memory), the part first."""
    assert "  for (int p = 1; p >= 0; --p)\n    for (int s = remat ? 3 : 2;" \
        in SOURCE
    for part in (True, False):
        for s in ((3, 2) if remat else (2,)):
            if bwd_bytes(d, units, s, remat, part) <= OPTIN:
                return s, part
    return 0, False


@pytest.mark.parametrize("d,units,fwd,remat,stored", [
    (1280, 10, 3, (2, True), (2, True)),   # the text classifier
    (512, 4, 3, (3, True), (2, True)),     # bench_lstm's other widths
    (256, 2, 3, (3, True), (2, True)),
    (64, 2, 3, (3, True), (2, True)),      # the OCR CRNN's backward
    (1744, 14, 2, (3, False), (2, True)),  # the widest D on 132 SMs
])
def test_smem_plans_are_the_sources_plans(d, units, fwd, remat, stored):
    assert LK._bf16_units(d, 132) == units
    for s in (2, 3):
        assert LK._bf16_fwd_bytes(d, units, s) == fwd_bytes(d, units, s)
        for r in (True, False):
            for p in (True, False):
                assert LK._bf16_bwd_bytes(d, units, s, r, p) == bwd_bytes(
                    d, units, s, r, p)
    assert fwd_stages(d, units) == fwd
    assert bwd_plan(d, units, True) == remat
    assert bwd_plan(d, units, False) == stored
    assert LK.bf16_refusal(d, 132, OPTIN) is None
    assert LK._bf16_split(d, units, -(-d // units)) == split(
        d, units, -(-d // units))


def test_fused_input_plan_is_the_sources_plan():
    """Row 6's block (E 128, D 512, U 4): W_x's slice before W_h's, the
    refusal's two stages, three at the launch."""
    assert LK.fi_bf16_smem_bytes(128, 512, 4) == fwd_bytes(512, 4, 2, 128)
    assert fwd_stages(512, 4, 128) == 3
    assert LK.fi_bf16_refusal(128, 512, 132, OPTIN) is None


def test_the_widest_d_and_the_split_at_the_text_shape():
    """D 1744 taken, 1752 refused on 132 SMs (the forward at two stages);
    at D 1280 the 128 blocks split X's 160 chunks in groups of 8, 20
    chunks (640 k) a block for the group's 80 units."""
    assert LK.bf16_refusal(1744, 132, OPTIN) is None
    assert "shared memory" in LK.bf16_refusal(1752, 132, OPTIN)
    assert split(1280, 10, 128) == (8, 80, 640, 672)
    assert split(64, 2, 32) == (8, 16, 32, 96)
    assert split(40, 6, 7)[0] == 7 and split(48, 4, 12)[0] == 6
    assert split(24, 2, 11) == (1, 2, 96, 160)


# -- the backward's exchange -------------------------------------------------


def dgates_writes(d, units, b):
    """{(row, column): times written} of X over every block and 64-row
    chunk: first-half warp w, lane l holds row 16 (w % 4) + l / 4 + 8 (l %
    2) and unit u0 + 2 j + (l / 2) % 2 of tile j < U / 2; it writes the
    four columns 4 u .. 4 u + 3 where the row is below B and u below D."""
    c = _constants()
    rows_c, nt = c["kRows"], units // 2
    writes = np.zeros((b, 4 * d), int)
    for blk in range(-(-d // units)):
        u0 = blk * units
        for b0 in range(0, b, rows_c):
            rows = min(rows_c, b - b0)
            for w in range(4):
                for lane in range(32):
                    rl = 16 * w + (lane >> 2) + 8 * (lane & 1)
                    for j in range(nt):
                        u = u0 + 2 * j + ((lane >> 1) & 1)
                        if rl < rows and u < d:
                            writes[b0 + rl, 4 * u:4 * u + 4] += 1
    return writes


@pytest.mark.parametrize("d,units,b", [
    (1280, 10, 64), (64, 2, 64), (48, 4, 70), (40, 6, 5)])
def test_every_dgates_entry_is_written_once_a_step(d, units, b):
    assert (dgates_writes(d, units, b) == 1).all()


def part_chunks(c0, c1):
    """(loaded, multiplied) chunks of ``dh_part``'s loop over [c0, c1):
    loads of four chunks into buffer a or b (past c1 none), each multiply
    of a buffer taking its chunks below c1."""
    loaded, used = [], []
    bufs = {}

    def load(name, c):
        bufs[name] = [c + i for i in range(4) if c + i < c1]
        loaded.extend(bufs[name])

    def multiply(name, c):
        got = [c + i for i in range(4) if c + i < c1]
        assert bufs[name] == got
        used.extend(got)

    load("a", c0)
    c = c0
    while c < c1:
        load("b", c + 4)
        multiply("a", c)
        if c + 4 >= c1:
            break
        load("a", c + 8)
        multiply("b", c + 4)
        c += 8
    return loaded, used


@pytest.mark.parametrize("c0,c1", [
    (0, 20), (140, 160), (0, 1), (3, 4), (0, 4), (0, 5), (0, 8), (2, 11),
    (5, 5)])
def test_every_chunk_of_a_part_is_loaded_and_multiplied_once(c0, c1):
    """20 chunks a block at D 1280, one at the CRNN's D 64; ranges ending
    on either buffer."""
    loaded, used = part_chunks(c0, c1)
    assert loaded == used == list(range(c0, c1))


def dh_walk(d, units, b, left_out=False):
    """One step's dh product over every block, as the kernels index it:
    (X reads [B][4D] over all blocks, partial writes [blocks][MP][BP],
    dh writes [B][D], the W part's loads [blocks][MP][KR]).  ``left_out``:
    the planted ``part_left_out`` (the second pass from part 2)."""
    c = _constants()
    warps, rows_c, kc = c["kWarpsB"], c["kRows"], c["kChunkK"]
    blocks = -(-d // units)
    p, mp, kr, _ = split(d, units, blocks)
    nch = 4 * d // kc
    bp = rows_c * -(-b // rows_c)
    reads = np.zeros((b, 4 * d), int)
    pwrites = np.zeros((blocks, mp, bp), int)
    wloads = np.zeros((blocks, mp, kr), int)
    dh = np.zeros((b, d), int)
    lane = np.arange(32)
    g, q, eight = lane >> 2, lane & 3, np.arange(8)

    def add(table, rows, cols, ok):
        np.add.at(table, (np.repeat(rows[ok], len(eight)),
                          (cols[ok][:, None] + eight).ravel()), 1)

    for j in range(blocks):
        kk = j % p
        g0 = j - kk
        nmu = min(mp, d - g0 * units)
        c0, c1 = kk * nch // p, (kk + 1) * nch // p
        for b0 in range(0, b, rows_c):
            for w in range(warps):
                row = b0 + 8 * w + g
                for ch in part_chunks(c0, c1)[1]:
                    add(reads, row, ch * kc + 8 * q, row < b)
                    for mt in range(-(-nmu // 16)):
                        for h in range(2):
                            m = 16 * mt + g + 8 * h
                            add(wloads[j], m, (ch - c0) * kc + 8 * q, m < nmu)
                for mt in range(-(-nmu // 16)):
                    for h in range(2):
                        m = 16 * mt + g + 8 * h
                        r = b0 + 8 * w + 2 * q
                        ok = m < nmu
                        np.add.at(pwrites[j], (np.repeat(m[ok], 2),
                                               (r[ok][:, None]
                                                + np.arange(2)).ravel()), 1)
    for j in range(blocks):
        kk = j % p
        u0, nu = j * units, min(units, d - j * units)
        nq = -(-b // 4)
        for e in range(nu * nq):
            m, r = e // nq, 4 * (e % nq)
            parts = range(2 if left_out else 1, p)
            assert all(pwrites[j - kk + i, kk * units + m, r:r + 4].all()
                       for i in [0, *parts])
            for v in range(4):
                if r + v < b:
                    dh[r + v, u0 + m] += 1
    return reads, pwrites, dh, wloads


@pytest.mark.parametrize("d,units,b", [
    (1280, 10, 64),   # the text shape: 16 groups of 8 blocks
    (64, 2, 64),      # the CRNN's: 4 groups of 8, a chunk a block
    (256, 2, 130),    # three chunks of rows, the last short
    (40, 6, 9),       # 7 blocks, one group of 7, the last block 4 units
    (24, 2, 5),       # 12 blocks: groups of 6
])
def test_dh_passes_read_and_write_every_entry_once(d, units, b):
    blocks = -(-d // units)
    p, mp, _, _ = split(d, units, blocks)
    reads, pwrites, dh, wloads = dh_walk(d, units, b)
    assert (reads == blocks // p).all()          # once a group
    assert (dh == 1).all()
    for j in range(blocks):
        nmu = min(mp, d - (j - j % p) * units)
        assert (pwrites[j, :nmu] == 1).all()
        assert not pwrites[j, nmu:].any()
        assert not wloads[j, nmu:].any()


def two_passes(x, w_h, units, left_out=False):
    """The dh product in float64 by the kernels' passes: each block's part
    over its chunks (each MMA's 16 k as a lane's registers give them), the
    parts of a group added in block order.  x [B, 4D] in X's column order,
    w_h [D, 4D]; returns dh [B, D] and how often each k fed an MMA slot."""
    d = w_h.shape[0]
    kc = _constants()["kChunkK"]
    blocks = -(-d // units)
    p, mp, _, _ = split(d, units, blocks)
    nch = 4 * d // kc
    wx = w_h.reshape(d, 4, d).transpose(0, 2, 1).reshape(d, 4 * d)
    wx = np.pad(wx, ((0, blocks * units - d), (0, 0)))
    parts = np.zeros((blocks, mp, x.shape[0]))
    slots = np.zeros((blocks // p, 4 * d), int)
    for j in range(blocks):
        kk, g0 = j % p, j - j % p
        rows = wx[g0 * units:g0 * units + mp]
        for ch in range(kk * nch // p, (kk + 1) * nch // p):
            for mma in range(2):
                ks = [ch * kc + 8 * ((lg % 8) // 2) + 4 * mma
                      + 2 * (lg >= 8) + lg % 2 for lg in range(16)]
                slots[j // p, ks] += 1
                parts[j] += rows[:, ks] @ x[:, ks].T
    dh = np.zeros((x.shape[0], blocks * units))
    for j in range(blocks):
        kk, g0 = j % p, j - j % p
        own = slice(kk * units, (kk + 1) * units)
        keep = [i for i in range(p) if not (left_out and i == 1)]
        dh[:, j * units:(j + 1) * units] = sum(
            parts[g0 + i, own] for i in keep).T
    return dh[:, :d], slots


@pytest.mark.parametrize("d,units", [(64, 2), (40, 6), (24, 2)])
def test_the_two_passes_are_x_times_w_h_and_a_part_left_out_misses(
        rng_np, d, units):
    """Each k of a group feeds one MMA slot once, and the passes sum to
    dgates W_h^T (dgates gate-major [B, 4D]); leaving a group's second part
    out of the sum (the planted fault) misses."""
    dg = rng_np.normal(size=(9, 4 * d))
    w_h = rng_np.normal(size=(d, 4 * d))
    x = dg.reshape(9, 4, d).transpose(0, 2, 1).reshape(9, 4 * d)
    got, slots = two_passes(x, w_h, units)
    assert (slots == 1).all()
    np.testing.assert_allclose(got, dg @ w_h.T, rtol=1e-12, atol=1e-12)
    bad, _ = two_passes(x, w_h, units, left_out=True)
    if split(d, units, -(-d // units))[0] > 1:
        assert np.abs(bad - dg @ w_h.T).max() > 1e-3


def built_part(w_h, units, j):
    """Block j's part of W_h as the backward kernel builds it from W_h
    [D, 4D]: element e of MP x KR goes to row m = e / KR, column 4 ul + g
    (ul = e % (KR / 4), g = e / (KR / 4) % 4), from W_h[g0 U + m, g D +
    c0 32 / 4 + ul], zero past its chunks and past D; and how often each
    entry was written."""
    d = w_h.shape[0]
    p, mp, kr, ldp = split(d, units, -(-d // units))
    kk, g0 = j % p, j - j % p
    nch = 4 * d // 32
    c0, c1 = kk * nch // p, (kk + 1) * nch // p
    uw, ul1 = kr // 4, (c1 - c0) * 32 // 4
    part = np.full((mp, ldp), np.nan)
    written = np.zeros((mp, ldp), int)
    for e in range(mp * kr):
        ul, g, m = e % uw, (e // uw) % 4, e // kr
        row = g0 * units + m
        ok = ul < ul1 and row < d
        part[m, 4 * ul + g] = w_h[row, g * d + c0 * 8 + ul] if ok else 0.0
        written[m, 4 * ul + g] += 1
    return part, written, c0, c1


def test_each_block_builds_its_part_of_w_h_in_the_exchange_order(rng_np):
    """Row m, column k' of block j = g0 + kk's part is W_h[g0 U + m] at X's
    column 32 c0 + k' (column 4 u + g: W_h[., g D + u]); every column
    below KR written once, zero past its chunks and past D; at equal
    chunk ranges and at unequal ones (a group of 7, 20 chunks)."""
    for d, u in ((64, 2), (40, 6)):
        w_h = rng_np.normal(size=(d, 4 * d))
        wx = w_h.reshape(d, 4, d).transpose(0, 2, 1).reshape(d, 4 * d)
        p, mp, kr, _ = split(d, u, -(-d // u))
        for j in range(-(-d // u)):
            part, written, c0, c1 = built_part(w_h, u, j)
            assert (written[:, :kr] == 1).all() and not written[:, kr:].any()
            g0 = j - j % p
            rows = min(mp, d - g0 * u)
            want = wx[g0 * u:g0 * u + rows, 32 * c0:32 * c1]
            np.testing.assert_array_equal(part[:rows, :32 * (c1 - c0)], want)
            assert not part[rows:, :kr].any()
            assert not part[:, 32 * (c1 - c0):kr].any()


# -- the forward's ring ------------------------------------------------------


def ring_walk(rows, k, stages, kc):
    """``product_bf16``'s ring over one 64-row chunk of A [rows, K]:
    ``load_slice_a<KC>`` of slice c stages (row, 8 k) groups p = r KC / 8
    + q into slot c % S; slices 0 .. S - 2 before the loop, slice c + S - 1
    after slice c's barrier; returns (staged [64][K], the events in
    order)."""
    c = _constants()
    assert "  for (int p = threadIdx.x; p < kRows * (KC / 8); p += kThreadsB) {" \
        in SOURCE
    nc = -(-k // kc)
    staged = np.zeros((c["kRows"], k), int)
    events = []

    def load(s):
        for p in range(c["kRows"] * (kc // 8)):
            r, q = p // (kc // 8), p % (kc // 8)
            kk = s * kc + 8 * q
            if r < rows and kk < k:
                staged[r, kk:kk + 8] += 1
        events.append(("load", s, s % stages))

    for s in range(stages - 1):
        if s < nc:
            load(s)
    for s in range(nc):
        events.append(("read", s, s % stages))
        if s + stages - 1 < nc:
            load(s + stages - 1)
    return staged, events


@pytest.mark.parametrize("rows,k,stages,kc", [
    (64, 1280, 3, 128), (64, 512, 3, 128), (64, 64, 3, 128),
    (64, 1280, 2, 64), (5, 1280, 3, 64), (64, 200, 2, 128), (17, 128, 2, 64)])
def test_ring_stages_every_row_and_slice_once(rows, k, stages, kc):
    """The forward's 128-deep slices, the remat backward's 64-deep ones."""
    staged, events = ring_walk(rows, k, stages, kc)
    assert (staged[:rows] == 1).all() and (staged[rows:] == 0).all()
    # a slot is refilled only after the slice it held was read
    held = {}
    for kind, s, slot in events:
        if kind == "load":
            assert held.get(slot) is None, (s, slot)
            held[slot] = s
        else:
            assert held.pop(slot) == s


@pytest.mark.parametrize("k", [1280, 512, 256, 64, 200])
def test_every_row_tile_and_step_is_taken_by_one_warp_half(k):
    """Warp w takes row tile w % 4 and, of a slice's 16-deep steps, every
    other one from w / 4: each (row tile, step) once, and the same steps
    in the same order at either depth (so the forward's and the remat
    backward's products give the same bits)."""
    c = _constants()
    orders = []
    for kc in (c["kKCF"], c["kKCB"]):
        taken = np.zeros((4, -(-k // 16)), int)
        order = []
        for w in range(c["kWarpsB"]):
            mi, kh = w & 3, w >> 2
            for s in range(-(-k // kc)):
                nks = (min(kc, k - s * kc) + 15) // 16
                for ks in range(kh, nks, 2):
                    taken[mi, s * kc // 16 + ks] += 1
                    order.append((w, s * kc // 16 + ks))
        assert (taken == 1).all()
        orders.append(order)
    assert orders[0] == orders[1]


# -- the lines the measurements and faults change -----------------------------


@pytest.mark.parametrize("name,variants", [
    # the splits' variants of this source (the others are the parent's)
    ("LSTM_BF16_BWD_SPLIT", ("no_remat_product_kc", "no_dgates_writes",
                             "no_dh_part", "no_dh_sum",
                             "no_grid_barriers_dh")),
    ("LSTM_BF16_FWD_SPLIT", ("no_h_product_kc", "no_x_product_kc",
                             "no_grid_barrier", "no_cell")),
    ("LSTM_BF16_VARIANTS", None),
    ("LSTM_BF16_PROBES", None),
    ("LSTM_BF16_DH_PROBES", None),
])
def test_chip_ab_bf16_lines_are_once_in_the_source(name, variants):
    import chip_ab

    table = getattr(chip_ab, name)
    for variant in variants or table:
        for line, _ in table[variant]:
            assert _count_in_sources("lstm_seq", line) == 1, (variant, line)


def test_bf16_planted_fault_lines_are_once_in_the_source():
    for edits in S.LSTM_BF16_FAULTS.values():
        for line, _ in edits:
            assert _count_in_sources("lstm_seq", line) == 1, line
    line = S.BF16_LAST_FAULTS["lstm_fi_projection_rounded"][2]
    assert _count_in_sources("lstm_seq", line) == 1

// Fused LSTM over a whole sequence: the forward (over xw, or over raw x
// with the input projection inside the loop, one template flag) and the
// backward, each one persistent cooperative launch that walks every time
// step.
//
// Replaces paddle_tpu/ops/pallas/lstm.py::lstm_seq (the Pallas _fwd_kernel,
// _bwd_kernel and _bwd_remat_kernel: grid (batch blocks, T) run in order on
// one core, W_h resident in VMEM, the h/c carries in VMEM scratch) and
// lstm.py::lstm_seq_fi (_fwd_fi_kernel: the same grid with W_x resident
// too, so the [T, B, 4D] gate-input slab never reaches HBM); f32 and bf16
// forms of each.
//
// Layout (batch-major, as the JAX entry takes it): xw [B, T, 4D] with gate
// order [i, f, g, o]; mask [B, T] f32 (1 while t < length; rows freeze
// afterwards); W_h [D, 4D]; peephole [3, D] = [W_ci, W_cf, W_co] (i and f
// see c_{t-1}, o sees c_t); h0, c0 [B, D]; hs, cs [B, T, D].  ``reverse``
// runs the same recurrence over indices T-1..0 (no flipped copies).
// D % 4 == 0 (16-byte copies).
//
// What bounds it on an H100: operations, and the step-to-step dependency.
// Each step is a [B, D] x [D, 4D] product (at B 64, D 1280: 0.84 GFLOP,
// 107 GFLOP over 128 steps) whose input h_{t-1} exists only once every
// unit of the previous step is done.  At D 1280, f32 W_h is 26.2 MB: it
// fits no SM, so the TPU design (W_h whole in VMEM) does not carry over.
// Instead each of ~128 blocks (one per SM) owns U hidden units and keeps
// W_h[:, the 4U gate columns of its units] in shared memory for the whole
// sequence (packed by the wrapper as wpack[block][D][U][4], the four gates
// of a unit side by side); a grid-wide barrier (cooperative launch) ends
// each step, because every block needs all of h_{t-1}.  A grid that
// cannot be co-resident is refused by cudaLaunchCooperativeKernel and the
// error is returned, never spun on.
//
// The product routine (gemm_gates): on the tensor cores as 3xTF32
// (mma.sync.m16n8k8 from csrc/tf32x3.cuh: hi = tf32(a), lo = tf32(a -
// hi), each rounded to nearest by two integer operations; hi.hi + hi.lo +
// lo.hi, each 8-deep slice's three passes summed apart from zero and
// added to nearest, because the tensor cores truncate the sums they
// round).  Each m16 x n8 tile of a 64-row chunk sums its K half (every
// other 8-deep slice) in order, and the halves' sums go through shared
// memory and are added in a fixed order, half 0 + half 1, into the thread
// (half, rg, uu) that runs the cell of rows rg + 16 (2 half + i) (i < 2)
// of unit uu.  Two walks share out the tiles: by rows (a warp a row tile
// and K half, every n8 tile: the forward below U 7) and by columns (a
// warp an n8 tile and K half, all four row tiles: the forward from U 7
// and the remat backward, whose block is 32U threads).  A tile's sum takes
// the same operations in every walk, so the forward and the remat
// backward give the same gates.  h_{t-1} streams through shared memory,
// three stages of cp.async in flight; the W slice stays [K][U][4] (at D
// 1280, U 10, 204,800 of the 232,448 bytes a block may opt in to: no room
// for a split copy), so each B fragment is split as it is read.
//
// The fused-input forward (lstm_fi_fwd_f32) takes raw x [B, T, E], W_x
// [E, 4D] and b [4D]: each block keeps the [E][U][4] column slice of W_x
// of its units beside its W_h slice ((E + D) 4U floats: 40 KB at E 128,
// D 512, U 4), and each step computes b + x_t W_x for its columns with
// gemm_gates over the x_t rows, then adds h_{t-1} W_h as the forward over
// xw does: two sums, (b + x_t W_x) + h W_h, in the JAX kernel's order.  At
// B 64, E 128, D 512 a step is 168 MFLOP, a quarter of it the projection;
// the [B, T, 4D] xw slab (at T 100, 52 MB) is neither written nor read.
// The outputs and the gates slab (remat off) are the forward's, in the
// layout the backward reads.  csrc/bilstm_seq.cu is no start for it: a
// block there holds all of W_h, which caps D near 116.
//
// The gates slab (remat off): a row's gates lie in four runs of D units,
// of which a block owns U, while a warp's cell covers 16 rows of 2 units
// each, so a store from the cell touches 16 rows' sectors a few bytes
// each.  Every forward form instead puts its chunk's gates in the staging
// area ([rows][4][U], free once the product is summed) and the block
// stores them a run of U units at a time (store_gates).
//
// Backward, reverse time.  (A) per own unit: the gates (recomputed from xw
// and the shifted h/c stacks with gemm_gates and the forward's cell code
// when remat is on, so both forms give the same bits; read from the slab
// when it is off), the gate cotangents from dh = carry + dhs[t] and the dc
// carry, written to dgates [B, T, 4D]; the peephole sums; the dc carry;
// and this block's share of dh_{t-1}: P[block][k][b] = sum over its own 4U
// columns c of dgates[b, c] * W_h[k, c], for every k, from the same W
// slice, on the tensor cores as 3xTF32 (dh_share): written to a scratch
// buffer (two, by step parity, so no block overwrites one another block is
// still reading).  Grid barrier.  (B) for its own units: dh_{t-1} = sum of
// the partials over blocks, 16 bytes (four rows, part's rows padded to a
// multiple of 4) a load, in block order within each of a few ranges of
// blocks and the ranges in order.  No atomics anywhere, so reruns are
// bit-identical; dpeep of a unit is summed in a fixed order over batch and
// time.  dW_h is one large product outside, as in the JAX package.
//
// Where the backward's time goes (the parent's FMA form at B 64, T 128,
// D 1280, remat; chip_ab.py --lstm-bwd-split): the remat product and the
// dh product about a third each, the (B) sum a fifth, the partials' writes
// and the grid barrier little (the writes leave the SM at once).  Summing
// the shares inside thread-block clusters over DSMEM before they reach
// device memory was built and ran slower: the card holds the 128 one-SM
// CTAs whole only in clusters of 2 (of 4 and 8: 120), which halves the sum
// but costs 65 cluster barrier phases a step.  So the dh product moved to
// the tensor cores and the sum to wider loads with more of them in flight;
// then the remat product, with the forward's (gemm_gates).
//
// Every value written during the launch by another block is read through
// L2 (__ldcg, cp.async.cg), never from a stale L1 line.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"
#include "tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 64;             // batch rows per chunk
constexpr int kRG = 16;               // row groups: thread rows rg + 16 i
constexpr int kK = 32;                // depth of one staged chunk of A
constexpr int kLda = kK + 4;          // its padded row stride (floats)
constexpr int kStage = kRows * kLda;  // floats a stage
constexpr int kMaxUnits = 16;         // 32U threads a block, at most 512

// Shared-memory plan (floats), the same formula on host and device (and in
// ops/kernels/lstm.py's _smem_floats): K rows of [U][4] weights (D, or
// E + D for the fused-input forward), then the staging area.  Once a
// chunk's product is done the staging area holds the halves' sums
// [2][kRows][4U + 4] (padded rows: no bank conflicts), then in the
// backward the dgates tile [kRows][4U + 4] and the peephole partials
// [3][32][U].
__host__ __device__ inline int row_stride(int U) { return 4 * U + 4; }

struct Plan {
  int a, total;
  __host__ __device__ Plan(int K, int U, int stages) {
    a = K * 4 * U;
    int scratch = stages * kStage;
    const int sums = 2 * kRows * row_stride(U);
    const int tiles = kRows * row_stride(U) + 3 * 2 * kRG * U;
    scratch = max(scratch, max(sums, tiles));
    total = a + scratch;
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

struct Gates {
  float i, f, g, o, c, h;
};

// The gate bundle of one (row, unit): x* are the xw entries, a* the
// h_{t-1} @ W_h products, cp = c_{t-1}.  Shared by the forward and the
// remat backward, so both compute the gates with the same instructions.
__device__ __forceinline__ Gates cell(float xi, float xf, float xg, float xo,
                                      float ai, float af, float ag, float ao,
                                      float cp, float p0, float p1,
                                      float p2) {
  Gates r;
  r.i = sigm((xi + ai) + p0 * cp);
  r.f = sigm((xf + af) + p1 * cp);
  r.g = tanhf(xg + ag);
  r.c = r.f * cp + r.i * r.g;
  r.o = sigm((xo + ao) + p2 * r.c);
  r.h = r.o * tanhf(r.c);
  return r;
}

// Stage chunk c of A (rows [0, rows) at a + r * lda, columns c*kK ..
// c*kK + kK - 1, zero past rows and K) into buf [kRows][kLda].
__device__ __forceinline__ void load_chunk(float* buf, const float* a,
                                           size_t lda, int rows, int K,
                                           int c) {
  for (int p = threadIdx.x; p < kRows * (kK / 4); p += blockDim.x) {
    const int r = p / (kK / 4), q = p % (kK / 4);
    const int k = c * kK + 4 * q;
    const bool ok = r < rows && k < K;
    cp_async16(buf + r * kLda + 4 * q, ok ? a + r * lda + k : a, ok);
  }
}

constexpr int kRowJobs = 8;         // the row walk: 4 row tiles x 2 K halves
constexpr int kColumnsFrom = 7;     // the forward walks by n8 tiles from U 7
constexpr int kNarrow = 320;        // a block bound that leaves 204 registers

// d = a . b from zero (tf32x3::mma with no accumulator to clear first):
// the first pass of a slice
__device__ __forceinline__ void mma_zero(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%10, %10, %10, %10};\n"
               : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1), "f"(0.f));
}

// Q slices' three passes over M row tiles and T n8 tiles, each summed
// apart from zero in mma3's order (lo.hi, hi.lo, hi.hi), every pass over
// all Q x M x T products before the next, so that the products issued in
// turn are independent: pt[q][m][j] = a[q][m] . b[q][j]
template <int Q, int M, int T>
__device__ __forceinline__ void passes(float (&pt)[Q][M][T][4],
                                       const tf32x3::SplitA (&as)[Q][M],
                                       const uint32_t (&bh)[Q][T][2],
                                       const uint32_t (&bl)[Q][T][2]) {
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < T; ++j)
        mma_zero(pt[q][m][j], as[q][m].lo, bh[q][j][0], bh[q][j][1]);
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < T; ++j)
        tf32x3::mma(pt[q][m][j], as[q][m].hi, bl[q][j][0], bl[q][j][1]);
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < T; ++j)
        tf32x3::mma(pt[q][m][j], as[q][m].hi, bh[q][j][0], bh[q][j][1]);
}

// The two walks of the product below share the staging ring: h's rows
// [0, rows) of `a` (lda apart) in 32-deep chunks through a_s, S stages;
// stage(c, buf) runs once a chunk with its stage in shared memory, every
// thread of the block taking part.
template <int S, typename Stage>
__device__ __forceinline__ void ring(const float* a, size_t lda, int rows,
                                     int K, float* a_s, Stage stage) {
  const int nc = (K + kK - 1) / kK;
#pragma unroll
  for (int c = 0; c < S - 1; ++c) {
    if (c < nc) load_chunk(a_s + c * kStage, a, lda, rows, K, c);
    cp_async_commit();
  }
  for (int c = 0; c < nc; ++c) {
    cp_async_wait<S - 2>();
    __syncthreads();
    const int cn = c + S - 1;
    if (cn < nc) load_chunk(a_s + (cn % S) * kStage, a, lda, rows, K, cn);
    cp_async_commit();
    stage(c, a_s + (c % S) * kStage);
  }
  __syncthreads();       // every chunk read: the staging area is free
}

// A lane's B fragment, column n (an n8 tile's column g) of slice rows k0
// and k0 + 4 of the [K][U][4] slice w_s (cols = 4U a row), split as it
// is read; zero past 4U, past K (in1: row k0 + 4 exists) or where !live
__device__ __forceinline__ void split_b(const float* w_s, int k0, int cols,
                                        int n, bool live, bool in1,
                                        uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  const float* w = w_s + (size_t)k0 * cols + n;
  live = live && n < cols;
  tf32x3::split(live ? w[0] : 0.f, bh[0], bl[0]);
  tf32x3::split(live && in1 ? w[4 * cols] : 0.f, bh[1], bl[1]);
}

// The product on the tensor cores as 3xTF32 (csrc/tf32x3.cuh), in two
// walks that give the same bits.  Both take a 64-row chunk's m16 row
// tiles, the 8-deep slices of one parity (the K half) and n8 tiles of the
// block's 4U columns (zero past 4U: an odd U's last tile is half live); a
// job's two slices of a 32-deep chunk go together, each splitting its A
// fragments once for the job's tiles and each B fragment (rows k, k + 4
// of the [K][U][4] slice) as it is read; a slice's passes are summed
// apart from zero (passes()) and added to the tile's sum of its K half to
// nearest, the slices in order.  So a tile's sum takes the same
// operations whichever walk, job and warp run it, and its bits depend on
// the values only.  Each K half's sums land in sums[kh][row][col] (rows
// below `rows`, columns below 4U).
//
// The row walk (the forward below U 7): job j < 8 (warp j) takes row tile
// j % 4 and K half j / 4, every n8 tile (nt = ceil(U / 2) <= 3), two at a
// time.
template <int S>
__device__ __forceinline__ void gates_rows(const float* a, size_t lda,
                                           int rows, int K, const float* w_s,
                                           int U, float* a_s) {
  constexpr int TPJ = 4, G = 2;            // tiles a job holds, at a time
  const int lane = threadIdx.x & 31, job = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int cols = 4 * U, nt = (U + 1) / 2, kh = job / 4;
  float acc[TPJ][4] = {};
  ring<S>(a, lda, rows, K, a_s, [&](int c, const float* buf) {
    const int ns = (min(kK, K - c * kK) + 7) / 8;   // K % 4 == 0
    if (job >= kRowJobs || kh >= ns) return;
    const bool two = kh + 2 < ns;                   // its second slice
    const int k0 = c * kK + 8 * kh + tq;            // row k0 (+ 16 q)
    const bool in1[2] = {k0 + 4 < K, two && k0 + 20 < K};
    const float* r0 = buf + (16 * (job & 3) + gq) * kLda + 8 * kh + tq;
    tf32x3::SplitA as[2][1];   // [slice]: rows g, g + 8; columns t, t + 4
#pragma unroll
    for (int q = 0; q < 2; ++q)
      as[q][0].set(r0[16 * q], r0[16 * q + 8 * kLda], r0[16 * q + 4],
                   r0[16 * q + 8 * kLda + 4]);
#pragma unroll
    for (int j0 = 0; j0 < TPJ; j0 += G) {
      if (j0 >= nt) break;
      uint32_t bh[2][G][2], bl[2][G][2];
      float pt[2][1][G][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int jj = 0; jj < G; ++jj)
          split_b(w_s, k0 + 16 * q, cols, 8 * (j0 + jj) + gq,
                  j0 + jj < nt && (q == 0 || two), in1[q], bh[q][jj],
                  bl[q][jj]);
      passes(pt, as, bh, bl);
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int jj = 0; jj < G; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (q == 0 || two) acc[j0 + jj][e] += pt[q][0][jj][e];
    }
  });
  if (job >= kRowJobs) return;
  // acc[j]: rows g (0, 1) and g + 8 (2, 3), columns 2t, 2t + 1 of tile j
  const int ld = row_stride(U), r = 16 * (job & 3) + gq;
  float* out = a_s + (size_t)kh * kRows * ld + 2 * tq;
#pragma unroll
  for (int j = 0; j < TPJ; ++j) {
    if (j >= nt || 8 * j + 2 * tq >= cols) continue;
    if (r < rows)
      *reinterpret_cast<float2*>(out + r * ld + 8 * j) =
          make_float2(acc[j][0], acc[j][1]);
    if (r + 8 < rows)
      *reinterpret_cast<float2*>(out + (r + 8) * ld + 8 * j) =
          make_float2(acc[j][2], acc[j][3]);
  }
}

// The column walk (the forward from U 7, at 32 max(U, 2 nt) threads, and
// the remat backward, at 32U): job j takes n8 tile j / 2 and K half j % 2
// for all four row tiles, two at a time, so that 2 nt jobs keep the warps
// busy (job j on warp j % warps, J = ceil(2 nt / warps) <= 2 a warp) and
// each B fragment is split once a block.
template <int S, int J>
__device__ __forceinline__ void gates_cols(const float* a, size_t lda,
                                           int rows, int K, const float* w_s,
                                           int U, float* a_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5, gq = lane >> 2, tq = lane & 3;
  const int cols = 4 * U, jobs = 2 * ((U + 1) / 2);
  float acc[J][4][4] = {};
  ring<S>(a, lda, rows, K, a_s, [&](int c, const float* buf) {
    const int ns = (min(kK, K - c * kK) + 7) / 8;   // K % 4 == 0
#pragma unroll
    for (int i = 0; i < J; ++i) {
      const int job = warp + warps * i, kh = job % 2;
      if (job >= jobs || kh >= ns) continue;
      const bool two = kh + 2 < ns;                 // its second slice
      const int k0 = c * kK + 8 * kh + tq, n = 8 * (job / 2) + gq;
      const bool in1[2] = {k0 + 4 < K, two && k0 + 20 < K};
      uint32_t bh[2][1][2], bl[2][1][2];
#pragma unroll
      for (int q = 0; q < 2; ++q)
        split_b(w_s, k0 + 16 * q, cols, n, q == 0 || two, in1[q], bh[q][0],
                bl[q][0]);
#pragma unroll
      for (int m0 = 0; m0 < 4; m0 += 2) {
        tf32x3::SplitA as[2][2];   // [slice][row tile]
        float pt[2][2][1][4];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const float* r0 = buf + (16 * (m0 + m) + gq) * kLda + 8 * kh +
                              16 * q + tq;
            as[q][m].set(r0[0], r0[8 * kLda], r0[4], r0[8 * kLda + 4]);
          }
        passes(pt, as, bh, bl);
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (q == 0 || two) acc[i][m0 + m][e] += pt[q][m][0][e];
      }
    }
  });
  const int ld = row_stride(U);
#pragma unroll
  for (int i = 0; i < J; ++i) {
    const int job = warp + warps * i, col = 8 * (job / 2) + 2 * tq;
    if (job >= jobs || col >= cols) continue;
    float* out = a_s + (size_t)(job % 2) * kRows * ld + col;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r = 16 * m + gq;
      if (r < rows)
        *reinterpret_cast<float2*>(out + r * ld) =
            make_float2(acc[i][m][0], acc[i][m][1]);
      if (r + 8 < rows)
        *reinterpret_cast<float2*>(out + (r + 8) * ld) =
            make_float2(acc[i][m][2], acc[i][m][3]);
    }
  }
}

// fin[i][g] = sum_k A[r_i][k] * W[k][uu][g] for the thread's rows r_i =
// rg + 16 (2 half + i), i < 2 (none at or past `rows`): the K halves'
// sums of the product, the half-0 sum plus the half-1 sum.  The forward
// (kFwd) walks by rows below U 7 and by columns from U 7, the remat
// backward by columns.  The bits depend on the values only, so both give
// the same gates.  A is global (rows [0, rows) at a + r * lda), staged
// through a_s in S stages; w_s is the block's [K][U][4] slice.  Every
// thread of the block must call it.
template <int S, bool kFwd = false>
__device__ __forceinline__ void gemm_gates(const float* a, size_t lda,
                                           int rows, int K, const float* w_s,
                                           int U, int uu, int rg, int half,
                                           float* a_s, float fin[2][4]) {
  if (kFwd && U < kColumnsFrom)
    gates_rows<S>(a, lda, rows, K, w_s, U, a_s);
  else if (2 * ((U + 1) / 2) <= (int)(blockDim.x >> 5))
    gates_cols<S, 1>(a, lda, rows, K, w_s, U, a_s);
  else
    gates_cols<S, 2>(a, lda, rows, K, w_s, U, a_s);
  __syncthreads();
  const int ld = row_stride(U);
  const float* sums = a_s;   // [2][kRows][ld]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rg + kRG * (2 * half + i);
    float4 p = make_float4(0.f, 0.f, 0.f, 0.f), q = p;
    if (r < rows) {
      p = *reinterpret_cast<const float4*>(sums + r * ld + uu * 4);
      q = *reinterpret_cast<const float4*>(sums + (kRows + r) * ld + uu * 4);
    }
    fin[i][0] = p.x + q.x;
    fin[i][1] = p.y + q.y;
    fin[i][2] = p.z + q.z;
    fin[i][3] = p.w + q.w;
  }
  __syncthreads();       // the caller may reuse the staging area
}

__device__ __forceinline__ void load_slice(float* w_s, const float* wpack,
                                           int D, int U) {
  const float4* src = reinterpret_cast<const float4*>(
      wpack + (size_t)blockIdx.x * D * 4 * U);
  float4* dst = reinterpret_cast<float4*>(w_s);
  for (int e = threadIdx.x; e < D * U; e += blockDim.x) dst[e] = src[e];
}

constexpr int kTilesK = 8;   // k tiles of 8 a warp takes at once

// The block's share of dh_{t-1} for one chunk of kRows rows, on the tensor
// cores as 3xTF32 (csrc/tf32x3.cuh): out[k][b] = sum over the block's 4U
// columns c of dg[b][c] * W[k][c], for every k < D and row b < rows, out's
// rows ldo apart.  A =
// the dgates tile dg_s [kRows][ldg], B = the W slice w_s [D][4U]; m16n8k8
// tiles of 16 rows by 8 k, warp w taking the (row tile, group of kTilesK k
// tiles) pairs w, w + warps, ...; each 8-deep slice of the 4U columns
// (zero past 4U) splits its A fragment once for the group, and each
// tile's three passes of a slice are summed apart from zero and added to
// nearest (as mma3_add, the passes issued across the group's tiles so
// that no product waits on the one before it), the slices in order: the
// bits depend on the values only.  Every thread of the block calls it.
__device__ __forceinline__ void dh_share(const float* dg_s, int ldg,
                                         const float* w_s, int U, int D,
                                         int ldo, int rows, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5, g = lane >> 2, t = lane & 3;
  const int cols = 4 * U, slices = (cols + 7) / 8;
  const int groups = (D + 8 * kTilesK - 1) / (8 * kTilesK);
  const int mtiles = (rows + 15) / 16;
  for (int i = warp; i < mtiles * groups; i += warps) {
    const int mt = i / groups, k0 = (i % groups) * 8 * kTilesK;
    const float* r0 = dg_s + (mt * 16 + g) * ldg;
    const float* r1 = r0 + 8 * ldg;
    const float* wr[kTilesK];
#pragma unroll
    for (int j = 0; j < kTilesK; ++j)
      wr[j] = w_s + (size_t)min(k0 + 8 * j + g, D - 1) * cols;
    float acc[kTilesK][4];
#pragma unroll
    for (int j = 0; j < kTilesK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int sl = 0; sl < slices; ++sl) {
      const int c0 = sl * 8 + t, c1 = c0 + 4;
      const bool in1 = c1 < cols;
      tf32x3::SplitA a;   // rows g, g + 8; columns t, t + 4 of the slice
      a.set(r0[c0], r1[c0], in1 ? r0[c1] : 0.f, in1 ? r1[c1] : 0.f);
      uint32_t bh[kTilesK][2], bl[kTilesK][2];
      float part[kTilesK][4];
#pragma unroll
      for (int j = 0; j < kTilesK; ++j) {
        tf32x3::split(wr[j][c0], bh[j][0], bl[j][0]);
        tf32x3::split(in1 ? wr[j][c1] : 0.f, bh[j][1], bl[j][1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
      }
      // the three passes of tf32x3::mma3 (lo.hi, hi.lo, hi.hi) tile by
      // tile, each pass over the kTilesK tiles in turn: the products that
      // issue back to back are independent
#pragma unroll
      for (int j = 0; j < kTilesK; ++j)
        tf32x3::mma(part[j], a.lo, bh[j][0], bh[j][1]);   // lo.hi
#pragma unroll
      for (int j = 0; j < kTilesK; ++j)
        tf32x3::mma(part[j], a.hi, bl[j][0], bl[j][1]);   // hi.lo
#pragma unroll
      for (int j = 0; j < kTilesK; ++j)
        tf32x3::mma(part[j], a.hi, bh[j][0], bh[j][1]);   // hi.hi
#pragma unroll
      for (int j = 0; j < kTilesK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
    }
    // acc[j]: rows g (0, 1) and g + 8 (2, 3), k 2t and 2t + 1 of tile j
    const int r = mt * 16 + g;
#pragma unroll
    for (int j = 0; j < kTilesK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + 8 * j + 2 * t + (e & 1), rr = r + 8 * (e >> 1);
        if (k < D && rr < rows) out[(size_t)k * ldo + rr] = acc[j][e];
      }
  }
}

// The chunk's gates from the tile [rows][4U + V] (element g U + uu of a
// row; V elements a store, Vec) to the slab at step t: thread i takes the
// store column i % (4U / V) of the rows i / (4U / V) + k (threads / (4U /
// V)), so consecutive threads store consecutive units of a run.  A Vec
// never straddles two gates (V divides U).  Every thread of the block
// must call it; it ends with the staging area free.
template <class Elem, class Vec>
__device__ __forceinline__ void store_gates(const Elem* tile, Elem* gates,
                                            int b0, int rows, int t, int T,
                                            int D, int U) {
  constexpr int V = sizeof(Vec) / sizeof(Elem);
  __syncthreads();       // the tile is written
  const int n = 4 * U / V, per = blockDim.x / n, r0 = threadIdx.x / n;
  const int c = V * (threadIdx.x - r0 * n), g = c / U;
  const int u = blockIdx.x * U + c - g * U;
  if (r0 < per && u < D) {
    const size_t T4D = (size_t)T * 4 * D;
    const Elem* src = tile + r0 * (4 * U + V) + c;
    Elem* dst = gates + (b0 + r0) * T4D + (size_t)t * 4 * D +
                (size_t)g * D + u;
    for (int r = r0; r < rows; r += per) {
      *reinterpret_cast<Vec*>(dst) = *reinterpret_cast<const Vec*>(src);
      src += per * (4 * U + V);
      dst += per * T4D;
    }
  }
  __syncthreads();       // the tile is read: the staging area is free
}

// kFi: `in` is raw x [B, T, E] and the block keeps the [E][U][4] slice
// of W_x (wxpack) before its W_h slice; otherwise `in` is xw [B, T, 4D]
// (E, wxpack and bias unused).
// kThreads: the block's bound, as the backward's below
template <bool kFi, int S, int kThreads = 2 * kRG * kMaxUnits>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_kernel(const float* __restrict__ in, const float* __restrict__ mask,
                const float* __restrict__ wxpack,
                const float* __restrict__ bias,
                const float* __restrict__ wpack,
                const float* __restrict__ peep, const float* h0,
                const float* c0, float* hs, float* cs, float* gates,
                float* hT, float* cT, int B, int T, int E, int D, int U,
                int reverse) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Plan plan(kFi ? E + D : D, U, S);
  float* wx_s = smem;                            // [E][U][4] (kFi)
  float* w_s = smem + (kFi ? (size_t)E * 4 * U : 0);
  float* a_s = smem + plan.a;
  const int half = threadIdx.x / (kRG * U), l = threadIdx.x % (kRG * U);
  const int rg = l % kRG, uu = l / kRG;
  const int u = blockIdx.x * U + uu;
  const bool live = u < D;
  if (kFi) load_slice(wx_s, wxpack, E, U);
  load_slice(w_s, wpack, D, U);
  float p0 = 0.f, p1 = 0.f, p2 = 0.f, bv[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
    p0 = peep[u];
    p1 = peep[D + u];
    p2 = peep[2 * D + u];
    if (kFi) {
#pragma unroll
      for (int g = 0; g < 4; ++g) bv[g] = bias[g * D + u];
    }
  }
  cg::grid_group grid = cg::this_grid();
  const size_t TD = (size_t)T * D, T4D = TD * 4, TE = (size_t)T * E;

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      // the cell's other operands, fetched while the product runs
      float x[2][4], hp[2], cp[2], m[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = rg + kRG * (2 * half + i);
        if (!live || r >= rows) continue;
        const int b = b0 + r;
        if (!kFi) {
          const float* xr = in + b * T4D + (size_t)t * 4 * D;
#pragma unroll
          for (int g = 0; g < 4; ++g) x[i][g] = xr[g * D + u];
        }
        const size_t bu = (size_t)b * D + u;
        hp[i] = s == 0 ? __ldcg(h0 + bu)
                       : __ldcg(hs + b * TD + (size_t)tp * D + u);
        cp[i] = s == 0 ? __ldcg(c0 + bu)
                       : __ldcg(cs + b * TD + (size_t)tp * D + u);
        m[i] = mask[(size_t)b * T + t];
      }
      if (kFi) {
        // b + x_t W_x for the own columns, as the twin's xw entries
        float px[2][4];
        gemm_gates<S, true>(in + b0 * TE + (size_t)t * E, TE, rows, E, wx_s,
                            U, uu, rg, half, a_s, px);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int g = 0; g < 4; ++g) x[i][g] = bv[g] + px[i][g];
      }
      const float* a = s == 0 ? h0 + (size_t)b0 * D
                              : hs + b0 * TD + (size_t)tp * D;
      float fin[2][4];
      gemm_gates<S, true>(a, s == 0 ? D : TD, rows, D, w_s, U, uu, rg, half,
                          a_s, fin);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = rg + kRG * (2 * half + i);
        if (!live || r >= rows) continue;
        const int b = b0 + r;
        const Gates q = cell(x[i][0], x[i][1], x[i][2], x[i][3], fin[i][0],
                             fin[i][1], fin[i][2], fin[i][3], cp[i], p0, p1,
                             p2);
        const float hn = m[i] * q.h + (1.f - m[i]) * hp[i];
        const float cn = m[i] * q.c + (1.f - m[i]) * cp[i];
        hs[b * TD + (size_t)t * D + u] = hn;
        cs[b * TD + (size_t)t * D + u] = cn;
        if (gates != nullptr) {
          float* g = a_s + r * (4 * U + 1) + uu;
          g[0] = q.i;
          g[U] = q.f;
          g[2 * U] = q.g;
          g[3 * U] = q.o;
        }
        if (s == T - 1) {
          hT[(size_t)b * D + u] = hn;
          cT[(size_t)b * D + u] = cn;
        }
      }
      if (gates != nullptr)
        store_gates<float, float>(a_s, gates, b0, rows, t, T, D, U);
    }
    grid.sync();
  }
}

// kThreads: the block's bound (ptxas gives a thread 65536 / kThreads
// registers: 128 at 512, 204 at 320, where the remat product's
// accumulators fit beside the step's other state)
template <bool kRemat, int S, int kThreads = 2 * kRG * kMaxUnits>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_kernel(const float* __restrict__ xw,
                const float* __restrict__ gates_in,
                const float* __restrict__ mask,
                const float* __restrict__ wpack,
                const float* __restrict__ peep, const float* h0,
                const float* c0, const float* hs, const float* cs,
                const float* __restrict__ dhs, const float* dhT,
                const float* dcT, float* dgates, float* dh, float* dc,
                float* dpeep, float* part, int B, int T, int D, int U,
                int reverse) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Plan plan(D, U, S);
  float* w_s = smem;                         // [D][U][4]
  float* a_s = smem + plan.a;                // staging, then the tiles:
  const int ldg = row_stride(U);
  float* dg_s = a_s;                         // [kRows][ldg]
  float* contrib = a_s + kRows * ldg;        // [3][2 kRG][U]
  const int half = threadIdx.x / (kRG * U), l = threadIdx.x % (kRG * U);
  const int rg = l % kRG, uu = l / kRG;
  const int rs = rg + kRG * half;            // this thread's contrib slot
  const int u0 = blockIdx.x * U, u = u0 + uu;
  const int nu = min(U, D - u0);
  const bool live = uu < nu;
  const int nblk = gridDim.x;
  const int B4 = (B + 3) & ~3;               // part's row stride
  load_slice(w_s, wpack, D, U);
  for (int e = threadIdx.x; e < B * nu; e += blockDim.x) {
    const size_t o = (size_t)(e / nu) * D + u0 + e % nu;
    dh[o] = dhT[o];
    dc[o] = dcT[o];
  }
  float p0 = 0.f, p1 = 0.f, p2 = 0.f;
  if (live) {
    p0 = peep[u];
    p1 = peep[D + u];
    p2 = peep[2 * D + u];
  }
  float dp_acc = 0.f;   // thread k * U + q owns dpeep[k][u0 + q]
  cg::grid_group grid = cg::this_grid();
  const size_t TD = (size_t)T * D, T4D = TD * 4;

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;   // computation order reversed
    const int tp = reverse ? t + 1 : t - 1;
    const bool first = reverse ? t == T - 1 : t == 0;
    float* P = part + (size_t)(s & 1) * nblk * D * B4;   // [nblk][D][B4]
    float dp_step = 0.f;
    __syncthreads();
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      // (A) the operands of rows rg + 16 (2 half + i), unit uu, fetched
      // while the remat product runs
      float x[2][4], m[2], dhv[2], dcv[2], cp[2], c[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = rg + kRG * (2 * half + i);
        if (!live || r >= rows) continue;
        const int b = b0 + r;
        const size_t bu = (size_t)b * D + u;
        const size_t bt = b * TD + (size_t)t * D + u;
        const float* xr = (kRemat ? xw : gates_in) + b * T4D
                          + (size_t)t * 4 * D;
#pragma unroll
        for (int g = 0; g < 4; ++g) x[i][g] = xr[g * D + u];
        m[i] = mask[(size_t)b * T + t];
        dhv[i] = dh[bu] + dhs[bt];
        dcv[i] = dc[bu];
        cp[i] = first ? __ldcg(c0 + bu)
                      : __ldcg(cs + b * TD + (size_t)tp * D + u);
        c[i] = __ldcg(cs + bt);
      }
      float fin[2][4];
      if (kRemat) {
        const float* a = first ? h0 + (size_t)b0 * D
                               : hs + b0 * TD + (size_t)tp * D;
        gemm_gates<S>(a, first ? D : TD, rows, D, w_s, U, uu, rg, half, a_s,
                      fin);
      }
      float cpart[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = rg + kRG * (2 * half + i);
        float4 dgv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live && r < rows) {
          const int b = b0 + r;
          const size_t bu = (size_t)b * D + u;
          float gi = x[i][0], gf = x[i][1], gg = x[i][2], go = x[i][3];
          if (kRemat) {
            const Gates q = cell(x[i][0], x[i][1], x[i][2], x[i][3],
                                 fin[i][0], fin[i][1], fin[i][2], fin[i][3],
                                 cp[i], p0, p1, p2);
            gi = q.i;
            gf = q.f;
            gg = q.g;
            go = q.o;
          }
          const float tc = tanhf(c[i]);
          const float d_o = dhv[i] * tc * go * (1.f - go) * m[i];
          const float dct = (dcv[i] + dhv[i] * go * (1.f - tc * tc)) * m[i]
                            + d_o * p2;
          const float d_i = dct * gg * gi * (1.f - gi);
          const float d_f = dct * cp[i] * gf * (1.f - gf);
          const float d_g = dct * gi * (1.f - gg * gg);
          float* dg = dgates + b * T4D + (size_t)t * 4 * D;
          dg[u] = d_i;
          dg[D + u] = d_f;
          dg[2 * D + u] = d_g;
          dg[3 * D + u] = d_o;
          cpart[0] += d_i * cp[i];
          cpart[1] += d_f * cp[i];
          cpart[2] += d_o * c[i];
          dh[bu] = (1.f - m[i]) * dhv[i];  // (B) adds the partials' sum
          dc[bu] = dct * gf + d_i * p0 + d_f * p1 + (1.f - m[i]) * dcv[i];
          dgv = make_float4(d_i, d_f, d_g, d_o);
        }
        *reinterpret_cast<float4*>(dg_s + r * ldg + uu * 4) = dgv;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
        contrib[(k * 2 * kRG + rs) * U + uu] = cpart[k];
      __syncthreads();
      if (threadIdx.x < 3 * U) {
        const int k = threadIdx.x / U, q = threadIdx.x % U;
        float sum = 0.f;
        for (int g = 0; g < 2 * kRG; ++g)
          sum += contrib[(k * 2 * kRG + g) * U + q];
        dp_step += sum;
      }
      // this block's share of dh_{t-1} (the product beside the threads
      // above reading contrib: it reads only dg_s and w_s)
      dh_share(dg_s, ldg, w_s, U, D, B4, rows,
               P + (size_t)blockIdx.x * D * B4 + b0);
      __syncthreads();   // dg_s and contrib are free for the next chunk
    }
    dp_acc += dp_step;
    grid.sync();
    // (B) dh_{t-1} of the own units: the blocks' partials summed, four
    // rows a 16-byte load (part's rows padded to B4).  Where the threads
    // outnumber the quads twice or more, the partials split into `groups`
    // ranges (at most 4), each summed in block order, then the ranges in
    // order; a round takes `per` quads.
    const int bq = B4 / 4, nq = nu * bq;
    const int groups = 2 * nq <= (int)blockDim.x
                           ? min(4, (int)blockDim.x / nq) : 1;
    const int span = (nblk + groups - 1) / groups;
    const int per = blockDim.x / groups;
    const int qi = threadIdx.x % per, grp = threadIdx.x / per;
    float4* gsum = reinterpret_cast<float4*>(a_s);   // [groups][per]
    for (int q0 = 0; q0 < nq; q0 += per) {
      const int q = q0 + qi;
      if (grp < groups && q < nq) {
        const float4* src = reinterpret_cast<const float4*>(
            P + (size_t)(u0 + q / bq) * B4 + 4 * (q % bq));
        const int k1 = min(nblk, (grp + 1) * span);
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
        for (int k = grp * span; k < k1; ++k) {
          const float4 v = __ldcg(src + (size_t)k * (D * B4 / 4));
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
        }
        gsum[grp * per + qi] = sum;
      }
      __syncthreads();
      if (grp == 0 && q < nq) {
        float4 sum = gsum[qi];
        for (int r = 1; r < groups; ++r) {
          const float4 v = gsum[r * per + qi];
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
        }
        const float s4[4] = {sum.x, sum.y, sum.z, sum.w};
        const int b = 4 * (q % bq);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const size_t bu = (size_t)(b + v) * D + u0 + q / bq;
          if (b + v < B) dh[bu] = s4[v] + dh[bu];
        }
      }
      __syncthreads();   // gsum is free for the next round
    }
  }
  if (threadIdx.x < 3 * U) {
    const int k = threadIdx.x / U, q = threadIdx.x % U;
    if (q < nu) dpeep[(size_t)k * D + u0 + q] = dp_acc;
  }
}

// Stages of the A pipeline: three when they fit beside K rows of weight
// slices, else two; 0 when even two do not fit.
int stages_for(int K, int U) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  for (int s = 3; s >= 2; --s)
    if (sizeof(float) * (size_t)Plan(K, U, s).total <= (size_t)optin)
      return s;
  return 0;
}

template <typename Kern>
int cooperative(Kern kernel, int grid, int threads, size_t smem, void** args,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  if ((long long)per_sm * sms < grid)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel((const void*)kernel, grid, threads, args,
                                    smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool valid_shape(int B, int T, int D, int U) {
  return B > 0 && T > 0 && D > 0 && D % 4 == 0 && U > 0 && U <= kMaxUnits;
}

template <bool kFi>
int launch_fwd(const float* in, const float* mask, const float* wxpack,
               const float* bias, const float* wpack, const float* peep,
               const float* h0, const float* c0, float* hs, float* cs,
               float* gates, float* hT, float* cT, int B, int T, int E,
               int D, int U, int reverse, void* stream) {
  const int K = kFi ? E + D : D;
  const int stages = stages_for(K, U);
  if (stages == 0) return (int)cudaErrorInvalidValue;
  const int grid = (D + U - 1) / U;
  const size_t smem = sizeof(float) * Plan(K, U, stages).total;
  void* args[] = {&in, &mask, &wxpack, &bias, &wpack, &peep, &h0, &c0, &hs,
                  &cs, &gates, &hT, &cT, &B, &T, &E, &D, &U, &reverse};
  cudaStream_t st = (cudaStream_t)stream;
  // 32U threads run the cells; the product wants 8 warps (the row walk)
  // or 2 ceil(U / 2) (the column walk)
  const int n = 32 * max(U, U < kColumnsFrom ? kRowJobs : 2 * ((U + 1) / 2));
  if (n <= kNarrow)
    return stages == 3
        ? cooperative(lstm_fwd_kernel<kFi, 3, kNarrow>, grid, n, smem, args,
                      st)
        : cooperative(lstm_fwd_kernel<kFi, 2, kNarrow>, grid, n, smem, args,
                      st);
  return stages == 3
      ? cooperative(lstm_fwd_kernel<kFi, 3>, grid, n, smem, args, st)
      : cooperative(lstm_fwd_kernel<kFi, 2>, grid, n, smem, args, st);
}

}  // namespace

// The grid: ceil(D / U) blocks of 32U threads; wpack [blocks][D][U][4].
extern "C" int lstm_fwd_f32(const float* xw, const float* mask,
                            const float* wpack, const float* peep,
                            const float* h0, const float* c0, float* hs,
                            float* cs, float* gates, float* hT, float* cT,
                            int B, int T, int D, int U, int reverse,
                            void* stream) {
  if (!valid_shape(B, T, D, U)) return (int)cudaErrorInvalidValue;
  return launch_fwd<false>(xw, mask, nullptr, nullptr, wpack, peep, h0, c0,
                           hs, cs, gates, hT, cT, B, T, 0, D, U, reverse,
                           stream);
}

// The fused-input forward: x [B, T, E] (E % 4 == 0), wxpack
// [blocks][E][U][4] the column slices of W_x, bias [4D]; the rest as
// lstm_fwd_f32.
extern "C" int lstm_fi_fwd_f32(const float* x, const float* mask,
                               const float* wxpack, const float* bias,
                               const float* wpack, const float* peep,
                               const float* h0, const float* c0, float* hs,
                               float* cs, float* gates, float* hT, float* cT,
                               int B, int T, int E, int D, int U,
                               int reverse, void* stream) {
  if (!valid_shape(B, T, D, U) || E <= 0 || E % 4 != 0)
    return (int)cudaErrorInvalidValue;
  return launch_fwd<true>(x, mask, wxpack, bias, wpack, peep, h0, c0, hs,
                          cs, gates, hT, cT, B, T, E, D, U, reverse, stream);
}

// remat != 0: gates recomputed from xw and the shifted h/c stacks
// (gates_in unused); remat == 0: gates_in is the forward's slab (xw
// unused).  part is scratch of 2 * blocks * D * B4 floats, B4 = B rounded
// up to a multiple of 4.
extern "C" int lstm_bwd_f32(const float* xw, const float* gates_in,
                            const float* mask, const float* wpack,
                            const float* peep, const float* h0,
                            const float* c0, const float* hs, const float* cs,
                            const float* dhs, const float* dhT,
                            const float* dcT, float* dgates, float* dh,
                            float* dc, float* dpeep, float* part, int B,
                            int T, int D, int U, int reverse, int remat,
                            void* stream) {
  if (!valid_shape(B, T, D, U)) return (int)cudaErrorInvalidValue;
  const int stages = stages_for(D, U);
  if (stages == 0) return (int)cudaErrorInvalidValue;
  const int grid = (D + U - 1) / U;
  const size_t smem = sizeof(float) * Plan(D, U, stages).total;
  void* args[] = {&xw, &gates_in, &mask, &wpack, &peep, &h0, &c0, &hs, &cs,
                  &dhs, &dhT, &dcT, &dgates, &dh, &dc, &dpeep, &part,
                  &B, &T, &D, &U, &reverse};
  cudaStream_t st = (cudaStream_t)stream;
  const int n = 2 * kRG * U;
  if (remat && n <= kNarrow)
    return stages == 3
        ? cooperative(lstm_bwd_kernel<true, 3, kNarrow>, grid, n, smem, args,
                      st)
        : cooperative(lstm_bwd_kernel<true, 2, kNarrow>, grid, n, smem, args,
                      st);
  if (remat)
    return stages == 3
        ? cooperative(lstm_bwd_kernel<true, 3>, grid, n, smem, args, st)
        : cooperative(lstm_bwd_kernel<true, 2>, grid, n, smem, args, st);
  return stages == 3
      ? cooperative(lstm_bwd_kernel<false, 3>, grid, n, smem, args, st)
      : cooperative(lstm_bwd_kernel<false, 2>, grid, n, smem, args, st);
}

// ---------------------------------------------------------------------------
// The bf16 forms: lstm_fwd_bf16 and lstm_bwd_bf16 (remat or stored gates,
// one template flag as in f32; xw in bf16 or f32, a template on its
// element type).  The same cooperative, persistent design as above, with
// the recurrent products on the tensor cores (mma.sync.m16n8k16 of
// mma_bf16.cuh, f32 accumulators) and the rounding points of the JAX
// kernels with bf16 operands (lstm.py:94-132, _fwd_call :212, _bwd_kernel
// :147, _bwd_remat_kernel :355): the cell in f32 from registers, the h
// carry rounded to bf16 (hs is the carry the next step reads, so the
// freeze keeps the rounded value), cs, h_T and c_T in f32 (h_T unrounded),
// the gates slab in bf16; backward: the dh and dc carries in f32, the
// remat gates rounded through bf16, dh_{t-1} from dgates rounded to bf16,
// dgates, dpeep, dh0 and dc0 out in f32.
//
// Plan (PlanFwdBf16, PlanBwdBf16, SplitBf16; ops/kernels/lstm.py's
// _bf16_fwd_bytes, _bf16_bwd_bytes and _bf16_split mirror them).  A block
// owns an even number U of units (ceil(D / SMs) rounded up: D 1280 on 132
// SMs gives U 10, 128 blocks; D 64 gives U 2, 32 blocks), so its 4U gate
// columns, packed [U][4] (a unit's four gates side by side), are U / 2
// whole n8 tiles of two units each.  It keeps W_h's slice transposed,
// [4U][LDK] bf16: row 4 uu + g, the reduction (D) contiguous, columns
// past D zero up to a multiple of 16 plus 8 (an odd count of 16-byte
// groups: the 8 rows an ldmatrix phase reads fall in distinct banks).  At
// D 1280, U 10: 103,040 bytes.  The h rows stream through a ring of
// slices (cp.async.cg, L2): 64 x 128 in the forward, as many stages as fit
// up to 3; 64 x 64 in the remat backward, whose block also holds its part
// of W_h for the dh product.  Eight warps: warp w takes row tile w % 4 (16
// of a 64-row chunk) and every other 16-deep step of the reduction (w /
// 4); the second half's sums go through shared memory and the first half
// adds them, in that order, so a rerun gives the same bits (and the
// ring's depth does not move them).
//
// The cell from the accumulators.  In an m16n8 accumulator the lane with
// lane % 4 = q holds columns 2q, 2q + 1 of rows g and g + 8 (g = lane / 4):
// lanes q = 0, 1 hold unit 2j's (i, f) and (g, o), lanes 2, 3 unit 2j + 1's.
// One __shfl_xor_sync(..., 1) swaps halves: the even lane keeps row g and
// takes its partner's (g, o) of that row, the odd lane keeps row g + 8 and
// takes its partner's (i, f).  Each lane then runs the cell of one (row,
// unit) a tile, in f32, from registers.
//
// Backward, reverse time, per step: (A) the gates (recomputed by the
// forward's product and cell, rounded through bf16, or read from the
// slab), the cotangents in f32 from dh = carry + dhs[t] and the dc carry,
// dgates written in f32 and, rounded to bf16, to an exchange X [B][4D]
// (column 4 u + g).  Grid barrier.  (B) dh_{t-1} = X W_h^T, the JAX
// kernel's single dot over the rounded dgates (lstm.py:196-197,
// :410-411), in two passes with f32 sums: (B1) the blocks in groups of up
// to 8, each block of a group taking an eighth of X's columns for every
// unit of the group against its part of W_h (kept in shared memory where
// it fits: 107,520 bytes at D 1280), its partial sums to scratch; grid
// barrier; (B2) each block adds the group's partials of its own units in
// block order.  At B 64, D 1280 a block reads 82 KB of X and writes and
// reads 20 KB of partials a step, against the 42 MB of f32 shares of
// dh_{t-1} a step all blocks exchanged before (on an H100 80GB HBM3 at
// 700 W that design's product and sum took 7.3 of its 9.4 ms), or 655 KB
// of X a block with W_h's rows through L2 for one pass (3.2 ms of 6.6 on
// the same card).  No atomics, so reruns are
// bit-identical, and both forms run the same passes on the same bits.
//
// What bounds them on an H100: the step-to-step chain.  At B 64, D 1280 a
// step's product is 0.84 GFLOP (0.85 us at 989 TFLOP/s) but every block
// reads all of h_{t-1} (160 KB) through L2 each step, and the backward
// adds two grid barriers a step around the dh product's passes.
//
// The fused-input form, lstm_fi_fwd_bf16 (lstm.py::lstm_seq_fi's
// _fwd_fi_kernel with bf16 operands): the forward above, one template
// flag, with the block's slice of W_x packed as W_h's ([4U][LDK(E)], at
// E 128, U 4: 4,352 bytes) in shared memory before W_h's.  Each step first
// stages the x_t rows of the chunk through the same ring and takes x_t W_x
// with the same product and gate gather, adds the f32 bias and keeps the
// sum in f32, never rounded (lstm.py:633-635); then h_{t-1} W_h is added
// as the forward over xw adds it: two f32 sums, (x_t W_x + b) + h W_h, in
// the JAX kernel's order.  The backward is lstm_bwd_bf16 with remat over
// the f32 projection xw = x W_x + b of one torch.matmul (the wrapper's
// autograd Function), as the JAX package's backward runs it.  At B 64, T
// 100, E 128, D 512 a step's products are 168 MFLOP, the [B, T, 4D] xw
// slab (26 MB in f32) is neither written nor read by the forward.

namespace {

using bf16 = __nv_bfloat16;
namespace tc = bf16_tc;

constexpr int kWarpsB = 8;                // 4 row tiles x 2 halves of K
constexpr int kThreadsB = 32 * kWarpsB;
constexpr int kKCF = 128;                 // the forward's slices of h: k
constexpr int kKCB = 64;                  // the remat backward's
constexpr int kMaxNT = kMaxUnits / 2;     // n8 tiles of a block's columns
constexpr int kChunkK = 32;               // k of a dh product's chunk
constexpr int kGroupK = 8;                // blocks that split X's k, at most
constexpr int kAheadFromU = 8;            // the forward loads fragments ahead
constexpr int kMaxMT = kGroupK * kMaxUnits / 16;  // m16 tiles of a group

// bf16 elements of a staged slice of kRows rows, KC deep (rows padded by
// 8: an odd count of 16-byte groups, conflict-free ldmatrix)
__host__ __device__ constexpr int stage_elems(int KC) {
  return kRows * (KC + 8);
}
__host__ __device__ inline int ld_k(int D) { return 16 * ((D + 15) / 16) + 8; }
__host__ __device__ inline size_t max_sz(size_t a, size_t b) {
  return a > b ? a : b;
}

// The backward's dh product in two passes: the grid's blocks in groups of
// P (the largest divisor of the grid up to kGroupK), block kk of a group
// taking X's chunks [kk nch / P, (kk + 1) nch / P) of nch = 4D / kChunkK
// for the group's MP = P U units.  Its part of W_h is [MP][LDP] bf16: row
// m, column k - its first chunk's k = W_h[group's first unit + m][...] in
// X's column order, zero past D and past its chunks; LDP = KR rounded up
// to 64, + 32 (rows 64 bytes apart mod 128: the 16-byte loads of two rows
// fall in distinct banks).
struct SplitBf16 {
  int P, MP, KR, LDP;
  __host__ __device__ SplitBf16(int D, int U, int grid) {
    P = 1;
    for (int p = kGroupK; p > 1; --p)
      if (grid % p == 0) {
        P = p;
        break;
      }
    MP = P * U;
    const int nch = 4 * D / kChunkK;
    KR = kChunkK * ((nch + P - 1) / P);
    LDP = 64 * ((KR + 63) / 64) + 32;
  }
  __host__ __device__ size_t part_bytes() const {
    return (size_t)MP * LDP * 2;
  }
};

// bytes of a forward block: W_x's slice [4U][LDK(E)] (the fused-input
// form), W_h's [4U][LDK(D)], then the ring of `stages` slices
// [kRows][kKCF + 8] or the halves' f32 sums [kRows][4U]
struct PlanFwdBf16 {
  size_t wx, w, total;
  __host__ __device__ PlanFwdBf16(int D, int U, int stages, int E) {
    wx = E > 0 ? (size_t)4 * U * ld_k(E) * 2 : 0;
    w = wx + (size_t)4 * U * ld_k(D) * 2;
    total = w + max_sz((size_t)stages * stage_elems(kKCF) * 2,
                       (size_t)kRows * 4 * U * 4);
  }
};

// bytes of a backward block: W_h's column slice [4U][LDK(D)] (remat), the
// region (the remat ring of `stages` slices [kRows][kKCB + 8], or the
// halves' f32 sums [kRows][4U] and the dpeep terms [3][kRows][U] after
// them), then the block's part of W_h where `part` (else read where it
// lies)
struct PlanBwdBf16 {
  size_t region, wp, total;
  __host__ __device__ PlanBwdBf16(int D, int U, int stages, bool remat,
                                  bool part, int grid) {
    region = remat ? (size_t)4 * U * ld_k(D) * 2 : 0;
    wp = region + max_sz(remat ? (size_t)stages * stage_elems(kKCB) * 2 : 0,
                         (size_t)kRows * 4 * U * 4 +
                             (size_t)3 * kRows * U * 4);
    total = wp + (part ? SplitBf16(D, U, grid).part_bytes() : 0);
  }
};

__device__ __forceinline__ float b2f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float rnd(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
// a bf16 another block wrote in this launch, read through L2
__device__ __forceinline__ float ldcg_bf(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ void load_slice_bf16(bf16* w_s, const bf16* wpack,
                                                size_t elems) {
  const uint4* src = reinterpret_cast<const uint4*>(
      wpack + (size_t)blockIdx.x * elems);
  uint4* dst = reinterpret_cast<uint4*>(w_s);
  for (size_t e = threadIdx.x; e < elems / 8; e += blockDim.x) dst[e] = src[e];
}

// Stage slice c of A (rows [0, rows) at a + r * lda, columns c KC ..
// c KC + KC - 1, zero past rows and K) into buf [kRows][KC + 8].
template <int KC>
__device__ __forceinline__ void load_slice_a(bf16* buf, const bf16* a,
                                             size_t lda, int rows, int K,
                                             int c) {
  for (int p = threadIdx.x; p < kRows * (KC / 8); p += kThreadsB) {
    const int r = p / (KC / 8), q = p % (KC / 8);
    const int k = c * KC + 8 * q;
    const bool ok = r < rows && k < K;
    tc::cp_async16(buf + r * (KC + 8) + 8 * q, ok ? a + r * lda + k : a, ok);
  }
}

// acc[j] = the m16n8 tile (row tile warp % 4, columns 8j..8j+7 of the
// block's 4U) of A [rows x K] . W, over this warp's half of the 16-deep
// steps (warp / 4: every other step), A staged through a ring of S slices
// KC deep.  The half takes the same steps in the same order whatever KC
// (every other one of all K / 16), so KC and S do not move the sums.
// kAhead: each step's fragments are all loaded before its MMAs and the
// next step's while they run (the ldmatrix and mma asm keep their order,
// so the order in the source is the schedule); it costs 40 registers, so
// only the forward over xw takes it, from U 8.  Either schedule runs the
// same MMAs in the same order.  Every thread of the block calls it.
template <int S, int KC, bool kAhead>
__device__ __forceinline__ void product_bf16(const bf16* a, size_t lda,
                                             int rows, int K, const bf16* w_s,
                                             int LDK, int NT, bf16* a_s,
                                             float (&acc)[kMaxNT][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mi = warp & 3, kh = warp >> 2;
#pragma unroll
  for (int j = 0; j < kMaxNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  constexpr int kStage = stage_elems(KC);
  const int nc = (K + KC - 1) / KC;
#pragma unroll
  for (int c = 0; c < S - 1; ++c) {
    if (c < nc) load_slice_a<KC>(a_s + c * kStage, a, lda, rows, K, c);
    tc::cp_async_commit();
  }
  for (int c = 0; c < nc; ++c) {
    tc::cp_async_wait<S - 2>();
    __syncthreads();   // slice c landed; slice c - 1 read by every warp
    const int cn = c + S - 1;
    if (cn < nc) load_slice_a<KC>(a_s + (cn % S) * kStage, a, lda, rows, K, cn);
    tc::cp_async_commit();
    const bf16* buf = a_s + (c % S) * kStage;
    const int nks = (min(KC, K - c * KC) + 15) / 16;
    if (!kAhead) {
      for (int ks = kh; ks < nks; ks += 2) {
        uint32_t af[4];
        tc::ldmatrix_x4(af, buf + (16 * mi + (lane & 15)) * (KC + 8) +
                                16 * ks + 8 * (lane >> 4));
        const int k0 = c * KC + 16 * ks;
#pragma unroll
        for (int j = 0; j < kMaxNT; ++j) {
          if (j >= NT) break;
          uint32_t b[2];
          tc::ldmatrix_x2(b, w_s + (size_t)(8 * j + (lane & 7)) * LDK + k0 +
                                 8 * ((lane >> 3) & 1));
          tc::mma_bf16(acc[j], af, b[0], b[1]);
        }
      }
      continue;
    }
    // a step's fragments: A the row tile's 16 x 16, B every n8 tile's
    auto frags = [&](int ks, uint32_t (&af)[4], uint32_t (&bf)[kMaxNT][2]) {
      tc::ldmatrix_x4(af, buf + (16 * mi + (lane & 15)) * (KC + 8) +
                              16 * ks + 8 * (lane >> 4));
      const bf16* wk = w_s + (size_t)(lane & 7) * LDK + c * KC + 16 * ks +
                       8 * ((lane >> 3) & 1);
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j)
        if (j < NT) tc::ldmatrix_x2(bf[j], wk + (size_t)8 * j * LDK);
    };
    auto mmas = [&](const uint32_t (&af)[4],
                    const uint32_t (&bf)[kMaxNT][2]) {
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j)
        if (j < NT) tc::mma_bf16(acc[j], af, bf[j][0], bf[j][1]);
    };
    uint32_t a0[4], b0[kMaxNT][2], a1[4], b1[kMaxNT][2];
    int ks = kh;
    if (ks < nks) frags(ks, a0, b0);
    for (; ks < nks; ks += 4) {
      if (ks + 2 < nks) frags(ks + 2, a1, b1);
      mmas(a0, b0);
      if (ks + 2 >= nks) break;
      if (ks + 4 < nks) frags(ks + 4, a0, b0);
      mmas(a1, b1);
    }
  }
  __syncthreads();       // every slice read: the ring is free
}

// The halves' sums added (first half + second), then each lane of a
// first-half warp gets, in place of its accumulators of tile j, the four
// gate products of its cell there: row 16 (warp % 4) + lane / 4 + 8 (lane
// % 2), unit 2j + (lane / 2) % 2.
__device__ __forceinline__ void gather_gates(float* sums, int NT,
                                             float (&acc)[kMaxNT][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mi = warp & 3, kh = warp >> 2;
  if (kh == 1) {
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j) {
      if (j >= NT) break;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sums[((mi * NT + j) * 4 + e) * 32 + lane] = acc[j][e];
    }
  }
  __syncthreads();
  if (kh == 1) return;
  const bool odd = lane & 1;
#pragma unroll
  for (int j = 0; j < kMaxNT; ++j) {
    if (j >= NT) break;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = acc[j][e] + sums[((mi * NT + j) * 4 + e) * 32 + lane];
    // the even lane sends its row g + 8's (i, f), the odd one its row g's
    // (g, o)
    const float s0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
    const float s1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
    acc[j][0] = odd ? s0 : v[0];
    acc[j][1] = odd ? s1 : v[1];
    acc[j][2] = odd ? v[2] : s0;
    acc[j][3] = odd ? v[3] : s1;
  }
}

// kFi: `in` is raw x [B, T, E] bf16 and the block keeps W_x's slice
// (wxpack, [4U][LDK(E)], packed as W_h's) before W_h's; each step's gate
// input is x_t W_x with f32 sums plus the f32 bias, kept in f32 and never
// rounded (lstm.py:633-635), and then h_{t-1} W_h is added as the forward
// over xw adds it.  Otherwise `in` is xw [B, T, 4D] bf16 (E, wxpack and
// bias unused).
template <bool kFi, int S, bool kAhead>
__global__ void __launch_bounds__(kThreadsB, 1)
lstm_fwd_bf16_kernel(const bf16* __restrict__ in,
                     const float* __restrict__ mask,
                     const bf16* __restrict__ wxpack,
                     const float* __restrict__ bias,
                     const bf16* __restrict__ wpack,
                     const bf16* __restrict__ peep, const bf16* h0,
                     const float* c0, bf16* hs, float* cs, bf16* gates,
                     float* hT, float* cT, int B, int T, int E, int D, int U,
                     int reverse) {
  extern __shared__ float4 smem4[];
  const PlanFwdBf16 plan(D, U, S, kFi ? E : 0);
  char* base = reinterpret_cast<char*>(smem4);
  bf16* wx_s = reinterpret_cast<bf16*>(base);             // kFi
  bf16* w_s = reinterpret_cast<bf16*>(base + plan.wx);
  bf16* a_s = reinterpret_cast<bf16*>(base + plan.w);
  float* sums = reinterpret_cast<float*>(base + plan.w);
  // the gates tile [kRows][4U + 2] (remat off) after the sums, in the ring
  // (at least two stages: room for both)
  bf16* tile = reinterpret_cast<bf16*>(sums + kRows * 4 * U);
  const int LDK = ld_k(D), LDE = kFi ? ld_k(E) : 0, NT = U / 2;
  const int lane = threadIdx.x & 31;
  const bool first_half = (threadIdx.x >> 5) < 4;
  const int rl = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2) + 8 * (lane & 1);
  const int u0 = blockIdx.x * U + ((lane >> 1) & 1);  // + 2j in tile j
  if (kFi) load_slice_bf16(wx_s, wxpack, (size_t)4 * U * LDE);
  load_slice_bf16(w_s, wpack, (size_t)4 * U * LDK);
  float pp[kMaxNT][3];
#pragma unroll
  for (int j = 0; j < kMaxNT; ++j) {
    const int u = u0 + 2 * j;
    const bool live = j < NT && u < D;
#pragma unroll
    for (int k = 0; k < 3; ++k) pp[j][k] = live ? b2f(peep[k * D + u]) : 0.f;
  }
  cg::grid_group grid = cg::this_grid();
  const size_t TD = (size_t)T * D, T4D = TD * 4, TE = (size_t)T * E;

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      const int b = b0 + rl;
      const bool rok = first_half && rl < rows;
      // the cell's other operands, fetched while the product runs
      float x[kMaxNT][4], hp[kMaxNT], cp[kMaxNT];
      const float m = rok ? mask[(size_t)b * T + t] : 0.f;
      if (kFi) {
        // x_t W_x over the own columns, then + b: the f32 gate input
        product_bf16<S, kKCF, false>(in + b0 * TE + (size_t)t * E, TE, rows,
                                     E, wx_s, LDE, NT, a_s, x);
        gather_gates(sums, NT, x);
        __syncthreads();   // the sums are read: the ring may be refilled
      }
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) {
        const int u = u0 + 2 * j;
        if (!rok || j >= NT || u >= D) continue;
        if (kFi) {
#pragma unroll
          for (int g = 0; g < 4; ++g) x[j][g] += __ldg(bias + g * D + u);
        } else {
          const bf16* xr = in + b * T4D + (size_t)t * 4 * D;
#pragma unroll
          for (int g = 0; g < 4; ++g) x[j][g] = b2f(xr[g * D + u]);
        }
        const size_t bu = (size_t)b * D + u;
        hp[j] = s == 0 ? ldcg_bf(h0 + bu)
                       : ldcg_bf(hs + b * TD + (size_t)tp * D + u);
        cp[j] = s == 0 ? __ldcg(c0 + bu)
                       : __ldcg(cs + b * TD + (size_t)tp * D + u);
      }
      float pre[kMaxNT][4];
      const bf16* a = s == 0 ? h0 + (size_t)b0 * D
                             : hs + b0 * TD + (size_t)tp * D;
      product_bf16<S, kKCF, kAhead>(a, s == 0 ? D : TD, rows, D, w_s, LDK,
                                    NT, a_s, pre);
      gather_gates(sums, NT, pre);
      if (first_half) {
#pragma unroll
        for (int j = 0; j < kMaxNT; ++j) {
          const int u = u0 + 2 * j;
          if (!rok || j >= NT || u >= D) continue;
          const Gates q = cell(x[j][0], x[j][1], x[j][2], x[j][3], pre[j][0],
                               pre[j][1], pre[j][2], pre[j][3], cp[j],
                               pp[j][0], pp[j][1], pp[j][2]);
          const float hn = m * q.h + (1.f - m) * hp[j];
          const float cn = m * q.c + (1.f - m) * cp[j];
          const size_t o = b * TD + (size_t)t * D + u;
          hs[o] = __float2bfloat16_rn(hn);
          cs[o] = cn;
          if (gates != nullptr) {
            bf16* g = tile + rl * (4 * U + 2) + u - blockIdx.x * U;
            g[0] = __float2bfloat16_rn(q.i);
            g[U] = __float2bfloat16_rn(q.f);
            g[2 * U] = __float2bfloat16_rn(q.g);
            g[3 * U] = __float2bfloat16_rn(q.o);
          }
          if (s == T - 1) {
            hT[(size_t)b * D + u] = hn;
            cT[(size_t)b * D + u] = cn;
          }
        }
      }
      if (gates != nullptr)
        store_gates<bf16, __nv_bfloat162>(tile, gates, b0, rows, t, T, D, U);
      __syncthreads();   // the sums and the ring are free for the next chunk
    }
    grid.sync();
  }
}

// (B1) of the backward, the first pass of dh_{t-1}: this block's part of
// the product over its chunks of X for every unit of its group, the rows
// [b0, b0 + kRows), as m16n8k16 tiles D^T[m][b] = sum over its k of
// wp[m][k] X[b][k]: A the block's part of W_h (wp, in shared memory or
// where it lies), B the step's dgates rounded to bf16 (X[b][4 u + g],
// written by every block before the grid barrier, read through L2).  A
// lane's 16-byte load of a row covers 8 of a chunk's 32 k (kChunkK): its
// registers .x .y feed one MMA and .z .w the next, the same for A and B,
// so each MMA sums 16 of the chunk's k (permuted, none skipped).  Warp w
// takes the n8 tile of rows b0 + 8w .. + 7 and every m16 tile of the
// group's units, its chunks in order, four chunks' loads of X in flight
// while the four before are multiplied.  Writes pp [MP][BP] f32 (rows of
// the group's units past `nmu` not written).
__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void dh_part(const bf16* X, const bf16* wp,
                                        const SplitBf16& sp, int D, int B,
                                        int BP, int b0, int nmu, float* pp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int K4 = 4 * D, nch = K4 / kChunkK, kk = blockIdx.x % sp.P;
  const int c0 = kk * nch / sp.P, c1 = (kk + 1) * nch / sp.P;
  const int b = b0 + 8 * warp + g;          // this lane's row of X
  const int MT = (nmu + 15) / 16;
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  float acc[kMaxMT][4];
#pragma unroll
  for (int mt = 0; mt < kMaxMT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
  const bf16* xr = X + (size_t)b * K4 + 8 * q;
  auto load = [&](uint4 (&x)[4], int c) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = c + i < c1 && b < B
                 ? __ldcg(reinterpret_cast<const uint4*>(
                       xr + (size_t)(c + i) * kChunkK))
                 : z;
  };
  auto multiply = [&](const uint4 (&x)[4], int c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (c + i >= c1) break;
      const bf16* wk = wp + (c + i - c0) * kChunkK + 8 * q;
#pragma unroll
      for (int mt = 0; mt < kMaxMT; ++mt) {
        if (mt >= MT) break;
        const int m = 16 * mt + g;
        const uint4 w0 = m < nmu ? ld16(wk + (size_t)m * sp.LDP) : z;
        const uint4 w1 = m + 8 < nmu ? ld16(wk + (size_t)(m + 8) * sp.LDP) : z;
        const uint32_t a0[4] = {w0.x, w1.x, w0.y, w1.y};
        const uint32_t a1[4] = {w0.z, w1.z, w0.w, w1.w};
        tc::mma_bf16(acc[mt], a0, x[i].x, x[i].y);
        tc::mma_bf16(acc[mt], a1, x[i].z, x[i].w);
      }
    }
  };
  uint4 xa[4], xb[4];
  load(xa, c0);
  for (int c = c0; c < c1; c += 8) {
    load(xb, c + 4);
    multiply(xa, c);
    if (c + 4 >= c1) break;
    load(xa, c + 8);
    multiply(xb, c + 4);
  }
  const int r = b0 + 8 * warp + 2 * q;
#pragma unroll
  for (int mt = 0; mt < kMaxMT; ++mt) {
    if (mt >= MT) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * mt + g + 8 * h;
      if (m < nmu)
        *reinterpret_cast<float2*>(pp + (size_t)m * BP + r) =
            make_float2(acc[mt][2 * h], acc[mt][2 * h + 1]);
    }
  }
}

// (B2), the second pass: dh_{t-1} of the own units (the group's rows kk U
// + m, m < nu) summed over the P parts of the group in block order, four
// rows a 16-byte load, then added to the carry's (1 - m) dh term.  No
// atomics: a rerun gives the same bits, and the remat and stored forms
// run the same passes on the same rounded dgates.
__device__ __forceinline__ void dh_sum(const float* pp, const SplitBf16& sp,
                                       int D, int B, int BP, int U, int nu,
                                       int u0, float* dh) {
  const int kk = blockIdx.x % sp.P, g0 = blockIdx.x - kk;
  const int nq = (B + 3) / 4;
  for (int e = threadIdx.x; e < nu * nq; e += kThreadsB) {
    const int m = e / nq, b = 4 * (e % nq);
    const float4* src = reinterpret_cast<const float4*>(
        pp + ((size_t)g0 * sp.MP + kk * U + m) * BP + b);
    float4 sum = __ldcg(src);
    for (int j = 1; j < sp.P; ++j) {
      const float4 v = __ldcg(src + (size_t)j * sp.MP * BP / 4);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const float s4[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      if (b + v >= B) break;
      const size_t bu = (size_t)(b + v) * D + u0 + m;
      dh[bu] = s4[v] + dh[bu];
    }
  }
}

template <bool kRemat, typename XT, int S>
__global__ void __launch_bounds__(kThreadsB, 1)
lstm_bwd_bf16_kernel(const XT* __restrict__ xw,
                     const bf16* __restrict__ gates_in,
                     const float* __restrict__ mask,
                     const bf16* __restrict__ wpack,
                     const bf16* __restrict__ w_h, bf16* wparts,
                     const bf16* __restrict__ peep, const bf16* h0,
                     const float* c0, const bf16* hs, const float* cs,
                     const bf16* __restrict__ dhs, const float* dhT,
                     const float* dcT, float* dgates, float* dh, float* dc,
                     float* dpeep, bf16* X, float* part, int B, int T,
                     int D, int U, int reverse, int part_smem) {
  extern __shared__ float4 smem4[];
  const PlanBwdBf16 plan(D, U, S, kRemat, part_smem, gridDim.x);
  const SplitBf16 sp(D, U, gridDim.x);
  const int LDK = ld_k(D), NT = U / 2;
  char* base = reinterpret_cast<char*>(smem4);
  bf16* w_s = reinterpret_cast<bf16*>(base);
  bf16* a_s = reinterpret_cast<bf16*>(base + plan.region);
  float* sums = reinterpret_cast<float*>(base + plan.region);
  float* contrib = sums + kRows * 4 * U;                  // [3][kRows][U]
  const bf16* wp = part_smem ? reinterpret_cast<const bf16*>(base + plan.wp)
                             : wparts + (size_t)blockIdx.x * sp.MP * sp.LDP;
  const int lane = threadIdx.x & 31;
  const bool first_half = (threadIdx.x >> 5) < 4;
  const int rl = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2) + 8 * (lane & 1);
  const int uin = (lane >> 1) & 1;             // unit 2j + uin of tile j
  const int u0 = blockIdx.x * U;
  const int nu = min(U, D - u0);
  // the group's units below D, and pp's row stride
  const int nmu = min(sp.MP, D - (int)(blockIdx.x - blockIdx.x % sp.P) * U);
  const int BP = kRows * ((B + kRows - 1) / kRows);
  float* ppb = part + (size_t)blockIdx.x * sp.MP * BP;
  if (kRemat) load_slice_bf16(w_s, wpack, (size_t)4 * U * LDK);
  {
    // this block's part of W_h for the dh product, built from W_h [D][4D]
    // (w_h) where it will be read: row m, column 4 ul + g = W_h[g0 U +
    // m][g D + u of X's chunks from c0]; past its chunks and past D zero
    const int kk = blockIdx.x % sp.P, g0 = blockIdx.x - kk;
    const int nch = 4 * D / kChunkK;
    const int c0 = kk * nch / sp.P, c1 = (kk + 1) * nch / sp.P;
    const int uw = sp.KR / 4, ul1 = (c1 - c0) * kChunkK / 4;
    bf16* dst = const_cast<bf16*>(wp);
    for (int e = threadIdx.x; e < sp.MP * sp.KR; e += kThreadsB) {
      const int ul = e % uw, g = (e / uw) % 4, m = e / sp.KR;
      const int row = g0 * U + m;
      dst[(size_t)m * sp.LDP + 4 * ul + g] =
          ul < ul1 && row < D
              ? w_h[(size_t)row * 4 * D + (size_t)g * D + c0 * kChunkK / 4 +
                    ul]
              : __float2bfloat16_rn(0.f);
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < B * nu; e += kThreadsB) {
    const size_t o = (size_t)(e / nu) * D + u0 + e % nu;
    dh[o] = dhT[o];
    dc[o] = dcT[o];
  }
  float pp[kMaxNT][3];
#pragma unroll
  for (int j = 0; j < kMaxNT; ++j) {
    const int u = u0 + 2 * j + uin;
    const bool live = j < NT && u < D;
#pragma unroll
    for (int k = 0; k < 3; ++k) pp[j][k] = live ? b2f(peep[k * D + u]) : 0.f;
  }
  float dp_acc = 0.f;   // thread k U + q owns dpeep[k][u0 + q]
  cg::grid_group grid = cg::this_grid();
  const size_t TD = (size_t)T * D, T4D = TD * 4;

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;   // computation order reversed
    const int tp = reverse ? t + 1 : t - 1;
    const bool first = reverse ? t == T - 1 : t == 0;
    float dp_step = 0.f;
    __syncthreads();
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      const int b = b0 + rl;
      const bool rok = first_half && rl < rows;
      // (A) the operands of this lane's cells, fetched while the remat
      // product runs
      float x[kMaxNT][4], dhv[kMaxNT], dcv[kMaxNT], cp[kMaxNT], c[kMaxNT];
      const float m = rok ? mask[(size_t)b * T + t] : 0.f;
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) {
        const int u = u0 + 2 * j + uin;
        if (!rok || j >= NT || u >= D) continue;
        const size_t bu = (size_t)b * D + u;
        const size_t bt = b * TD + (size_t)t * D + u;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          x[j][g] = kRemat ? to_f(xw[b * T4D + (size_t)t * 4 * D + g * D + u])
                           : b2f(gates_in[b * T4D + (size_t)t * 4 * D +
                                          g * D + u]);
        dhv[j] = dh[bu] + b2f(dhs[bt]);
        dcv[j] = dc[bu];
        cp[j] = first ? __ldcg(c0 + bu)
                      : __ldcg(cs + b * TD + (size_t)tp * D + u);
        c[j] = __ldcg(cs + bt);
      }
      float pre[kMaxNT][4];
      if (kRemat) {
        const bf16* a = first ? h0 + (size_t)b0 * D
                              : hs + b0 * TD + (size_t)tp * D;
        product_bf16<S, kKCB, false>(a, first ? D : TD, rows, D, w_s, LDK,
                                     NT, a_s, pre);
        gather_gates(sums, NT, pre);
      }
      if (first_half) {
#pragma unroll
        for (int j = 0; j < kMaxNT; ++j) {
          if (j >= NT) break;
          const int uu = 2 * j + uin, u = u0 + uu;
          float d_i = 0.f, d_f = 0.f, d_g = 0.f, d_o = 0.f;
          float t0 = 0.f, t1 = 0.f, t2 = 0.f;
          if (rok && u < D) {
            float gi = x[j][0], gf = x[j][1], gg = x[j][2], go = x[j][3];
            if (kRemat) {
              const Gates q = cell(x[j][0], x[j][1], x[j][2], x[j][3],
                                   pre[j][0], pre[j][1], pre[j][2],
                                   pre[j][3], cp[j], pp[j][0], pp[j][1],
                                   pp[j][2]);
              gi = rnd(q.i);
              gf = rnd(q.f);
              gg = rnd(q.g);
              go = rnd(q.o);
            }
            const float tcv = tanhf(c[j]);
            d_o = dhv[j] * tcv * go * (1.f - go) * m;
            const float dct = (dcv[j] + dhv[j] * go * (1.f - tcv * tcv)) * m
                              + d_o * pp[j][2];
            d_i = dct * gg * gi * (1.f - gi);
            d_f = dct * cp[j] * gf * (1.f - gf);
            d_g = dct * gi * (1.f - gg * gg);
            float* dgr = dgates + b * T4D + (size_t)t * 4 * D;
            dgr[u] = d_i;
            dgr[D + u] = d_f;
            dgr[2 * D + u] = d_g;
            dgr[3 * D + u] = d_o;
            t0 = d_i * cp[j];
            t1 = d_f * cp[j];
            t2 = d_o * c[j];
            const size_t bu = (size_t)b * D + u;
            dh[bu] = (1.f - m) * dhv[j];  // (B) adds the product
            dc[bu] = dct * gf + d_i * pp[j][0] + d_f * pp[j][1] +
                     (1.f - m) * dcv[j];
            // the cell's dgates rounded to bf16 for every block's (B)
            *reinterpret_cast<uint2*>(X + (size_t)b * 4 * D + 4 * u) =
                make_uint2(tc::pack_bf16x2(d_i, d_f),
                           tc::pack_bf16x2(d_g, d_o));
          }
          contrib[(0 * kRows + rl) * U + uu] = t0;
          contrib[(1 * kRows + rl) * U + uu] = t1;
          contrib[(2 * kRows + rl) * U + uu] = t2;
        }
      }
      __syncthreads();
      if (threadIdx.x < 3 * U) {
        const int k = threadIdx.x / U, q = threadIdx.x % U;
        float sum = 0.f;
        for (int r = 0; r < kRows; ++r) sum += contrib[(k * kRows + r) * U + q];
        dp_step += sum;
      }
      __syncthreads();   // the terms and the sums are free
    }
    dp_acc += dp_step;
    // (B) dh_{t-1} of the own units from every block's rounded dgates, in
    // two passes.  One buffer of X and of pp serves every step: a block
    // writes X again only past the barrier every block reaches after its
    // (B1), and pp only past the one every block reaches after its (B2).
    grid.sync();
    for (int b0 = 0; b0 < B; b0 += kRows)
      dh_part(X, wp, sp, D, B, BP, b0, nmu, ppb);
    grid.sync();
    dh_sum(part, sp, D, B, BP, U, nu, u0, dh);
  }
  if (threadIdx.x < 3 * U) {
    const int k = threadIdx.x / U, q = threadIdx.x % U;
    if (q < nu) dpeep[(size_t)k * D + u0 + q] = dp_acc;
  }
}

int optin_bytes() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return optin;
}

// The forward's ring: the most stages up to 3 that fit (a fourth ran no
// faster at the text shape and takes L1's room), 0 when 2 do not.
int stages_fwd_bf16(int D, int U, int E) {
  const int optin = optin_bytes();
  for (int s = 3; s >= 2; --s)
    if (PlanFwdBf16(D, U, s, E).total <= (size_t)optin) return s;
  return 0;
}

// The backward's plan: its part of W_h in shared memory with the most ring
// stages up to 3 that fit beside it, else the part read where it lies with
// the most that fit (stages 0: none do).  The stored form has no ring.
void plan_bwd_bf16(int D, int U, bool remat, int grid, int* stages,
                   int* part) {
  const int optin = optin_bytes();
  for (int p = 1; p >= 0; --p)
    for (int s = remat ? 3 : 2; s >= 2; --s)
      if (PlanBwdBf16(D, U, s, remat, p, grid).total <= (size_t)optin) {
        *stages = s;
        *part = p;
        return;
      }
  *stages = 0;
  *part = 0;
}

template <bool kFi>
int launch_fwd_bf16(const void* in, const float* mask, const void* wxpack,
                    const float* bias, const void* wpack, const void* peep,
                    const void* h0, const float* c0, void* hs, float* cs,
                    void* gates, float* hT, float* cT, int B, int T, int E,
                    int D, int U, int reverse, void* stream) {
  const int stages = stages_fwd_bf16(D, U, kFi ? E : 0);
  if (stages == 0) return (int)cudaErrorInvalidValue;
  const int grid = (D + U - 1) / U;
  const size_t smem = PlanFwdBf16(D, U, stages, kFi ? E : 0).total;
  const bf16* x = static_cast<const bf16*>(in);
  const bf16* wx = static_cast<const bf16*>(wxpack);
  const bf16* w = static_cast<const bf16*>(wpack);
  const bf16* p = static_cast<const bf16*>(peep);
  const bf16* h = static_cast<const bf16*>(h0);
  bf16* o = static_cast<bf16*>(hs);
  bf16* g = static_cast<bf16*>(gates);
  void* args[] = {&x, &mask, &wx, &bias, &w, &p, &h, &c0, &o, &cs, &g, &hT,
                  &cT, &B, &T, &E, &D, &U, &reverse};
  cudaStream_t st = (cudaStream_t)stream;
  // fragments ahead where the block's columns fill 4 n8 tiles or more (on
  // an H100 80GB HBM3 at 700 W: 0.21 ms faster at D 1280, U 10; 0.08 ms
  // slower at U 4 and 2)
  if (!kFi && U >= kAheadFromU)
    return stages == 3
        ? cooperative(lstm_fwd_bf16_kernel<false, 3, true>, grid, kThreadsB,
                      smem, args, st)
        : cooperative(lstm_fwd_bf16_kernel<false, 2, true>, grid, kThreadsB,
                      smem, args, st);
  return stages == 3
      ? cooperative(lstm_fwd_bf16_kernel<kFi, 3, false>, grid, kThreadsB,
                    smem, args, st)
      : cooperative(lstm_fwd_bf16_kernel<kFi, 2, false>, grid, kThreadsB,
                    smem, args, st);
}

bool valid_bf16(int B, int T, int D, int U) {
  return B > 0 && T > 0 && D > 0 && D % 8 == 0 && U > 0 && U % 2 == 0 &&
         U <= kMaxUnits;
}

template <bool kRemat, typename XT>
int launch_bwd_bf16(int stages, int grid, size_t smem, void** args,
                    cudaStream_t st) {
  return stages == 3
      ? cooperative(lstm_bwd_bf16_kernel<kRemat, XT, 3>, grid, kThreadsB,
                    smem, args, st)
      : cooperative(lstm_bwd_bf16_kernel<kRemat, XT, 2>, grid, kThreadsB,
                    smem, args, st);
}

}  // namespace

// The bf16 forward: xw [B, T, 4D], W_h's pack [blocks][4U][LDK], the
// peepholes [3, D] and h0 [B, D] in bf16; mask [B, T] and c0 in f32; hs and
// the gates slab (nullptr: none) bf16, cs, hT, cT f32.  D % 8 == 0; U even.
extern "C" int lstm_fwd_bf16(const void* xw, const float* mask,
                             const void* wpack, const void* peep,
                             const void* h0, const float* c0, void* hs,
                             float* cs, void* gates, float* hT, float* cT,
                             int B, int T, int D, int U, int reverse,
                             void* stream) {
  if (!valid_bf16(B, T, D, U)) return (int)cudaErrorInvalidValue;
  return launch_fwd_bf16<false>(xw, mask, nullptr, nullptr, wpack, peep, h0,
                                c0, hs, cs, gates, hT, cT, B, T, 0, D, U,
                                reverse, stream);
}

// The bf16 fused-input forward: x [B, T, E] bf16 (E % 8 == 0, 16-byte
// aligned), wxpack [blocks][4U][LDK(E)] W_x's slices packed as W_h's,
// bias [4D] f32; the rest as lstm_fwd_bf16.
extern "C" int lstm_fi_fwd_bf16(const void* x, const float* mask,
                                const void* wxpack, const float* bias,
                                const void* wpack, const void* peep,
                                const void* h0, const float* c0, void* hs,
                                float* cs, void* gates, float* hT, float* cT,
                                int B, int T, int E, int D, int U,
                                int reverse, void* stream) {
  if (!valid_bf16(B, T, D, U) || E <= 0 || E % 8 != 0)
    return (int)cudaErrorInvalidValue;
  return launch_fwd_bf16<true>(x, mask, wxpack, bias, wpack, peep, h0, c0,
                               hs, cs, gates, hT, cT, B, T, E, D, U, reverse,
                               stream);
}

// The bf16 backward: remat != 0 recomputes the gates from xw (bf16, or
// f32 when xw_f32 != 0) and the shifted h/c stacks, remat == 0 reads the
// forward's bf16 slab gates_in; hs, dhs, the packs, peep and h0 bf16; mask,
// c0, cs, dhT, dcT f32; dgates, dh, dc, dpeep f32.  wpack is W_h's column
// slices as the forward's (read by the remat form only); w_h is W_h [D, 4D]
// itself, from which each block builds its part for the dh product
// (SplitBf16) in shared memory where it fits, else in wparts, bf16 scratch
// of blocks * MP * LDP; xg bf16 scratch of B * 4D (the rounded dgates) and
// pp f32 scratch of blocks * MP * BP (BP = B rounded up to 64), all
// 16-byte aligned.
extern "C" int lstm_bwd_bf16(const void* xw, const void* gates_in,
                             const float* mask, const void* wpack,
                             const void* w_h, void* wparts, const void* peep,
                             const void* h0, const float* c0, const void* hs,
                             const float* cs, const void* dhs,
                             const float* dhT, const float* dcT,
                             float* dgates, float* dh, float* dc,
                             float* dpeep, void* xg, float* pp, int B, int T,
                             int D, int U, int reverse, int remat,
                             int xw_f32, void* stream) {
  if (!valid_bf16(B, T, D, U)) return (int)cudaErrorInvalidValue;
  const int grid = (D + U - 1) / U;
  int stages = 0, part = 0;
  plan_bwd_bf16(D, U, remat != 0, grid, &stages, &part);
  if (stages == 0 || (!part && wparts == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = PlanBwdBf16(D, U, stages, remat != 0, part, grid).total;
  const bf16* g = static_cast<const bf16*>(gates_in);
  const bf16* w = static_cast<const bf16*>(wpack);
  const bf16* wh = static_cast<const bf16*>(w_h);
  bf16* wp = static_cast<bf16*>(wparts);
  const bf16* p = static_cast<const bf16*>(peep);
  const bf16* h = static_cast<const bf16*>(h0);
  const bf16* y = static_cast<const bf16*>(hs);
  const bf16* dy = static_cast<const bf16*>(dhs);
  bf16* xs = static_cast<bf16*>(xg);
  cudaStream_t st = (cudaStream_t)stream;
  if (remat && xw_f32) {
    const float* x = static_cast<const float*>(xw);
    void* args[] = {&x, &g, &mask, &w, &wh, &wp, &p, &h, &c0, &y, &cs, &dy,
                    &dhT, &dcT, &dgates, &dh, &dc, &dpeep, &xs, &pp, &B, &T,
                    &D, &U, &reverse, &part};
    return launch_bwd_bf16<true, float>(stages, grid, smem, args, st);
  }
  const bf16* x = static_cast<const bf16*>(xw);
  void* args[] = {&x, &g, &mask, &w, &wh, &wp, &p, &h, &c0, &y, &cs, &dy,
                  &dhT, &dcT, &dgates, &dh, &dc, &dpeep, &xs, &pp, &B, &T, &D,
                  &U, &reverse, &part};
  return remat ? launch_bwd_bf16<true, bf16>(stages, grid, smem, args, st)
               : cooperative(lstm_bwd_bf16_kernel<false, bf16, 2>, grid,
                             kThreadsB, smem, args, st);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

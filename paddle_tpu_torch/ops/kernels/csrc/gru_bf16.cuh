// Shared pieces of the GRU kernels' bf16 forms (csrc/gru_seq.cu's
// gru_fwd_bf16 and gru_bwd_bf16, csrc/bigru_seq.cu's bigru_fwd_bf16): the
// block's tensor-core product routine and the plan of its shared memory.
//
// Tiling.  A block of 8 warps owns U hidden units (U <= 16) and keeps its
// weight slices in shared memory as bf16 rows [8 NT][LDK], the reduction
// contiguous: row n is the n-th column of the block's product.  Two
// shapes of slice: "pairs", the update and reset columns of its units
// side by side (row 2 uu + g, g = 0 the update gate, 1 the reset gate;
// NT = ceil(2U / 8) n8 tiles), and "units", one row a unit (the
// candidate's column, or in the backward the row of W_h or W_hc the unit
// owns; NT = ceil(U / 8)).  Rows past 2U or U are zero up to whole n8
// tiles, the reduction is zero past K up to a multiple of 16, then 8 more
// (an odd count of 16-byte groups: the 8 rows an ldmatrix phase reads
// fall in distinct banks).  ops/kernels/gru.py's _pack_bf16 packs them.
//
// The product (mma.sync.m16n8k16 of mma_bf16.cuh, f32 accumulators).  A
// (the h, r*h, dc, [du, dr] or x rows of a 64-row chunk of the batch)
// streams from global memory through a ring of S stages of 64 x 64 bf16
// (cp.async.cg: L2, never a stale L1 line, since other blocks write those
// rows during the launch).  Warp w takes row tile w % 4 (16 rows) and
// every other 16-deep step of the reduction (w / 4); the second half's
// sums reach the first half through shared memory and are added after
// it, so a value's bits depend on the inputs only.  In an m16n8
// accumulator the lane (g = lane / 4, q = lane % 4) of a first-half warp
// holds columns 8j + 2q, 8j + 2q + 1 of rows 16 (w % 4) + g and + 8: on a
// pairs slice, the update and reset sums of unit 4j + q; on a units
// slice, units 8j + 2q and 8j + 2q + 1.  The cell runs there, in f32.

#pragma once

#include <cuda_bf16.h>

#include "gru_common.cuh"
#include "mma_bf16.cuh"

namespace gru_bf16 {

using bf16 = __nv_bfloat16;
namespace tc = bf16_tc;

constexpr int kRows = 64;                 // batch rows a chunk
constexpr int kWarps = 8;                 // 4 row tiles x 2 halves of K
constexpr int kThreads = 32 * kWarps;
constexpr int kKC = 64;                   // depth of a staged slice of A
constexpr int kALd = kKC + 8;             // its padded row (bf16)
constexpr int kStage = kRows * kALd;      // bf16 elements a stage
constexpr int kMaxUnits = 16;
constexpr int kMaxNT = kMaxUnits / 4;     // n8 tiles of a pairs slice

__host__ __device__ inline int ld_k(int k) { return 16 * ((k + 15) / 16) + 8; }
__host__ __device__ inline int tiles(int cols) { return (cols + 7) / 8; }
// bf16 elements of a slice of `cols` columns over a reduction of k
__host__ __device__ inline int slice_elems(int cols, int k) {
  return 8 * tiles(cols) * ld_k(k);
}
// bytes of the staging region: the ring of S stages, or the halves' f32
// sums [4 row tiles][NT][4][32 lanes]
__host__ __device__ inline size_t region_bytes(int S, int nt) {
  const size_t ring = (size_t)S * kStage * 2, sums = (size_t)512 * nt * 4;
  return ring > sums ? ring : sums;
}

__device__ __forceinline__ float b2f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 f2b(float x) { return __float2bfloat16_rn(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return b2f(x); }
// a bf16 another block may have written in this launch, read through L2
__device__ __forceinline__ float ldcg_bf(const bf16* p) {
  return b2f(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// The block's slice (elems bf16, a multiple of 8) of a pack [blocks][elems].
__device__ __forceinline__ void load_slice(bf16* w_s, const bf16* pack,
                                           size_t elems, int block) {
  const uint4* src = reinterpret_cast<const uint4*>(pack + elems * block);
  uint4* dst = reinterpret_cast<uint4*>(w_s);
  for (size_t e = threadIdx.x; e < elems / 8; e += kThreads) dst[e] = src[e];
}

// Stage slice c of A (rows [0, rows) at a + r lda, columns c kKC ..
// c kKC + kKC - 1, zero past rows and K; K % 8 == 0) into buf.
__device__ __forceinline__ void load_a(bf16* buf, const bf16* a, size_t lda,
                                       int rows, int K, int c) {
  for (int p = threadIdx.x; p < kRows * (kKC / 8); p += kThreads) {
    const int r = p / (kKC / 8), q = p % (kKC / 8);
    const int k = c * kKC + 8 * q;
    const bool ok = r < rows && k < K;
    tc::cp_async16(buf + r * kALd + 8 * q, ok ? a + r * lda + k : a, ok);
  }
}

// acc[j] of a first-half warp = the m16n8 tile j (NT of them) of A [rows x
// K] . W^T, w_s the [8 NT][LDK] slice.  Every thread of the block calls
// it; the ring a_s and the sums (which may alias it) are free when it
// returns.
template <int S>
__device__ __forceinline__ void product(const bf16* a, size_t lda, int rows,
                                        int K, const bf16* w_s, int LDK,
                                        int NT, bf16* a_s, float* sums,
                                        float (&acc)[kMaxNT][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mi = warp & 3, kh = warp >> 2;
#pragma unroll
  for (int j = 0; j < kMaxNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int nc = (K + kKC - 1) / kKC;
#pragma unroll
  for (int c = 0; c < S - 1; ++c) {
    if (c < nc) load_a(a_s + c * kStage, a, lda, rows, K, c);
    tc::cp_async_commit();
  }
  for (int c = 0; c < nc; ++c) {
    tc::cp_async_wait<S - 2>();
    __syncthreads();
    const int cn = c + S - 1;
    if (cn < nc) load_a(a_s + (cn % S) * kStage, a, lda, rows, K, cn);
    tc::cp_async_commit();
    const bf16* buf = a_s + (c % S) * kStage;
    const int nks = (min(kKC, K - c * kKC) + 15) / 16;
    for (int ks = kh; ks < nks; ks += 2) {
      uint32_t af[4];
      tc::ldmatrix_x4(af, buf + (16 * mi + (lane & 15)) * kALd + 16 * ks +
                              8 * (lane >> 4));
      const int k0 = c * kKC + 16 * ks;
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) {
        if (j >= NT) break;
        uint32_t b[2];
        tc::ldmatrix_x2(b, w_s + (size_t)(8 * j + (lane & 7)) * LDK + k0 +
                               8 * ((lane >> 3) & 1));
        tc::mma_bf16(acc[j], af, b[0], b[1]);
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();       // every slice read: the ring may hold the sums
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
  if (kh == 0) {
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j) {
      if (j >= NT) break;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] += sums[((mi * NT + j) * 4 + e) * 32 + lane];
    }
  }
  __syncthreads();       // the sums are read: the region is free
}

// The cells of a first-half warp's lane, by the slice's shape: on a pairs
// slice, tile j's unit and its two rows; on a units slice, tile j's
// accumulator e: unit 8j + 2q + (e & 1), row + 8 (e >> 1).
struct Lane {
  bool first;   // a first-half warp: it holds the summed accumulators
  int r0;       // the chunk row of accumulators 0, 1 (2, 3: r0 + 8)
  int q;
  __device__ Lane() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    first = warp < 4;
    r0 = 16 * (warp & 3) + (lane >> 2);
    q = lane & 3;
  }
  __device__ int pair_unit(int j) const { return 4 * j + q; }
  __device__ int unit(int j, int e) const { return 8 * j + 2 * q + (e & 1); }
  __device__ int row(int e) const { return r0 + 8 * (e >> 1); }
};

inline bool valid_bf16(int B, int T, int D, int U) {
  return B > 0 && T > 0 && D > 0 && D % 8 == 0 && U > 0 && U <= kMaxUnits;
}

// Stages of the ring: three when `w` bytes of weights, the ring and the
// sums of nt tiles fit the card's opt-in, else two; 0 when two do not.
inline int stages_for(size_t w, int nt) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  for (int s = 3; s >= 2; --s)
    if (w + region_bytes(s, nt) <= (size_t)optin) return s;
  return 0;
}

}  // namespace gru_bf16

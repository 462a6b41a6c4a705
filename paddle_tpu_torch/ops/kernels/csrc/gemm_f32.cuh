// Shared f32 GEMM tile for the port's convolution kernels (brgemm.cu,
// conv2d_direct.cu): C[M, N] = A[M, Kred] . B[Kred, N] with an f32
// accumulator in registers and a fused epilogue before the one store.
//
// B is row-major [Kred, N] in device memory (a weight matrix).  A is never
// materialised: a Loader gives A(m, k), so one tile serves the batch-reduce
// GEMM (A is a stack of matrices, or the strided pixel rows of an NHWC
// image) and the implicit-GEMM convolution (A is the patch matrix, built
// on the fly from index math).  A Loader provides
//
//   struct Row;  __device__ Row row(int m) const;   // m >= M is masked
//   struct Col;  __device__ Col col(int k) const;   // k >= Kred is masked
//   __device__ float load(const Row&, const Col&) const;  // 0 when masked
//
// Tile: 128 rows x BN (64 or 128) columns per block of 256 threads, the
// reduction streamed 8 deep through double-buffered shared memory.  Thread
// (ty, tx) of the 16 x 16 grid owns rows ty + 16 i and columns tx + 16 j,
// so its shared-memory reads are broadcasts (A) or 16 consecutive words
// (B) and its stores to C are 16 consecutive words per row.  FMA on the
// CUDA cores: f32 at full precision (TF32 stays off, as everywhere in the
// port).
//
// Epilogue, on the accumulator before the store:
//   - stats: per-column sum and sum of squares of the pre-epilogue
//     accumulator over the valid rows of the block, written as one partial
//     per row tile (no atomics); stats_reduce then sums the partials of
//     each column in a fixed order, so a rerun is bit-identical;
//   - affine: y = acc * scale[n] + shift[n] (the inference-mode BN fold);
//   - relu.
// Rows past M and columns past N are masked in the loads and the stores;
// nothing is padded in memory.

#pragma once

#include <cuda_runtime.h>

namespace gemm {

constexpr int kBM = 128;        // output rows per block
constexpr int kBK = 8;          // reduction depth per shared-memory stage
constexpr int kThreads = 256;   // 16 x 16
constexpr int kTM = kBM / 16;   // rows per thread
constexpr int kARows = kThreads / kBK;         // A rows loaded per pass (32)
constexpr int kALoads = kBM * kBK / kThreads;  // A loads per thread (4)

struct Epilogue {
  const float* scale;  // [N] or null
  const float* shift;  // [N] or null (set with scale)
  int relu;
  float* partial;      // [2, row_tiles, N] or null: per-tile sum, sumsq
};

template <int BN, class Loader>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(Loader A, const float* __restrict__ b, int M, int N, int Kred,
            float* __restrict__ y, Epilogue ep) {
  constexpr int TN = BN / 16;                   // columns per thread
  constexpr int kBLoads = BN * kBK / kThreads;  // B loads per thread
  constexpr int kBRows = kThreads / BN;         // B rows loaded per pass
  // A is stored transposed ([k][m]); the +4 pad makes the transposing
  // stores of a warp hit 32 distinct banks
  __shared__ float As[2][kBK][kBM + 4];
  __shared__ float Bs[2][kBK][BN];
  __shared__ float red[2][16][BN];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;

  const int a_k = tid % kBK, a_m = tid / kBK;
  typename Loader::Row rows[kALoads];
#pragma unroll
  for (int i = 0; i < kALoads; ++i) rows[i] = A.row(m0 + a_m + kARows * i);
  const int b_n = tid % BN, b_k = tid / BN;
  const bool b_col_ok = n0 + b_n < N;

  float acc[kTM][TN];
#pragma unroll
  for (int r = 0; r < kTM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

  float a_reg[kALoads], b_reg[kBLoads];
  auto load_global = [&](int k0) {
    const typename Loader::Col col = A.col(k0 + a_k);
#pragma unroll
    for (int i = 0; i < kALoads; ++i) a_reg[i] = A.load(rows[i], col);
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      const int k = k0 + b_k + kBRows * i;
      b_reg[i] = (b_col_ok && k < Kred) ? b[(long long)k * N + n0 + b_n] : 0.f;
    }
  };
  auto store_shared = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kALoads; ++i) As[buf][a_k][a_m + kARows * i] = a_reg[i];
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) Bs[buf][b_k + kBRows * i][b_n] = b_reg[i];
  };

  const int steps = (Kred + kBK - 1) / kBK;
  load_global(0);
  store_shared(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    // the next stage's loads are in flight while this stage computes
    if (s + 1 < steps) load_global((s + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM], bv[TN];
#pragma unroll
      for (int r = 0; r < kTM; ++r) av[r] = As[buf][kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < TN; ++c) bv[c] = Bs[buf][kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < kTM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    // buf ^ 1 was last read in stage s - 1, before the barrier that ended it
    if (s + 1 < steps) store_shared(buf ^ 1);
    __syncthreads();
  }

  if (ep.partial != nullptr) {
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int r = 0; r < kTM; ++r) {
        if (m0 + ty + 16 * r < M) {
          s += acc[r][c];
          ss += acc[r][c] * acc[r][c];
        }
      }
      red[0][ty][tx + 16 * c] = s;
      red[1][ty][tx + 16 * c] = ss;
    }
    __syncthreads();
    for (int i = tid; i < 2 * BN; i += kThreads) {
      const int mo = i / BN, col = i % BN;
      if (n0 + col < N) {
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) t += red[mo][j][col];
        ep.partial[((long long)mo * gridDim.x + blockIdx.x) * N + n0 + col] = t;
      }
    }
  }

  float sc[TN], sh[TN];
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    const int n = n0 + tx + 16 * c;
    const bool ok = ep.scale != nullptr && n < N;
    sc[c] = ok ? ep.scale[n] : 1.f;
    sh[c] = ok ? ep.shift[n] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    const int m = m0 + ty + 16 * r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int n = n0 + tx + 16 * c;
      if (n >= N) continue;
      float v = acc[r][c];
      if (ep.scale != nullptr) v = fmaf(v, sc[c], sh[c]);
      if (ep.relu) v = fmaxf(v, 0.f);
      y[(long long)m * N + n] = v;
    }
  }
}

// sum[n], sumsq[n] from the per-row-tile partials [2, tiles, N]: 8 warps
// each sum a fixed stride of tiles for 32 columns, then warp 0 adds the 8
// partials in order — a fixed summation order, so reruns are bit-identical.
__global__ void __launch_bounds__(256)
stats_reduce(const float* __restrict__ partial, int tiles, int N,
             float* __restrict__ sum, float* __restrict__ sumsq) {
  __shared__ float part[8][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane, mo = blockIdx.y;
  float t = 0.f;
  if (n < N) {
    const float* p = partial + (long long)mo * tiles * N + n;
    for (int i = w; i < tiles; i += 8) t += p[(long long)i * N];
  }
  part[w][lane] = t;
  __syncthreads();
  if (w == 0 && n < N) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s += part[j][lane];
    (mo == 0 ? sum : sumsq)[n] = s;
  }
}

inline int row_tiles(int M) { return (M + kBM - 1) / kBM; }

// One GEMM launch (+ the stats reduction when partial is set); returns the
// first CUDA error, or 0.
template <class Loader>
int launch(const Loader& A, const float* b, int M, int N, int Kred, float* y,
           const float* scale, const float* shift, int relu, float* partial,
           float* sum, float* sumsq, cudaStream_t stream) {
  const int tiles = row_tiles(M);
  const Epilogue ep{scale, shift, relu, partial};
  if (N <= 64) {
    const dim3 grid(tiles, (N + 63) / 64);
    gemm_kernel<64, Loader><<<grid, kThreads, 0, stream>>>(A, b, M, N, Kred, y, ep);
  } else {
    const dim3 grid(tiles, (N + 127) / 128);
    gemm_kernel<128, Loader><<<grid, kThreads, 0, stream>>>(A, b, M, N, Kred, y, ep);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return (int)err;
  const dim3 grid((N + 31) / 32, 2);
  stats_reduce<<<grid, 256, 0, stream>>>(partial, tiles, N, sum, sumsq);
  return (int)cudaGetLastError();
}

}  // namespace gemm

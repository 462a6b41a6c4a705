// Shared pieces of the GRU kernels (csrc/gru_seq.cu, csrc/bigru_seq.cu):
// the per-block product routine, the gate code the forward and the remat
// backward both run, and the cooperative launch.
//
// Tiling.  A block owns U hidden units (U <= 8) and runs 64U threads.
// Thread (q, rg, uu) — q = tid / 16U the quarter of k it sums, rg the row
// group, uu the unit — accumulates batch rows rg + 16 i (i < 4) of unit
// uu over its quarter of each 32-deep chunk of k; the four quarters' sums
// are added in a fixed order through shared memory, and the thread
// finishes row rg + 16 q.  So every (row, unit) value of a step belongs to
// one fixed thread, which also runs the cell update from registers, and a
// value's bits depend on the inputs only.  A (the h, r*h or x rows)
// streams from global memory through shared memory in chunks of 64 rows
// x 32 k, S stages of cp.async.cg in flight (L2, never a stale L1 line:
// other blocks write those rows during the launch).  The weight slice
// is [K][U][NC] in shared memory: the NC gate columns of each own unit.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace gru {

namespace cg = cooperative_groups;

constexpr int kRows = 64;             // batch rows per chunk
constexpr int kRG = 16;               // row groups: thread rows rg + 16 i
constexpr int kRB = kRows / kRG;      // 4 rows a thread
constexpr int kQ = 4;                 // k-split: quarters of each chunk
constexpr int kK = 32;                // depth of one staged chunk of A
constexpr int kLda = kK + 4;          // its padded row stride (floats)
constexpr int kStage = kRows * kLda;  // floats a stage
constexpr int kMaxUnits = 8;          // 64U threads a block, at most 512
constexpr int kMaxNC = 3;             // gate columns a unit, at most

// Floats of the staging area: S stages of A, or the quarters' sums
// [kQ][kRows][U * kMaxNC + 1] (odd rows: no bank conflicts).
__host__ __device__ inline int sums_ld(int U) { return U * kMaxNC + 1; }
__host__ __device__ inline int scratch_floats(int U, int S) {
  const int stages = S * kStage, sums = kQ * kRows * sums_ld(U);
  return stages > sums ? stages : sums;
}

struct Lane {
  int q, rg, uu, row;   // row: the chunk row this thread finishes
  __device__ Lane(int U) {
    const int l = threadIdx.x % (kRG * U);
    q = threadIdx.x / (kRG * U);
    rg = l % kRG;
    uu = l / kRG;
    row = rg + kRG * q;
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

__device__ __forceinline__ float sigm(float x) {
  return 1.f / (1.f + expf(-x));
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

// fin[n] = sum_k A[row][k] * W[k][uu][n] for the thread's row: k
// ascending within each quarter of each chunk, one fmaf per term, then
// ((q0 + q1) + q2) + q3.  A is global (rows [0, rows) at a + r * lda, K %
// 4 == 0), staged through a_s in S stages; w_s is the block's [K][U][NC]
// slice.  Every thread of the block must call it.
template <int NC, int S>
__device__ __forceinline__ void gemm(const float* a, size_t lda, int rows,
                                     int K, const float* w_s, int U,
                                     const Lane& ln, float* a_s,
                                     float fin[NC]) {
  float acc[kRB][NC];
#pragma unroll
  for (int i = 0; i < kRB; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
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
    const float* buf = a_s + (c % S) * kStage;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kl = 8 * ln.q + 4 * h;     // k within the chunk
      const int kg = c * kK + kl;
      if (kg >= K) break;
      float4 av[kRB];
#pragma unroll
      for (int i = 0; i < kRB; ++i)
        av[i] = *reinterpret_cast<const float4*>(
            buf + (ln.rg + kRG * i) * kLda + kl);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* wr = w_s + ((size_t)(kg + kk) * U + ln.uu) * NC;
        float w[NC];
#pragma unroll
        for (int n = 0; n < NC; ++n) w[n] = wr[n];
#pragma unroll
        for (int i = 0; i < kRB; ++i) {
          const float x = kk == 0 ? av[i].x : kk == 1 ? av[i].y
                        : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(x, w[n], acc[i][n]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();       // every chunk read: the staging area is free
  const int ld = sums_ld(U);
  float* sums = a_s;     // [kQ][kRows][ld]
#pragma unroll
  for (int i = 0; i < kRB; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n)
      sums[(ln.q * kRows + ln.rg + kRG * i) * ld + ln.uu * NC + n] =
          acc[i][n];
  __syncthreads();
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    const float* s = sums + ln.row * ld + ln.uu * NC + n;
    fin[n] = ((s[0] + s[kRows * ld]) + s[2 * kRows * ld]) + s[3 * kRows * ld];
  }
  __syncthreads();       // the caller may reuse the staging area
}

// Copy the block's packed slice ([blocks][n floats] in global) into w_s.
__device__ __forceinline__ void load_slice(float* w_s, const float* pack,
                                           size_t n, int block) {
  const float4* src = reinterpret_cast<const float4*>(pack + n * block);
  float4* dst = reinterpret_cast<float4*>(w_s);
  for (size_t e = threadIdx.x; e < n / 4; e += blockDim.x) dst[e] = src[e];
}

// The update and reset gates of one (row, unit) from the gate inputs xu,
// xr and the h_{t-1} @ W_h products au, ar; shared by the forwards and
// the remat backward, so all compute them with the same instructions.
__device__ __forceinline__ void update_reset(float xu, float xr, float au,
                                             float ar, float& u, float& r) {
  u = sigm(xu + au);
  r = sigm(xr + ar);
}

__device__ __forceinline__ float candidate(float xc, float ac) {
  return tanhf(xc + ac);
}

// Stages of the A pipeline: three when they fit beside `w` floats of
// weights, else two; 0 when even two do not fit.
inline int stages_for(size_t w, int U) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  for (int s = 3; s >= 2; --s)
    if (sizeof(float) * (w + scratch_floats(U, s)) <= (size_t)optin) return s;
  return 0;
}

// One cooperative launch; a grid that cannot be co-resident is refused
// with the launch error, never spun on.
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

inline bool valid_shape(int B, int T, int D, int U) {
  return B > 0 && T > 0 && D > 0 && D % 4 == 0 && U > 0 && U <= kMaxUnits;
}

}  // namespace gru

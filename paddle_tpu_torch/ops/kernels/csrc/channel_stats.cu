// Per-channel sum and sum of squares over all leading axes: the
// training-mode batch-norm moments from one read of x.
//
// Replaces paddle_tpu/ops/pallas/tpp/conv.py::channel_stats (the
// pallas_call of _stats_kernel).  That kernel walks 512-row blocks of the
// [R, C] view in order on one core and carries the two [1, C] sums in its
// output block from one grid step to the next.  Blocks of a CUDA grid run
// in parallel and in no order, so nothing carries between them: the sum
// is split into two passes, with no atomics, so that a rerun gives the
// same bits (the rule of the conv kernels' statistics epilogue).
//
// Pass 1 (partial_kernel): P row blocks, P chosen by the wrapper from R
// alone (never from the card's SM count), each of rows_per_block rows.
// A block covers 32 columns and its rows: thread (tx, ty) owns column
// c = 32 * blockIdx.x + tx and every 8th row of the block from row ty, in
// increasing order, so a warp reads 32 neighbouring floats of one row
// (coalesced).  The 8 row groups are added in shared memory in a fixed
// tree (8 -> 4 -> 2 -> 1) and the block writes its partials
// part[0][p][c] = sum x and part[1][p][c] = sum x^2.
//
// Pass 2 (finish_kernel): the same shape over the [P, C] partials, every
// 8th block from ty, in order, then the same tree: sum[c] and sumsq[c].
//
// What bounds it on an H100: bytes.  It does 3 flops per element read
// (add, multiply, add) against 4 bytes, far below the card's ~20 f32
// flops per byte, so the least time is R * C * 4 bytes over 3.35 TB/s
// (33.5 MB, ~0.010 ms, at small_vgg's first [131072, 64] view).  This
// first design reads a float a thread at a time; vectorised loads and a
// last-block finish in one launch are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;    // columns a block: one warp wide
constexpr int kGroups = 8;   // row groups a block (warps)
constexpr int kThreads = kCols * kGroups;

// Adds the kGroups row groups of (s, ss) in a fixed tree; thread ty == 0
// of each column ends with the block's sums.
__device__ void tree_sum(float s, float ss, float (*sh_s)[kCols],
                         float (*sh_ss)[kCols], int tx, int ty) {
  sh_s[ty][tx] = s;
  sh_ss[ty][tx] = ss;
  __syncthreads();
#pragma unroll
  for (int h = kGroups / 2; h > 0; h >>= 1) {
    if (ty < h) {
      sh_s[ty][tx] += sh_s[ty + h][tx];
      sh_ss[ty][tx] += sh_ss[ty + h][tx];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
partial_kernel(const float* __restrict__ x, long long R, int C,
               long long rows_per_block, int P, float* __restrict__ part) {
  __shared__ float sh_s[kGroups][kCols], sh_ss[kGroups][kCols];
  const int tx = threadIdx.x % kCols, ty = threadIdx.x / kCols;
  const int c = blockIdx.x * kCols + tx;
  const int p = blockIdx.y;
  const long long r0 = (long long)p * rows_per_block;
  const long long r1 = min(R, r0 + rows_per_block);
  float s = 0.f, ss = 0.f;
  if (c < C) {
    const float* col = x + c;
#pragma unroll 4
    for (long long r = r0 + ty; r < r1; r += kGroups) {
      const float v = __ldg(col + r * C);
      s += v;
      ss += v * v;
    }
  }
  tree_sum(s, ss, sh_s, sh_ss, tx, ty);
  if (ty == 0 && c < C) {
    part[(long long)p * C + c] = sh_s[0][tx];
    part[((long long)P + p) * C + c] = sh_ss[0][tx];
  }
}

__global__ void __launch_bounds__(kThreads)
finish_kernel(const float* __restrict__ part, int P, int C,
              float* __restrict__ sum, float* __restrict__ sumsq) {
  __shared__ float sh_s[kGroups][kCols], sh_ss[kGroups][kCols];
  const int tx = threadIdx.x % kCols, ty = threadIdx.x / kCols;
  const int c = blockIdx.x * kCols + tx;
  float s = 0.f, ss = 0.f;
  if (c < C) {
    for (int p = ty; p < P; p += kGroups) {
      s += part[(long long)p * C + c];
      ss += part[((long long)P + p) * C + c];
    }
  }
  tree_sum(s, ss, sh_s, sh_ss, tx, ty);
  if (ty == 0 && c < C) {
    sum[c] = sh_s[0][tx];
    sumsq[c] = sh_ss[0][tx];
  }
}

}  // namespace

// x [R, C] contiguous f32; part [2, P, C] scratch; sum, sumsq [C].  The
// P row blocks of rows_per_block rows must cover R exactly:
// (P - 1) * rows_per_block < R <= P * rows_per_block.
extern "C" int channel_stats_f32(const float* x, long long R, int C,
                                 long long rows_per_block, int P,
                                 float* part, float* sum, float* sumsq,
                                 void* stream) {
  if (R <= 0 || C <= 0 || P <= 0 || P > 65535 || rows_per_block <= 0 ||
      (long long)(P - 1) * rows_per_block >= R ||
      (long long)P * rows_per_block < R)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int col_blocks = (C + kCols - 1) / kCols;
  partial_kernel<<<dim3(col_blocks, P), kThreads, 0, st>>>(
      x, R, C, rows_per_block, P, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_kernel<<<col_blocks, kThreads, 0, st>>>(part, P, C, sum, sumsq);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Per-channel sum and sum of squares over all leading axes: the
// training-mode batch-norm moments from one read of x.
//
// Replaces paddle_tpu/ops/pallas/tpp/conv.py::channel_stats (the
// pallas_call of _stats_kernel).  That kernel walks 512-row blocks of the
// [R, C] view in order on one core and carries the two [1, C] sums in its
// output block from one grid step to the next; on bf16 input it reads
// bf16 and sums in f32 (:74-76).  Blocks of a CUDA grid run in parallel
// and in no order, so nothing carries between them: the sum is split
// into two passes, with no atomics, so that a rerun gives the same bits
// (the rule of the conv kernels' statistics epilogue).
//
// Pass 1 (partial_kernel): P row blocks, P chosen by the wrapper from R
// alone (never from the card's SM count), each of rows_per_block rows.
// A block's 256 threads are `lanes` column chunks by 256 / lanes row
// groups: thread (lane, grp) owns the V channels from (blockIdx.x * lanes
// + lane) * V and every (256 / lanes)-th row of the block from row grp,
// in increasing order.  The row groups are added in shared memory in a
// fixed tree and the block writes its partials part[0][p][c] = sum x and
// part[1][p][c] = sum x^2.  The f32 form reads a float a thread (V = 1,
// lanes = 32: a warp reads 32 neighbouring floats of one row, 8 row
// groups).  The bf16 form reads 8 channels a thread with one 16-byte load
// where C % 8 == 0 (else one), converts them to f32 and sums in f32;
// lanes is 32, or the chunks of a narrower C, so a warp still reads 512
// contiguous bytes at C = 64.  Both forms sum each channel in the same
// scheme from this one source.
//
// Pass 2 (finish_kernel): the f32 form's pass 1 shape over the [P, C]
// partials, every 8th block from the row group, in order, then the same
// tree: sum[c] and sumsq[c].
//
// What bounds it on an H100: bytes.  It does 3 flops per element read
// (add, multiply, add) against 4 bytes (2 in bf16), far below the card's
// ~20 f32 flops per byte, so the least time is R * C * 4 bytes over 3.35
// TB/s (33.5 MB, ~0.010 ms, at small_vgg's first [131072, 64] view; half
// in bf16).  A last-block finish in one launch is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;    // lanes of the f32 form and of pass 2
constexpr int kThreads = 256;

// Adds the row groups of the V (s, ss) pairs of each thread in a fixed
// tree; the threads of row group 0 end with the block's sums in
// sh_s[lane], sh_ss[lane].
template <int V>
__device__ void tree_sum(const float (&s)[V], const float (&ss)[V],
                         float (*sh_s)[V], float (*sh_ss)[V], int lanes) {
  const int grp = threadIdx.x / lanes;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    sh_s[threadIdx.x][v] = s[v];
    sh_ss[threadIdx.x][v] = ss[v];
  }
  __syncthreads();
  for (int h = kThreads / lanes / 2; h > 0; h >>= 1) {
    if (grp < h) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        sh_s[threadIdx.x][v] += sh_s[threadIdx.x + h * lanes][v];
        sh_ss[threadIdx.x][v] += sh_ss[threadIdx.x + h * lanes][v];
      }
    }
    __syncthreads();
  }
}

// The V channels at p, in f32.
__device__ __forceinline__ void load(const float* p, float (&f)[1]) {
  f[0] = __ldg(p);
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[1]) {
  f[0] = __bfloat162float(p[0]);
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <class T, int V>
__global__ void __launch_bounds__(kThreads)
partial_kernel(const T* __restrict__ x, long long R, int C,
               long long rows_per_block, int P, int lanes,
               float* __restrict__ part) {
  __shared__ float sh_s[kThreads][V], sh_ss[kThreads][V];
  const int lane = threadIdx.x % lanes, grp = threadIdx.x / lanes;
  const int groups = kThreads / lanes;
  const int c0 = (blockIdx.x * lanes + lane) * V;
  const int p = blockIdx.y;
  const long long r0 = (long long)p * rows_per_block;
  const long long r1 = min(R, r0 + rows_per_block);
  float s[V], ss[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = ss[v] = 0.f;
  if (c0 < C) {
#pragma unroll 4
    for (long long r = r0 + grp; r < r1; r += groups) {
      float f[V];
      load(x + r * C + c0, f);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        s[v] += f[v];
        ss[v] += f[v] * f[v];
      }
    }
  }
  tree_sum(s, ss, sh_s, sh_ss, lanes);
  if (grp == 0 && c0 < C) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      part[(long long)p * C + c0 + v] = sh_s[lane][v];
      part[((long long)P + p) * C + c0 + v] = sh_ss[lane][v];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
finish_kernel(const float* __restrict__ part, int P, int C,
              float* __restrict__ sum, float* __restrict__ sumsq) {
  __shared__ float sh_s[kThreads][1], sh_ss[kThreads][1];
  const int tx = threadIdx.x % kCols, ty = threadIdx.x / kCols;
  const int c = blockIdx.x * kCols + tx;
  float s[1] = {0.f}, ss[1] = {0.f};
  if (c < C) {
    for (int p = ty; p < P; p += kThreads / kCols) {
      s[0] += part[(long long)p * C + c];
      ss[0] += part[((long long)P + p) * C + c];
    }
  }
  tree_sum(s, ss, sh_s, sh_ss, kCols);
  if (ty == 0 && c < C) {
    sum[c] = sh_s[tx][0];
    sumsq[c] = sh_ss[tx][0];
  }
}

bool bad_plan(long long R, int C, long long rows_per_block, int P) {
  return R <= 0 || C <= 0 || P <= 0 || P > 65535 || rows_per_block <= 0 ||
         (long long)(P - 1) * rows_per_block >= R ||
         (long long)P * rows_per_block < R;
}

// Pass 1 over `chunks` column chunks of V channels, `lanes` a block,
// then pass 2.
template <class T, int V>
int launch(const T* x, long long R, int C, long long rows_per_block, int P,
           int lanes, float* part, float* sum, float* sumsq,
           cudaStream_t st) {
  const int chunks = C / V;
  partial_kernel<T, V><<<dim3((chunks + lanes - 1) / lanes, P), kThreads, 0,
                         st>>>(x, R, C, rows_per_block, P, lanes, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_kernel<<<(C + kCols - 1) / kCols, kThreads, 0, st>>>(part, P, C,
                                                             sum, sumsq);
  return (int)cudaGetLastError();
}

}  // namespace

// x [R, C] contiguous f32; part [2, P, C] scratch; sum, sumsq [C].  The
// P row blocks of rows_per_block rows must cover R exactly:
// (P - 1) * rows_per_block < R <= P * rows_per_block.
extern "C" int channel_stats_f32(const float* x, long long R, int C,
                                 long long rows_per_block, int P,
                                 float* part, float* sum, float* sumsq,
                                 void* stream) {
  if (bad_plan(R, C, rows_per_block, P)) return (int)cudaErrorInvalidValue;
  return launch<float, 1>(x, R, C, rows_per_block, P, kCols, part, sum,
                          sumsq, (cudaStream_t)stream);
}

// x [R, C] contiguous bf16, the rest as channel_stats_f32 (f32 sums);
// vec (8 channels a 16-byte load) needs C % 8 == 0 and x 16-byte aligned.
extern "C" int channel_stats_bf16(const __nv_bfloat16* x, long long R, int C,
                                  long long rows_per_block, int P, int vec,
                                  float* part, float* sum, float* sumsq,
                                  void* stream) {
  if (bad_plan(R, C, rows_per_block, P) ||
      (vec && (C % 8 != 0 ||
               (reinterpret_cast<unsigned long long>(x) & 15) != 0)))
    return (int)cudaErrorInvalidValue;
  const int chunks = vec ? C / 8 : C;
  int lanes = kCols;
  while (lanes > 1 && lanes / 2 >= chunks) lanes /= 2;
  return vec ? launch<__nv_bfloat16, 8>(x, R, C, rows_per_block, P, lanes,
                                        part, sum, sumsq, (cudaStream_t)stream)
             : launch<__nv_bfloat16, 1>(x, R, C, rows_per_block, P, lanes,
                                        part, sum, sumsq,
                                        (cudaStream_t)stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Embedding row gather and duplicate-exact scatter-add.
//
// Replaces paddle_tpu/ops/pallas/tpp/embedding.py::embedding_gather (one
// row DMA per id, the id list scalar-prefetched into SMEM) and
// ::embedding_scatter_add (a one-hot MXU contraction accumulated over id
// blocks; run after jax.ops.segment_sum in the fused lookup's backward).
//
// What bounds them on an H100: bytes.  Neither does arithmetic worth the
// name: the gather moves N rows of D floats in and out, the scatter-add
// reads N cotangent rows and writes the rows they touch.  So each row is
// copied by one warp, consecutive lanes on consecutive floats (coalesced).
//
// Gather: out[i] = table[clamp(ids[i], 0, V - 1)] for a flat int64 id list.
// Two forms: f32 (a float a lane) and bf16 (embedding_gather_bf16: rows
// copied in the table's dtype, as the JAX kernel does, 16 bytes = 8 bf16
// a lane; D % 8 == 0 and 16-byte aligned rows).  At the text
// classifier's 8,192 ids of [30000, 128] bf16 a row is 256 bytes, 16
// lanes of one 16-byte copy each.
//
// Scatter-add: out[id] += sum of rows[j] over every j with ids[j] == id,
// ids outside [0, V) contributing nothing.  The sum must not depend on
// the order in which warps run (an atomicAdd would), so the wrapper
// stable-sorts the ids first (sorted, perm).  One block per sorted
// position: the block at the start of a run of equal ids sums that run
// and adds it to the output row once; the others return.  A run can be
// long (a batch's padding positions all hold id 0), so its 8 warps take
// every 8th entry, each in order, with the row indices fetched a warp
// load at a time and broadcast by shuffles (8 row loads in flight a lane),
// and the warps' sums are added in warp order.  Reruns are bit-identical.
// Two forms, one template on the table's and the rows' types: f32
// (embedding_scatter_add_f32) and a bf16 table with f32 or bf16 rows
// (embedding_scatter_add_bf16), as the JAX kernel takes them
// (tpp/embedding.py:176-189): the rows are read as f32 and summed in f32,
// the table row is read as f32 and added, and the result is rounded to
// bf16 once.  At the text classifier's 8,192 ids into [30000, 128] a bf16
// table row is 256 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ table,
              const long long* __restrict__ ids, float* __restrict__ out,
              int N, int V, int D) {
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= N) return;
  long long id = ids[i];
  id = id < 0 ? 0 : (id >= V ? V - 1 : id);
  const float* src = table + id * D;
  float* dst = out + (size_t)i * D;
  for (int d = lane; d < D; d += 32) dst[d] = src[d];
}

// the bf16 rows as 16-byte groups of 8 elements (D8 = D / 8 a row)
__global__ void __launch_bounds__(kThreads)
gather_bf16_kernel(const uint4* __restrict__ table,
                   const long long* __restrict__ ids, uint4* __restrict__ out,
                   int N, int V, int D8) {
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= N) return;
  long long id = ids[i];
  id = id < 0 ? 0 : (id >= V ? V - 1 : id);
  const uint4* src = table + id * D8;
  uint4* dst = out + (size_t)i * D8;
  for (int d = lane; d < D8; d += 32) dst[d] = src[d];
}

constexpr int kRunWarps = 8;
constexpr int kCols = 128;            // columns a pass: 4 a lane

// out: the table (O), rows (R); the run's f32 sum is added to the table
// row read as f32 and stored in O once
template <typename O, typename R>
__global__ void __launch_bounds__(kRunWarps * 32)
scatter_add_kernel(O* __restrict__ out,
                   const long long* __restrict__ sorted,
                   const long long* __restrict__ perm,
                   const R* __restrict__ rows, int N, int V, int D) {
  const int i = blockIdx.x;
  const long long id = sorted[i];
  if (id < 0 || id >= V || (i > 0 && sorted[i - 1] == id)) return;
  __shared__ int end_s;
  __shared__ float part[kRunWarps][kCols];
  if (threadIdx.x == 0) end_s = N;
  __syncthreads();
  // the run's end: the first later position holding another id
  for (int j = i + 1 + threadIdx.x; j < N; j += blockDim.x) {
    if (sorted[j] != id) {
      atomicMin(&end_s, j);
      break;
    }
    if (j > *(volatile int*)&end_s) break;
  }
  __syncthreads();
  const int end = end_s;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  O* dst = out + id * D;
  for (int d0 = 0; d0 < D; d0 += kCols) {
    float acc[kCols / 32] = {0.f, 0.f, 0.f, 0.f};
    // entries i + warp + 8 n, n ascending, 32 row indices a warp load
    for (int j0 = i + warp; j0 < end; j0 += 32 * kRunWarps) {
      const int mine = j0 + kRunWarps * lane;
      const long long p = mine < end ? perm[mine] : 0;
      const int n = min(32, (end - j0 + kRunWarps - 1) / kRunWarps);
#pragma unroll 8
      for (int e = 0; e < n; ++e) {
        const R* src = rows + __shfl_sync(0xffffffffu, p, e) * D + d0;
#pragma unroll
        for (int q = 0; q < kCols / 32; ++q) {
          const int d = d0 + lane + 32 * q;
          if (d < D) acc[q] += to_f(src[lane + 32 * q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kCols / 32; ++q) part[warp][lane + 32 * q] = acc[q];
    __syncthreads();
    if (threadIdx.x < kCols && d0 + threadIdx.x < D) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kRunWarps; ++w) sum += part[w][threadIdx.x];
      store(dst + d0 + threadIdx.x, to_f(dst[d0 + threadIdx.x]) + sum);
    }
    __syncthreads();
  }
}

int blocks_for(int n) { return (n + kWarps - 1) / kWarps; }

}  // namespace

extern "C" int embedding_gather_f32(const float* table, const long long* ids,
                                    float* out, int N, int V, int D,
                                    void* stream) {
  if (N <= 0 || V <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  gather_kernel<<<blocks_for(N), kThreads, 0, (cudaStream_t)stream>>>(
      table, ids, out, N, V, D);
  return (int)cudaGetLastError();
}

// table and out bf16 [V, D] and [N, D], D % 8 == 0, 16-byte aligned
extern "C" int embedding_gather_bf16(const void* table, const long long* ids,
                                     void* out, int N, int V, int D,
                                     void* stream) {
  if (N <= 0 || V <= 0 || D <= 0 || D % 8) return (int)cudaErrorInvalidValue;
  gather_bf16_kernel<<<blocks_for(N), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(table), ids, static_cast<uint4*>(out), N, V,
      D / 8);
  return (int)cudaGetLastError();
}

extern "C" int embedding_scatter_add_f32(float* out, const long long* sorted,
                                         const long long* perm,
                                         const float* rows, int N, int V,
                                         int D, void* stream) {
  if (N <= 0 || V <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  scatter_add_kernel<float, float>
      <<<N, kRunWarps * 32, 0, (cudaStream_t)stream>>>(out, sorted, perm,
                                                       rows, N, V, D);
  return (int)cudaGetLastError();
}

// out: the bf16 table [V, D], in place; rows [N, D] bf16 (rows_bf16 != 0)
// or f32
extern "C" int embedding_scatter_add_bf16(void* out, const long long* sorted,
                                          const long long* perm,
                                          const void* rows, int rows_bf16,
                                          int N, int V, int D, void* stream) {
  if (N <= 0 || V <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  if (rows_bf16)
    scatter_add_kernel<bf16, bf16><<<N, kRunWarps * 32, 0, st>>>(
        o, sorted, perm, static_cast<const bf16*>(rows), N, V, D);
  else
    scatter_add_kernel<bf16, float><<<N, kRunWarps * 32, 0, st>>>(
        o, sorted, perm, static_cast<const float*>(rows), N, V, D);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Large-vocabulary softmax cross-entropy: the per-row log-sum-exp and NLL
// (forward) and the logits' gradient (backward), one row a block.
//
// Replaces paddle_tpu/ops/pallas/softmax_xent.py::softmax_xent (the
// pallas_call of _lse_kernel: a grid (row blocks, vocabulary tiles) whose
// vocabulary axis runs in order on one core, an online max and sum-exp
// carried in VMEM scratch from tile to tile; and of _dlogits_kernel:
// (exp(x - lse) - onehot) * g tile by tile).
//
// Layout: logits [N, V] f32 or bf16 row-major (V = 50,257 at the LM's
// vocabulary: odd, so rows are not 16-byte aligned); targets [N] int64;
// lse, nll and g [N] f32; dlogits [N, V] in the logits' type.  A target
// outside [0, V) is read nowhere: its row's NLL is NaN (as the JAX
// package's gather fills past V) and its gradient has no onehot term.
//
// Two forms, one template on the logits' type.  f32 (softmax_xent_fwd_f32
// / _bwd_f32): every load a scalar one, coalesced across the block.  bf16
// (softmax_xent_fwd_bf16 / _bwd_bf16, the JAX kernel's bf16 logits,
// softmax_xent.py:106-108): a bf16 row of the LM (100,514 bytes) starts
// only 2-byte aligned, so each row is read as a scalar head up to its
// first 16-byte boundary, a body of 16-byte groups of 8 elements and a
// scalar tail; the max, sum-exp, lse and NLL are f32 as in the f32 form,
// and the gradient (exp(x - lse) - onehot) g is computed in f32 and
// rounded to bf16 once (:126).  dlogits is written in 16-byte groups
// where its rows lie as the logits' do against 16 bytes (the wrapper's
// fresh output and contiguous logits), else element by element.
//
// What bounds it on an H100: bytes.  The forward reads the logits once
// (3.29 GB at [16 * 1023, 50257] f32: 0.98 ms at 3.35 TB/s; 0.49 ms in
// bf16) and does a few operations an element; the backward reads them
// once and writes the gradient once (1.96 ms f32, 0.98 ms bf16).  The TPU's sequential vocabulary axis becomes
// a loop inside the block: each thread keeps an online (max, sum-exp) over
// the columns it strides through, four loads in flight, and the block
// combines the threads' pairs in a fixed tree (warp shuffles, then warp 0
// over the warps), so a rerun gives the same bits.  The row's target
// logit is read once by thread 0.  No atomics; every output is written by
// one thread.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kUnroll = 4;
constexpr int kUnrollV = 2;          // 16-byte groups in flight a thread
constexpr float kNegInf = -1e30f;   // the JAX kernel's NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// (m, s) <- the online pair of (m, s) and (m2, s2): s * e^(m - max) +
// s2 * e^(m2 - max).  An empty pair is (kNegInf, 0).
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

// one element into the thread's online pair: one exp an element
__device__ __forceinline__ void online(float& m, float& s, float v) {
  if (v > m) {                 // rescale the sum
    s = s * expf(m - v) + 1.f;
    m = v;
  } else {
    s += expf(v - m);
  }
}

// The thread's online pair over its columns of an f32 row: column j0 + q
// kThreads, kUnroll loads in flight.
__device__ __forceinline__ void row_pair(const float* row, int V, float& m,
                                         float& s) {
  for (int j0 = threadIdx.x; j0 < V; j0 += kThreads * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int j = j0 + q * kThreads;
      v[q] = j < V ? __ldg(row + j) : kNegInf;
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q)
      if (j0 + q * kThreads < V) online(m, s, v[q]);
  }
}

// A bf16 row at p: `head` elements up to its first 16-byte boundary, then
// n8 groups of 8, then the tail from `tail`.
struct Split {
  int head, n8, tail;
  __device__ Split(const bf16* p, int V) {
    const int h = (int)(((16u - ((uintptr_t)p & 15u)) & 15u) >> 1);
    head = min(V, h);
    n8 = (V - head) / 8;
    tail = head + 8 * n8;
  }
};

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 p = __bfloat1622float2(h[k]);
    f[2 * k] = p.x;
    f[2 * k + 1] = p.y;
  }
}

// The thread's online pair over its elements of a bf16 row: the head and
// the tail element by element, the body 16 bytes a load.
__device__ __forceinline__ void row_pair(const bf16* row, int V, float& m,
                                         float& s) {
  const Split sp(row, V);
  if ((int)threadIdx.x < sp.head) online(m, s, to_f(row[threadIdx.x]));
  const uint4* body = reinterpret_cast<const uint4*>(row + sp.head);
  for (int q0 = threadIdx.x; q0 < sp.n8; q0 += kThreads * kUnrollV) {
    uint4 v[kUnrollV];
#pragma unroll
    for (int u = 0; u < kUnrollV; ++u) {
      const int q = q0 + u * kThreads;
      v[u] = q < sp.n8 ? __ldg(body + q) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnrollV; ++u) {
      if (q0 + u * kThreads >= sp.n8) continue;
      float f[8];
      unpack8(v[u], f);
#pragma unroll
      for (int k = 0; k < 8; ++k) online(m, s, f[k]);
    }
  }
  const int j = sp.tail + threadIdx.x;
  if (j < V) online(m, s, to_f(row[j]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lse_kernel(const T* __restrict__ logits,
           const long long* __restrict__ targets, float* __restrict__ lse,
           float* __restrict__ nll, int V) {
  __shared__ float red_m[kThreads / 32], red_s[kThreads / 32];
  const T* row = logits + (size_t)blockIdx.x * V;
  float m = kNegInf, s = 0.f;
  row_pair(row, V, m, s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, m2, s2);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? red_m[lane] : kNegInf;
    s = lane < kThreads / 32 ? red_s[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
      merge(m, s, m2, s2);
    }
    if (lane == 0) {
      const float l = m + logf(fmaxf(s, 1e-30f));
      const long long tgt = targets[blockIdx.x];
      lse[blockIdx.x] = l;
      nll[blockIdx.x] =
          tgt >= 0 && tgt < V ? l - to_f(row[tgt]) : CUDART_NAN_F;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dlogits_kernel(const float* __restrict__ logits,
               const long long* __restrict__ targets,
               const float* __restrict__ lse, const float* __restrict__ g,
               float* __restrict__ dlogits, int V) {
  const size_t off = (size_t)blockIdx.x * V;
  const float l = lse[blockIdx.x], gr = g[blockIdx.x];
  const long long tgt = targets[blockIdx.x];
  for (int j0 = threadIdx.x; j0 < V; j0 += kThreads * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int j = j0 + q * kThreads;
      v[q] = j < V ? __ldg(logits + off + j) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int j = j0 + q * kThreads;
      if (j < V)
        dlogits[off + j] = (expf(v[q] - l) - (j == tgt ? 1.f : 0.f)) * gr;
    }
  }
}

// The bf16 gradient: each entry (exp(x - lse) - onehot) g in f32, rounded
// once.  vec_out: dlogits' rows lie as the logits' do against 16 bytes,
// so the body is stored 16 bytes at a time.
__global__ void __launch_bounds__(kThreads)
dlogits_bf16_kernel(const bf16* __restrict__ logits,
                    const long long* __restrict__ targets,
                    const float* __restrict__ lse,
                    const float* __restrict__ g, bf16* __restrict__ dlogits,
                    int V, int vec_out) {
  const size_t off = (size_t)blockIdx.x * V;
  const bf16* row = logits + off;
  bf16* out = dlogits + off;
  const float l = lse[blockIdx.x], gr = g[blockIdx.x];
  const long long tgt = targets[blockIdx.x];
  const Split sp(row, V);
  if ((int)threadIdx.x < sp.head) {
    const int j = threadIdx.x;
    out[j] = __float2bfloat16_rn(
        (expf(to_f(row[j]) - l) - (j == tgt ? 1.f : 0.f)) * gr);
  }
  const uint4* body = reinterpret_cast<const uint4*>(row + sp.head);
  for (int q0 = threadIdx.x; q0 < sp.n8; q0 += kThreads * kUnrollV) {
    uint4 v[kUnrollV];
#pragma unroll
    for (int u = 0; u < kUnrollV; ++u) {
      const int q = q0 + u * kThreads;
      v[u] = q < sp.n8 ? __ldg(body + q) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnrollV; ++u) {
      const int q = q0 + u * kThreads;
      if (q >= sp.n8) continue;
      float f[8];
      unpack8(v[u], f);
      const int j0 = sp.head + 8 * q;
      __align__(16) bf16 r[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        r[k] = __float2bfloat16_rn(
            (expf(f[k] - l) - (j0 + k == tgt ? 1.f : 0.f)) * gr);
      if (vec_out) {
        *reinterpret_cast<uint4*>(out + j0) = *reinterpret_cast<uint4*>(r);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) out[j0 + k] = r[k];
      }
    }
  }
  const int j = sp.tail + threadIdx.x;
  if (j < V)
    out[j] = __float2bfloat16_rn(
        (expf(to_f(row[j]) - l) - (j == tgt ? 1.f : 0.f)) * gr);
}

bool valid(int N, int V) { return N > 0 && V > 0; }

}  // namespace

// lse, nll: [N] outputs.
extern "C" int softmax_xent_fwd_f32(const float* logits,
                                    const long long* targets, float* lse,
                                    float* nll, int N, int V, void* stream) {
  if (!valid(N, V)) return (int)cudaErrorInvalidValue;
  lse_kernel<float><<<N, kThreads, 0, (cudaStream_t)stream>>>(
      logits, targets, lse, nll, V);
  return (int)cudaGetLastError();
}

// g [N]: the cotangent of each row's NLL; dlogits [N, V] output.
extern "C" int softmax_xent_bwd_f32(const float* logits,
                                    const long long* targets,
                                    const float* lse, const float* g,
                                    float* dlogits, int N, int V,
                                    void* stream) {
  if (!valid(N, V)) return (int)cudaErrorInvalidValue;
  dlogits_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
      logits, targets, lse, g, dlogits, V);
  return (int)cudaGetLastError();
}

// logits [N, V] bf16 (2-byte aligned); lse, nll: [N] f32 outputs.
extern "C" int softmax_xent_fwd_bf16(const void* logits,
                                     const long long* targets, float* lse,
                                     float* nll, int N, int V,
                                     void* stream) {
  if (!valid(N, V)) return (int)cudaErrorInvalidValue;
  lse_kernel<bf16><<<N, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(logits), targets, lse, nll, V);
  return (int)cudaGetLastError();
}

// logits, dlogits [N, V] bf16; lse, g [N] f32.
extern "C" int softmax_xent_bwd_bf16(const void* logits,
                                     const long long* targets,
                                     const float* lse, const float* g,
                                     void* dlogits, int N, int V,
                                     void* stream) {
  if (!valid(N, V)) return (int)cudaErrorInvalidValue;
  const int vec_out =
      (((uintptr_t)logits ^ (uintptr_t)dlogits) & 15u) == 0u;
  dlogits_bf16_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(logits), targets, lse, g,
      static_cast<bf16*>(dlogits), V, vec_out);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Large-vocabulary softmax cross-entropy: the per-row log-sum-exp and NLL
// (forward) and the logits' gradient (backward), one row a block.
//
// Replaces paddle_tpu/ops/pallas/softmax_xent.py::softmax_xent (the
// pallas_call of _lse_kernel: a grid (row blocks, vocabulary tiles) whose
// vocabulary axis runs in order on one core, an online max and sum-exp
// carried in VMEM scratch from tile to tile; and of _dlogits_kernel:
// (exp(x - lse) - onehot) * g tile by tile).
//
// Layout: logits [N, V] f32 row-major (V = 50,257 at the LM's vocabulary:
// odd, so rows are not 16-byte aligned and every load here is a scalar
// one, coalesced across the block); targets [N] int64; lse, nll and g [N]
// f32; dlogits [N, V] f32.  A target outside [0, V) is read nowhere: its
// row's NLL is NaN (as the JAX package's gather fills past V) and its
// gradient has no onehot term.
//
// What bounds it on an H100: bytes.  The forward reads the logits once
// (3.29 GB at [16 * 1023, 50257]: 0.98 ms at 3.35 TB/s) and does a few
// operations an element; the backward reads them once and writes the
// gradient once (1.96 ms).  The TPU's sequential vocabulary axis becomes
// a loop inside the block: each thread keeps an online (max, sum-exp) over
// the columns it strides through, four loads in flight, and the block
// combines the threads' pairs in a fixed tree (warp shuffles, then warp 0
// over the warps), so a rerun gives the same bits.  The row's target
// logit is read once by thread 0.  No atomics; every output is written by
// one thread.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;
constexpr float kNegInf = -1e30f;   // the JAX kernel's NEG_INF

// (m, s) <- the online pair of (m, s) and (m2, s2): s * e^(m - max) +
// s2 * e^(m2 - max).  An empty pair is (kNegInf, 0).
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

__global__ void __launch_bounds__(kThreads)
lse_kernel(const float* __restrict__ logits,
           const long long* __restrict__ targets, float* __restrict__ lse,
           float* __restrict__ nll, int V) {
  __shared__ float red_m[kThreads / 32], red_s[kThreads / 32];
  const float* row = logits + (size_t)blockIdx.x * V;
  float m = kNegInf, s = 0.f;
  for (int j0 = threadIdx.x; j0 < V; j0 += kThreads * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int j = j0 + q * kThreads;
      v[q] = j < V ? __ldg(row + j) : kNegInf;
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      if (j0 + q * kThreads >= V) continue;
      if (v[q] > m) {              // one exp an element: rescale the sum
        s = s * expf(m - v[q]) + 1.f;
        m = v[q];
      } else {
        s += expf(v[q] - m);
      }
    }
  }
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
      nll[blockIdx.x] = tgt >= 0 && tgt < V ? l - row[tgt] : CUDART_NAN_F;
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

bool valid(int N, int V) { return N > 0 && V > 0; }

}  // namespace

// lse, nll: [N] outputs.
extern "C" int softmax_xent_fwd_f32(const float* logits,
                                    const long long* targets, float* lse,
                                    float* nll, int N, int V, void* stream) {
  if (!valid(N, V)) return (int)cudaErrorInvalidValue;
  lse_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(logits, targets, lse,
                                                      nll, V);
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

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Fused CTC forward-backward and greedy decode.
//
// Replaces paddle_tpu/ops/pallas/ctc.py: the pallas_call of _ctc_kernel
// (reached from ctc_loss_fused) and of _decode_kernel (reached from
// ctc_greedy_decode_fused).  The TPU kernel walks a grid (batch blocks,
// 2 phases, T) in order on one core: phase 0 ascends t (optional
// log-softmax, the emission gather as a one-hot contraction, the alpha
// recursion into a [T, bb, S] VMEM slab), phase 1 descends t (the beta
// recursion and the gradient gamma / p scattered back to the classes).
//
// Here a block owns one batch row and loops over t inside, so the grid
// needs no order: rows are independent.  A row's alpha and emission slabs
// [T][S] and its per-frame log-normalizers live in shared memory (24 x 33
// floats each on the OCR CRNN's path); past the wrapper's budget they go
// to a scratch buffer in device memory that the wrapper allocates.  The
// emission is a direct gather at the extended labels (the one-hot
// contraction was a TPU workaround).  The log-add keeps the exact form
// m + log1p(exp(min - m)) and every step the max(., NEG_INF) pins of the
// TPU kernel, so infeasible rows report the sentinel loss with an
// exactly-zero gradient.  Every gradient element is written once, by the
// block of its row, and the block reductions run in a fixed order: no
// atomics, a rerun gives the same bits.
//
// What bounds it on an H100: neither bytes nor operations.  It reads the
// [B, T, V] slab and writes the [B, T, V] gradient once (0.33 MB at the
// CRNN's [64, 24, 27]: 0.1 us of HBM time), but the recursions are a
// serial chain of 2T steps, each a few dependent transcendentals and a
// block barrier.  The design keeps that chain inside one launch.
//
// The decode kernel computes the whole contract of the fused decode in one
// launch: (ids [B, T] int32, the kept frames first and -1 after them,
// lengths [B] int32).  A block owns one row and walks T in chunks of
// kDecChunk frames.  In a chunk each warp takes frames in turn, its lanes
// reading the frame's V scores in coalesced runs of 32 and reducing
// (value, index) by shuffles to the argmax in torch.argmax's order (NaN
// first, then the larger value, then the lower index).  Then thread f of
// the block decides keep = best != blank && best != best[t-1] && t <
// ilen (best[-1] = -1, the chunk's first frame against the carried argmax
// of the one before), and writes its id at the row's kept count so far
// plus the exclusive scan of keep over the chunk (a ballot per warp, the
// warps' counts in shared memory).  The count carries to the next chunk;
// the tail of the row gets -1 at the end.  Every output position is
// written once, with no atomics: a rerun gives the same bits.  The lengths
// are read in the dtype they come in (int32 or int64).
//
// What bounds it on an H100: launch latency.  At the CRNN's [64, 24, 27]
// it reads 166 KB (0.05 us of HBM time); the nine launches of the argmax,
// the keep mask and the torch compaction it replaces cost more than that
// each.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
// The 48 KB a launch may take without an opt-in holds the block's static
// reduction buffer (33 floats) beside the dynamic row workspace; 256 bytes
// are kept back for it.  ops/kernels/ctc.py's _SMEM_BUDGET is this value.
constexpr size_t kDynSmemMax = 48 * 1024 - 256;

__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(fminf(a, b) - m));
}

// Block-wide max / sum in a fixed order (warp shuffles, then warp 0 over
// the warps' results); every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : v + w;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nw ? red[lane] : (kMax ? -CUDART_INF_F : 0.f);
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, v, o);
      v = kMax ? fmaxf(v, w) : v + w;
    }
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

__global__ void __launch_bounds__(kThreads)
ctc_fwd_bwd_kernel(const float* __restrict__ logp, const int* __restrict__ ext,
                   const int* __restrict__ skip, const int* __restrict__ valid,
                   const int* __restrict__ ilen, const int* __restrict__ llen,
                   float* __restrict__ loss, float* __restrict__ grad,
                   float* scratch, int T, int V, int S, int normalize) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const size_t per_row = 2 * (size_t)T * S + T + 3 * (size_t)S;
  float* alpha = scratch != nullptr ? scratch + b * per_row : smem;  // [T][S]
  float* emit = alpha + (size_t)T * S;                               // [T][S]
  float* lse = emit + (size_t)T * S;                                 // [T]
  float* beta0 = lse + T;                                            // [S]
  float* beta1 = beta0 + S;                                          // [S]
  float* post = beta1 + S;                                           // [S]
  const float* x = logp + (size_t)b * T * V;
  const int* e = ext + (size_t)b * S;
  const int* sk = skip + (size_t)b * S;
  const int* va = valid + (size_t)b * S;
  const int il = ilen[b], ll = llen[b];

  // every frame's log-normalizer (normalize) and emissions
  for (int t = 0; t < T; ++t) {
    const float* xt = x + (size_t)t * V;
    float l = 0.f;
    if (normalize) {
      float m = -CUDART_INF_F;
      for (int v = tid; v < V; v += nt) m = fmaxf(m, xt[v]);
      m = block_reduce<true>(m, red);
      float sum = 0.f;
      for (int v = tid; v < V; v += nt) sum += expf(xt[v] - m);
      l = m + logf(block_reduce<false>(sum, red));
    }
    if (tid == 0) lse[t] = l;
    for (int s = tid; s < S; s += nt) {
      const int c = min(max(e[s], 0), V - 1);
      emit[(size_t)t * S + s] = xt[c] - l;
    }
  }
  __syncthreads();

  // alpha, up in t; frozen past the row's input length
  for (int s = tid; s < S; s += nt)
    alpha[s] = (s == 0 || (s == 1 && ll > 0)) ? emit[s] : kNegInf;
  for (int t = 1; t < T; ++t) {
    __syncthreads();
    const float* prev = alpha + (size_t)(t - 1) * S;
    float* cur = alpha + (size_t)t * S;
    for (int s = tid; s < S; s += nt) {
      float a = prev[s];
      if (t < il) {
        const float f1 = s >= 1 ? prev[s - 1] : kNegInf;
        const float f2 = (s >= 2 && sk[s]) ? prev[s - 2] : kNegInf;
        const float n = lae(lae(a, f1), f2) + emit[(size_t)t * S + s];
        a = va[s] ? fmaxf(n, kNegInf) : kNegInf;
      }
      cur[s] = a;
    }
  }
  __syncthreads();
  const float* last = alpha + (size_t)(T - 1) * S;
  const float a_last = last[min(2 * ll, S - 1)];
  const float a_prev = ll > 0 ? last[min(2 * ll - 1, S - 1)] : kNegInf;
  const float lik = fmaxf(lae(a_last, a_prev), kNegInf);
  if (tid == 0) loss[b] = -lik;
  const bool feasible = lik > kNegInf * 0.5f;

  // beta, down in t (emission excluded), and the gradient of each frame
  float* bc = beta0;
  float* bn = beta1;
  for (int tr = T - 1; tr >= 0; --tr) {
    const float* en = emit + (size_t)(tr + 1) * S;
    for (int s = tid; s < S; s += nt) {
      const bool fin = s == 2 * ll || (s == 2 * ll - 1 && ll > 0);
      const float finv = fin ? 0.f : kNegInf;
      float bv;
      if (tr == T - 1) {
        bv = il - 1 == tr ? finv : kNegInf;
      } else {
        const float t0 = bc[s] + en[s];
        const float t1 = s + 1 < S ? bc[s + 1] + en[s + 1] : kNegInf;
        const float t2 = (s + 2 < S && sk[s + 2]) ? bc[s + 2] + en[s + 2]
                                                  : kNegInf;
        float trans = fmaxf(lae(lae(t0, t1), t2), kNegInf);
        trans = va[s] ? trans : kNegInf;
        bv = il - 1 == tr ? finv : trans;
      }
      bn[s] = bv;
      float g = alpha[(size_t)tr * S + s] + bv - lik;
      g = feasible ? g : kNegInf;
      post[s] = (e[s] >= 0 && e[s] < V) ? expf(fminf(g, 0.f)) : 0.f;
    }
    __syncthreads();
    // contrib[v] = the posteriors of the positions labelled v, in s order
    const float* xt = x + (size_t)tr * V;
    float* gr = grad + ((size_t)b * T + tr) * V;
    float total = 0.f;
    if (normalize) {
      float part = 0.f;
      for (int v = tid; v < V; v += nt)
        for (int s = 0; s < S; ++s)
          if (e[s] == v) part += post[s];
      total = block_reduce<false>(part, red);
    }
    for (int v = tid; v < V; v += nt) {
      float c = 0.f;
      for (int s = 0; s < S; ++s)
        if (e[s] == v) c += post[s];
      float g = normalize ? expf(xt[v] - lse[tr]) * total - c : -c;
      gr[v] = tr < il ? g : 0.f;
    }
    __syncthreads();   // post and bn are rewritten next step
    float* tmp = bc;
    bc = bn;
    bn = tmp;
  }
}

constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecChunk = kDecThreads;   // frames a chunk: a thread each

// (v, i) comes before (w, j) in torch.argmax's order: NaN is the largest,
// then the larger value, then the lower index
__device__ __forceinline__ bool beats(float v, int i, float w, int j) {
  const bool nv = isnan(v), nw = isnan(w);
  if (nv != nw) return nv;
  if (!nv && v != w) return v > w;
  return i < j;
}

__global__ void __launch_bounds__(kDecThreads)
ctc_decode_kernel(const float* __restrict__ logp, const void* __restrict__ ilen,
                  int len64, int* __restrict__ ids, int* __restrict__ lens,
                  int T, int V, int blank) {
  __shared__ int best_s[kDecChunk];
  __shared__ int warp_n[kDecWarps];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long il = len64 ? static_cast<const long long*>(ilen)[b]
                             : static_cast<const int*>(ilen)[b];
  const float* x = logp + (size_t)b * T * V;
  int* out = ids + (size_t)b * T;
  int prev = -1;   // the argmax of the frame before this chunk
  int kept = 0;    // the frames kept before this chunk
  for (int t0 = 0; t0 < T; t0 += kDecChunk) {
    const int n = min(kDecChunk, T - t0);
    for (int f = warp; f < n; f += kDecWarps) {
      const float* row = x + (size_t)(t0 + f) * V;
      float bv = -CUDART_INF_F;
      int bi = 0x7fffffff;
      for (int v = lane; v < V; v += 32) {
        const float y = __ldg(row + v);
        if (beats(y, v, bv, bi)) {
          bv = y;
          bi = v;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float w = __shfl_xor_sync(0xffffffffu, bv, o);
        const int j = __shfl_xor_sync(0xffffffffu, bi, o);
        if (beats(w, j, bv, bi)) {
          bv = w;
          bi = j;
        }
      }
      if (lane == 0) best_s[f] = bi;
    }
    __syncthreads();
    const int best = tid < n ? best_s[tid] : -1;
    const int before = tid == 0 ? prev : best_s[tid - 1];
    const bool keep = tid < n && best != blank && best != before &&
                      t0 + tid < il;
    const unsigned mine = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_n[warp] = __popc(mine);
    __syncthreads();
    int base = kept;   // this warp's first slot in the row
    int total = 0;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const int c = warp_n[w];
      base += w < warp ? c : 0;
      total += c;
    }
    if (keep) out[base + __popc(mine & ((1u << lane) - 1u))] = best;
    kept += total;
    prev = best_s[n - 1];
    __syncthreads();   // best_s and warp_n are rewritten by the next chunk
  }
  for (int p = kept + tid; p < T; p += kDecThreads) out[p] = -1;
  if (tid == 0) lens[b] = kept;
}

}  // namespace

// logp [B, T, V] f32; ext, skip, valid [B, S] int32 (the tables of
// ops/ctc.ctc_tables, the last two 0/1); ilen, llen [B] int32; loss [B],
// grad [B, T, V] out.  scratch: null (the row's workspace in shared
// memory) or B * (2 T S + T + 3 S) floats.
extern "C" int ctc_fwd_bwd_f32(const float* logp, const int* ext,
                               const int* skip, const int* valid,
                               const int* ilen, const int* llen, float* loss,
                               float* grad, float* scratch, int B, int T,
                               int V, int S, int normalize, void* stream) {
  if (B <= 0 || T <= 0 || V <= 0 || S < 3) return (int)cudaErrorInvalidValue;
  const size_t per_row = 2 * (size_t)T * S + T + 3 * (size_t)S;
  const size_t smem = scratch != nullptr ? 0 : sizeof(float) * per_row;
  if (smem > kDynSmemMax) return (int)cudaErrorInvalidValue;
  ctc_fwd_bwd_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      logp, ext, skip, valid, ilen, llen, loss, grad, scratch, T, V, S,
      normalize);
  return (int)cudaGetLastError();
}

// logp [B, T, V] f32, ilen [B] int32 (len64 0) or int64 (len64 1); ids
// [B, T] and lens [B] int32 out.
extern "C" int ctc_decode_f32(const float* logp, const void* ilen, int len64,
                              int* ids, int* lens, int B, int T, int V,
                              int blank, void* stream) {
  if (B <= 0 || T <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  ctc_decode_kernel<<<B, kDecThreads, 0, (cudaStream_t)stream>>>(
      logp, ilen, len64, ids, lens, T, V, blank);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

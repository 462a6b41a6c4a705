// Ragged paged attention, one decode step: one query per (sequence, head)
// over a paged KV cache.
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::ragged_paged_attention
// (the Pallas _decode_kernel: grid (B, H, pages), page table and lengths in
// scalar prefetch, online softmax carried in VMEM scratch across pages).
//
// What bounds it on an H100: bytes.  Per live row and head it reads
// seq_len * D floats of K and as many of V and does about 4 * D flops per
// token (q.k and p*v): half a flop per byte, far below the ~20 flop/byte
// at which f32 FMA, not HBM, would set the pace.  So the design reads each
// resident K/V byte once, with consecutive lanes on consecutive floats of a
// token row (coalesced), and never touches a page past seq_len.  Scores are
// never stored: the softmax runs online in registers.
//
// Layout: q [B, H, D]; k_pages / v_pages [H, P, page_size, D] (one layer);
// page_table [B, max_pages] int32; seq_lens [B] int32 (the tokens resident,
// including the one being decoded); out [B, H, D].  Page 0 is the null page:
// rows with seq_len == 0 never read it and write exact zeros.
//
// Grid: one block per (b, h), four warps.  Warp w takes tokens w, w + 4, ...
// of the sequence (a page's tokens are split across the warps); each lane
// holds D / 32 dims of q and of the accumulator.  Per token: a partial dot,
// a warp all-reduce, the online-softmax update.  The warps' (m, l, acc)
// partials are combined in shared memory at the end.  The TPU kernel's
// 8-sublane query broadcast is a TPU tiling artifact and is not copied.
//
// The bf16 form (paged_attention_bf16; q, the pools and out bf16) rounds
// where the Pallas kernel rounds with bf16 operands: q.k in f32, p rounded
// to bf16 before p.V against the running max of WHOLE pages, l summed from
// the unrounded p, out rounded once.  So it walks the pages in order with
// the online softmax updated once a page, as the Pallas grid does; the f32
// form's split of the tokens over four warps would round p against a
// per-warp max.  Bytes bound it twice as hard as f32 (2 B an element):
// each thread loads 8 bf16 (16 bytes) of a token row at a time, G lanes
// (G = D / 8 rounded up to a power of two) cover a row, and 128 / G rows
// of a page are read at once.  A page's scores are reduced over the G
// lanes by shuffles and meet in shared memory for the page max; each
// thread keeps an f32 accumulator of its 8 dims over its rows, and the
// row groups' accumulators are summed at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxPerLane = 4;  // head_dim <= 128
constexpr float kNegInf = -1e30f;

__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ k_pages,
                    const float* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ seq_lens,
                    float* __restrict__ out,
                    int H, int P, int page_size, int D, int max_pages,
                    float scale) {
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* o = out + ((size_t)b * H + h) * D;
  // a length past the table row would read past it: clamp to the row
  const int seq_len = min(seq_lens[b], max_pages * page_size);
  if (seq_len <= 0) {
    for (int d = threadIdx.x; d < D; d += blockDim.x) o[d] = 0.f;
    return;
  }

  const float* qrow = q + ((size_t)b * H + h) * D;
  float qr[kMaxPerLane], acc[kMaxPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < D ? qrow[d] : 0.f;
    acc[i] = 0.f;
  }

  float m = kNegInf, l = 0.f;
  const int* pt = page_table + (size_t)b * max_pages;
  const size_t head_off = (size_t)h * P * page_size * D;
  for (int t = warp; t < seq_len; t += kWarps) {
    int page = pt[t / page_size];
    if ((unsigned)page >= (unsigned)P) page = 0;  // never read out of bounds
    const size_t row = head_off + ((size_t)page * page_size + t % page_size) * D;
    const float* kr = k_pages + row;
    const float* vr = v_pages + row;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) part = fmaf(qr[i], kr[d], part);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    const float s = part * scale;
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * corr + p;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) acc[i] = fmaf(p, vr[d], acc[i] * corr);
    }
    m = m_new;
  }

  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][32 * kMaxPerLane];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) sm_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();

  // a warp that got no token has m = kNegInf, l = 0: its weight is 0
  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  float wt[kWarps], total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wt[w] = expf(sm_m[w] - mx);
    total += sm_l[w] * wt[w];
  }
  const float safe_l = fmaxf(total, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a = fmaf(sm_acc[w][d], wt[w], a);
    o[d] = a / safe_l;
  }
}

constexpr int kBf16Threads = 128;

__device__ __forceinline__ void unpack8(const uint4& u, float f[8]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h2[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Dynamic shared memory: s[page_size], p[page_size], then the row groups'
// accumulators [128 / G][D] for the final sum.
__global__ void __launch_bounds__(kBf16Threads)
paged_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k_pages,
                         const __nv_bfloat16* __restrict__ v_pages,
                         const int* __restrict__ page_table,
                         const int* __restrict__ seq_lens,
                         __nv_bfloat16* __restrict__ out,
                         int H, int P, int page_size, int D, int max_pages,
                         int group, float scale) {
  extern __shared__ float smem[];
  float* s_sm = smem;
  float* p_sm = smem + page_size;
  float* part_sm = smem + 2 * page_size;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int rows = kBf16Threads / group;  // token rows read at once
  const int r0 = tid / group;             // this thread's row of a pass
  const int c = tid % group;              // its 8-wide chunk of the row
  const bool has_chunk = c * 8 < D;
  __nv_bfloat16* o = out + ((size_t)b * H + h) * D;
  // a length past the table row would read past it: clamp to the row
  const int seq_len = min(seq_lens[b], max_pages * page_size);
  if (seq_len <= 0) {
    for (int d = tid; d < D; d += kBf16Threads) o[d] = __float2bfloat16(0.f);
    return;
  }

  float qf[8], acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) qf[e] = acc[e] = 0.f;
  if (has_chunk)
    unpack8(*reinterpret_cast<const uint4*>(q + ((size_t)b * H + h) * D +
                                            c * 8), qf);

  float m = kNegInf, l = 0.f;
  const int* pt = page_table + (size_t)b * max_pages;
  const size_t head_off = (size_t)h * P * page_size * D;
  const int npages = (seq_len + page_size - 1) / page_size;
  for (int i = 0; i < npages; ++i) {
    int page = pt[i];
    if ((unsigned)page >= (unsigned)P) page = 0;  // never read out of bounds
    const size_t base = head_off + (size_t)page * page_size * D + c * 8;
    // the page's scores; every lane runs every pass (the shuffles)
    for (int rb = 0; rb < page_size; rb += rows) {
      const int r = rb + r0;
      float dot = 0.f;
      if (has_chunk && r < page_size) {
        float kf[8];
        unpack8(__ldg(reinterpret_cast<const uint4*>(
                    k_pages + base + (size_t)r * D)), kf);
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qf[e], kf[e], dot);
      }
      for (int off = group >> 1; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (c == 0 && r < page_size)
        s_sm[r] = i * page_size + r < seq_len ? dot * scale : kNegInf;
    }
    __syncthreads();
    float mx = kNegInf;
    for (int r = 0; r < page_size; ++r) mx = fmaxf(mx, s_sm[r]);
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] *= corr;
    for (int r = r0; r < page_size; r += rows) {
      const float p = expf(s_sm[r] - m_new);
      if (c == 0) p_sm[r] = p;
      if (has_chunk) {
        const float pb = __bfloat162float(__float2bfloat16(p));
        float vf[8];
        unpack8(__ldg(reinterpret_cast<const uint4*>(
                    v_pages + base + (size_t)r * D)), vf);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(pb, vf[e], acc[e]);
      }
    }
    __syncthreads();
    float sum = 0.f;
    for (int r = 0; r < page_size; ++r) sum += p_sm[r];
    l = l * corr + sum;
    m = m_new;
  }

  if (has_chunk) {
#pragma unroll
    for (int e = 0; e < 8; ++e) part_sm[r0 * D + c * 8 + e] = acc[e];
  }
  __syncthreads();
  const float safe_l = fmaxf(l, 1e-30f);
  for (int d = tid; d < D; d += kBf16Threads) {
    float a = 0.f;
    for (int rr = 0; rr < rows; ++rr) a += part_sm[rr * D + d];
    o[d] = __float2bfloat16(a / safe_l);
  }
}

}  // namespace

extern "C" int paged_attention_bf16(const void* q, const void* k_pages,
                                    const void* v_pages,
                                    const int* page_table, const int* seq_lens,
                                    void* out, int B, int H, int P,
                                    int page_size, int D, int max_pages,
                                    float scale, void* stream) {
  if (B <= 0 || H <= 0 || D <= 0 || D > 128 || D % 8 || page_size <= 0)
    return (int)cudaErrorInvalidValue;
  int group = 1;
  while (group * 8 < D) group <<= 1;
  const size_t smem =
      sizeof(float) * (2 * (size_t)page_size + (kBf16Threads / group) * D);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  paged_bf16_kernel<<<B * H, kBf16Threads, smem,
                             (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages), page_table, seq_lens,
      static_cast<__nv_bfloat16*>(out), H, P, page_size, D, max_pages, group,
      scale);
  return (int)cudaGetLastError();
}

extern "C" int paged_attention_f32(const float* q, const float* k_pages,
                                   const float* v_pages,
                                   const int* page_table, const int* seq_lens,
                                   float* out, int B, int H, int P,
                                   int page_size, int D, int max_pages,
                                   float scale, void* stream) {
  if (B <= 0 || H <= 0 || D <= 0 || D > 32 * kMaxPerLane)
    return (int)cudaErrorInvalidValue;
  paged_decode_kernel<<<B * H, kWarps * 32, 0, (cudaStream_t)stream>>>(
      q, k_pages, v_pages, page_table, seq_lens, out, H, P, page_size, D,
      max_pages, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

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

}  // namespace

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

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
// at which f32 FMA, not HBM, would set the pace.  So each form reads each
// resident K/V byte once, coalesced, and never touches a page past
// seq_len.
//
// Layout: q [B, H, D]; k_pages / v_pages [H, P, page_size, D] (one layer);
// page_table [B, max_pages] int32; seq_lens [B] int32 (the tokens resident,
// including the one being decoded); out [B, H, D].  Page 0 is the null page:
// rows with seq_len == 0 never read it and write exact zeros.  The TPU
// kernel's 8-sublane query broadcast is a TPU tiling artifact and is not
// copied.
//
// The f32 form (paged_attention_f32, the split namespace below) splits
// each (b, h) over chunks of whole pages, one block a chunk, and combines
// the chunks in the same launch.
//
// The bf16 form (paged_attention_bf16; q, the pools and out bf16) rounds
// where the Pallas kernel rounds with bf16 operands: q.k in f32, p rounded
// to bf16 before p.V against the running max of WHOLE pages, l summed from
// the unrounded p, out rounded once.  So it walks the pages in order with
// the online softmax updated once a page, as the Pallas grid does; the f32
// form's split of the tokens over chunks would round p against a
// chunk's max.  Bytes bound it twice as hard as f32 (2 B an element):
// each thread loads 8 bf16 (16 bytes) of a token row at a time, G lanes
// (G = D / 8 rounded up to a power of two) cover a row, and 128 / G rows
// of a page are read at once.  A page's scores are reduced over the G
// lanes by shuffles and meet in shared memory for the page max; each
// thread keeps an f32 accumulator of its 8 dims over its rows, and the
// row groups' accumulators are summed at the end.

#include <climits>
#include <cstdint>
#include <cuda/atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;

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

// ---------------------------------------------------------------------------
// The f32 form (paged_attention_f32): split over the sequence, one launch.
//
// A decode step reads each resident K/V float once and does ~4 flops a
// float pair, so bytes bound it (the bound at serving's shape, [32, 12,
// 64], page 16, 7,936 resident tokens, is ~15 us).  To stream at HBM's
// rate the card needs a few MB of loads in flight; one block a (b, h)
// walking its tokens one at a time kept under 0.4 MB in flight and ran
// ~10x its bound, the longest row holding its block to the end.  So:
// - Work split: block (bh, c) takes chunk c of whole pages of one (b, h),
//   chunk_pages pages (the wrapper's rule, paged_attention.py
//   pages_per_chunk); the grid is (B*H, ceil(max_pages / chunk_pages)),
//   fixed by the table's width, so the lengths stay on the card.  A block
//   whose chunk starts at or past its row's seq_len (clamped to the
//   table's row) exits at once.
// - Inside a block: G lanes a token row (G = D / 4 rounded up to a power
//   of two), each lane 4 floats of it, so 128 / G rows are read at once
//   (at D 64 a warp reads 2 rows a load), and each thread issues
//   kInFlight row loads before it reduces any.  K rows are read 16 bytes
//   a lane where D % 4 == 0 and q and the pools are 16-byte aligned, else
//   as 4-byte units (Unit<1>, the same template).  Scores of a window of
//   kWindow tokens go to shared memory; the window max by a warp
//   reduction, p = exp(s - m) once a token, the running (m, l) and each
//   thread's f32 accumulator of its 4 dims over its rows rescaled as the
//   windows go; V rows are read as K's; the row groups' accumulators are
//   summed at the end in order.
// - The combine, in the same launch: a row with one live chunk writes out
//   = acc / max(l, 1e-30) itself.  Otherwise each live chunk writes (m, l,
//   acc[D]) to the workspace (kept per device and stream by the wrapper)
//   and draws a ticket of its (b, h) (an acquire-release atomic at device
//   scope); the chunk that draws the last combines the live chunks in
//   chunk order (a rerun gives the same bits), writes out, and resets the
//   ticket to 0 for the next launch (so a captured graph replays right).
//   Rows with seq_len == 0 write exact zeros.  Out-of-range page ids read
//   page 0.
namespace split {

constexpr int kThreads = 128;
constexpr int kWindow = 64;    // tokens whose scores shared memory holds
constexpr int kInFlight = 4;   // row loads a thread issues before reducing

// 4 floats of a row a thread: one 16-byte unit (V = 4, dims 4c .. 4c + 3)
// or four 4-byte units (V = 1, dims c, c + G, c + 2G, c + 3G)
template <int V>
__device__ __forceinline__ int dim_of(int c, int i, int G) {
  return V == 4 ? 4 * c + i : c + G * i;
}

template <int V>
__device__ __forceinline__ void load4(float (&x)[4], const float* row,
                                      int c, int G, int D) {
  if constexpr (V == 4) {
    if (4 * c < D) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(row) + c);
      x[0] = u.x;
      x[1] = u.y;
      x[2] = u.z;
      x[3] = u.w;
    } else {
      x[0] = x[1] = x[2] = x[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = c + G * i;
      x[i] = d < D ? __ldg(row + d) : 0.f;
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const float* __restrict__ q,
                   const float* __restrict__ k_pages,
                   const float* __restrict__ v_pages,
                   const int* __restrict__ page_table,
                   const int* __restrict__ seq_lens, float* __restrict__ out,
                   float* __restrict__ ws, unsigned int* __restrict__ tickets,
                   int H, int P, int page_size, int D, int max_pages,
                   int chunk_pages, int G, float scale) {
  __shared__ float s_sm[kWindow], p_sm[kWindow];
  __shared__ float acc_sm[kThreads * 4];  // [row group][lane][4]
  __shared__ bool last;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, chunk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int R = kThreads / G, r0 = tid / G, c = tid % G;
  float* o = out + (size_t)bh * D;
  // a length past the table row would read past it: clamp to the row
  const int seq_len = min(seq_lens[b], max_pages * page_size);
  if (seq_len <= 0) {
    if (chunk == 0)
      for (int d = tid; d < D; d += kThreads) o[d] = 0.f;
    return;
  }
  const int chunk_tokens = chunk_pages * page_size;
  const int n_live = (seq_len + chunk_tokens - 1) / chunk_tokens;
  if (chunk >= n_live) return;
  const int t0 = chunk * chunk_tokens;
  const int t1 = min(seq_len, t0 + chunk_tokens);

  const int* pt = page_table + (size_t)b * max_pages;
  const size_t head = (size_t)h * P;
  auto row_of = [&](const float* pool, int tok) {
    int page = pt[tok / page_size];
    if ((unsigned)page >= (unsigned)P) page = 0;  // never read out of bounds
    return pool + ((head + page) * page_size + tok % page_size) * D;
  };

  float qv[4], acc[4] = {0.f, 0.f, 0.f, 0.f};
  load4<V>(qv, q + (size_t)bh * D, c, G, D);
  float m = kNegInf, l = 0.f;
  for (int w0 = t0; w0 < t1; w0 += kWindow) {
    const int n = min(kWindow, t1 - w0);
    // the window's scores: kInFlight row loads a thread, then the dots,
    // each reduced over its row's G lanes (every lane runs every pass)
    for (int rb = 0; rb < n; rb += R * kInFlight) {
      float x[kInFlight][4];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int r = rb + r0 + R * u;
        if (r < n) {
          load4<V>(x[u], row_of(k_pages, w0 + r), c, G, D);
        } else {
          x[u][0] = x[u][1] = x[u][2] = x[u][3] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) dot = fmaf(qv[i], x[u][i], dot);
        for (int off = G >> 1; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const int r = rb + r0 + R * u;
        if (c == 0 && r < n) s_sm[r] = dot * scale;
      }
    }
    __syncthreads();
    float mx = kNegInf;
    for (int r = lane; r < n; r += 32) mx = fmaxf(mx, s_sm[r]);
    const float m_new = fmaxf(m, warp_max(mx));
    const float corr = expf(m - m_new);
    if (tid < n) p_sm[tid] = expf(s_sm[tid] - m_new);
    __syncthreads();
    float ps = 0.f;
    for (int r = lane; r < n; r += 32) ps += p_sm[r];
    l = l * corr + warp_sum(ps);
    m = m_new;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] *= corr;
    // acc += p v over the thread's rows of the window
    for (int rb = 0; rb < n; rb += R * kInFlight) {
      float x[kInFlight][4];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int r = rb + r0 + R * u;
        if (r < n) load4<V>(x[u], row_of(v_pages, w0 + r), c, G, D);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int r = rb + r0 + R * u;
        if (r < n) {
          const float p = p_sm[r];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i] = fmaf(p, x[u][i], acc[i]);
        }
      }
    }
  }

  // the row groups' accumulators, summed in order of the group
#pragma unroll
  for (int i = 0; i < 4; ++i) acc_sm[tid * 4 + i] = acc[i];
  __syncthreads();
  float a = 0.f;
  if (tid < D) {
    const int cd = V == 4 ? tid / 4 : tid % G, id = V == 4 ? tid % 4 : tid / G;
    for (int r = 0; r < R; ++r) a += acc_sm[(r * G + cd) * 4 + id];
  }
  if (n_live == 1) {  // the row's only chunk: no partials, no ticket
    if (tid < D) o[tid] = a / fmaxf(l, 1e-30f);
    return;
  }
  const int splits = gridDim.y, stride = D + 2;
  float* base = ws + (size_t)bh * splits * stride;
  if (tid < D) base[chunk * stride + 2 + tid] = a;
  if (tid == 0) {
    base[chunk * stride] = m;
    base[chunk * stride + 1] = l;
  }

  // The ticket, one acquire-release atomic: it releases the block's
  // partial (the barrier orders every writer's before it) and, in the
  // last block, acquires the others' (the barrier orders every reader
  // after it).
  __syncthreads();
  if (tid == 0) {
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> ticket(
        tickets[bh]);
    last = ticket.fetch_add(1u, cuda::memory_order_acq_rel) ==
           (unsigned)(n_live - 1);
  }
  __syncthreads();
  if (!last) return;

  // The combine: the live chunks in chunk order
  float mx = kNegInf;
  for (int cc = 0; cc < n_live; ++cc) mx = fmaxf(mx, __ldcg(base + cc * stride));
  float lsum = 0.f, asum = 0.f;
  for (int cc = 0; cc < n_live; ++cc) {
    const float* pc = base + cc * stride;
    const float w = expf(__ldcg(pc) - mx);  // chunk cc's correction
    lsum += __ldcg(pc + 1) * w;
    if (tid < D) asum += __ldcg(pc + 2 + tid) * w;
  }
  if (tid < D) o[tid] = asum / fmaxf(lsum, 1e-30f);
  if (tid == 0) tickets[bh] = 0;  // ready for the next launch
}

}  // namespace split

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

// q [B, H, D], pools [H, P, page_size, D], out [B, H, D] f32; the
// table and lengths int32; ws at least B*H*ceil(max_pages / chunk_pages)
// * (D + 2) floats; tickets B*H counters, all 0 (and 0 again after the
// launch)
extern "C" int paged_attention_f32(const float* q, const float* k_pages,
                                   const float* v_pages,
                                   const int* page_table, const int* seq_lens,
                                   float* out, float* ws, unsigned int* tickets,
                                   int B, int H, int P, int page_size, int D,
                                   int max_pages, int chunk_pages, float scale,
                                   void* stream) {
  if (B <= 0 || H <= 0 || D <= 0 || D > 128 || page_size <= 0 ||
      max_pages < 0 || chunk_pages <= 0 || (long long)B * H > INT_MAX ||
      (long long)max_pages * page_size > INT_MAX)
    return (int)cudaErrorInvalidValue;
  int G = 1;
  while (4 * G < D) G <<= 1;  // lanes a row: 4 floats a lane
  const int splits =
      max_pages > 0 ? (max_pages + chunk_pages - 1) / chunk_pages : 1;
  const dim3 grid(B * H, splits);
  const bool wide = D % 4 == 0 && ((reinterpret_cast<uintptr_t>(q) |
                                    reinterpret_cast<uintptr_t>(k_pages) |
                                    reinterpret_cast<uintptr_t>(v_pages)) &
                                   15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    split::paged_split_kernel<4><<<grid, split::kThreads, 0, s>>>(
        q, k_pages, v_pages, page_table, seq_lens, out, ws, tickets, H, P,
        page_size, D, max_pages, chunk_pages, G, scale);
  else
    split::paged_split_kernel<1><<<grid, split::kThreads, 0, s>>>(
        q, k_pages, v_pages, page_table, seq_lens, out, ws, tickets, H, P,
        page_size, D, max_pages, chunk_pages, G, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

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
// to bf16 before p.V against the running max of WHOLE pages 0..i, l summed
// from the unrounded p, out rounded once.  It splits each (b, h) over the
// same kind of chunks in two launches (the split16 namespace below): the
// scores and page maxes first, so that each chunk can form the running
// max of every one of its pages.

#include <climits>
#include <cstdint>
#include <cuda/atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;

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

// ---------------------------------------------------------------------------
// The bf16 form (paged_attention_bf16): split over the sequence, in two
// launches.
//
// Bytes bound it twice as hard as f32 (2 B an element: the bound at
// serving's shape is ~7.3 us).  The Pallas kernel rounds p = exp(s - m_i)
// to bf16 before p.V, where m_i is the running max over pages 0..i of the
// row; a chunk that starts at page j > 0 cannot know that max from its
// own tokens, and rounding against a chunk's own max is another function.
// So the row's page maxes are published first:
// - Work split (both launches): block (bh, c) takes chunk c of whole
//   pages of one (b, h), chunk_pages pages (paged_attention.py
//   pages_per_chunk at CHUNK_TOKENS_BF16); the grid is (B*H, ceil(
//   max_pages / chunk_pages)), fixed by the table's width, so the lengths
//   stay on the card; a block whose chunk starts at or past its row's
//   seq_len (clamped to the table's row) exits at once.
// - Pass 1, scores (paged_bf16_scores_kernel): each live chunk reads its
//   K rows once, 16 bytes (8 bf16) a lane, G = D / 8 lanes a row (rounded
//   up to a power of two), 128 / G rows a pass and kInFlight row loads a
//   thread issued before any is reduced; q.k in f32, reduced over the G
//   lanes by shuffles, scaled; past seq_len nothing is read.  It writes
//   its tokens' scores and each of its pages' max (over the tokens below
//   seq_len) to the workspace.
// - Pass 2, p.V and the combine (paged_bf16_pv_kernel): each live chunk
//   reads the page maxes of pages 0..its last, takes the max of those
//   before it (a block reduction) and each of its pages' running max m_i
//   by a max scan (warp 0), exactly the m the Pallas grid carries into
//   page i.  A token's p = exp(s - m_i) is rounded to bf16 for p.V and
//   taken unrounded for l; both are carried to the chunk's last running
//   max m_c by the page's weight exp(m_i - m_c) (the twin's page-by-page
//   rescale acc = acc exp(m - m') + ..., in closed form).  V rows are read
//   as pass 1 reads K, each thread's f32 accumulator of its 8 dims over
//   its rows, the row groups' accumulators summed in order at the end.
// - The combine (the f32 form's): a row with one live chunk writes out =
//   acc / max(l, 1e-30) rounded to bf16 once.  Otherwise each live chunk
//   writes (m_c, l, acc[D]) to the workspace and draws its row's ticket
//   (an acquire-release atomic at device scope); the last combines the
//   live chunks in chunk order (a rerun gives the same bits), rounds out
//   to bf16 once and resets the ticket to 0.  Rows with seq_len == 0
//   write exact zeros.  Out-of-range page ids read page 0.
// The two launches run in stream order inside one C call: no spin, no
// host sync.  The scores add 4 B a token and head to the 2 D B of K and V
// (+1.6% at D 64).  ptxas (sm_90a): 64 registers each, 4 B (scores) and 8
// B (p.V) spilled, p.V 4,128 B of static shared memory.  At serving's
// shape 8 pages a chunk and 8 row loads in flight ran fastest (chip_ab.py
// --paged-chunks, --paged-bf16-variants).
namespace split16 {

constexpr int kThreads = 128;
constexpr int kInFlight = 8;   // 16-byte row loads a thread issues first
// pass 2's static shared memory (the row groups' accumulators, the
// warps' sums, the ticket's flag) beside the dynamic p and page arrays
constexpr int kStaticBytes = kThreads * 8 * 4 + 64;

__device__ __forceinline__ void unpack8(const uint4& u, float f[8]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h2[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Row `tok` of one head's pool, at the 8 dims of lane c
__device__ __forceinline__ const uint4* row8(const __nv_bfloat16* pool,
                                             const int* pt, size_t head,
                                             int P, int page_size, int D,
                                             int tok, int c) {
  int page = pt[tok / page_size];
  if ((unsigned)page >= (unsigned)P) page = 0;  // never read out of bounds
  return reinterpret_cast<const uint4*>(
      pool + ((head + page) * page_size + tok % page_size) * D + c * 8);
}

// Dynamic shared memory: the chunk's scores [chunk_pages * page_size]
__global__ void __launch_bounds__(kThreads)
paged_bf16_scores_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k_pages,
                         const int* __restrict__ page_table,
                         const int* __restrict__ seq_lens,
                         float* __restrict__ scores,
                         float* __restrict__ page_max, int H, int P,
                         int page_size, int D, int max_pages,
                         int chunk_pages, int G, float scale) {
  extern __shared__ float s_sm[];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, chunk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = kThreads / G, r0 = tid / G, c = tid % G;
  const bool has = c * 8 < D;
  const int row_tokens = max_pages * page_size;
  // a length past the table row would read past it: clamp to the row
  const int seq_len = min(seq_lens[b], row_tokens);
  const int chunk_tokens = chunk_pages * page_size;
  const int t0 = chunk * chunk_tokens;
  if (t0 >= seq_len) return;   // past the row (or an idle row)
  const int n = min(seq_len - t0, chunk_tokens);
  const int* pt = page_table + (size_t)b * max_pages;
  const size_t head = (size_t)h * P;

  float qf[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) qf[e] = 0.f;
  if (has)
    unpack8(*reinterpret_cast<const uint4*>(q + (size_t)bh * D + c * 8), qf);
  // the chunk's scores: kInFlight row loads a thread, then the dots, each
  // reduced over its row's G lanes (every lane runs every pass)
  for (int rb = 0; rb < n; rb += R * kInFlight) {
    uint4 x[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int r = rb + r0 + R * u;
      x[u] = has && r < n
                 ? __ldg(row8(k_pages, pt, head, P, page_size, D, t0 + r, c))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      float kf[8];
      unpack8(x[u], kf);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) dot = fmaf(qf[e], kf[e], dot);
      for (int off = G >> 1; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int r = rb + r0 + R * u;
      if (c == 0 && r < n) s_sm[r] = scale * dot;  // the scaled score
    }
  }
  __syncthreads();
  float* sc = scores + (size_t)bh * row_tokens + t0;
  for (int i = tid; i < n; i += kThreads) sc[i] = s_sm[i];
  // each page's max over its tokens below seq_len, a warp a page
  const int p0 = t0 / page_size, npg = (n + page_size - 1) / page_size;
  for (int j = warp; j < npg; j += kThreads / 32) {
    const int end = min(n, (j + 1) * page_size);
    float mx = kNegInf;
    for (int i = j * page_size + lane; i < end; i += 32)
      mx = fmaxf(mx, s_sm[i]);
    mx = split::warp_max(mx);
    if (lane == 0) page_max[(size_t)bh * max_pages + p0 + j] = mx;
  }
}

// Dynamic shared memory: each token's weight of its V row [chunk_pages *
// page_size], then each page's running max and weight [chunk_pages] each
__global__ void __launch_bounds__(kThreads)
paged_bf16_pv_kernel(const __nv_bfloat16* __restrict__ v_pages,
                     const int* __restrict__ page_table,
                     const int* __restrict__ seq_lens,
                     const float* __restrict__ scores,
                     const float* __restrict__ page_max,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ part,
                     unsigned int* __restrict__ tickets, int H, int P,
                     int page_size, int D, int max_pages, int chunk_pages,
                     int G) {
  extern __shared__ float dyn[];
  __shared__ float acc_sm[kThreads * 8];  // [row group][lane][8]
  __shared__ float red[kThreads / 32];
  __shared__ bool last;
  const int chunk_tokens = chunk_pages * page_size;
  float* p_sm = dyn;
  float* m_pg = dyn + chunk_tokens;
  float* w_pg = m_pg + chunk_pages;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, chunk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = kThreads / G, r0 = tid / G, c = tid % G;
  const bool has = c * 8 < D;
  __nv_bfloat16* o = out + (size_t)bh * D;
  const int row_tokens = max_pages * page_size;
  const int seq_len = min(seq_lens[b], row_tokens);
  if (seq_len <= 0) {
    if (chunk == 0)
      for (int d = tid; d < D; d += kThreads) o[d] = __float2bfloat16(0.f);
    return;
  }
  const int n_live = (seq_len + chunk_tokens - 1) / chunk_tokens;
  if (chunk >= n_live) return;
  const int t0 = chunk * chunk_tokens;
  const int n = min(seq_len - t0, chunk_tokens);
  const int p0 = t0 / page_size, npg = (n + page_size - 1) / page_size;
  const float* pm = page_max + (size_t)bh * max_pages;

  // the running max the Pallas grid carries into the chunk: the max of
  // pages 0 .. p0 - 1, a block reduction
  float mx = kNegInf;
  for (int j = tid; j < p0; j += kThreads) mx = fmaxf(mx, pm[j]);
  mx = split::warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  if (warp == 0) {
    // each page's running max m_i = max(m_{i-1}, the page's max): an
    // inclusive max scan from the chunk's carry in
    float carry = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
    for (int j0 = 0; j0 < npg; j0 += 32) {
      const int j = j0 + lane;
      float m = j < npg ? pm[p0 + j] : kNegInf;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, m, off);
        if (lane >= off) m = fmaxf(m, y);
      }
      m = fmaxf(m, carry);
      if (j < npg) m_pg[j] = m;
      carry = __shfl_sync(0xffffffffu, m, 31);
    }
    __syncwarp();
    // each page's weight: its running max carried to the chunk's last
    const float m_last = m_pg[npg - 1];
    for (int j = lane; j < npg; j += 32) w_pg[j] = expf(m_pg[j] - m_last);
  }
  __syncthreads();
  const float m_c = m_pg[npg - 1];
  // p against its page's running max: unrounded into l, rounded to bf16
  // for p.V, both carried to m_c by the page's weight
  const float* sc = scores + (size_t)bh * row_tokens + t0;
  float ls = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const int j = i / page_size;
    const float mi = m_pg[j];   // the page's running max
    const float p = expf(__ldg(sc + i) - mi);
    p_sm[i] = __bfloat162float(__float2bfloat16(p)) * w_pg[j];
    ls = fmaf(p, w_pg[j], ls);
  }
  ls = split::warp_sum(ls);
  __syncthreads();   // every warp has read red; p_sm is whole
  if (lane == 0) red[warp] = ls;
  __syncthreads();
  const float l = ((red[0] + red[1]) + red[2]) + red[3];

  // acc += p v over the thread's rows: kInFlight V row loads, then the
  // products
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  const int* pt = page_table + (size_t)b * max_pages;
  const size_t head = (size_t)h * P;
  for (int rb = 0; rb < n; rb += R * kInFlight) {
    uint4 x[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int r = rb + r0 + R * u;
      x[u] = has && r < n
                 ? __ldg(row8(v_pages, pt, head, P, page_size, D, t0 + r, c))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int r = rb + r0 + R * u;
      if (r < n) {
        const float w = p_sm[r];
        float vf[8];
        unpack8(x[u], vf);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(w, vf[e], acc[e]);
      }
    }
  }
  // the row groups' accumulators, summed in order of the group
#pragma unroll
  for (int e = 0; e < 8; ++e) acc_sm[tid * 8 + e] = acc[e];
  __syncthreads();
  float a = 0.f;
  if (tid < D)
    for (int r = 0; r < R; ++r) a += acc_sm[(r * G + tid / 8) * 8 + tid % 8];
  if (n_live == 1) {  // the row's only chunk: no partials, no ticket
    if (tid < D) o[tid] = __float2bfloat16(a / fmaxf(l, 1e-30f));
    return;
  }
  const int splits = gridDim.y, stride = D + 2;
  float* base = part + (size_t)bh * splits * stride;
  if (tid < D) base[chunk * stride + 2 + tid] = a;
  if (tid == 0) {
    base[chunk * stride] = m_c;
    base[chunk * stride + 1] = l;
  }
  // the ticket: releases this chunk's partial, acquires the others' in
  // the last (the barriers order every writer before, every reader after)
  __syncthreads();
  if (tid == 0) {
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> ticket(
        tickets[bh]);
    last = ticket.fetch_add(1u, cuda::memory_order_acq_rel) ==
           (unsigned)(n_live - 1);
  }
  __syncthreads();
  if (!last) return;
  // the combine: the live chunks in chunk order, out rounded once
  float top = kNegInf;
  for (int cc = 0; cc < n_live; ++cc)
    top = fmaxf(top, __ldcg(base + cc * stride));
  float lsum = 0.f, asum = 0.f;
  for (int cc = 0; cc < n_live; ++cc) {
    const float* pc = base + cc * stride;
    const float w = expf(__ldcg(pc) - top);   // the chunk's correction
    lsum += __ldcg(pc + 1) * w;
    if (tid < D) asum += __ldcg(pc + 2 + tid) * w;
  }
  if (tid < D) o[tid] = __float2bfloat16(asum / fmaxf(lsum, 1e-30f));
  if (tid == 0) tickets[bh] = 0u;  // the row's ticket, ready again
}

}  // namespace split16

}  // namespace

// q [B, H, D], pools [H, P, page_size, D], out [B, H, D] bf16 (D % 8 ==
// 0, q and the pools 16-byte aligned); the table and lengths int32; ws at
// least B*H*(max_pages*page_size + max_pages + ceil(max_pages /
// chunk_pages) * (D + 2)) floats (the scores, the page maxes, the
// partials); tickets B*H counters, all 0 (and 0 again after the call).
// Two launches in stream order: the scores, then p.V and the combine.
extern "C" int paged_attention_bf16(const void* q, const void* k_pages,
                                    const void* v_pages,
                                    const int* page_table, const int* seq_lens,
                                    void* out, float* ws,
                                    unsigned int* tickets, int B, int H,
                                    int P, int page_size, int D,
                                    int max_pages, int chunk_pages,
                                    float scale, void* stream) {
  if (B <= 0 || H <= 0 || D <= 0 || D > 128 || D % 8 || page_size <= 0 ||
      max_pages < 0 || chunk_pages <= 0 || (long long)B * H > INT_MAX ||
      (long long)max_pages * page_size > INT_MAX ||
      (long long)chunk_pages * page_size > INT_MAX)
    return (int)cudaErrorInvalidValue;
  using namespace split16;
  const size_t chunk_tokens = (size_t)chunk_pages * page_size;
  const size_t smem1 = sizeof(float) * chunk_tokens;
  const size_t smem2 = sizeof(float) * (chunk_tokens + 2 * (size_t)chunk_pages);
  if (smem2 + kStaticBytes > 48 * 1024) return (int)cudaErrorInvalidValue;
  int G = 1;
  while (8 * G < D) G <<= 1;  // lanes a row: 8 bf16 a lane
  const int splits =
      max_pages > 0 ? (max_pages + chunk_pages - 1) / chunk_pages : 1;
  const dim3 grid(B * H, splits);
  const size_t bh = (size_t)B * H;
  float* scores = ws;
  float* page_max = scores + bh * max_pages * page_size;
  float* part = page_max + bh * max_pages;
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k_pages);
  const auto* vb = static_cast<const __nv_bfloat16*>(v_pages);
  cudaStream_t s = (cudaStream_t)stream;
  paged_bf16_scores_kernel<<<grid, kThreads, smem1, s>>>(
      qb, kb, page_table, seq_lens, scores, page_max, H, P, page_size, D,
      max_pages, chunk_pages, G, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_bf16_pv_kernel<<<grid, kThreads, smem2, s>>>(
      vb, page_table, seq_lens, scores, page_max,
      static_cast<__nv_bfloat16*>(out), part, tickets, H, P, page_size, D,
      max_pages, chunk_pages, G);
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

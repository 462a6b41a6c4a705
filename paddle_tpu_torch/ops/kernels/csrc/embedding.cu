// Embedding row gather and duplicate-exact scatter-add.
//
// Replaces paddle_tpu/ops/pallas/tpp/embedding.py::embedding_gather (one
// row DMA per id, the id list scalar-prefetched into SMEM) and
// ::embedding_scatter_add (a one-hot MXU contraction accumulated over id
// blocks; run after jax.ops.segment_sum in the fused lookup's backward).
//
// What bounds them on an H100: bytes.  Neither does arithmetic worth the
// name: the gather moves N rows of D floats in and out; the scatter-add
// reads the table and N rows and writes a fresh table (JAX's
// embedding_scatter_add returns one: tpp/embedding.py:217 has no alias).
//
// Gather: out[i] = table[clamp(ids[i], 0, V - 1)] for a flat int64 id
// list, and zeros where ids[i] == padding_idx when one is given (the fused
// lookup's forward in one launch: JAX's fused_embedding_lookup zeroes
// those rows after its gather).  Two forms, one template on the copy
// unit: f32 (embedding_gather_f32) and bf16 (embedding_gather_bf16), the
// rows copied in the table's dtype, as the JAX kernel does.  Bytes bound
// it: at the text classifier's 8,192 ids of [30000, 128] the rows are
// 4 MB (f32) or 2 MB (bf16), a microsecond at 3.35 TB/s, so the design
// is about latency and lanes: the N x D output is one run of 16-byte
// units (float4, or 8 bf16) where D and the table allow it (4- and
// 2-byte units otherwise), unit u of row u / W at column u % W, so a
// warp copies 512 contiguous bytes of output whatever D is: several
// rows a warp where a row is shorter (bf16 at D 128: 256 bytes, two
// rows).  Each thread has its units' ids and rows in flight before it
// stores any (kGatherUnroll), and the grid is sized to the card's SMs
// (8 blocks of 256 an SM at most), striding over the rest.
// Scatter-add: out[v] = table[v] + the sum of rows[j] over every j with
// ids[j] == v, ids outside [0, V) contributing nothing, each output row
// written once.  The sum must not depend on the order in which blocks run
// (an atomicAdd's would), so the ids are first grouped by a counting sort
// of their positions, stable, in two passes, and the rows of each group
// are summed in position order, each output row written once:
//   group_sort  one block a chunk of 1,024 positions: the chunk's keys
//               (id << 32 | position; ids out of range sort last) sorted
//               by a bitonic network (shuffles within a warp, shared
//               memory across warps), written out, and
//               each id's count added to counts[id] (integers: the order
//               of the adds does not matter).  The block that finishes
//               last scans counts into offsets[0..V] (an exclusive sum;
//               offsets[V] = the ids in range).
//   group_place one block a chunk: a position's slot is offsets[id], plus
//               the positions of its id in earlier chunks (each earlier
//               key looked up in a table of this chunk's ids in shared
//               memory), plus its rank in its own chunk's run.  So order[] holds each id's positions in
//               increasing order: the stable sort, without a sort library.
//   copy_rows   (blocks of the same launch as group_place: it needs the
//               counts only) every row no id touches, copied from the
//               table 16 bytes a thread where the rows allow it, or zeros
//               for a table gradient.
//   sum_runs    segment warps take 16 consecutive entries of order[] each
//               and sum each run's rows in f32, in position order; a run
//               inside one segment is added to its table row (read as
//               f32) and rounded once.  A run that spans segments (a
//               batch's padding ids: 1,792 of 8,192 in the text row)
//               leaves one f32 partial a segment; the warp that finishes
//               its segments last (an atomic counter a run decides who,
//               not the order) adds the partials in segment order, then
//               the table row, and rounds once.
// Reruns are bit-identical.  All passes launch from one C call on the
// caller's stream, with one memset of the counters; the wrapper passes one
// scratch block (its layout is `Layout` below, mirrored in embedding.py).
// Two forms, one template on the table's and the rows' types: f32
// (embedding_scatter_add_f32) and a bf16 table with f32 or bf16 rows
// (embedding_scatter_add_bf16), as the JAX kernel takes them
// (tpp/embedding.py:176-189): the rows are read as f32 and summed in f32,
// the table row is read as f32 and added, and the result is rounded to
// the table's dtype once.  A null table is a table of zeros (table_grad).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

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

constexpr int kGatherUnroll = 2;  // units a thread holds before storing
constexpr int kGatherChunk = kThreads * kGatherUnroll;

// out[u] for the units u of the chunks blockIdx.x, + gridDim.x, ...: row
// u / W, column u % W of it; a row whose raw id is the padding id (when
// has_pad) is written as zeros and not read.
template <class Unit>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const Unit* __restrict__ table,
              const long long* __restrict__ ids, Unit* __restrict__ out,
              int units, int W, int V, int has_pad, long long pad) {
  for (int base = blockIdx.x * kGatherChunk; base < units;
       base += gridDim.x * kGatherChunk) {
    Unit v[kGatherUnroll];
#pragma unroll
    for (int j = 0; j < kGatherUnroll; ++j) {
      const int u = base + j * kThreads + threadIdx.x;
      if (u < units) {
        const int row = u / W;
        long long id = __ldg(ids + row);
        if (has_pad && id == pad) {
          v[j] = Unit{};
        } else {
          id = id < 0 ? 0 : (id >= V ? V - 1 : id);
          v[j] = __ldg(table + id * W + (u - row * W));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kGatherUnroll; ++j) {
      const int u = base + j * kThreads + threadIdx.x;
      if (u < units) out[u] = v[j];
    }
  }
}

// the card's SMs, asked once a device
int sm_count() {
  static int sms_of[64] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= 64) return 132;
  if (sms_of[device] == 0 &&
      cudaDeviceGetAttribute(&sms_of[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return 132;
  return sms_of[device];
}

template <class Unit>
int gather_units(const void* table, const long long* ids, void* out, int N,
                 int V, int W, int has_pad, long long pad,
                 cudaStream_t stream) {
  if ((long long)N * W > INT_MAX) return (int)cudaErrorInvalidValue;
  const int units = N * W;
  const int blocks = (int)std::min<long long>(
      (units + kGatherChunk - 1) / kGatherChunk, 8LL * sm_count());
  gather_kernel<Unit><<<blocks, kThreads, 0, stream>>>(
      static_cast<const Unit*>(table), ids, static_cast<Unit*>(out), units,
      W, V, has_pad, pad);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The gather of rows of D elements of `elem` bytes: 16-byte units where
// a row is whole 16-byte units and both tables lie on 16 bytes, else the
// element itself (float, or bf16's 2 bytes).
template <class Elem>
int gather(const void* table, const long long* ids, void* out, int N, int V,
           int D, int has_pad, long long pad, void* stream) {
  if (N <= 0 || V <= 0 || D <= 0 || table == nullptr || ids == nullptr ||
      out == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  constexpr int kPer16 = 16 / sizeof(Elem);
  if (D % kPer16 == 0 && aligned(table, 16) && aligned(out, 16))
    return gather_units<uint4>(table, ids, out, N, V, D / kPer16, has_pad,
                               pad, st);
  return gather_units<Elem>(table, ids, out, N, V, D, has_pad, pad, st);
}

// -- grouping ------------------------------------------------------------------

constexpr int kChunk = 1024;        // positions a grouping block
constexpr int kSeg = 16;            // entries of order[] a segment warp
constexpr int kCols = 128;          // columns a pass of a segment warp
constexpr int kCopyBlocks = 132 * 2;  // blocks of 1,024 copying rows
constexpr int kScan = 8;            // counts a thread of the scan sums
constexpr int kUnroll = 4;          // 16-byte copies in flight a thread
constexpr unsigned long long kNoKey = ~0ull;

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
long long up16(long long bytes) { return cdiv(bytes, 16) * 16; }

// The scratch block, section by section, each 16-byte aligned; the
// counters (counts, done, arrive) first, so one memset clears them.
struct Layout {
  long long counts, done, arrive, zeroed, offsets, order, keys, partial,
      total;
  Layout(long long N, long long V, long long D) {
    const long long B = N > 0 ? cdiv(N, kChunk) : 1, S = cdiv(N, kSeg);
    counts = 0;
    done = counts + up16(4 * V);
    arrive = done + 16;
    zeroed = arrive + up16(4 * S);
    offsets = zeroed;
    order = offsets + up16(4 * (V + 1));
    keys = order + up16(4 * N);
    partial = keys + 8 * B * kChunk;
    total = partial + up16(4 * S * 2 * D);
  }
};

__device__ __forceinline__ unsigned key_id(unsigned long long k) {
  return (unsigned)(k >> 32);
}

__global__ void __launch_bounds__(kChunk)
group_sort_kernel(const long long* __restrict__ ids, int N, int V,
                  unsigned long long* __restrict__ keys, int* counts,
                  int* done, int* __restrict__ offsets) {
  __shared__ unsigned long long s[kChunk];
  __shared__ int warp_tot[kChunk / 32];
  __shared__ int carry;
  __shared__ bool last;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const long long i = (long long)blockIdx.x * kChunk + t;
  unsigned long long key = kNoKey;
  if (i < N) {
    const long long id = ids[i];
    if (id >= 0 && id < V)
      key = ((unsigned long long)id << 32) | (unsigned)i;
  }
  // bitonic sort of the chunk's keys, ascending, a key a thread: the
  // partner t ^ j is in the warp for j < 32 (a shuffle), else exchanged
  // through shared memory.  Keys are unique (the position is in them) but
  // for the out-of-range ones, which are equal.
  for (int k = 2; k <= kChunk; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      unsigned long long other;
      if (j >= 32) {
        s[t] = key;
        __syncthreads();
        other = s[t ^ j];
        __syncthreads();
      } else {
        other = __shfl_xor_sync(0xffffffffu, key, j);
      }
      const bool keep_low = ((t & j) == 0) == ((t & k) == 0);
      key = keep_low ? min(key, other) : max(key, other);
    }
  }
  keys[(long long)blockIdx.x * kChunk + t] = key;
  // each id's count in this chunk, added once a warp's run of it
  const unsigned id = key_id(key);
  const unsigned peers = __match_any_sync(0xffffffffu, id);
  if (key != kNoKey && __ffs(peers) - 1 == lane)
    atomicAdd(&counts[id], __popc(peers));
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(done, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the last block: offsets = the exclusive sum of counts, kScan a thread
  // (loaded 16 bytes at a time where a thread's run lies inside [0, V))
  __threadfence();
  if (t == 0) carry = 0;
  for (long long base = 0; base < V; base += kScan * kChunk) {
    const long long v0 = base + kScan * t;
    int4 c[kScan / 4];
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kScan / 4; ++q) {
      const long long v = v0 + 4 * q;
      if (v + 4 <= V) {
        c[q] = __ldcg(reinterpret_cast<const int4*>(counts + v));
      } else {
        c[q].x = v < V ? __ldcg(counts + v) : 0;
        c[q].y = v + 1 < V ? __ldcg(counts + v + 1) : 0;
        c[q].z = v + 2 < V ? __ldcg(counts + v + 2) : 0;
        c[q].w = v + 3 < V ? __ldcg(counts + v + 3) : 0;
      }
      sum += c[q].x + c[q].y + c[q].z + c[q].w;
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += x;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int x = warp_tot[lane];
      int y = x;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int z = __shfl_up_sync(0xffffffffu, y, d);
        if (lane >= d) y += z;
      }
      warp_tot[lane] = y - x;
    }
    __syncthreads();
    int run = carry + warp_tot[warp] + incl - sum;
#pragma unroll
    for (int q = 0; q < kScan / 4; ++q) {
      const long long v = v0 + 4 * q;
      const int4 o = make_int4(run, run + c[q].x, run + c[q].x + c[q].y,
                               run + c[q].x + c[q].y + c[q].z);
      run = o.w + c[q].w;
      if (v + 4 <= V) {
        *reinterpret_cast<int4*>(offsets + v) = o;
      } else {
        if (v < V) offsets[v] = o.x;
        if (v + 1 < V) offsets[v + 1] = o.y;
        if (v + 2 < V) offsets[v + 2] = o.z;
      }
    }
    __syncthreads();
    if (t == kChunk - 1) carry = run;
    __syncthreads();
  }
  if (t == 0) offsets[V] = carry;
}

constexpr int kHash = 2 * kChunk;    // slots of a chunk's id table
constexpr unsigned kEmpty = ~0u;

__device__ __forceinline__ int hash_slot(unsigned id) {
  return (int)((id * 2654435761u) >> 21);  // 11 bits: kHash slots
}

// The positions of each run head's id in earlier chunks are counted with
// a table of this chunk's ids in shared memory (open addressing, one
// entry a run head): each earlier key whose id is in it adds one to its
// head's count (integer adds: their order does not matter).
__device__ __forceinline__ void group_place(
    const unsigned long long* __restrict__ keys, int V,
    const int* __restrict__ offsets, int* __restrict__ order) {
  __shared__ unsigned long long s[kChunk];
  __shared__ unsigned table_id[kHash];
  __shared__ int table_head[kHash];
  __shared__ int prior[kChunk];
  const int t = threadIdx.x, b = blockIdx.x;
  const unsigned long long key = keys[(long long)b * kChunk + t];
  s[t] = key;
  prior[t] = 0;
  for (int i = t; i < kHash; i += kChunk) table_id[i] = kEmpty;
  const unsigned id = key_id(key);
  const bool valid = key != kNoKey && id < (unsigned)V;
  __syncthreads();
  if (valid && (t == 0 || key_id(s[t - 1]) != id)) {
    for (int h = hash_slot(id);; h = (h + 1) & (kHash - 1)) {
      if (atomicCAS(&table_id[h], kEmpty, id) == kEmpty) {
        table_head[h] = t;
        break;
      }
    }
  }
  __syncthreads();
  for (int c0 = 0; c0 < b; c0 += 8) {
    unsigned long long k[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      k[c] = c0 + c < b ? keys[(long long)(c0 + c) * kChunk + t] : kNoKey;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const unsigned other = key_id(k[c]);
      if (k[c] == kNoKey || other >= (unsigned)V) continue;
      for (int h = hash_slot(other); table_id[h] != kEmpty;
           h = (h + 1) & (kHash - 1)) {
        if (table_id[h] == other) {
          atomicAdd(&prior[table_head[h]], 1);
          break;
        }
      }
    }
  }
  __syncthreads();
  if (!valid) return;
  int h = hash_slot(id);
  while (table_id[h] != id) h = (h + 1) & (kHash - 1);
  const int head = table_head[h];
  order[offsets[id] + prior[head] + (t - head)] = (int)(unsigned)key;
}

// The rows no id touches: copied from the table (zeros without one), 16
// bytes a thread where vec (rows of the output a multiple of 16 bytes, out
// and table 16-byte aligned), kUnroll copies issued before any is stored;
// else an element a thread.  Needs only the counts.  first, stride: this
// thread's first 16-byte copy (or element) and the threads' count.
template <typename O>
__device__ __forceinline__ void copy_rows(O* __restrict__ out,
                                          const O* __restrict__ table, int V,
                                          int D, bool vec,
                                          const int* __restrict__ counts,
                                          long long first, long long stride) {
  if (vec) {
    const long long per_row = (long long)D * sizeof(O) / 16;
    const long long total = (long long)V * per_row;
    const uint4* src = reinterpret_cast<const uint4*>(table);
    uint4* dst = reinterpret_cast<uint4*>(out);
    for (long long k0 = first; k0 < total; k0 += kUnroll * stride) {
      uint4 val[kUnroll];
      bool copy[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long k = k0 + u * stride;
        copy[u] = k < total && counts[k / per_row] == 0;
        val[u] = copy[u] && src != nullptr ? src[k]
                                           : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (copy[u]) dst[k0 + u * stride] = val[u];
    }
  } else {
    const long long total = (long long)V * D;
    for (long long k = first; k < total; k += stride) {
      if (counts[k / D]) continue;
      out[k] = table != nullptr ? table[k] : O(0.f);
    }
  }
}

// The second grouping pass (blocks [0, B)) and, beside it, the copy of the
// untouched rows (the rest; none for the grouping alone).
template <typename O>
__global__ void __launch_bounds__(kChunk)
place_copy_kernel(const unsigned long long* __restrict__ keys, int V,
                  const int* __restrict__ offsets, int* __restrict__ order,
                  int B, O* __restrict__ out, const O* __restrict__ table,
                  int D, bool vec, const int* __restrict__ counts) {
  if ((int)blockIdx.x < B) {
    group_place(keys, V, offsets, order);
    return;
  }
  copy_rows(out, table, V, D, vec, counts,
            (long long)(blockIdx.x - B) * kChunk + threadIdx.x,
            (long long)(gridDim.x - B) * kChunk);
}

// Memset of the counters, then the first grouping pass: counts, offsets
// and the chunks' sorted keys.
int group_counts(const long long* ids, char* scratch, const Layout& L, int N,
                 int V, cudaStream_t st) {
  if (cudaError_t e = cudaMemsetAsync(scratch, 0, L.zeroed, st)) return e;
  const int B = N > 0 ? (int)cdiv(N, kChunk) : 1;
  group_sort_kernel<<<B, kChunk, 0, st>>>(
      ids, N, V, reinterpret_cast<unsigned long long*>(scratch + L.keys),
      reinterpret_cast<int*>(scratch + L.counts),
      reinterpret_cast<int*>(scratch + L.done),
      reinterpret_cast<int*>(scratch + L.offsets));
  return (int)cudaGetLastError();
}

// The second grouping pass, order, and beside it (copy_blocks > 0) the
// copy of the untouched rows into out.
template <typename O>
int group_order(char* scratch, const Layout& L, int N, int V,
                cudaStream_t st, int copy_blocks = 0, O* out = nullptr,
                const O* table = nullptr, int D = 0, bool vec = false) {
  const int B = N > 0 ? (int)cdiv(N, kChunk) : 1;
  place_copy_kernel<O><<<B + copy_blocks, kChunk, 0, st>>>(
      reinterpret_cast<const unsigned long long*>(scratch + L.keys), V,
      reinterpret_cast<const int*>(scratch + L.offsets),
      reinterpret_cast<int*>(scratch + L.order), B, out, table, D, vec,
      reinterpret_cast<const int*>(scratch + L.counts));
  return (int)cudaGetLastError();
}

// -- the output pass ---------------------------------------------------------------

template <typename O>
__device__ __forceinline__ float table_at(const O* table, long long i) {
  return table == nullptr ? 0.f : to_f(table[i]);
}

// Four consecutive elements of a row from column d as f32 (zeros past D);
// vec: one 16-byte (f32) or 8-byte (bf16) load, D % 4 == 0 and the rows
// aligned so.
__device__ __forceinline__ void load4(const float* src, int d, int D,
                                      bool vec, float* x) {
  if (vec && d < D) {
    const float4 v = *reinterpret_cast<const float4*>(src + d);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) x[q] = d + q < D ? src[d + q] : 0.f;
}
__device__ __forceinline__ void load4(const bf16* src, int d, int D,
                                      bool vec, float* x) {
  if (vec && d < D) {
    const uint2 v = *reinterpret_cast<const uint2*>(src + d);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) x[q] = d + q < D ? to_f(src[d + q]) : 0.f;
}

constexpr int kRowsInFlight = 8;  // rows a segment warp loads before
                                  // it adds them
constexpr int kInFlight = 16;     // partials a combining warp loads

// A warp a segment of kSeg entries of order[] (8 a block).  vec_rows: D %
// 4 == 0, rows aligned for load4.  Lane l holds columns d0 + 4 l .. d0 +
// 4 l + 3 of the 128 a pass.
template <typename O, typename R>
__global__ void __launch_bounds__(kThreads)
sum_runs_kernel(O* __restrict__ out, const O* __restrict__ table,
                const long long* __restrict__ ids,
                const R* __restrict__ rows, int V, int D, bool vec_rows,
                const int* __restrict__ offsets,
                const int* __restrict__ order, int* arrive,
                float* partial) {
  const int lane = threadIdx.x % 32;
  const int seg = blockIdx.x * kWarps + threadIdx.x / 32;
  const int M = offsets[V];
  const int j0 = seg * kSeg;
  if (j0 >= M) return;  // warp-uniform
  const int n = min(kSeg, M - j0), j1 = j0 + n;
  const int my_pos = lane < n ? order[j0 + lane] : 0;
  const int my_id = lane < n ? (int)ids[my_pos] : -1;
  // a run starts at entry e when its id differs from entry e - 1's
  const int prev_id = __shfl_up_sync(0xffffffffu, my_id, 1);
  const bool my_start = lane < n && (lane == 0 || prev_id != my_id);
  // where the runs at the segment's two ends begin and end: the others
  // lie inside it, their bounds known from the entries alone
  const int head_start = offsets[__shfl_sync(0xffffffffu, my_id, 0)];
  const int tail_end = offsets[__shfl_sync(0xffffffffu, my_id, n - 1) + 1];
  // one run (entries ef..el) on this lane's columns: a complete run
  // added to its table row and stored, a spanning one to this segment's
  // partial slot (1: the run starts here, 0: it started before)
  auto flush = [&](int v, int ef, int el, int d, const float* acc,
                   const float* tab) {
    const int start = ef == 0 ? head_start : j0 + ef;
    const int end = el == n - 1 ? tail_end : j0 + el + 1;
    if (start >= j0 && end <= j1) {
      O* dst = out + (long long)v * D;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (d + q < D) store(dst + d + q, tab[q] + acc[q]);
    } else {
      float* dst = partial + ((long long)seg * 2 + (start >= j0)) * D;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (d + q < D) dst[d + q] = acc[q];
    }
  };
  for (int d0 = 0; d0 < D; d0 += kCols) {
    const int d = d0 + 4 * lane;
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, tab[4] = {0.f, 0.f, 0.f, 0.f};
    int cur = -1, first = 0;
    for (int e0 = 0; e0 < n; e0 += kRowsInFlight) {
      // the rows' loads in flight, and the table row of each run that
      // starts among them, then the adds in position order
      float x[kRowsInFlight][4], t[kRowsInFlight][4];
#pragma unroll
      for (int e = 0; e < kRowsInFlight; ++e) {
        const long long p = __shfl_sync(0xffffffffu, my_pos, e0 + e);
        const int id = __shfl_sync(0xffffffffu, my_id, e0 + e);
        const bool starts = __shfl_sync(0xffffffffu, my_start, e0 + e);
#pragma unroll
        for (int q = 0; q < 4; ++q) x[e][q] = t[e][q] = 0.f;
        if (e0 + e < n) load4(rows + p * D, d, D, vec_rows, x[e]);
        if (e0 + e < n && starts && table != nullptr) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (d + q < D) t[e][q] = to_f(table[(long long)id * D + d + q]);
        }
      }
#pragma unroll
      for (int e = 0; e < kRowsInFlight; ++e) {
        const int id = __shfl_sync(0xffffffffu, my_id, e0 + e);
        if (e0 + e >= n) break;
        if (id != cur) {
          if (cur >= 0) flush(cur, first, e0 + e - 1, d, acc, tab);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[q] = 0.f;
            tab[q] = t[e][q];
          }
          cur = id;
          first = e0 + e;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] += x[e][q];
      }
    }
    flush(cur, first, n - 1, d, acc, tab);
  }
  // the runs that span segments: the last of their segments to get here
  // adds the partials in segment order
  const int head = __shfl_sync(0xffffffffu, my_id, 0);
  const int tail = __shfl_sync(0xffffffffu, my_id, n - 1);
  for (int r = 0; r < 2; ++r) {
    const int v = r == 0 ? head : tail;
    if (r == 1 && tail == head) break;
    const int start = offsets[v], end = offsets[v + 1];
    if (start >= j0 && end <= j1) continue;
    __threadfence();
    __syncwarp();
    const int s0 = start / kSeg, s1 = (end - 1) / kSeg;
    int last = 0;
    if (lane == 0) last = atomicAdd(&arrive[s0], 1) == s1 - s0;
    if (!__shfl_sync(0xffffffffu, last, 0)) continue;
    __threadfence();
    O* dst = out + (long long)v * D;
    for (int d0 = 0; d0 < D; d0 += kCols) {
      const int d = d0 + 4 * lane;
      float sum[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sum[q] = d + q < D
                     ? __ldcg(partial + ((long long)s0 * 2 + 1) * D + d + q)
                     : 0.f;
      // the later segments' partials in order
      for (int s = s0 + 1; s <= s1; s += kInFlight) {
        float x[kInFlight][4];
#pragma unroll
        for (int e = 0; e < kInFlight; ++e) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            x[e][q] = s + e <= s1 && d + q < D
                          ? __ldcg(partial + (long long)(s + e) * 2 * D + d + q)
                          : 0.f;
        }
#pragma unroll
        for (int e = 0; e < kInFlight; ++e) {
          if (s + e > s1) break;
#pragma unroll
          for (int q = 0; q < 4; ++q) sum[q] += x[e][q];
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (d + q < D)
          store(dst + d + q,
                table_at(table, (long long)v * D + d + q) + sum[q]);
    }
  }
}

template <typename O, typename R>
int scatter_add(O* out, const O* table, const long long* ids, const R* rows,
                void* scratch_, long long scratch_bytes, int N, int V, int D,
                void* stream) {
  if (N < 0 || V <= 0 || D <= 0 || out == nullptr ||
      (N > 0 && (ids == nullptr || rows == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Layout L(N, V, D);
  char* scratch = static_cast<char*>(scratch_);
  if (scratch == nullptr || scratch_bytes < L.total)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // the grouping; the untouched rows beside its second pass
  if (int err = group_counts(ids, scratch, L, N, V, st)) return err;
  const bool vec = (long long)D * sizeof(O) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0;
  if (int err = group_order<O>(scratch, L, N, V, st, kCopyBlocks, out, table,
                               D, vec))
    return err;
  const int G = (int)cdiv(cdiv(N, kSeg), kWarps);
  if (G == 0) return 0;
  const bool vec_rows =
      D % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % (4 * sizeof(R)) == 0;
  sum_runs_kernel<O, R><<<G, kThreads, 0, st>>>(
      out, table, ids, rows, V, D, vec_rows,
      reinterpret_cast<const int*>(scratch + L.offsets),
      reinterpret_cast<const int*>(scratch + L.order),
      reinterpret_cast<int*>(scratch + L.arrive),
      reinterpret_cast<float*>(scratch + L.partial));
  return (int)cudaGetLastError();
}

}  // namespace

// table [V, D] and out [N, D] of the form's dtype, contiguous; has_pad 1
// zeroes the rows whose id is pad
extern "C" int embedding_gather_f32(const void* table, const long long* ids,
                                    void* out, int N, int V, int D,
                                    int has_pad, long long pad,
                                    void* stream) {
  return gather<float>(table, ids, out, N, V, D, has_pad, pad, stream);
}

extern "C" int embedding_gather_bf16(const void* table, const long long* ids,
                                     void* out, int N, int V, int D,
                                     int has_pad, long long pad,
                                     void* stream) {
  return gather<unsigned short>(table, ids, out, N, V, D, has_pad, pad,
                                stream);
}

// The grouping alone, into the scratch block (D = 0 in its layout):
// counts [V], offsets [V + 1] and order [offsets[V]].
extern "C" int embedding_group_ids(const long long* ids, void* scratch,
                                   long long scratch_bytes, int N, int V,
                                   void* stream) {
  const Layout L(N, V, 0);
  if (N < 0 || V <= 0 || (N > 0 && ids == nullptr) || scratch == nullptr ||
      scratch_bytes < L.total)
    return (int)cudaErrorInvalidValue;
  char* s = static_cast<char*>(scratch);
  if (int err = group_counts(ids, s, L, N, V, (cudaStream_t)stream))
    return err;
  return group_order<float>(s, L, N, V, (cudaStream_t)stream);
}

// out [V, D] f32, written whole; table [V, D] f32 or null (zeros); rows
// [N, D] f32
extern "C" int embedding_scatter_add_f32(float* out, const float* table,
                                         const long long* ids,
                                         const float* rows, void* scratch,
                                         long long scratch_bytes, int N,
                                         int V, int D, void* stream) {
  return scatter_add<float, float>(out, table, ids, rows, scratch,
                                   scratch_bytes, N, V, D, stream);
}

// out [V, D] bf16, written whole; table [V, D] bf16 or null (zeros); rows
// [N, D] bf16 (rows_bf16 != 0) or f32
extern "C" int embedding_scatter_add_bf16(void* out, const void* table,
                                          const long long* ids,
                                          const void* rows, int rows_bf16,
                                          void* scratch,
                                          long long scratch_bytes, int N,
                                          int V, int D, void* stream) {
  bf16* o = static_cast<bf16*>(out);
  const bf16* t = static_cast<const bf16*>(table);
  if (rows_bf16)
    return scatter_add<bf16, bf16>(o, t, ids, static_cast<const bf16*>(rows),
                                   scratch, scratch_bytes, N, V, D, stream);
  return scatter_add<bf16, float>(o, t, ids, static_cast<const float*>(rows),
                                  scratch, scratch_bytes, N, V, D, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

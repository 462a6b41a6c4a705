// Per-channel sum and sum of squares over all leading axes: the
// training-mode batch-norm moments from one read of x, in one launch.
//
// Replaces paddle_tpu/ops/pallas/tpp/conv.py::channel_stats (the
// pallas_call of _stats_kernel).  That kernel walks 512-row blocks of the
// [R, C] view in order on one core and carries the two [1, C] sums in its
// output block from one grid step to the next; on bf16 input it reads
// bf16 and sums in f32 (:74-76).  Blocks of a CUDA grid run in parallel
// and in no order, so nothing carries between them.  Here each block
// writes partial sums, and the block that finishes last for its columns
// adds them up in a fixed order, in the same launch, with no float
// atomics: a rerun gives the same bits (the rule of the conv kernels'
// statistics epilogue).
//
// The grid: column chunks x P row blocks, both chosen by the wrapper
// (ops/kernels/channel_stats.py's plan) from R, C and the form alone,
// never from the card.  Block (bx, p) owns lanes * V channels from
// bx * lanes * V and the rows [p * rows_per_block, (p + 1) *
// rows_per_block).  Its 256 threads are `lanes` column lanes by 256 /
// lanes row groups: thread (lane, grp) reads V neighbouring channels of
// every (256 / lanes)-th row from row grp, in increasing order, with
// kInFlight rows' loads made before their adds (32 KB in flight a block
// in the 16-byte forms).  The forms: f32 reads 4 channels a thread as one
// float4 where C % 4 == 0 and x is 16-byte aligned; bf16 8 channels as
// one 16-byte load where C % 8 == 0 and x is aligned, converted to f32;
// either dtype one channel a thread otherwise.
//
// A block's row groups are added in a fixed tree (a butterfly over the
// groups of a warp, then the 8 warps in order) and written as partials
// part[0][p][c] = sum x, part[1][p][c] = sum x^2.  Then the last-block
// finish: one thread draws a ticket from its column chunk's counter (an
// acquire-release atomic at device scope); the block that draws ticket
// P - 1 reads the P partials of its columns through L2, adds them in
// order of p through the same tree, writes sum and sumsq and sets the
// counter back to 0 for the next launch.  Which block finishes last
// changes nothing in the bits: only the plan orders the sums.  The
// counters stay on the card between launches (the wrapper keeps them,
// zeroed when allocated, one set per device and stream), so no memset
// runs before a call.  Where one row block covers R (P = 1, the plan's
// choice where the columns alone give the blocks), a block's sums are
// final: no partials, no ticket.
//
// What bounds it on an H100: bytes.  It does 3 flops per element read
// (add, multiply, add) against 4 bytes (2 in bf16), far below the card's
// ~20 f32 flops per byte, so the least time is R * C * 4 bytes over 3.35
// TB/s (33.5 MB, ~0.010 ms, at small_vgg's first [131072, 64] view; half
// in bf16).  The plan gives every small_vgg view at least 256 blocks
// where the work has a 16-byte read a thread for them, so every SM has
// reads in flight; the finish reads P x (the chunk's channels) x 8 bytes
// from L2 on one SM, the tail of the launch.  At the smaller views the
// chain of a launch (x's loads, the partials' stores, the ticket, the
// partials' loads) sets the time, not the bytes.

#include <cuda/atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The launch's parameter block, one field a line in this order
// (ops/kernels/channel_stats.py's StatsParams mirrors it): x in the
// entry's dtype; out [2, C], part [2, P, C] f32; tickets, one per column
// chunk, all 0 between launches.
struct StatsParams {
  const void* x;
  float* out;
  float* part;
  unsigned int* tickets;
  long long R;
  long long rows_per_block;
  int C;
  int P;
  int lanes;
  int vec;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kInFlight = 8;   // rows of x a thread loads before adding

// One read of V channels of a row of x (Raw) and its sums in f32.
template <class T, int V>
struct Io;

template <>
struct Io<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw read(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void add(Raw r, float (&s)[1],
                                             float (&ss)[1]) {
    s[0] += r;
    ss[0] += r * r;
  }
};

template <>
struct Io<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw read(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void add(const Raw& r, float (&s)[4],
                                             float (&ss)[4]) {
    const float f[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      s[v] += f[v];
      ss[v] += f[v] * f[v];
    }
  }
};

template <>
struct Io<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw read(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ void add(Raw r, float (&s)[1],
                                             float (&ss)[1]) {
    const float f = __bfloat162float(__ushort_as_bfloat16(r));
    s[0] += f;
    ss[0] += f * f;
  }
};

template <>
struct Io<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw read(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void add(const Raw& r, float (&s)[8],
                                             float (&ss)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      s[2 * i] += t.x;
      ss[2 * i] += t.x * t.x;
      s[2 * i + 1] += t.y;
      ss[2 * i + 1] += t.y * t.y;
    }
  }
};

// V f32 partials at p, read through L2 (other blocks wrote them).
template <int V>
__device__ __forceinline__ void read_part(const float* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = __ldcg(p);
  } else {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 u = __ldcg(reinterpret_cast<const float4*>(p) + i);
      f[4 * i] = u.x;
      f[4 * i + 1] = u.y;
      f[4 * i + 2] = u.z;
      f[4 * i + 3] = u.w;
    }
  }
}

// Adds the (s, ss) of a block's row groups in a fixed order: a butterfly
// over the groups of each warp, then the warps in order.  Thread t <
// lanes * V ends with the block's sums of the chunk's channel t.
template <int V>
__device__ __forceinline__ void block_sum(float (&s)[V], float (&ss)[V],
                                          int lanes,
                                          float (*sh)[kWarps][32 * V],
                                          float& bs, float& bss) {
  for (int off = 16; off >= lanes; off >>= 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      s[v] += __shfl_xor_sync(0xffffffffu, s[v], off);
      ss[v] += __shfl_xor_sync(0xffffffffu, ss[v], off);
    }
  }
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  if (wl < lanes) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      sh[0][warp][wl * V + v] = s[v];
      sh[1][warp][wl * V + v] = ss[v];
    }
  }
  __syncthreads();
  bs = bss = 0.f;
  if (threadIdx.x < lanes * V) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      bs += sh[0][w][threadIdx.x];
      bss += sh[1][w][threadIdx.x];
    }
  }
}

template <class T, int V>
__global__ void __launch_bounds__(kThreads)
channel_stats_kernel(const T* __restrict__ x, long long R, int C,
                     long long rows_per_block, int P, int lanes,
                     float* __restrict__ part, unsigned int* tickets,
                     float* __restrict__ out) {
  using io = Io<T, V>;
  __shared__ float sh[2][kWarps][32 * V];
  __shared__ bool last;
  const int t = threadIdx.x;
  const int lane = t & (lanes - 1), grp = t / lanes;
  const int groups = kThreads / lanes;
  const int c0 = blockIdx.x * lanes * V;   // the block's first channel
  const int c = c0 + lane * V;             // this thread's first channel
  const bool mine = c < C;
  const int p = blockIdx.y;
  const long long r0 = (long long)p * rows_per_block;
  const long long r1 = min(R, r0 + rows_per_block);
  float s[V], ss[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = ss[v] = 0.f;
  if (mine) {
    for (long long r = r0 + grp; r < r1; r += (long long)kInFlight * groups) {
      typename io::Raw raw[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (r + (long long)u * groups < r1)
          raw[u] = io::read(x + (r + (long long)u * groups) * C + c);
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (r + (long long)u * groups < r1) io::add(raw[u], s, ss);
    }
  }
  float bs, bss;
  block_sum<V>(s, ss, lanes, sh, bs, bss);
  const bool writes = t < lanes * V && c0 + t < C;
  if (P == 1) {   // the block's sums are its chunk's: no partials, no ticket
    if (writes) {
      out[c0 + t] = bs;
      out[C + c0 + t] = bss;
    }
    return;
  }
  if (writes) {
    part[(long long)p * C + c0 + t] = bs;
    part[((long long)P + p) * C + c0 + t] = bss;
  }

  // The ticket, one acquire-release atomic: it releases the block's
  // partials (the barrier orders every writer's before it) and, in the
  // last block, acquires the others' (the barrier orders every reader
  // after it).
  __syncthreads();
  if (t == 0) {
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> ticket(
        tickets[blockIdx.x]);
    last = ticket.fetch_add(1u, cuda::memory_order_acq_rel) ==
           (unsigned)(P - 1);
  }
  __syncthreads();
  if (!last) return;

  // The finish: the chunk's P partials in order of p in each thread
  // (p = grp, grp + groups, ...), then the same tree.
  constexpr int kRows = V >= 4 ? 16 / V : 8;   // partial rows in flight
  const int parts = P;   // every row block's partials
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = ss[v] = 0.f;
  if (mine) {
    for (int q = grp; q < parts; q += kRows * groups) {
      float a[kRows][V], b[kRows][V];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int qu = q + u * groups;
        if (qu < parts) {
          read_part<V>(part + (long long)qu * C + c, a[u]);
          read_part<V>(part + ((long long)P + qu) * C + c, b[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (q + u * groups < parts) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            s[v] += a[u][v];
            ss[v] += b[u][v];
          }
        }
      }
    }
  }
  block_sum<V>(s, ss, lanes, sh, bs, bss);
  if (writes) {
    out[c0 + t] = bs;
    out[C + c0 + t] = bss;
  }
  if (t == 0) tickets[blockIdx.x] = 0;   // ready for the next launch
}

bool bad_args(const StatsParams& p, int V) {
  const bool lanes_ok = p.lanes >= 1 && p.lanes <= 32 &&
                        (p.lanes & (p.lanes - 1)) == 0;
  return !p.x || !p.out || !p.part || !p.tickets || p.R <= 0 || p.C <= 0 ||
         p.P <= 0 || p.P > 65535 || p.rows_per_block <= 0 || !lanes_ok ||
         (long long)(p.P - 1) * p.rows_per_block >= p.R ||
         (long long)p.P * p.rows_per_block < p.R ||
         (p.vec && (p.C % V != 0 ||
                    (reinterpret_cast<unsigned long long>(p.x) & 15) != 0));
}

template <class T, int V>
int launch(const StatsParams& p, void* stream) {
  const int chunks = p.C / V;
  const dim3 grid((chunks + p.lanes - 1) / p.lanes, p.P);
  channel_stats_kernel<T, V><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(p.x), p.R, p.C, p.rows_per_block, p.P, p.lanes,
      p.part, p.tickets, p.out);
  return (int)cudaGetLastError();
}

}  // namespace

// x [R, C] contiguous f32; out [2, C] (sum, sumsq); part [2, P, C]
// scratch; tickets: ceil(C / V / lanes) counters, all 0 (and 0 again
// when the launch ends).  The P row blocks of rows_per_block rows must
// cover R exactly: (P - 1) * rows_per_block < R <= P * rows_per_block.
// vec (4 channels a float4) needs C % 4 == 0 and x 16-byte aligned.
extern "C" int channel_stats_f32(const StatsParams* p, void* stream) {
  if (bad_args(*p, 4)) return (int)cudaErrorInvalidValue;
  return p->vec ? launch<float, 4>(*p, stream) : launch<float, 1>(*p, stream);
}

// x [R, C] contiguous bf16, the rest as channel_stats_f32 (f32 sums);
// vec (8 channels a 16-byte load) needs C % 8 == 0 and x 16-byte aligned.
extern "C" int channel_stats_bf16(const StatsParams* p, void* stream) {
  if (bad_args(*p, 8)) return (int)cudaErrorInvalidValue;
  return p->vec ? launch<__nv_bfloat16, 8>(*p, stream)
                : launch<__nv_bfloat16, 1>(*p, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

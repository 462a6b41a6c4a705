// The SGD / Momentum update of a whole parameter list in one launch, and
// the row-lazy update of embedding tables in one launch, both in place.
//
// Replaces paddle_tpu/ops/pallas/tpp/update.py::fused_momentum_update and
// ::fused_sgd_update (one pallas_call a tensor over a [rows, 128] lane
// view, p and v aliased in place) and
// paddle_tpu/ops/pallas/tpp/embedding.py::sparse_row_update (row blocks of
// a [V, D] table, p and v aliased; a row whose gradient is all zero keeps
// its values).
//
// What bounds them on an H100: bytes.  The rule does 4 to 6 flops an
// element against 20 bytes (p, g, v read; p', v' written; 12 bytes for
// plain SGD), so the least time is the bytes over 3.35 TB/s.  The TPU runs
// one kernel a tensor; a ResNet-50 step has 161 tensors, most of them
// small (BN scales and shifts of a few hundred floats), so here one launch
// takes them all, and block b works on the entry whose range of blocks
// holds b (a binary search over the entries' first blocks, an exclusive
// prefix sum).
//
// In place, as the JAX kernels are (their steps donate p and v): p' and v'
// are written over p and v.  Nothing is allocated a step, and the table of
// entries (the p and v pointers, sizes, the f32 scalars, flags) does not
// change from one step to the next: the wrapper builds it once, keeps it on
// the card and builds it again only when a pointer, a shape or a scalar
// changes.  Only the gradients are new each step; their pointers travel by
// value, in the launch's own parameter block (GradList, 3,840 bytes: up to
// 480 entries a launch; a longer list is cut into several launches by the
// C entry point).  So a step costs the host one launch and no copy.
//
// The arithmetic is the eager update's, op for op, each product and sum
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn: nvcc would contract
// mu * v + g into one FMA and change the bits), in Optimizer.apply's order:
//   g  = g + wd * p                  (only where wd is set)
//   v' = mu * v + g
//   d  = lr * v'   (nesterov: lr * (g + mu * v'))   plain SGD: lr * g
//   p' = p - d
// so a step through the kernel equals the eager per-tensor loop bit for
// bit.
//
// Row-lazy form: one warp a row of a [V, D] table.  touched = any(g != 0)
// over the row (a float compare: a -0.0 row is untouched, a NaN row is
// touched), decided with __any_sync; a touched row takes the rule above,
// an untouched one is left as it is: its gradient is read (4 bytes an
// element) and p and v are neither read nor written.

#include <cuda_runtime.h>

#include <cstring>

namespace {

enum : int { kHasV = 1, kNesterov = 2, kHasWd = 4 };

struct Entry {
  float* p;
  float* v;            // null: plain SGD
  long long n;         // elements (dense form) or rows (row-lazy form)
  long long first;     // this entry's first block
  float lr, mu, wd;
  int flags;
  int width;           // row width D (row-lazy form), else 0
  int pad;
};
static_assert(sizeof(Entry) == 56, "the wrapper's table layout");

// the gradients of one launch's entries, by value in the parameter block
// (4 KB at most with the other parameters)
constexpr int kMaxGrads = 480;
struct GradList {
  const float* g[kMaxGrads];
};

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr long long kChunk = kThreads * kPerThread;  // elements a block
constexpr int kWarps = kThreads / 32;                // rows a block

// The entry whose blocks hold block b: the last one with first <= b.
__device__ int find_entry(const Entry* table, int count, long long b) {
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table[mid].first <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ int block_entry(const Entry* table, int count,
                                           long long b) {
  __shared__ int idx;
  if (threadIdx.x == 0) idx = find_entry(table, count, b);
  __syncthreads();
  return idx;
}

// The update of one element; v and v_new unused without kHasV.
__device__ __forceinline__ float rule(float p, float g, float v, float* v_new,
                                      const Entry& e) {
  if (e.flags & kHasWd) g = __fadd_rn(g, __fmul_rn(e.wd, p));
  if (!(e.flags & kHasV)) return __fsub_rn(p, __fmul_rn(e.lr, g));
  const float vn = __fadd_rn(__fmul_rn(e.mu, v), g);
  *v_new = vn;
  const float d = (e.flags & kNesterov)
                      ? __fmul_rn(e.lr, __fadd_rn(g, __fmul_rn(e.mu, vn)))
                      : __fmul_rn(e.lr, vn);
  return __fsub_rn(p, d);
}

// table: this launch's entries; base: the first block of table[0], so
// block blockIdx.x works on the global block base + blockIdx.x
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const Entry* __restrict__ table, int count,
                    long long base, const __grid_constant__ GradList grads) {
  const long long b = base + blockIdx.x;
  const int idx = block_entry(table, count, b);
  const Entry e = table[idx];
  const float* __restrict__ gp = grads.g[idx];
  const bool has_v = e.flags & kHasV;
  const long long start = (b - e.first) * kChunk + threadIdx.x;
  float p[kPerThread], g[kPerThread], v[kPerThread];
  // all loads first, then the arithmetic: 16-24 loads in flight a thread
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = start + (long long)k * kThreads;
    if (i < e.n) {
      p[k] = e.p[i];
      g[k] = gp[i];
      v[k] = has_v ? e.v[i] : 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = start + (long long)k * kThreads;
    if (i < e.n) {
      float vn;
      e.p[i] = rule(p[k], g[k], v[k], &vn, e);
      if (has_v) e.v[i] = vn;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sparse_row_update_kernel(const Entry* __restrict__ table, int count,
                         long long base,
                         const __grid_constant__ GradList grads) {
  const long long b = base + blockIdx.x;
  const int idx = block_entry(table, count, b);
  const Entry e = table[idx];
  const int lane = threadIdx.x % 32;
  const long long row = (b - e.first) * kWarps + threadIdx.x / 32;
  if (row >= e.n) return;  // warp-uniform
  const bool has_v = e.flags & kHasV;
  const long long off = row * e.width;
  const float* g = grads.g[idx] + off;
  bool mine = false;
  for (int d = lane; d < e.width; d += 32) mine |= g[d] != 0.f;
  if (!__any_sync(0xffffffffu, mine)) return;  // untouched: left as it is
  float* p = e.p + off;
  float* v = has_v ? e.v + off : nullptr;
  for (int d = lane; d < e.width; d += 32) {
    float vn;
    p[d] = rule(p[d], g[d], has_v ? v[d] : 0.f, &vn, e);
    if (has_v) v[d] = vn;
  }
}

// Launches `kernel` over the table in runs of at most kMaxGrads entries.
int launch_runs(const void* table_, int count, const long long* first,
                const void* const* grads, void* stream_,
                void (*kernel)(const Entry*, int, long long, GradList)) {
  const Entry* table = static_cast<const Entry*>(table_);
  if (table == nullptr || count <= 0 || first == nullptr || grads == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  for (int lo = 0; lo < count; lo += kMaxGrads) {
    const int hi = count - lo < kMaxGrads ? count : lo + kMaxGrads;
    const long long blocks = first[hi] - first[lo];
    if (blocks <= 0 || blocks > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    GradList list;
    std::memcpy(list.g, grads + lo, sizeof(void*) * (hi - lo));
    kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(table + lo, hi - lo,
                                                      first[lo], list);
    if (cudaError_t err = cudaGetLastError()) return (int)err;
  }
  return 0;
}

}  // namespace

// table: `count` entries (struct Entry) on the card, in increasing
// `first`, each with n > 0 and first = the sum of the blocks of the
// entries before it (ceil(n / 2048) in the dense form, ceil(rows / 8) in
// the row-lazy form); first: the same firsts on the host and, at
// first[count], the sum over all entries; grads: the entries' gradient
// pointers on the host, in table order.  The table is passed as void*: a
// C entry point cannot name a type of the anonymous namespace and keep its
// external symbol.
extern "C" int fused_update_f32(const void* table, int count,
                                const long long* first,
                                const void* const* grads, void* stream) {
  return launch_runs(table, count, first, grads, stream,
                     fused_update_kernel);
}

extern "C" int sparse_row_update_f32(const void* table, int count,
                                     const long long* first,
                                     const void* const* grads, void* stream) {
  return launch_runs(table, count, first, grads, stream,
                     sparse_row_update_kernel);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

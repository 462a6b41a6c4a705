// The SGD / Momentum update of a whole parameter list in one launch, and
// the row-lazy update of embedding tables in one launch.
//
// Replaces paddle_tpu/ops/pallas/tpp/update.py::fused_momentum_update and
// ::fused_sgd_update (one pallas_call a tensor over a [rows, 128] lane
// view, p and v aliased in place) and
// paddle_tpu/ops/pallas/tpp/embedding.py::sparse_row_update (row blocks of
// a [V, D] table; a row whose gradient is all zero is written back as it
// was).
//
// What bounds them on an H100: bytes.  The rule does 4 to 6 flops an
// element against 20 bytes (p, g, v read; p', v' written; 12 bytes for
// plain SGD), so the least time is the bytes over 3.35 TB/s.  The TPU runs
// one kernel a tensor; a ResNet-50 step has 161 tensors, most of them
// small (BN scales and shifts of a few hundred floats), so here one launch
// takes them all: the wrapper writes a table of entries (pointers, size,
// the f32 scalars, flags) on the host, copies it to the card in one copy,
// and block b works on the entry whose range of blocks holds b (a binary
// search over the entries' first blocks, an exclusive prefix sum).
//
// The arithmetic is the eager update's, op for op, each product and sum
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn: nvcc would contract
// mu * v + g into one FMA and change the bits), in Optimizer.apply's order:
//   g  = g + wd * p                  (only where wd is set)
//   v' = mu * v + g
//   d  = lr * v'   (nesterov: lr * (g + mu * v'))   plain SGD: lr * g
//   p' = p - d
// so a step through the kernel equals the eager per-tensor loop bit for
// bit.  Outputs are fresh buffers (out of place): the caller keeps p and v.
//
// Row-lazy form: one warp a row of a [V, D] table.  touched = any(g != 0)
// over the row (a float compare: a -0.0 row is untouched, a NaN row is
// touched), decided with __any_sync; a touched row takes the rule above,
// an untouched one is copied through, p and v bit for bit.

#include <cuda_runtime.h>

namespace {

enum : int { kHasV = 1, kNesterov = 2, kHasWd = 4 };

struct Entry {
  const float* p;
  const float* g;
  const float* v;      // null: plain SGD
  float* p_out;
  float* v_out;        // null: plain SGD
  long long n;         // elements (dense form) or rows (row-lazy form)
  long long first;     // this entry's first block
  float lr, mu, wd;
  int flags;
  int width;           // row width D (row-lazy form), else 0
  int pad;
};
static_assert(sizeof(Entry) == 80, "the wrapper's table layout");

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

__device__ __forceinline__ int block_entry(const Entry* table, int count) {
  __shared__ int idx;
  if (threadIdx.x == 0) idx = find_entry(table, count, blockIdx.x);
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

__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const Entry* __restrict__ table, int count) {
  const Entry e = table[block_entry(table, count)];
  const bool has_v = e.flags & kHasV;
  const long long base = (blockIdx.x - e.first) * kChunk + threadIdx.x;
  float p[kPerThread], g[kPerThread], v[kPerThread];
  // all loads first, then the arithmetic: 16-24 loads in flight a thread
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + (long long)k * kThreads;
    if (i < e.n) {
      p[k] = e.p[i];
      g[k] = e.g[i];
      v[k] = has_v ? e.v[i] : 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + (long long)k * kThreads;
    if (i < e.n) {
      float vn;
      e.p_out[i] = rule(p[k], g[k], v[k], &vn, e);
      if (has_v) e.v_out[i] = vn;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sparse_row_update_kernel(const Entry* __restrict__ table, int count) {
  const Entry e = table[block_entry(table, count)];
  const int lane = threadIdx.x % 32;
  const long long row = (blockIdx.x - e.first) * kWarps + threadIdx.x / 32;
  if (row >= e.n) return;  // warp-uniform
  const bool has_v = e.flags & kHasV;
  const long long off = row * e.width;
  const float* g = e.g + off;
  bool mine = false;
  for (int d = lane; d < e.width; d += 32) mine |= g[d] != 0.f;
  const bool touched = __any_sync(0xffffffffu, mine);
  const float* p = e.p + off;
  const float* v = has_v ? e.v + off : nullptr;
  float* po = e.p_out + off;
  float* vo = has_v ? e.v_out + off : nullptr;
  for (int d = lane; d < e.width; d += 32) {
    const float pd = p[d];
    const float vd = has_v ? v[d] : 0.f;
    if (touched) {
      float vn;
      po[d] = rule(pd, g[d], vd, &vn, e);
      if (has_v) vo[d] = vn;
    } else {
      po[d] = pd;
      if (has_v) vo[d] = vd;
    }
  }
}

int check(const Entry* table, int count, long long blocks) {
  if (table == nullptr || count <= 0 || blocks <= 0 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// table: `count` entries (struct Entry) on the card, in increasing
// `first`, each with n > 0 and first = the sum of the blocks of the
// entries before it (ceil(n / 2048) in the dense form, ceil(rows / 8) in
// the row-lazy form); blocks: the sum over all entries.  The table is
// passed as void*: a C entry point cannot name a type of the anonymous
// namespace and keep its external symbol.
extern "C" int fused_update_f32(const void* table_, int count,
                                long long blocks, void* stream) {
  const Entry* table = static_cast<const Entry*>(table_);
  if (int err = check(table, count, blocks)) return err;
  fused_update_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(table, count);
  return (int)cudaGetLastError();
}

extern "C" int sparse_row_update_f32(const void* table_, int count,
                                     long long blocks, void* stream) {
  const Entry* table = static_cast<const Entry*>(table_);
  if (int err = check(table, count, blocks)) return err;
  sparse_row_update_kernel<<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(table, count);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

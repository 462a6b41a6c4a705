// Fused-input bidirectional LSTM forward: both directions in one launch,
// the input projection x @ W_x + b computed step by step inside the loop.
//
// Replaces paddle_tpu/ops/pallas/lstm.py::bilstm_seq (the pallas_call of
// _bi_fwd_kernel: a grid over T run in order on one core, the forward
// recurrence at index i and the reverse one at T-1-i, all four weight
// matrices resident in VMEM, so the [T, B, 4D] gate-input slab never
// reaches HBM).
//
// Layout (batch-major, as the JAX entry takes it): x [B, T, E]; mask
// [B, T] f32 (1 while t < length; rows freeze afterwards); per direction
// W_x [E, 4D], b [4D], W_h [D, 4D], peephole [3, D] = [W_ci, W_cf, W_co]
// (i and f see c_{t-1}, o sees c_t), h0, c0 [B, D]; out hs, cs [B, T, D]
// (what the remat backward recomputes the gates from), h_T, c_T [B, D].
// Gate order [i, f, g, o]; the cell is _cell_step of lstm.py and
// lstm_seq.cu's, with pre = (x W_x + b) + h W_h.
//
// Design (the f32 form).  Batch rows are independent, so a thread-block
// cluster of C CTAs owns one direction and a tile of kRows batch rows and
// walks every step of that direction with no grid barrier (blockIdx.y is
// the direction; the reverse one visits T-1..0).  CTA k of the cluster
// owns the units [k U, (k+1) U), U = D/C, and all four gate columns of
// each, so its cell needs nothing from its peers.  Its slices of W_h
// [D, 4U] and, where they fit (kResident), of W_x [E, 4U] stay in shared
// memory for the whole sequence, unit-major (column 4u + g is gate g of
// unit u): W_x is read once a CTA a launch, not once a step.  The whole h
// of the tile's rows is kept by every CTA, [D][kRows], double-buffered by
// step parity; x_t's rows are staged as [E][kRows], so one 16-byte load
// holds a k of four rows; the bias and peephole slices sit in shared
// memory too.  A step:
//   1. x_t W_x: thread i takes unit u = i % U (its four gate columns, one
//      16-byte load of the slice a k) and the (i / U)-th of KS shares of
//      the E reduction (KS = min(16, 256 / U): every thread works), 16
//      FMAs a k; its partial sums to shared memory.  It needs no h, so it
//      runs before the cluster barrier's wait and hides the peers' latency;
//   2. wait on the cluster barrier (acquire): every peer's h_{t-1} slice
//      has landed in this CTA's h buffer;
//   3. h_{t-1} W_h the same way;
//   4. x_{t+1}'s rows and mask copied in by cp.async, which overlaps 5;
//   5. thread (r, u) adds its unit's partial sums in share order as
//      (x W_x + b) + h W_h, runs the cell, stores h_t into every CTA's
//      other-parity h buffer over distributed shared memory, and arrives
//      on the cluster barrier (release); only then are hs, cs (and h_T,
//      c_T) written to device memory, so the release waits on no store
//      to device memory.
// A CTA reads the parity its peers wrote a step before and writes the
// other; a peer can write a buffer only after every CTA's arrive that
// follows its last read of it, so two buffers suffice.  Without the
// resident slice (a shape whose W_x slice does not fit) W_x and x are read
// through L2 at each step, as the single-block kernel before it did.
//
// What bounds it on an H100: the step-to-step chain.  At B 64, T 24, E
// 256, D 64 the work is ~503 MFLOP (7.5 us of f32 FMA at 67 TFLOP/s); each
// of the 24 steps of a direction waits on the one before, so the latency
// of a step's products, its barriers and the cell's transcendentals set
// its time.  One CTA writes each output and the sums run in a fixed
// order: a rerun gives the same bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kClThreads = 256;
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kMaxSplits = 16;    // shares of a product's reduction

struct Dir {
  const float* wx;    // [E, 4D]
  const float* b;     // [4D]
  const float* wh;    // [D, 4D]
  const float* peep;  // [3, D]
  const float* h0;    // [B, D]
  const float* c0;    // [B, D]
  float* hs;          // [B, T, D]
  float* cs;          // [B, T, D]
  float* hT;          // [B, D]
  float* cT;          // [B, D]
};

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

// the shares of a product's reduction: 256 threads over U units
__host__ __device__ inline int splits_of(int U) {
  const int ks = U >= kClThreads ? 1 : kClThreads / U;
  return ks < kMaxSplits ? ks : kMaxSplits;
}

// floats of shared memory a CTA takes (lstm.py's bi_smem_floats): the W_h
// slice [D][4U], the resident W_x slice [E][4U] and x_t rows [E][rows],
// the h buffers [2][D][rows], the c carry [rows][U], the partial sums
// [2][splits][rows][4U], the bias slice [4U], the peepholes [3][U] and the
// mask of two steps [2][rows]
__host__ __device__ inline size_t cl_smem_floats(int E, int D, int C,
                                                 int rows, bool resident) {
  const int U = D / C, cols = 4 * U;
  const size_t lx = resident ? (size_t)E : 0;
  return (lx + D) * cols + rows * lx + 2 * (size_t)rows * D +
         (size_t)rows * U + 2 * (size_t)splits_of(U) * rows * cols + cols +
         3 * U + 2 * rows;
}

// a 4-byte asynchronous copy to shared memory, zero-filled when !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& w) {
  acc.x = fmaf(a, w.x, acc.x);
  acc.y = fmaf(a, w.y, acc.y);
  acc.z = fmaf(a, w.z, acc.z);
  acc.w = fmaf(a, w.w, acc.w);
}

// The partial sums of one product over K: thread i takes unit u = i % U
// and share ks = i / U of the reduction, and writes out[ks][r][4u..4u+3]
// = sum over its k of a[k][r] w[k][4u..4u+3].  kShared: a [K][kRows] and
// w [K][4U] in shared memory; else x_t's rows (xt) and W_x's columns of
// unit col0 + u (gate g at column g D) in device memory.
template <int kRows, bool kShared>
__device__ __forceinline__ void partial_sums(
    float4* out, const float* a, const float* w, int K, int U, int KS,
    const float* const* xt, const float* wg, int D, int col0) {
  const int G = 4 * D, share = (K + KS - 1) / KS;
  for (int i = threadIdx.x; i < U * KS; i += kClThreads) {
    const int u = i % U, ks = i / U;
    const int lo = ks * share, hi = min(K, lo + share);
    float4 acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (kShared) {
      const float4* wk = reinterpret_cast<const float4*>(w) + lo * U + u;
      const float4* ak = reinterpret_cast<const float4*>(a) + lo * (kRows / 4);
#pragma unroll 4
      for (int k = lo; k < hi; ++k, wk += U, ak += kRows / 4) {
        const float4 wv = *wk;
#pragma unroll
        for (int q = 0; q < kRows / 4; ++q) {
          const float4 av = ak[q];
          fma4(acc[4 * q], av.x, wv);
          fma4(acc[4 * q + 1], av.y, wv);
          fma4(acc[4 * q + 2], av.z, wv);
          fma4(acc[4 * q + 3], av.w, wv);
        }
      }
    } else {
      const float* wc = wg + col0 + u;
      for (int k = lo; k < hi; ++k) {
        const float* wr = wc + (size_t)k * G;
        const float4 wv = make_float4(__ldg(wr), __ldg(wr + D),
                                      __ldg(wr + 2 * D), __ldg(wr + 3 * D));
#pragma unroll
        for (int r = 0; r < kRows; ++r) fma4(acc[r], __ldg(xt[r] + k), wv);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) out[(ks * kRows + r) * U + u] = acc[r];
  }
}

template <int kRows, bool kResident>
__global__ void __launch_bounds__(kClThreads, 1)
bilstm_cluster_kernel(const float* __restrict__ x,
                      const float* __restrict__ mask, Dir fw, Dir bw, int B,
                      int T, int E, int D) {
  static_assert(kRows % 4 == 0, "a 16-byte load holds a k of four rows");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool reverse = blockIdx.y == 1;
  const Dir p = reverse ? bw : fw;
  const int G = 4 * D, U = D / C, cols = 4 * U, col0 = rank * U;
  const int KS = splits_of(U);
  const int tid = threadIdx.x;
  const int b0 = (blockIdx.x / C) * kRows;
  const int rows = min(kRows, B - b0);
  float* wh_s = smem;                                          // [D][4U]
  float* wx_s = wh_s + (size_t)D * cols;                       // [E][4U]
  float* x_s = wx_s + (kResident ? (size_t)E * cols : 0);      // [E][kRows]
  float* h_s = x_s + (kResident ? (size_t)E * kRows : 0);      // [2][D][kRows]
  float* c_s = h_s + 2 * D * kRows;                            // [kRows][U]
  float4* red_x = reinterpret_cast<float4*>(c_s + kRows * U);  // [KS][kRows][U]
  float4* red_h = red_x + KS * kRows * U;                      // [KS][kRows][U]
  float* bias_s = reinterpret_cast<float*>(red_h + KS * kRows * U);  // [4U]
  float* peep_s = bias_s + cols;                               // [3][U]
  float* mask_s = peep_s + 3 * U;                              // [2][kRows]

  // the slices: column 4u + g is gate g of unit col0 + u
  for (int i = tid; i < D * cols; i += kClThreads) {
    const int k = i / cols, j = i % cols;
    wh_s[i] = p.wh[(size_t)k * G + (j % 4) * D + col0 + j / 4];
  }
  if constexpr (kResident) {
    for (int i = tid; i < E * cols; i += kClThreads) {
      const int k = i / cols, j = i % cols;
      wx_s[i] = p.wx[(size_t)k * G + (j % 4) * D + col0 + j / 4];
    }
  }
  for (int i = tid; i < 2 * D * kRows; i += kClThreads) {
    const int r = i % kRows, k = (i / kRows) % D;
    h_s[i] = i < D * kRows && r < rows ? p.h0[(size_t)(b0 + r) * D + k] : 0.f;
  }
  for (int i = tid; i < kRows * U; i += kClThreads) {
    const int r = i / U;
    c_s[i] = r < rows ? p.c0[(size_t)(b0 + r) * D + col0 + i % U] : 0.f;
  }
  for (int j = tid; j < cols; j += kClThreads)
    bias_s[j] = p.b[(j % 4) * D + col0 + j / 4];
  for (int i = tid; i < 3 * U; i += kClThreads)
    peep_s[i] = p.peep[(i / U) * D + col0 + i % U];
  // rows past B read the tile's last row (their results are dropped)
  const float* xrow[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    xrow[r] = x + (size_t)(b0 + min(r, rows - 1)) * T * E;
  // step s's x_t rows (resident) and mask, by asynchronous copies
  auto stage = [&](int s) {
    const int t = reverse ? T - 1 - s : s;
    if constexpr (kResident) {
      for (int i = tid; i < kRows * E; i += kClThreads) {
        const int r = i / E, e = i % E;
        cp_async4(x_s + e * kRows + r,
                  x + ((size_t)(b0 + min(r, rows - 1)) * T + t) * E + e, true);
      }
    }
    if (tid < kRows)
      cp_async4(mask_s + (s & 1) * kRows + tid,
                mask + (size_t)(b0 + min(tid, rows - 1)) * T + t, true);
  };
  stage(0);
  cp_async_commit_wait();
  // every CTA of the cluster runs (its shared memory exists) before any
  // store to a peer's; this also makes the prologue's writes visible
  cluster.sync();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    if (s > 0) {
      cp_async_commit_wait();        // this thread's copies of step s
      __syncthreads();               // everyone's; the cells read red_*
    }
    const float* xt[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) xt[r] = xrow[r] + (size_t)t * E;
    partial_sums<kRows, kResident>(red_x, x_s, wx_s, E, U, KS, xt, p.wx, D,
                                   col0);
    if (s > 0) cluster_wait();       // every peer's h_{t-1} has landed
    const float* h_cur = h_s + (s & 1) * D * kRows;
    float* h_nxt = h_s + ((s + 1) & 1) * D * kRows;
    partial_sums<kRows, true>(red_h, h_cur, wh_s, D, U, KS, nullptr,
                              nullptr, D, col0);
    __syncthreads();
    if (s + 1 < T) stage(s + 1);     // x_s is read; the copies overlap the cell
    for (int i = tid; i < kRows * U; i += kClThreads) {
      const int r = i / U, u = i % U, unit = col0 + u;
      if (r >= rows) continue;
      float4 sx = make_float4(0.f, 0.f, 0.f, 0.f), sh = sx;
#pragma unroll 4
      for (int ks = 0; ks < KS; ++ks) {
        const float4 vx = red_x[(ks * kRows + r) * U + u];
        const float4 vh = red_h[(ks * kRows + r) * U + u];
        sx.x += vx.x, sx.y += vx.y, sx.z += vx.z, sx.w += vx.w;
        sh.x += vh.x, sh.y += vh.y, sh.z += vh.z, sh.w += vh.w;
      }
      const float4 bv = reinterpret_cast<const float4*>(bias_s)[u];
      const float cp = c_s[i], hp = h_cur[unit * kRows + r];
      const float gi = sigm(((sx.x + bv.x) + sh.x) + peep_s[u] * cp);
      const float gf = sigm(((sx.y + bv.y) + sh.y) + peep_s[U + u] * cp);
      const float gg = tanhf((sx.z + bv.z) + sh.z);
      const float c = gf * cp + gi * gg;
      const float go = sigm(((sx.w + bv.w) + sh.w) + peep_s[2 * U + u] * c);
      const float h = go * tanhf(c);
      const float m = mask_s[(s & 1) * kRows + r];
      const float hn = m * h + (1.f - m) * hp;
      c_s[i] = m * c + (1.f - m) * cp;
      if (s + 1 < T) {
        for (int q = 0; q < C; ++q)
          cluster.map_shared_rank(h_nxt, q)[unit * kRows + r] = hn;
      } else {
        h_nxt[unit * kRows + r] = hn;
      }
    }
    if (s + 1 < T) cluster_arrive();   // this CTA's h_t slice is out
    // the outputs of step s, read back from this CTA's own h and c (no
    // other thread writes them before its next arrive)
    for (int i = tid; i < kRows * U; i += kClThreads) {
      const int r = i / U, unit = col0 + i % U;
      if (r >= rows) continue;
      const int b = b0 + r;
      const float hn = h_nxt[unit * kRows + r], cn = c_s[i];
      const size_t o = ((size_t)b * T + t) * D + unit;
      p.hs[o] = hn;
      p.cs[o] = cn;
      if (s == T - 1) {
        p.hT[(size_t)b * D + unit] = hn;
        p.cT[(size_t)b * D + unit] = cn;
      }
    }
  }
}

template <int kRows, bool kResident>
cudaError_t launch_cluster(const float* x, const float* mask, const Dir& fw,
                           const Dir& bw, int B, int T, int E, int D, int C,
                           cudaStream_t stream) {
  auto kernel = bilstm_cluster_kernel<kRows, kResident>;
  const size_t smem = sizeof(float) * cl_smem_floats(E, D, C, kRows,
                                                     kResident);
  // the opt-in, once a device and a size (a larger one raises it; it is
  // never lowered, max_clusters included)
  static size_t opted[16] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 16 || smem > opted[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < 16) opted[dev] = smem;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((B + kRows - 1) / kRows), 2, 1);
  cfg.blockDim = dim3(kClThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, mask, fw, bw, B, T, E, D);
}

template <int kRows, bool kResident>
cudaError_t max_clusters(int E, int D, int C, int* out) {
  auto kernel = bilstm_cluster_kernel<kRows, kResident>;
  const size_t smem = sizeof(float) * cl_smem_floats(E, D, C, kRows,
                                                     kResident);
  // the opt-in is only raised, never lowered: launch_cluster counts on it
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  if ((int)smem > fa.maxDynamicSharedSizeBytes) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(kClThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, (const void*)kernel, &cfg);
}

}  // namespace

// How many clusters of the f32 form's plan (C, rows, resident) at E, D
// the current card holds at once (cudaOccupancyMaxActiveClusters): the
// card's own count, which its GPCs' sizes bound below SMs / C.
extern "C" int bilstm_f32_max_clusters(int E, int D, int C, int rows,
                                       int resident, int* out) {
  if (E <= 0 || D <= 0 || C <= 0 || C > kMaxCluster || D % C ||
      (rows != 4 && rows != 8))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (rows == 4)
    err = resident ? max_clusters<4, true>(E, D, C, out)
                   : max_clusters<4, false>(E, D, C, out);
  else
    err = resident ? max_clusters<8, true>(E, D, C, out)
                   : max_clusters<8, false>(E, D, C, out);
  return (int)err;
}

// The f32 form, in the plan of lstm.py's bi_plan: clusters of C CTAs (C
// divides D, C <= 8), row tiles of `rows` (4 or 8), W_x's slice resident
// in shared memory or not; the grid (C ceil(B / rows), 2), the forward
// direction's operands first, then the reverse one's.  Returns
// cudaErrorInvalidValue for a plan outside these.
extern "C" int bilstm_fwd_f32(
    const float* x, const float* mask,
    const float* wx_f, const float* b_f, const float* wh_f,
    const float* peep_f, const float* h0_f, const float* c0_f, float* hs_f,
    float* cs_f, float* hT_f, float* cT_f,
    const float* wx_b, const float* b_b, const float* wh_b,
    const float* peep_b, const float* h0_b, const float* c0_b, float* hs_b,
    float* cs_b, float* hT_b, float* cT_b,
    int B, int T, int E, int D, int C, int rows, int resident,
    void* stream) {
  if (B <= 0 || T <= 0 || E <= 0 || D <= 0 || C <= 0 || C > kMaxCluster ||
      D % C || (rows != 4 && rows != 8))
    return (int)cudaErrorInvalidValue;
  const Dir fw{wx_f, b_f, wh_f, peep_f, h0_f, c0_f, hs_f, cs_f, hT_f, cT_f};
  const Dir bw{wx_b, b_b, wh_b, peep_b, h0_b, c0_b, hs_b, cs_b, hT_b, cT_b};
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (rows == 4)
    err = resident
              ? launch_cluster<4, true>(x, mask, fw, bw, B, T, E, D, C, st)
              : launch_cluster<4, false>(x, mask, fw, bw, B, T, E, D, C, st);
  else
    err = resident
              ? launch_cluster<8, true>(x, mask, fw, bw, B, T, E, D, C, st)
              : launch_cluster<8, false>(x, mask, fw, bw, B, T, E, D, C, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 form, bilstm_fwd_bf16: the rounding points of _bi_fwd_kernel
// with bf16 operands (lstm.py:800-860): the projection x_t W_x + b summed
// in f32 and never rounded (:833-835), h_{t-1} W_h in f32 from the bf16 h
// carry, the cell in f32, hs in bf16, cs, h_T and c_T in f32 (h_T
// unrounded).
//
// A block owns one direction and a tile of 16 batch rows (one m16 tile of
// mma.sync.m16n8k16, f32 accumulators) and walks every step of that
// direction with no grid barrier.  W_x and W_h of its direction stay in
// shared memory for the whole sequence, transposed and packed by the
// wrapper as [4D][K] (row 4u + g: gate g of unit u; the reduction
// contiguous, zero past E or D up to a multiple of 16, then 8 more, an odd
// count of 16-byte groups): at E 256, D 64, 172,032 bytes, read through
// the tensor cores instead of f32 FMAs over W_x in L2.  The h carry of the
// tile's rows lives in shared memory as the next step's A operand, bf16;
// x_t's rows are staged by cp.async one step ahead (two stages).  Eight
// warps each own up to 4 n8 tiles (two units each: D <= 64) and keep two
// accumulators per tile, x W_x and h W_h, added as (x W_x + b) + h W_h;
// the cell runs in registers after the same __shfl_xor_sync(..., 1) as in
// lstm_seq.cu, and each lane keeps its cells' c carry in registers.
//
// What bounds it on an H100: the step-to-step chain.  At B 64, T 24, E
// 256, D 64 the work is ~0.5 GFLOP (0.5 us at 989 TFLOP/s), spread over 8
// blocks (4 row tiles x 2 directions), 24 dependent steps each.

namespace {

using bf16 = __nv_bfloat16;
namespace tc = bf16_tc;

constexpr int kRowsB = 16;            // batch rows a block: one m16 tile
constexpr int kWarpsB = 8;
constexpr int kThreadsB = 32 * kWarpsB;
constexpr int kTilesB = 4;            // n8 tiles a warp at most: D <= 64

__host__ __device__ inline int ld_bf(int k) { return 16 * ((k + 15) / 16) + 8; }

// bytes of shared memory a block takes (lstm.py's bi_bf16_smem_bytes)
__host__ __device__ inline size_t smem_bytes_bf16(int E, int D) {
  return 2 * ((size_t)4 * D * (ld_bf(E) + ld_bf(D)) +
              (size_t)kRowsB * (2 * ld_bf(E) + ld_bf(D)));
}

struct DirBf16 {
  const bf16* wx;     // [4D][ld(E)], rows 4u + g
  const float* b;     // [4D], index 4u + g
  const bf16* wh;     // [4D][ld(D)]
  const bf16* peep;   // [3, D]
  const bf16* h0;     // [B, D]
  const float* c0;    // [B, D]
  bf16* hs;           // [B, T, D]
  float* cs;          // [B, T, D]
  float* hT;          // [B, D]
  float* cT;          // [B, D]
};

__device__ __forceinline__ float b2f_b(bf16 x) { return __bfloat162float(x); }

// x_t's rows of the tile into buf [kRowsB][ld(E)], zero past the rows and E
__device__ __forceinline__ void stage_x(bf16* buf, const bf16* x, int b0,
                                        int rows, int t, int T, int E,
                                        int LX) {
  const int n8 = (LX - 8) / 8;        // 16-byte groups up to E's multiple of 16
  for (int p = threadIdx.x; p < kRowsB * n8; p += kThreadsB) {
    const int r = p / n8, q = p % n8;
    const bool ok = r < rows && 8 * q < E;
    tc::cp_async16(buf + r * LX + 8 * q,
                   ok ? x + ((size_t)(b0 + r) * T + t) * E + 8 * q : x, ok);
  }
}

__global__ void __launch_bounds__(kThreadsB, 1)
bilstm_fwd_bf16_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ mask, DirBf16 fw,
                       DirBf16 bw, int B, int T, int E, int D) {
  extern __shared__ float4 smem4[];
  const bool reverse = blockIdx.y == 1;
  const DirBf16 p = reverse ? bw : fw;
  const int G = 4 * D, LX = ld_bf(E), LH = ld_bf(D), NTILE = G / 8;
  bf16* wx_s = reinterpret_cast<bf16*>(smem4);    // [G][LX]
  bf16* wh_s = wx_s + (size_t)G * LX;             // [G][LH]
  bf16* x_s = wh_s + (size_t)G * LH;              // [2][kRowsB][LX]
  bf16* h_s = x_s + 2 * kRowsB * LX;              // [kRowsB][LH]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * kRowsB;
  const int rows = min(kRowsB, B - b0);
  {
    const uint4* src = reinterpret_cast<const uint4*>(p.wx);
    uint4* dst = reinterpret_cast<uint4*>(wx_s);
    for (int e = threadIdx.x; e < G * LX / 8; e += kThreadsB) dst[e] = src[e];
    src = reinterpret_cast<const uint4*>(p.wh);
    dst = reinterpret_cast<uint4*>(wh_s);
    for (int e = threadIdx.x; e < G * LH / 8; e += kThreadsB) dst[e] = src[e];
  }
  for (int e = threadIdx.x; e < kRowsB * LH; e += kThreadsB) {
    const int r = e / LH, u = e % LH;
    h_s[e] = r < rows && u < D ? p.h0[(size_t)(b0 + r) * D + u]
                               : __float2bfloat16_rn(0.f);
  }
  // this lane's cells: tile j = warp + 8 i, row rl, unit 2j + (lane / 2) % 2
  const int rl = (lane >> 2) + 8 * (lane & 1);
  const bool rok = rl < rows;
  const int b = b0 + rl;
  float bias[kTilesB][2], pp[kTilesB][3], cc[kTilesB], hc[kTilesB];
#pragma unroll
  for (int i = 0; i < kTilesB; ++i) {
    const int j = warp + kWarpsB * i;
    const int col = 8 * j + 2 * (lane & 3), u = 2 * j + ((lane >> 1) & 1);
    const bool live = j < NTILE;
    bias[i][0] = live ? p.b[col] : 0.f;
    bias[i][1] = live ? p.b[col + 1] : 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) pp[i][k] = live ? b2f_b(p.peep[k * D + u]) : 0.f;
    cc[i] = live && rok ? p.c0[(size_t)b * D + u] : 0.f;
    hc[i] = live && rok ? b2f_b(p.h0[(size_t)b * D + u]) : 0.f;
  }
  stage_x(x_s, x, b0, rows, reverse ? T - 1 : 0, T, E, LX);
  tc::cp_async_commit();
  const int kx = (LX - 8) / 16, kh = (LH - 8) / 16;   // 16-deep steps

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    if (s + 1 < T)
      stage_x(x_s + ((s + 1) & 1) * kRowsB * LX, x, b0, rows,
              reverse ? t - 1 : t + 1, T, E, LX);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* xs = x_s + (s & 1) * kRowsB * LX;
    float ax[kTilesB][4], ah[kTilesB][4];
#pragma unroll
    for (int i = 0; i < kTilesB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) ax[i][e] = ah[i][e] = 0.f;
    for (int ks = 0; ks < kx; ++ks) {
      uint32_t af[4];
      tc::ldmatrix_x4(af, xs + (lane & 15) * LX + 16 * ks + 8 * (lane >> 4));
#pragma unroll
      for (int i = 0; i < kTilesB; ++i) {
        const int j = warp + kWarpsB * i;
        if (j >= NTILE) break;
        uint32_t bb[2];
        tc::ldmatrix_x2(bb, wx_s + (size_t)(8 * j + (lane & 7)) * LX +
                                16 * ks + 8 * ((lane >> 3) & 1));
        tc::mma_bf16(ax[i], af, bb[0], bb[1]);
      }
    }
    for (int ks = 0; ks < kh; ++ks) {
      uint32_t af[4];
      tc::ldmatrix_x4(af, h_s + (lane & 15) * LH + 16 * ks + 8 * (lane >> 4));
#pragma unroll
      for (int i = 0; i < kTilesB; ++i) {
        const int j = warp + kWarpsB * i;
        if (j >= NTILE) break;
        uint32_t bb[2];
        tc::ldmatrix_x2(bb, wh_s + (size_t)(8 * j + (lane & 7)) * LH +
                                16 * ks + 8 * ((lane >> 3) & 1));
        tc::mma_bf16(ah[i], af, bb[0], bb[1]);
      }
    }
    __syncthreads();     // h_s read by every warp: the cells may write it
    const float m = rok ? mask[(size_t)b * T + t] : 0.f;
    const bool odd = lane & 1;
#pragma unroll
    for (int i = 0; i < kTilesB; ++i) {
      const int j = warp + kWarpsB * i;
      if (j >= NTILE) break;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = (ax[i][e] + bias[i][e & 1]) + ah[i][e];
      const float s0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
      const float s1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
      const float pi = odd ? s0 : v[0], pf = odd ? s1 : v[1];
      const float pg = odd ? v[2] : s0, po = odd ? v[3] : s1;
      const int u = 2 * j + ((lane >> 1) & 1);
      if (!rok) continue;
      const float cp = cc[i];
      const float gi = sigm(pi + pp[i][0] * cp);
      const float gf = sigm(pf + pp[i][1] * cp);
      const float gg = tanhf(pg);
      const float c = gf * cp + gi * gg;
      const float go = sigm(po + pp[i][2] * c);
      const float h = go * tanhf(c);
      const float hn = m * h + (1.f - m) * hc[i];
      const float cn = m * c + (1.f - m) * cp;
      const bf16 hr = __float2bfloat16_rn(hn);
      h_s[rl * LH + u] = hr;
      hc[i] = __bfloat162float(hr);
      cc[i] = cn;
      const size_t o = ((size_t)b * T + t) * D + u;
      p.hs[o] = hr;
      p.cs[o] = cn;
      if (s == T - 1) {
        p.hT[(size_t)b * D + u] = hn;
        p.cT[(size_t)b * D + u] = cn;
      }
    }
  }
}

}  // namespace

// The bf16 form: the grid (ceil(B / 16), 2); per direction W_x and W_h
// packed [4D][K padded] bf16, b [4D] f32 (both index 4u + g), peep [3, D]
// and h0 bf16, c0 f32; x [B, T, E] bf16, mask f32; hs bf16, cs, hT, cT
// f32.  E, D multiples of 8, D <= 64; cudaErrorInvalidValue for a shape
// whose shared memory exceeds the card's opt-in.
extern "C" int bilstm_fwd_bf16(
    const void* x, const float* mask,
    const void* wx_f, const float* b_f, const void* wh_f, const void* peep_f,
    const void* h0_f, const float* c0_f, void* hs_f, float* cs_f,
    float* hT_f, float* cT_f,
    const void* wx_b, const float* b_b, const void* wh_b, const void* peep_b,
    const void* h0_b, const float* c0_b, void* hs_b, float* cs_b,
    float* hT_b, float* cT_b,
    int B, int T, int E, int D, void* stream) {
  if (B <= 0 || T <= 0 || E <= 0 || D <= 0 || E % 8 || D % 8 ||
      D > kWarpsB * kTilesB * 2)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = smem_bytes_bf16(E, D);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bilstm_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  using B16 = const bf16*;
  const DirBf16 fw{B16(wx_f), b_f, B16(wh_f), B16(peep_f), B16(h0_f), c0_f,
                   static_cast<bf16*>(hs_f), cs_f, hT_f, cT_f};
  const DirBf16 bw{B16(wx_b), b_b, B16(wh_b), B16(peep_b), B16(h0_b), c0_b,
                   static_cast<bf16*>(hs_b), cs_b, hT_b, cT_b};
  const dim3 grid((B + kRowsB - 1) / kRowsB, 2);
  bilstm_fwd_bf16_kernel<<<grid, kThreadsB, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), mask, fw, bw, B, T, E, D);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

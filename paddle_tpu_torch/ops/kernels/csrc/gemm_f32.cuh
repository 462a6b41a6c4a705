// Shared f32 GEMM tile for the port's convolution kernels (brgemm.cu,
// conv2d_direct.cu): C[M, N] = A[M, Kred] . B[Kred, N] with an f32
// accumulator in registers and a fused epilogue before the one store.
//
// B is row-major [Kred, N] in device memory (a weight matrix).  A is never
// materialised: a Loader gives the address of A(m, k), so one tile serves
// the batch-reduce GEMM (A is a stack of matrices, or the strided pixel
// rows of an NHWC image) and the implicit-GEMM convolution (A is the patch
// matrix, read from the image by index math).  A Loader provides
//
//   struct Row;     __device__ Row row(int m) const;      // m >= M: masked
//   struct Cursor;  __device__ Cursor cursor(int k) const;
//   __device__ void advance(Cursor&, int step) const;      // k += step
//   __device__ const float* src(const Row&, const Cursor&, bool& ok) const;
//
// src gives the address of A(m, k) and whether it holds data (in range:
// m < M, k < Kred, the tap inside the image); a masked element's address
// is the Loader's base pointer, a valid one to hand the copy.  The
// cursor walks the reduction by increments, so the per-stage index math
// is an add and a compare, not a division.
//
// What bounds it on an H100: operations at the 3x3 and 5x5 convs (e.g.
// ResNet-50's res2 3x3 at batch 64, ~140 flop per byte of x and y), bytes
// near the short-reduction 1x1 convs (res2 branch2c, K = 64: ~26 flop per
// byte, close to the ~20 of f32 FMA at 67 TFLOP/s over 3.35 TB/s).  The
// port computes in f32 with TF32 off, and the tensor cores take f32
// operands only as TF32 (wgmma, mma.sync), so this is a CUDA-core (SIMT)
// design aimed at the f32 FMA rate.  What it does about it:
//
// - The ring: operands are copied global -> shared with cp.async (no
//   register staging) into a ring of kStages slices, each kBK = 16 deep;
//   the copies of slice s + kStages - 1 are in flight while slice s is
//   computed, with one barrier a slice.  Masked elements (padding taps,
//   rows past M, the reduction's tail) are zero-filled by the copy's
//   source-size operand, so the compute loop has no branch.
// - Two copy forms, chosen per launch by the caller's plan: the 16-byte
//   form (cp.async.cg) moves 4 consecutive reduction elements of A and 4
//   columns of B a copy; it needs the reduction's contiguous run (a
//   conv's Cin, the BRGEMM's K) and N to be multiples of 4 and 16-byte
//   aligned operands.  The 4-byte form (cp.async.ca) moves one element and
//   takes any shape (Cin 1 and 3 convs, odd K or N, an unaligned view).
// - Register fragments read as float4: A sits in shared memory row-major
//   ([m][k], as the copies land), so one LDS.128 gives a row 4 reduction
//   steps; B sits [k][n], so one LDS.128 gives 4 columns.  A thread's
//   8 x 8 accumulator then takes 2 + 2 LDS.128 for its 64 FMAs a
//   reduction step, and the epilogue stores float4 rows.
// - A BM x 64 tile runs (BM / 8) x 8 threads; thread (ty, tx) owns rows
//   ty + (BM / 8) i and columns 32 h + 4 tx + {0..3}.  A warp's A reads
//   are 4 rows, each a broadcast to a quarter-warp; its B reads and C
//   stores 128 contiguous bytes.  A thread copies 4 consecutive floats of
//   A (or B) a pass in both forms: one 16-byte copy, or four 4-byte ones,
//   and a warp's copies of A fill 512 contiguous bytes of a slice.
// - Two tiles, 128 x 64 (128 threads, 3 blocks an SM at 168 registers)
//   and 64 x 64 (64 threads, 6 an SM): at one block an SM, a 128 x 128
//   tile measured slower on every shape, with no other block to run while
//   one loads or stores.
// - Blocks are numbered column tile fastest, so the column tiles of one
//   row tile run together and read their A rows from L2.
// - A split of the reduction where the smallest tile's grid does not fill
//   the card (ResNet-50's res5, small_vgg's last group): each block stores
//   its raw partial sum to scratch, and split_reduce adds the splits in
//   order, then applies the epilogue and the stats; no atomics.
// - The tile (block_m x block_n), the copy form and the split come from
//   the caller (ops/kernels/brgemm.py, ``plan``), which also sizes the
//   stats partials by the same block_m: one source of tile geometry.
//
// Epilogue, on the accumulator before the store:
//   - stats: per-column sum and sum of squares of the pre-epilogue
//     accumulator over the valid rows of the block, written as one partial
//     per row tile (no atomics), through scratch that reuses the drained
//     ring; stats_reduce then sums the partials of each column in a fixed
//     order, so a rerun is bit-identical;
//   - affine: y = acc * scale[n] + shift[n] (the inference-mode BN fold);
//   - relu.
// Rows past M and columns past N are masked in the copies and the stores;
// nothing is padded in memory.

#pragma once

#include <climits>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gemm {

constexpr int kBK = 16;        // reduction depth of one ring slice
constexpr int kStages = 4;     // ring slices (a power of 2)

struct Epilogue {
  const float* scale;  // [N] or null
  const float* shift;  // [N] or null (set with scale)
  int relu;
  float* partial;      // [2, row_tiles, N] or null: per-tile sum, sumsq
};

// A BM x BN tile: (BM / 8) x (BN / 8) threads, 8 x 8 outputs each.
template <int BM, int BN>
struct Tile {
  static constexpr int kThreads = BM * BN / 64;
  static constexpr int kTX = BN / 8, kTY = BM / 8;  // thread grid
  static constexpr int kAFloats = BM * kBK;          // A as [BM][kBK]
  static constexpr int kStage = kAFloats + kBK * BN;  // floats of one slice
  static constexpr int kSmemBytes = kStages * kStage * 4;
  // a thread copies 4 consecutive floats (one 16-byte or four 4-byte
  // copies) of a row of A (4 reduction steps) or of B (4 columns)
  static constexpr int kARows = kThreads / (kBK / 4);  // A rows a pass
  static constexpr int kAPasses = BM / kARows;
  static constexpr int kBRows = kThreads / (BN / 4);   // B rows a pass
  static constexpr int kBPasses = kBK / kBRows;
  static_assert(kAPasses >= 1 && kBPasses >= 1, "copy passes");
  static_assert(2 * kTY * BN <= kStages * kStage, "stats scratch fits");
  // past 48 KB a launch would need cudaFuncSetAttribute's opt-in
  static_assert(kSmemBytes <= 48 * 1024, "the ring fits without opt-in");
};

// Copy kBytes (16 or 4) from global to shared memory, asynchronously; a
// masked copy reads nothing and writes zeros (source size 0).
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(n));
  } else {
    static_assert(kBytes == 4, "16- or 4-byte copies");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ float elem(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One block: the BM x BN output tile (mt, nt) over reduction slices
// [split * split_slices, + split_slices).  Without a split (ws null) the
// block applies the epilogue and stores y; with one it stores its raw
// partial sum to ws[split] and split_reduce finishes.
template <int BM, int BN, bool kVec, class Loader>
__global__ void __launch_bounds__(BM * BN / 64)
gemm_kernel(Loader A, const float* __restrict__ b, int M, int N, int Kred,
            int n_tiles, int m_tiles, int split_slices,
            float* __restrict__ y, float* __restrict__ ws, Epilogue ep) {
  using T = Tile<BM, BN>;
  using Cursor = typename Loader::Cursor;
  constexpr int kTX = T::kTX, kTY = T::kTY;

  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int nt = blockIdx.x % n_tiles, mt = blockIdx.x / n_tiles % m_tiles;
  const int split = blockIdx.x / n_tiles / m_tiles;
  const int m0 = mt * BM, n0 = nt * BN, k0 = split * split_slices * kBK;
  float* out = y;
  if (ws != nullptr) {  // a split: the raw sum, no epilogue
    out = ws + (long long)split * M * N;
    ep = Epilogue{nullptr, nullptr, 0, nullptr};
  }

  const int a_c = 4 * (tid % (kBK / 4)), a_r = tid / (kBK / 4);
  typename Loader::Row rows[T::kAPasses];
#pragma unroll
  for (int i = 0; i < T::kAPasses; ++i)
    rows[i] = A.row(m0 + a_r + T::kARows * i);
  Cursor cur = A.cursor(k0 + a_c);
  const int b_n = 4 * (tid % (BN / 4)), b_k = tid / (BN / 4);

  // slice s of the reduction into ring slot s % kStages; slices are
  // loaded in order, so the cursor advances by one slice a call
  auto load_slice = [&](int s) {
    float* As = smem + (s % kStages) * T::kStage;
    float* Bs = As + T::kAFloats;
    Cursor u[kVec ? 1 : 4];  // the thread's 4 reduction steps
    u[0] = cur;
#pragma unroll
    for (int e = 1; e < (kVec ? 1 : 4); ++e) {
      u[e] = u[e - 1];
      A.advance(u[e], 1);
    }
#pragma unroll
    for (int i = 0; i < T::kAPasses; ++i) {
      float* d = As + (a_r + T::kARows * i) * kBK + a_c;
#pragma unroll
      for (int e = 0; e < (kVec ? 1 : 4); ++e) {
        bool ok;
        const float* p = A.src(rows[i], u[e], ok);
        cp_async<kVec ? 16 : 4>(d + e, p, ok);
      }
    }
    A.advance(cur, kBK);
#pragma unroll
    for (int i = 0; i < T::kBPasses; ++i) {
      const int k = k0 + s * kBK + b_k + T::kBRows * i;
      float* d = Bs + (b_k + T::kBRows * i) * BN + b_n;
      const float* p = b + (long long)k * N + n0 + b_n;
#pragma unroll
      for (int e = 0; e < (kVec ? 1 : 4); ++e) {
        // the 16-byte form has N % 4 == 0: its 4 columns are in or out
        const bool ok = k < Kred && n0 + b_n + e < N;
        cp_async<kVec ? 16 : 4>(d + e, ok ? p + e : b, ok);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  const int steps = min(split_slices, (Kred - k0 + kBK - 1) / kBK);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_slice(s);
    cp_async_commit();  // an empty group keeps the count uniform
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();  // slice s has landed (this thread's)
    // ... and everyone's; and every thread is past slice s - 1, whose
    // slot the next copies overwrite
    __syncthreads();
    if (s + kStages - 1 < steps) load_slice(s + kStages - 1);
    cp_async_commit();
    const float* As = smem + (s % kStages) * T::kStage;
    const float* Bs = As + T::kAFloats;
#pragma unroll
    for (int k4 = 0; k4 < kBK; k4 += 4) {
      float4 a[8];  // the thread's 8 rows at 4 reduction steps
#pragma unroll
      for (int r = 0; r < 8; ++r)
        a[r] = *reinterpret_cast<const float4*>(
            As + (ty + kTY * r) * kBK + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[8];  // the thread's 8 columns at one step
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              Bs + (k4 + kk) * BN + (BN / 2) * h + 4 * tx);
          bv[4 * h] = v.x;
          bv[4 * h + 1] = v.y;
          bv[4 * h + 2] = v.z;
          bv[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            acc[r][c] = fmaf(elem(a[r], kk), bv[c], acc[r][c]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained: its memory is free

  // the thread's rows are ty + kTY r, its columns n0 + col(c)
  auto col = [&](int c) { return (BN / 2) * (c / 4) + 4 * tx + (c % 4); };

  if (ep.partial != nullptr) {
    float* red = smem;  // [2][kTY][BN]
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (m0 + ty + kTY * r < M) {
          s += acc[r][c];
          ss += acc[r][c] * acc[r][c];
        }
      }
      red[ty * BN + col(c)] = s;
      red[(kTY + ty) * BN + col(c)] = ss;
    }
    __syncthreads();
    for (int i = tid; i < 2 * BN; i += T::kThreads) {
      const int mo = i / BN, cc = i % BN;
      if (n0 + cc < N) {
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < kTY; ++j) t += red[(kTY * mo + j) * BN + cc];
        ep.partial[((long long)mo * m_tiles + mt) * N + n0 + cc] = t;
      }
    }
  }

  float sc[8], sh[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int n = n0 + col(c);
    const bool ok = ep.scale != nullptr && n < N;
    sc[c] = ok ? ep.scale[n] : 1.f;
    sh[c] = ok ? ep.shift[n] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int m = m0 + ty + kTY * r;
    if (m >= M) continue;
    float* yr = out + (long long)m * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * h + e;
        v[e] = acc[r][c];
        if (ep.scale != nullptr) v[e] = fmaf(v[e], sc[c], sh[c]);
        if (ep.relu) v[e] = fmaxf(v[e], 0.f);
      }
      const int n = n0 + (BN / 2) * h + 4 * tx;
      if (kVec) {
        if (n < N)
          *reinterpret_cast<float4*>(yr + n) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) yr[n + e] = v[e];
      }
    }
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A split reduction's second pass: y[m, n] = epilogue(sum over the
// splits of ws[split, m, n], in split order), a thread a column and a
// block a tile of `rows` rows; with stats, the column's sum and sumsq
// over the tile's rows, in row order, as its per-row-tile partial.  y is
// f32, or bf16 (gemm_bf16.cuh: one rounding of the f32 result).
template <class OutT>
__global__ void __launch_bounds__(128)
split_reduce(const float* __restrict__ ws, int splits, int M, int N,
             int rows, OutT* __restrict__ y, Epilogue ep) {
  const int n = blockIdx.x * 128 + threadIdx.x;
  if (n >= N) return;
  const int m0 = blockIdx.y * rows, m1 = min(M, m0 + rows);
  const long long mn = (long long)M * N;
  const float sc = ep.scale != nullptr ? ep.scale[n] : 1.f;
  const float sh = ep.scale != nullptr ? ep.shift[n] : 0.f;
  float s = 0.f, ss = 0.f;
  for (int m = m0; m < m1; ++m) {
    const long long o = (long long)m * N + n;
    float acc = ws[o];
    for (int p = 1; p < splits; ++p) acc += ws[p * mn + o];
    s += acc;
    ss += acc * acc;
    float v = acc;
    if (ep.scale != nullptr) v = fmaf(v, sc, sh);
    if (ep.relu) v = fmaxf(v, 0.f);
    store(y + o, v);
  }
  if (ep.partial != nullptr) {
    ep.partial[(long long)blockIdx.y * N + n] = s;
    ep.partial[((long long)gridDim.y + blockIdx.y) * N + n] = ss;
  }
}

// sum[n], sumsq[n] from the per-row-tile partials [2, tiles, N]: 32 warps
// each sum a fixed stride of tiles for 32 columns, then warp 0 adds the 32
// partials in order — a fixed summation order, so reruns are bit-identical.
__global__ void __launch_bounds__(1024)
stats_reduce(const float* __restrict__ partial, int tiles, int N,
             float* __restrict__ sum, float* __restrict__ sumsq) {
  __shared__ float part[32][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane, mo = blockIdx.y;
  float t = 0.f;
  if (n < N) {
    const float* p = partial + (long long)mo * tiles * N + n;
    for (int i = w; i < tiles; i += 32) t += p[(long long)i * N];
  }
  part[w][lane] = t;
  __syncthreads();
  if (w == 0 && n < N) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) s += part[j][lane];
    (mo == 0 ? sum : sumsq)[n] = s;
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// The tiles the plan may name (ops/kernels/brgemm.py, Form.tiles), for
// every form: f(BM, BN, kVec), as integral constants, at the
// instantiation that (block_m, block_n, vec) names; or
// cudaErrorInvalidValue.
template <class F>
cudaError_t dispatch(int block_m, int block_n, int vec, F&& f) {
  auto form = [&](auto bm, auto bn) {
    return vec ? f(bm, bn, std::true_type{}) : f(bm, bn, std::false_type{});
  };
  if (block_m == 128 && block_n == 64)
    return form(std::integral_constant<int, 128>{},
                std::integral_constant<int, 64>{});
  if (block_m == 64 && block_n == 64)
    return form(std::integral_constant<int, 64>{},
                std::integral_constant<int, 64>{});
  return cudaErrorInvalidValue;
}

// A form of the shared tile, as launch and resident take it: the element
// type of b and y, the depth of a ring slice, the elements of one 16-byte
// copy and whether it has the 16-byte copy form, the tile's geometry
// (Tile<BM, BN>::kThreads, ::kSmemBytes) and its kernel.  This is the
// f32 SIMT tile; gemm_bf16.cuh's mma::Form the bf16 mma.sync one
// (gemm_wgmma.cuh's Hopper tile has a launch of its own).
struct F32Form {
  using Elem = float;
  static constexpr int kBK = gemm::kBK, kVecElems = 4;
  static constexpr bool kVec16 = true;  // both copy forms
  template <int BM, int BN>
  using Tile = gemm::Tile<BM, BN>;
  template <int BM, int BN, bool kVec, class Loader>
  static auto kernel() { return &gemm_kernel<BM, BN, kVec, Loader>; }
};

// Blocks of Form's block_m x block_n tile in the copy form vec that one SM
// of the current card holds at once (its registers, shared memory and
// threads allow), as the CUDA runtime computes it; or -(CUDA error).
template <class Form, class Loader>
int resident(int block_m, int block_n, int vec) {
  if (vec && !Form::kVec16) return -(int)cudaErrorInvalidValue;
  int n = 0;
  const cudaError_t err =
      dispatch(block_m, block_n, vec, [&](auto bm, auto bn, auto v) {
        constexpr int BM = decltype(bm)::value, BN = decltype(bn)::value;
        using T = typename Form::template Tile<BM, BN>;
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, Form::template kernel<BM, BN, decltype(v)::value, Loader>(),
            T::kThreads, T::kSmemBytes);
      });
  return err == cudaSuccess ? n : -(int)err;
}

// One GEMM in Form at the planned tile (block_m x block_n), copy form (vec)
// and split of the reduction (splits; ws [splits, M, N] f32 scratch when
// > 1), then the split's second pass, then, when partial is set, the
// stats reduction over the ceil(M / block_m) row tiles; returns the first
// CUDA error, or 0.  b and y are Form::Elem; scale, shift, ws, partial,
// sum and sumsq f32.  The 16-byte form needs N % Form::kVecElems == 0 and
// b, y (and ws) 16-byte aligned; the Loader's own conditions are its
// caller's to check.
template <class Form, class Loader>
int launch(const Loader& A, const typename Form::Elem* b, int M, int N,
           int Kred, typename Form::Elem* y, int block_m, int block_n,
           int vec, int splits, float* ws, const float* scale,
           const float* shift, int relu, float* partial, float* sum,
           float* sumsq, cudaStream_t stream) {
  const Epilogue ep{scale, shift, relu, partial};
  const int slices = (Kred + Form::kBK - 1) / Form::kBK;
  if (splits < 1 || splits > slices ||
      (splits > 1 && (ws == nullptr || !aligned16(ws))) ||
      (vec && (!Form::kVec16 || N % Form::kVecElems != 0 || !aligned16(b) ||
               !aligned16(y))))
    return (int)cudaErrorInvalidValue;
  const int split_slices = (slices + splits - 1) / splits;
  cudaError_t err =
      dispatch(block_m, block_n, vec, [&](auto bm, auto bn, auto v) {
        constexpr int BM = decltype(bm)::value, BN = decltype(bn)::value;
        using T = typename Form::template Tile<BM, BN>;
        const int n_tiles = (N + BN - 1) / BN, m_tiles = (M + BM - 1) / BM;
        const long long blocks = (long long)m_tiles * n_tiles * splits;
        if (blocks > INT_MAX) return cudaErrorInvalidValue;
        const auto kernel =
            Form::template kernel<BM, BN, decltype(v)::value, Loader>();
        kernel<<<(unsigned)blocks, T::kThreads, T::kSmemBytes, stream>>>(
            A, b, M, N, Kred, n_tiles, m_tiles, split_slices, y,
            splits > 1 ? ws : nullptr, ep);
        return cudaGetLastError();
      });
  if (err != cudaSuccess) return (int)err;
  const int tiles = (M + block_m - 1) / block_m;
  if (splits > 1) {
    split_reduce<<<dim3((N + 127) / 128, tiles), 128, 0, stream>>>(
        ws, splits, M, N, block_m, y, ep);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (partial == nullptr) return 0;
  const dim3 grid((N + 31) / 32, 2);
  stats_reduce<<<grid, 1024, 0, stream>>>(partial, tiles, N, sum, sumsq);
  return (int)cudaGetLastError();
}

}  // namespace gemm

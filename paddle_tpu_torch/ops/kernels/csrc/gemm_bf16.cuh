// The mma.sync bf16 GEMM tile of the port's convolution kernels (brgemm.cu,
// conv2d_direct.cu): C[M, N] = A[M, Kred] . B[Kred, N] from bf16 operands
// on the tensor cores, with f32 accumulators in registers and the fused
// epilogue of gemm_f32.cuh before one rounding to bf16 and one store.
//
// The bf16 forms of the TPU kernels rows 14 and 15 replace
// (paddle_tpu/ops/pallas/tpp/brgemm.py::_kernel and tpp/conv.py::
// _conv_kernel): bf16 operands fed to the MXU with
// preferred_element_type=f32, the stats taken from the f32 accumulator,
// affine + ReLU in f32, the output written in the operands' dtype.
//
// A and its Loader are gemm_f32.cuh's contract (row, cursor, advance,
// src), with src giving a bf16 address: one tile serves the BRGEMM's
// stacked or strided rows, the strided 1x1's row map and the direct
// conv's implicit patch matrix.
//
// What bounds it on an H100: at bf16 the card does ~295 tensor-core
// flops for every byte it reads (989 TFLOP/s over 3.35 TB/s), so every
// ResNet-50 conv at batch 64 is bound by its bytes on paper (res2's 3x3:
// 14.8 GFLOP against ~52 MB, ~285 flop/byte, at the line; the 1x1s with
// K = 64 ~26).  This first design is simple and right, not fast:
//
// - Products: mma.sync.m16n8k16 (bf16 x bf16 + f32; the copies, loads and
//   product of mma_bf16.cuh), 4 warps a block in a
//   2 x 2 grid, each warp a (BM / 2) x (BN / 2) tile of m16n8 fragments.
//   A's fragments come from shared memory [m][k] by ldmatrix.x4, B's from
//   [k][n] (the HWIO / [K, N] weight as it lies in memory) by
//   ldmatrix.x4.trans, two n8 fragments a load.  Shared rows are padded
//   by 8 elements (16 bytes), so the 8 rows an ldmatrix phase reads fall
//   in 8 distinct groups of 4 banks.
// - The ring: kStages slices of kBK = 32 reduction steps, staged through
//   registers (cp.async has no 2-byte form, and the shapes this tile
//   takes are the ones 16-byte copies cannot read: the stem's Cin 3,
//   small_vgg's first conv, unaligned views): the slice s + kStages - 1
//   is read from global memory into registers before slice s is
//   computed and stored to shared memory after it.  Masked elements
//   (padding taps, rows past M, the reduction's tail up to the mma's
//   k = 16 and the slice's 32) are zero.
// - Epilogue, on the f32 accumulators: the stats (per-column sum and sum
//   of squares, butterfly shuffles over a warp's rows, then the two warps
//   of a column in order, one partial a row tile; gemm::stats_reduce
//   sums the partials in a fixed order); affine + ReLU in f32; one
//   round-to-nearest-even to bf16 (__floats2bfloat162_rn) and one store.
//   A split of the reduction stores raw f32 sums and gemm::split_reduce
//   finishes; no atomics anywhere, so a rerun gives the same bits.
//
// Every bf16 shape whose copies can be 16 bytes wide takes the Hopper
// tile (gemm_wgmma.cuh: wgmma, TMA, a warp-specialised mbarrier ring,
// persistent) instead.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

#include "gemm_f32.cuh"
#include "mma_bf16.cuh"

namespace gemm {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kBK = 32;       // reduction depth of one ring slice
constexpr int kStages = 3;    // ring slices
constexpr int kThreads = 128;  // 4 warps, 2 x 2
constexpr int kPad = 8;       // bf16 of padding a shared row

// A BM x BN tile: 4 warps, each (BM / 2) x (BN / 2) of m16n8 fragments.
template <int BM, int BN>
struct Tile {
  static constexpr int kThreads = mma::kThreads;
  static constexpr int kWM = BM / 2, kWN = BN / 2;       // a warp's tile
  static constexpr int kMI = kWM / 16, kNI = kWN / 8;     // its fragments
  static constexpr int kALd = kBK + kPad, kBLd = BN + kPad;  // row strides
  static constexpr int kAElems = BM * kALd;
  static constexpr int kStageElems = kAElems + kBK * kBLd;
  static constexpr int kSmemBytes = kStages * kStageElems * 2;
  // a thread copies chunks of 8 consecutive bf16: of a row of A (8
  // reduction steps) or of B (8 columns)
  static constexpr int kAPasses = BM * kBK / 8 / kThreads;
  static constexpr int kARows = kThreads / (kBK / 8);   // A rows a pass
  static constexpr int kBPasses = kBK * BN / 8 / kThreads;
  static constexpr int kBRows = kThreads / (BN / 8);    // B rows a pass
  static_assert(kMI >= 1 && kNI % 2 == 0, "x4.trans loads n8 pairs");
  static_assert(kAPasses >= 1 && kBPasses >= 1, "copy passes");
  static_assert(4 * BN * 4 <= kSmemBytes, "stats scratch fits");
  static_assert(kSmemBytes <= 48 * 1024, "the ring fits without opt-in");
};

using bf16_tc::ldmatrix_x4;
using bf16_tc::ldmatrix_x4_trans;
using bf16_tc::mma_bf16;

// the bits of *p, or 0 (a bf16 zero) when the element is masked
__device__ __forceinline__ uint32_t bits(const bf16* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const unsigned short*>(p)) : 0u;
}

__device__ __forceinline__ uint4 pack(const uint32_t (&v)[8]) {
  return make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16,
                    v[4] | v[5] << 16, v[6] | v[7] << 16);
}

// One block: the BM x BN output tile (mt, nt) over reduction slices
// [split * split_slices, + split_slices).  Without a split (ws null) the
// block applies the epilogue and stores y in bf16; with one it stores its
// raw f32 sum to ws[split] and split_reduce finishes.
template <int BM, int BN, class Loader>
__global__ void __launch_bounds__(kThreads)
mma_kernel(Loader A, const bf16* __restrict__ b, int M, int N, int Kred,
           int n_tiles, int m_tiles, int split_slices,
           bf16* __restrict__ y, float* __restrict__ ws, Epilogue ep) {
  using T = Tile<BM, BN>;
  using Cursor = typename Loader::Cursor;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int nt = blockIdx.x % n_tiles, mt = blockIdx.x / n_tiles % m_tiles;
  const int split = blockIdx.x / n_tiles / m_tiles;
  const int m0 = mt * BM, n0 = nt * BN, k0 = split * split_slices * kBK;
  if (ws != nullptr) ep = Epilogue{nullptr, nullptr, 0, nullptr};

  const int a_c = 8 * (tid % (kBK / 8)), a_r = tid / (kBK / 8);
  typename Loader::Row rows[T::kAPasses];
#pragma unroll
  for (int i = 0; i < T::kAPasses; ++i)
    rows[i] = A.row(m0 + a_r + T::kARows * i);
  Cursor cur = A.cursor(k0 + a_c);
  const int b_n = 8 * (tid % (BN / 8)), b_k = tid / (BN / 8);

  auto a_dst = [&](int s, int i) {
    return smem + (s % kStages) * T::kStageElems +
           (a_r + T::kARows * i) * T::kALd + a_c;
  };
  auto b_dst = [&](int s, int i) {
    return smem + (s % kStages) * T::kStageElems + T::kAElems +
           (b_k + T::kBRows * i) * T::kBLd + b_n;
  };
  auto b_row = [&](int s, int i) { return k0 + s * kBK + b_k + T::kBRows * i; };

  // slice s into registers, element by element
  uint4 stage_a[T::kAPasses], stage_b[T::kBPasses];
  auto fetch_slice = [&](int s) {
    Cursor u[8];
    u[0] = cur;
#pragma unroll
    for (int e = 1; e < 8; ++e) {
      u[e] = u[e - 1];
      A.advance(u[e], 1);
    }
    A.advance(cur, kBK);
#pragma unroll
    for (int i = 0; i < T::kAPasses; ++i) {
      uint32_t v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        bool ok;
        const bf16* p = A.src(rows[i], u[e], ok);
        v[e] = bits(p, ok);
      }
      stage_a[i] = pack(v);
    }
#pragma unroll
    for (int i = 0; i < T::kBPasses; ++i) {
      const int k = b_row(s, i);
      uint32_t v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool ok = k < Kred && n0 + b_n + e < N;
        v[e] = bits(b + (long long)k * N + n0 + b_n + e, ok);
      }
      stage_b[i] = pack(v);
    }
  };
  auto store_slice = [&](int s) {
#pragma unroll
    for (int i = 0; i < T::kAPasses; ++i)
      *reinterpret_cast<uint4*>(a_dst(s, i)) = stage_a[i];
#pragma unroll
    for (int i = 0; i < T::kBPasses; ++i)
      *reinterpret_cast<uint4*>(b_dst(s, i)) = stage_b[i];
  };

  float acc[T::kMI][T::kNI][4];
#pragma unroll
  for (int i = 0; i < T::kMI; ++i)
#pragma unroll
    for (int j = 0; j < T::kNI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  auto compute = [&](int s) {
    const bf16* As = smem + (s % kStages) * T::kStageElems;
    const bf16* Bs = As + T::kAElems;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[T::kMI][4], bfr[T::kNI / 2][4];
#pragma unroll
      for (int i = 0; i < T::kMI; ++i)
        ldmatrix_x4(af[i], As + (wm * T::kWM + 16 * i + lane % 16) * T::kALd +
                               kk + 8 * (lane / 16));
#pragma unroll
      for (int j = 0; j < T::kNI / 2; ++j)
        ldmatrix_x4_trans(bfr[j], Bs + (kk + lane % 16) * T::kBLd +
                                      wn * T::kWN + 16 * j + 8 * (lane / 16));
#pragma unroll
      for (int i = 0; i < T::kMI; ++i)
#pragma unroll
        for (int j = 0; j < T::kNI; ++j)
          mma_bf16(acc[i][j], af[i], bfr[j / 2][2 * (j % 2)],
                   bfr[j / 2][2 * (j % 2) + 1]);
    }
  };

  const int steps = min(split_slices, (Kred - k0 + kBK - 1) / kBK);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      fetch_slice(s);
      store_slice(s);
    }
  }
  for (int s = 0; s < steps; ++s) {
    // slice s is everyone's; every thread is past slice s - 1, whose slot
    // the next stores overwrite
    __syncthreads();
    const int next = s + kStages - 1;
    if (next < steps) fetch_slice(next);  // in flight while s computes
    compute(s);
    if (next < steps) store_slice(next);
  }
  __syncthreads();  // the ring is done: its memory is free

  // the thread's fragment element c of (i, j) is row
  // wm * kWM + 16 i + g + 8 (c / 2), column wn * kWN + 8 j + 2 t + c % 2
  const int g = lane >> 2, t = lane & 3;
  if (ep.partial != nullptr) {
    float* red = reinterpret_cast<float*>(smem_raw);  // [sum, sumsq][wm][BN]
#pragma unroll
    for (int j = 0; j < T::kNI; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = 0.f, ss = 0.f;  // rows past M hold zeros
#pragma unroll
        for (int i = 0; i < T::kMI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v = acc[i][j][2 * h + e];
            s += v;
            ss += v * v;
          }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {  // over g, in a fixed order
          s += __shfl_xor_sync(0xffffffffu, s, off);
          ss += __shfl_xor_sync(0xffffffffu, ss, off);
        }
        if (g == 0) {
          const int c = wn * T::kWN + 8 * j + 2 * t + e;
          red[wm * BN + c] = s;
          red[(2 + wm) * BN + c] = ss;
        }
      }
    __syncthreads();
    for (int i = tid; i < 2 * BN; i += kThreads) {
      const int mo = i / BN, c = i % BN;
      if (n0 + c < N)
        ep.partial[((long long)mo * m_tiles + mt) * N + n0 + c] =
            red[2 * mo * BN + c] + red[(2 * mo + 1) * BN + c];
    }
  }

  float sc[T::kNI][2], sh[T::kNI][2];
#pragma unroll
  for (int j = 0; j < T::kNI; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn * T::kWN + 8 * j + 2 * t + e;
      const bool ok = ep.scale != nullptr && n < N;
      sc[j][e] = ok ? ep.scale[n] : 1.f;
      sh[j][e] = ok ? ep.shift[n] : 0.f;
    }
  float* wsp = ws == nullptr ? nullptr : ws + (long long)split * M * N;
#pragma unroll
  for (int i = 0; i < T::kMI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * T::kWM + 16 * i + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < T::kNI; ++j) {
        const int n = n0 + wn * T::kWN + 8 * j + 2 * t;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = acc[i][j][2 * h + e];
          if (ep.scale != nullptr) v[e] = fmaf(v[e], sc[j][e], sh[j][e]);
          if (ep.relu) v[e] = fmaxf(v[e], 0.f);
        }
        const long long o = (long long)m * N + n;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n + e >= N) continue;
          if (wsp != nullptr)
            wsp[o + e] = v[e];
          else
            y[o + e] = __float2bfloat16_rn(v[e]);
        }
      }
    }
}

// The bf16 tensor-core tile as gemm::launch and gemm::resident (in
// gemm_f32.cuh) take it: bf16 b and y, 32-deep slices, the
// register-staged copy form only (gemm::launch refuses vec, so the
// kVec the dispatch names never selects a kernel).
struct Form {
  using Elem = bf16;
  static constexpr int kBK = mma::kBK, kVecElems = 8;
  static constexpr bool kVec16 = false;
  template <int BM, int BN>
  using Tile = mma::Tile<BM, BN>;
  template <int BM, int BN, bool kVec, class Loader>
  static auto kernel() { return &mma_kernel<BM, BN, Loader>; }
};

}  // namespace mma
}  // namespace gemm

// The 3xTF32 pieces shared by the f32 flash forward (flash_attention.cu's
// tf32f namespace) and the f32 flash backward (flash_attention_bwd.cu's
// tf32 namespace): every product on the tensor cores by
// mma.sync.m16n8k8 with TF32 operands and f32 accumulators, each f32
// operand a split into a TF32 high part hi = tf32(a) and a TF32 low part
// lo = tf32(a - hi), each rounded to nearest, and a product taken as
// hi.hi + hi.lo + lo.hi (the lo.lo term, 2^-22 of it, dropped): the
// counterpart of the reference's Precision.HIGHEST.  Also the 16-byte
// cp.async copy of a 64-row tile from a [B, T, H, D] f32 tensor as it
// lies.
//
// - The fragment order: the m16n8 accumulator holds columns 2t and 2t + 1
//   of a thread's rows where the m16n8k8 A fragment wants columns t and
//   t + 4, so a product whose A is an earlier product's accumulator (P V
//   from S, dS K from dS) runs the reduction over a slice's 8 columns in
//   the order (0, 2, 4, 6, 1, 3, 5, 7) instead: the accumulator tile
//   (c0, c1, c2, c3) is the A fragment (c0, c2, c1, c3) as it lies, with
//   no shuffle and no pass through shared memory, and B's rows are the
//   slice's rows 2t and 2t + 1.
// - The rounding: tf32's round to nearest (ties away, the bits cvt.rna
//   gives) by two integer operations; the conversion instruction issues
//   at a quarter of the ALU rate.
// - The sums: the tensor cores truncate the sums they round, so a chain
//   of T / 8 slices into one accumulator drifts toward zero (1.1e-5 of
//   the flash gradients against float64 at T 1024, 14x the FMA form's).
//   A long sum takes each slice's three passes summed apart from zero and
//   added to the accumulator to nearest (mma3_add).  The D / 8 slices of
//   a score chain at head_dim <= 64 and are summed apart at 128
//   (kSliceApart).

#pragma once

#include <cstdint>

#include "mma_bf16.cuh"

namespace tf32x3 {

constexpr int kB = 64;  // rows of a query tile and of a key tile

// shared rows are D + 4 floats apart, so both fragment patterns (rows g,
// columns t; rows 2t, columns g) fall on 32 distinct banks
template <int D>
__host__ __device__ constexpr int ld() { return D + 4; }

template <int D>
__host__ __device__ constexpr int tile_floats() { return kB * ld<D>(); }

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero; the same bits for every finite x), by two integer operations:
// half of the 13 dropped bits' unit added to the magnitude, then the
// dropped bits cleared.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + (what TF32 drops of lo), hi and lo each rounded to nearest
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a . b: one m16n8k8 product, tf32 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

// An A fragment of f32 values split into its TF32 parts
struct SplitA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

// d += a . b in three passes, the small terms first: lo.hi, hi.lo, hi.hi
__device__ __forceinline__ void mma3(float (&d)[4], const SplitA& a,
                                     float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(d, a.lo, bh0, bh1);
  mma(d, a.hi, bl0, bl1);
  mma(d, a.hi, bh0, bh1);
}

// d += a . b with the slice's three passes summed apart from zero and
// added to d to nearest (the tensor cores truncate the sums they round)
__device__ __forceinline__ void mma3_add(float (&d)[4], const SplitA& a,
                                         float b0, float b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(t, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// whether a score (D / 8 slices deep) sums each slice apart too
template <int D>
constexpr bool kSliceApart = D > 64;

// The rows of one (b, h) of a [B, T, H, D] f32 tensor: row t at
// base + t * stride, d contiguous
struct Rows {
  const float* base;
  long long stride;
};

// Up to four [B, T, H, D] f32 operands as they lie: pointers and (b, t,
// h) element strides (multiples of 4, 16-byte aligned bases)
struct Operands {
  const float* x[4];
  long long sb[4], st[4], sh[4];

  __device__ __forceinline__ Rows rows(int i, int b, int h) const {
    return {x[i] + b * sb[i] + h * sh[i], st[i]};
  }
};

// whether the first n operands are not as the kernels read them (a null
// or a base off 16 bytes, a (b, t, h) stride that is not a multiple of 4
// floats), or the grid of 64-row tiles over tqp queries or t_k keys is
// too tall
inline bool bad_operands(const Operands& ops, int n, int tqp, int t_k) {
  for (int i = 0; i < n; ++i)
    if (!ops.x[i] || reinterpret_cast<uintptr_t>(ops.x[i]) % 16 ||
        ops.sb[i] % 4 || ops.st[i] % 4 || ops.sh[i] % 4)
      return true;
  return tqp / kB > 65535 || (t_k + kB - 1) / kB > 65535;
}

// rows row0 .. row0 + 63 of `src` (`rows` of them exist) into shared rows
// D + 4 apart, 16 bytes a copy, every thread of the block taking part
// (thread tid copies the same 16 bytes of every kStep-th row, from one
// pointer stepped by kStep rows); rows at or past `rows` are zero-filled
// by the copy's source size
template <int D, int kThreads>
__device__ __forceinline__ void copy_rows(float* dst, Rows src, int row0,
                                          int rows, int tid) {
  constexpr int kPerRow = D / 4, kStep = kThreads / kPerRow;
  static_assert(kThreads % kPerRow == 0 && kB % kStep == 0, "whole passes");
  const int r0 = tid / kPerRow, e = 4 * (tid % kPerRow);
  const float* p = src.base + (row0 + r0) * src.stride + e;
  const long long jump = kStep * src.stride;
  float* d = dst + r0 * ld<D>() + e;
#pragma unroll
  for (int i = 0; i < kB / kStep; ++i) {
    const bool ok = row0 + r0 + i * kStep < rows;
    bf16_tc::cp_async16(d + i * kStep * ld<D>(), ok ? p + i * jump
                                                     : src.base, ok);
  }
}

}  // namespace tf32x3

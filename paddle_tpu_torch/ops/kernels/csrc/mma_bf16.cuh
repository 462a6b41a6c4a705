// The bf16 tensor-core building blocks shared by the port's bf16 kernels
// (gemm_bf16.cuh's conv tile, the bf16 flash attention forms, the bf16
// LSTM and BiLSTM forms): 16-byte cp.async copies, ldmatrix loads of
// m8n8 bf16 matrices from shared memory, and the mma.sync.m16n8k16
// product with f32 accumulators.
//
// Fragment layouts of mma.sync.m16n8k16 (bf16 operands, f32 sums), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major), 4 registers of 2 bf16 each:
//     a0 = (g, 2t..2t+1)  a1 = (g+8, 2t..2t+1)
//     a2 = (g, 2t+8..)    a3 = (g+8, 2t+8..)
//   B (16 x 8, k x n), 2 registers: b0 = (2t..2t+1, g), b1 = (2t+8.., g)
//   C (16 x 8, f32), 4 floats: c0, c1 = (g, 2t..2t+1); c2, c3 = (g+8, ..)
// So two n8 accumulator tiles side by side (columns 0-7 and 8-15) hold,
// once rounded and packed in pairs, the A fragment of the 16 x 16 matrix
// they form: a0 = (c0, c1) of the first, a1 = (c2, c3) of the first, a2
// and a3 the same of the second (pack_bf16x2).

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace bf16_tc {

using bf16 = __nv_bfloat16;

// 16 bytes global -> shared, asynchronously; a masked copy reads nothing
// and writes zeros (source size 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most kPending of this thread's copy groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// two m8n8 matrices: the addresses of lanes 0-15 are read (one B fragment
// of an n8 tile, b0 and b1)
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 "
               "{%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(s));
}

// d += a . b: one m16n8k16 product, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

// a padded shared row of D bf16, in elements, and a 64-row tile of them
template <int D>
__host__ __device__ constexpr int tile_ld() { return D + 8; }

template <int D>
__host__ __device__ constexpr int tile64_elems() { return 64 * tile_ld<D>(); }

// a 64-row x D bf16 tile (rows D apart in global memory) into shared rows
// D + 8 apart (16 bytes of padding: the 8 rows an ldmatrix phase reads
// fall in 8 distinct groups of 4 banks), 16 bytes a copy, every one of
// the block's kThreads threads taking part
template <int D, int kThreads>
__device__ __forceinline__ void copy_tile64(bf16* dst, const bf16* src,
                                            int tid) {
  constexpr int kPerRow = D / 8;  // 16-byte copies a row
  static_assert(64 * kPerRow % kThreads == 0, "whole passes");
#pragma unroll
  for (int i = 0; i < 64 * kPerRow / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / kPerRow, e = 8 * (c % kPerRow);
    cp_async16(dst + r * tile_ld<D>() + e, src + (size_t)r * D + e, true);
  }
}

// two floats rounded to nearest even bf16, lo in the low half (the lower
// column of a fragment pair)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace bf16_tc

// The Hopper bf16 GEMM tile of the port's convolution kernels (brgemm.cu,
// conv2d_direct.cu): C[M, N] = A[M, Kred] . B[Kred, N] from bf16 operands
// with f32 accumulators, and gemm_f32.cuh's fused epilogue (per-column
// sum and sum of squares, or affine + ReLU) before one rounding to bf16
// and one store.  It takes every bf16 shape whose copies can be 16 bytes
// wide (the reduction's contiguous run and N multiples of 8, 16-byte
// aligned operands); gemm_bf16.cuh's mma.sync tile keeps the rest (the
// stem's Cin 3, unaligned views).
//
// The bf16 forms of the TPU kernels rows 14 and 15 replace
// (paddle_tpu/ops/pallas/tpp/brgemm.py::_kernel and tpp/conv.py::
// _conv_kernel).  What bounds it on an H100: at bf16 the card does ~295
// tensor-core flops for every byte it reads, and ResNet-50's 3x3 convs at
// batch 64 sit near that line (res2: 14.8 GFLOP against ~52 MB), its
// 1x1s below it (bytes).  Only wgmma reaches the tensor cores' full bf16
// rate, so the design is Hopper's.  Measured (PERF.md §6): each 64-deep
// stage's 24-48 KB of operands come from L2 at ~45 GB/s an SM, so the
// tile is bound by L2 traffic, not the tensor cores; a 3x3's patch
// matrix reads x nine times.
//
// - Products: wgmma.mma_async m64nBNk16, both operands in shared memory
//   in the 128-byte swizzle.  A block is 3 warpgroups: two consumers, each
//   64 rows of the 128-row tile, and one producer.  A sits [128][64]
//   K-major (a row's 64 reduction steps are its 128 bytes); B sits as the
//   HWIO / [Kred, N] weight lies in memory, [64][BN] MN-major, read with
//   wgmma's transposed-B flag, as BN / 64 boxes of [64 k][64 n].  A
//   slice of the reduction is 64 deep.
// - Operands: B by TMA (cp.async.bulk.tensor.2d on a CUtensorMap with
//   the 128-byte swizzle, encoded by the C entry with libcuda's encoder
//   looked up at run time, out-of-range rows and columns zero-filled);
//   A, the implicit patch matrix or the 1x1's strided row map, by the
//   producer's 128 threads through gemm_f32.cuh's Loader contract (row,
//   cursor, advance, src): 16-byte cp.async copies, zero-filled where
//   masked, chunk c of row r landing at chunk c ^ (r % 8) as the swizzle
//   wants.
//   TMA's im2col mode was not taken: its windows cannot express the
//   BRGEMM's row map, and one Loader keeps one producer for both kernels.
// - The ring: kStages stages in dynamic shared memory, each with a full
//   and an empty mbarrier.  The full barrier completes on the producer's
//   128 cp.async arrivals (.noinc) and TMA's byte count; a consumer
//   warpgroup arrives on a stage's empty barrier only after the wgmma
//   group that read it has retired (wgmma.wait_group 1 keeps the next
//   group in flight).  The producer gives registers away (setmaxnreg.dec)
//   and the consumers take them (setmaxnreg.inc).
// - Persistent: the grid is the card's SMs times the blocks one SM holds
//   (one); each block walks output tiles b, b + grid, ...  numbered column
//   tile fastest, so the column tiles of one row tile run together and
//   read their A rows from L2.  Where the tiles leave the card idle the
//   plan may split the reduction, and gemm::split_reduce adds the splits
//   in order.  The producer runs ahead into the next tile while the
//   consumers finish one: the ring never drains between tiles.
// - Epilogue, on the f32 accumulators: the wgmma accumulator gives a
//   thread rows g and g + 8 of its warp's 16 and columns 8j + 2t + {0, 1}
//   (g = lane / 4, t = lane % 4), the m16n8 pattern, so the stats are a
//   butterfly over g a column, then the 8 warps' partials added in warp
//   order (one partial a 128-row tile; gemm::stats_reduce sums those in a
//   fixed order); affine + ReLU in f32; one __floats2bfloat162_rn into a
//   warp's 2 KB of staging, read back 16 bytes a lane and stored as whole
//   128-byte rows (the accumulator's own layout writes 16 bytes of each
//   of 8 rows a store).  No atomics: a rerun gives the same bits.
//
// The tile (BN in {64, 128, 256}) and the split come from the caller's
// plan (ops/kernels/brgemm.py, WGMMA), which also sizes the stats
// partials by BM = 128: one source of tile geometry.

#pragma once

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_f32.cuh"

namespace gemm {
namespace wgmma {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;       // two consumer warpgroups of 64 rows
constexpr int kBK = 64;        // reduction depth of a stage: 128 bytes a row
constexpr int kThreads = 384;  // consumers: warpgroups 0, 1; producer: 2
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
static_assert(kThreads / 3 * (kProducerRegs + 2 * kConsumerRegs) <= 65536,
              "the register file holds the three warpgroups");

// The BM x BN tile's shared memory: kStages stages of A [128][64] and
// BN / 64 boxes of B [64][64] (each 1024-byte aligned, as the swizzle's
// 8-row atoms are), the stats scratch [sum, sumsq][8 warps][BN] f32, the
// output's staging (2 KB a consumer warp), the barriers.
template <int BN>
struct Tile {
  static constexpr int kStages = BN == 256 ? 4 : 6;
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kBoxBytes = kBK * 64 * 2;
  static constexpr int kBBytes = BN / 64 * kBoxBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kRedBytes = 2 * 8 * BN * 4;
  static constexpr int kOutBytes = 8 * 16 * 64 * 2;  // a warp's 16 x 64
  static constexpr int kBarBytes = 2 * kStages * 8;
  // + 1024: the dynamic window's start is rounded up to the atom
  static constexpr int kSmemBytes =
      1024 + kStages * kStageBytes + kRedBytes + kOutBytes + kBarBytes;
  static_assert(BN == 64 || BN == 128 || BN == 256, "wgmma widths");
  static_assert(kSmemBytes <= 227 * 1024, "one block's shared memory");
};

// -- PTX: mbarriers, copies, wgmma --------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// an arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// the arrival of this thread once its earlier cp.async copies land, one
// of the barrier's expected arrivals (.noinc)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// 16 bytes global -> shared; a masked copy reads nothing, writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

// one [64 k][64 n] box of B at (column n, row k) into `dst`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int n, int k, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(n),
         "r"(k) : "memory");
}

// cp.async's writes (the generic proxy) before wgmma's reads (the async
// proxy) of the same shared memory
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending)
               : "memory");
}

// the 256 consumer threads (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of v across the wgmma
// instructions that own it
__device__ __forceinline__ void fence_operand(float& v) {
  asm volatile("" : "+f"(v) :: "memory");
}

// A shared-memory matrix descriptor in the 128-byte swizzle: the start
// address, the leading and stride byte offsets (in 16-byte units).
// K-major A: rows 128 bytes apart, 8-row atoms 1024 apart (SBO; LBO
// unused).  MN-major B: k rows 128 bytes apart, 8-row atoms 1024 apart
// (SBO), 64-column boxes kBoxBytes apart (LBO).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

// d += a . b: m64nNk16, bf16 operands from descriptors, f32 sums; A
// K-major, B MN-major (the transposed-B flag)
template <int N>
struct Mma;

template <>
struct Mma<64> {
  __device__ static void run(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Mma<128> {
  __device__ static void run(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Mma<256> {
  __device__ static void run(float (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1));
  }
};

// -- the kernel ----------------------------------------------------------------

// Where tile t of the walk sits: row tile mt, column tile nt, split.
struct Walk {
  int n_tiles, m_tiles, tiles, split_slices, slices;
  __device__ void at(int t, int& mt, int& nt, int& split, int& k0,
                     int& steps) const {
    nt = t % n_tiles;
    mt = t / n_tiles % m_tiles;
    split = t / n_tiles / m_tiles;
    k0 = split * split_slices;          // in slices
    steps = min(split_slices, slices - k0);
  }
};

// One persistent block: output tiles blockIdx.x, + gridDim.x, ... of
// the walk.  Without a split (ws null) a tile takes the epilogue and is
// stored in bf16; with one its raw f32 sum goes to ws[split] and
// split_reduce finishes.
template <int BN, class Loader>
__global__ void __launch_bounds__(kThreads, 1)
wgmma_kernel(const Loader A, const __grid_constant__ CUtensorMap b_map,
             int M, int N, Walk walk, bf16* __restrict__ y,
             float* __restrict__ ws, Epilogue ep) {
  using T = Tile<BN>;
  using Cursor = typename Loader::Cursor;
  constexpr int kStages = T::kStages;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the atoms' alignment
  unsigned char* smem = smem_raw + (base - raw);
  float* red = reinterpret_cast<float*>(smem + kStages * T::kStageBytes);
  unsigned char* stage_out = smem + kStages * T::kStageBytes + T::kRedBytes;
  const uint32_t full =
      base + kStages * T::kStageBytes + T::kRedBytes + T::kOutBytes;
  const uint32_t empty = full + kStages * 8;
  if (ws != nullptr) ep = Epilogue{nullptr, nullptr, 0, nullptr};

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 128 + 1);  // the copies' arrivals + TMA's
      mbar_init(empty + 8 * s, 2);       // one a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // -- the producer: A by cp.async, B by TMA, slice after slice --------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    const int pt = threadIdx.x - 256;
    const int c = pt & 7, r0 = pt >> 3;  // chunk c of rows r0 + 16 i
    // row r0 + 16 i keeps r0's swizzle phase: (r0 + 16 i) % 8 == r0 % 8
    const uint32_t a_off = r0 * 128 + ((c ^ (r0 & 7)) << 4);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < walk.tiles; t += gridDim.x) {
      int mt, nt, split, k0, steps;
      walk.at(t, mt, nt, split, k0, steps);
      typename Loader::Row rows[kBM / 16];
#pragma unroll
      for (int i = 0; i < kBM / 16; ++i)
        rows[i] = A.row(mt * kBM + r0 + 16 * i);
      Cursor cur = A.cursor(k0 * kBK + 8 * c);
      for (int s = 0; s < steps; ++s) {
        const uint32_t st = base + stage * T::kStageBytes;
        const uint32_t fb = full + 8 * stage;
        mbar_wait(empty + 8 * stage, phase ^ 1);
        if (pt == 0) {
          mbar_expect_tx(fb, T::kBBytes);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(st + T::kABytes + j * T::kBoxBytes, &b_map,
                     nt * BN + 64 * j, (k0 + s) * kBK, fb);
        }
#pragma unroll
        for (int i = 0; i < kBM / 16; ++i) {
          bool ok;
          const bf16* p = A.src(rows[i], cur, ok);
          cp_async16(st + a_off + i * 16 * 128, p, ok);
        }
        A.advance(cur, kBK);
        cp_async_arrive(fb);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // -- the consumers: 64 rows each, every slice of every tile ----------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    const bool leader = (threadIdx.x & 127) == 0;
    int stage = 0;
    uint32_t phase = 0;
    float acc[BN / 2];
    for (int t = blockIdx.x; t < walk.tiles; t += gridDim.x) {
      int mt, nt, split, k0, steps;
      walk.at(t, mt, nt, split, k0, steps);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int last = -1;  // the stage of the group still in flight
      for (int s = 0; s < steps; ++s) {
        mbar_wait(full + 8 * stage, phase);
        fence_proxy_async();
        const uint32_t st = base + stage * T::kStageBytes;
        const uint32_t a0 = st + wg * 64 * 128, b0 = st + T::kABytes;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          Mma<BN>::run(acc, desc(a0 + 32 * kk, 16, 1024),
                       desc(b0 + 16 * 128 * kk, T::kBoxBytes, 1024));
        wgmma_commit();
        // the previous slice's group has retired: its stage is free
        wgmma_wait<1>();
        if (leader && last >= 0) mbar_arrive(empty + 8 * last);
        last = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
      if (leader && last >= 0) mbar_arrive(empty + 8 * last);

      // acc[4 j + 2 h + e]: row 16 warp + g + 8 h, column 8 j + 2 t4 + e
      const int m0 = mt * kBM, n0 = nt * BN;
      if (ep.partial != nullptr) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float s = 0.f, ss = 0.f;  // rows past M hold zeros
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v = acc[4 * j + 2 * h + e];
              s += v;
              ss += v * v;
            }
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {  // over g, in order
              s += __shfl_xor_sync(0xffffffffu, s, off);
              ss += __shfl_xor_sync(0xffffffffu, ss, off);
            }
            if (g == 0) {
              const int col = 8 * j + 2 * t4 + e;
              red[warp * BN + col] = s;
              red[(8 + warp) * BN + col] = ss;
            }
          }
        consumers_sync();
        for (int i = threadIdx.x; i < 2 * BN; i += 256) {
          const int mo = i / BN, col = i % BN;
          if (n0 + col < N) {
            float v = 0.f;
#pragma unroll
            for (int w = 0; w < 8; ++w) v += red[(8 * mo + w) * BN + col];
            ep.partial[((long long)mo * walk.m_tiles + mt) * N + n0 + col] =
                v;
          }
        }
        consumers_sync();  // red is free for the next tile
      }

      if (ws != nullptr) {
        // a split: the raw f32 sums, a quad's 32 bytes of a row a store
        float* wsp = ws + (long long)split * M * N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = n0 + 8 * j + 2 * t4;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + 16 * warp + g + 8 * h;
            if (m < M && n < N)   // N % 8 == 0: both columns or neither
              *reinterpret_cast<float2*>(wsp + (long long)m * N + n) =
                  make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
        continue;
      }
      // y: the warp's 16 rows, 64 columns at a time, rounded into its
      // 2 KB of staging (16-byte chunk c of row r at c ^ (r % 8): no bank
      // conflicts either way), then read back 16 bytes a lane and stored
      // as whole 128-byte rows
      unsigned char* stg = stage_out + warp * 2048;
#pragma unroll
      for (int cb = 0; cb < BN / 64; ++cb) {
        // the block's scale and shift, read before the staging stores
        // (read-only loads the stores cannot be taken to alias, so they
        // are all in flight at once)
        float sc[8][2], sh[8][2];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + 64 * cb + 8 * jj + 2 * t4 + e;
            const bool ok = ep.scale != nullptr && n < N;
            sc[jj][e] = ok ? __ldg(ep.scale + n) : 1.f;
            sh[jj][e] = ok ? __ldg(ep.shift + n) : 0.f;
          }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * cb + jj;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = g + 8 * h;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              v[e] = acc[4 * j + 2 * h + e];
              if (ep.scale != nullptr)
                v[e] = fmaf(v[e], sc[jj][e], sh[jj][e]);
              if (ep.relu) v[e] = fmaxf(v[e], 0.f);
            }
            *reinterpret_cast<__nv_bfloat162*>(
                stg + r * 128 + ((jj ^ (r & 7)) << 4) + 4 * t4) =
                __floats2bfloat162_rn(v[0], v[1]);
          }
        }
        __syncwarp();
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = 4 * q + (lane >> 3), c = lane & 7;
          const int m = m0 + 16 * warp + r, n = n0 + 64 * cb + 8 * c;
          const uint4 v = *reinterpret_cast<const uint4*>(
              stg + r * 128 + ((c ^ (r & 7)) << 4));
          if (m < M && n < N)   // N % 8 == 0: the chunk is in or out
            *reinterpret_cast<uint4*>(y + (long long)m * N + n) = v;
        }
        __syncwarp();   // the staging is free for the next 64 columns
      }
    }
  }
}

// -- host ------------------------------------------------------------------------

// libcuda's cuTensorMapEncodeTiled, looked up through the CUDA runtime
// (cudaGetDriverEntryPoint*, so nothing links -lcuda); null where the
// installed libcuda has none.
inline PFN_cuTensorMapEncodeTiled encoder() {
  static PFN_cuTensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// B [Kred, N] bf16, row-major, as [64 k][64 n] boxes in the 128-byte
// swizzle; out-of-range elements read as zeros.
inline cudaError_t encode_b(CUtensorMap* map, const bf16* b, int Kred,
                            int N) {
  const PFN_cuTensorMapEncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)Kred};
  const cuuint64_t strides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t box[2] = {64, kBK}, unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(b), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// f(BN) as an integral constant at the instantiation block_n names (the
// plan's WGMMA.tiles), or cudaErrorInvalidValue.
template <class F>
cudaError_t dispatch(int block_n, F&& f) {
  if (block_n == 256) return f(std::integral_constant<int, 256>{});
  if (block_n == 128) return f(std::integral_constant<int, 128>{});
  if (block_n == 64) return f(std::integral_constant<int, 64>{});
  return cudaErrorInvalidValue;
}

// The opt-in of BN's instantiation to kSmemBytes of dynamic shared
// memory, set once (before any launch or occupancy query), and the blocks
// one SM holds of it (the CUDA runtime's occupancy); or a CUDA error.
template <int BN, class Loader>
cudaError_t prepare(int* resident) {
  static int blocks = 0;
  static const cudaError_t err = [] {
    const auto fn = &wgmma_kernel<BN, Loader>;
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile<BN>::kSmemBytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fn, kThreads, Tile<BN>::kSmemBytes);
    return e;
  }();
  *resident = blocks;
  return err;
}

// Blocks of the 128 x block_n tile one SM holds, or -(CUDA error).
template <class Loader>
int resident(int block_n) {
  int n = 0;
  const cudaError_t err = dispatch(block_n, [&](auto bn) {
    return prepare<decltype(bn)::value, Loader>(&n);
  });
  return err == cudaSuccess ? n : -(int)err;
}

// One GEMM on the 128 x block_n tile, split `splits` ways (ws [splits, M,
// N] f32 scratch when > 1), then the split's second pass, then, when
// partial is set, the stats reduction over the ceil(M / 128) row tiles;
// returns the first CUDA error, or 0.  b, y bf16 with N % 8 == 0 and b,
// y (and ws) 16-byte aligned; the Loader's own conditions (a run of 8 in
// A, A aligned) are its caller's to check.
template <class Loader>
int launch(const Loader& A, const bf16* b, int M, int N, int Kred, bf16* y,
           int block_n, int splits, float* ws, const float* scale,
           const float* shift, int relu, float* partial, float* sum,
           float* sumsq, cudaStream_t stream) {
  const Epilogue ep{scale, shift, relu, partial};
  const int slices = (Kred + kBK - 1) / kBK;
  if (splits < 1 || splits > slices || N % 8 != 0 || !aligned16(b) ||
      !aligned16(y) || (splits > 1 && (ws == nullptr || !aligned16(ws))))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  cudaError_t err = encode_b(&map, b, Kred, N);
  if (err != cudaSuccess) return (int)err;
  // the card's SMs, asked once a device
  static int sms_of[64] = {};
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if (device >= 64) return (int)cudaErrorInvalidDevice;
  if (sms_of[device] == 0 &&
      (err = cudaDeviceGetAttribute(&sms_of[device],
                                    cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  const int sms = sms_of[device];
  err = dispatch(block_n, [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    int per_sm = 0;
    const cudaError_t e = prepare<BN, Loader>(&per_sm);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const int split_slices = (slices + splits - 1) / splits;
    const long long tiles = (long long)((M + kBM - 1) / kBM) *
                            ((N + BN - 1) / BN) * splits;
    if (tiles > INT_MAX) return cudaErrorInvalidValue;
    const Walk walk{(N + BN - 1) / BN, (M + kBM - 1) / kBM, (int)tiles,
                    split_slices, slices};
    const int grid = (int)std::min<long long>(tiles, (long long)sms * per_sm);
    wgmma_kernel<BN, Loader><<<grid, kThreads, Tile<BN>::kSmemBytes,
                               stream>>>(
        A, map, M, N, walk, y, splits > 1 ? ws : nullptr, ep);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  const int tiles = (M + kBM - 1) / kBM;
  if (splits > 1) {
    split_reduce<<<dim3((N + 127) / 128, tiles), 128, 0, stream>>>(
        ws, splits, M, N, kBM, y, ep);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (partial == nullptr) return 0;
  stats_reduce<<<dim3((N + 31) / 32, 2), 1024, 0, stream>>>(
      partial, tiles, N, sum, sumsq);
  return (int)cudaGetLastError();
}

}  // namespace wgmma
}  // namespace gemm

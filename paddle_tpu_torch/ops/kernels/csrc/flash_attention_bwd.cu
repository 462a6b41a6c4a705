// Flash attention backward: dq, dk, dv of softmax(q k^T * scale) v from
// q, k, v, dO, the forward's row log-sum-exp (lse) and delta = rowsum(dO * O),
// recomputing the probabilities tile by tile so that no [Tq, Tk] matrix ever
// reaches device memory.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_flash_bwd: the fused
// single-tile _dqkv_single_kernel and the tiled pair _dq_kernel (grid
// (B*H, q tiles, k tiles), k axis in order, dq carried in VMEM scratch) and
// _dkv_kernel (grid (B*H, k tiles, q tiles), q axis in order).  On the card
// the function is two kernels, each writing its outputs from one block with
// no atomics, so a rerun is bit for bit the same:
//   dK/dV: one block per (bh, 64-key tile); K and V stay in shared memory,
//          dK and dV accumulate in registers, the block walks the 64-query
//          tiles from the diagonal down (causal) and for each recomputes
//          S = Q K^T * scale, P = exp(S - lse), dV += P^T dO, dP = dO V^T,
//          dS = P * (dP - delta) * scale, dK += dS^T Q.
//   dQ:    one block per (bh, 64-query tile); Q and dO stay in shared memory,
//          the block walks the key tiles up to the diagonal and accumulates
//          dQ += dS K in registers.
//
// What bounds it on an H100: operations.  At the LM training shape
// (B=16, T=1024, H=12, D=64, causal) the function's five products (S, dP,
// dV, dQ, dK) over the causal pairs are 64.5 GFLOP against ~0.40 GB of
// q/k/v/o/dO/dq/dk/dv, ~160 flop per byte, far above the ~20 flop/byte f32
// balance point.  f32 at full precision rules out the tensor cores (they
// would take TF32), so the ceiling is f32 FMA on the CUDA cores; the two
// kernels recompute S and dP each (7 products in all where the function
// needs 5), the price of writing every output from one block.  As in the
// forward, every operand of the inner products is in shared memory or
// registers: each thread owns a 4x4 block of S/dP and a 4 x D/16 block of
// each accumulator, causal tiles above the diagonal are never loaded, and
// shared rows are padded by one float so the threads of a warp read distinct
// banks.  The dK/dV kernel holds K, V, a Q and a dO tile and P and dS
// (~100 KB at D=64), over the 48 KB default, so it opts in to more dynamic
// shared memory.
//
// Layout: q/o/dO/dq [BH, Tqp, D], k/v/dk/dv [BH, Tkp, D] with Tqp, Tkp
// multiples of 64 (the wrapper transposes and zero-pads); lse, delta
// [BH, Tqp].  Keys at or past t_k, and keys after the query (causal, by
// absolute position), get P = 0, as the TPU kernels' -1e30 mask gives.
// Padded query rows have dO = 0 and delta = 0, so they add nothing.
//
// Two forms, one pair of entry points each: flash_attention_bwd_{dq,dkv}_f32
// (this design) and flash_attention_bwd_{dq,dkv}_bf16 (the tensor-core
// form, below).

#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kB = 64;        // rows of a query tile and of a key tile
constexpr int kThreads = 256; // 16 x 16: thread (ty, tx) owns rows ty*4+r
constexpr int kPS = kB + 1;   // padded row of a P / dS tile

__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int d, int tid) {
  for (int i = tid; i < kB * d; i += kThreads) dst[(i / d) * (d + 1) + i % d] = src[i];
}

template <int D>
constexpr size_t dkv_smem_floats() {
  return 4 * (size_t)kB * (D + 1) + 2 * (size_t)kB * kPS + 2 * kB;
}

template <int D>
constexpr size_t dq_smem_floats() {
  return 4 * (size_t)kB * (D + 1) + (size_t)kB * kPS;
}

// One block per (bh, key tile j).  Thread (ty, tx) owns key rows
// kr = ty*4 + r and, of each query tile, the columns qc = tx + 16c.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int tqp, int tkp, int t_k,
                     int causal, float scale) {
  constexpr int S = D + 1;
  constexpr int DC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sk = smem;             // [kB][S]
  float* sv = sk + kB * S;      // [kB][S]
  float* sq = sv + kB * S;      // [kB][S]
  float* sdo = sq + kB * S;     // [kB][S]
  float* sp = sdo + kB * S;     // [kB keys][kPS]: P^T of the tile
  float* sds = sp + kB * kPS;   // [kB keys][kPS]: dS^T of the tile
  float* slse = sds + kB * kPS; // [kB]
  float* sdl = slse + kB;       // [kB]

  const int bh = blockIdx.x, j = blockIdx.y;  // j = 0 (most work) first
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t kbase = ((size_t)bh * tkp + (size_t)j * kB) * D;
  load_tile(sk, k + kbase, D, tid);
  load_tile(sv, v + kbase, D, tid);

  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  const int nq = tqp / kB;
  for (int i = causal ? j : 0; i < nq; ++i) {
    __syncthreads();  // the previous tile's sq/sdo/sp/sds are no longer read
    const size_t qbase = ((size_t)bh * tqp + (size_t)i * kB) * D;
    load_tile(sq, q + qbase, D, tid);
    load_tile(sdo, dout + qbase, D, tid);
    if (tid < kB) {
      slse[tid] = lse[(size_t)bh * tqp + (size_t)i * kB + tid];
      sdl[tid] = delta[(size_t)bh * tqp + (size_t)i * kB + tid];
    }
    __syncthreads();

    // S^T (keys x queries) and dP^T in one pass over d
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        kv[r] = sk[(ty * 4 + r) * S + d];
        vv[r] = sv[(ty * 4 + r) * S + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        qv[c] = sq[(tx + 16 * c) * S + d];
        dov[c] = sdo[(tx + 16 * c) * S + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(kv[r], qv[c], s[r][c]);
          dp[r][c] = fmaf(vv[r], dov[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kpos = j * kB + ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qc = tx + 16 * c, qpos = i * kB + qc;
        const bool valid = kpos < t_k && (!causal || qpos >= kpos);
        const float p = valid ? expf(s[r][c] * scale - slse[qc]) : 0.f;
        sp[(ty * 4 + r) * kPS + qc] = p;
        sds[(ty * 4 + r) * kPS + qc] = p * (dp[r][c] - sdl[qc]) * scale;
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q over the tile's 64 queries
#pragma unroll 4
    for (int qq = 0; qq < kB; ++qq) {
      float pv[4], dsv[4], dov[DC], qv[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pv[r] = sp[(ty * 4 + r) * kPS + qq];
        dsv[r] = sds[(ty * 4 + r) * kPS + qq];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dov[c] = sdo[qq * S + tx + 16 * c];
        qv[c] = sq[qq * S + tx + 16 * c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc_v[r][c] = fmaf(pv[r], dov[c], acc_v[r][c]);
          acc_k[r][c] = fmaf(dsv[r], qv[c], acc_k[r][c]);
        }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const size_t row = kbase + (size_t)(ty * 4 + r) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[row + tx + 16 * c] = acc_k[r][c];
      dv[row + tx + 16 * c] = acc_v[r][c];
    }
  }
}

// One block per (bh, query tile i).  Thread (ty, tx) owns query rows
// qr = ty*4 + r and, of each key tile, the columns kc = tx + 16c.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int tqp, int tkp, int t_k, int causal, float scale) {
  constexpr int S = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sq = smem;            // [kB][S]
  float* sdo = sq + kB * S;    // [kB][S]
  float* sk = sdo + kB * S;    // [kB][S]
  float* sv = sk + kB * S;     // [kB][S]
  float* sds = sv + kB * S;    // [kB queries][kPS]

  const int bh = blockIdx.x;
  const int i = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t qbase = ((size_t)bh * tqp + (size_t)i * kB) * D;
  load_tile(sq, q + qbase, D, tid);
  load_tile(sdo, dout + qbase, D, tid);
  float row_lse[4], row_dl[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const size_t row = (size_t)bh * tqp + (size_t)i * kB + ty * 4 + r;
    row_lse[r] = lse[row];
    row_dl[r] = delta[row];
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  int n_tiles = tkp / kB;
  if (causal) n_tiles = min(n_tiles, i + 1);
  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();  // the previous tile's sk/sv/sds are no longer read
    const size_t kbase = ((size_t)bh * tkp + (size_t)j * kB) * D;
    load_tile(sk, k + kbase, D, tid);
    load_tile(sv, v + kbase, D, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qv[r] = sq[(ty * 4 + r) * S + d];
        dov[r] = sdo[(ty * 4 + r) * S + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kv[c] = sk[(tx + 16 * c) * S + d];
        vv[c] = sv[(tx + 16 * c) * S + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
          dp[r][c] = fmaf(dov[r], vv[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = i * kB + ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = j * kB + tx + 16 * c;
        const bool valid = kpos < t_k && (!causal || qpos >= kpos);
        const float p = valid ? expf(s[r][c] * scale - row_lse[r]) : 0.f;
        sds[(ty * 4 + r) * kPS + tx + 16 * c] =
            p * (dp[r][c] - row_dl[r]) * scale;
      }
    }
    __syncthreads();

    // dQ += dS K over the tile's 64 keys
#pragma unroll 4
    for (int kk = 0; kk < kB; ++kk) {
      float dsv[4], kv[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) dsv[r] = sds[(ty * 4 + r) * kPS + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = sk[kk * S + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(dsv[r], kv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const size_t row = qbase + (size_t)(ty * 4 + r) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[row + tx + 16 * c] = acc[r][c];
  }
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v, const float* dout,
              const float* lse, const float* delta, float* dq, int bh, int tqp,
              int tkp, int t_k, int causal, float scale, cudaStream_t stream) {
  const int smem = (int)(dq_smem_floats<D>() * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, tqp / kB);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, tqp, tkp, t_k, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               float* dk, float* dv, int bh, int tqp, int tkp, int t_k,
               int causal, float scale, cudaStream_t stream) {
  const int smem = (int)(dkv_smem_floats<D>() * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, tkp / kB);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, tqp, tkp, t_k, causal, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 form: bf16 q, k, v, dO on the tensor cores; lse and delta f32;
// S, P, dP and dS in f32 registers; P rounded to bf16 before P^T dO and
// dS before dS K and dS^T Q; dq, dk, dv written in bf16 from f32
// accumulators, as the TPU kernels do with bf16 operands
// (flash_attention.py: _dq_kernel :110-117, _dkv_kernel :148-157, the
// outputs in the operands' dtype :126, :166-167).
//
// What bounds it on an H100: operations.  At the LM training shape the
// five products over the causal pairs are 64.5 GFLOP (~65 us at 989
// TFLOP/s) against ~0.20 GB (~60 us at 3.35 TB/s); the two kernels
// recompute S and dP each (7 products in all), the price of writing
// every output from one block with no atomics.  This first design is
// simple and right, not fast: 4 warps a block, each 16 rows, the
// block's own 64-row operand tiles in shared memory, the walked tiles
// through a 2-stage ring of 64-row tiles by 16-byte cp.async (tile i + 1
// in flight while tile i is computed), causal tiles above the diagonal
// never loaded, mma.sync.m16n8k16 for every product:
//   dQ    one block per (bh, 64-query tile), walking the key tiles up to
//         the diagonal: S = Q K^T and dP = dO V^T with K and V [key][d] as
//         B's [n][k] (plain ldmatrix); P = exp(S * scale - lse) and
//         dS = P * (dP - delta) * scale in f32; dS rounded to bf16 and
//         packed from the accumulator tiles into A fragments (the forward's
//         C -> A reuse); dQ += dS K with K [key][d] = B's [k][n]
//         (ldmatrix.trans).
//   dK/dV one block per (bh, 64-key tile), walking the query tiles from the
//         diagonal down.  It computes the transposed tiles directly,
//         S^T = K Q^T and dP^T = V dO^T (Q and dO [query][d] as B's
//         [n][k]), so P^T and dS^T come out of the accumulators already
//         as the A fragments of dV += P^T dO and dK += dS^T Q (dO and Q
//         [query][d] = B's [k][n], ldmatrix.trans); lse and delta are
//         then indexed by the fragment's column, from a 64-float slice
//         staged in shared memory with the tile.  Nothing is staged
//         through shared memory but the operands, which keeps the block's
//         shared memory at 6 tiles and needs no extra barrier.

namespace tc = bf16_tc;
using bf16 = tc::bf16;

constexpr int kTcThreads = 128;  // 4 warps; warp w owns rows 16w..16w+15

template <int D>
constexpr size_t bwd_bf16_smem_bytes() {
  // the block's 2 tiles + 2 stages x 2 walked tiles; dK/dV also stages
  // 2 x 64 floats of lse and delta a stage
  return 6 * (size_t)tc::tile64_elems<D>() * sizeof(bf16) +
         4 * 64 * sizeof(float);
}

// One block per (bh, query tile i): dq = dS K over the key tiles j <= i
// (causal) or all of them.
template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int tqp, int tkp, int t_k,
                         int causal, float scale) {
  constexpr int LD = tc::tile_ld<D>(), TILE = tc::tile64_elems<D>();
  constexpr int kNT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + TILE;
  bf16* ring = sdo + TILE;     // [2 stages][K, V]

  const int bh = blockIdx.x;
  const int i = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = i * 64 + 16 * warp + g;   // rows row0 and row0 + 8

  int n_tiles = tkp / 64;
  if (causal) n_tiles = min(n_tiles, i + 1);
  const bf16* kg = k + (size_t)bh * tkp * D;
  const bf16* vg = v + (size_t)bh * tkp * D;
  auto stage_k = [&](int j) { return ring + (j & 1) * 2 * TILE; };
  auto stage_v = [&](int j) { return ring + (j & 1) * 2 * TILE + TILE; };
  auto copy = [&](bf16* dst, const bf16* src) {
    tc::copy_tile64<D, kTcThreads>(dst, src, tid);
  };

  const size_t qbase = ((size_t)bh * tqp + (size_t)i * 64) * D;
  copy(sq, q + qbase);
  copy(sdo, dout + qbase);
  copy(stage_k(0), kg);
  copy(stage_v(0), vg);
  tc::cp_async_commit();

  float row_lse[2], row_dl[2], acc[kNT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_lse[h] = lse[(size_t)bh * tqp + row0 + 8 * h];
    row_dl[h] = delta[(size_t)bh * tqp + row0 + 8 * h];
  }
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();  // every warp is past tile j - 1, whose slot j + 1 takes
    if (j + 1 < n_tiles) {
      copy(stage_k(j + 1), kg + (size_t)(j + 1) * 64 * D);
      copy(stage_v(j + 1), vg + (size_t)(j + 1) * 64 * D);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* sk = stage_k(j);
    const bf16* sv = stage_v(j);

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys a warp each
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const int a_off = (16 * warp + (lane & 15)) * LD + 16 * kc +
                        8 * (lane >> 4);
      uint32_t aq[4], ado[4];
      tc::ldmatrix_x4(aq, sq + a_off);
      tc::ldmatrix_x4(ado, sdo + a_off);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int b_off = (16 * np + (lane & 7) + 8 * (lane >> 4)) * LD +
                          16 * kc + 8 * ((lane >> 3) & 1);
        uint32_t b[4];
        tc::ldmatrix_x4(b, sk + b_off);
        tc::mma_bf16(s[2 * np], aq, b[0], b[1]);
        tc::mma_bf16(s[2 * np + 1], aq, b[2], b[3]);
        tc::ldmatrix_x4(b, sv + b_off);
        tc::mma_bf16(dp[2 * np], ado, b[0], b[1]);
        tc::mma_bf16(dp[2 * np + 1], ado, b[2], b[3]);
      }
    }

    // dS = P * (dP - delta) * scale, rounded to bf16 in A fragments
    uint32_t dsa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = row0 + 8 * (e >> 1);
        const int kpos = j * 64 + 8 * n + 2 * t + (e & 1);
        const bool valid = kpos < t_k && (!causal || qpos >= kpos);
        const float p = valid ? expf(__fmul_rn(s[n][e], scale) -
                                     row_lse[e >> 1]) : 0.f;
        s[n][e] = p * (dp[n][e] - row_dl[e >> 1]) * scale;
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      dsa[kk][0] = tc::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      dsa[kk][1] = tc::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      dsa[kk][2] = tc::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      dsa[kk][3] = tc::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }

    // dQ += dS K: K [key][d] is B's [k][n]
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        tc::ldmatrix_x4_trans(b, sk + (16 * kk + (lane & 15)) * LD + 16 * dn +
                                     8 * (lane >> 4));
        tc::mma_bf16(acc[2 * dn], dsa[kk], b[0], b[1]);
        tc::mma_bf16(acc[2 * dn + 1], dsa[kk], b[2], b[3]);
      }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t row = (size_t)bh * tqp + row0 + 8 * h;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dq + row * D + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

// One block per (bh, key tile j): dk = dS^T Q and dv = P^T dO over the
// query tiles i >= j (causal) or all of them.
template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int tqp, int tkp, int t_k, int causal,
                          float scale) {
  constexpr int LD = tc::tile_ld<D>(), TILE = tc::tile64_elems<D>();
  constexpr int kNT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + TILE;
  bf16* ring = sv + TILE;      // [2 stages][Q, dO]
  // [2 stages][lse, delta][64]
  float* srow = reinterpret_cast<float*>(ring + 4 * TILE);

  const int bh = blockIdx.x, j = blockIdx.y;  // j = 0 (most work) first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = j * 64 + 16 * warp + g;    // keys key0 and key0 + 8

  const int i0 = causal ? j : 0, nq = tqp / 64;
  const bf16* qg = q + (size_t)bh * tqp * D;
  const bf16* dog = dout + (size_t)bh * tqp * D;
  auto stage_q = [&](int s) { return ring + (s & 1) * 2 * TILE; };
  auto stage_do = [&](int s) { return ring + (s & 1) * 2 * TILE + TILE; };
  auto copy = [&](bf16* dst, const bf16* src) {
    tc::copy_tile64<D, kTcThreads>(dst, src, tid);
  };
  // query tile i into stage s: Q and dO by cp.async, lse and delta by
  // plain loads (visible after the barrier that precedes their use)
  auto fetch = [&](int i, int s) {
    copy(stage_q(s), qg + (size_t)i * 64 * D);
    copy(stage_do(s), dog + (size_t)i * 64 * D);
    if (tid < 64) {
      srow[(s & 1) * 128 + tid] = lse[(size_t)bh * tqp + i * 64 + tid];
      srow[(s & 1) * 128 + 64 + tid] = delta[(size_t)bh * tqp + i * 64 + tid];
    }
  };

  const size_t kbase = ((size_t)bh * tkp + (size_t)j * 64) * D;
  copy(sk, k + kbase);
  copy(sv, v + kbase);
  if (i0 < nq) fetch(i0, 0);
  tc::cp_async_commit();

  float acc_k[kNT][4], acc_v[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int i = i0; i < nq; ++i) {
    const int s_cur = i - i0;
    __syncthreads();  // every warp is past the tile whose slot i + 1 takes
    if (i + 1 < nq) fetch(i + 1, s_cur + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* sq = stage_q(s_cur);
    const bf16* sdo = stage_do(s_cur);
    const float* slse = srow + (s_cur & 1) * 128;
    const float* sdl = slse + 64;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries a warp each
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const int a_off = (16 * warp + (lane & 15)) * LD + 16 * kc +
                        8 * (lane >> 4);
      uint32_t ak[4], av[4];
      tc::ldmatrix_x4(ak, sk + a_off);
      tc::ldmatrix_x4(av, sv + a_off);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int b_off = (16 * np + (lane & 7) + 8 * (lane >> 4)) * LD +
                          16 * kc + 8 * ((lane >> 3) & 1);
        uint32_t b[4];
        tc::ldmatrix_x4(b, sq + b_off);
        tc::mma_bf16(s[2 * np], ak, b[0], b[1]);
        tc::mma_bf16(s[2 * np + 1], ak, b[2], b[3]);
        tc::ldmatrix_x4(b, sdo + b_off);
        tc::mma_bf16(dp[2 * np], av, b[0], b[1]);
        tc::mma_bf16(dp[2 * np + 1], av, b[2], b[3]);
      }
    }

    // P^T and dS^T, element (key, query column); each rounded to bf16 in
    // the A fragments of the two products over the tile's 64 queries
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * n + 2 * t + (e & 1);
        const int qpos = i * 64 + qc, kpos = key0 + 8 * (e >> 1);
        const bool valid = kpos < t_k && (!causal || qpos >= kpos);
        const float p = valid ? expf(__fmul_rn(s[n][e], scale) - slse[qc])
                              : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - sdl[qc]) * scale;
      }
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = tc::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = tc::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = tc::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = tc::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      dsa[kk][0] = tc::pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]);
      dsa[kk][1] = tc::pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]);
      dsa[kk][2] = tc::pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      dsa[kk][3] = tc::pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
    }

    // dV += P^T dO and dK += dS^T Q: dO and Q [query][d] are B's [k][n]
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        const int b_off = (16 * kk + (lane & 15)) * LD + 16 * dn +
                          8 * (lane >> 4);
        uint32_t b[4];
        tc::ldmatrix_x4_trans(b, sdo + b_off);
        tc::mma_bf16(acc_v[2 * dn], pa[kk], b[0], b[1]);
        tc::mma_bf16(acc_v[2 * dn + 1], pa[kk], b[2], b[3]);
        tc::ldmatrix_x4_trans(b, sq + b_off);
        tc::mma_bf16(acc_k[2 * dn], dsa[kk], b[0], b[1]);
        tc::mma_bf16(acc_k[2 * dn + 1], dsa[kk], b[2], b[3]);
      }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t row = (size_t)bh * tkp + key0 + 8 * h;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const size_t o = row * D + 8 * n + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dk + o) =
          __floats2bfloat162_rn(acc_k[n][2 * h], acc_k[n][2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + o) =
          __floats2bfloat162_rn(acc_v[n][2 * h], acc_v[n][2 * h + 1]);
    }
  }
}

template <int D>
int launch_dq_bf16(const bf16* q, const bf16* k, const bf16* v,
                   const bf16* dout, const float* lse, const float* delta,
                   bf16* dq, int bh, int tqp, int tkp, int t_k, int causal,
                   float scale, cudaStream_t stream) {
  const int smem = (int)bwd_bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, tqp / 64);
  flash_bwd_dq_bf16_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, tqp, tkp, t_k, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_bf16(const bf16* q, const bf16* k, const bf16* v,
                    const bf16* dout, const float* lse, const float* delta,
                    bf16* dk, bf16* dv, int bh, int tqp, int tkp, int t_k,
                    int causal, float scale, cudaStream_t stream) {
  const int smem = (int)bwd_bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, tkp / 64);
  flash_bwd_dkv_bf16_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, tqp, tkp, t_k, causal, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int bh, int tqp, int tkp) {
  return bh <= 0 || tqp <= 0 || tkp <= 0 || tqp % kB || tkp % kB ||
         tqp / kB > 65535 || tkp / kB > 65535;
}

}  // namespace

extern "C" int flash_attention_bwd_dq_f32(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, float* dq, int bh, int tqp, int tkp,
    int t_k, int d, int causal, float scale, void* stream) {
  if (bad_shape(bh, tqp, tkp)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 16: return launch_dq<16>(q, k, v, dout, lse, delta, dq, bh, tqp, tkp, t_k, causal, scale, s);
    case 32: return launch_dq<32>(q, k, v, dout, lse, delta, dq, bh, tqp, tkp, t_k, causal, scale, s);
    case 64: return launch_dq<64>(q, k, v, dout, lse, delta, dq, bh, tqp, tkp, t_k, causal, scale, s);
    case 128: return launch_dq<128>(q, k, v, dout, lse, delta, dq, bh, tqp, tkp, t_k, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_bwd_dkv_f32(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, float* dk, float* dv, int bh,
    int tqp, int tkp, int t_k, int d, int causal, float scale, void* stream) {
  if (bad_shape(bh, tqp, tkp)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 16: return launch_dkv<16>(q, k, v, dout, lse, delta, dk, dv, bh, tqp, tkp, t_k, causal, scale, s);
    case 32: return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, bh, tqp, tkp, t_k, causal, scale, s);
    case 64: return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, tqp, tkp, t_k, causal, scale, s);
    case 128: return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, tqp, tkp, t_k, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q, k, v, dout, dq / dk, dv: bf16, 16-byte aligned; lse, delta: f32
extern "C" int flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int bh, int tqp, int tkp,
    int t_k, int d, int causal, float scale, void* stream) {
  if (bad_shape(bh, tqp, tkp)) return (int)cudaErrorInvalidValue;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* db = static_cast<const bf16*>(dout);
  bf16* out = static_cast<bf16*>(dq);
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 16: return launch_dq_bf16<16>(qb, kb, vb, db, lse, delta, out, bh, tqp, tkp, t_k, causal, scale, s);
    case 32: return launch_dq_bf16<32>(qb, kb, vb, db, lse, delta, out, bh, tqp, tkp, t_k, causal, scale, s);
    case 64: return launch_dq_bf16<64>(qb, kb, vb, db, lse, delta, out, bh, tqp, tkp, t_k, causal, scale, s);
    case 128: return launch_dq_bf16<128>(qb, kb, vb, db, lse, delta, out, bh, tqp, tkp, t_k, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int bh,
    int tqp, int tkp, int t_k, int d, int causal, float scale, void* stream) {
  if (bad_shape(bh, tqp, tkp)) return (int)cudaErrorInvalidValue;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* db = static_cast<const bf16*>(dout);
  bf16 *ok = static_cast<bf16*>(dk), *ov = static_cast<bf16*>(dv);
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 16: return launch_dkv_bf16<16>(qb, kb, vb, db, lse, delta, ok, ov, bh, tqp, tkp, t_k, causal, scale, s);
    case 32: return launch_dkv_bf16<32>(qb, kb, vb, db, lse, delta, ok, ov, bh, tqp, tkp, t_k, causal, scale, s);
    case 64: return launch_dkv_bf16<64>(qb, kb, vb, db, lse, delta, ok, ov, bh, tqp, tkp, t_k, causal, scale, s);
    case 128: return launch_dkv_bf16<128>(qb, kb, vb, db, lse, delta, ok, ov, bh, tqp, tkp, t_k, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

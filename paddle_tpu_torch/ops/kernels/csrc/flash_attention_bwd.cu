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
//   dK/dV: one block per (bh, key tile); K and V stay in shared memory, dK
//          and dV accumulate in registers, the block walks the query tiles
//          from the diagonal down (causal) and for each recomputes
//          S^T = K Q^T, P^T = exp(S^T * scale - lse), dV += P^T dO,
//          dP^T = V dO^T, dS^T = P^T * (dP^T - delta) * scale, dK += dS^T Q.
//   dQ:    one block per (bh, query tile); Q and dO stay in shared memory,
//          the block walks the key tiles up to the diagonal and accumulates
//          dQ += dS K in registers.
// The two kernels recompute S and dP each (7 products where the function
// needs 5), the price of writing every output from one block.  Keys at or
// past t_k, and keys after the query (causal, by absolute position), get
// P = 0, as the TPU kernels' -1e30 mask gives; padded query rows have
// dO = 0 and delta = 0, so they add nothing.
//
// Three forms, one pair of entry points each:
//   flash_attention_bwd_{dq,dkv}_tf32x3 f32, the products on the tensor
//                                       cores as 3xTF32 (below);
//   flash_attention_bwd_{dq,dkv}_bf16   bf16 on mma.sync, on the padded
//                                       problem (head_dim 16 and 32 on the
//                                       main path);
//   flash_attention_bwd_{dq,dkv}_wgmma  bf16 on wgmma fed by TMA from
//                                       [B, T, H, D] (head_dim 64 and 128).
// The f32 and mma.sync forms take q/o/dO/dq [BH, Tqp, D], k/v/dk/dv
// [BH, Tkp, D] with Tqp, Tkp multiples of 64 (the wrapper transposes and
// zero-pads) and lse, delta [BH, Tqp].

#include <climits>
#include <cuda_runtime.h>

#include "flash_hopper.cuh"
#include "mma_bf16.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kB = 64;  // rows of a query tile and of a key tile

// ---------------------------------------------------------------------------
// The f32 form: every product on the tensor cores as 3xTF32 (the pieces
// are tf32x3.cuh's, shared with the f32 forward).
//
// What bounds it on an H100: operations.  At the LM training shape
// (B=16, T=1024, H=12, D=64, causal) the function's five products over the
// causal pairs are 64.5 GFLOP against ~0.40 GB of q/k/v/o/dO/dq/dk/dv,
// ~160 flop per byte.  On the CUDA cores (67 TFLOP/s of f32 FMA) that is
// 0.96 ms at best; the first design (PR 3: 4x4 register tiles of FMAs,
// scalar copies) took 3.7 ms, held by shared-memory reads (two FMAs a
// 4-byte read).  Three TF32 passes at 495 TFLOP/s put the floor at
// 0.39 ms.  The design is the bf16 mma.sync form's: 4 warps a block, each
// 16 rows of the block's 64, the block's own two operands resident, the
// walked tiles through a 2-stage ring by 16-byte cp.async, causal tiles
// above the diagonal never loaded, mma.sync.m16n8k8 (tf32) for every
// product, and for dK/dV the transposed tiles S^T and dP^T, so P^T and
// dS^T come out of the accumulators as the rows of the A operand of
// dV += P^T dO and dK += dS^T Q (tf32x3.cuh's fragment order).
// - Operands where they lie: q, k, v and dO are read from [B, T, H, D] by
//   16-byte cp.async with their own (b, t, h) strides (multiples of 4
//   floats, 16-byte aligned bases); rows at or past T are zero-filled by
//   the copy, so padded query rows carry dO = 0 and add nothing.  dq, dk
//   and dv are written into contiguous [B, T, H, D]; lse and delta are
//   the [B*H, Tqp] rows (Tqp = t_q rounded up to 64).
// - The long sums (dV, dK, dQ) take mma3_add; S and dP chain at head_dim
//   <= 64 (kSliceApart); chip_ab.py --tf32-variants weighs summing them
//   apart at 64 too (nearer float64, slower).
// - Each warp splits the walked tiles' B values itself (4x what the block
//   needs).  Versions that split them once a block into (hi, lo) pairs in
//   shared memory ran slower (8 warps a block and 64-row tiles, one block
//   an SM; 4 warps and 32-row tiles, two): reading both parts as 8-byte
//   loads doubles the shared-memory traffic of the products.
// - The softmax on ex2.approx (exp(x) = 2^(x log2 e), x = S scale - lse in
//   one fma).

namespace tf32 {

using namespace tf32x3;

constexpr int kThreads = 128;  // 4 warps; warp w owns rows 16w..16w+15

// the block's 2 tiles + 2 stages x 2 walked tiles + 2 stages x (lse,
// delta) rows
template <int D>
constexpr size_t smem_bytes() {
  return (6 * (size_t)tile_floats<D>() + 4 * kB) * sizeof(float);
}

// One block per (bh, key tile j): dk = dS^T Q and dv = P^T dO over the
// query tiles i >= j (causal) or all of them.  Warp w owns keys
// key0 = 64 j + 16 w + g and key0 + 8; S^T and dP^T are [16 keys][64
// queries] a warp, in 8 n8 tiles.  ops: q, k, v, dO.  Its registers are
// asked for two blocks an SM: left to itself ptxas took 189 and serialised
// the HMMAs of a product with NOPs (1.50 ms alone at the LM shape against
// 1.22; chip_ab.py --tf32-variants).
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_tf32x3_kernel(const Operands ops,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int H, int t_q, int t_k, int tqp, int causal,
                            float scale) {
  constexpr int LD = ld<D>(), TILE = tile_floats<D>(), kNT = D / 8;
  extern __shared__ __align__(16) float smem_f[];
  float* sk = smem_f;
  float* sv = sk + TILE;
  float* ring = sv + TILE;             // [2 stages][Q, dO]
  float* srow = ring + 4 * TILE;       // [2 stages][lse, delta][64]

  const int j = blockIdx.y, bh = blockIdx.x;  // j = 0 (most work) first
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = j * kB + 16 * warp + g;

  const int i0 = causal ? j : 0, nq = tqp / kB;
  const Rows qr = ops.rows(0, b, h), dor = ops.rows(3, b, h);
  auto stage_q = [&](int s) { return ring + (s & 1) * 2 * TILE; };
  auto stage_do = [&](int s) { return ring + (s & 1) * 2 * TILE + TILE; };
  // query tile i into stage s: Q and dO by cp.async, lse and delta by
  // plain loads (visible after the barrier that precedes their use)
  auto fetch = [&](int i, int s) {
    copy_rows<D, kThreads>(stage_q(s), qr, i * kB, t_q, tid);
    copy_rows<D, kThreads>(stage_do(s), dor, i * kB, t_q, tid);
    if (tid < kB) {
      srow[(s & 1) * 128 + tid] = lse[(size_t)bh * tqp + i * kB + tid];
      srow[(s & 1) * 128 + 64 + tid] = delta[(size_t)bh * tqp + i * kB + tid];
    }
  };

  copy_rows<D, kThreads>(sk, ops.rows(1, b, h), j * kB, t_k, tid);
  copy_rows<D, kThreads>(sv, ops.rows(2, b, h), j * kB, t_k, tid);
  if (i0 < nq) fetch(i0, 0);
  bf16_tc::cp_async_commit();

  float acc_k[kNT][4], acc_v[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  const float* ka = sk + (16 * warp + g) * LD + t;  // A rows g, g + 8
  const float* va = sv + (16 * warp + g) * LD + t;

  for (int i = i0; i < nq; ++i) {
    const int s_cur = i - i0;
    __syncthreads();  // every warp is past the tile whose slot i + 1 takes
    if (i + 1 < nq) fetch(i + 1, s_cur + 1);
    bf16_tc::cp_async_commit();
    bf16_tc::cp_async_wait<1>();
    __syncthreads();
    const float* sq = stage_q(s_cur);
    const float* sdo = stage_do(s_cur);
    const float* slse = srow + (s_cur & 1) * 128;
    const float* sdl = slse + 64;

    // S^T = K Q^T and dP^T = V dO^T: Q and dO [query][d] are B's [n][k]
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 8; ++kc) {
      SplitA ak, av;
      ak.set(ka[8 * kc], ka[8 * LD + 8 * kc], ka[8 * kc + 4],
             ka[8 * LD + 8 * kc + 4]);
      av.set(va[8 * kc], va[8 * LD + 8 * kc], va[8 * kc + 4],
             va[8 * LD + 8 * kc + 4]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int bi = (8 * n + g) * LD + 8 * kc + t;
        if constexpr (kSliceApart<D>) {
          mma3_add(s[n], ak, sq[bi], sq[bi + 4]);
          mma3_add(dp[n], av, sdo[bi], sdo[bi + 4]);
        } else {
          mma3(s[n], ak, sq[bi], sq[bi + 4]);
          mma3(dp[n], av, sdo[bi], sdo[bi + 4]);
        }
      }
    }

    // P^T and dS^T, element (key, query column)
    const float kLog2e = 1.4426950408889634f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * n + 2 * t + (e & 1);
        const int qpos = i * kB + qc, kpos = key0 + 8 * (e >> 1);
        const bool valid = kpos < t_k && (!causal || qpos >= kpos);
        const float p = valid ? flash_hop::ex2(
            fmaf(s[n][e], scale, -slse[qc]) * kLog2e) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - sdl[qc]) * scale;
      }

    // dV += P^T dO and dK += dS^T Q over the tile's 64 queries in the
    // fragment order (0, 2, 4, 6, 1, 3, 5, 7): B's rows are the queries
    // 2t and 2t + 1
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      SplitA pa, da;
      pa.set(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
      da.set(dp[kk][0], dp[kk][2], dp[kk][1], dp[kk][3]);
#pragma unroll
      for (int dn = 0; dn < kNT; ++dn) {
        const int bi = (8 * kk + 2 * t) * LD + 8 * dn + g;
        mma3_add(acc_v[dn], pa, sdo[bi], sdo[bi + LD]);
        mma3_add(acc_k[dn], da, sq[bi], sq[bi + LD]);
      }
    }
  }
  bf16_tc::cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = key0 + 8 * hh;
    if (row >= t_k) continue;
    const size_t at = (((size_t)b * t_k + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      *reinterpret_cast<float2*>(dk + at + 8 * n) =
          make_float2(acc_k[n][2 * hh], acc_k[n][2 * hh + 1]);
      *reinterpret_cast<float2*>(dv + at + 8 * n) =
          make_float2(acc_v[n][2 * hh], acc_v[n][2 * hh + 1]);
    }
  }
}

// One block per (bh, query tile i): dq = dS K over the key tiles j <= i
// (causal) or all of them.  Warp w owns rows row0 = 64 i + 16 w + g and
// row0 + 8.  ops: q, k, v, dO.  Its registers are asked for two blocks an
// SM, as the dK/dV kernel's (0.85 -> 0.80 ms alone at the LM shape).
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_tf32x3_kernel(const Operands ops,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, int H, int t_q, int t_k,
                           int tqp, int causal, float scale) {
  constexpr int LD = ld<D>(), TILE = tile_floats<D>(), kNT = D / 8;
  extern __shared__ __align__(16) float smem_f[];
  float* sq = smem_f;
  float* sdo = sq + TILE;
  float* ring = sdo + TILE;  // [2 stages][K, V]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int i = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = i * kB + 16 * warp + g;   // rows row0 and row0 + 8

  int n_tiles = (t_k + kB - 1) / kB;
  if (causal) n_tiles = min(n_tiles, i + 1);
  const Rows kr = ops.rows(1, b, h), vr = ops.rows(2, b, h);
  auto stage_k = [&](int j) { return ring + (j & 1) * 2 * TILE; };
  auto stage_v = [&](int j) { return ring + (j & 1) * 2 * TILE + TILE; };

  copy_rows<D, kThreads>(sq, ops.rows(0, b, h), i * kB, t_q, tid);
  copy_rows<D, kThreads>(sdo, ops.rows(3, b, h), i * kB, t_q, tid);
  copy_rows<D, kThreads>(stage_k(0), kr, 0, t_k, tid);
  copy_rows<D, kThreads>(stage_v(0), vr, 0, t_k, tid);
  bf16_tc::cp_async_commit();

  float row_lse[2], row_dl[2], acc[kNT][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row_lse[hh] = lse[(size_t)bh * tqp + row0 + 8 * hh];
    row_dl[hh] = delta[(size_t)bh * tqp + row0 + 8 * hh];
  }
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float* qa = sq + (16 * warp + g) * LD + t;  // A rows g, g + 8
  const float* da = sdo + (16 * warp + g) * LD + t;

  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();  // every warp is past tile j - 1, whose slot j + 1 takes
    if (j + 1 < n_tiles) {
      copy_rows<D, kThreads>(stage_k(j + 1), kr, (j + 1) * kB, t_k, tid);
      copy_rows<D, kThreads>(stage_v(j + 1), vr, (j + 1) * kB, t_k, tid);
    }
    bf16_tc::cp_async_commit();
    bf16_tc::cp_async_wait<1>();
    __syncthreads();
    const float* sk = stage_k(j);
    const float* sv = stage_v(j);

    // S = Q K^T and dP = dO V^T: K and V [key][d] are B's [n][k]
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 8; ++kc) {
      SplitA aq, ad;
      aq.set(qa[8 * kc], qa[8 * LD + 8 * kc], qa[8 * kc + 4],
             qa[8 * LD + 8 * kc + 4]);
      ad.set(da[8 * kc], da[8 * LD + 8 * kc], da[8 * kc + 4],
             da[8 * LD + 8 * kc + 4]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int bi = (8 * n + g) * LD + 8 * kc + t;
        if constexpr (kSliceApart<D>) {
          mma3_add(s[n], aq, sk[bi], sk[bi + 4]);
          mma3_add(dp[n], ad, sv[bi], sv[bi + 4]);
        } else {
          mma3(s[n], aq, sk[bi], sk[bi + 4]);
          mma3(dp[n], ad, sv[bi], sv[bi + 4]);
        }
      }
    }

    // dS = P * (dP - delta) * scale, element (row, key column)
    const float kLog2e = 1.4426950408889634f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = row0 + 8 * (e >> 1);
        const int kpos = j * kB + 8 * n + 2 * t + (e & 1);
        const bool valid = kpos < t_k && (!causal || qpos >= kpos);
        const float p = valid ? flash_hop::ex2(
            fmaf(s[n][e], scale, -row_lse[e >> 1]) * kLog2e) : 0.f;
        s[n][e] = p * (dp[n][e] - row_dl[e >> 1]) * scale;
      }

    // dQ += dS K over the tile's 64 keys in the order of the dK/dV
    // kernel's products: K [key][d] is B's [k][n], rows 2t and 2t + 1
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      SplitA sa;
      sa.set(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
#pragma unroll
      for (int dn = 0; dn < kNT; ++dn) {
        const int bi = (8 * kk + 2 * t) * LD + 8 * dn + g;
        mma3_add(acc[dn], sa, sk[bi], sk[bi + LD]);
      }
    }
  }
  bf16_tc::cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= t_q) continue;
    float* out = dq + (((size_t)b * t_q + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
  }
}

template <int D>
int launch_dq(const Operands& ops, const float* lse, const float* delta,
              float* dq, int B, int H, int t_q, int t_k, int tqp, int causal,
              float scale, cudaStream_t stream) {
  static bool opted[64] = {};
  const int smem = (int)smem_bytes<D>();
  const cudaError_t err =
      flash_hop::opt_in(flash_bwd_dq_tf32x3_kernel<D>, smem, opted);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, tqp / kB);
  flash_bwd_dq_tf32x3_kernel<D><<<grid, kThreads, smem, stream>>>(
      ops, lse, delta, dq, H, t_q, t_k, tqp, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const Operands& ops, const float* lse, const float* delta,
               float* dk, float* dv, int B, int H, int t_q, int t_k, int tqp,
               int causal, float scale, cudaStream_t stream) {
  static bool opted[64] = {};
  const int smem = (int)smem_bytes<D>();
  const cudaError_t err =
      flash_hop::opt_in(flash_bwd_dkv_tf32x3_kernel<D>, smem, opted);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (t_k + kB - 1) / kB);
  flash_bwd_dkv_tf32x3_kernel<D><<<grid, kThreads, smem, stream>>>(
      ops, lse, delta, dk, dv, H, t_q, t_k, tqp, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace tf32

// ---------------------------------------------------------------------------
// The mma.sync form of the bf16 backward, on the padded problem: the main
// path's at head_dim 16 and 32 (the Hopper form below takes 64 and 128).
// bf16 q, k, v, dO on the tensor cores; lse and delta f32;
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

// ---------------------------------------------------------------------------
// The Hopper form of the bf16 backward (flash_attention_bwd_{dq,dkv}_wgmma),
// for head_dim 64 and 128; the mma.sync form above keeps 16 and 32.  The
// same function and rounding points as the mma.sync form (the twins are
// flash_attention.py's _bwd_dq_plain and _bwd_dkv_plain): S and dP in f32,
// P = exp(S scale - lse) in f32, P rounded to bf16 before P^T dO, dS before
// dS K and dS^T Q, dq, dk and dv rounded once; lse and delta f32.
//
// What bounds it on an H100: operations.  At the LM training shape the
// five products over the causal pairs are 64.5 GFLOP, 65 us at 989
// TFLOP/s, against ~0.2 GB (60 us at 3.35 TB/s); the two kernels do 7
// products (90 GFLOP).  Only wgmma reaches the tensor cores' full bf16
// rate, so the design is Hopper's, after the forward's (hop):
// - Operands by TMA, where they lie: q, k, v and dO stay [B, T, H, D] (any
//   strides that are multiples of 16 bytes), read through 4-d tensor maps
//   as [64 rows][64 d] boxes in the 128-byte swizzle (D 128: two panels);
//   rows past T read as zeros.  lse and delta come [B*H, Tqp] f32 by 1-d
//   bulk copies of 64 rows; dq, dk and dv are written [B, T, H, D], staged
//   through the block's own operand tiles and stored as whole rows.
// - dK/dV: a block is a tile of 128 keys of one (b, h): two consumer
//   warpgroups of 64 keys and one producer warp.  K and V stay resident;
//   the producer streams 64-query tiles of Q and dO with their lse and
//   delta rows through a kStages-deep mbarrier ring from the diagonal
//   down (tiles wholly above it are never loaded; a warpgroup releases a
//   tile wholly above its own keys unread).  Each warpgroup computes
//   S^T = K Q^T and dP^T = V dO^T on wgmma m64n64k16 from shared memory
//   (K and Q both K-major), then P^T = 2^(S^T scale log2e - lse log2e) on
//   ex2.approx, the mask only on tiles that cross the diagonal, t_k or
//   t_q; P^T rounded to bf16 is packed from the accumulators into wgmma's
//   register A (the accumulator's m16n8 layout is the A fragment's) for
//   dV += P^T dO with dO the MN-major B; dS^T = P^T (dP^T - delta) scale
//   rounded to bf16 feeds dK += dS^T Q the same way.
// - dQ: a block is a tile of 128 queries: Q, dO and their lse and delta
//   rows stay resident, K and V stream up to the diagonal; S = Q K^T and
//   dP = dO V^T on wgmma from shared memory, dS rounded to bf16 into
//   register A, dQ += dS K with K the MN-major B.
// - A warpgroup releases a stage only after the wgmma groups that read it
//   have retired (wgmma.wait_group 0).  No atomics: every output element
//   is written by one block, so a rerun gives the same bits.
// A warpgroup runs a tile's S and dP products, its ex2 and dS work and
// its dV and dK (or dQ) products in turn, one block of 9 warps an SM:
// the kernels stay at 27-29% of the bound at the LM shape (PERF.md row
// 3 bf16); the ring's depth does not bound them.
namespace hop_bwd {

using namespace flash_hop;  // wg, kPanelBytes, the TMA loads, ex2, Qk, Pv

constexpr int kThreads = 288;   // warpgroups 0, 1 consume; warp 8 loads
constexpr int kRows = 128;      // keys (dK/dV) or queries (dQ) a block
constexpr int kRowBytes = 256;  // a tile's 64 lse or delta values

template <int D>
struct Layout {
  static constexpr int kPanels = D / 64;
  static constexpr int kTileBytes = kPanels * kPanelBytes;  // 64 rows x D
  static constexpr int kStages = D == 64 ? 4 : 3;
  // the two resident operands, 128 rows each: K, V (dK/dV); Q, dO (dQ)
  static constexpr int kFixedBytes = 4 * kTileBytes;
  // dK/dV: a stage is Q, dO and the tile's lse and delta rows (padded to
  // the swizzle's 1024-byte atom); dQ: the resident rows, then stages of
  // K and V
  static constexpr int kDkvStageBytes = 2 * kTileBytes + 1024;
  static constexpr int kDkvBarOffset = kFixedBytes + kStages * kDkvStageBytes;
  static constexpr int kDqStageBytes = 2 * kTileBytes;
  static constexpr int kDqRowsOffset = kFixedBytes;
  static constexpr int kDqBarOffset = kFixedBytes + 1024 + kStages * kDqStageBytes;
  // + 1024: the dynamic window's start is rounded up to the swizzle atom
  static constexpr int kDkvBytes = 1024 + kDkvBarOffset + (1 + 2 * kStages) * 8;
  static constexpr int kDqBytes = 1024 + kDqBarOffset + (1 + 2 * kStages) * 8;
  static_assert(D == 64 || D == 128, "the Hopper form's head dims");
  static_assert(kDkvBytes <= 227 * 1024 && kDqBytes <= 227 * 1024,
                "shared memory");
};

// The output tile of a warpgroup, acc[4 n + 2 hh + e] (row r0 + 8 hh of
// its 64, column 8 n + 2 t4 + e), rounded once into the warpgroup's own
// operand tile `stg` (16-byte chunk c of row r at c ^ (r % 8)), then
// stored as whole rows, 16 bytes a lane, into [B, T, H, D] rows row_wg..
// below t
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           unsigned char* stg, int r0,
                                           int t4, bf16_tc::bf16* out,
                                           int b, int h, int H, int t,
                                           int row_wg, int wgi) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wgi) : "memory");
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh, c = n & 7;
      *reinterpret_cast<__nv_bfloat162*>(
          stg + (n >> 3) * kPanelBytes + r * 128 + ((c ^ (r & 7)) << 4) +
          4 * t4) =
          __floats2bfloat162_rn(acc[4 * n + 2 * hh], acc[4 * n + 2 * hh + 1]);
    }
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wgi) : "memory");
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x & 127; i < 64 * kChunks; i += 128) {
    const int r = i / kChunks, cc = i % kChunks, c = cc & 7;
    const int row = row_wg + r;
    if (row < t)
      *reinterpret_cast<uint4*>(out + (((size_t)b * t + row) * H + h) * D +
                                8 * cc) =
          *reinterpret_cast<const uint4*>(stg + (cc >> 3) * kPanelBytes +
                                          r * 128 + ((c ^ (r & 7)) << 4));
  }
}

// One block per (bh, 128-key tile): dk = dS^T Q, dv = P^T dO over the
// query tiles from the diagonal down (causal) or all of them.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16_tc::bf16* __restrict__ dk,
                           bf16_tc::bf16* __restrict__ dv, int H, int t_q,
                           int t_k, int tqp, int causal, float scale) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the atoms' alignment
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t kv_full = base + L::kDkvBarOffset;
  const uint32_t qfull = kv_full + 8, qempty = qfull + 8 * L::kStages;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kRows;  // the most work first
  const int nq = tqp / 64;
  const int i0 = causal ? k0 / 64 : 0;  // the first tile that meets a key

  if (threadIdx.x == 0) {
    wg::mbar_init(kv_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      wg::mbar_init(qfull + 8 * s, 1);   // the producer's, with TMA's bytes
      wg::mbar_init(qempty + 8 * s, 2);  // one a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 8) {
    // -- the producer: K and V once, then Q, dO, lse, delta tile by tile --
    if (lane == 0) {
      wg::mbar_expect_tx(kv_full, L::kFixedBytes);
      for (int r = 0; r < 2; ++r)
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load_4d(base + (r * L::kPanels + p) * kPanelBytes, &k_map,
                      64 * p, h, k0 + 64 * r, b, kv_full);
          tma_load_4d(base + 2 * L::kTileBytes +
                          (r * L::kPanels + p) * kPanelBytes,
                      &v_map, 64 * p, h, k0 + 64 * r, b, kv_full);
        }
      int stage = 0;
      uint32_t phase = 0;
      for (int i = i0; i < nq; ++i) {
        const uint32_t st = base + L::kFixedBytes + stage * L::kDkvStageBytes;
        const uint32_t fb = qfull + 8 * stage;
        wg::mbar_wait(qempty + 8 * stage, phase ^ 1);
        wg::mbar_expect_tx(fb, 2 * L::kTileBytes + 2 * kRowBytes);
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load_4d(st + p * kPanelBytes, &q_map, 64 * p, h, 64 * i, b, fb);
          tma_load_4d(st + L::kTileBytes + p * kPanelBytes, &do_map, 64 * p,
                      h, 64 * i, b, fb);
        }
        const size_t row = (size_t)bh * tqp + 64 * i;
        bulk_load(st + 2 * L::kTileBytes, lse + row, kRowBytes, fb);
        bulk_load(st + 2 * L::kTileBytes + kRowBytes, delta + row, kRowBytes,
                  fb);
        if (++stage == L::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // -- the consumers: 64 keys a warpgroup, every query tile ---------------
  const int wgi = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int key_wg = k0 + 64 * wgi;              // the warpgroup's keys
  const int r0 = 16 * (warp & 3) + g;            // its rows r0, r0 + 8
  const bool leader = (threadIdx.x & 127) == 0;
  const uint32_t ks = base + wgi * L::kTileBytes;
  const uint32_t vs = base + (2 + wgi) * L::kTileBytes;
  // acc[4 n + 2 hh + e]: key key_wg + r0 + 8 hh, column 8 n + 2 t4 + e
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  const float kLog2e = 1.4426950408889634f;
  const float scale2 = scale * kLog2e;  // S in base 2: exp(x) = 2^(x log2 e)
  wg::mbar_wait(kv_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = i0; i < nq; ++i) {
    wg::mbar_wait(qfull + 8 * stage, phase);
    const uint32_t qs = base + L::kFixedBytes + stage * L::kDkvStageBytes;
    const uint32_t dos = qs + L::kTileBytes;
    const float* rows = reinterpret_cast<const float*>(
        smem + L::kFixedBytes + stage * L::kDkvStageBytes + 2 * L::kTileBytes);
    // a causal tile wholly above the warpgroup's first key adds nothing
    if ((!causal || 64 * i + 63 >= key_wg) && key_wg < t_k) {
      // S^T = K Q^T and dP^T = V dO^T: 16-deep slices of d
      float s[32], dp[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * kPanelBytes + 32 * (kk & 3);
        Qk<64>::run(s, wg::desc(ks + off, 16, 1024),
                    wg::desc(qs + off, 16, 1024), kk);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * kPanelBytes + 32 * (kk & 3);
        Qk<64>::run(dp, wg::desc(vs + off, 16, 1024),
                    wg::desc(dos + off, 16, 1024), kk);
      }
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        wg::fence_operand(s[e]);
        wg::fence_operand(dp[e]);
      }

      // P^T = 2^(S^T scale2 - lse log2e) and dS^T, element (key, query
      // column 8 n + 2 t4 + e); the mask only on a tile that crosses the
      // diagonal, t_k or t_q (uniform across the warpgroup)
      const bool edge = (causal && 64 * i < key_wg + 63) ||
                        key_wg + 64 > t_k || 64 * i + 64 > t_q;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int qc = 8 * n + 2 * t4;
        const float2 lse2 = *reinterpret_cast<const float2*>(rows + qc);
        const float2 dlt2 = *reinterpret_cast<const float2*>(rows + 64 + qc);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int e = 4 * n + x;
          const float l = (x & 1) ? lse2.y : lse2.x;
          const float dl = (x & 1) ? dlt2.y : dlt2.x;
          float p = ex2(fmaf(s[e], scale2, -l * kLog2e));
          if (edge) {
            const int qpos = 64 * i + qc + (x & 1);
            const int kpos = key_wg + r0 + 8 * (x >> 1);
            if (kpos >= t_k || qpos >= t_q || (causal && qpos < kpos))
              p = 0.f;
          }
          s[e] = p;
          dp[e] = p * (dp[e] - dl) * scale;
        }
      }
      // P^T and dS^T rounded to bf16 in the A operands: keys are rows,
      // queries 16 kk.. are the accumulator's n8 tiles 2 kk and 2 kk + 1
      uint32_t pa[4][4], dsa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[kk][e] = bf16_tc::pack_bf16x2(s[8 * kk + 2 * e],
                                           s[8 * kk + 2 * e + 1]);
          dsa[kk][e] = bf16_tc::pack_bf16x2(dp[8 * kk + 2 * e],
                                            dp[8 * kk + 2 * e + 1]);
        }

      // dV += P^T dO and dK += dS^T Q: dO and Q [query][d] are the
      // MN-major B, 16 queries (2 KB) a slice
#pragma unroll
      for (int e = 0; e < D / 2; ++e) {
        wg::fence_operand(acc_k[e]);
        wg::fence_operand(acc_v[e]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fence_operand(pa[kk][e]);
          fence_operand(dsa[kk][e]);
        }
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Pv<D>::run(acc_v, pa[kk], wg::desc(dos + 2048 * kk, kPanelBytes, 1024));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Pv<D>::run(acc_k, dsa[kk], wg::desc(qs + 2048 * kk, kPanelBytes, 1024));
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < D / 2; ++e) {
        wg::fence_operand(acc_k[e]);
        wg::fence_operand(acc_v[e]);
      }
    }
    // this warpgroup's products that read the stage have retired
    if (leader) wg::mbar_arrive(qempty + 8 * stage);
    if (++stage == L::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // dk into the warpgroup's own K tile, dv into its own V tile (neither
  // read any more), each stored as whole rows below t_k
  store_rows<D>(acc_k, smem + wgi * L::kTileBytes, r0, t4, dk, b, h, H, t_k,
                key_wg, wgi);
  store_rows<D>(acc_v, smem + (2 + wgi) * L::kTileBytes, r0, t4, dv, b, h, H,
                t_k, key_wg, wgi);
}

// One block per (bh, 128-query tile): dq = dS K over the key tiles up to
// the diagonal (causal) or all of them; heaviest tiles first.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16_tc::bf16* __restrict__ dq, int H, int t_q,
                          int t_k, int tqp, int causal, float scale) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the atoms' alignment
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_full = base + L::kDqBarOffset;
  const uint32_t kfull = q_full + 8, kempty = kfull + 8 * L::kStages;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest first
  int n_tiles = (t_k + 63) / 64;
  if (causal) n_tiles = min(n_tiles, (q0 + kRows - 1) / 64 + 1);

  if (threadIdx.x == 0) {
    wg::mbar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      wg::mbar_init(kfull + 8 * s, 1);   // the producer's, with TMA's bytes
      wg::mbar_init(kempty + 8 * s, 2);  // one a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 8) {
    // -- the producer: Q, dO and their rows once, then K and V tiles ------
    if (lane == 0) {
      const int n_rows = min(2, (tqp - q0) / 64);  // tiles below tqp
      wg::mbar_expect_tx(q_full, L::kFixedBytes + 2 * kRowBytes * n_rows);
      for (int r = 0; r < 2; ++r) {
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load_4d(base + (r * L::kPanels + p) * kPanelBytes, &q_map,
                      64 * p, h, q0 + 64 * r, b, q_full);
          tma_load_4d(base + 2 * L::kTileBytes +
                          (r * L::kPanels + p) * kPanelBytes,
                      &do_map, 64 * p, h, q0 + 64 * r, b, q_full);
        }
        if (r < n_rows) {
          const size_t row = (size_t)bh * tqp + q0 + 64 * r;
          const uint32_t dst = base + L::kDqRowsOffset + r * kRowBytes;
          bulk_load(dst, lse + row, kRowBytes, q_full);
          bulk_load(dst + 2 * kRowBytes, delta + row, kRowBytes, q_full);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        const uint32_t st = base + L::kFixedBytes + 1024 +
                            stage * L::kDqStageBytes;
        const uint32_t fb = kfull + 8 * stage;
        wg::mbar_wait(kempty + 8 * stage, phase ^ 1);
        wg::mbar_expect_tx(fb, L::kDqStageBytes);
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load_4d(st + p * kPanelBytes, &k_map, 64 * p, h, 64 * j, b, fb);
          tma_load_4d(st + L::kTileBytes + p * kPanelBytes, &v_map, 64 * p,
                      h, 64 * j, b, fb);
        }
        if (++stage == L::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // -- the consumers: 64 query rows a warpgroup, every key tile -----------
  const int wgi = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int row_wg = q0 + 64 * wgi;              // the warpgroup's rows
  const int r0 = 16 * (warp & 3) + g;            // its rows r0, r0 + 8
  const bool leader = (threadIdx.x & 127) == 0;
  const bool live = row_wg < t_q;
  const uint32_t qs = base + wgi * L::kTileBytes;
  const uint32_t dos = base + (2 + wgi) * L::kTileBytes;
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  const float kLog2e = 1.4426950408889634f;
  const float scale2 = scale * kLog2e;  // S in base 2: exp(x) = 2^(x log2 e)
  wg::mbar_wait(q_full, 0);
  float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
  if (live) {
    const float* rows = reinterpret_cast<const float*>(smem + L::kDqRowsOffset);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 64 * wgi + r0 + 8 * hh;
      lse2[hh] = rows[r] * kLog2e;
      dlt[hh] = rows[2 * 64 + r];
    }
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < n_tiles; ++j) {
    wg::mbar_wait(kfull + 8 * stage, phase);
    const uint32_t ks = base + L::kFixedBytes + 1024 + stage * L::kDqStageBytes;
    const uint32_t vs = ks + L::kTileBytes;
    // a causal tile wholly after the warpgroup's last row adds nothing
    if (live && (!causal || 64 * j <= row_wg + 63)) {
      // S = Q K^T and dP = dO V^T: 16-deep slices of d
      float s[32], dp[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * kPanelBytes + 32 * (kk & 3);
        Qk<64>::run(s, wg::desc(qs + off, 16, 1024),
                    wg::desc(ks + off, 16, 1024), kk);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * kPanelBytes + 32 * (kk & 3);
        Qk<64>::run(dp, wg::desc(dos + off, 16, 1024),
                    wg::desc(vs + off, 16, 1024), kk);
      }
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        wg::fence_operand(s[e]);
        wg::fence_operand(dp[e]);
      }

      // dS = P (dP - delta) scale, element (row r0 + 8 hh, key column
      // 8 n + 2 t4 + e); the mask only on a tile that crosses the diagonal
      // or t_k
      const bool edge = (causal && 64 * j + 63 > row_wg) || 64 * j + 64 > t_k;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int hh = (e >> 1) & 1;
        float p = ex2(fmaf(s[e], scale2, -lse2[hh]));
        if (edge) {
          const int qpos = row_wg + r0 + 8 * hh;
          const int kpos = 64 * j + 8 * (e >> 2) + 2 * t4 + (e & 1);
          if (kpos >= t_k || (causal && qpos < kpos)) p = 0.f;
        }
        s[e] = p * (dp[e] - dlt[hh]) * scale;
      }
      // dS rounded to bf16 in the A operand: keys 16 kk.. are the
      // accumulator's n8 tiles 2 kk and 2 kk + 1
      uint32_t dsa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dsa[kk][e] = bf16_tc::pack_bf16x2(s[8 * kk + 2 * e],
                                            s[8 * kk + 2 * e + 1]);

      // dQ += dS K: K [key][d] is the MN-major B, 16 keys (2 KB) a slice
#pragma unroll
      for (int e = 0; e < D / 2; ++e) wg::fence_operand(acc[e]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) fence_operand(dsa[kk][e]);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Pv<D>::run(acc, dsa[kk], wg::desc(ks + 2048 * kk, kPanelBytes, 1024));
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < D / 2; ++e) wg::fence_operand(acc[e]);
    }
    // this warpgroup's products that read the stage have retired
    if (leader) wg::mbar_arrive(kempty + 8 * stage);
    if (++stage == L::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // dq into the warpgroup's own Q tile (read by now), stored below t_q
  store_rows<D>(acc, smem + wgi * L::kTileBytes, r0, t4, dq, b, h, H, t_q,
                row_wg, wgi);
}

// q, k, v, dO as 4-d tensor maps (strides[3 i..3 i + 2] the (b, t, h)
// element strides of operand i), or a CUDA error
inline cudaError_t encode_four(CUtensorMap (&maps)[4], const void* const (&xs)[4],
                               const long long (&strides)[12], int B, int H,
                               int t_q, int t_k, int D) {
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = encode_bthd(
        &maps[i], xs[i], B, (i == 1 || i == 2) ? t_k : t_q, H, D,
        strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int D>
int launch_dkv(const void* const (&xs)[4], const long long (&strides)[12],
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int t_q, int t_k, int tqp, int causal,
               float scale, cudaStream_t stream) {
  using L = Layout<D>;
  static bool opted[64] = {};
  cudaError_t err = opt_in(flash_bwd_dkv_wgmma_kernel<D>, L::kDkvBytes, opted);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[4];
  err = encode_four(maps, xs, strides, B, H, t_q, t_k, D);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (t_k + kRows - 1) / kRows);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, kThreads, L::kDkvBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta,
      static_cast<bf16_tc::bf16*>(dk), static_cast<bf16_tc::bf16*>(dv), H,
      t_q, t_k, tqp, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* const (&xs)[4], const long long (&strides)[12],
              const float* lse, const float* delta, void* dq, int B, int H,
              int t_q, int t_k, int tqp, int causal, float scale,
              cudaStream_t stream) {
  using L = Layout<D>;
  static bool opted[64] = {};
  cudaError_t err = opt_in(flash_bwd_dq_wgmma_kernel<D>, L::kDqBytes, opted);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[4];
  err = encode_four(maps, xs, strides, B, H, t_q, t_k, D);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (t_q + kRows - 1) / kRows);
  flash_bwd_dq_wgmma_kernel<D><<<grid, kThreads, L::kDqBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta,
      static_cast<bf16_tc::bf16*>(dq), H, t_q, t_k, tqp, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace hop_bwd

bool bad_shape(int bh, int tqp, int tkp) {
  return bh <= 0 || tqp <= 0 || tkp <= 0 || tqp % kB || tkp % kB ||
         tqp / kB > 65535 || tkp / kB > 65535;
}

// the Hopper entries' shared checks: sizes, tqp = t_q rounded up to 64,
// 16-byte aligned rows and outputs
bool bad_bthd(int B, int H, int t_q, int t_k, int tqp, const void* lse,
              const void* delta, const void* out0, const void* out1) {
  return B <= 0 || H <= 0 || t_q <= 0 || t_k <= 0 ||
         tqp != (t_q + 63) / 64 * 64 || (long long)B * H > INT_MAX ||
         (t_q + hop_bwd::kRows - 1) / hop_bwd::kRows > 65535 ||
         (t_k + hop_bwd::kRows - 1) / hop_bwd::kRows > 65535 ||
         !gemm::aligned16(lse) || !gemm::aligned16(delta) ||
         !gemm::aligned16(out0) || !gemm::aligned16(out1);
}

}  // namespace

// q, k, v, dout: f32 [B, T, H, D] with d contiguous, (b, t, h) element
// strides in `*_s*` (multiples of 4, 16-byte aligned bases); lse, delta
// f32 [B*H, tqp] with tqp = t_q rounded up to 64; dq f32 [B, t_q, H, D]
// contiguous; d 16, 32, 64 or 128
extern "C" int flash_attention_bwd_dq_tf32x3(
    const float* q, const float* k, const float* v, const float* dout,
    long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, long long do_sb, long long do_st, long long do_sh,
    const float* lse, const float* delta, float* dq, int B, int H,
    int t_q, int t_k, int tqp, int d, int causal, float scale, void* stream) {
  const tf32x3::Operands ops = {{q, k, v, dout},
                                {q_sb, k_sb, v_sb, do_sb},
                                {q_st, k_st, v_st, do_st},
                                {q_sh, k_sh, v_sh, do_sh}};
  if (bad_bthd(B, H, t_q, t_k, tqp, lse, delta, dq, dq) ||
      tf32x3::bad_operands(ops, 4, tqp, t_k))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 16: return tf32::launch_dq<16>(ops, lse, delta, dq, B, H, t_q, t_k, tqp, causal, scale, s);
    case 32: return tf32::launch_dq<32>(ops, lse, delta, dq, B, H, t_q, t_k, tqp, causal, scale, s);
    case 64: return tf32::launch_dq<64>(ops, lse, delta, dq, B, H, t_q, t_k, tqp, causal, scale, s);
    case 128: return tf32::launch_dq<128>(ops, lse, delta, dq, B, H, t_q, t_k, tqp, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the same operands; dk, dv f32 [B, t_k, H, D] contiguous
extern "C" int flash_attention_bwd_dkv_tf32x3(
    const float* q, const float* k, const float* v, const float* dout,
    long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, long long do_sb, long long do_st, long long do_sh,
    const float* lse, const float* delta, float* dk, float* dv, int B, int H,
    int t_q, int t_k, int tqp, int d, int causal, float scale, void* stream) {
  const tf32x3::Operands ops = {{q, k, v, dout},
                                {q_sb, k_sb, v_sb, do_sb},
                                {q_st, k_st, v_st, do_st},
                                {q_sh, k_sh, v_sh, do_sh}};
  if (bad_bthd(B, H, t_q, t_k, tqp, lse, delta, dk, dv) ||
      tf32x3::bad_operands(ops, 4, tqp, t_k))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 16: return tf32::launch_dkv<16>(ops, lse, delta, dk, dv, B, H, t_q, t_k, tqp, causal, scale, s);
    case 32: return tf32::launch_dkv<32>(ops, lse, delta, dk, dv, B, H, t_q, t_k, tqp, causal, scale, s);
    case 64: return tf32::launch_dkv<64>(ops, lse, delta, dk, dv, B, H, t_q, t_k, tqp, causal, scale, s);
    case 128: return tf32::launch_dkv<128>(ops, lse, delta, dk, dv, B, H, t_q, t_k, tqp, causal, scale, s);
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

// q, k, v, dout: bf16 [B, T, H, D] with d contiguous, (b, t, h) element
// strides in `*_s*` (multiples of 8, 16-byte aligned bases); lse, delta
// f32 [B*H, tqp] with tqp = t_q rounded up to 64; dq bf16 [B, t_q, H, D]
// contiguous; d 64 or 128
extern "C" int flash_attention_bwd_dq_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, long long do_sb, long long do_st, long long do_sh,
    const float* lse, const float* delta, void* dq, int B, int H, int t_q,
    int t_k, int tqp, int d, int causal, float scale, void* stream) {
  if (bad_bthd(B, H, t_q, t_k, tqp, lse, delta, dq, dq))
    return (int)cudaErrorInvalidValue;
  const void* const xs[4] = {q, k, v, dout};
  const long long strides[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                                 v_sb, v_st, v_sh, do_sb, do_st, do_sh};
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 64: return hop_bwd::launch_dq<64>(xs, strides, lse, delta, dq, B, H, t_q, t_k, tqp, causal, scale, s);
    case 128: return hop_bwd::launch_dq<128>(xs, strides, lse, delta, dq, B, H, t_q, t_k, tqp, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the same operands; dk, dv bf16 [B, t_k, H, D] contiguous
extern "C" int flash_attention_bwd_dkv_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, long long do_sb, long long do_st, long long do_sh,
    const float* lse, const float* delta, void* dk, void* dv, int B, int H,
    int t_q, int t_k, int tqp, int d, int causal, float scale, void* stream) {
  if (bad_bthd(B, H, t_q, t_k, tqp, lse, delta, dk, dv))
    return (int)cudaErrorInvalidValue;
  const void* const xs[4] = {q, k, v, dout};
  const long long strides[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                                 v_sb, v_st, v_sh, do_sb, do_st, do_sh};
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 64: return hop_bwd::launch_dkv<64>(xs, strides, lse, delta, dk, dv, B, H, t_q, t_k, tqp, causal, scale, s);
    case 128: return hop_bwd::launch_dkv<128>(xs, strides, lse, delta, dk, dv, B, H, t_q, t_k, tqp, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

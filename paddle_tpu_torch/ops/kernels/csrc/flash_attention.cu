// Flash attention forward: softmax(q k^T * scale) v without the [Tq, Tk]
// score matrix ever reaching device memory; writes o and the row
// log-sum-exp (lse = m + log l) that a backward pass needs.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::flash_attention, forward
// (_fwd_impl: the single-tile _fwd_single_kernel and the tiled _fwd_kernel,
// grid (B*H, q tiles, k tiles) with the k-tile axis run in order and the
// online-softmax state carried in VMEM scratch).  Here the k-tile axis is a
// loop inside the block; blocks run in parallel in no order.
//
// Keys at or past t_k are masked with the finite -1e30 (or given P = 0),
// as the TPU kernel does; causal masks by absolute position.
//
// Three forms, one entry point each:
//   flash_attention_fwd_tf32x3  f32, 3xTF32 on the tensor cores, q, k, v
//                               read where they lie in [B, T, H, D] (below);
//   flash_attention_fwd_bf16    bf16 on mma.sync, on the padded [BH, Tp, D]
//                               problem (head_dim 16 and 32 on the main
//                               path);
//   flash_attention_fwd_wgmma   bf16 on wgmma fed by TMA from [B, T, H, D]
//                               (head_dim 64 and 128).

#include <cuda_runtime.h>

#include "flash_hopper.cuh"
#include "gemm_wgmma.cuh"
#include "mma_bf16.cuh"
#include "tf32x3.cuh"

namespace {

constexpr float kNegInf = -1e30f;

using flash_hop::opt_in;

// ---------------------------------------------------------------------------
// The f32 form (flash_attention_fwd_tf32x3): every product on the tensor
// cores as 3xTF32 (tf32x3.cuh, the pieces the f32 backward shares), the
// softmax state and the sums in f32.
//
// What bounds it on an H100: operations.  At the LM training shape
// (B=16, T=1024, H=12, D=64, causal) the products are 25.8 GFLOP over the
// causal pairs against ~0.20 GB of q, k, v, o and lse: 0.385 ms of f32
// FMA on the CUDA cores at best (the first design, 4x4 register tiles of
// FMAs, took 1.05 ms, held by shared-memory reads), 0.156 ms of three
// TF32 passes at 495 TFLOP/s.  The design is the f32 backward's:
// - One block of 4 warps per 64-query tile of one (b, h), each warp 16
//   rows; blocks numbered heaviest causal tile first.  K and V tiles of 64
//   keys stream through a kStages-deep ring by 16-byte cp.async (tile
//   j + kStages - 1's copies in flight while tile j is computed); causal
//   tiles above the diagonal are never loaded.
// - Operands where they lie: q, k and v are read from [B, T, H, D] with
//   their own (b, t, h) strides (multiples of 4 floats, 16-byte aligned
//   bases), rows at or past T zero-filled by the copy, so a padded query
//   row is q = 0 and its lse is the padded problem's; o is written into a
//   contiguous [B, t_q, H, D], lse into the [B*H, Tqp] rows the backward
//   reads (Tqp = t_q rounded up to 64).
// - S = Q K^T by mma.sync.m16n8k8 as hi.hi + hi.lo + lo.hi, K [key][d]
//   as B's [n][k]; D / 8 slices deep, chained at head_dim <= 64 and
//   summed apart at 128 (kSliceApart).  At head_dim <= 64 each warp splits
//   its Q fragments once into registers (64 a thread at 64), Q landing in
//   the ring's last slot before that slot's first tile, so a block takes
//   70 KB and three fit an SM; at 128 the fragments would take 128
//   registers, so Q keeps a tile of its own and is split each tile.
// - Scale, the mask (keys at or past t_k; causal by absolute position)
//   only on the tiles that cross the diagonal or t_k, and the online
//   softmax in base 2 on ex2.approx: m is the running max of S scale
//   log2(e), and P = 2^x with x = S scale log2(e) - m in one fma.
// - P is the A operand of P V as S's accumulators lie (tf32x3.cuh's
//   fragment order), V [key][d] as B's [k][n].  O += P V is a long sum
//   (T / 8 slices): each slice's three passes are summed apart and added
//   to O to nearest (mma3_add).
// - The epilogue: o = O / max(l, 1e-30) as float2 stores of whole rows
//   below t_q, lse = (m + log2 l) ln 2.
namespace tf32f {

using namespace tf32x3;

constexpr int kThreads = 128;  // 4 warps; warp w owns rows 16w..16w+15
constexpr int kStages = 2;     // K/V tiles of the ring

template <int D>
constexpr bool kQInRegisters = D <= 64;
// where Q's fragments live in registers, Q lands in the ring's last slot
// (read before that slot's first tile is fetched) and takes no tile of
// its own: 70 KB a block at head_dim 64, three blocks an SM
template <int D>
constexpr int kQTiles = kQInRegisters<D> ? 0 : 1;
template <int D>
constexpr int kMinBlocks = D <= 64 ? 3 : 1;

template <int D>
constexpr size_t smem_bytes() {
  return (kQTiles<D> + 2 * (size_t)kStages) * tile_floats<D>() *
         sizeof(float);
}

// ops: q, k, v
template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
flash_fwd_tf32x3_kernel(const Operands ops, float* __restrict__ o,
                        float* __restrict__ lse, int H, int t_q, int t_k,
                        int tqp, int causal, float scale) {
  constexpr int LD = ld<D>(), TILE = tile_floats<D>(), kNT = D / 8;
  constexpr int kKC = D / 8;  // 8-deep slices of d
  extern __shared__ __align__(16) float smem_f[];
  float* ring = smem_f + kQTiles<D> * TILE;  // [kStages][K, V]
  float* sq = kQTiles<D> ? smem_f : ring + (kStages - 1) * 2 * TILE;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = qt * kB + 16 * warp + g;   // rows row0 and row0 + 8

  int n_tiles = (t_k + kB - 1) / kB;
  if (causal) n_tiles = min(n_tiles, qt + 1);
  const Rows kr = ops.rows(1, b, h), vr = ops.rows(2, b, h);
  auto stage = [&](int j) { return ring + (j % kStages) * 2 * TILE; };
  auto fetch = [&](int j) {
    copy_rows<D, kThreads>(stage(j), kr, j * kB, t_k, tid);
    copy_rows<D, kThreads>(stage(j) + TILE, vr, j * kB, t_k, tid);
  };

  // one copy group for Q, then one a tile for the ring's first tiles
  // (slots 0 .. kStages - 2; the last holds Q where it has no tile)
  copy_rows<D, kThreads>(sq, ops.rows(0, b, h), qt * kB, t_q, tid);
  bf16_tc::cp_async_commit();
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) fetch(j);
    bf16_tc::cp_async_commit();
  }
  bf16_tc::cp_async_wait<kStages - 1>();  // Q has landed: this thread's
  __syncthreads();                         // ... and everyone's

  const float* qa = sq + (16 * warp + g) * LD + t;  // A rows g, g + 8
  auto q_frag = [&](SplitA& a, int kc) {
    a.set(qa[8 * kc], qa[8 * LD + 8 * kc], qa[8 * kc + 4],
          qa[8 * LD + 8 * kc + 4]);
  };
  SplitA qf[kQInRegisters<D> ? kKC : 1];
  if constexpr (kQInRegisters<D>) {
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) q_frag(qf[kc], kc);
  }

  float acc[kNT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float scale2 = scale * 1.4426950408889634f;  // scale log2(e)

  for (int j = 0; j < n_tiles; ++j) {
    bf16_tc::cp_async_wait<kStages - 2>();  // tile j has landed: this
    __syncthreads();  // thread's and everyone's; every warp is past j - 1
    if (j + kStages - 1 < n_tiles) fetch(j + kStages - 1);  // j - 1's slot
    bf16_tc::cp_async_commit();  // an empty group keeps the count uniform
    const float* sk = stage(j);
    const float* sv = sk + TILE;

    // S = Q K^T: 16 rows x 64 keys a warp, 8 n8 tiles
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
      SplitA a;
      if constexpr (kQInRegisters<D>) {
        a = qf[kc];
      } else {
        q_frag(a, kc);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int bi = (8 * n + g) * LD + 8 * kc + t;
        if constexpr (kSliceApart<D>) {
          mma3_add(s[n], a, sk[bi], sk[bi + 4]);
        } else {
          mma3(s[n], a, sk[bi], sk[bi + 4]);
        }
      }
    }

    // the mask only on a tile that crosses the diagonal or t_k (uniform
    // across the block); the row max of S scale log2(e) over the quad
    const bool edge = (causal && j == qt) || (j + 1) * kB > t_k;
    auto valid = [&](int n, int e) {
      const int qpos = row0 + 8 * (e >> 1);
      const int kpos = j * kB + 8 * n + 2 * t + (e & 1);
      return !edge || (kpos < t_k && (!causal || qpos >= kpos));
    };
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (valid(n, e)) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e] * scale2);
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      corr[hh] = flash_hop::ex2(m[hh] - m_new);
      m[hh] = m_new;
    }
    // P = 2^(S scale log2(e) - m), its row sum l's
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = valid(n, e) ? flash_hop::ex2(fmaf(s[n][e], scale2,
                                                    -m[e >> 1]))
                              : 0.f;
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
      l[hh] = l[hh] * corr[hh] + rs[hh];
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // O += P V over the tile's 64 keys in the fragment order (0, 2, 4, 6,
    // 1, 3, 5, 7): B's rows are the keys 2t and 2t + 1
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      SplitA pa;
      pa.set(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
#pragma unroll
      for (int dn = 0; dn < kNT; ++dn) {
        const int bi = (8 * kk + 2 * t) * LD + 8 * dn + g;
        mma3_add(acc[dn], pa, sv[bi], sv[bi + LD]);  // O's slice apart
      }
    }
  }
  bf16_tc::cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    const float safe_l = fmaxf(l[hh], 1e-30f);
    if (t == 0)  // back from base 2
      lse[(size_t)bh * tqp + row] =
          (m[hh] + log2f(safe_l)) * 0.6931471805599453f;
    if (row >= t_q) continue;
    float* out = o + (((size_t)b * t_q + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[n][2 * hh] / safe_l, acc[n][2 * hh + 1] / safe_l);
  }
}

template <int D>
int launch(const Operands& ops, float* o, float* lse, int B, int H, int t_q,
           int t_k, int tqp, int causal, float scale, cudaStream_t stream) {
  static bool opted[64] = {};
  const int smem = (int)smem_bytes<D>();
  const cudaError_t err = opt_in(flash_fwd_tf32x3_kernel<D>, smem, opted);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, tqp / kB);
  flash_fwd_tf32x3_kernel<D><<<grid, kThreads, smem, stream>>>(
      ops, o, lse, H, t_q, t_k, tqp, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace tf32f

// ---------------------------------------------------------------------------
// The bf16 form: bf16 q, k, v on the tensor cores, f32 scores, softmax
// state and accumulators, o written in bf16 and lse in f32, as the TPU
// kernel does with bf16 operands (flash_attention.py: the scores by
// jnp.dot(..., preferred_element_type=f32) :64, P rounded to the
// operands' dtype before P.V :75, o in the operands' dtype :89).
//
// What bounds it on an H100: bytes on paper.  At the LM training shape
// (B=16, T=1024, H=12, D=64, causal) the function is 25.8 GFLOP against
// ~101 MB of q, k, v, o and lse: ~26 us at 989 TFLOP/s against ~30 us at
// 3.35 TB/s.  This first design is simple and right, not fast: one block
// of 4 warps per 64 query rows, each warp 16 rows.  The q tile stays in
// shared memory; K and V stream through a 2-stage ring of 64-key tiles by
// 16-byte cp.async (the copies of tile j + 1 in flight while tile j is
// computed); causal tiles above the diagonal are never loaded.  For each
// tile:
//   S = Q K^T by mma.sync.m16n8k16: Q's fragments by ldmatrix from [q][d];
//     K lies [key][d], which is B's [n][k], so plain ldmatrix (no .trans);
//   scale, the finite -1e30 mask (keys at or past t_k, and keys after the
//     query), the online softmax in f32 registers: the row max and the
//     row sum over the 4 threads of a quad by shuffles, m, l and the
//     correction exp(m_old - m_new), as _fwd_kernel :66-80;
//   P = exp(S - m) rounded to bf16 against the running max and packed
//     straight from the two n8 accumulator tiles of 16 keys into the m16k16
//     A fragment of P.V (mma_bf16.cuh's layouts line up);
//   O = O * corr + P V, V [key][d] = B's [k][n] by ldmatrix.trans.
// Shared rows are padded by 8 bf16 (16 bytes; mma_bf16.cuh's copy_tile64).

namespace tc = bf16_tc;
using bf16 = tc::bf16;

constexpr int kTcThreads = 128;  // 4 warps; warp w owns rows 16w..16w+15

template <int D>
constexpr size_t fwd_bf16_smem_bytes() {
  // q + 2 stages x (K, V)
  return 5 * (size_t)tc::tile64_elems<D>() * sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int tqp, int tkp, int t_k,
                      int causal, float scale) {
  constexpr int LD = tc::tile_ld<D>(), TILE = tc::tile64_elems<D>();
  constexpr int kNT = D / 8;   // n8 tiles of a warp's output rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = sq + TILE;      // [2 stages][K, V]

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = qt * 64 + 16 * warp + g;   // rows row0 and row0 + 8

  int n_tiles = tkp / 64;
  if (causal) n_tiles = min(n_tiles, qt + 1);
  const bf16* kg = k + (size_t)bh * tkp * D;
  const bf16* vg = v + (size_t)bh * tkp * D;
  auto stage_k = [&](int j) { return ring + (j & 1) * 2 * TILE; };
  auto stage_v = [&](int j) { return ring + (j & 1) * 2 * TILE + TILE; };
  auto copy = [&](bf16* dst, const bf16* src) {
    tc::copy_tile64<D, kTcThreads>(dst, src, tid);
  };

  copy(sq, q + ((size_t)bh * tqp + (size_t)qt * 64) * D);
  copy(stage_k(0), kg);
  copy(stage_v(0), vg);
  tc::cp_async_commit();

  float acc[kNT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
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
    tc::cp_async_commit();  // an empty group keeps the count uniform
    tc::cp_async_wait<1>();  // tile j (and q) has landed: this thread's
    __syncthreads();         // ... and everyone's
    const bf16* sk = stage_k(j);
    const bf16* sv = stage_v(j);

    // S = Q K^T: 16 rows x 64 keys a warp, 8 n8 tiles
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[4];
      tc::ldmatrix_x4(a, sq + (16 * warp + (lane & 15)) * LD + 16 * kc +
                             8 * (lane >> 4));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        tc::ldmatrix_x4(b, sk + (16 * np + (lane & 7) + 8 * (lane >> 4)) * LD +
                               16 * kc + 8 * ((lane >> 3) & 1));
        tc::mma_bf16(s[2 * np], a, b[0], b[1]);
        tc::mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // scale and mask; the row max over the quad
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = row0 + 8 * (e >> 1);
        const int kpos = j * 64 + 8 * n + 2 * t + (e & 1);
        const bool valid = kpos < t_k && (!causal || qpos >= kpos);
        s[n][e] = valid ? __fmul_rn(s[n][e], scale) : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
    // P = exp(S - m) in f32 (its row sum is l's), then rounded to bf16 in
    // the A fragments of P V: keys 16kk.. are the n8 tiles 2kk and 2kk + 1
    uint32_t pa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = tc::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = tc::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = tc::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = tc::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l[h] = l[h] * corr[h] + rs[h];
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // O += P V: V [key][d] is B's [k][n], two d n8 tiles an ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        tc::ldmatrix_x4_trans(b, sv + (16 * kk + (lane & 15)) * LD + 16 * dp +
                                     8 * (lane >> 4));
        tc::mma_bf16(acc[2 * dp], pa[kk], b[0], b[1]);
        tc::mma_bf16(acc[2 * dp + 1], pa[kk], b[2], b[3]);
      }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t row = (size_t)bh * tqp + row0 + 8 * h;
    const float safe_l = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o + row * D + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * h] / safe_l,
                                acc[n][2 * h + 1] / safe_l);
    if (t == 0) lse[row] = m[h] + logf(safe_l);
  }
}

template <int D>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                float* lse, int bh, int tqp, int tkp, int t_k, int causal,
                float scale, cudaStream_t stream) {
  const int smem = (int)fwd_bf16_smem_bytes<D>();
  static bool opted[64] = {};
  const cudaError_t err = opt_in(flash_fwd_bf16_kernel<D>, smem, opted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, tqp / 64);
  flash_fwd_bf16_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      q, k, v, o, lse, tqp, tkp, t_k, causal, scale);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The Hopper form of the bf16 forward (flash_attention_fwd_wgmma), for
// head_dim 64 and 128; the mma.sync form above keeps 16 and 32.  The same
// function and rounding points as the mma.sync form (the twin is
// flash_attention.py's _fwd_plain_tiled over 64-key tiles): S = Q K^T in
// f32, the online softmax in f32 registers, P = exp(S - m_running)
// rounded to bf16 before P.V, o rounded once, lse f32.  Only wgmma reaches
// the card's full bf16 rate, and at the LM and prefill shapes the products
// (4 T^2 D / 2 flops a head, causal) outweigh the bytes, so the design is
// Hopper's:
// - A block is a 128-query tile of one (b, h): two consumer warpgroups of
//   64 rows each and one producer warp (288 threads).  Blocks are numbered
//   heaviest causal tile first over all heads (numbering the q tiles of
//   a head together, for K and V's reuse in L2, ran 8-16% slower).
// - Operands by TMA, where they lie: q, k and v stay [B, T, H, D] (any
//   strides that are multiples of 16 bytes) and are read through 4-d
//   tensor maps as boxes of [64 rows][64 d] in the 128-byte swizzle (a
//   D-64 bf16 row is 128 bytes; D 128 is two such panels); rows past T
//   read as zeros and are masked as in the mma.sync form.  o is written
//   [B, T, H, D] and lse [B*H, Tqp] (Tqp = T rounded up to 64, the
//   backward's rows).
// - The ring: the producer loads Q once (one barrier), then K and V tile
//   after tile into kStages stages, each with a full barrier (TMA's byte
//   count) and an empty one (one arrival a consumer warpgroup).  Causal
//   tiles past the block's last row are never loaded.  A warpgroup
//   releases a stage only after the wgmma groups that read it have
//   retired (wgmma.wait_group 0); a tile wholly after its own last row it
//   releases unread.
// - The softmax runs in base 2 on the special-function unit (ex2.approx:
//   one instruction an element where expf takes about ten), the mask
//   only on tiles that cross the diagonal or t_k: the tile loop is bound
//   by this work, not by the tensor cores, at head_dim 64.
// - The products: S = Q K^T on wgmma m64n64k16 from shared memory, both
//   operands K-major (K lies [key][d], B's K-major layout); P is packed
//   from S's accumulators straight into wgmma's register A operand (the
//   accumulator's m16n8 layout is the A fragment's), and O += P V on
//   wgmma m64nDk16 with V [key][d] as the MN-major B (the transposed-B
//   flag), the RS form.
// - The epilogue: o = acc / l rounded once into the warpgroup's own Q
//   panels (read by now), then stored 16 bytes a lane as whole rows.
// D 64 holds two blocks an SM (83 KB of shared memory each, registers
// capped at 112 a thread), D 128 one.
namespace hop {

using namespace flash_hop;  // wg, kPanelBytes, the TMA loads, ex2, Qk, Pv

constexpr int kRows = 128;             // query rows a block
constexpr int kKeys = kBoxRows;        // keys a tile (the twin's tile)
constexpr int kThreads = 288;          // warpgroups 0, 1 consume; warp 8

template <int D>
struct Layout {
  static constexpr int kPanels = D / 64;
  static constexpr int kTileBytes = kPanels * kPanelBytes;  // 64 rows x D
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kStageBytes = 2 * kTileBytes;        // K, V
  static constexpr int kQBytes = 2 * kTileBytes;            // 128 rows
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  // + 1024: the dynamic window's start is rounded up to the swizzle atom
  static constexpr int kBytes = 1024 + kBarOffset + (1 + 2 * kStages) * 8;
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;
  static_assert(D == 64 || D == 128, "the Hopper form's head dims");
  static_assert(kMinBlocks * kBytes <= 227 * 1024, "shared memory");
};

template <int D>
__global__ void __launch_bounds__(kThreads, Layout<D>::kMinBlocks)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       bf16* __restrict__ o, float* __restrict__ lse, int H,
                       int t_q, int t_k, int tqp, int causal, float scale) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the atoms' alignment
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_full = base + L::kBarOffset;
  const uint32_t full = q_full + 8, empty = full + 8 * L::kStages;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest first
  int n_tiles = (t_k + kKeys - 1) / kKeys;
  if (causal) n_tiles = min(n_tiles, (q0 + kRows - 1) / kKeys + 1);

  if (threadIdx.x == 0) {
    wg::mbar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      wg::mbar_init(full + 8 * s, 1);   // the producer's, with TMA's bytes
      wg::mbar_init(empty + 8 * s, 2);  // one a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 8) {
    // -- the producer: Q once, then K and V tile after tile ----------------
    if (lane == 0) {
      wg::mbar_expect_tx(q_full, L::kQBytes);
      for (int r = 0; r < 2; ++r)
        for (int p = 0; p < L::kPanels; ++p)
          tma_load_4d(base + (r * L::kPanels + p) * kPanelBytes, &q_map,
                      64 * p, h, q0 + 64 * r, b, q_full);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        const uint32_t st = base + L::kQBytes + stage * L::kStageBytes;
        const uint32_t fb = full + 8 * stage;
        wg::mbar_wait(empty + 8 * stage, phase ^ 1);
        wg::mbar_expect_tx(fb, L::kStageBytes);
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load_4d(st + p * kPanelBytes, &k_map, 64 * p, h, j * kKeys, b,
                      fb);
          tma_load_4d(st + L::kTileBytes + p * kPanelBytes, &v_map, 64 * p,
                      h, j * kKeys, b, fb);
        }
        if (++stage == L::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // -- the consumers: 64 query rows a warpgroup, every tile ----------------
  const int wgi = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int row_wg = q0 + 64 * wgi;                // the warpgroup's rows
  const int row0 = row_wg + 16 * (warp & 3) + g;   // rows row0, row0 + 8
  const bool leader = (threadIdx.x & 127) == 0;
  const uint32_t qs = base + wgi * L::kTileBytes;
  // acc[4 n + 2 hh + e]: row row0 + 8 hh, column 8 n + 2 t4 + e
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // the softmax in base 2: S scale log2(e), so P = 2^(S' - m) is exp(S
  // scale - m ln 2), the same function at one more rounding of S
  const float scale2 = scale * 1.4426950408889634f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  wg::mbar_wait(q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < n_tiles; ++j) {
    wg::mbar_wait(full + 8 * stage, phase);
    const uint32_t ks = base + L::kQBytes + stage * L::kStageBytes;
    const uint32_t vs = ks + L::kTileBytes;
    // a causal tile wholly after the warpgroup's last row adds nothing
    if (!causal || j * kKeys <= row_wg + 63) {
      // S = Q K^T: 16-deep slices of d, a panel's 128 bytes 32 at a time
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * kPanelBytes + 32 * (kk & 3);
        Qk<64>::run(s, wg::desc(qs + off, 16, 1024),
                    wg::desc(ks + off, 16, 1024), kk);
      }
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) wg::fence_operand(s[i]);

      // scale; the mask only on a tile that crosses the diagonal or t_k
      // (uniform across the warpgroup); the row max over the quad
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale2;
      if ((causal && j * kKeys + kKeys - 1 > row_wg) ||
          j * kKeys + kKeys > t_k) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int qpos = row0 + 8 * ((i >> 1) & 1);
          const int kpos = j * kKeys + 8 * (i >> 2) + 2 * t4 + (i & 1);
          if (kpos >= t_k || (causal && qpos < kpos))
            s[i] = __int_as_float(0xff800000);  // -inf
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m[hh], mx[hh]);
        corr[hh] = ex2(m[hh] - m_new);
        m[hh] = m_new;
      }
      // P = 2^(S' - m) in f32 (its row sum is l's), rounded to bf16 in the
      // A operand of P V: keys 16 kk.. are S's n8 tiles 2 kk and 2 kk + 1
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = ex2(s[i] - m[(i >> 1) & 1]);
        rs[(i >> 1) & 1] += s[i];
      }
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = tc::pack_bf16x2(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
        rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
        l[hh] = l[hh] * corr[hh] + rs[hh];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

      // O += P V: V [key][d] is the MN-major B, 16 keys (2 KB) a slice
#pragma unroll
      for (int i = 0; i < D / 2; ++i) wg::fence_operand(acc[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) fence_operand(pa[kk][e]);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Pv<D>::run(acc, pa[kk], wg::desc(vs + 2048 * kk, kPanelBytes, 1024));
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) wg::fence_operand(acc[i]);
    }
    // this warpgroup's products that read the stage have retired
    if (leader) wg::mbar_arrive(empty + 8 * stage);
    if (++stage == L::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // o = acc / l rounded once into the warpgroup's own Q panels (16-byte
  // chunk c of row r at c ^ (r % 8)), then whole rows 16 bytes a lane
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wgi) : "memory");
  unsigned char* stg = smem + wgi * L::kTileBytes;
  float safe_l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    safe_l[hh] = fmaxf(l[hh], 1e-30f);
    const int row = row0 + 8 * hh;
    if (t4 == 0 && row < tqp)   // back from base 2
      lse[(size_t)bh * tqp + row] =
          (m[hh] + log2f(safe_l[hh])) * 0.6931471805599453f;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + 8 * hh - row_wg, c = n & 7;
      *reinterpret_cast<__nv_bfloat162*>(
          stg + (n >> 3) * kPanelBytes + r * 128 + ((c ^ (r & 7)) << 4) +
          4 * t4) =
          __floats2bfloat162_rn(acc[4 * n + 2 * hh] / safe_l[hh],
                                acc[4 * n + 2 * hh + 1] / safe_l[hh]);
    }
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wgi) : "memory");
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x & 127; i < 64 * kChunks; i += 128) {
    const int r = i / kChunks, cc = i % kChunks, c = cc & 7;
    const int row = row_wg + r;
    if (row < t_q)
      *reinterpret_cast<uint4*>(o + (((size_t)b * t_q + row) * H + h) * D +
                                8 * cc) =
          *reinterpret_cast<const uint4*>(stg + (cc >> 3) * kPanelBytes +
                                          r * 128 + ((c ^ (r & 7)) << 4));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v,
           const long long (&strides)[9], void* o, float* lse, int B, int H,
           int t_q, int t_k, int tqp, int causal, float scale,
           cudaStream_t stream) {
  using L = Layout<D>;
  static bool opted[64] = {};
  cudaError_t err = opt_in(flash_fwd_wgmma_kernel<D>, L::kBytes, opted);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[3];
  const void* xs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    err = encode_bthd(&maps[i], xs[i], B, i ? t_k : t_q, H, D,
                      strides[3 * i], strides[3 * i + 1],
                      strides[3 * i + 2]);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(B * H, (t_q + kRows - 1) / kRows);
  flash_fwd_wgmma_kernel<D><<<grid, kThreads, L::kBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), lse, H, t_q, t_k,
      tqp, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace hop

}  // namespace

// q, k, v: f32 [B, T, H, D] with d contiguous, (b, t, h) element strides
// in `*_s*` (multiples of 4, 16-byte aligned bases); o f32 [B, t_q, H, D]
// contiguous, lse f32 [B*H, tqp] with tqp = t_q rounded up to 64; d 16,
// 32, 64 or 128
extern "C" int flash_attention_fwd_tf32x3(
    const float* q, const float* k, const float* v, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh, float* o,
    float* lse, int B, int H, int t_q, int t_k, int tqp, int d, int causal,
    float scale, void* stream) {
  const tf32x3::Operands ops = {{q, k, v, nullptr},
                                {q_sb, k_sb, v_sb, 0},
                                {q_st, k_st, v_st, 0},
                                {q_sh, k_sh, v_sh, 0}};
  if (B <= 0 || H <= 0 || t_q <= 0 || t_k <= 0 ||
      tqp != (t_q + 63) / 64 * 64 || (long long)B * H > INT_MAX ||
      tf32x3::bad_operands(ops, 3, tqp, t_k) || !gemm::aligned16(o) ||
      !gemm::aligned16(lse))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 16: return tf32f::launch<16>(ops, o, lse, B, H, t_q, t_k, tqp, causal, scale, s);
    case 32: return tf32f::launch<32>(ops, o, lse, B, H, t_q, t_k, tqp, causal, scale, s);
    case 64: return tf32f::launch<64>(ops, o, lse, B, H, t_q, t_k, tqp, causal, scale, s);
    case 128: return tf32f::launch<128>(ops, o, lse, B, H, t_q, t_k, tqp, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q, k, v, o: bf16 [bh, tqp or tkp, d], 16-byte aligned; lse f32 [bh, tqp]
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int bh, int tqp, int tkp, int t_k,
                                        int d, int causal, float scale,
                                        void* stream) {
  if (bh <= 0 || tqp <= 0 || tkp <= 0 || tqp % 64 || tkp % 64 ||
      tqp / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 16: return launch_bf16<16>(qb, kb, vb, ob, lse, bh, tqp, tkp, t_k, causal, scale, s);
    case 32: return launch_bf16<32>(qb, kb, vb, ob, lse, bh, tqp, tkp, t_k, causal, scale, s);
    case 64: return launch_bf16<64>(qb, kb, vb, ob, lse, bh, tqp, tkp, t_k, causal, scale, s);
    case 128: return launch_bf16<128>(qb, kb, vb, ob, lse, bh, tqp, tkp, t_k, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q, k, v: bf16 [B, T, H, D] with d contiguous, (b, t, h) element strides
// in `*_s*` (multiples of 8, 16-byte aligned bases); o bf16 [B, t_q, H, D]
// contiguous, lse f32 [B*H, tqp] with tqp = t_q rounded up to 64; d 64 or
// 128
extern "C" int flash_attention_fwd_wgmma(
    const void* q, const void* k, const void* v, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh, void* o,
    float* lse, int B, int H, int t_q, int t_k, int tqp, int d, int causal,
    float scale, void* stream) {
  if (B <= 0 || H <= 0 || t_q <= 0 || t_k <= 0 ||
      tqp != (t_q + 63) / 64 * 64 || (long long)B * H > INT_MAX ||
      (t_q + hop::kRows - 1) / hop::kRows > 65535 ||
      !gemm::aligned16(o) || !gemm::aligned16(lse))
    return (int)cudaErrorInvalidValue;
  const long long strides[9] = {q_sb, q_st, q_sh, k_sb, k_st,
                                k_sh, v_sb, v_st, v_sh};
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 64: return hop::launch<64>(q, k, v, strides, o, lse, B, H, t_q, t_k, tqp, causal, scale, s);
    case 128: return hop::launch<128>(q, k, v, strides, o, lse, B, H, t_q, t_k, tqp, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

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
// What bounds it on an H100: operations.  At the serving prefill shape
// (B=8, T=512, H=12, D=64, causal) the products are ~3.2 GFLOP against
// ~50 MB of q/k/v/o, ~64 flop per byte, above the ~20 flop/byte f32 balance
// point.  f32 at full precision rules out the tensor cores (they would take
// TF32), so the ceiling is f32 FMA on the CUDA cores.  The design keeps
// every operand of the inner products in shared memory or registers: a
// 64-row q tile stays resident, 64-row K/V tiles stream through shared
// memory, each thread computes a 4x4 block of scores and a 4 x D/16 block
// of the output with FMAs, and causal tiles above the diagonal are never
// loaded.  Rows of shared tiles are padded by one float so the threads of
// a warp read distinct banks.
//
// Layout: q/o [BH, Tqp, D], k/v [BH, Tkp, D] with Tqp, Tkp multiples of 64
// (the wrapper transposes and zero-pads); lse [BH, Tqp].  Keys at or past
// t_k are masked with the finite -1e30, as the TPU kernel does.
//
// Two forms, one entry point each: flash_attention_fwd_f32 (this design)
// and flash_attention_fwd_bf16 (the tensor-core form, below).

#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // key rows per tile
constexpr int kThreads = 256; // 16 x 16: thread (ty, tx) owns rows ty*4+r
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t smem_floats() {
  return (size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D +
         (size_t)kBQ * (kBK + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int tqp, int tkp, int t_k,
                 int causal, float scale) {
  constexpr int QS = D + 1, KS = D + 1, PS = kBK + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;            // [kBQ][QS]
  float* sk = sq + kBQ * QS;   // [kBK][KS]
  float* sv = sk + kBK * KS;   // [kBK][D]
  float* sp = sv + kBK * D;    // [kBQ][PS]

  const int bh = blockIdx.x;
  // heaviest causal tiles (the last rows) are scheduled first
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const float* qg = q + ((size_t)bh * tqp + (size_t)qt * kBQ) * D;
  for (int i = tid; i < kBQ * D; i += kThreads) sq[(i / D) * QS + i % D] = qg[i];

  float acc[4][DC], m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  int n_tiles = tkp / kBK;
  if (causal) n_tiles = min(n_tiles, (qt * kBQ + kBQ - 1) / kBK + 1);
  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();  // the previous tile's sk/sv/sp are no longer read
    const float* kg = k + ((size_t)bh * tkp + (size_t)j * kBK) * D;
    const float* vg = v + ((size_t)bh * tkp + (size_t)j * kBK) * D;
    for (int i = tid; i < kBK * D; i += kThreads) {
      sk[(i / D) * KS + i % D] = kg[i];
      sv[i] = vg[i];
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = sq[(ty * 4 + r) * QS + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sk[(tx + 16 * c) * KS + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = qt * kBQ + ty * 4 + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = j * kBK + tx + 16 * c;
        const bool valid = kpos < t_k && (!causal || qpos >= kpos);
        s[r][c] = valid ? s[r][c] * scale : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      // the 16 threads of a row group are one half-warp: xor offsets < 16
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        rs += p;
        sp[(ty * 4 + r) * PS + tx + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = l[r] * corr + rs;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = sp[(ty * 4 + r) * PS + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = sv[kk * D + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const size_t row = (size_t)bh * tqp + (size_t)qt * kBQ + ty * 4 + r;
    const float safe_l = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) o[row * D + tx + 16 * c] = acc[r][c] / safe_l;
    if (tx == 0) lse[row] = m[r] + logf(safe_l);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int bh, int tqp, int tkp, int t_k, int causal,
           float scale, cudaStream_t stream) {
  const int smem = (int)(smem_floats<D>() * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, tqp / kBQ);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, lse, tqp, tkp, t_k, causal, scale);
  return (int)cudaGetLastError();
}

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
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, tqp / 64);
  flash_fwd_bf16_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      q, k, v, o, lse, tqp, tkp, t_k, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_fwd_f32(const float* q, const float* k,
                                       const float* v, float* o, float* lse,
                                       int bh, int tqp, int tkp, int t_k,
                                       int d, int causal, float scale,
                                       void* stream) {
  if (bh <= 0 || tqp <= 0 || tkp <= 0 || tqp % kBQ || tkp % kBK ||
      tqp / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 16: return launch<16>(q, k, v, o, lse, bh, tqp, tkp, t_k, causal, scale, s);
    case 32: return launch<32>(q, k, v, o, lse, bh, tqp, tkp, t_k, causal, scale, s);
    case 64: return launch<64>(q, k, v, o, lse, bh, tqp, tkp, t_k, causal, scale, s);
    case 128: return launch<128>(q, k, v, o, lse, bh, tqp, tkp, t_k, causal, scale, s);
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

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

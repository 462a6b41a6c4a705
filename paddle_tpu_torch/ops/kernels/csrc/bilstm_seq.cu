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
// Design.  Batch rows are independent, so a block owns one direction and
// a tile of kRows batch rows and walks every step of that direction with
// no grid barrier (blockIdx.y is the direction; the reverse one visits
// T-1..0).  W_h [D, 4D] stays in shared memory for the whole sequence
// (64 KB f32 at D 64).  W_x [E, 4D] (256 KB at E 256, D 64) does not fit
// beside it; it is read through L2 every step, where both directions'
// copies stay (512 KB of 50 MB).  Each step: the x_t rows of the tile are
// staged in shared memory, thread j owns gate column j for every row of
// the tile (acc = sum_e x[r][e] W_x[e][j] with W_x loads coalesced along
// j, + b[j], + sum_k h[r][k] W_h[k][j] from shared memory, one fmaf per
// term in ascending order), the pre-activations go to shared memory, and
// then thread (r, u) runs the cell of unit u and writes h and c.
//
// What bounds it on an H100: the step-to-step chain, then W_x's L2 reads.
// At B 64, T 24, E 256, D 64 the work is ~503 MFLOP (7.5 us of f32 FMA at
// 67 TFLOP/s), but each of the 24 steps of a direction waits on the one
// before, and each block pulls W_x (256 KB) through L2 every step.  Thread
// block clusters sharing W_x over distributed shared memory, or a time
// chunk's projection as one staged product, would cut that; a later PR's
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kRows = 4;          // batch rows a block owns (one float4)
constexpr int kMaxThreads = 256;
static_assert(kRows == 4, "the product loops read a row tile as one float4");

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

// floats of shared memory a block takes, the same formula on both sides
__host__ __device__ inline size_t smem_floats(int E, int D) {
  return (size_t)D * 4 * D + (size_t)kRows * (E + 2 * D + 4 * D);
}

__global__ void __launch_bounds__(kMaxThreads)
bilstm_fwd_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                  Dir fw, Dir bw, int B, int T, int E, int D) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const bool reverse = blockIdx.y == 1;
  const Dir p = reverse ? bw : fw;
  const int G = 4 * D;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - b0);
  // the tile's rows side by side ([.][kRows]), so one float4 holds them
  float* wh_s = smem;                        // [D][4D]
  float* x_s = wh_s + (size_t)D * G;         // [E][kRows]
  float* h_s = x_s + kRows * E;              // [D][kRows]
  float* c_s = h_s + kRows * D;              // [D][kRows]
  float* pre_s = c_s + kRows * D;            // [kRows][4D]

  for (int i = tid; i < D * G; i += nt) wh_s[i] = p.wh[i];
  for (int i = tid; i < kRows * D; i += nt) {
    const int r = i / D, u = i % D;
    const size_t o = (size_t)(b0 + r) * D + u;
    h_s[u * kRows + r] = r < rows ? p.h0[o] : 0.f;
    c_s[u * kRows + r] = r < rows ? p.c0[o] : 0.f;
  }

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    for (int i = tid; i < kRows * E; i += nt) {
      const int r = i / E, e = i % E;
      x_s[e * kRows + r] =
          r < rows ? x[((size_t)(b0 + r) * T + t) * E + e] : 0.f;
    }
    __syncthreads();
    // pre[r][j] = (x_t[r] . W_x[:, j] + b[j]) + h[r] . W_h[:, j]
    for (int j = tid; j < G; j += nt) {
      float ax[kRows], ah[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) ax[r] = ah[r] = 0.f;
#pragma unroll 8
      for (int e = 0; e < E; ++e) {
        const float w = __ldg(p.wx + (size_t)e * G + j);
        const float4 xv = *reinterpret_cast<const float4*>(x_s + e * kRows);
        ax[0] = fmaf(xv.x, w, ax[0]);
        ax[1] = fmaf(xv.y, w, ax[1]);
        ax[2] = fmaf(xv.z, w, ax[2]);
        ax[3] = fmaf(xv.w, w, ax[3]);
      }
#pragma unroll 8
      for (int k = 0; k < D; ++k) {
        const float w = wh_s[(size_t)k * G + j];
        const float4 hv = *reinterpret_cast<const float4*>(h_s + k * kRows);
        ah[0] = fmaf(hv.x, w, ah[0]);
        ah[1] = fmaf(hv.y, w, ah[1]);
        ah[2] = fmaf(hv.z, w, ah[2]);
        ah[3] = fmaf(hv.w, w, ah[3]);
      }
      const float bj = __ldg(p.b + j);
#pragma unroll
      for (int r = 0; r < kRows; ++r) pre_s[r * G + j] = (ax[r] + bj) + ah[r];
    }
    __syncthreads();
    // the cell of (row r, unit u), the row frozen past its length
    for (int i = tid; i < kRows * D; i += nt) {
      const int r = i / D, u = i % D;
      if (r >= rows) continue;
      const int b = b0 + r;
      const float* pr = pre_s + r * G;
      const float cp = c_s[u * kRows + r], hp = h_s[u * kRows + r];
      const float gi = sigm(pr[u] + __ldg(p.peep + u) * cp);
      const float gf = sigm(pr[D + u] + __ldg(p.peep + D + u) * cp);
      const float gg = tanhf(pr[2 * D + u]);
      const float c = gf * cp + gi * gg;
      const float go = sigm(pr[3 * D + u] + __ldg(p.peep + 2 * D + u) * c);
      const float h = go * tanhf(c);
      const float m = mask[(size_t)b * T + t];
      const float hn = m * h + (1.f - m) * hp;
      const float cn = m * c + (1.f - m) * cp;
      h_s[u * kRows + r] = hn;
      c_s[u * kRows + r] = cn;
      const size_t o = ((size_t)b * T + t) * D + u;
      p.hs[o] = hn;
      p.cs[o] = cn;
    }
    __syncthreads();
  }
  for (int i = tid; i < rows * D; i += nt) {
    const int r = i / D, u = i % D;
    const size_t o = (size_t)(b0 + r) * D + u;
    p.hT[o] = h_s[u * kRows + r];
    p.cT[o] = c_s[u * kRows + r];
  }
}

int threads_for(int D) {
  const int g = 4 * D;
  return g >= kMaxThreads ? kMaxThreads : ((g + 31) / 32) * 32;
}

}  // namespace

// The grid: (ceil(B / kRows), 2) blocks; the forward direction's operands
// first, then the reverse one's.  Returns cudaErrorInvalidValue for a
// shape whose shared-memory plan exceeds the card's opt-in limit.
extern "C" int bilstm_fwd_f32(
    const float* x, const float* mask,
    const float* wx_f, const float* b_f, const float* wh_f,
    const float* peep_f, const float* h0_f, const float* c0_f, float* hs_f,
    float* cs_f, float* hT_f, float* cT_f,
    const float* wx_b, const float* b_b, const float* wh_b,
    const float* peep_b, const float* h0_b, const float* c0_b, float* hs_b,
    float* cs_b, float* hT_b, float* cT_b,
    int B, int T, int E, int D, void* stream) {
  if (B <= 0 || T <= 0 || E <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = sizeof(float) * smem_floats(E, D);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bilstm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Dir fw{wx_f, b_f, wh_f, peep_f, h0_f, c0_f, hs_f, cs_f, hT_f, cT_f};
  const Dir bw{wx_b, b_b, wh_b, peep_b, h0_b, c0_b, hs_b, cs_b, hT_b, cT_b};
  const dim3 grid((B + kRows - 1) / kRows, 2);
  bilstm_fwd_kernel<<<grid, threads_for(D), smem, (cudaStream_t)stream>>>(
      x, mask, fw, bw, B, T, E, D);
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

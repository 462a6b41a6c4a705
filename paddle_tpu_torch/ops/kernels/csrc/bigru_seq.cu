// Fused bidirectional GRU forward over raw inputs: both directions in one
// persistent cooperative launch, the input projections x @ W_x + b inside
// the loop, step by step, so the [B, T, 3D] gate-input slabs never reach
// device memory.
//
// Replaces paddle_tpu/ops/pallas/gru.py::bigru_seq (the Pallas
// _bigru_fwd_kernel: grid (T,) run in order on one core, all six weight
// matrices resident in VMEM, both h carries in VMEM scratch).
//
// Layout: x [B, T, E]; mask [B, T] f32 (1 while t < length); per
// direction W_x [E, 3D], b [3D], W_h [D, 2D], W_hc [D, D], h0 [B, D],
// and the outputs hs [B, T, D], h_T [B, D].  The forward direction walks
// indices 0..T-1, the reverse one T-1..0 in the same steps.  E % 4 == 0
// and D % 4 == 0 (16-byte copies).  The cell is Paddle's (gru_seq.cu).
//
// What bounds it on an H100: operations, and the step-to-step
// dependency.  Per step and direction x_t @ W_x, h @ W_h and (r h) @ W_hc
// (at B 64, E = D = 512: 201 MFLOP, 12.9 GFLOP for both directions over
// 32 steps).  The six matrices are 12.6 MB f32, so no SM holds a whole
// direction (csrc/bilstm_seq.cu's whole-W_h-per-block layout does not
// scale to this D).  Instead the SMs split between the directions: each of ~64
// blocks a direction owns U units and keeps their 3U columns of W_x, W_h
// and W_hc in shared memory for the whole sequence (at D 512, U 8: 96 KB
// a block; W_x is read from shared memory, not through L2), with the
// product routine and gate code of gru_common.cuh, the same as the
// gru_seq kernels'.  A step has two grid-wide barriers, as gru_seq's
// forward: after the update/reset gates (every unit's r * h_{t-1}
// written), and after the new h.  No atomics: every output is written by
// one thread in a fixed order, so reruns are bit-identical.  The backward
// is two launches of gru_seq.cu's remat backward (the wrapper's
// autograd Function), as in the JAX package.

#include "gru_bf16.cuh"
#include "gru_common.cuh"

namespace {

using namespace gru;

struct Dir {
  const float *wxp, *bias, *whp, *whcp, *h0;
  float *hs, *hT;
};

template <int S>
__global__ void __launch_bounds__(kRows * kMaxUnits, 1)
bigru_fwd_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                 Dir fwd, Dir bwd, float* scratch, int B, int T, int E,
                 int D, int U) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nb = gridDim.x / 2;
  const int rev = blockIdx.x >= nb;
  const int jb = blockIdx.x - rev * nb;
  const Dir dir = rev ? bwd : fwd;
  float* wx_s = smem;                            // [E][U][3]
  float* wh_s = wx_s + (size_t)E * U * 3;        // [D][U][2]
  float* whc_s = wh_s + (size_t)D * U * 2;       // [D][U]
  float* a_s = whc_s + (size_t)D * U;
  const Lane ln(U);
  const int u = jb * U + ln.uu;
  const bool live = u < D;
  load_slice(wx_s, dir.wxp, (size_t)E * U * 3, jb);
  load_slice(wh_s, dir.whp, (size_t)D * U * 2, jb);
  load_slice(whc_s, dir.whcp, (size_t)D * U, jb);
  __syncthreads();
  float b_u = 0.f, b_r = 0.f, b_c = 0.f;
  if (live) {
    b_u = dir.bias[u];
    b_r = dir.bias[D + u];
    b_c = dir.bias[2 * D + u];
  }
  // this direction's [3][B][D] scratch: r * h_{t-1}, u, and xw_c
  float* rh_buf = scratch + (size_t)rev * 3 * B * D;
  float* u_buf = rh_buf + (size_t)B * D;
  float* xc_buf = u_buf + (size_t)B * D;
  cg::grid_group grid = cg::this_grid();
  const size_t TD = (size_t)T * D, TE = (size_t)T * E;

  for (int s = 0; s < T; ++s) {
    const int t = rev ? T - 1 - s : s;
    const int tp = rev ? t + 1 : t - 1;
    // (A) the projection, u, r and r * h_{t-1} of the own units
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      float xv[3], ur[2];
      gemm<3, S>(x + b0 * TE + (size_t)t * E, TE, rows, E, wx_s, U, ln, a_s,
                 xv);
      const float* a = s == 0 ? dir.h0 + (size_t)b0 * D
                              : dir.hs + b0 * TD + (size_t)tp * D;
      gemm<2, S>(a, s == 0 ? D : TD, rows, D, wh_s, U, ln, a_s, ur);
      if (!live || ln.row >= rows) continue;
      const int b = b0 + ln.row;
      const size_t bo = (size_t)b * D + u;
      const float hp = s == 0 ? __ldcg(dir.h0 + bo)
                              : __ldcg(dir.hs + b * TD + (size_t)tp * D + u);
      float ug, rg;
      update_reset(xv[0] + b_u, xv[1] + b_r, ur[0], ur[1], ug, rg);
      rh_buf[bo] = rg * hp;
      u_buf[bo] = ug;
      xc_buf[bo] = xv[2] + b_c;
    }
    grid.sync();
    // (B) the candidate and the new h of the own units
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      float ac[1];
      gemm<1, S>(rh_buf + (size_t)b0 * D, D, rows, D, whc_s, U, ln, a_s, ac);
      if (!live || ln.row >= rows) continue;
      const int b = b0 + ln.row;
      const size_t bo = (size_t)b * D + u;
      const float hp = s == 0 ? __ldcg(dir.h0 + bo)
                              : __ldcg(dir.hs + b * TD + (size_t)tp * D + u);
      const float c = candidate(xc_buf[bo], ac[0]);
      const float ug = u_buf[bo];
      const float m = mask[(size_t)b * T + t];
      const float hn = m * (ug * hp + (1.f - ug) * c) + (1.f - m) * hp;
      dir.hs[b * TD + (size_t)t * D + u] = hn;
      if (s == T - 1) dir.hT[bo] = hn;
    }
    grid.sync();
  }
}

}  // namespace

// Per direction: wxp [blocks][E][U][3], whp [blocks][D][U][2], whcp
// [blocks][D][U] the column slices of W_x, W_h and W_hc (one block set a
// direction: the grid is 2 ceil(D / U) blocks of 64U threads), bias [3D],
// h0 [B, D]; outputs hs [B, T, D], hT [B, D].  scratch: [2][3][B][D].
extern "C" int bigru_fwd_f32(const float* x, const float* mask,
                             const float* wxp_f, const float* b_f,
                             const float* whp_f, const float* whcp_f,
                             const float* h0_f, float* hs_f, float* hT_f,
                             const float* wxp_b, const float* b_b,
                             const float* whp_b, const float* whcp_b,
                             const float* h0_b, float* hs_b, float* hT_b,
                             float* scratch, int B, int T, int E, int D,
                             int U, void* stream) {
  if (!valid_shape(B, T, D, U) || E <= 0 || E % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t w = (size_t)(3 * E + 3 * D) * U;
  const int stages = stages_for(w, U);
  if (stages == 0) return (int)cudaErrorInvalidValue;
  const int grid = 2 * ((D + U - 1) / U);
  const size_t smem = sizeof(float) * (w + scratch_floats(U, stages));
  Dir fwd{wxp_f, b_f, whp_f, whcp_f, h0_f, hs_f, hT_f};
  Dir bwd{wxp_b, b_b, whp_b, whcp_b, h0_b, hs_b, hT_b};
  void* args[] = {&x, &mask, &fwd, &bwd, &scratch, &B, &T, &E, &D, &U};
  cudaStream_t st = (cudaStream_t)stream;
  return stages == 3
      ? cooperative(bigru_fwd_kernel<3>, grid, kRows * U, smem, args, st)
      : cooperative(bigru_fwd_kernel<2>, grid, kRows * U, smem, args, st);
}

// ---------------------------------------------------------------------------
// The bf16 form, bigru_fwd_bf16: the rounding points of _bigru_fwd_kernel
// with bf16 operands (gru.py:551-598): the projection x_t W_x + b summed in
// f32 and never rounded (:578-580), u and r from it plus h_{t-1} W_h in
// f32, r h_{t-1} rounded to bf16 before the candidate product, the cell
// in f32, the h carry rounded to bf16 every step, hs in bf16, h_T in f32
// (unrounded).
//
// The f32 form's layout with the tensor-core products of gru_bf16.cuh:
// the SMs split between the directions, each block owns U units of one
// direction (at D 512 on 66 SMs a direction, U 8: 64 blocks a direction)
// and keeps the pairs slices of W_x's and W_h's update and reset columns
// and the units slices of their candidate columns (W_x's and W_hc's) in
// shared memory for the whole sequence (at E = D = 512, U 8: 49,920
// bytes).  A step: (A) x_t W_x and h_{t-1} W_h over the pairs slices, two
// accumulators added as (x_t W_x + b) + h_{t-1} W_h, u and r; r h_{t-1}
// written; grid barrier; (B) x_t W_x and (r h_{t-1}) W_hc over the units
// slices, (x_t W_x + b) + (r h) W_hc, the candidate, the new h; grid
// barrier.  x_t is staged once in each phase, so no f32 slab is kept.
//
// What bounds it on an H100: the step-to-step chain, as the f32 form.
// Per step and direction the products are 201 MFLOP at B 64, E = D = 512
// (12.9 GFLOP over 32 steps and both directions: 13 us at 989 TFLOP/s).

namespace gru_bf16 {

struct Dir {
  const bf16 *wxp, *wxcp;   // W_x: pairs slices [u, r]; units slices [c]
  const float* bias;        // [3D] f32
  const bf16 *whp, *whcp;   // W_h pairs slices; W_hc units slices
  const bf16* h0;           // [B, D]
  bf16* hs;                 // [B, T, D]
  float* hT;                // [B, D]
};

template <int S>
__global__ void __launch_bounds__(kThreads, 1)
bigru_fwd_bf16_kernel(const bf16* __restrict__ x,
                      const float* __restrict__ mask, Dir fwd, Dir bwd,
                      bf16* rh_scr, float* u_scr, int B, int T, int E, int D,
                      int U) {
  extern __shared__ float4 smem4[];
  const int nblk = gridDim.x / 2;
  const int rev = blockIdx.x >= nblk;
  const int jb = blockIdx.x - rev * nblk;
  const Dir dir = rev ? bwd : fwd;
  const int LDE = ld_k(E), LDK = ld_k(D), NTA = tiles(2 * U), NTB = tiles(U);
  const size_t nxa = slice_elems(2 * U, E), nxb = slice_elems(U, E);
  const size_t na = slice_elems(2 * U, D), nb = slice_elems(U, D);
  bf16* wx_s = reinterpret_cast<bf16*>(smem4);
  bf16* wxc_s = wx_s + nxa;
  bf16* wh_s = wxc_s + nxb;
  bf16* whc_s = wh_s + na;
  bf16* a_s = whc_s + nb;
  float* sums = reinterpret_cast<float*>(a_s);
  load_slice(wx_s, dir.wxp, nxa, jb);
  load_slice(wxc_s, dir.wxcp, nxb, jb);
  load_slice(wh_s, dir.whp, na, jb);
  load_slice(whc_s, dir.whcp, nb, jb);
  __syncthreads();
  const Lane ln;
  const int ub = jb * U;
  // this lane's biases: the update and reset ones of its pair units, the
  // candidate's of its units
  float b_ur[kMaxNT][2], b_c[kMaxNT][2];
#pragma unroll
  for (int j = 0; j < kMaxNT; ++j) {
    const int up = ub + ln.pair_unit(j);
    const bool pa = j < NTA && ln.pair_unit(j) < U && up < D;
    b_ur[j][0] = pa ? dir.bias[up] : 0.f;
    b_ur[j][1] = pa ? dir.bias[D + up] : 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int uc = ub + ln.unit(j, e);
      b_c[j][e] = j < NTB && ln.unit(j, e) < U && uc < D
                      ? dir.bias[2 * D + uc] : 0.f;
    }
  }
  bf16* rh_buf = rh_scr + (size_t)rev * B * D;
  float* u_buf = u_scr + (size_t)rev * B * D;
  gru::cg::grid_group grid = gru::cg::this_grid();
  const size_t TD = (size_t)T * D, TE = (size_t)T * E;

  for (int s = 0; s < T; ++s) {
    const int t = rev ? T - 1 - s : s;
    const int tp = rev ? t + 1 : t - 1;
    // (A) the projection's update and reset columns, u, r, r h_{t-1}
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      float ax[kMaxNT][4], ah[kMaxNT][4];
      product<S>(x + b0 * TE + (size_t)t * E, TE, rows, E, wx_s, LDE, NTA,
                 a_s, sums, ax);
      const bf16* a = s == 0 ? dir.h0 + (size_t)b0 * D
                             : dir.hs + b0 * TD + (size_t)tp * D;
      product<S>(a, s == 0 ? D : TD, rows, D, wh_s, LDK, NTA, a_s, sums, ah);
      if (!ln.first) continue;
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) {
        const int uu = ln.pair_unit(j), u = ub + uu;
        if (j >= NTA || uu >= U || u >= D) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = ln.r0 + 8 * h;
          if (r >= rows) continue;
          const int b = b0 + r;
          const size_t bo = (size_t)b * D + u;
          const float hp = s == 0
              ? ldcg_bf(dir.h0 + bo)
              : ldcg_bf(dir.hs + b * TD + (size_t)tp * D + u);
          float ug, rg;
          gru::update_reset(ax[j][2 * h] + b_ur[j][0],
                            ax[j][2 * h + 1] + b_ur[j][1], ah[j][2 * h],
                            ah[j][2 * h + 1], ug, rg);
          rh_buf[bo] = f2b(rg * hp);
          u_buf[bo] = ug;
        }
      }
    }
    grid.sync();
    // (B) the projection's candidate column, the candidate, the new h
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      float ax[kMaxNT][4], ac[kMaxNT][4];
      product<S>(x + b0 * TE + (size_t)t * E, TE, rows, E, wxc_s, LDE, NTB,
                 a_s, sums, ax);
      product<S>(rh_buf + (size_t)b0 * D, D, rows, D, whc_s, LDK, NTB, a_s,
                 sums, ac);
      if (!ln.first) continue;
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) {
        if (j >= NTB) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int uu = ln.unit(j, e), u = ub + uu, r = ln.row(e);
          if (uu >= U || u >= D || r >= rows) continue;
          const int b = b0 + r;
          const size_t bo = (size_t)b * D + u;
          const float hp = s == 0
              ? ldcg_bf(dir.h0 + bo)
              : ldcg_bf(dir.hs + b * TD + (size_t)tp * D + u);
          const float c = gru::candidate(ax[j][e] + b_c[j][e & 1], ac[j][e]);
          const float ug = __ldcg(u_buf + bo);
          const float m = mask[(size_t)b * T + t];
          const float hn = m * (ug * hp + (1.f - ug) * c) + (1.f - m) * hp;
          dir.hs[b * TD + (size_t)t * D + u] = f2b(hn);
          if (s == T - 1) dir.hT[bo] = hn;
        }
      }
    }
    grid.sync();
  }
}

inline size_t bi_weights(int E, int D, int U) {
  return 2 * (size_t)(slice_elems(2 * U, E) + slice_elems(U, E) +
                      slice_elems(2 * U, D) + slice_elems(U, D));
}

}  // namespace gru_bf16

// The bf16 form: per direction the pairs and units slices of W_x (K = E),
// bias [3D] f32, the pairs slices of W_h and the units slices of W_hc (K =
// D), all bf16 packed [blocks][8 ceil(n / 8)][ld(K)] (gru_bf16.cuh), h0
// [B, D] bf16; outputs hs [B, T, D] bf16 and hT [B, D] f32.  x [B, T, E]
// bf16, mask [B, T] f32; the grid is 2 ceil(D / U) blocks of 256 threads.
// rh_scr [2][B][D] bf16 and u_scr [2][B][D] f32: scratch.  E, D multiples
// of 8.
extern "C" int bigru_fwd_bf16(
    const void* x, const float* mask,
    const void* wxp_f, const void* wxcp_f, const float* b_f,
    const void* whp_f, const void* whcp_f, const void* h0_f, void* hs_f,
    float* hT_f,
    const void* wxp_b, const void* wxcp_b, const float* b_b,
    const void* whp_b, const void* whcp_b, const void* h0_b, void* hs_b,
    float* hT_b,
    void* rh_scr, float* u_scr, int B, int T, int E, int D, int U,
    void* stream) {
  namespace gb = gru_bf16;
  using gb::bf16;
  if (!gb::valid_bf16(B, T, D, U) || E <= 0 || E % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t w = gb::bi_weights(E, D, U);
  const int nt = gb::tiles(2 * U);
  const int stages = gb::stages_for(w, nt);
  if (stages == 0) return (int)cudaErrorInvalidValue;
  const int grid = 2 * ((D + U - 1) / U);
  const size_t smem = w + gb::region_bytes(stages, nt);
  using B16 = const bf16*;
  gb::Dir fwd{B16(wxp_f), B16(wxcp_f), b_f, B16(whp_f), B16(whcp_f),
              B16(h0_f), static_cast<bf16*>(hs_f), hT_f};
  gb::Dir bwd{B16(wxp_b), B16(wxcp_b), b_b, B16(whp_b), B16(whcp_b),
              B16(h0_b), static_cast<bf16*>(hs_b), hT_b};
  B16 xs = static_cast<B16>(x);
  bf16* rh = static_cast<bf16*>(rh_scr);
  void* args[] = {&xs, &mask, &fwd, &bwd, &rh, &u_scr, &B, &T, &E, &D, &U};
  cudaStream_t st = (cudaStream_t)stream;
  return stages == 3
      ? gru::cooperative(gb::bigru_fwd_bf16_kernel<3>, grid, gb::kThreads,
                         smem, args, st)
      : gru::cooperative(gb::bigru_fwd_bf16_kernel<2>, grid, gb::kThreads,
                         smem, args, st);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Fused GRU over a whole sequence: the forward (over xw, or over raw x
// with the input projection inside the loop, one template flag) and the
// backward (stored gates or remat, one template flag), each one
// persistent cooperative launch that walks every time step.
//
// Replaces paddle_tpu/ops/pallas/gru.py::gru_seq (the Pallas _fwd_kernel,
// _bwd_kernel and _bwd_remat_kernel: grid (batch blocks, T) run in order
// on one core, W_h and W_hc resident in VMEM, the h carry in VMEM
// scratch) and gru.py::gru_seq_fi (_fwd_fi_kernel: the same grid with
// W_x resident too, so the [T, B, 3D] gate-input slab never reaches HBM);
// f32 and bf16 forms of each.
//
// Layout (batch-major, as the JAX entry takes it): xw [B, T, 3D] with
// gate order [u, r, c]; mask [B, T] f32 (1 while t < length; rows freeze
// afterwards); W_h [D, 2D] ([u, r] columns); W_hc [D, D]; h0 [B, D]; hs
// [B, T, D].  ``reverse`` runs the same recurrence over indices T-1..0
// (no flipped copies).  D % 4 == 0 (16-byte copies).  The cell is
// Paddle's: u, r = sigmoid(xw[:2D] + h W_h), c = tanh(xw[2D:] + (r h)
// W_hc), h' = u h + (1 - u) c — the reset gate acts before the product,
// unlike cuDNN's GRU.
//
// What bounds it on an H100: operations, and the step-to-step
// dependency.  Each step is [B, D] x [D, 2D] then [B, D] x [D, D] (at B
// 64, D 512: 101 MFLOP, 3.2 GFLOP over 32 steps), and the candidate
// product needs the whole r * h_{t-1}, which exists only once every unit
// has its reset gate.  At D 512, f32 W_h and W_hc are 3 MB: they fit no
// SM, so the TPU design (the weights whole in VMEM) does not carry over.
// Instead each of ~128 blocks (one per SM) owns U hidden units and keeps
// the 3U weight columns of its units in shared memory for the whole
// sequence (packed by the wrapper, gru_common.cuh's tiling).  A step of
// the forward has two grid-wide barriers: after the update/reset gates
// (each block has written its units' r * h_{t-1}), and after the new h.
//
// Backward, reverse time, from row slices of the weights: block j keeps
// W_h[own k, :] and W_hc[own k, :] (the wrapper packs W_h^T and W_hc^T
// as columns).  Per step: (a) per own unit the gate cotangents du and
// dc (pre-activation) from dh = carry + dhs[t], written to dxw and to an
// exchange buffer; barrier; (b) drh = dc @ W_hc^T for the own units (a
// product over all units' dc), then dr; barrier; (c) dh_{t-1} = dh u m +
// drh r + [du, dr] @ W_h^T for the own units, plus the frozen rows'
// pass-through.  The exchange buffers alternate by step parity, so (a) of
// the next step needs no barrier.  No atomics and no partial sums across
// blocks: every value is summed in one fixed order by one thread, so
// reruns are bit-identical.  Remat recomputes the u/r/c slab in two
// passes over all steps before the loop (they do not depend on the
// backward recurrence): u, r and r * h_{t-1} from the shifted h stack,
// barrier, then c — with the forward's gemm and gate code, so the
// recomputed gates equal the forward's in bits and remat on and off give
// the same result.  Both forms write r * h_{t-1} [B, T, D]; dW_h and dW_hc
// are large products outside, as in the JAX package.

#include "gru_bf16.cuh"
#include "gru_common.cuh"

namespace {

using namespace gru;

// kFi: `in` is raw x [B, T, E] and the block keeps its [E][U][3] column
// slice of W_x (wxp) beside W_h's and W_hc's; xc_buf carries the
// candidate's input x_t W_x[:, 2D:] + b from (A) to (B).  Otherwise `in`
// is xw [B, T, 3D] (E, wxp, bias and xc_buf unused).
template <bool kFi, int S>
__global__ void __launch_bounds__(kRows * kMaxUnits, 1)
gru_fwd_kernel(const float* __restrict__ in, const float* __restrict__ mask,
               const float* __restrict__ wxp, const float* __restrict__ bias,
               const float* __restrict__ whp, const float* __restrict__ whcp,
               const float* h0, float* hs, float* urc, float* hT,
               float* rh_buf, float* u_buf, float* xc_buf, int B, int T,
               int E, int D, int U, int reverse) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const size_t wx = kFi ? (size_t)E * U * 3 : 0;
  float* wx_s = smem;                            // [E][U][3] (kFi)
  float* wh_s = smem + wx;                       // [D][U][2]
  float* whc_s = wh_s + (size_t)D * U * 2;       // [D][U]
  float* a_s = whc_s + (size_t)D * U;
  const Lane ln(U);
  const int u = blockIdx.x * U + ln.uu;
  const bool live = u < D;
  if (kFi) load_slice(wx_s, wxp, wx, blockIdx.x);
  load_slice(wh_s, whp, (size_t)D * U * 2, blockIdx.x);
  load_slice(whc_s, whcp, (size_t)D * U, blockIdx.x);
  __syncthreads();
  float b_u = 0.f, b_r = 0.f, b_c = 0.f;
  if (kFi && live) {
    b_u = bias[u];
    b_r = bias[D + u];
    b_c = bias[2 * D + u];
  }
  cg::grid_group grid = cg::this_grid();
  const size_t TD = (size_t)T * D, TE = (size_t)T * E;

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;
    // (A) (the projection,) u, r and r * h_{t-1} of the own units
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      float xv[3], ur[2];
      if (kFi)
        gemm<3, S>(in + b0 * TE + (size_t)t * E, TE, rows, E, wx_s, U, ln,
                   a_s, xv);
      const float* a = s == 0 ? h0 + (size_t)b0 * D
                              : hs + b0 * TD + (size_t)tp * D;
      gemm<2, S>(a, s == 0 ? D : TD, rows, D, wh_s, U, ln, a_s, ur);
      if (!live || ln.row >= rows) continue;
      const int b = b0 + ln.row;
      const size_t bo = (size_t)b * D + u;
      if (kFi) {
        xv[0] += b_u;
        xv[1] += b_r;
        xc_buf[bo] = xv[2] + b_c;
      } else {
        const float* xr = in + (b * TD + (size_t)t * D) * 3;
        xv[0] = xr[u];
        xv[1] = xr[D + u];
      }
      const float hp = s == 0 ? __ldcg(h0 + bo)
                              : __ldcg(hs + b * TD + (size_t)tp * D + u);
      float ug, rg;
      update_reset(xv[0], xv[1], ur[0], ur[1], ug, rg);
      rh_buf[bo] = rg * hp;
      u_buf[bo] = ug;
      if (urc != nullptr) {
        float* g = urc + (b * TD + (size_t)t * D) * 3;
        g[u] = ug;
        g[D + u] = rg;
      }
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
      const float xc = kFi ? xc_buf[bo]
                           : in[(b * TD + (size_t)t * D) * 3 + 2 * D + u];
      const float hp = s == 0 ? __ldcg(h0 + bo)
                              : __ldcg(hs + b * TD + (size_t)tp * D + u);
      const float c = candidate(xc, ac[0]);
      const float ug = u_buf[bo];
      const float m = mask[(size_t)b * T + t];
      const float hn = m * (ug * hp + (1.f - ug) * c) + (1.f - m) * hp;
      hs[b * TD + (size_t)t * D + u] = hn;
      if (urc != nullptr) urc[(b * TD + (size_t)t * D) * 3 + 2 * D + u] = c;
      if (s == T - 1) hT[bo] = hn;
    }
    grid.sync();
  }
}

template <bool kRemat, int S>
__global__ void __launch_bounds__(kRows * kMaxUnits, 1)
gru_bwd_kernel(const float* __restrict__ xw, const float* __restrict__ urc_in,
               const float* __restrict__ mask,
               const float* __restrict__ whp, const float* __restrict__ whcp,
               const float* __restrict__ whtp,
               const float* __restrict__ whctp, const float* h0,
               const float* hs, const float* __restrict__ dhs,
               const float* __restrict__ dhT, float* dxw, float* dh,
               float* rh, float* gates, float* dpc_buf, float* dur_buf,
               float* drh_buf, int B, int T, int D, int U, int reverse) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* a_s = smem + (size_t)D * U * 3;
  const Lane ln(U);
  const int u = blockIdx.x * U + ln.uu;
  const bool live = u < D;
  cg::grid_group grid = cg::this_grid();
  const size_t TD = (size_t)T * D;
  const float* g_in = kRemat ? gates : urc_in;

  if (kRemat) {
    // the u/r/c slab, recomputed as the forward computed it
    float* wh_s = smem;                          // [D][U][2]
    float* whc_s = smem + (size_t)D * U * 2;     // [D][U]
    load_slice(wh_s, whp, (size_t)D * U * 2, blockIdx.x);
    load_slice(whc_s, whcp, (size_t)D * U, blockIdx.x);
    __syncthreads();
    for (int t = 0; t < T; ++t) {
      const bool first = reverse ? t == T - 1 : t == 0;
      const int tp = reverse ? t + 1 : t - 1;
      for (int b0 = 0; b0 < B; b0 += kRows) {
        const int rows = min(kRows, B - b0);
        const float* a = first ? h0 + (size_t)b0 * D
                               : hs + b0 * TD + (size_t)tp * D;
        float ur[2];
        gemm<2, S>(a, first ? D : TD, rows, D, wh_s, U, ln, a_s, ur);
        if (!live || ln.row >= rows) continue;
        const int b = b0 + ln.row;
        const size_t bt = b * TD + (size_t)t * D;
        const float hp = first ? h0[(size_t)b * D + u]
                               : hs[b * TD + (size_t)tp * D + u];
        float ug, rg;
        update_reset(xw[bt * 3 + u], xw[bt * 3 + D + u], ur[0], ur[1], ug,
                     rg);
        gates[bt * 3 + u] = ug;
        gates[bt * 3 + D + u] = rg;
        rh[bt + u] = rg * hp;
      }
    }
    grid.sync();
    for (int t = 0; t < T; ++t) {
      for (int b0 = 0; b0 < B; b0 += kRows) {
        const int rows = min(kRows, B - b0);
        float ac[1];
        gemm<1, S>(rh + b0 * TD + (size_t)t * D, TD, rows, D, whc_s, U, ln,
                   a_s, ac);
        if (!live || ln.row >= rows) continue;
        const size_t bt = (b0 + ln.row) * TD + (size_t)t * D;
        gates[bt * 3 + 2 * D + u] = candidate(xw[bt * 3 + 2 * D + u], ac[0]);
      }
    }
    __syncthreads();     // the column slices give way to the row slices
  }
  float* wht_s = smem;                           // [2D][U]: W_h[k, :]
  float* whct_s = smem + (size_t)D * U * 2;      // [D][U]: W_hc[k, :]
  load_slice(wht_s, whtp, (size_t)D * U * 2, blockIdx.x);
  load_slice(whct_s, whctp, (size_t)D * U, blockIdx.x);
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;   // computation order reversed
    const int tp = reverse ? t + 1 : t - 1;
    const bool first = reverse ? t == T - 1 : t == 0;
    float* dpc = dpc_buf + (size_t)(s & 1) * B * D;        // [B][D]
    float* dur = dur_buf + (size_t)(s & 1) * B * 2 * D;    // [B][2D]
    // (a) du and dc of the own units
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      if (!live || ln.row >= rows) continue;
      const int b = b0 + ln.row;
      const size_t bu = (size_t)b * D + u, bt = b * TD + (size_t)t * D;
      const float dhv = (s == 0 ? dhT[bu] : dh[bu]) + dhs[bt + u];
      const float m = mask[(size_t)b * T + t];
      const float ug = g_in[bt * 3 + u], c = g_in[bt * 3 + 2 * D + u];
      const float hp = first ? h0[bu] : hs[b * TD + (size_t)tp * D + u];
      const float du = dhv * (hp - c) * ug * (1.f - ug) * m;
      const float dc = dhv * (1.f - ug) * m * (1.f - c * c);
      dxw[bt * 3 + u] = du;
      dxw[bt * 3 + 2 * D + u] = dc;
      dpc[bu] = dc;
      dur[(size_t)b * 2 * D + u] = du;
      if (!kRemat) rh[bt + u] = g_in[bt * 3 + D + u] * hp;
    }
    grid.sync();
    // (b) drh = dc @ W_hc^T and dr of the own units
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      float drh[1];
      gemm<1, S>(dpc + (size_t)b0 * D, D, rows, D, whct_s, U, ln, a_s, drh);
      if (!live || ln.row >= rows) continue;
      const int b = b0 + ln.row;
      const size_t bu = (size_t)b * D + u, bt = b * TD + (size_t)t * D;
      const float rg = g_in[bt * 3 + D + u];
      const float hp = first ? h0[bu] : hs[b * TD + (size_t)tp * D + u];
      const float dr = drh[0] * hp * rg * (1.f - rg);
      dxw[bt * 3 + D + u] = dr;
      dur[(size_t)b * 2 * D + D + u] = dr;
      drh_buf[bu] = drh[0];
    }
    grid.sync();
    // (c) dh_{t-1} of the own units
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      float acc[1];
      gemm<1, S>(dur + (size_t)b0 * 2 * D, 2 * D, rows, 2 * D, wht_s, U, ln,
                 a_s, acc);
      if (!live || ln.row >= rows) continue;
      const int b = b0 + ln.row;
      const size_t bu = (size_t)b * D + u, bt = b * TD + (size_t)t * D;
      const float dhv = (s == 0 ? dhT[bu] : dh[bu]) + dhs[bt + u];
      const float m = mask[(size_t)b * T + t];
      const float ug = g_in[bt * 3 + u], rg = g_in[bt * 3 + D + u];
      const float prev = dhv * ug * m + drh_buf[bu] * rg + acc[0];
      dh[bu] = prev + (1.f - m) * dhv;
    }
  }
}

template <bool kFi>
int launch_fwd(const float* in, const float* mask, const float* wxp,
               const float* bias, const float* whp, const float* whcp,
               const float* h0, float* hs, float* urc, float* hT,
               float* rh_buf, float* u_buf, float* xc_buf, int B, int T,
               int E, int D, int U, int reverse, void* stream) {
  const size_t w = (size_t)(3 * E + 3 * D) * U;
  const int stages = stages_for(w, U);
  if (stages == 0) return (int)cudaErrorInvalidValue;
  const int grid = (D + U - 1) / U;
  const size_t smem = sizeof(float) * (w + scratch_floats(U, stages));
  void* args[] = {&in, &mask, &wxp, &bias, &whp, &whcp, &h0, &hs, &urc,
                  &hT, &rh_buf, &u_buf, &xc_buf, &B, &T, &E, &D, &U,
                  &reverse};
  cudaStream_t st = (cudaStream_t)stream;
  return stages == 3
      ? cooperative(gru_fwd_kernel<kFi, 3>, grid, kRows * U, smem, args, st)
      : cooperative(gru_fwd_kernel<kFi, 2>, grid, kRows * U, smem, args, st);
}

}  // namespace

// The grid: ceil(D / U) blocks of 64U threads; whp [blocks][D][U][2] and
// whcp [blocks][D][U] the column slices of W_h and W_hc.  rh_buf, u_buf:
// [B, D] scratch.  urc (may be null): the [B, T, 3D] gate slab.
extern "C" int gru_fwd_f32(const float* xw, const float* mask,
                           const float* whp, const float* whcp,
                           const float* h0, float* hs, float* urc, float* hT,
                           float* rh_buf, float* u_buf, int B, int T, int D,
                           int U, int reverse, void* stream) {
  if (!valid_shape(B, T, D, U)) return (int)cudaErrorInvalidValue;
  return launch_fwd<false>(xw, mask, nullptr, nullptr, whp, whcp, h0, hs,
                           urc, hT, rh_buf, u_buf, nullptr, B, T, 0, D, U,
                           reverse, stream);
}

// The fused-input forward: x [B, T, E] (E % 4 == 0), wxp [blocks][E][U][3]
// the column slices of W_x, bias [3D]; the rest as gru_fwd_f32.  scratch:
// [3][B][D] (r * h_{t-1}, u, the candidate's input).
extern "C" int gru_fi_fwd_f32(const float* x, const float* mask,
                              const float* wxp, const float* bias,
                              const float* whp, const float* whcp,
                              const float* h0, float* hs, float* urc,
                              float* hT, float* scratch, int B, int T, int E,
                              int D, int U, int reverse, void* stream) {
  if (!valid_shape(B, T, D, U) || E <= 0 || E % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t bd = (size_t)B * D;
  return launch_fwd<true>(x, mask, wxp, bias, whp, whcp, h0, hs, urc, hT,
                          scratch, scratch + bd, scratch + 2 * bd, B, T, E,
                          D, U, reverse, stream);
}

// remat != 0: the gates recomputed from xw and the shifted h stack into
// `gates` ([B, T, 3D] scratch; urc_in unused); remat == 0: urc_in is the
// forward's slab (xw and gates unused).  whtp [blocks][2D][U] and whctp
// [blocks][D][U] pack W_h^T and W_hc^T as columns (the row slices).
// Outputs dxw [B, T, 3D], dh [B, D] (dh0), rh [B, T, D] = r * h_{t-1};
// scratch dpc_buf [2][B][D], dur_buf [2][B][2D], drh_buf [B][D].
extern "C" int gru_bwd_f32(const float* xw, const float* urc_in,
                           const float* mask, const float* whp,
                           const float* whcp, const float* whtp,
                           const float* whctp, const float* h0,
                           const float* hs, const float* dhs,
                           const float* dhT, float* dxw, float* dh, float* rh,
                           float* gates, float* dpc_buf, float* dur_buf,
                           float* drh_buf, int B, int T, int D, int U,
                           int reverse, int remat, void* stream) {
  if (!valid_shape(B, T, D, U)) return (int)cudaErrorInvalidValue;
  const size_t w = (size_t)D * U * 3;
  const int stages = stages_for(w, U);
  if (stages == 0) return (int)cudaErrorInvalidValue;
  const int grid = (D + U - 1) / U;
  const size_t smem = sizeof(float) * (w + scratch_floats(U, stages));
  void* args[] = {&xw, &urc_in, &mask, &whp, &whcp, &whtp, &whctp, &h0,
                  &hs, &dhs, &dhT, &dxw, &dh, &rh, &gates, &dpc_buf,
                  &dur_buf, &drh_buf, &B, &T, &D, &U, &reverse};
  cudaStream_t st = (cudaStream_t)stream;
  const int n = kRows * U;
  if (remat)
    return stages == 3
        ? cooperative(gru_bwd_kernel<true, 3>, grid, n, smem, args, st)
        : cooperative(gru_bwd_kernel<true, 2>, grid, n, smem, args, st);
  return stages == 3
      ? cooperative(gru_bwd_kernel<false, 3>, grid, n, smem, args, st)
      : cooperative(gru_bwd_kernel<false, 2>, grid, n, smem, args, st);
}

// ---------------------------------------------------------------------------
// The bf16 forms: gru_fwd_bf16 and gru_bwd_bf16 (remat or stored gates, one
// template flag as in f32; xw in bf16 or f32, a template on its element
// type), with the rounding points of the JAX kernels on bf16 operands
// (gru.py:31-76, _fwd_call :165; _durc_bwd :79, _bwd_kernel :99,
// _bwd_remat_kernel :128, _gru_dxw_bwd :349).  Forward: u, r from xw +
// h_{t-1} W_h in f32, r h_{t-1} rounded to bf16 before the candidate
// product (it is also the exchanged operand: half the f32 exchange), the
// cell in f32, the h carry rounded to bf16 (hs is the carry the next step
// reads, so the freeze keeps the rounded value), hs and the u/r/c slab in
// bf16, h_T in f32 (unrounded).  Backward: the dh carry in f32; u, r, c
// from the bf16 slab, or recomputed by the forward's products and cell
// and rounded through bf16 (so remat on and off give the same bits); dc
// and [du, dr] rounded to bf16 for the W_hc^T and W_h^T products; dxw and
// dh0 out in f32; rh = bf16(bf16(r) h_{t-1}), dW_hc's operand.
//
// The same cooperative, persistent design as the f32 kernels, with the
// recurrent products on the tensor cores (gru_bf16.cuh).  Forward, a
// step: (A) u, r of the own units from the pairs slice of W_h, r h_{t-1}
// written; grid barrier; (B) c from the units slice of W_hc over every
// unit's r h_{t-1}, the new h; grid barrier.  At D 512 on 132 SMs, U 4:
// 128 blocks, W_h's 8 pair columns one n8 tile, W_hc's 4 half of one
// (zero-padded).  Backward, a step, from the row slices W_h[own, :] and
// W_hc[own, :]: (a) du, dc of the own units; barrier; (b) drh = dc W_hc^T,
// dr; barrier; (c) dh_{t-1} = dh u m + drh r + [du, dr] W_h^T.  The
// exchange buffers (dc, [du, dr], bf16) alternate by step parity.  Remat
// recomputes the slab in two passes before the loop (u, r and the
// forward's r h_{t-1}; barrier; c).  No atomics: every value is summed in
// one fixed order, so reruns give the same bits.
//
// What bounds them on an H100: the step-to-step chain.  A step's products
// at B 64, D 512 are 101 MFLOP (0.1 us at 989 TFLOP/s), but each block
// stages all of h_{t-1} (64 KB) through L2 in each phase and the grid
// meets at two barriers a step (three in the backward).
//
// The fused-input form, gru_fi_fwd_bf16 (gru.py::gru_seq_fi's
// _fwd_fi_kernel with bf16 operands): the forward above, one template
// flag, and the one-direction form of bigru_fwd_bf16's block: W_x's pairs
// and units slices in shared memory beside W_h's and W_hc's (at E = D =
// 512, U 4: 33,280 bytes), x_t staged through the ring in each phase, x_t
// W_x + b kept in f32 and never rounded (gru.py:418-420), added to h W_h
// in (A) and to (r h) W_hc in (B).  The backward is gru_bwd_bf16 with
// remat over the f32 projection of one torch.matmul, as the BiGRU's.  At
// B 64, T 32, E = D = 512 a step's products are 201 MFLOP.

namespace gru_bf16 {

// kFi (gru_fi_fwd_bf16): `in` is raw x [B, T, E] and the block keeps the
// pairs and units slices of W_x (wxp, wxcp; K = E) before W_h's and
// W_hc's, as bigru_fwd_bf16's block of one direction does (bigru_seq.cu):
// each phase takes its columns of x_t W_x with f32 sums plus the f32 bias,
// kept in f32 and never rounded (gru.py:418-420), then adds h_{t-1} W_h
// or (r h) W_hc.  Otherwise `in` is xw [B, T, 3D] bf16 (E, wxp, wxcp and
// bias unused).
template <bool kFi, int S>
__global__ void __launch_bounds__(kThreads, 1)
gru_fwd_bf16_kernel(const bf16* __restrict__ in,
                    const float* __restrict__ mask,
                    const bf16* __restrict__ wxp,
                    const bf16* __restrict__ wxcp,
                    const float* __restrict__ bias,
                    const bf16* __restrict__ whp,
                    const bf16* __restrict__ whcp, const bf16* h0, bf16* hs,
                    bf16* urc, float* hT, bf16* rh_buf, float* u_buf, int B,
                    int T, int E, int D, int U, int reverse) {
  extern __shared__ float4 smem4[];
  const int LDK = ld_k(D), LDE = kFi ? ld_k(E) : 0;
  const int NTA = tiles(2 * U), NTB = tiles(U);
  const size_t nxa = kFi ? slice_elems(2 * U, E) : 0;
  const size_t nxb = kFi ? slice_elems(U, E) : 0;
  const size_t na = slice_elems(2 * U, D), nb = slice_elems(U, D);
  bf16* wx_s = reinterpret_cast<bf16*>(smem4);            // kFi
  bf16* wxc_s = wx_s + nxa;
  bf16* wh_s = wxc_s + nxb;
  bf16* whc_s = wh_s + na;
  bf16* a_s = whc_s + nb;
  float* sums = reinterpret_cast<float*>(a_s);
  if (kFi) {
    load_slice(wx_s, wxp, nxa, blockIdx.x);
    load_slice(wxc_s, wxcp, nxb, blockIdx.x);
  }
  load_slice(wh_s, whp, na, blockIdx.x);
  load_slice(whc_s, whcp, nb, blockIdx.x);
  __syncthreads();
  const Lane ln;
  const int ub = blockIdx.x * U;
  // kFi: this lane's biases, the update and reset ones of its pair units,
  // the candidate's of its units
  float b_ur[kMaxNT][2], b_c[kMaxNT][2];
#pragma unroll
  for (int j = 0; j < kMaxNT; ++j) {
    const int up = ub + ln.pair_unit(j);
    const bool pa = kFi && j < NTA && ln.pair_unit(j) < U && up < D;
    b_ur[j][0] = pa ? bias[up] : 0.f;
    b_ur[j][1] = pa ? bias[D + up] : 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int uc = ub + ln.unit(j, e);
      b_c[j][e] = kFi && j < NTB && ln.unit(j, e) < U && uc < D
                      ? bias[2 * D + uc] : 0.f;
    }
  }
  gru::cg::grid_group grid = gru::cg::this_grid();
  const size_t TD = (size_t)T * D, TE = (size_t)T * E;

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;
    // (A) u, r and r h_{t-1} of the own units
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      float ax[kMaxNT][4];
      if (kFi)
        product<S>(in + b0 * TE + (size_t)t * E, TE, rows, E, wx_s, LDE,
                   NTA, a_s, sums, ax);
      const bf16* a = s == 0 ? h0 + (size_t)b0 * D
                             : hs + b0 * TD + (size_t)tp * D;
      float acc[kMaxNT][4];
      product<S>(a, s == 0 ? D : TD, rows, D, wh_s, LDK, NTA, a_s, sums, acc);
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
          const size_t bo = (size_t)b * D + u, bt = b * TD + (size_t)t * D;
          const float hp = s == 0 ? ldcg_bf(h0 + bo)
                                  : ldcg_bf(hs + b * TD + (size_t)tp * D + u);
          float ug, rg;
          if (kFi)
            gru::update_reset(ax[j][2 * h] + b_ur[j][0],
                              ax[j][2 * h + 1] + b_ur[j][1], acc[j][2 * h],
                              acc[j][2 * h + 1], ug, rg);
          else
            gru::update_reset(b2f(in[bt * 3 + u]), b2f(in[bt * 3 + D + u]),
                              acc[j][2 * h], acc[j][2 * h + 1], ug, rg);
          rh_buf[bo] = f2b(rg * hp);
          u_buf[bo] = ug;
          if (urc != nullptr) {
            urc[bt * 3 + u] = f2b(ug);
            urc[bt * 3 + D + u] = f2b(rg);
          }
        }
      }
    }
    grid.sync();
    // (B) the candidate and the new h of the own units
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      float ax[kMaxNT][4];
      if (kFi)
        product<S>(in + b0 * TE + (size_t)t * E, TE, rows, E, wxc_s, LDE,
                   NTB, a_s, sums, ax);
      float acc[kMaxNT][4];
      product<S>(rh_buf + (size_t)b0 * D, D, rows, D, whc_s, LDK, NTB, a_s,
                 sums, acc);
      if (!ln.first) continue;
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) {
        if (j >= NTB) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int uu = ln.unit(j, e), u = ub + uu, r = ln.row(e);
          if (uu >= U || u >= D || r >= rows) continue;
          const int b = b0 + r;
          const size_t bo = (size_t)b * D + u, bt = b * TD + (size_t)t * D;
          const float hp = s == 0 ? ldcg_bf(h0 + bo)
                                  : ldcg_bf(hs + b * TD + (size_t)tp * D + u);
          const float c = gru::candidate(
              kFi ? ax[j][e] + b_c[j][e & 1] : b2f(in[bt * 3 + 2 * D + u]),
              acc[j][e]);
          const float ug = __ldcg(u_buf + bo);
          const float m = mask[(size_t)b * T + t];
          const float hn = m * (ug * hp + (1.f - ug) * c) + (1.f - m) * hp;
          hs[bt + u] = f2b(hn);
          if (urc != nullptr) urc[bt * 3 + 2 * D + u] = f2b(c);
          if (s == T - 1) hT[bo] = hn;
        }
      }
    }
    grid.sync();
  }
}

template <bool kRemat, typename XT, int S>
__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_bf16_kernel(const XT* __restrict__ xw,
                    const bf16* __restrict__ urc_in,
                    const float* __restrict__ mask,
                    const bf16* __restrict__ whp,
                    const bf16* __restrict__ whcp,
                    const bf16* __restrict__ whrp,
                    const bf16* __restrict__ whcrp, const bf16* h0,
                    const bf16* hs, const bf16* __restrict__ dhs,
                    const float* __restrict__ dhT, float* dxw, float* dh,
                    bf16* rh, bf16* gates, bf16* rh_f, bf16* dpc_buf,
                    bf16* dur_buf, float* drh_buf, int B, int T, int D,
                    int U, int reverse) {
  extern __shared__ float4 smem4[];
  const int LDK = ld_k(D), LDK2 = ld_k(2 * D);
  const int NTA = tiles(2 * U), NTB = tiles(U);
  const size_t na = slice_elems(2 * U, D), nb = slice_elems(U, D);
  const size_t nr = slice_elems(U, 2 * D);
  const size_t cols = kRemat ? na + nb : 0, rows_w = nr + nb;
  bf16* w_s = reinterpret_cast<bf16*>(smem4);
  bf16* a_s = w_s + (cols > rows_w ? cols : rows_w);
  float* sums = reinterpret_cast<float*>(a_s);
  const Lane ln;
  const int ub = blockIdx.x * U;
  gru::cg::grid_group grid = gru::cg::this_grid();
  const size_t TD = (size_t)T * D;
  const bf16* g_in = kRemat ? gates : urc_in;

  if (kRemat) {
    // the u/r/c slab, recomputed as the forward computed it: (1) u, r and
    // the forward's r h_{t-1} of every step; barrier; (2) c
    bf16* wh_s = w_s;                     // pairs slice of W_h
    bf16* whc_s = w_s + na;               // units slice of W_hc
    load_slice(wh_s, whp, na, blockIdx.x);
    load_slice(whc_s, whcp, nb, blockIdx.x);
    __syncthreads();
    for (int t = 0; t < T; ++t) {
      const bool first = reverse ? t == T - 1 : t == 0;
      const int tp = reverse ? t + 1 : t - 1;
      for (int b0 = 0; b0 < B; b0 += kRows) {
        const int rows = min(kRows, B - b0);
        const bf16* a = first ? h0 + (size_t)b0 * D
                              : hs + b0 * TD + (size_t)tp * D;
        float acc[kMaxNT][4];
        product<S>(a, first ? D : TD, rows, D, wh_s, LDK, NTA, a_s, sums,
                   acc);
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
            const size_t bt = b * TD + (size_t)t * D;
            const float hp = first ? b2f(h0[(size_t)b * D + u])
                                   : b2f(hs[b * TD + (size_t)tp * D + u]);
            float ug, rg;
            gru::update_reset(to_f(xw[bt * 3 + u]), to_f(xw[bt * 3 + D + u]),
                              acc[j][2 * h], acc[j][2 * h + 1], ug, rg);
            gates[bt * 3 + u] = f2b(ug);
            gates[bt * 3 + D + u] = f2b(rg);
            rh_f[bt + u] = f2b(rg * hp);
          }
        }
      }
    }
    grid.sync();
    for (int t = 0; t < T; ++t) {
      for (int b0 = 0; b0 < B; b0 += kRows) {
        const int rows = min(kRows, B - b0);
        float acc[kMaxNT][4];
        product<S>(rh_f + b0 * TD + (size_t)t * D, TD, rows, D, whc_s, LDK,
                   NTB, a_s, sums, acc);
        if (!ln.first) continue;
#pragma unroll
        for (int j = 0; j < kMaxNT; ++j) {
          if (j >= NTB) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int uu = ln.unit(j, e), u = ub + uu, r = ln.row(e);
            if (uu >= U || u >= D || r >= rows) continue;
            const size_t bt = (b0 + r) * TD + (size_t)t * D;
            gates[bt * 3 + 2 * D + u] = f2b(
                gru::candidate(to_f(xw[bt * 3 + 2 * D + u]), acc[j][e]));
          }
        }
      }
    }
    __syncthreads();     // the column slices give way to the row slices
  }
  bf16* whr_s = w_s;                      // W_h[own, :]  [8 NTB][LDK2]
  bf16* whcr_s = w_s + nr;                // W_hc[own, :] [8 NTB][LDK]
  load_slice(whr_s, whrp, nr, blockIdx.x);
  load_slice(whcr_s, whcrp, nb, blockIdx.x);
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;   // computation order reversed
    const int tp = reverse ? t + 1 : t - 1;
    const bool first = reverse ? t == T - 1 : t == 0;
    bf16* dpc = dpc_buf + (size_t)(s & 1) * B * D;          // [B][D]
    bf16* dur = dur_buf + (size_t)(s & 1) * B * 2 * D;      // [B][2D]
    // (a) du and dc of the own units (the cells of a units slice)
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      if (!ln.first) continue;
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) {
        if (j >= NTB) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int uu = ln.unit(j, e), u = ub + uu, r = ln.row(e);
          if (uu >= U || u >= D || r >= rows) continue;
          const int b = b0 + r;
          const size_t bu = (size_t)b * D + u, bt = b * TD + (size_t)t * D;
          const float dhv = (s == 0 ? dhT[bu] : dh[bu]) + b2f(dhs[bt + u]);
          const float m = mask[(size_t)b * T + t];
          const float ug = b2f(g_in[bt * 3 + u]);
          const float rg = b2f(g_in[bt * 3 + D + u]);
          const float c = b2f(g_in[bt * 3 + 2 * D + u]);
          const float hp = first ? b2f(h0[bu])
                                 : b2f(hs[b * TD + (size_t)tp * D + u]);
          const float du = dhv * (hp - c) * ug * (1.f - ug) * m;
          const float dc = dhv * (1.f - ug) * m * (1.f - c * c);
          dxw[bt * 3 + u] = du;
          dxw[bt * 3 + 2 * D + u] = dc;
          dpc[bu] = f2b(dc);
          dur[(size_t)b * 2 * D + u] = f2b(du);
          rh[bt + u] = f2b(rg * hp);
        }
      }
    }
    grid.sync();
    // (b) drh = dc W_hc^T and dr of the own units
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      float acc[kMaxNT][4];
      product<S>(dpc + (size_t)b0 * D, D, rows, D, whcr_s, LDK, NTB, a_s,
                 sums, acc);
      if (!ln.first) continue;
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) {
        if (j >= NTB) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int uu = ln.unit(j, e), u = ub + uu, r = ln.row(e);
          if (uu >= U || u >= D || r >= rows) continue;
          const int b = b0 + r;
          const size_t bu = (size_t)b * D + u, bt = b * TD + (size_t)t * D;
          const float rg = b2f(g_in[bt * 3 + D + u]);
          const float hp = first ? b2f(h0[bu])
                                 : b2f(hs[b * TD + (size_t)tp * D + u]);
          const float dr = acc[j][e] * hp * rg * (1.f - rg);
          dxw[bt * 3 + D + u] = dr;
          dur[(size_t)b * 2 * D + D + u] = f2b(dr);
          drh_buf[bu] = acc[j][e];
        }
      }
    }
    grid.sync();
    // (c) dh_{t-1} of the own units
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      float acc[kMaxNT][4];
      product<S>(dur + (size_t)b0 * 2 * D, 2 * D, rows, 2 * D, whr_s, LDK2,
                 NTB, a_s, sums, acc);
      if (!ln.first) continue;
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) {
        if (j >= NTB) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int uu = ln.unit(j, e), u = ub + uu, r = ln.row(e);
          if (uu >= U || u >= D || r >= rows) continue;
          const int b = b0 + r;
          const size_t bu = (size_t)b * D + u, bt = b * TD + (size_t)t * D;
          const float dhv = (s == 0 ? dhT[bu] : dh[bu]) + b2f(dhs[bt + u]);
          const float m = mask[(size_t)b * T + t];
          const float ug = b2f(g_in[bt * 3 + u]);
          const float rg = b2f(g_in[bt * 3 + D + u]);
          const float prev = dhv * ug * m + drh_buf[bu] * rg + acc[j][e];
          dh[bu] = prev + (1.f - m) * dhv;
        }
      }
    }
  }
}

// bytes of shared memory of the forward (the fused-input form: W_x's
// slices too) and of the backward
inline size_t fwd_weights(int D, int U, int E = 0) {
  const size_t wx = E > 0 ? slice_elems(2 * U, E) + slice_elems(U, E) : 0;
  return 2 * (wx + slice_elems(2 * U, D) + slice_elems(U, D));
}

template <bool kFi>
int launch_fwd_bf16(const void* in, const float* mask, const void* wxp,
               const void* wxcp, const float* bias, const void* whp,
               const void* whcp, const void* h0, void* hs, void* urc,
               float* hT, void* rh_buf, float* u_buf, int B, int T, int E,
               int D, int U, int reverse, void* stream) {
  const size_t w = fwd_weights(D, U, kFi ? E : 0);
  const int stages = stages_for(w, tiles(2 * U));
  if (stages == 0) return (int)cudaErrorInvalidValue;
  const int grid = (D + U - 1) / U;
  const size_t smem = w + region_bytes(stages, tiles(2 * U));
  const bf16* x = static_cast<const bf16*>(in);
  const bf16* wx = static_cast<const bf16*>(wxp);
  const bf16* wxc = static_cast<const bf16*>(wxcp);
  const bf16* wh = static_cast<const bf16*>(whp);
  const bf16* whc = static_cast<const bf16*>(whcp);
  const bf16* h = static_cast<const bf16*>(h0);
  bf16* o = static_cast<bf16*>(hs);
  bf16* g = static_cast<bf16*>(urc);
  bf16* rb = static_cast<bf16*>(rh_buf);
  void* args[] = {&x, &mask, &wx, &wxc, &bias, &wh, &whc, &h, &o, &g, &hT,
                  &rb, &u_buf, &B, &T, &E, &D, &U, &reverse};
  cudaStream_t st = (cudaStream_t)stream;
  return stages == 3
      ? gru::cooperative(gru_fwd_bf16_kernel<kFi, 3>, grid, kThreads, smem,
                         args, st)
      : gru::cooperative(gru_fwd_bf16_kernel<kFi, 2>, grid, kThreads, smem,
                         args, st);
}
inline size_t bwd_weights(int D, int U, bool remat) {
  const size_t cols = remat ? fwd_weights(D, U) : 0;
  const size_t rows = 2 * (size_t)(slice_elems(U, 2 * D) + slice_elems(U, D));
  return cols > rows ? cols : rows;
}

template <bool kRemat, typename XT>
int launch_bwd(int stages, int grid, size_t smem, void** args,
               cudaStream_t st) {
  return stages == 3
      ? gru::cooperative(gru_bwd_bf16_kernel<kRemat, XT, 3>, grid, kThreads,
                         smem, args, st)
      : gru::cooperative(gru_bwd_bf16_kernel<kRemat, XT, 2>, grid, kThreads,
                         smem, args, st);
}

}  // namespace gru_bf16

// The bf16 forward: xw [B, T, 3D], h0 [B, D] bf16; whp [blocks][8
// ceil(2U / 8)][ld(D)] and whcp [blocks][8 ceil(U / 8)][ld(D)] the pairs
// slices of W_h and the units slices of W_hc (gru_bf16.cuh), bf16; mask
// [B, T] f32.  Outputs hs bf16, urc (nullptr: none) bf16 [B, T, 3D], hT
// f32.  rh_buf [B, D] bf16 and u_buf [B, D] f32: scratch.  D % 8 == 0.
extern "C" int gru_fwd_bf16(const void* xw, const float* mask,
                            const void* whp, const void* whcp, const void* h0,
                            void* hs, void* urc, float* hT, void* rh_buf,
                            float* u_buf, int B, int T, int D, int U,
                            int reverse, void* stream) {
  namespace gb = gru_bf16;
  if (!gb::valid_bf16(B, T, D, U)) return (int)cudaErrorInvalidValue;
  return gb::launch_fwd_bf16<false>(xw, mask, nullptr, nullptr, nullptr, whp,
                                    whcp, h0, hs, urc, hT, rh_buf, u_buf, B,
                                    T, 0, D, U, reverse, stream);
}

// The bf16 fused-input forward: x [B, T, E] bf16 (E % 8 == 0, 16-byte
// aligned); wxp [blocks][8 ceil(2U / 8)][ld(E)] and wxcp [blocks][8 ceil(U
// / 8)][ld(E)] the pairs slices of W_x's update and reset columns and the
// units slices of its candidate column, bf16; bias [3D] f32; the rest as
// gru_fwd_bf16.
extern "C" int gru_fi_fwd_bf16(const void* x, const float* mask,
                               const void* wxp, const void* wxcp,
                               const float* bias, const void* whp,
                               const void* whcp, const void* h0, void* hs,
                               void* urc, float* hT, void* rh_buf,
                               float* u_buf, int B, int T, int E, int D,
                               int U, int reverse, void* stream) {
  namespace gb = gru_bf16;
  if (!gb::valid_bf16(B, T, D, U) || E <= 0 || E % 8 != 0)
    return (int)cudaErrorInvalidValue;
  return gb::launch_fwd_bf16<true>(x, mask, wxp, wxcp, bias, whp, whcp, h0,
                                   hs, urc, hT, rh_buf, u_buf, B, T, E, D, U,
                                   reverse, stream);
}

// The bf16 backward: remat != 0 recomputes the gates from xw (bf16, or
// f32 when xw_f32 != 0) and the shifted h stack into `gates` [B, T, 3D]
// and `rh_f` [B, T, D] (bf16 scratch; whp, whcp the forward's slices);
// remat == 0 reads the forward's bf16 slab urc_in (xw, gates, rh_f, whp
// and whcp unused).  whrp [blocks][8 ceil(U / 8)][ld(2D)] and whcrp
// [blocks][8 ceil(U / 8)][ld(D)] the units slices of W_h^T and W_hc^T (the
// rows the block's units own).  h0, hs, dhs bf16; mask, dhT f32.  Outputs
// dxw [B, T, 3D] f32, dh [B, D] f32 (dh0), rh [B, T, D] bf16; scratch
// dpc_buf [2][B][D] and dur_buf [2][B][2D] bf16, drh_buf [B][D] f32.
extern "C" int gru_bwd_bf16(const void* xw, const void* urc_in,
                            const float* mask, const void* whp,
                            const void* whcp, const void* whrp,
                            const void* whcrp, const void* h0, const void* hs,
                            const void* dhs, const float* dhT, float* dxw,
                            float* dh, void* rh, void* gates, void* rh_f,
                            void* dpc_buf, void* dur_buf, float* drh_buf,
                            int B, int T, int D, int U, int reverse,
                            int remat, int xw_f32, void* stream) {
  namespace gb = gru_bf16;
  using gb::bf16;
  if (!gb::valid_bf16(B, T, D, U)) return (int)cudaErrorInvalidValue;
  const int nt = remat ? gb::tiles(2 * U) : gb::tiles(U);
  const size_t w = gb::bwd_weights(D, U, remat != 0);
  const int stages = gb::stages_for(w, nt);
  if (stages == 0) return (int)cudaErrorInvalidValue;
  const int grid = (D + U - 1) / U;
  const size_t smem = w + gb::region_bytes(stages, nt);
  const bf16* u_in = static_cast<const bf16*>(urc_in);
  const bf16* wh = static_cast<const bf16*>(whp);
  const bf16* whc = static_cast<const bf16*>(whcp);
  const bf16* whr = static_cast<const bf16*>(whrp);
  const bf16* whcr = static_cast<const bf16*>(whcrp);
  const bf16* h = static_cast<const bf16*>(h0);
  const bf16* y = static_cast<const bf16*>(hs);
  const bf16* dy = static_cast<const bf16*>(dhs);
  bf16* rho = static_cast<bf16*>(rh);
  bf16* g = static_cast<bf16*>(gates);
  bf16* rf = static_cast<bf16*>(rh_f);
  bf16* dp = static_cast<bf16*>(dpc_buf);
  bf16* du = static_cast<bf16*>(dur_buf);
  cudaStream_t st = (cudaStream_t)stream;
  if (remat && xw_f32) {
    const float* x = static_cast<const float*>(xw);
    void* args[] = {&x, &u_in, &mask, &wh, &whc, &whr, &whcr, &h, &y, &dy,
                    &dhT, &dxw, &dh, &rho, &g, &rf, &dp, &du, &drh_buf,
                    &B, &T, &D, &U, &reverse};
    return gb::launch_bwd<true, float>(stages, grid, smem, args, st);
  }
  const bf16* x = static_cast<const bf16*>(xw);
  void* args[] = {&x, &u_in, &mask, &wh, &whc, &whr, &whcr, &h, &y, &dy,
                  &dhT, &dxw, &dh, &rho, &g, &rf, &dp, &du, &drh_buf,
                  &B, &T, &D, &U, &reverse};
  return remat ? gb::launch_bwd<true, bf16>(stages, grid, smem, args, st)
               : gb::launch_bwd<false, bf16>(stages, grid, smem, args, st);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

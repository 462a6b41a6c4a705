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

#include <cuda_runtime.h>

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

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

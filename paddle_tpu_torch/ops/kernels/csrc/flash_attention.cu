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

#include <cuda_runtime.h>

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

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

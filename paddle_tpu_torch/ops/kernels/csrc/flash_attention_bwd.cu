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

#include <cuda_runtime.h>

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

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Batch-reduce GEMM: y[M, N] = sum_g a[g] . b[g] with an f32 accumulator
// and a fused epilogue (affine, relu, per-column sum/sumsq of the
// pre-epilogue accumulator), on the shared tile of gemm_f32.cuh.
//
// Replaces paddle_tpu/ops/pallas/tpp/brgemm.py::brgemm (the pallas_call of
// _kernel_impl: grid (N tiles, M tiles, G) with the G axis run in order on
// a VMEM accumulator, and the stats block resident across the M axis).
// Here the G axis folds into the reduction: b [G, K, N] is one row-major
// [G*K, N] matrix, and A(m, g*K + k) = a[g][row m][k].  The stats are
// per-row-tile partials reduced in a fixed order (gemm::stats_reduce), not
// a carried VMEM block: blocks on the card run in no order.
//
// The ResNet-50 1x1 convolutions are this kernel with G = 1 and A the
// pixel rows of an NHWC image: row m = (n, oh, ow) reads x[n, oh*sh,
// ow*sw, :], so a strided 1x1 conv reads its rows by index instead of
// copying x[:, ::s, ::s] first (tpp/conv.py:209).  A plain [G, M, K] stack
// is the same mapping with one "image" of 1 x M pixels at stride 1.
//
// What bounds it on an H100: operations, narrowly.  The batch-64
// ResNet-50 1x1 convs have K, N >= 64 and M >= 12,544: e.g. res2 branch2c
// (M = 200,704, K = 64, N = 256) is 6.6 GFLOP against 257 MB of A and y,
// ~26 flop/byte, just above the ~20 flop/byte balance point of f32 FMA
// (67 TFLOP/s) over HBM (3.35 TB/s).  f32 at full precision rules out the
// tensor cores, so the shared tile (gemm_f32.cuh) streams A and B through
// a cp.async ring, 16-byte copies when K and N are multiples of 4, and
// stores y as float4 rows: a short reduction leaves little time to hide
// the copies behind, so they are few and wide.
//
// brgemm_bf16 is the bf16 form (the TPU kernel's bf16 operands with an
// f32 accumulator, written in bf16) on the tensor-core tile of
// gemm_bf16.cuh, with the same row map and epilogues.  The bound at bf16
// is bytes: res2 branch2c moves 129 MB at 3.35 TB/s (0.038 ms) and its
// 6.6 GFLOP take 0.0067 ms at 989 TFLOP/s.

#include "gemm_bf16.cuh"

namespace {

template <class T>
struct BrgemmA {
  const T* a;
  long long gstride;  // elements between a[g] and a[g + 1] (M * K)
  int M, K, Kred;
  int img_h, img_w, out_h, out_w, sh, sw;  // row m -> pixel (n, oh*sh, ow*sw)

  struct Row {
    long long off;
    bool ok;
  };
  struct Cursor {
    int k, g, kk;  // reduction index k = g * K + kk
  };

  __device__ Row row(int m) const {
    Row r{0, m < M};
    if (r.ok) {
      const int per_img = out_h * out_w;
      const int n = m / per_img, rem = m - n * per_img;
      const int oh = rem / out_w, ow = rem - oh * out_w;
      r.off = ((long long)(n * img_h + oh * sh) * img_w + (long long)ow * sw) * K;
    }
    return r;
  }
  __device__ Cursor cursor(int k) const {
    const int g = k / K;
    return Cursor{k, g, k - g * K};
  }
  __device__ void advance(Cursor& u, int step) const {
    u.k += step;
    u.kk += step;
    while (u.kk >= K) {
      u.kk -= K;
      ++u.g;
    }
  }
  __device__ const T* src(const Row& r, const Cursor& u, bool& ok) const {
    ok = r.ok && u.k < Kred;
    return ok ? a + r.off + u.g * gstride + u.kk : a;
  }
};

// the arguments both forms check
bool bad_args(int G, int M, int K, int N, int img_h, int out_h, int out_w) {
  return G <= 0 || M <= 0 || K <= 0 || N <= 0 || out_h <= 0 || out_w <= 0 ||
         M % (out_h * out_w) != 0 || (G > 1 && (img_h != 1 || out_h != 1)) ||
         (long long)G * K > 0x7fffffff;
}

}  // namespace

// a [G, M, K] (or, with G = 1, an NHWC image [n, img_h, img_w, K] read at
// rows (oh*sh, ow*sw), M = n * out_h * out_w); b [G, K, N]; y [M, N].
// block_m x block_n is the tile, vec the copy form (16-byte copies:
// K % 4 == 0, N % 4 == 0 and a, b, y 16-byte aligned) and splits the
// split of the reduction (ws [splits, M, N] scratch when > 1), as
// ops/kernels/brgemm.py's plan picks them.  scale/shift [N] or null;
// partial [2, ceil(M / block_m), N] scratch and sum/sumsq [N] outputs, or
// all three null.
extern "C" int brgemm_f32(const float* a, const float* b, float* y, int G,
                          int M, int K, int N, int img_h, int img_w,
                          int out_h, int out_w, int sh, int sw, int block_m,
                          int block_n, int vec, int splits, float* ws,
                          const float* scale,
                          const float* shift, int relu, float* partial,
                          float* sum, float* sumsq, void* stream) {
  if (bad_args(G, M, K, N, img_h, out_h, out_w) ||
      (vec && (K % 4 != 0 || !gemm::aligned16(a))))
    return (int)cudaErrorInvalidValue;
  const BrgemmA<float> A{a, (long long)M * K, M, K, G * K,
                         img_h, img_w, out_h, out_w, sh, sw};
  return gemm::launch<gemm::F32Form>(A, b, M, N, G * K, y, block_m, block_n,
                                     vec, splits, ws, scale, shift, relu,
                                     partial, sum, sumsq,
                                     (cudaStream_t)stream);
}

// Blocks of brgemm_f32's block_m x block_n tile in the copy form vec that
// one SM holds at once, or -(CUDA error): ops/kernels/brgemm.py's
// F32.resident, which the tile plan reads, is checked against it.
extern "C" int brgemm_f32_resident(int block_m, int block_n, int vec) {
  return gemm::resident<gemm::F32Form, BrgemmA<float>>(block_m, block_n,
                                                       vec);
}

// brgemm_f32's contract with bf16 a, b and y (scale, shift, ws and the
// stats f32); the 16-byte form needs K % 8 == 0, N % 8 == 0 and a, b, y
// 16-byte aligned.
extern "C" int brgemm_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                           __nv_bfloat16* y, int G, int M, int K, int N,
                           int img_h, int img_w, int out_h, int out_w,
                           int sh, int sw, int block_m, int block_n, int vec,
                           int splits, float* ws, const float* scale,
                           const float* shift, int relu, float* partial,
                           float* sum, float* sumsq, void* stream) {
  if (bad_args(G, M, K, N, img_h, out_h, out_w) ||
      (vec && (K % 8 != 0 || !gemm::aligned16(a))))
    return (int)cudaErrorInvalidValue;
  const BrgemmA<__nv_bfloat16> A{a, (long long)M * K, M, K, G * K,
                                 img_h, img_w, out_h, out_w, sh, sw};
  return gemm::launch<gemm::mma::Form>(A, b, M, N, G * K, y, block_m,
                                       block_n, vec, splits, ws, scale,
                                       shift, relu, partial, sum, sumsq,
                                       (cudaStream_t)stream);
}

extern "C" int brgemm_bf16_resident(int block_m, int block_n, int vec) {
  return gemm::resident<gemm::mma::Form, BrgemmA<__nv_bfloat16>>(
      block_m, block_n, vec);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

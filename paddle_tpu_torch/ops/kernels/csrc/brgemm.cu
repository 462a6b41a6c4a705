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
// What bounds it on an H100: operations.  The batch-64 ResNet-50 1x1
// convs have K, N >= 64 and M >= 12,544: e.g. res2 branch2c (M = 200,704,
// K = 64, N = 256) is 6.6 GFLOP against 257 MB of A and y, ~26 flop/byte,
// above the ~20 flop/byte balance point of f32 FMA (67 TFLOP/s) over HBM
// (3.35 TB/s).  f32 at full precision rules out the tensor cores, so the
// tile keeps every operand in shared memory or registers and does 64
// FMAs per thread for each 16 shared-memory reads.

#include "gemm_f32.cuh"

namespace {

struct BrgemmA {
  const float* a;
  long long gstride;  // elements between a[g] and a[g + 1] (M * K)
  int M, K, Kred;
  int img_h, img_w, out_h, out_w, sh, sw;  // row m -> pixel (n, oh*sh, ow*sw)

  struct Row {
    long long off;
    bool ok;
  };
  struct Col {
    long long off;
    bool ok;
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
  __device__ Col col(int k) const {
    Col c{0, k < Kred};
    if (c.ok) {
      const int g = k / K;
      c.off = g * gstride + (k - g * K);
    }
    return c;
  }
  __device__ float load(const Row& r, const Col& c) const {
    return (r.ok && c.ok) ? a[r.off + c.off] : 0.f;
  }
};

}  // namespace

// a [G, M, K] (or, with G = 1, an NHWC image [n, img_h, img_w, K] read at
// rows (oh*sh, ow*sw), M = n * out_h * out_w); b [G, K, N]; y [M, N].
// scale/shift [N] or null; partial [2, ceil(M / 128), N] scratch and
// sum/sumsq [N] outputs, or all three null.
extern "C" int brgemm_f32(const float* a, const float* b, float* y, int G,
                          int M, int K, int N, int img_h, int img_w,
                          int out_h, int out_w, int sh, int sw,
                          const float* scale, const float* shift, int relu,
                          float* partial, float* sum, float* sumsq,
                          void* stream) {
  if (G <= 0 || M <= 0 || K <= 0 || N <= 0 || out_h <= 0 || out_w <= 0 ||
      M % (out_h * out_w) != 0 || (G > 1 && (img_h != 1 || out_h != 1)) ||
      (long long)G * K > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const BrgemmA A{a, (long long)M * K, M, K, G * K,
                  img_h, img_w, out_h, out_w, sh, sw};
  return gemm::launch(A, b, M, N, G * K, y, scale, shift, relu, partial, sum,
                      sumsq, (cudaStream_t)stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

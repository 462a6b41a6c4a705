// Direct 2-D convolution, NHWC input / HWIO weights, groups = 1,
// dilation = 1, numeric padding, as an implicit GEMM with the fused
// epilogue of gemm_f32.cuh (none, per-channel sum/sumsq for training-mode
// batch norm, or affine + relu for inference-mode batch norm).
//
// Replaces paddle_tpu/ops/pallas/tpp/conv.py::_direct_fwd_raw's direct
// kernel (the pallas_call of _conv_kernel, reached from conv2d_direct and
// conv2d_bn_act).  That kernel runs a grid (N, OH, KH) over one padded
// input row in VMEM and contracts each kw tap's shifted row slice on the
// MXU.  This one computes the same function with the card's structure:
// output pixels (n, oh, ow) are the GEMM rows, Cout the columns, and the
// reduction runs over (kh, kw, cin) in the order of the HWIO weight, so B
// is the weight itself seen as a row-major [KH*KW*Cin, Cout] matrix.  The
// patch matrix is never written: each A element is read from x by index
// math, and padding and stride are bounds checks, so no padded copy of x
// exists either.
//
// What bounds it on an H100: operations.  The batch-64 ResNet-50 3x3
// convs (e.g. res2: x [64, 56, 56, 64], 64 filters) are 14.8 GFLOP
// against ~103 MB of x and y, ~140 flop/byte; the 7x7 stem is 15.1 GFLOP
// against ~244 MB, ~62 flop/byte.  f32 at full precision rules out the tensor cores, so
// the shared tile streams 8-deep reduction slices of A and B through
// shared memory and does 64 FMAs per thread per 16 shared reads.  The
// stem's Cin = 3 (reduction 147) and the odd output sizes are masked in
// the loads, not padded.

#include "gemm_f32.cuh"

namespace {

struct ConvA {
  const float* x;
  int M, H, W, C, OH, OW, KW, sh, sw, ph, pw, Kred;

  struct Row {
    long long base;  // offset of image n
    int ih0, iw0;    // top-left input pixel of the window (may be < 0)
    bool ok;
  };
  struct Col {
    int kh, kw, c;
    bool ok;
  };

  __device__ Row row(int m) const {
    Row r{0, 0, 0, m < M};
    if (r.ok) {
      const int per_img = OH * OW;
      const int n = m / per_img, rem = m - n * per_img;
      const int oh = rem / OW, ow = rem - oh * OW;
      r.base = (long long)n * H * W * C;
      r.ih0 = oh * sh - ph;
      r.iw0 = ow * sw - pw;
    }
    return r;
  }
  __device__ Col col(int k) const {
    Col c{0, 0, 0, k < Kred};
    if (c.ok) {
      const int kwc = KW * C;
      c.kh = k / kwc;
      const int rem = k - c.kh * kwc;
      c.kw = rem / C;
      c.c = rem - c.kw * C;
    }
    return c;
  }
  __device__ float load(const Row& r, const Col& c) const {
    const int ih = r.ih0 + c.kh, iw = r.iw0 + c.kw;
    const bool ok = r.ok && c.ok && (unsigned)ih < (unsigned)H &&
                    (unsigned)iw < (unsigned)W;
    return ok ? x[r.base + ((long long)ih * W + iw) * C + c.c] : 0.f;
  }
};

}  // namespace

// x [n, h, w, cin], wt [kh, kw, cin, cout], y [n, oh, ow, cout] (all
// contiguous f32).  scale/shift [cout] or null; partial
// [2, ceil(n*oh*ow / 128), cout] scratch and sum/sumsq [cout] outputs, or
// all three null.
extern "C" int conv2d_direct_f32(const float* x, const float* wt, float* y,
                                 int n, int h, int w, int cin, int kh, int kw,
                                 int cout, int oh, int ow, int sh, int sw,
                                 int ph, int pw, const float* scale,
                                 const float* shift, int relu, float* partial,
                                 float* sum, float* sumsq, void* stream) {
  const long long m = (long long)n * oh * ow;
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || kh <= 0 || kw <= 0 ||
      cout <= 0 || oh <= 0 || ow <= 0 || sh <= 0 || sw <= 0 || ph < 0 ||
      pw < 0 || m > 0x7fffffff || (long long)kh * kw * cin > 0x7fffffff ||
      (oh - 1) * sh + kh > h + 2 * ph || (ow - 1) * sw + kw > w + 2 * pw)
    return (int)cudaErrorInvalidValue;
  const ConvA A{x, (int)m, h, w, cin, oh, ow, kw, sh, sw, ph, pw,
                kh * kw * cin};
  return gemm::launch(A, wt, (int)m, cout, kh * kw * cin, y, scale, shift,
                      relu, partial, sum, sumsq, (cudaStream_t)stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

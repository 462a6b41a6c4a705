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
// against ~244 MB, ~62 flop/byte.  f32 at full precision rules out the
// tensor cores, so the shared tile (gemm_f32.cuh) streams 16-deep
// reduction slices through a cp.async ring and runs an 8 x 8 FMA tile a
// thread.  The reduction runs (kh, kw) outer and channels inner, so with
// Cin % 4 == 0 one 16-byte copy reads 4 channels of one tap (NHWC keeps a
// tap's channels contiguous) and a row's window test is per tap, not per
// element; the Cin 1 and 3 convs (the ResNet stem, AlexNet conv1, the
// CRNN's first conv) take the tile's 4-byte form.  A thread's cursor into
// the reduction advances by a slice with adds and compares; the divisions
// happen once, when a block starts.  Padding taps and rows past M are
// zero-filled by the copies.
//
// conv2d_direct_bf16 is the bf16 form (bf16 x and w, f32 accumulation,
// y in bf16) on the tensor-core tile of gemm_bf16.cuh; Cin % 8 == 0 takes
// its 16-byte copies, the stem's Cin 3 its register-staged form.  At bf16
// the 3x3s sit near the card's balance of ~295 flop a byte (res2: 14.8
// GFLOP, 52 MB: 0.015 ms of tensor-core time, 0.015 of bytes).

#include "gemm_bf16.cuh"

namespace {

template <class T>
struct ConvA {
  const T* x;
  int M, H, W, C, OH, OW, KW, sh, sw, ph, pw, Kred;

  struct Row {
    int pix;       // pixel index of the window's top-left tap (n, ih0, iw0)
    int ih0, iw0;  // that tap's input row and column (may be < 0)
  };
  struct Cursor {
    int k, kh, kw, c;  // reduction index k = (kh * KW + kw) * C + c
  };

  __device__ Row row(int m) const {
    if (m >= M) return Row{0, -(1 << 30), 0};  // no tap is inside the image
    const int per_img = OH * OW;
    const int n = m / per_img, rem = m - n * per_img;
    const int oh = rem / OW, ow = rem - oh * OW;
    const int ih0 = oh * sh - ph, iw0 = ow * sw - pw;
    return Row{(n * H + ih0) * W + iw0, ih0, iw0};
  }
  __device__ Cursor cursor(int k) const {
    const int tap = k / C;
    return Cursor{k, tap / KW, tap - tap / KW * KW, k - tap * C};
  }
  __device__ void advance(Cursor& u, int step) const {
    u.k += step;
    u.c += step;
    while (u.c >= C) {
      u.c -= C;
      if (++u.kw == KW) {
        u.kw = 0;
        ++u.kh;
      }
    }
  }
  __device__ const T* src(const Row& r, const Cursor& u, bool& ok) const {
    const int ih = r.ih0 + u.kh, iw = r.iw0 + u.kw;
    ok = u.k < Kred && (unsigned)ih < (unsigned)H && (unsigned)iw < (unsigned)W;
    return ok ? x + ((long long)(r.pix + u.kh * W + u.kw) * C + u.c) : x;
  }
};

// the arguments both forms check
bool bad_args(int n, int h, int w, int cin, int kh, int kw, int cout, int oh,
              int ow, int sh, int sw, int ph, int pw) {
  const long long m = (long long)n * oh * ow;
  return n <= 0 || h <= 0 || w <= 0 || cin <= 0 || kh <= 0 || kw <= 0 ||
         cout <= 0 || oh <= 0 || ow <= 0 || sh <= 0 || sw <= 0 || ph < 0 ||
         pw < 0 || m > 0x7fffffff || (long long)kh * kw * cin > 0x7fffffff ||
         (long long)n * h * w > 0x7fffffff ||
         (oh - 1) * sh + kh > h + 2 * ph || (ow - 1) * sw + kw > w + 2 * pw;
}

}  // namespace

// x [n, h, w, cin], wt [kh, kw, cin, cout], y [n, oh, ow, cout] (all
// contiguous f32).  block_m x block_n is the tile, vec the copy form
// (16-byte copies: cin % 4 == 0, cout % 4 == 0 and x, wt, y 16-byte
// aligned) and splits the split of the reduction (ws [splits, n*oh*ow,
// cout] scratch when > 1), as ops/kernels/brgemm.py's plan picks them.
// scale/shift
// [cout] or null; partial [2, ceil(n*oh*ow / block_m), cout] scratch and
// sum/sumsq [cout] outputs, or all three null.
extern "C" int conv2d_direct_f32(const float* x, const float* wt, float* y,
                                 int n, int h, int w, int cin, int kh, int kw,
                                 int cout, int oh, int ow, int sh, int sw,
                                 int ph, int pw, int block_m, int block_n,
                                 int vec, int splits, float* ws,
                                 const float* scale,
                                 const float* shift, int relu, float* partial,
                                 float* sum, float* sumsq, void* stream) {
  const long long m = (long long)n * oh * ow;
  if (bad_args(n, h, w, cin, kh, kw, cout, oh, ow, sh, sw, ph, pw) ||
      (vec && (cin % 4 != 0 || !gemm::aligned16(x))))
    return (int)cudaErrorInvalidValue;
  const ConvA<float> A{x, (int)m, h, w, cin, oh, ow, kw, sh, sw, ph, pw,
                       kh * kw * cin};
  return gemm::launch<gemm::F32Form>(A, wt, (int)m, cout, kh * kw * cin, y,
                                     block_m, block_n, vec, splits, ws,
                                     scale, shift, relu, partial, sum, sumsq,
                                     (cudaStream_t)stream);
}

// Blocks of conv2d_direct_f32's block_m x block_n tile in the copy form vec that
// one SM holds at once, or -(CUDA error): ops/kernels/brgemm.py's
// F32.resident, which the tile plan reads, is checked against it.
extern "C" int conv2d_direct_f32_resident(int block_m, int block_n, int vec) {
  return gemm::resident<gemm::F32Form, ConvA<float>>(block_m, block_n, vec);
}

// conv2d_direct_f32's contract with bf16 x, wt and y (scale, shift, ws
// and the stats f32); the 16-byte form needs cin % 8 == 0, cout % 8 == 0
// and x, wt, y 16-byte aligned.
extern "C" int conv2d_direct_bf16(const __nv_bfloat16* x,
                                  const __nv_bfloat16* wt, __nv_bfloat16* y,
                                  int n, int h, int w, int cin, int kh,
                                  int kw, int cout, int oh, int ow, int sh,
                                  int sw, int ph, int pw, int block_m,
                                  int block_n, int vec, int splits,
                                  float* ws, const float* scale,
                                  const float* shift, int relu,
                                  float* partial, float* sum, float* sumsq,
                                  void* stream) {
  const long long m = (long long)n * oh * ow;
  if (bad_args(n, h, w, cin, kh, kw, cout, oh, ow, sh, sw, ph, pw) ||
      (vec && (cin % 8 != 0 || !gemm::aligned16(x))))
    return (int)cudaErrorInvalidValue;
  const ConvA<__nv_bfloat16> A{x, (int)m, h, w, cin, oh, ow, kw, sh, sw,
                               ph, pw, kh * kw * cin};
  return gemm::launch<gemm::mma::Form>(A, wt, (int)m, cout, kh * kw * cin,
                                       y, block_m, block_n, vec, splits, ws,
                                       scale, shift, relu, partial, sum,
                                       sumsq, (cudaStream_t)stream);
}

extern "C" int conv2d_direct_bf16_resident(int block_m, int block_n,
                                           int vec) {
  return gemm::resident<gemm::mma::Form, ConvA<__nv_bfloat16>>(
      block_m, block_n, vec);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

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
// The bf16 forms (bf16 x and w, f32 accumulation, y in bf16):
// conv2d_direct_wgmma on the Hopper tile of gemm_wgmma.cuh where Cin and
// Cout are multiples of 8 and the operands 16-byte aligned (every
// ResNet-50 conv but the stem), conv2d_direct_bf16 on the mma.sync tile
// of gemm_bf16.cuh otherwise (its register-staged form: the stem's Cin
// 3).  At bf16 the 3x3s sit near the card's balance of ~295 flop a byte
// (res2: 14.8 GFLOP, 52 MB: 0.015 ms of tensor-core time, 0.015 of
// bytes).  Every entry takes one parameter block (ConvParams) and the
// stream.

#include "gemm_bf16.cuh"
#include "gemm_wgmma.cuh"

// The launch's parameter block, one field a line in this order
// (ops/kernels/conv.py's ConvParams mirrors it): x, wt and y in the
// entry's dtype, ws, scale, shift and the stats f32.
struct ConvParams {
  const void* x;
  const void* wt;
  void* y;
  float* ws;
  const float* scale;
  const float* shift;
  float* partial;
  float* sum;
  float* sumsq;
  int n;
  int h;
  int w;
  int cin;
  int kh;
  int kw;
  int cout;
  int oh;
  int ow;
  int sh;
  int sw;
  int ph;
  int pw;
  int block_m;
  int block_n;
  int vec;
  int splits;
  int relu;
};

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

// the arguments every form checks; vec_elems: the elements of a 16-byte
// copy (4 f32, 8 bf16), whose multiple Cin must be in the 16-byte form
bool bad_args(const ConvParams& p, int vec_elems) {
  const long long m = (long long)p.n * p.oh * p.ow;
  return p.n <= 0 || p.h <= 0 || p.w <= 0 || p.cin <= 0 || p.kh <= 0 ||
         p.kw <= 0 || p.cout <= 0 || p.oh <= 0 || p.ow <= 0 || p.sh <= 0 ||
         p.sw <= 0 || p.ph < 0 || p.pw < 0 || m > 0x7fffffff ||
         (long long)p.kh * p.kw * p.cin > 0x7fffffff ||
         (long long)p.n * p.h * p.w > 0x7fffffff ||
         (p.oh - 1) * p.sh + p.kh > p.h + 2 * p.ph ||
         (p.ow - 1) * p.sw + p.kw > p.w + 2 * p.pw ||
         (p.vec && (p.cin % vec_elems != 0 || !gemm::aligned16(p.x)));
}

template <class T>
ConvA<T> loader(const ConvParams& p) {
  return ConvA<T>{static_cast<const T*>(p.x), p.n * p.oh * p.ow, p.h, p.w,
                  p.cin, p.oh, p.ow, p.kw, p.sh, p.sw, p.ph, p.pw,
                  p.kh * p.kw * p.cin};
}

template <class Form>
int run(const ConvParams& p, void* stream) {
  using T = typename Form::Elem;
  if (bad_args(p, Form::kVecElems)) return (int)cudaErrorInvalidValue;
  return gemm::launch<Form>(loader<T>(p), static_cast<const T*>(p.wt),
                            p.n * p.oh * p.ow, p.cout, p.kh * p.kw * p.cin,
                            static_cast<T*>(p.y), p.block_m, p.block_n,
                            p.vec, p.splits, p.ws, p.scale, p.shift, p.relu,
                            p.partial, p.sum, p.sumsq, (cudaStream_t)stream);
}

}  // namespace

// x [n, h, w, cin], wt [kh, kw, cin, cout], y [n, oh, ow, cout] (all
// contiguous f32).  block_m x block_n is the tile, vec the copy form
// (16-byte copies: cin % 4 == 0, cout % 4 == 0 and x, wt, y 16-byte
// aligned) and splits the split of the reduction (ws [splits, n*oh*ow,
// cout] scratch when > 1), as ops/kernels/brgemm.py's plan picks them.
// scale/shift [cout] or null; partial [2, ceil(n*oh*ow / block_m), cout]
// scratch and sum/sumsq [cout] outputs, or all three null.
extern "C" int conv2d_direct_f32(const ConvParams* p, void* stream) {
  return run<gemm::F32Form>(*p, stream);
}

// Blocks of conv2d_direct_f32's block_m x block_n tile in the copy form
// vec that one SM holds at once, or -(CUDA error): ops/kernels/brgemm.py's
// F32.resident, which the tile plan reads, is checked against it.
extern "C" int conv2d_direct_f32_resident(int block_m, int block_n, int vec) {
  return gemm::resident<gemm::F32Form, ConvA<float>>(block_m, block_n, vec);
}

// conv2d_direct_f32's contract with bf16 x, wt and y on the mma.sync tile
// of gemm_bf16.cuh (scale, shift, ws and the stats f32), its
// register-staged form only (vec 0).
extern "C" int conv2d_direct_bf16(const ConvParams* p, void* stream) {
  return run<gemm::mma::Form>(*p, stream);
}

extern "C" int conv2d_direct_bf16_resident(int block_m, int block_n,
                                           int vec) {
  return gemm::resident<gemm::mma::Form, ConvA<__nv_bfloat16>>(
      block_m, block_n, vec);
}

// conv2d_direct_bf16's contract on the wgmma tile of gemm_wgmma.cuh:
// block_m 128, the 16-byte form only (cin % 8 == 0, cout % 8 == 0, x, wt,
// y 16-byte aligned); the weight's tensor map is encoded here.
extern "C" int conv2d_direct_wgmma(const ConvParams* p, void* stream) {
  using bf16 = __nv_bfloat16;
  if (bad_args(*p, 8) || !p->vec || p->block_m != gemm::wgmma::kBM)
    return (int)cudaErrorInvalidValue;
  return gemm::wgmma::launch(
      loader<bf16>(*p), static_cast<const bf16*>(p->wt), p->n * p->oh * p->ow,
      p->cout, p->kh * p->kw * p->cin, static_cast<bf16*>(p->y), p->block_n,
      p->splits, p->ws, p->scale, p->shift, p->relu, p->partial, p->sum,
      p->sumsq, (cudaStream_t)stream);
}

extern "C" int conv2d_direct_wgmma_resident(int block_m, int block_n,
                                            int vec) {
  if (block_m != gemm::wgmma::kBM || !vec) return -(int)cudaErrorInvalidValue;
  return gemm::wgmma::resident<ConvA<__nv_bfloat16>>(block_n);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

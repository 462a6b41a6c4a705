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
// The bf16 forms (the TPU kernel's bf16 operands with an f32
// accumulator, written in bf16) have the same row map and epilogues:
// brgemm_wgmma on the Hopper tile of gemm_wgmma.cuh (wgmma, TMA, a
// warp-specialised mbarrier ring, persistent) where the copies can be
// 16 bytes wide (K and N multiples of 8, aligned operands), brgemm_bf16
// on the mma.sync tile of gemm_bf16.cuh otherwise.  The bound at bf16 is
// bytes: res2 branch2c moves 129 MB at 3.35 TB/s (0.038 ms) and its 6.6
// GFLOP take 0.0067 ms at 989 TFLOP/s.
//
// Every entry takes one parameter block (BrgemmParams) and the stream,
// so the host converts two arguments a call, not 25.

#include "gemm_bf16.cuh"
#include "gemm_wgmma.cuh"

// The launch's parameter block, one field a line in this order
// (ops/kernels/brgemm.py's BrgemmParams mirrors it): a, b and y in the
// entry's dtype, ws, scale, shift and the stats f32.
struct BrgemmParams {
  const void* a;
  const void* b;
  void* y;
  float* ws;
  const float* scale;
  const float* shift;
  float* partial;
  float* sum;
  float* sumsq;
  int G;
  int M;
  int K;
  int N;
  int img_h;
  int img_w;
  int out_h;
  int out_w;
  int sh;
  int sw;
  int block_m;
  int block_n;
  int vec;
  int splits;
  int relu;
};

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

// the arguments every form checks; vec_elems: the elements of a 16-byte
// copy (4 f32, 8 bf16), whose multiple K must be in the 16-byte form
bool bad_args(const BrgemmParams& p, int vec_elems) {
  return p.G <= 0 || p.M <= 0 || p.K <= 0 || p.N <= 0 || p.out_h <= 0 ||
         p.out_w <= 0 || p.M % (p.out_h * p.out_w) != 0 ||
         (p.G > 1 && (p.img_h != 1 || p.out_h != 1)) ||
         (long long)p.G * p.K > 0x7fffffff ||
         (p.vec && (p.K % vec_elems != 0 || !gemm::aligned16(p.a)));
}

template <class T>
BrgemmA<T> loader(const BrgemmParams& p) {
  return BrgemmA<T>{static_cast<const T*>(p.a), (long long)p.M * p.K, p.M,
                    p.K, p.G * p.K, p.img_h, p.img_w, p.out_h, p.out_w,
                    p.sh, p.sw};
}

template <class Form>
int run(const BrgemmParams& p, void* stream) {
  using T = typename Form::Elem;
  if (bad_args(p, Form::kVecElems)) return (int)cudaErrorInvalidValue;
  return gemm::launch<Form>(loader<T>(p), static_cast<const T*>(p.b), p.M,
                            p.N, p.G * p.K, static_cast<T*>(p.y), p.block_m,
                            p.block_n, p.vec, p.splits, p.ws, p.scale,
                            p.shift, p.relu, p.partial, p.sum, p.sumsq,
                            (cudaStream_t)stream);
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
extern "C" int brgemm_f32(const BrgemmParams* p, void* stream) {
  return run<gemm::F32Form>(*p, stream);
}

// Blocks of brgemm_f32's block_m x block_n tile in the copy form vec that
// one SM holds at once, or -(CUDA error): ops/kernels/brgemm.py's
// F32.resident, which the tile plan reads, is checked against it.
extern "C" int brgemm_f32_resident(int block_m, int block_n, int vec) {
  return gemm::resident<gemm::F32Form, BrgemmA<float>>(block_m, block_n,
                                                       vec);
}

// brgemm_f32's contract with bf16 a, b and y on the mma.sync tile of
// gemm_bf16.cuh (scale, shift, ws and the stats f32), its register-staged
// form only (vec 0).
extern "C" int brgemm_bf16(const BrgemmParams* p, void* stream) {
  return run<gemm::mma::Form>(*p, stream);
}

extern "C" int brgemm_bf16_resident(int block_m, int block_n, int vec) {
  return gemm::resident<gemm::mma::Form, BrgemmA<__nv_bfloat16>>(
      block_m, block_n, vec);
}

// brgemm_bf16's contract on the wgmma tile of gemm_wgmma.cuh: block_m
// 128, the 16-byte form only (K % 8 == 0, N % 8 == 0, a, b, y 16-byte
// aligned); B's tensor map is encoded here.
extern "C" int brgemm_wgmma(const BrgemmParams* p, void* stream) {
  using bf16 = __nv_bfloat16;
  if (bad_args(*p, 8) || !p->vec || p->block_m != gemm::wgmma::kBM)
    return (int)cudaErrorInvalidValue;
  return gemm::wgmma::launch(loader<bf16>(*p), static_cast<const bf16*>(p->b),
                             p->M, p->N, p->G * p->K, static_cast<bf16*>(p->y),
                             p->block_n, p->splits, p->ws, p->scale,
                             p->shift, p->relu, p->partial, p->sum,
                             p->sumsq, (cudaStream_t)stream);
}

extern "C" int brgemm_wgmma_resident(int block_m, int block_n, int vec) {
  if (block_m != gemm::wgmma::kBM || !vec) return -(int)cudaErrorInvalidValue;
  return gemm::wgmma::resident<BrgemmA<__nv_bfloat16>>(block_n);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

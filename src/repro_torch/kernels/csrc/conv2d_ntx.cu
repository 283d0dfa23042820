// NTX direct convolution for Hopper: NHWC x HWIO -> NHWC, VALID, stride >= 1.
//
// Replaces the TPU kernel repro/kernels/conv2d.py::conv2d_ntx (body
// _conv_kernel): a grid of (image, th-row tile); each step zeroes an fp32
// accumulator, adds the kh*kw products of the strided (th, ow, Cin) slab
// slice with w[u, v] (Cin, Cout), and stores once in x's dtype.
//
// Design:
//   * one CTA per (image, th-row output tile, 64-channel Cout tile), with
//     th = min(tile_h, OH) from the caller. The TPU grid's row axis is
//     "arbitrary", but its tiles carry no state from one to the next, so
//     here they run at once. A CTA reads only its input slab, the
//     (th - 1) * stride + kh rows its outputs need, and walks the slab's
//     th * OW output pixels in blocks of 128;
//   * the reduction index r runs over (u, v, ci) in that order, as the TPU
//     kernel sums over (u, v) with the Cin contraction inside each: a block
//     of 128 pixels x 64 channels is the shared GEMM loop of ffma_tile.cuh
//     with one tile over all of r (Join::kNone), its A operand gathered
//     from x through x's four strides and its B operand w read as the
//     (kh*kw*Cin, Cout) matrix it is. Every output adds its terms to one
//     fp32 register in an FFMA chain and leaves registers once, rounded
//     once to x's dtype (__float2bfloat16_rn for bf16);
//   * rows that JAX pads to whole tiles and slices off are never written:
//     a pixel past OH is read as 0 and not stored. No atomics, no
//     cross-CTA sums: the same bits on every run.
//
// Bound on the H100: at the GoogLeNet layers the work is 2 * N*OH*OW * Cout *
// kh*kw*Cin FLOPs against x, w and y moved once, tens to hundreds of FLOPs per
// byte, so the fp32 pipe (67 TFLOP/s, FFMA) bounds it. The design does about
// that what a simple implicit-GEMM kernel does (ffma_tile.cuh): an 8 x 4
// register block per thread fed by three 16-byte shared loads per r, and the
// next chunk's global loads in flight while the current one is summed.

#include "ffma_tile.cuh"

namespace {

constexpr int BM = 128;  // output pixels of a block
constexpr int TM = BM / 16;
constexpr int A_LOADS = ffma::A_LOADS<BM>;
using ffma::BK;
using ffma::PAD;

// The im2col rows of one block of output pixels, gathered from x: register
// i of a thread holds pixel tid / 16 + 16 i at reduction index kc0 + tid % 16
// (ffma::a_slot's k-fast order).
template <typename T>
struct Gather {
  const T* x;
  int KW, Cin;
  long long sxh, sxw, sxc;
  long long base[A_LOADS];  // offset of each pixel's window in x, image included
  bool live[A_LOADS];

  __device__ __forceinline__ Gather(const T* x_, int KW_, int Cin_, long long sxn,
                                    long long sxh_, long long sxw_, long long sxc_, int stride,
                                    int OW, int img, int oh0, int p0, int n_pix)
      : x(x_), KW(KW_), Cin(Cin_), sxh(sxh_), sxw(sxw_), sxc(sxc_) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int p = p0 + threadIdx.x / BK + 16 * i;
      live[i] = p < n_pix;
      const int oh = oh0 + p / OW, ow = p % OW;
      base[i] = img * sxn + static_cast<long long>(oh) * stride * sxh +
                static_cast<long long>(ow) * stride * sxw;
    }
  }
  __device__ __forceinline__ void load(float (&r)[A_LOADS], int kc0, int kend) const {
    const int k = kc0 + threadIdx.x % BK;
    const bool k_ok = k < kend;
    const int u = k / (KW * Cin);
    const int rem = k - u * KW * Cin;
    const int v = rem / Cin;
    const int ci = rem - v * Cin;
    const long long off = u * sxh + v * sxw + ci * sxc;
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i)
      r[i] = (k_ok && live[i]) ? ffma::widen(x[base[i] + off]) : 0.f;
  }
  __device__ __forceinline__ void stage(float (&s)[BK][BM + PAD],
                                        const float (&r)[A_LOADS]) const {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) s[threadIdx.x % BK][threadIdx.x / BK + 16 * i] = r[i];
  }
};

template <typename T>
__global__ void __launch_bounds__(ffma::THREADS)
conv2d_ntx_kernel(const T* __restrict__ X, const T* __restrict__ W, T* __restrict__ Y, int KW,
                  int Cin, int Cout, int stride, int th, int OH, int OW, int row_tiles,
                  long long sxn, long long sxh, long long sxw, long long sxc, int K) {
  __shared__ __align__(16) ffma::Tiles<BM> sm;
  const int img = blockIdx.x / row_tiles;
  const int oh0 = (blockIdx.x % row_tiles) * th;
  const int rows = min(th, OH - oh0);
  const int co0 = blockIdx.y * ffma::BN;
  const int n_pix = rows * OW;
  const ffma::StridedB<T> w{W, Cout, co0, Cout, 1};

  for (int p0 = 0; p0 < n_pix; p0 += BM) {
    const Gather<T> x(X, KW, Cin, sxn, sxh, sxw, sxc, stride, OW, img, oh0, p0, n_pix);
    float out[TM][ffma::TN];
    ffma::gemm<ffma::Join::kNone>(sm, x, w, K, K, out);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int p = p0 + (threadIdx.x / 16) * TM + i;
      if (p >= n_pix) continue;
      const long long row = (static_cast<long long>(img) * OH + oh0 + p / OW) * OW + p % OW;
#pragma unroll
      for (int j = 0; j < ffma::TN; ++j) {
        const int co = co0 + (threadIdx.x % 16) * ffma::TN + j;
        if (co < Cout) ffma::put(Y + row * Cout + co, out[i][j]);
      }
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, void* y, int N, int KH, int KW, int Cin, int Cout,
            int stride, int th, int OH, int OW, long long sxn, long long sxh, long long sxw,
            long long sxc, cudaStream_t stream) {
  const int row_tiles = (OH + th - 1) / th;
  dim3 grid(N * row_tiles, (Cout + ffma::BN - 1) / ffma::BN);
  conv2d_ntx_kernel<T><<<grid, ffma::THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), KW, Cin, Cout,
      stride, th, OH, OW, row_tiles, sxn, sxh, sxw, sxc, KH * KW * Cin);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, w and y alike). x is read through its
// (n, h, w, c) strides; w is (KH, KW, Cin, Cout) contiguous; y is
// (N, OH, OW, Cout) contiguous.
extern "C" int conv2d_ntx_launch(const void* x, const void* w, void* y, int dtype, int N,
                                 int KH, int KW, int Cin, int Cout, int stride, int th, int OH,
                                 int OW, long long sxn, long long sxh, long long sxw,
                                 long long sxc, void* stream) {
  if (N > 0 && OH > 0 && OW > 0 && Cout > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
      launch<float>(x, w, y, N, KH, KW, Cin, Cout, stride, th, OH, OW, sxn, sxh, sxw, sxc, s);
    else
      launch<__nv_bfloat16>(x, w, y, N, KH, KW, Cin, Cout, stride, th, OH, OW, sxn, sxh, sxw,
                            sxc, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* conv2d_ntx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// NTX direct convolution for Hopper on the tensor cores, for the few-channel
// stem of a CNN (GoogLeNet L0: 224 x 224 x 3, 7 x 7, stride 2 -> 64): NHWC x
// HWIO -> NHWC, VALID, stride >= 1, as an implicit GEMM on wgmma, in bf16 and
// in fp32 (3xTF32) from one source templated on the operands' bits.
//
// Replaces the TPU kernel repro/kernels/conv2d.py::conv2d_ntx (body
// _conv_kernel, pallas_call at :75; per-tap jnp.dot into an fp32 acc_ref)
// for the channel counts neither wide kernel takes (conv2d_ntx_wgmma.cu: Cin
// and Cout multiples of 64; conv2d_ntx_tf32.cu: Cin a multiple of 32), with
// K = KH*KW*Cin at most MAX_K and Cout a multiple of 64. It computes what
// conv2d_ntx.cu computes: per output pixel and channel, the sum over (u, v,
// ci) into fp32, stored once in x's type.
//
// The GEMM: M = output pixels, N = Cout, K = (u, v, ci) flattened in that
// order and padded with zeros to whole slices: at L0 K = 147, 160 in bf16
// (ten k16 slices), 152 in fp32 (nineteen k8 slices).
//
// Bound on the H100 at L0, batch 32: 2 * 401,408 * 64 * 147 = 7.553 GFLOP.
// bf16: x, w and y moved once are 61.5 MB, 0.01837 ms at 3.35 TB/s, against
// 0.0076 ms of bf16 tensor work: bytes bound it. fp32: three tf32 products
// each, 0.0458 ms at 495 TFLOP/s, against 123.1 MB (0.0368 ms): operations.
//
// Numerics. bf16: products of bf16 are exact in fp32; the slices are summed
// in the fp32 accumulator on the tensor cores and y is rounded once (round to
// nearest even). fp32 (the rule of csrc/ntx_gemm_wgmma.cu): x and w are
// split into hi = tf32_rn(v) and lo = tf32_rn(v - hi); a k8 slice takes
// lo.hi, hi.lo and hi.hi summed from zero on the tensor cores; the (at most)
// four slices of a stage of 32 K are summed from zero by IEEE adds
// (__fadd_rn), and the stage's sum is added to the pixel's fp32 sum by one
// more (kernels/conv2d_ntx_stem.py::emulate reads about 0.82x the plain
// version's RMS error against fp64 at L0; slices added one by one straight
// into the pixel's sum about 0.93x). The order depends neither on the grid
// nor on tile_h, so the bits are the same on every run and for every tile_h.
//
// Design (what the few channels change against the wide kernels):
//   * a pixel tile is TR x TC = 8 x 16 output pixels of one image; the CTA
//     keeps its slab of x, ((TR - 1) s + KH) x ((TC - 1) s + KW) x Cin input
//     elements (21 x 37 x 3 at L0), in shared memory: Cin 3 gives 6 or 12
//     bytes a tap, below cp.async's 16, so every tap's row is gathered from
//     the slab and not from device memory. The slab is loaded by all threads
//     with coalesced loads through x's four strides (along channels where
//     they are the innermost, else along columns: fp32 L0's NCHW data viewed
//     as NHWC), zero past H and W; in fp32 each element is split into hi
//     and lo once, as it lands.
//   * A: each thread reads its fragment of the m64 tile straight from the
//     slab (a table of the K index's slab offset, -1 past K, sits beside it)
//     and the products take A from registers (the rs form of wgmma), so no A
//     tile is built in shared memory. Warpgroup g owns output rows 4g .. 4g +
//     3 of the tile, warp w of it row 4g + w: a fragment's rows are that
//     row's 16 pixels.
//   * B: w's 64 columns of the CTA's Cout tile, K-major (one 128-byte row of
//     K per output channel, under the 128-byte swizzle, 32 fp32 or 64 bf16
//     of K a box), zero past K, split for fp32; loaded once per CTA. tf32
//     wgmma has no transpose bit, so B must be K-major.
//   * grid: (as many CTAs as fit the SMs, Cout / 64). A CTA walks the pixel
//     tiles (image, row tile, column tile) from blockIdx.x in steps of
//     gridDim.x. No split-K, no atomics, no cross-CTA sum.
//   * epilogue: each thread stores its accumulators of two pixels as pairs
//     (eight 32-byte runs a warp store, whole sectors), only for pixels
//     inside OH x OW. Measured on an H100 against this design: 16-byte
//     stores (lanes trading pairs), the next tile's slab loaded into
//     registers during the products, and batched slab loads each took as
//     long or longer; without the y stores the kernel took as long: the
//     products' waits and the slab set its time.
//
// The wrapper (kernels/conv2d.py, rules in kernels/conv2d_ntx_stem.py)
// checks the shapes and the shared memory; x is read through any strides.

#include "sm90.cuh"

#include <algorithm>
#include <climits>

namespace {

constexpr int TR = 8;             // output rows of a pixel tile
constexpr int TC = 16;            // output columns of a pixel tile
constexpr int THREADS = 256;      // two warpgroups of 64 pixels (4 rows of 16) each
constexpr int BN = 64;            // Cout columns per CTA
constexpr int ROW = 128;          // one swizzled row of B
constexpr int B_TILE = BN * ROW;  // one K box of B, hi or lo
constexpr int MAX_K = 256;        // K = KH*KW*Cin the kernel takes (MAX_K in conv2d_ntx_stem.py)

// the operands' bits: fp32 as uint32_t, bf16 as uint16_t
template <typename U>
struct Num;
template <>
struct Num<uint32_t> {
  static constexpr int SLICE = 8, BOX = 32, PARTS = 2;  // k8 slices, hi and lo
};
template <>
struct Num<uint16_t> {
  static constexpr int SLICE = 16, BOX = 64, PARTS = 1;
};

struct Dims {
  int H, W, Cin, KW, Cout, stride, OH, OW;
  int K, kpad, kboxes, kslices;  // K, K in whole slices, boxes of B, slices
  int SR, SW;                    // slab rows and columns
  int tiles_h, tiles_w, n_tiles;
  int c_inner;                   // 1: x's channel stride <= its column stride
  long long sxn, sxh, sxw, sxc;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// d[64 x 64] = scale_d d + a[64 x 16] b[16 x 64], bf16 -> fp32; a the m64k16
// fragment in registers (thread t holds row 16 (t / 32) + (t % 32) / 4 + 8 (i
// % 2), columns 2 (t % 4) + 8 (i / 2) + {0, 1} in a[i], the lower column in
// the low half), b K-major in shared memory
__device__ __forceinline__ void bf16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : SM90_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <typename U>
__device__ __forceinline__ void store_y(U* y, long long off, float v0, float v1);
template <>
__device__ __forceinline__ void store_y<uint32_t>(uint32_t* y, long long off, float v0, float v1) {
  *reinterpret_cast<float2*>(y + off) = make_float2(v0, v1);
}
template <>
__device__ __forceinline__ void store_y<uint16_t>(uint16_t* y, long long off, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(y + off) = __floats2bfloat162_rn(v0, v1);
}

template <typename U>
__global__ void __launch_bounds__(THREADS, 2)
stem_kernel(const U* __restrict__ x, const U* __restrict__ w, U* __restrict__ y, Dims d) {
  using Nm = Num<U>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);  // B: part p (hi, lo), box b at (p kboxes + b) B_TILE
  int* koff = reinterpret_cast<int*>(sm + Nm::PARTS * d.kboxes * B_TILE);
  U* slab = reinterpret_cast<U*>(koff + d.kpad);  // part p at p slab_n
  const int slab_n = d.SR * d.SW * d.Cin;
  const int tid = threadIdx.x;
  const int co0 = blockIdx.y * BN;

  // B, once per CTA: element (k, co) to row co, byte (k % BOX) * size of box k / BOX
  for (int e = tid; e < d.kboxes * Nm::BOX * BN; e += THREADS) {
    const int k = e / BN, co = e - (e / BN) * BN;
    const U v = k < d.K ? w[static_cast<long long>(k) * d.Cout + co0 + co] : U(0);
    const int byte = (k % Nm::BOX) * static_cast<int>(sizeof(U));
    const int off = (k / Nm::BOX) * B_TILE + co * ROW + (((byte >> 4) ^ (co & 7)) << 4) + (byte & 15);
    if constexpr (Nm::PARTS == 2) {
      uint32_t hi, lo;
      tf32_split(v, hi, lo);
      *reinterpret_cast<uint32_t*>(sm + off) = hi;
      *reinterpret_cast<uint32_t*>(sm + d.kboxes * B_TILE + off) = lo;
    } else {
      *reinterpret_cast<U*>(sm + off) = v;
    }
  }
  // the slab offset of each K index (u, v, ci); -1 past K
  for (int k = tid; k < d.kpad; k += THREADS) {
    int o = -1;
    if (k < d.K) {
      const int u = k / (d.KW * d.Cin), r = k - u * d.KW * d.Cin;
      const int v = r / d.Cin, ci = r - v * d.Cin;
      o = (u * d.SW + v) * d.Cin + ci;
    }
    koff[k] = o;
  }
  fence_proxy_async();  // B is read by wgmma after the loop's first barrier

  const int g = tid / 128, warp = (tid % 128) / 32, lane = tid % 32, q = lane % 4;
  const int pr = 4 * g + warp;  // this warp's output row in the tile
  const int pc = lane / 4;      // this thread's output columns pc and pc + 8
  const int pix0 = (pr * d.stride * d.SW + pc * d.stride) * d.Cin;
  const int pix1 = pix0 + 8 * d.stride * d.Cin;
  const int per_img = d.tiles_h * d.tiles_w;

  for (int tile = blockIdx.x; tile < d.n_tiles; tile += gridDim.x) {
    const int img = tile / per_img, rem = tile - (tile / per_img) * per_img;
    const int oh0 = (rem / d.tiles_w) * TR, ow0 = (rem - (rem / d.tiles_w) * d.tiles_w) * TC;
    const U* xb = x + img * d.sxn + static_cast<long long>(oh0) * d.stride * d.sxh +
                  static_cast<long long>(ow0) * d.stride * d.sxw;
    const int rows = min(d.SR, d.H - oh0 * d.stride), cols = min(d.SW, d.W - ow0 * d.stride);
    __syncthreads();  // every fragment of the last tile has been read from the slab
    for (int e = tid; e < slab_n; e += THREADS) {
      int r, c, ci;
      if (d.c_inner) {  // (r, c, ci), ci fastest
        ci = e % d.Cin;
        c = (e / d.Cin) % d.SW;
        r = e / (d.Cin * d.SW);
      } else {  // (r, ci, c), c fastest
        c = e % d.SW;
        ci = (e / d.SW) % d.Cin;
        r = e / (d.SW * d.Cin);
      }
      const U v = r < rows && c < cols ? xb[r * d.sxh + c * d.sxw + ci * d.sxc] : U(0);
      const int at = (r * d.SW + c) * d.Cin + ci;
      if constexpr (Nm::PARTS == 2) {
        uint32_t hi, lo;
        tf32_split(v, hi, lo);
        slab[at] = hi;
        slab[slab_n + at] = lo;
      } else {
        slab[at] = v;
      }
    }
    __syncthreads();

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    if constexpr (Nm::PARTS == 2) {
      const U* sh = slab;
      const U* sl_lo = slab + slab_n;
      for (int box = 0; box < d.kboxes; ++box) {
        const uint8_t* bh = sm + box * B_TILE;
        const uint8_t* bl = sm + (d.kboxes + box) * B_TILE;
        float part[32], sl[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) part[i] = sl[i] = 0.f;
#pragma unroll
        for (int s4 = 0; s4 < Nm::BOX / Nm::SLICE; ++s4) {
          const int kk = 4 * box + s4;
          if (kk < d.kslices) {
            const int ka = koff[kk * 8 + q], kb = koff[kk * 8 + q + 4];
            // a[i]: row pc + 8 (i % 2), column q + 4 (i / 2) of the slice
            uint32_t ah[4], al[4];
            ah[0] = ka < 0 ? 0u : sh[pix0 + ka];
            ah[1] = ka < 0 ? 0u : sh[pix1 + ka];
            ah[2] = kb < 0 ? 0u : sh[pix0 + kb];
            ah[3] = kb < 0 ? 0u : sh[pix1 + kb];
            al[0] = ka < 0 ? 0u : sl_lo[pix0 + ka];
            al[1] = ka < 0 ? 0u : sl_lo[pix1 + ka];
            al[2] = kb < 0 ? 0u : sl_lo[pix0 + kb];
            al[3] = kb < 0 ? 0u : sl_lo[pix1 + kb];
            fence_regs(sl);
            wg_fence();
            Tf32Mma<64>::rs(sl, al, kdesc(bh + 32 * s4), 0);
            Tf32Mma<64>::rs(sl, ah, kdesc(bl + 32 * s4), 1);
            Tf32Mma<64>::rs(sl, ah, kdesc(bh + 32 * s4), 1);
            wg_commit();
            wg_wait<0>();
            fence_regs(sl);
#pragma unroll
            for (int i = 0; i < 32; ++i) part[i] = s4 == 0 ? sl[i] : __fadd_rn(part[i], sl[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
      }
    } else {
      // every slice's fragment first (registers a wgmma reads may not change
      // before it retires), then the slices into one accumulator
      uint32_t a[MAX_K / 16][4];
#pragma unroll
      for (int kk = 0; kk < MAX_K / 16; ++kk) {
        if (kk < d.kslices) {
          // a[kk][i]: row pc + 8 (i % 2), columns 2 q + 8 (i / 2) + {0, 1} of the slice
          const int k0 = kk * 16 + 2 * q;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int pix = i % 2 ? pix1 : pix0;
            const int o0 = koff[k0 + 8 * (i / 2)], o1 = koff[k0 + 8 * (i / 2) + 1];
            const uint32_t lo = o0 < 0 ? 0u : slab[pix + o0];
            const uint32_t hi = o1 < 0 ? 0u : slab[pix + o1];
            a[kk][i] = lo | hi << 16;
          }
        }
      }
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < MAX_K / 16; ++kk)
        if (kk < d.kslices) bf16_rs(acc, a[kk], kdesc(sm + (kk / 4) * B_TILE + 32 * (kk % 4)), 1);
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
    }

    // epilogue: rows pc, pc + 8 of this warp's output row; columns 8 j + 2 q
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int oh = oh0 + pr, ow = ow0 + pc + 8 * i;
      if (oh >= d.OH || ow >= d.OW) continue;
      const long long base =
          ((static_cast<long long>(img) * d.OH + oh) * d.OW + ow) * d.Cout + co0 + 2 * q;
#pragma unroll
      for (int j = 0; j < 8; ++j) store_y<U>(y, base + 8 * j, acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

// ---- host -----------------------------------------------------------------

// the dynamic shared memory of one block (smem_bytes in conv2d_ntx_stem.py)
template <typename U>
int smem_of(const Dims& d) {
  return 1024 + Num<U>::PARTS * d.kboxes * B_TILE + 4 * d.kpad +
         Num<U>::PARTS * d.SR * d.SW * d.Cin * static_cast<int>(sizeof(U));
}

template <typename U>
int launch_t(const void* x, const void* w, void* y, int N, Dims d, cudaStream_t stream) {
  using Nm = Num<U>;
  d.kslices = (d.K + Nm::SLICE - 1) / Nm::SLICE;
  d.kpad = d.kslices * Nm::SLICE;
  d.kboxes = (d.kpad + Nm::BOX - 1) / Nm::BOX;
  const int smem = smem_of<U>(d);
  const long long tiles = static_cast<long long>(N) * d.tiles_h * d.tiles_w;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  d.n_tiles = static_cast<int>(tiles);
  cudaError_t e = cudaFuncSetAttribute(stem_kernel<U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_kernel<U>, THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cout_tiles = d.Cout / BN;
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(
      std::min<long long>(d.n_tiles, std::max<long long>(1, fit / cout_tiles)));
  stem_kernel<U><<<dim3(blocks, cout_tiles), THREADS, smem, stream>>>(
      static_cast<const U*>(x), static_cast<const U*>(w), static_cast<U*>(y), d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, H, W, Cin) fp32 (dtype 0) or bf16 (dtype 1), pre-padded, read through
// its (n, h, w, c) element strides; w (KH, KW, Cin, Cout) contiguous; y (N,
// OH, OW, Cout) contiguous, in x's type. K = KH*KW*Cin at most MAX_K, Cout a
// multiple of 64.
extern "C" int conv2d_ntx_stem(const void* x, const void* w, void* y, int dtype, int N, int H,
                               int W, int KH, int KW, int Cin, int Cout, int stride, int OH,
                               int OW, long long sxn, long long sxh, long long sxw,
                               long long sxc, void* stream) {
  const int K = KH * KW * Cin;
  if ((dtype != 0 && dtype != 1) || K <= 0 || K > MAX_K || Cout % BN || stride < 1 ||
      OH != (H - KH) / stride + 1 || OW != (W - KW) / stride + 1 || H < KH || W < KW)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || Cout == 0) return static_cast<int>(cudaGetLastError());
  Dims d;
  d.H = H;
  d.W = W;
  d.Cin = Cin;
  d.KW = KW;
  d.Cout = Cout;
  d.stride = stride;
  d.OH = OH;
  d.OW = OW;
  d.K = K;
  d.SR = (TR - 1) * stride + KH;
  d.SW = (TC - 1) * stride + KW;
  d.tiles_h = (OH + TR - 1) / TR;
  d.tiles_w = (OW + TC - 1) / TC;
  d.c_inner = sxc <= sxw ? 1 : 0;
  d.sxn = sxn;
  d.sxh = sxh;
  d.sxw = sxw;
  d.sxc = sxc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_t<uint32_t>(x, w, y, N, d, s) : launch_t<uint16_t>(x, w, y, N, d, s);
}

extern "C" const char* conv2d_ntx_stem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// NTX direct convolution for Hopper on the tensor cores, fp32 x and w as
// 3xTF32: NHWC x HWIO -> NHWC, VALID, stride >= 1, as an implicit GEMM on
// wgmma.
//
// Replaces the TPU kernel repro/kernels/conv2d.py::conv2d_ntx (body
// _conv_kernel, pallas_call at :75; per-tap jnp.dot into an fp32 acc_ref)
// for fp32 operands with Cin a multiple of 32 and Cout a multiple of 64; it
// computes what conv2d_ntx.cu computes: per output pixel and channel, the
// sum over (u, v, ci) in that order into fp32, stored once. fp32 with other
// channel counts (GoogLeNet's Cin 3 stem) stays on the FFMA kernel of
// conv2d_ntx.cu.
//
// The GEMM: M = N*OH*OW output pixels, N = Cout, K = KH*KW*Cin, walked in
// stages of 32 input channels of one tap, in the order (u, v, ci).
//
// Bound on the H100: 2 * M * Cout * K FLOPs, each three tf32 products on the
// tensor cores, against x, w and y moved once; at GoogLeNet L1 (batch 32,
// 56 x 56 x 64 -> 192, 3 x 3) 3 x 22.20 GFLOP at 495 TFLOP/s, 0.1345 ms,
// against 105.1 MB (0.0314 ms): the tf32 rate bounds it.
//
// Numerics (PR 22's rule, csrc/ntx_gemm_wgmma.cu): x and w are split into
// hi = tf32_rn(v) and lo = tf32_rn(v - hi), round to nearest even at 10
// mantissa bits; a k8 slice takes lo.hi, hi.lo and hi.hi, summed from zero
// on the tensor cores; the four slices of a stage are summed from zero by
// IEEE adds (__fadd_rn) and the stage's sum is added to the pixel's fp32
// sum by one more. (One IEEE add per slice straight into the pixel's sum
// reads about 1.1x the plain version's RMS error at 3 x 3 and Cin 64 in the
// CPU emulation, kernels/conv2d_ntx_tf32.py::emulate; the stage's own sum
// about 0.7-0.8x.) The order depends neither on the grid nor on tile_h, so
// the bits are the same on every run and for every tile_h.
//
// Design:
//   * w first: a small kernel writes w's split, transposed to two K-major
//     (Cout, K) matrices hi and lo, into the caller's workspace. tf32
//     wgmma has no transpose bit, so B must be K-major; w is small and is
//     read by every CTA, so it is split once per call and not per CTA.
//   * grid: one CTA per BM = 128 output pixels (the flat index over (image,
//     oh, ow)) and one Cout tile of BN = 96 (where Cout is a multiple of 96)
//     or 64 columns. Two consumer warpgroups own 64 pixels each; two
//     producer warps fill a ring of STAGES = 4 stages. No split-K, no
//     atomics, no cross-CTA sum.
//   * A (the pixel gather): each pixel's 128 bytes at tap (u, v) by eight
//     16-byte cp.async from x through x's strides, chunk c of row r to chunk
//     c ^ (r % 8) (the 128-byte swizzle written by hand); pixels past M are
//     zero-filled (src-size 0) and never stored. Each producer thread keeps
//     LAG groups in flight, waits for the oldest and arrives on the stage's
//     full barrier. The consumers split A: each warpgroup reads its 64 rows,
//     writes hi over them and lo into the stage's A_LO tile (the split
//     keeps every element where it is, so the swizzle carries over), fences
//     its stores for the async proxy (fence.proxy.async) and syncs the
//     warpgroup on a named barrier before its wgmma.
//   * B: the hi and lo boxes (32 K x BN rows, 128-byte swizzle) of the
//     workspace by TMA, one 2-D map over the (2 Cout, K) matrix, issued by
//     one producer thread.
//   * products: per stage, slice and warpgroup, three wgmma m64nBNk8 (tf32,
//     fp32 accumulators) into BN / 2 registers a thread; waited for, then
//     added as above. A stage is released (empty barrier) once its last
//     slice has retired.
//   * epilogue: the fp32 sums stored from registers into y (contiguous N,
//     OH, OW, Cout), only for pixels < M.
//
// The wrapper (kernels/conv2d.py, rules in kernels/conv2d_ntx_tf32.py)
// checks that x's channel stride is 1, its pixel strides multiples of 16
// bytes and its base 16-byte aligned, and raises on operands that break
// them: the kernel copies nothing of x.

#include "sm90.cuh"

#include <climits>

namespace {

constexpr int BM = 128;                 // output pixels per CTA: two consumer warpgroups
constexpr int BK = 32;                  // input channels of one tap per stage
constexpr int STAGES = 4;               // ring of A / B stages (smem_bytes in conv2d_ntx_tf32.py)
// cp.async groups a producer thread keeps in flight before it publishes the
// oldest; a consumer releases a stage once it is done with it, so any LAG
// up to STAGES - 1 cannot deadlock
constexpr int LAG = STAGES - 2;
constexpr int CONSUMERS = 256;          // warps 0-7
constexpr int PRODUCERS = 64;           // warps 8-9
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int ROW = 128;                // one swizzled row: 32 fp32
constexpr int A_BYTES = BM * ROW;       // one stage of A, hi or lo
constexpr int ROWS_PER_THREAD = BM * 8 / PRODUCERS;  // pixel rows a producer thread copies into

template <int BN>
struct Layout {
  static constexpr int B_BYTES = BN * ROW;  // one stage of B, hi or lo
  static constexpr int A_LO = A_BYTES, B_HI = 2 * A_BYTES, B_LO = B_HI + B_BYTES;
  static constexpr int STAGE = 2 * (A_BYTES + B_BYTES);
  static constexpr int SMEM = 1024 + STAGES * STAGE;  // + slack to align to 1,024
};

struct Dims {
  int KW, Cout, stride, OH, OW, M, cin_blocks, n_stages;
  long long sxn, sxh, sxw;
};

// the threads of one warpgroup meet at named barrier `id`
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// ---- w's split ------------------------------------------------------------

// w (K, Cout) row-major -> wt (2 Cout, K): rows 0 .. Cout - 1 hi, Cout ..
// 2 Cout - 1 lo, each K-major
__global__ void split_w_kernel(const float* __restrict__ w, float* __restrict__ wt, int K,
                               int Cout) {
  const long long n = static_cast<long long>(K) * Cout;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(i / Cout), co = static_cast<int>(i % Cout);
    uint32_t hi, lo;
    tf32_split(__float_as_uint(w[i]), hi, lo);
    wt[static_cast<long long>(co) * K + k] = __uint_as_float(hi);
    wt[static_cast<long long>(Cout + co) * K + k] = __uint_as_float(lo);
  }
}

// ---- the kernel -----------------------------------------------------------

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
conv_tf32_kernel(const __grid_constant__ CUtensorMap tw, const float* __restrict__ x,
                 float* __restrict__ y, Dims d) {
  using L = Layout<BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], PRODUCERS + 1);  // every producer thread + the TMA's expect_tx
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warps
    const int pt = tid - CONSUMERS;
    const int chunk = pt % 8;  // this thread's 16 bytes of a pixel's row: 4 channels
    const int r0 = pt / 8;     // its rows: r0 + 8 j
    long long base[ROWS_PER_THREAD];  // x offset of each row's pixel at tap (0, 0); -1: past M
#pragma unroll
    for (int j = 0; j < ROWS_PER_THREAD; ++j) {
      const int m = m0 + r0 + 8 * j;
      base[j] = -1;
      if (m < d.M) {
        const int img = m / (d.OH * d.OW);
        const int rem = m - img * d.OH * d.OW;
        const int oh = rem / d.OW, ow = rem - (rem / d.OW) * d.OW;
        base[j] = img * d.sxn + static_cast<long long>(oh) * d.stride * d.sxh +
                  static_cast<long long>(ow) * d.stride * d.sxw + 4 * chunk;
      }
    }
    // rows r0 + 8 j share r0 % 8, so one swizzled offset serves them all
    const int a_off = r0 * ROW + ((chunk ^ (r0 & 7)) << 4);
    for (int t = 0; t < d.n_stages; ++t) {
      const int s = t % STAGES;
      if (t >= STAGES) mbar_wait(&empty[s], (t / STAGES - 1) & 1);  // its last stage was consumed
      uint8_t* st = sm + s * L::STAGE;
      if (pt == 0) {
        mbar_expect_tx(&full[s], 2 * L::B_BYTES);
        tma_load_2d(st + L::B_HI, &tw, &full[s], t * BK, co0);
        tma_load_2d(st + L::B_LO, &tw, &full[s], t * BK, d.Cout + co0);
      }
      const int tap = t / d.cin_blocks;
      const int u = tap / d.KW, v = tap - (tap / d.KW) * d.KW;
      const long long off = u * d.sxh + v * d.sxw + (t - tap * d.cin_blocks) * BK;
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j) {
        const bool live = base[j] >= 0;
        cp_async_16(st + a_off + j * 8 * ROW, live ? x + base[j] + off : x, live ? 16 : 0);
      }
      cp_async_commit();
      if (t >= LAG) {  // stage t - LAG has landed: publish it
        cp_async_wait<LAG>();
        mbar_arrive(&full[(t - LAG) % STAGES]);
      }
    }
    cp_async_wait<0>();
    for (int t = max(0, d.n_stages - LAG); t < d.n_stages; ++t) mbar_arrive(&full[t % STAGES]);
    return;
  }

  // consumers: warpgroup g owns pixels 64 g .. 64 g + 63 of the tile
  const int g = tid / 128, ct = tid % 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < d.n_stages; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    uint8_t* st = sm + s * L::STAGE;
    // split this warpgroup's rows of A: hi over the gathered x, lo in A_LO
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = g * 64 * ROW + (ct + 128 * i) * 16;
      const uint4 v = *reinterpret_cast<const uint4*>(st + off);
      uint32_t h[4], l[4];
      tf32_split(v.x, h[0], l[0]);
      tf32_split(v.y, h[1], l[1]);
      tf32_split(v.z, h[2], l[2]);
      tf32_split(v.w, h[3], l[3]);
      *reinterpret_cast<uint4*>(st + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(st + L::A_LO + off) = make_uint4(l[0], l[1], l[2], l[3]);
    }
    fence_proxy_async();
    warpgroup_sync(1 + g);

    // the stage: per slice of 8 channels lo.hi + hi.lo + hi.hi from zero on
    // the tensor cores, the slices summed from zero, the stage added to acc
    const uint8_t* at = st + g * 64 * ROW;
    float part[BN / 2], sl[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sl[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      fence_regs(sl);
      wg_fence();
      Tf32Mma<BN>::ss(sl, kdesc(at + L::A_LO + 32 * kk), kdesc(st + L::B_HI + 32 * kk), 0);
      Tf32Mma<BN>::ss(sl, kdesc(at + 32 * kk), kdesc(st + L::B_LO + 32 * kk), 1);
      Tf32Mma<BN>::ss(sl, kdesc(at + 32 * kk), kdesc(st + L::B_HI + 32 * kk), 1);
      wg_commit();
      wg_wait<0>();
      fence_regs(sl);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) part[i] = kk == 0 ? sl[i] : __fadd_rn(part[i], sl[i]);
    }
    mbar_arrive(&empty[s]);  // every product of stage t has retired
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
  }

  const int warp = ct / 32, lane = tid % 32;
  const int row = m0 + 64 * g + 16 * warp + lane / 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = row + 8 * i;
    if (m >= d.M) continue;
    float* yr = y + static_cast<long long>(m) * d.Cout + co0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<float2*>(yr + 8 * j) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

// ---- host -----------------------------------------------------------------

// a 2-D map over wt as the (2 Cout, K) matrix, K contiguous: boxes of 32 K
// x BN rows, 128-byte swizzle
int encode_w(CUtensorMap* map, const void* wt, int K, int Cout, int BN) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(2 * Cout)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 4};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(BN)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(wt), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int BN>
int launch_bn(const float* x, const float* w, float* y, float* wt, int K, const Dims& d,
              cudaStream_t stream) {
  using L = Layout<BN>;
  const long long kc = static_cast<long long>(K) * d.Cout;
  const int blocks = static_cast<int>(kc < 1024LL * 256 ? (kc + 255) / 256 : 1024LL);
  split_w_kernel<<<blocks, 256, 0, stream>>>(w, wt, K, d.Cout);
  CUtensorMap tw;
  const int err = encode_w(&tw, wt, K, d.Cout, BN);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      conv_tf32_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((d.M + BM - 1) / BM, d.Cout / BN);
  conv_tf32_kernel<BN><<<grid, THREADS, L::SMEM, stream>>>(tw, x, y, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, H, W, Cin) fp32 read through its (n, h, w) element strides (channel
// stride 1, pixel strides multiples of 4 elements, 16-byte-aligned base);
// w (KH, KW, Cin, Cout) contiguous fp32; y (N, OH, OW, Cout) contiguous
// fp32; ws 2 * KH*KW*Cin * Cout fp32 of workspace (16-byte aligned) for w's
// split. Cin is a multiple of 32, Cout of 64.
extern "C" int conv2d_ntx_f32_tf32(const void* x, const void* w, void* y, void* ws, int N,
                                   int KH, int KW, int Cin, int Cout, int stride, int OH, int OW,
                                   long long sxn, long long sxh, long long sxw, void* stream) {
  if (Cin % BK || Cout % 64 || stride < 1 || ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long m = static_cast<long long>(N) * OH * OW;
  if (m > INT_MAX - BM) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || Cout == 0) return static_cast<int>(cudaGetLastError());
  Dims d;
  d.KW = KW;
  d.Cout = Cout;
  d.stride = stride;
  d.OH = OH;
  d.OW = OW;
  d.M = static_cast<int>(m);
  d.cin_blocks = Cin / BK;
  d.n_stages = KH * KW * Cin / BK;
  d.sxn = sxn;
  d.sxh = sxh;
  d.sxw = sxw;
  const int K = KH * KW * Cin;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  float* wt = static_cast<float*>(ws);
  return Cout % 96 == 0 ? launch_bn<96>(xf, wf, yf, wt, K, d, s)
                        : launch_bn<64>(xf, wf, yf, wt, K, d, s);
}

extern "C" const char* conv2d_ntx_tf32_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

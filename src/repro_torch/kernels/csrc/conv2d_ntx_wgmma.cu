// NTX direct convolution for Hopper on the tensor cores, bf16 x and w:
// NHWC x HWIO -> NHWC, VALID, stride >= 1, as an implicit GEMM on wgmma.
//
// Replaces the TPU kernel repro/kernels/conv2d.py::conv2d_ntx (body
// _conv_kernel, pallas_call at :75) for bf16 operands with Cin and Cout
// multiples of 64; it computes what conv2d_ntx.cu computes: per output
// pixel and channel, the sum over the taps (u, v) of the Cin contraction,
// in an fp32 accumulator (the TPU kernel's preferred_element_type=float32),
// rounded once to bf16 at the store. fp32 operands, and bf16 with other
// channel counts (GoogLeNet's Cin 3 stem), stay on the FFMA kernel of
// conv2d_ntx.cu.
//
// The GEMM: M = N*OH*OW output pixels, N = Cout, K = KH*KW*Cin, walked in
// the order (u, v, ci), as the TPU kernel and conv2d_ntx.cu walk it.
//
// Bound on the H100: 2 * M * Cout * K FLOPs against x, w and y moved once;
// at GoogLeNet L1 (batch 32, 56 x 56 x 64 -> 192, 3 x 3) 22.20 GFLOP and
// 52.5 MB, some 420 FLOPs a byte, so the bf16 tensor-core rate bounds it:
// 0.02244 ms at 989 TFLOP/s.
//
// Design:
//   * grid: one CTA per BM = 128 output pixels (the flat index over
//     (image, oh, ow)) and one Cout tile of BN = 192 (where Cout is a
//     multiple of 192) or 64 columns. Two consumer warpgroups own 64 pixels
//     each; a producer warpgroup fills a ring of STAGES = 4 stages. No
//     split-K, no atomics, no cross-CTA sum: every output is summed by one
//     CTA in one order that depends neither on the grid nor on tile_h, so
//     the bits are the same on every run and for every tile_h.
//   * K stages: one stage is 64 input channels of one tap, so a stage's A
//     tile is one 128-byte row per pixel (K-major) and its B tile 64 rows of
//     w. Rows sit under the 128-byte swizzle; every tile starts on 1,024
//     bytes, so the hand-written swizzle of A, TMA's swizzle of B and the
//     wgmma descriptors' (layout type 1, 128B) agree.
//   * A (the pixel gather): the 128 producer threads copy each pixel's 128
//     bytes at tap (u, v) by eight 16-byte cp.async from x through x's
//     strides, chunk c of row r to chunk c ^ (r % 8) (the 128-byte swizzle
//     written by hand). Pixels past M are zero-filled (src-size 0) and never
//     stored. Hopper's TMA im2col mode was not taken: its box walks a
//     rectangle of one image's pixels, so a tile of 128 flat pixels that
//     crosses output rows or images needs several boxes, and its bounding
//     corners cap the filter size per map; a gather by cp.async reads any
//     stride and any tile with the same code. Each producer thread keeps
//     LAG groups in flight, waits for the oldest, makes its copies visible
//     to the async proxy (fence.proxy.async) and arrives on the stage's
//     full barrier.
//   * B (w): the (K, Cout) row-major matrix, N contiguous, MN-major, by a
//     2-D TMA map (boxes of 64 Cout x 64 K rows, 128-byte swizzle) issued by
//     one producer thread; the wgmma reads it under the transpose bit
//     (LBO = the next 64-column box, SBO = 8 rows), as
//     flash_attention_wgmma.cu reads v.
//   * products: per stage and warpgroup, four wgmma m64nBNk16 (bf16 x bf16
//     -> fp32, exact products, fp32 sums) into BN / 2 accumulator registers
//     a thread; one committed group stays in flight while the next stage's
//     is issued, and a stage is released (empty barrier) once its products
//     have retired. Accumulator registers are pinned around issue and retire.
//   * epilogue: each accumulator is rounded once with __floats2bfloat162_rn
//     (round to nearest even, as __float2bfloat16_rn) and stored from
//     registers into y (contiguous N, OH, OW, Cout), only for pixels < M.
//
// The wrapper (kernels/conv2d.py, rules in kernels/conv2d_ntx_wgmma.py)
// checks that x's channel stride is 1, its pixel strides multiples of 16
// bytes and its base and w's 16-byte aligned, and raises on operands that
// break them: the kernel copies nothing.

#include "sm90.cuh"

#include <climits>

namespace {

constexpr int BM = 128;                  // output pixels per CTA: two consumer warpgroups
constexpr int BK = 64;                   // input channels of one tap per stage
constexpr int STAGES = 4;                // ring of A / B stages (smem_bytes in conv2d_ntx_wgmma.py)
// cp.async groups a producer thread keeps in flight before it publishes the
// oldest. A consumer releases stage t - 1 only once it holds stage t, so the
// producer, which waits for stage t - STAGES to be released before it issues
// stage t, must have published stage t - STAGES + 1 by then: LAG <= STAGES - 2.
constexpr int LAG = STAGES - 2;
constexpr int CONSUMERS = 256;           // warps 0-7
constexpr int PRODUCERS = 128;           // warps 8-11
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int ROW_BYTES = 128;           // one swizzled row: 64 bf16
constexpr int A_BYTES = BM * ROW_BYTES;  // one stage of A
constexpr int ROWS_PER_THREAD = BM * 8 / PRODUCERS;  // pixel rows a producer thread copies into

template <int BN>
struct Layout {
  static constexpr int B_BYTES = BK * BN * 2;  // one stage of B: BN / 64 boxes of 8 KB
  static constexpr int B_OFF = STAGES * A_BYTES;
  static constexpr int SMEM = 1024 + STAGES * (A_BYTES + B_BYTES);  // + slack to align to 1,024
};

struct Dims {
  int KW, Cout, stride, OH, OW, M, cin_blocks, n_stages;
  long long sxn, sxh, sxw;
};

// ---- wgmma ----------------------------------------------------------------

// d[64 x BN] += a[64 x 16] b[16 x BN]: a K-major, b MN-major (transpose
// bit), both from shared memory; thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 + 8 i, columns 8 j + 2 (t % 4) + c in register
// 4 j + 2 i + c
template <int BN>
struct Mma;

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<192> {
  static __device__ __forceinline__ void run(float (&d)[96], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(a), "l"(b), "r"(1));
  }
};

// ---- the kernel -----------------------------------------------------------

template <int BN>
__global__ void __launch_bounds__(THREADS, BN == 64 ? 2 : 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap tw, const __nv_bfloat16* __restrict__ x,
                  __nv_bfloat16* __restrict__ y, Dims d) {
  using L = Layout<BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  // swizzled tiles start on 1,024 bytes: the A ring, then the B ring
  uint8_t* as = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* bs = as + L::B_OFF;

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

  if (tid >= CONSUMERS) {  // the producer warpgroup
    const int pt = tid - CONSUMERS;
    const int chunk = pt % 8;  // this thread's 16 bytes of a pixel's row: 8 channels
    const int r0 = pt / 8;     // its rows: r0 + 16 j
    long long base[ROWS_PER_THREAD];  // x offset of each row's pixel at tap (0, 0); -1: past M
#pragma unroll
    for (int j = 0; j < ROWS_PER_THREAD; ++j) {
      const int m = m0 + r0 + 16 * j;
      base[j] = -1;
      if (m < d.M) {
        const int img = m / (d.OH * d.OW);
        const int rem = m - img * d.OH * d.OW;
        const int oh = rem / d.OW, ow = rem - (rem / d.OW) * d.OW;
        base[j] = img * d.sxn + static_cast<long long>(oh) * d.stride * d.sxh +
                  static_cast<long long>(ow) * d.stride * d.sxw + 8 * chunk;
      }
    }
    // rows r0 + 16 j share r0 % 8, so one swizzled offset serves them all
    const int a_off = r0 * ROW_BYTES + ((chunk ^ (r0 & 7)) << 4);
    for (int t = 0; t < d.n_stages; ++t) {
      const int s = t % STAGES;
      if (t >= STAGES) mbar_wait(&empty[s], (t / STAGES - 1) & 1);  // its last stage was consumed
      if (pt == 0) {
        mbar_expect_tx(&full[s], L::B_BYTES);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(bs + s * L::B_BYTES + c * BK * ROW_BYTES, &tw, &full[s], co0 + 64 * c,
                      t * BK);
      }
      const int tap = t / d.cin_blocks;
      const int u = tap / d.KW, v = tap - (tap / d.KW) * d.KW;
      const long long off = u * d.sxh + v * d.sxw + (t - tap * d.cin_blocks) * BK;
      uint8_t* at = as + s * A_BYTES + a_off;
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j) {
        const bool live = base[j] >= 0;
        cp_async_16(at + j * 16 * ROW_BYTES, live ? x + base[j] + off : x, live ? 16 : 0);
      }
      cp_async_commit();
      if (t >= LAG) {  // stage t - LAG has landed: publish it
        cp_async_wait<LAG>();
        fence_proxy_async();
        mbar_arrive(&full[(t - LAG) % STAGES]);
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    for (int t = max(0, d.n_stages - LAG); t < d.n_stages; ++t) mbar_arrive(&full[t % STAGES]);
    return;
  }

  // consumers: warpgroup g owns pixels 64 g .. 64 g + 63 of the tile
  const int g = tid / 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < d.n_stages; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const uint8_t* at = as + s * A_BYTES + g * 64 * ROW_BYTES;
    const uint8_t* bt = bs + s * L::B_BYTES;
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)  // 16 channels a slice: 32 bytes along A's row, 16 rows of B
      Mma<BN>::run(acc, desc(at + kk * 32, 16, 8 * ROW_BYTES),
                   desc(bt + kk * 16 * ROW_BYTES, BK * ROW_BYTES, 8 * ROW_BYTES));
    wg_commit();
    wg_wait<1>();  // the products of stage t - 1 have retired
    fence_regs(acc);
    if (t > 0) mbar_arrive(&empty[(t - 1) % STAGES]);
  }
  wg_wait<0>();
  fence_regs(acc);

  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int row = m0 + 64 * g + 16 * warp + lane / 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = row + 8 * i;
    if (m >= d.M) continue;
    __nv_bfloat16* yr = y + static_cast<long long>(m) * d.Cout + co0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(yr + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

// ---- host -----------------------------------------------------------------

// a 2-D map over w as the (K, Cout) matrix, Cout contiguous: boxes of 64
// Cout x 64 K rows, 128-byte swizzle
int encode_w(CUtensorMap* map, const void* w, int K, int Cout) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Cout), static_cast<cuuint64_t>(K)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Cout) * 2};
  const cuuint32_t box[2] = {64, BK};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int BN>
int launch_bn(const void* x, const void* w, void* y, int K, const Dims& d, cudaStream_t stream) {
  using L = Layout<BN>;
  CUtensorMap tw;
  const int err = encode_w(&tw, w, K, d.Cout);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      conv_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((d.M + BM - 1) / BM, d.Cout / BN);
  conv_wgmma_kernel<BN><<<grid, THREADS, L::SMEM, stream>>>(
      tw, static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, H, W, Cin) bf16 read through its (n, h, w) element strides (channel
// stride 1, pixel strides multiples of 8 elements, 16-byte-aligned base);
// w (KH, KW, Cin, Cout) contiguous bf16 with a 16-byte-aligned base; y
// (N, OH, OW, Cout) contiguous bf16. Cin and Cout are multiples of 64.
extern "C" int conv2d_ntx_bf16_wgmma(const void* x, const void* w, void* y, int N, int KH,
                                     int KW, int Cin, int Cout, int stride, int OH, int OW,
                                     long long sxn, long long sxh, long long sxw, void* stream) {
  if (Cin % BK || Cout % 64 || stride < 1) return static_cast<int>(cudaErrorInvalidValue);
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
  return Cout % 192 == 0 ? launch_bn<192>(x, w, y, K, d, s) : launch_bn<64>(x, w, y, K, d, s);
}

extern "C" const char* conv2d_ntx_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Mamba-2 SSD chunked scan for Hopper on the tensor cores, bf16 x, b, c:
// y = SSD(x, la, b, c), y (B, H, S, P) in bf16.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (body
// _ssd_kernel, pallas_call at :102) for bf16 operands with P a multiple of
// 64, N a multiple of 64 up to 256 and chunks of Q = 64 or 128 tokens; it
// computes what ssd_scan.cu computes. Per chunk of Q tokens, with the
// inclusive cumsum cum of the log decay la and total = cum[Q - 1]:
//
//   y[i]  = sum_{j<=i} exp(cum_i - cum_j) (c_i . b_j) x_j     intra-chunk
//         + exp(cum_i) (h c_i)                                 inter-chunk
//   h     = exp(total) h + sum_j exp(total - cum_j) x_j b_j^T  (P x N, fp32)
//
// fp32 operands, and bf16 at other shapes, stay on the FFMA kernel of
// ssd_scan.cu.
//
// Bound on the H100: x, la, b, c read once and y written once, 53.22 MB at
// the Mamba-2 780M prefill shape (B 2, H 48, G 1, S 2,048, P 64, N 128),
// 0.01589 ms at 3.35 TB/s; its 8.22 GFLOP of dual-form products take 0.00831
// ms at the bf16 tensor-core rate. The workspace (53.5 MB there, most of it
// the chunk states) is this design's own traffic and not in the bound.
//
// Design: the TPU kernel walks the chunks of one (b, h) in order and carries
// the state in VMEM. Here the chunks run in parallel, in four passes on the
// caller's stream, each a grid of its own:
//   1. states, one CTA per (chunk, h, b) and 64 rows of P: cum in order, in
//      fp32, by one thread (written to the workspace, so later passes read
//      the same bits); the chunk's own state S_c = X^T (w o B), w_j =
//      exp(total - cum_j), on wgmma: X^T is the MN-major A operand (X as
//      TMA loads it, P contiguous, transpose bit), w o B the MN-major B.
//   2. cb, one CTA per (chunk, g, b): CB = C B^T (Q x Q, fp32), once per
//      group and not per head, only its 64 x 64 tiles on or below the
//      diagonal.
//   3. scan, over (b, h, 4 state elements): h_in[c] = h; h = exp(total_c) h
//      + S_c in fp32, chunk after chunk, written over S_c in place
//      (ssd_chunk_scan in ssd_scan_common.cuh, shared with the fp32 kernel).
//   4. out, one CTA per (chunk, h, b) and 64 columns of P, Q / 64 consumer
//      warpgroups of 64 rows: y = exp(cum_i) (C h_in^T) + (CB o decay) X,
//      decay_ij = exp(cum_i - cum_j) evaluated only for j <= i: above the
//      diagonal it overflows at strong decay, so it is selected, never
//      multiplied by a mask. K tiles wholly above the diagonal are not
//      issued: warpgroup w walks w + 1 of them, in a loop without a branch
//      around its wgmma. y is rounded once to bf16 at the store.
// No float atomics, no reduction across CTAs: the same bits run to run, and
// strided operands give the bits of contiguous ones.
//
// Numerics: the TPU kernel keeps every operand of a product in fp32. A bf16
// x bf16 product is exact in fp32, so c b^T, x^T (.) and C (.) run on bf16
// wgmma as they are. Each fp32 operand (w o b, the state h_in, the
// decay-weighted scores) enters as two bf16 terms, hi = bf16(v) and lo =
// bf16(v - hi) (v - hi is exact in fp32; the pair keeps about 16 bits of
// v), whose products sum in the fp32 accumulator. Products that feed a
// split are rounded by __fmul_rn, so that no FMA folds them into v - hi.
//
// Loads: x, b and c by TMA through 4-D maps over (inner, S, heads or
// groups, B) built from the operands' own strides, so ssm_block's transposed
// views load with no copy; rows are 64 bf16 = 128 bytes under the 128-byte
// swizzle, every tile on 1,024 bytes. la and the fp32 workspace by plain
// loads. The splits are written by threads into swizzled tiles (chunk c of
// row r at chunk c ^ r % 8) and made visible to wgmma by fence.proxy.async.
//
// The wrapper (kernels/ssd_scan.py, rules in kernels/ssd_scan_wgmma.py)
// checks TMA's rules on x, b and c (16-byte-aligned bases, unit last stride,
// other strides multiples of 16 bytes), allocates the workspace and raises
// on what the kernel does not take.

#include "ssd_scan_common.cuh"

namespace {

constexpr int BOX = 64;          // columns of a TMA box, rows and columns of a wgmma tile
constexpr int ROW_BYTES = 128;   // one swizzled row: 64 bf16
constexpr int SLICE = 16;        // K of one wgmma
constexpr int STATE_THREADS = 256;  // two warpgroups deal out the N tiles of a state

// ---- wgmma m64n64k16, bf16 x bf16 -> fp32 ---------------------------------
// thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 + 8 i,
// columns 8 j + 2 (t % 4) + c of the accumulator in register 4 j + 2 i + c

#define SSD_ACC                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define SSD_D32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d += a b, a and b from shared memory; TA / TB 1: MN-major (transpose bit)
template <int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSD_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : SSD_ACC
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// d += a b, a from four registers (two bf16 each, the lower column in the
// low half), b MN-major from shared memory
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSD_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SSD_ACC
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// K-major tile: a k16 slice is the row start + 32 bytes a slice, 8-row groups 1,024 bytes apart
__device__ __forceinline__ uint64_t kmajor(const uint8_t* p) { return desc(p, 16, 8 * ROW_BYTES); }
// MN-major tile: a k16 slice is 16 rows; 8-row groups 1,024 bytes apart
__device__ __forceinline__ uint64_t mnmajor(const uint8_t* p, uint32_t box_bytes) {
  return desc(p, box_bytes, 8 * ROW_BYTES);
}

// two floats as two bf16 terms each: hi = bf16(v), lo = bf16(v - hi), packed in pairs
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the byte offset of 16-byte chunk `ch` of row `r` in a tile under the 128-byte swizzle
__device__ __forceinline__ int swizzled(int r, int ch) { return r * ROW_BYTES + ((ch ^ (r & 7)) << 4); }

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void init_barrier(uint64_t* bar) {
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// ---- pass 1: cum and the chunk states ---------------------------------------

// grid (NC * P / 64, H, B). Shared memory: the X tile (Q rows of 64 P), the
// B tile (N / 64 boxes of Q rows; w o b's hi term written over it in place)
// and w o b's lo term.
template <int Q>
__global__ void __launch_bounds__(STATE_THREADS)
ssd_wgmma_states(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                 const float* __restrict__ la, float* __restrict__ cum_ws,
                 float* __restrict__ st_ws, Dims d) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full;
  __shared__ float cum[Q], wt[Q];
  const int NB = d.N / BOX, TILE = Q * ROW_BYTES;  // one box of Q rows
  uint8_t* xs = align1024(smem_raw);
  uint8_t* bs = xs + TILE;
  uint8_t* ls = bs + NB * TILE;
  const int c = blockIdx.x % d.NC, pt = blockIdx.x / d.NC;
  const int h = blockIdx.y, bi = blockIdx.z, g = h / (d.H / d.G);
  const int tid = threadIdx.x;

  init_barrier(&full);
  if (tid == 0) {
    mbar_expect_tx(&full, (1 + NB) * TILE);
    tma_load_4d(xs, &tx, &full, BOX * pt, c * Q, h, bi);
    for (int kb = 0; kb < NB; ++kb) tma_load_4d(bs + kb * TILE, &tb, &full, BOX * kb, c * Q, g, bi);
  }
  const float* lb = la + bi * d.sla[0] + h * d.sla[1] + static_cast<long long>(c) * Q * d.sla[2];
  for (int i = tid; i < Q; i += STATE_THREADS) cum[i] = lb[i * d.sla[2]];
  __syncthreads();
  if (tid == 0) {  // inclusive cumsum, in order
    float s = 0.f;
#pragma unroll 8
    for (int i = 0; i < Q; ++i) {
      s += cum[i];
      cum[i] = s;
    }
  }
  __syncthreads();
  const float total = cum[Q - 1];
  float* cb = cum_ws + (static_cast<long long>(bi) * d.H + h) * d.S + c * Q;
  for (int i = tid; i < Q; i += STATE_THREADS) {
    wt[i] = expf(total - cum[i]);
    if (pt == 0) cb[i] = cum[i];
  }
  __syncthreads();
  mbar_wait(&full, 0);

  // w o b as two bf16 terms: the 128-byte swizzle keeps each 16-byte chunk in
  // its row, so row j of a chunk is its offset / 128 within the box
  for (int o = 16 * tid; o < NB * TILE; o += 16 * STATE_THREADS) {
    const uint4 v = *reinterpret_cast<const uint4*>(bs + o);
    const float w = wt[(o % TILE) / ROW_BYTES];
    const __nv_bfloat162* pv = reinterpret_cast<const __nv_bfloat162*>(&v);
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      split2(__fmul_rn(w, __low2float(pv[k])), __fmul_rn(w, __high2float(pv[k])), hi[k], lo[k]);
    *reinterpret_cast<uint4*>(bs + o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(ls + o) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  fence_proxy_async();
  __syncthreads();

  // S[p][n] = sum_j x[j][p] (w o b)[j][n], one 64 x 64 tile per N box
  const int wg = tid / 128, lt = tid % 128;
  float* sb = st_ws + ((static_cast<long long>(bi) * d.H + h) * d.NC + c) * d.P * d.N +
              static_cast<long long>(BOX) * pt * d.N;
  for (int nt = wg; nt < NB; nt += STATE_THREADS / 128) {
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < Q / SLICE; ++kk)
      mma_ss<1, 1>(acc, mnmajor(xs + kk * SLICE * ROW_BYTES, TILE),
                   mnmajor(bs + nt * TILE + kk * SLICE * ROW_BYTES, TILE));
#pragma unroll
    for (int kk = 0; kk < Q / SLICE; ++kk)
      mma_ss<1, 1>(acc, mnmajor(xs + kk * SLICE * ROW_BYTES, TILE),
                   mnmajor(ls + nt * TILE + kk * SLICE * ROW_BYTES, TILE));
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    store_tile(sb + BOX * nt, d.N, acc, lt);
  }
}

// ---- pass 2: c b^T once per group --------------------------------------------

// grid (NC, G, B), Q / 64 warpgroups: warpgroup w computes the tiles (w, jt),
// jt <= w, of CB = C B^T, K = N in boxes of 64
template <int Q>
__global__ void __launch_bounds__(Q * 2)
ssd_wgmma_cb(const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap tb,
             float* __restrict__ cb_ws, Dims d) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full;
  const int NB = d.N / BOX, TILE = Q * ROW_BYTES;
  uint8_t* cs = align1024(smem_raw);
  uint8_t* bs = cs + NB * TILE;
  const int c = blockIdx.x, g = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x;

  init_barrier(&full);
  if (tid == 0) {
    mbar_expect_tx(&full, 2 * NB * TILE);
    for (int kb = 0; kb < NB; ++kb) {
      tma_load_4d(cs + kb * TILE, &tc, &full, BOX * kb, c * Q, g, bi);
      tma_load_4d(bs + kb * TILE, &tb, &full, BOX * kb, c * Q, g, bi);
    }
  }
  mbar_wait(&full, 0);

  const int wg = tid / 128, lt = tid % 128;
  float* out = cb_ws + ((static_cast<long long>(bi) * d.G + g) * d.NC + c) * Q * Q;
  for (int jt = 0; jt <= wg; ++jt) {
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int kb = 0; kb < NB; ++kb) {
      const uint8_t* a = cs + kb * TILE + wg * BOX * ROW_BYTES;
      const uint8_t* b = bs + kb * TILE + jt * BOX * ROW_BYTES;
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int s = 0; s < BOX / SLICE; ++s) mma_ss<0, 0>(acc, kmajor(a + 32 * s), kmajor(b + 32 * s));
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
    }
    store_tile(out + wg * BOX * Q + jt * BOX, Q, acc, lt);
  }
}

// ---- pass 4: y -----------------------------------------------------------------

// grid (NC * P / 64, H, B), Q / 64 consumer warpgroups of 64 rows. Shared
// memory: the C tile (N / 64 boxes of Q rows), the X tile (Q rows of 64 P),
// and h_in's two terms (N / 64 boxes of 64 rows of P, K-major).
template <int Q>
__global__ void __launch_bounds__(Q * 2)
ssd_wgmma_out(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tc,
              const float* __restrict__ cum_ws, const float* __restrict__ cb_ws,
              const float* __restrict__ st_ws, __nv_bfloat16* __restrict__ y, Dims d) {
  constexpr int THREADS = Q * 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full;
  __shared__ __align__(16) float cum[Q];
  const int NB = d.N / BOX, TILE = Q * ROW_BYTES, HTILE = BOX * ROW_BYTES;
  uint8_t* cs = align1024(smem_raw);
  uint8_t* xs = cs + NB * TILE;
  uint8_t* hh = xs + TILE;
  uint8_t* hl = hh + NB * HTILE;
  const int c = blockIdx.x % d.NC, pt = blockIdx.x / d.NC;
  const int h = blockIdx.y, bi = blockIdx.z, g = h / (d.H / d.G);
  const int tid = threadIdx.x;

  init_barrier(&full);
  if (tid == 0) {
    mbar_expect_tx(&full, (NB + 1) * TILE);
    for (int kb = 0; kb < NB; ++kb) tma_load_4d(cs + kb * TILE, &tc, &full, BOX * kb, c * Q, g, bi);
    tma_load_4d(xs, &tx, &full, BOX * pt, c * Q, h, bi);
  }
  const long long bh = static_cast<long long>(bi) * d.H + h;
  for (int i = tid; i < Q; i += THREADS) cum[i] = cum_ws[bh * d.S + c * Q + i];
  // h_in (rows p of this tile, N contiguous) as two bf16 terms, K-major
  const float* hb = st_ws + (bh * d.NC + c) * d.P * d.N + static_cast<long long>(BOX) * pt * d.N;
  const int chunks = d.N / 8;  // 16-byte chunks of bf16 per row
  for (int e = tid; e < BOX * chunks; e += THREADS) {
    const int p = e / chunks, ch = e % chunks;
    const float4 v0 = *reinterpret_cast<const float4*>(hb + p * d.N + 8 * ch);
    const float4 v1 = *reinterpret_cast<const float4*>(hb + p * d.N + 8 * ch + 4);
    uint32_t hi[4], lo[4];
    split2(v0.x, v0.y, hi[0], lo[0]);
    split2(v0.z, v0.w, hi[1], lo[1]);
    split2(v1.x, v1.y, hi[2], lo[2]);
    split2(v1.z, v1.w, hi[3], lo[3]);
    const int off = (ch / 8) * HTILE + swizzled(p, ch % 8);
    *reinterpret_cast<uint4*>(hh + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(hl + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  fence_proxy_async();
  __syncthreads();
  mbar_wait(&full, 0);

  const int wg = tid / 128, lt = tid % 128;
  const int warp = lt / 32, lane = lt % 32, t4 = lane % 4;
  const int i0 = BOX * wg + 16 * warp + lane / 4, i1 = i0 + 8;  // this thread's rows
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  // inter-chunk: C h_in^T, K = N in boxes of 64, hi then lo term
  for (int kb = 0; kb < NB; ++kb) {
    const uint8_t* a = cs + kb * TILE + wg * HTILE;
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int s = 0; s < BOX / SLICE; ++s)
      mma_ss<0, 0>(acc, kmajor(a + 32 * s), kmajor(hh + kb * HTILE + 32 * s));
#pragma unroll
    for (int s = 0; s < BOX / SLICE; ++s)
      mma_ss<0, 0>(acc, kmajor(a + 32 * s), kmajor(hl + kb * HTILE + 32 * s));
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
  }
  const float ci0 = cum[i0], ci1 = cum[i1];
  const float e0 = expf(ci0), e1 = expf(ci1);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[4 * j] *= e0;
    acc[4 * j + 1] *= e0;
    acc[4 * j + 2] *= e1;
    acc[4 * j + 3] *= e1;
  }

  // intra-chunk: (CB o decay) X over the K tiles on or below the diagonal;
  // the A fragment of slice kk, register r: row i0 (r even) or i1, columns
  // 16 kk + 8 (r / 2) + 2 (lane % 4) + {0, 1}
  const float* cbw = cb_ws + ((static_cast<long long>(bi) * d.G + g) * d.NC + c) * Q * Q;
  for (int kt = 0; kt <= wg; ++kt) {
    uint32_t ah[16], al[16];
#pragma unroll
    for (int s = 0; s < BOX / SLICE; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = r & 1 ? i1 : i0;
        const float crow = r & 1 ? ci1 : ci0;
        const int col = BOX * kt + SLICE * s + 8 * (r / 2) + 2 * t4;
        const float2 v = *reinterpret_cast<const float2*>(cbw + row * Q + col);
        const float2 cc = *reinterpret_cast<const float2*>(cum + col);
        // select, never multiply by a mask: exp above the diagonal may be inf
        const float d0 = col <= row ? __fmul_rn(v.x, expf(crow - cc.x)) : 0.f;
        const float d1 = col + 1 <= row ? __fmul_rn(v.y, expf(crow - cc.y)) : 0.f;
        split2(d0, d1, ah[4 * s + r], al[4 * s + r]);
      }
    const uint8_t* b = xs + kt * BOX * ROW_BYTES;
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int s = 0; s < BOX / SLICE; ++s) mma_rs(acc, ah + 4 * s, mnmajor(b + s * SLICE * ROW_BYTES, TILE));
#pragma unroll
    for (int s = 0; s < BOX / SLICE; ++s) mma_rs(acc, al + 4 * s, mnmajor(b + s * SLICE * ROW_BYTES, TILE));
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
  }

  __nv_bfloat16* yb = y + (bh * d.S + c * Q) * d.P + BOX * pt;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? i1 : i0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(yb + static_cast<long long>(row) * d.P + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

// ---- host ----------------------------------------------------------------------

// a 4-D map over (inner, S, heads or groups, B) of x, b or c from its element
// strides (B, heads, S, inner order; the inner stride is 1), boxes of 64
// columns x `rows`, 128-byte swizzle
int encode(CUtensorMap* map, const void* ptr, int inner, int s, int h, int b,
           const long long* st, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {BOX, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// dynamic shared memory of each pass (smem_bytes in kernels/ssd_scan_wgmma.py)
int states_smem(int Q, int N) { return 1024 + Q * ROW_BYTES * (1 + 2 * (N / BOX)); }
int cb_smem(int Q, int N) { return 1024 + 2 * (N / BOX) * Q * ROW_BYTES; }
int out_smem(int Q, int N) { return 1024 + Q * ROW_BYTES * (1 + N / BOX) + 2 * N * ROW_BYTES; }

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int Q>
int launch_q(const void* x, const void* la, const void* b, const void* c, void* y, float* ws,
             const Dims& d, const long long* st, cudaStream_t stream) {
  CUtensorMap tx, tb, tc;
  int err = encode(&tx, x, d.P, d.S, d.H, d.B, st, Q);
  if (!err) err = encode(&tb, b, d.N, d.S, d.G, d.B, st + 7, Q);
  if (!err) err = encode(&tc, c, d.N, d.S, d.G, d.B, st + 11, Q);
  if (err) return err;
  float* cum_ws = ws;
  float* cb_ws = cum_ws + static_cast<long long>(d.B) * d.H * d.S;
  float* st_ws = cb_ws + static_cast<long long>(d.B) * d.G * d.NC * Q * Q;
  const int s1 = states_smem(Q, d.N), s2 = cb_smem(Q, d.N), s4 = out_smem(Q, d.N);
  cudaError_t e = allow_smem(ssd_wgmma_states<Q>, s1);
  if (e == cudaSuccess) e = allow_smem(ssd_wgmma_cb<Q>, s2);
  if (e == cudaSuccess) e = allow_smem(ssd_wgmma_out<Q>, s4);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ptiles = d.P / BOX;
  ssd_wgmma_states<Q><<<dim3(d.NC * ptiles, d.H, d.B), STATE_THREADS, s1, stream>>>(
      tx, tb, static_cast<const float*>(la), cum_ws, st_ws, d);
  ssd_wgmma_cb<Q><<<dim3(d.NC, d.G, d.B), Q * 2, s2, stream>>>(tc, tb, cb_ws, d);
  const int per = d.P * d.N / 4;
  ssd_chunk_scan<<<dim3((per + SCAN_THREADS - 1) / SCAN_THREADS, d.H, d.B), SCAN_THREADS, 0,
                   stream>>>(cum_ws, st_ws, d);
  ssd_wgmma_out<Q><<<dim3(d.NC * ptiles, d.H, d.B), Q * 2, s4, stream>>>(
      tx, tc, cum_ws, cb_ws, st_ws, static_cast<__nv_bfloat16*>(y), d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dims: B, H, G, S, P, N, Q, then the element strides of x (4), la (3), b
// (4) and c (4). x, b, c are bf16 with unit last strides, 16-byte-aligned
// bases and the other strides multiples of 8 elements (TMA's rules; the
// wrapper checks them); la is fp32 with any strides; y is a contiguous
// (B, H, S, P) bf16; ws holds B H S + B G (S / Q) Q Q + B H (S / Q) P N
// fp32 (cum, CB, the chunk states). P and N are multiples of 64, N at most
// 256, Q is 64 or 128 and divides S.
extern "C" int ssd_scan_bf16_wgmma(const void* x, const void* la, const void* b, const void* c,
                                   void* y, void* ws, const long long* dims, void* stream) {
  Dims d;
  d.B = static_cast<int>(dims[0]);
  d.H = static_cast<int>(dims[1]);
  d.G = static_cast<int>(dims[2]);
  d.S = static_cast<int>(dims[3]);
  d.P = static_cast<int>(dims[4]);
  d.N = static_cast<int>(dims[5]);
  d.Q = static_cast<int>(dims[6]);
  for (int k = 0; k < 3; ++k) d.sla[k] = dims[11 + k];
  if (d.P % BOX || d.N % BOX || d.N > 4 * BOX || d.P == 0 || d.N == 0 || d.G == 0 ||
      d.H % d.G || (d.Q != 64 && d.Q != 128) || d.S % d.Q)
    return static_cast<int>(cudaErrorInvalidValue);
  d.NC = d.S / d.Q;
  if (d.B * d.H == 0 || d.S == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  return d.Q == 64 ? launch_q<64>(x, la, b, c, y, w, d, dims + 7, s)
                   : launch_q<128>(x, la, b, c, y, w, d, dims + 7, s);
}

extern "C" const char* ssd_scan_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

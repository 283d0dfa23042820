// Mamba-2 SSD chunked scan for Hopper on the tensor cores, fp32 x, b, c as
// 3xTF32: y = SSD(x, la, b, c), y (B, H, S, P) in fp32.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (body
// _ssd_kernel, pallas_call at :102) for fp32 operands with P a multiple of
// 64, N a multiple of 64 up to 256 and chunks of Q = 64 or 128 tokens; it
// computes what ssd_scan.cu computes. Per chunk of Q tokens, with the
// inclusive cumsum cum of the log decay la and total = cum[Q - 1]:
//
//   y[i]  = sum_{j<=i} exp(cum_i - cum_j) (c_i . b_j) x_j     intra-chunk
//         + exp(cum_i) (h c_i)                                 inter-chunk
//   h     = exp(total) h + sum_j exp(total - cum_j) x_j b_j^T  (P x N, fp32)
//
// fp32 at other shapes stays on the FFMA kernel of ssd_scan.cu.
//
// Bound on the H100 at the Mamba-2 780M prefill shape (B 2, H 48, G 1,
// S 2,048, P 64, N 128): 8.22 GFLOP of dual-form products, each three tf32
// products on the tensor cores, 0.0498 ms at 495 TFLOP/s, against x, la, b,
// c read once and y written once, 105.6 MB (0.0315 ms): operations bound
// it. The workspace (53.2 MB there, most of it the chunk states) is this
// design's own traffic and not in the bound.
//
// Design: the four passes of the bf16 kernel (ssd_scan_wgmma.cu), the chunks
// in parallel, each a grid of its own on the caller's stream:
//   1. states, one CTA per (chunk, h, 64 rows of P, b): cum by one thread in
//      fp64, in order (chunk_cum), each rounded once to fp32 and written to
//      the workspace for the scan; S_c = (w o X)^T B with w_j = exp(total -
//      cum_j) taken from the fp64 difference, applied to x (rounded, then
//      split), K = the Q tokens; two warpgroups take the N tiles in pairs.
//   2. cb, one CTA per (chunk, g, b): CB = C B^T, K = N, once per group and
//      only its 64 x 64 tiles on or below the diagonal.
//   3. scan: ssd_chunk_scan of ssd_scan_common.cuh, shared with the bf16
//      kernel: h_in[c] = h; h = exp(total_c) h + S_c, over S_c in place.
//   4. out, one CTA per (chunk, 64 columns of P, h, b), Q / 64 warpgroups of
//      64 rows: y = exp(cum_i) (C h_in^T) + (CB o decay) X, cum again by
//      chunk_cum (the same bits as pass 1's). The decay-weighted scores enter
//      as the A operand from registers (the rs form): each thread computes
//      exactly its fragment's elements from the workspace, decay_ij =
//      exp(cum_i - cum_j) from the fp64 difference, selected for j <= i,
//      never multiplied by a mask (it overflows above the diagonal at strong
//      decay). Warpgroup w skips the K stages of X wholly above its rows.
//
// Operands: tf32 wgmma takes shared-memory operands K-major only (there is no
// transpose bit). Every operand is split into hi and lo by threads anyway, so
// the threads that split it also lay it out: X and B, token-major in device
// memory, are written transposed ((P, Q) and (N, Q) rows) for the products
// that contract over tokens; C, B (pass 2) and h_in, already K-major, as they
// are. K is streamed in stages of 32 (one 128-byte row of fp32 a tile row,
// under the 128-byte swizzle): every stage is loaded into registers while the
// last one is on the tensor cores, then split into a double buffer. No TMA:
// the loads go through the operands' own strides (16-byte rows).
//
// Numerics (the rule of csrc/ntx_gemm_wgmma.cu): hi = tf32_rn(v), lo =
// tf32_rn(v - hi); a k8 slice takes lo.hi, hi.lo and hi.hi summed from zero
// on the tensor cores; the four slices of a stage are summed from zero by
// IEEE adds (__fadd_rn) and the stage's sum is added to the running sum by
// one more. The inter term is scaled by exp(cum_i) before the intra term's
// stages are added to it. y is stored in fp32. No float atomics, no
// reduction across CTAs: the same bits run to run, and strided operands give
// the bits of contiguous ones.
//
// The wrapper (kernels/ssd_scan.py, rules in kernels/ssd_scan_tf32.py)
// checks the operand rules on x, b and c (16-byte-aligned bases, unit last
// stride, other strides multiples of 4 elements), allocates the workspace and
// raises on what the kernel does not take.

#include "ssd_scan_common.cuh"

namespace {

constexpr int T = 64;                  // rows of a wgmma tile
constexpr int KB = 32;                 // K of one stage: a 128-byte row of fp32
constexpr int ROW = 128;
constexpr int HALF = T * ROW;          // one 64-row tile of a stage, hi or lo
constexpr int TILE_BYTES = 2 * HALF;   // hi, then lo
constexpr int THREADS = 256;           // pass 1: two warpgroups

struct Ops {
  const float* x;
  const float* la;
  const float* b;
  const float* c;
  long long sx[3], sb[3], sc[3];  // element strides of (batch, head or group, token)
};

// ---- staging ----------------------------------------------------------------

// four consecutive K elements (one 16-byte chunk) of row r, split, into a tile
__device__ __forceinline__ void put4(uint8_t* tile, int r, int chunk, float4 v) {
  uint32_t h[4], l[4];
  tf32_split(__float_as_uint(v.x), h[0], l[0]);
  tf32_split(__float_as_uint(v.y), h[1], l[1]);
  tf32_split(__float_as_uint(v.z), h[2], l[2]);
  tf32_split(__float_as_uint(v.w), h[3], l[3]);
  const int off = r * ROW + ((chunk ^ (r & 7)) << 4);
  *reinterpret_cast<uint4*>(tile + off) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(tile + HALF + off) = make_uint4(l[0], l[1], l[2], l[3]);
}

// one K element of row r, split, into a tile
__device__ __forceinline__ void put1(uint8_t* tile, int r, int k, float v) {
  uint32_t h, l;
  tf32_split(__float_as_uint(v), h, l);
  const int off = r * ROW + ((((k >> 2) ^ (r & 7)) << 4) | ((k & 3) << 2));
  *reinterpret_cast<uint32_t*>(tile + off) = h;
  *reinterpret_cast<uint32_t*>(tile + HALF + off) = l;
}

// A transposed tile: token rows of 64 contiguous columns in device memory
// (src row j at src + j * ld) become 64 tile rows of 32 tokens, 32 tokens x
// 16 chunks of 4 columns moved by NT threads: a warp reads 8 tokens x 64
// bytes and writes 4 x 8 (row, token) pairs a store.
template <int NT>
struct Transposed {
  static constexpr int PER = 512 / NT;
  float4 v[PER];
  __device__ __forceinline__ static void at(int e, int& j, int& cq) {
    const int grp = e / 32, lane = e % 32;  // 16 groups of 4 chunks x 8 tokens
    cq = 4 * (grp % 4) + lane / 8;
    j = 8 * (grp / 4) + lane % 8;
  }
  __device__ __forceinline__ void load(const float* src, long long ld, int tid) {
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      int j, cq;
      at(tid + NT * m, j, cq);
      v[m] = *reinterpret_cast<const float4*>(src + j * ld + 4 * cq);
    }
  }
  // w: a weight per token (nullptr: none), applied before the split
  __device__ __forceinline__ void store(uint8_t* tile, const float* w, int tid) const {
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      int j, cq;
      at(tid + NT * m, j, cq);
      const float e[4] = {v[m].x, v[m].y, v[m].z, v[m].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) put1(tile, 4 * cq + u, j, w ? __fmul_rn(w[j], e[u]) : e[u]);
    }
  }
};

// A natural tile set: R rows of 32 contiguous K elements (row r at src + r *
// ld) into R / 64 tiles; NT threads move R * 8 / NT float4 each
template <int R, int NT>
struct Natural {
  static constexpr int PER = R * 8 / NT;
  float4 v[PER];
  __device__ __forceinline__ void load(const float* src, long long ld, int tid) {
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int e = tid + NT * m;
      v[m] = *reinterpret_cast<const float4*>(src + (e / 8) * ld + 4 * (e % 8));
    }
  }
  __device__ __forceinline__ void store(uint8_t* tiles, int tid) const {
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int e = tid + NT * m, r = e / 8;
      put4(tiles + (r / T) * TILE_BYTES, r % T, e % 8, v[m]);
    }
  }
};

// ---- products -----------------------------------------------------------------

// part = the sum of a stage's four k8 slices, each lo.hi + hi.lo + hi.hi from
// zero on the tensor cores, the slices summed from zero by IEEE adds in
// order: slice kk is issued into its own accumulator (two in turn) before
// slice kk - 1 is waited for and added, so the tensor cores run one slice
// while the last is summed. issue(sl, kk) issues slice kk's three products.
template <typename Issue>
__device__ __forceinline__ void stage_sum(float (&part)[32], Issue issue) {
  float s0[32], s1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s0[i] = s1[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KB / 8; ++kk) {
    float(&cur)[32] = kk % 2 ? s1 : s0;
    float(&last)[32] = kk % 2 ? s0 : s1;
    fence_regs(cur);
    wg_fence();
    issue(cur, kk);
    wg_commit();
    if (kk > 0) {
      wg_wait<1>();  // slice kk - 1 has retired
      fence_regs(last);
#pragma unroll
      for (int i = 0; i < 32; ++i) part[i] = kk == 1 ? last[i] : __fadd_rn(part[i], last[i]);
    }
  }
  wg_wait<0>();
  float(&fin)[32] = (KB / 8 - 1) % 2 ? s1 : s0;
  fence_regs(fin);
#pragma unroll
  for (int i = 0; i < 32; ++i) part[i] = __fadd_rn(part[i], fin[i]);
}

// acc += one stage of a b^T, a and b 64-row tiles (hi, lo) in shared memory
__device__ __forceinline__ void stage_ss(float (&acc)[32], const uint8_t* a, const uint8_t* b) {
  float part[32];
  stage_sum(part, [&](float(&sl)[32], int kk) {
    Tf32Mma<64>::ss(sl, kdesc(a + HALF + 32 * kk), kdesc(b + 32 * kk), 0);
    Tf32Mma<64>::ss(sl, kdesc(a + 32 * kk), kdesc(b + HALF + 32 * kk), 1);
    Tf32Mma<64>::ss(sl, kdesc(a + 32 * kk), kdesc(b + 32 * kk), 1);
  });
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void zero(float (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
}

// ---- cum --------------------------------------------------------------------

// the inclusive cumsum of chunk c's log decays in fp64 (cum64), and each
// rounded once (cum), by the first warp: Q / 32 in order a lane, then the
// lanes' sums scanned across the warp. Both passes that need it compute it
// so, with the same bits. exp(cum_i - cum_j) and exp(total - cum_j) take the
// fp64 difference: the rounded cums' differences cancel (la reaches -50 a
// step in the Mamba-2 780M prefill) and read 1.06x the plain version's RMS
// error against fp64 on its layer 0 on an H100, the fp64 ones 0.07-0.15x
template <int Q, int NT>
__device__ __forceinline__ void chunk_cum(const Ops& o, const Dims& d, int bi, int h, int c,
                                          float* cum, double* cum64) {
  constexpr int PER = Q / 32;
  const float* lb = o.la + bi * d.sla[0] + h * d.sla[1] + static_cast<long long>(c) * Q * d.sla[2];
  for (int i = threadIdx.x; i < Q; i += NT) cum[i] = lb[i * d.sla[2]];
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    double v[PER], s = 0.0;
#pragma unroll
    for (int k = 0; k < PER; ++k) v[k] = s += static_cast<double>(cum[PER * lane + k]);
    double t = s;  // the warp's inclusive scan of the lanes' sums
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += u;
    }
    double before = __shfl_up_sync(0xffffffffu, t, 1);
    if (lane == 0) before = 0.0;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      cum64[PER * lane + k] = before + v[k];
      cum[PER * lane + k] = static_cast<float>(before + v[k]);
    }
  }
  __syncthreads();
}

// ---- pass 1: cum and the chunk states ----------------------------------------

// grid (NC, H * P / 64, B), 256 threads. A stage: the (w o X)^T tile and two
// B^T tiles (the warpgroups' N tiles), double-buffered.
template <int Q>
__global__ void __launch_bounds__(THREADS, 1)
ssd_tf32_states(Ops o, float* __restrict__ cum_ws, float* __restrict__ st_ws, Dims d) {
  constexpr int STAGE = 3 * TILE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ double cum64[Q];
  __shared__ float cum[Q], wt[Q];
  uint8_t* sm = align1024(smem_raw);
  const int PT = d.P / T, NT = d.N / T;
  const int c = blockIdx.x, h = blockIdx.y / PT, pt = blockIdx.y % PT, bi = blockIdx.z;
  const int g = h / (d.H / d.G), tid = threadIdx.x, wg = tid / 128, lt = tid % 128;

  chunk_cum<Q, THREADS>(o, d, bi, h, c, cum, cum64);
  float* cw = cum_ws + (static_cast<long long>(bi) * d.H + h) * d.S + c * Q;
  for (int i = tid; i < Q; i += THREADS) {
    wt[i] = expf(static_cast<float>(cum64[Q - 1] - cum64[i]));
    if (pt == 0) cw[i] = cum[i];
  }
  __syncthreads();

  const float* xs = o.x + bi * o.sx[0] + h * o.sx[1] + static_cast<long long>(c) * Q * o.sx[2] + T * pt;
  const float* bs = o.b + bi * o.sb[0] + g * o.sb[1] + static_cast<long long>(c) * Q * o.sb[2];
  float* sb = st_ws + ((static_cast<long long>(bi) * d.H + h) * d.NC + c) * d.P * d.N +
              static_cast<long long>(T) * pt * d.N;
  constexpr int NS = Q / KB;
  for (int n0 = 0; n0 < NT; n0 += 2) {
    const int nt = n0 + wg;  // this warpgroup's N tile; past NT: idle
    Transposed<THREADS> ra, rb0, rb1;
    auto load = [&](int t) {
      ra.load(xs + t * KB * o.sx[2], o.sx[2], tid);
      rb0.load(bs + t * KB * o.sb[2] + T * n0, o.sb[2], tid);
      if (n0 + 1 < NT) rb1.load(bs + t * KB * o.sb[2] + T * (n0 + 1), o.sb[2], tid);
    };
    auto store = [&](int t) {
      uint8_t* st = sm + (t % 2) * STAGE;
      ra.store(st, wt + t * KB, tid);
      rb0.store(st + TILE_BYTES, nullptr, tid);
      if (n0 + 1 < NT) rb1.store(st + 2 * TILE_BYTES, nullptr, tid);
      fence_proxy_async();
    };
    __syncthreads();  // the last pair's stages have been read
    load(0);
    store(0);
    __syncthreads();
    float acc[32];
    zero(acc);
#pragma unroll 1
    for (int t = 0; t < NS; ++t) {
      if (t + 1 < NS) load(t + 1);
      const uint8_t* st = sm + (t % 2) * STAGE;
      if (nt < NT) stage_ss(acc, st, st + (1 + wg) * TILE_BYTES);
      if (t + 1 < NS) store(t + 1);
      __syncthreads();
    }
    if (nt < NT) store_tile(sb + T * nt, d.N, acc, lt);
  }
}

// ---- pass 2: c b^T once per group ----------------------------------------------

// grid (NC, G, B), Q / 64 warpgroups: warpgroup w computes the tiles (w, jt),
// jt <= w, of CB = C B^T, K = N in stages of 32: a stage holds the C and B
// tiles of all Q rows, double-buffered
template <int Q>
__global__ void __launch_bounds__(Q * 2, 1)
ssd_tf32_cb(Ops o, float* __restrict__ cb_ws, Dims d) {
  constexpr int NTH = Q * 2, RT = Q / T, STAGE = 2 * RT * TILE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const int c = blockIdx.x, g = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128;
  const float* cs = o.c + bi * o.sc[0] + g * o.sc[1] + static_cast<long long>(c) * Q * o.sc[2];
  const float* bs = o.b + bi * o.sb[0] + g * o.sb[1] + static_cast<long long>(c) * Q * o.sb[2];
  Natural<Q, NTH> rc, rb;
  auto load = [&](int t) {
    rc.load(cs + t * KB, o.sc[2], tid);
    rb.load(bs + t * KB, o.sb[2], tid);
  };
  auto store = [&](int t) {
    uint8_t* st = sm + (t % 2) * STAGE;
    rc.store(st, tid);
    rb.store(st + RT * TILE_BYTES, tid);
    fence_proxy_async();
  };
  const int NS = d.N / KB;
  load(0);
  store(0);
  __syncthreads();
  float acc[RT][32];
#pragma unroll
  for (int jt = 0; jt < RT; ++jt) zero(acc[jt]);
#pragma unroll 1
  for (int t = 0; t < NS; ++t) {
    if (t + 1 < NS) load(t + 1);
    const uint8_t* st = sm + (t % 2) * STAGE;
#pragma unroll
    for (int jt = 0; jt < RT; ++jt)
      if (jt <= wg) stage_ss(acc[jt], st + wg * TILE_BYTES, st + (RT + jt) * TILE_BYTES);
    if (t + 1 < NS) store(t + 1);
    __syncthreads();
  }
  float* out = cb_ws + ((static_cast<long long>(bi) * d.G + g) * d.NC + c) * Q * Q;
#pragma unroll
  for (int jt = 0; jt < RT; ++jt)
    if (jt <= wg) store_tile(out + wg * T * Q + jt * T, Q, acc[jt], lt);
}

// ---- pass 4: y -------------------------------------------------------------------

// grid (NC * P / 64, H, B), Q / 64 warpgroups of 64 rows. Stages: first N / 32
// of the inter term (the C tiles of all Q rows and the h_in tile), then Q / 32
// of the intra term (the X^T tile), double-buffered.
template <int Q>
__global__ void __launch_bounds__(Q * 2, 1)
ssd_tf32_out(Ops o, const float* __restrict__ cb_ws, const float* __restrict__ st_ws,
             float* __restrict__ y, Dims d) {
  constexpr int NTH = Q * 2, RT = Q / T, STAGE = (RT + 1) * TILE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ double cum64[Q];
  __shared__ float cum[Q];
  uint8_t* sm = align1024(smem_raw);
  const int c = blockIdx.x % d.NC, pt = blockIdx.x / d.NC;
  const int h = blockIdx.y, bi = blockIdx.z, g = h / (d.H / d.G);
  const int tid = threadIdx.x, wg = tid / 128, lt = tid % 128;
  const int warp = lt / 32, lane = lt % 32, t4 = lane % 4;
  const long long bh = static_cast<long long>(bi) * d.H + h;
  chunk_cum<Q, NTH>(o, d, bi, h, c, cum, cum64);

  const float* cs = o.c + bi * o.sc[0] + g * o.sc[1] + static_cast<long long>(c) * Q * o.sc[2];
  const float* xs = o.x + bi * o.sx[0] + h * o.sx[1] + static_cast<long long>(c) * Q * o.sx[2] + T * pt;
  const float* hs = st_ws + (bh * d.NC + c) * d.P * d.N + static_cast<long long>(T) * pt * d.N;
  const int NI = d.N / KB, NS = NI + Q / KB;
  Natural<Q, NTH> rc;
  Natural<T, NTH> rh;
  Transposed<NTH> rx;
  const int i0 = T * wg + 16 * warp + lane / 4, i1 = i0 + 8;  // this thread's rows
  const float* cbw = cb_ws + ((static_cast<long long>(bi) * d.G + g) * d.NC + c) * Q * Q;
  // CB at this thread's fragment of an intra stage: sv of the stage on the
  // tensor cores, sn of the next (loaded while the last one runs); 0 above
  // the diagonal (never read there)
  float sv[16], sn[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) sn[k] = 0.f;
  auto load = [&](int t) {
    if (t < NI) {
      rc.load(cs + t * KB, o.sc[2], tid);
      rh.load(hs + t * KB, d.N, tid);
    } else {
      const int j0 = (t - NI) * KB;
      rx.load(xs + j0 * o.sx[2], o.sx[2], tid);
#pragma unroll
      for (int kk = 0; kk < KB / 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = r & 1 ? i1 : i0, col = j0 + 8 * kk + t4 + 4 * (r / 2);
          sn[4 * kk + r] = col <= row ? cbw[row * Q + col] : 0.f;
        }
    }
  };
  auto store = [&](int t) {
    uint8_t* st = sm + (t % 2) * STAGE;
    if (t < NI) {
      rc.store(st, tid);
      rh.store(st + RT * TILE_BYTES, tid);
    } else {
      rx.store(st, nullptr, tid);
    }
    fence_proxy_async();
  };
  load(0);
  store(0);
  __syncthreads();

  const float ci0 = cum[i0], ci1 = cum[i1];
  float acc[32];
  zero(acc);
#pragma unroll 1
  for (int t = 0; t < NS; ++t) {
#pragma unroll
    for (int k = 0; k < 16; ++k) sv[k] = sn[k];
    if (t + 1 < NS) load(t + 1);
    const uint8_t* st = sm + (t % 2) * STAGE;
    if (t < NI) {
      stage_ss(acc, st + wg * TILE_BYTES, st + RT * TILE_BYTES);
      if (t == NI - 1) {  // the inter term is complete: scale its rows by exp(cum_i)
        const float e0 = expf(ci0), e1 = expf(ci1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[4 * j] = __fmul_rn(acc[4 * j], e0);
          acc[4 * j + 1] = __fmul_rn(acc[4 * j + 1], e0);
          acc[4 * j + 2] = __fmul_rn(acc[4 * j + 2], e1);
          acc[4 * j + 3] = __fmul_rn(acc[4 * j + 3], e1);
        }
      }
    } else if ((t - NI) * KB < T * (wg + 1)) {  // a stage of X with keys at or below these rows
      const int j0 = (t - NI) * KB;
      // the A fragments of the stage's four slices: a[4 kk + r] at row i0 (r
      // even) or i1, key j0 + 8 kk + t4 + 4 (r / 2)
      uint32_t ah[16], al[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int row = k & 1 ? i1 : i0, col = j0 + 8 * (k / 4) + t4 + 4 * ((k % 4) / 2);
        // select, never multiply by a mask: exp above the diagonal may be inf
        const float v =
            col <= row ? __fmul_rn(sv[k], expf(static_cast<float>(cum64[row] - cum64[col])))
                       : 0.f;
        tf32_split(__float_as_uint(v), ah[k], al[k]);
      }
      float part[32];
      stage_sum(part, [&](float(&sl)[32], int kk) {
        const uint32_t(&fh)[4] = *reinterpret_cast<const uint32_t(*)[4]>(ah + 4 * kk);
        const uint32_t(&fl)[4] = *reinterpret_cast<const uint32_t(*)[4]>(al + 4 * kk);
        Tf32Mma<64>::rs(sl, fl, kdesc(st + 32 * kk), 0);
        Tf32Mma<64>::rs(sl, fh, kdesc(st + HALF + 32 * kk), 1);
        Tf32Mma<64>::rs(sl, fh, kdesc(st + 32 * kk), 1);
      });
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    }
    if (t + 1 < NS) store(t + 1);
    __syncthreads();
  }

  store_tile(y + (bh * d.S + c * Q + T * wg) * d.P + T * pt, d.P, acc, lt);
}

// ---- host ----------------------------------------------------------------------

// dynamic shared memory of each pass (smem_bytes in kernels/ssd_scan_tf32.py)
int states_smem() { return 1024 + 2 * 3 * TILE_BYTES; }
int cb_smem(int Q) { return 1024 + 2 * 2 * (Q / T) * TILE_BYTES; }
int out_smem(int Q) { return 1024 + 2 * (Q / T + 1) * TILE_BYTES; }

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int Q>
int launch_q(const Ops& o, float* y, float* ws, const Dims& d, cudaStream_t stream) {
  float* cum_ws = ws;
  float* cb_ws = cum_ws + static_cast<long long>(d.B) * d.H * d.S;
  float* st_ws = cb_ws + static_cast<long long>(d.B) * d.G * d.NC * Q * Q;
  const int s1 = states_smem(), s2 = cb_smem(Q), s4 = out_smem(Q);
  cudaError_t e = allow_smem(ssd_tf32_states<Q>, s1);
  if (e == cudaSuccess) e = allow_smem(ssd_tf32_cb<Q>, s2);
  if (e == cudaSuccess) e = allow_smem(ssd_tf32_out<Q>, s4);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ptiles = d.P / T;
  ssd_tf32_states<Q><<<dim3(d.NC, d.H * ptiles, d.B), THREADS, s1, stream>>>(o, cum_ws, st_ws, d);
  ssd_tf32_cb<Q><<<dim3(d.NC, d.G, d.B), Q * 2, s2, stream>>>(o, cb_ws, d);
  const int per = d.P * d.N / 4;
  ssd_chunk_scan<<<dim3((per + SCAN_THREADS - 1) / SCAN_THREADS, d.H, d.B), SCAN_THREADS, 0,
                   stream>>>(cum_ws, st_ws, d);
  ssd_tf32_out<Q><<<dim3(d.NC * ptiles, d.H, d.B), Q * 2, s4, stream>>>(o, cb_ws, st_ws, y, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dims: B, H, G, S, P, N, Q, then the element strides of x (4), la (3), b
// (4) and c (4). x, b, c are fp32 with unit last strides, 16-byte-aligned
// bases and the other strides multiples of 4 elements (the wrapper checks
// them); la is fp32 with any strides; y is a contiguous (B, H, S, P) fp32;
// ws holds B H S + B G (S / Q) Q Q + B H (S / Q) P N fp32 (cum, CB, the
// chunk states). P and N are multiples of 64, N at most 256, Q is 64 or 128
// and divides S.
extern "C" int ssd_scan_f32_tf32(const void* x, const void* la, const void* b, const void* c,
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
  if (d.P % T || d.N % T || d.N > 4 * T || d.P == 0 || d.N == 0 || d.G == 0 || d.H % d.G ||
      (d.Q != 64 && d.Q != 128) || d.S % d.Q)
    return static_cast<int>(cudaErrorInvalidValue);
  d.NC = d.S / d.Q;
  if (d.B * d.H == 0 || d.S == 0) return static_cast<int>(cudaGetLastError());
  Ops o;
  o.x = static_cast<const float*>(x);
  o.la = static_cast<const float*>(la);
  o.b = static_cast<const float*>(b);
  o.c = static_cast<const float*>(c);
  for (int k = 0; k < 3; ++k) {
    o.sx[k] = dims[7 + k];
    o.sb[k] = dims[14 + k];
    o.sc[k] = dims[18 + k];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* yf = static_cast<float*>(y);
  float* w = static_cast<float*>(ws);
  return d.Q == 64 ? launch_q<64>(o, yf, w, d, s) : launch_q<128>(o, yf, w, d, s);
}

extern "C" const char* ssd_scan_tf32_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

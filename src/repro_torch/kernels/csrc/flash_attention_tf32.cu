// Flash attention forward for Hopper on the tensor cores, fp32 q, k, v at
// head dims 64 and 128, as 3xTF32: o = softmax(q k^T * scale + mask) v.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _attn_kernel, pallas_call at :153; its dots at :75 and :103 keep
// fp32 with preferred_element_type=float32) for fp32 operands; it computes
// what flash_attention.cu computes (lines 11-16 there):
//
//   s   = (q . k) * scale, masked to NEG_INF where j >= Skv, j > i (causal)
//         or j <= i - window (sliding window)
//   m'  = max(m, max_j s);  alpha = exp(m - m');  p = exp(s - m')
//         (p = 0 and alpha = 0 while m' is still NEG_INF)
//   l'  = l alpha + sum_j p;  acc' = acc alpha + p v
//   o   = acc / (l == 0 ? 1 : l)
//
// GQA maps q head h to kv head h / (Hq / Hkv) with no KV copy; rows that see
// no key give exactly 0. fp32 at head dims 16, 32 and 256 stays on the FFMA
// kernel of flash_attention.cu.
//
// Bound on the H100: 4 D FLOP per visible (q, k) pair against 4 D fp32
// elements read or written per token and head. On the tensor cores each of
// those FLOPs is three tf32 products (below), so the bound is 3 x 17.19
// GFLOP at 495 TFLOP/s, 0.1042 ms at the Qwen1.5-0.5B prefill shape (B 2,
// H 16, S 2,048, D 64, causal), against 67.11 MB moved (0.0200 ms).
//
// Numerics (PR 22's rule, csrc/ntx_gemm_wgmma.cu): every fp32 operand of a
// product is split into hi = tf32_rn(x) and lo = tf32_rn(x - hi), round to
// nearest even at 10 mantissa bits, and a k8 slice of a product takes three
// tf32 products, the small terms first: lo.hi, hi.lo, hi.hi. Each slice is
// summed from zero on the tensor cores and added to the running fp32 sum by
// one IEEE add (__fadd_rn): s over the 8 slices of D, acc (after acc *=
// alpha) over the 8 slices of 8 keys of a tile. The scale, the masks, the
// online max, exp (expf) and l are fp32 as in flash_attention.cu.
//
// Design:
//   * grid and order: one CTA per (b, hq, tile of query rows), the tiles of
//     the last query rows launched first; a consumer warpgroup owns 64 rows
//     of the tile and walks its KV tiles of BKV = 64 keys in order, only
//     those between the window start and the causal diagonal of its rows.
//     At D 64 a CTA holds 128 rows in two consumer warpgroups, which share
//     each K and V tile (one CTA an SM: 197,704 bytes of shared memory; the
//     producer warpgroup gives registers up by setmaxnreg, 88 a thread, so
//     that a consumer thread has 208); at D 128 one warpgroup of 64 rows.
//     No split-KV, no atomics: the same bits on every run.
//   * loads: a producer warpgroup reads q once and each K and V tile through
//     the operands' strides (16-byte loads along D), splits every element
//     into hi and lo in registers and stores both into shared memory under
//     the 128-byte swizzle (16-byte chunk c of row r at chunk c ^ r % 8,
//     rows of 32 fp32, every tile on 1,024 bytes), then fences the stores
//     for the async proxy (fence.proxy.async) before it arrives on the tile's
//     full barrier. Rows past Sq or Skv are stored as 0 (and the KV tail is
//     masked). K and V have rings of their own (two stages at D 64, one at
//     D 128), each stage with a full and an empty barrier: K loads while
//     the consumers run the softmax and p v, V while they run q k^T.
//   * a wait per k8 slice costs the tensor cores' latency each time: at D
//     64 two slices are issued into registers of their own before one wait,
//     then added in order, which changes no bit.
//   * s = q k^T: tf32 wgmma m64n64k8, q and K both K-major along D from
//     shared memory (D / 32 boxes of 32 columns; a k8 slice is 32 bytes
//     into the row).
//   * acc += p v: tf32 has no transpose bit, so v must be K-major along the
//     keys: the producers transpose it on the way in, blocks of 4 keys x 4
//     columns through registers, into D rows of 64 keys. p comes from
//     registers: the score accumulator gives a thread keys 2t, 2t + 1 of
//     each group of 8 (t = lane % 4), and tf32's A fragment takes columns
//     t and t + 4, so p goes in as it lies and each group's v rows are
//     stored in the matching order (keys 0, 2, 4, 6, 1, 3, 5, 7): a slice
//     still sums its own 8 keys. p's split is made in registers.
//   * epilogue: o = acc / (l == 0 ? 1 : l) in fp32, stored from registers
//     into o (contiguous, B, Hq, Sq, D).
//
// --use_fast_math stays off. The wrapper (kernels/flash_attention.py, rules
// in kernels/flash_attention_tf32.py) checks that q, k and v have unit last
// strides, 16-byte-aligned bases and other strides that are multiples of 16
// bytes, and raises on operands that break them.

#include "sm90.cuh"

namespace {

constexpr int BKV = 64;                  // keys per tile
constexpr int PRODUCERS = 128;           // one producer warpgroup, after the consumers
constexpr int ROW = 128;                 // one swizzled row: 32 fp32
constexpr float NEG_INF = -1e30f;

// per head dim: consumer warpgroups (64 query rows each), stages of the K
// and V rings, and k8 slices issued before one wait (each into its own
// registers, added in order)
template <int D>
struct Cfg {
  static constexpr int NWG = D == 64 ? 2 : 1;
  static constexpr int BQ = 64 * NWG;  // query rows per CTA
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + PRODUCERS;
  static constexpr int STAGES = D == 64 ? 2 : 1;
  static constexpr int PAIR = D == 64 ? 2 : 1;
};

// registers a thread after setmaxnreg at 384 threads (two consumer
// warpgroups). The block's registers are what it was launched with: the
// consumers' increase waits for the producer's decrease, so 128 x 88 +
// 256 x 208 = 64,512 must not pass 384 x the registers ptxas gave the
// kernel, or the block never starts its work. ptxas gives 168 to a block
// of 384; launch_d reads the count the kernel was built with and refuses
// to launch below it
constexpr int PRODUCER_REGS = 88, CONSUMER_REGS = 208;
constexpr int SETMAXNREG_NEEDS = PRODUCERS * PRODUCER_REGS + 256 * CONSUMER_REGS;
static_assert(SETMAXNREG_NEEDS <= 384 * 168,
              "setmaxnreg would wait for registers the block does not hold");

// shared memory, from a 1,024-byte boundary: each warpgroup's q tile, then
// the K and V^T rings, every tile a hi and a lo copy (smem_bytes in
// flash_attention_tf32.py)
template <int D>
struct Layout {
  static constexpr int QK_TILE = 64 * D * 4;  // 64 rows x D: D / 32 boxes of 64 rows
  static constexpr int VT_TILE = D * BKV * 4;  // D rows x 64 keys: two boxes of D rows
  static constexpr int Q_OFF = 0;              // warpgroup w: hi at 2 w QK_TILE, lo after it
  static constexpr int K_OFF = Cfg<D>::NWG * 2 * QK_TILE;  // stage s: hi at 2 s QK_TILE
  static constexpr int V_OFF = K_OFF + Cfg<D>::STAGES * 2 * QK_TILE;  // stage s: 2 s VT_TILE
  static constexpr int SMEM = 1024 + V_OFF + Cfg<D>::STAGES * 2 * VT_TILE;
};

struct Dims {
  int B, Hq, Hkv, Sq, Skv, causal, has_window, window;
  long long sq[4], sk[4], sv[4];  // element strides of q, k, v (the last is 1)
};

// a tile's descriptor moved `bytes` (a multiple of 16) into the tile: the
// start address is the low 14 bits, in units of 16 bytes
__device__ __forceinline__ uint64_t at(uint64_t d, int bytes) {
  return d + static_cast<uint64_t>(bytes >> 4);
}

// hides a value from the compiler, so that what is derived from it is
// computed where it is used and not kept in registers across the loop
__device__ __forceinline__ uint64_t opaque(uint64_t v) {
  asm volatile("" : "+l"(v));
  return v;
}
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// the split of one 16-byte chunk: hi at byte off of the hi tile, lo at the
// same place of the lo tile, lo_delta bytes further
__device__ __forceinline__ void put_split(uint8_t* hi, int lo_delta, int off, const uint4& x) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) tf32_split(word(x, i), h[i], l[i]);
  *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(hi + lo_delta + off) = make_uint4(l[0], l[1], l[2], l[3]);
}

// ---- the producers --------------------------------------------------------

// A producer thread's share of a tile is LOADS = D / 8 loads of 16 bytes,
// held in registers between the global loads and the split stores.
template <int D>
constexpr int LOADS = 64 * D / 4 / PRODUCERS;

// the 16-byte chunks of a 64-row q or K tile of a producer thread: chunk
// e = pt + PRODUCERS i is row e / (D / 4), chunk e % (D / 4) of D
// (neighbouring threads along D); rows >= valid read 0
template <int D>
__device__ __forceinline__ void fetch_rows(uint4 (&v)[LOADS<D>], const float* base,
                                           long long srow, int valid, int pt) {
#pragma unroll
  for (int i = 0; i < LOADS<D>; ++i) {
    const int e = pt + PRODUCERS * i;
    const int r = e / (D / 4), c = e % (D / 4);
    v[i] = r < valid ? *reinterpret_cast<const uint4*>(base + r * srow + 4 * c)
                     : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int D>
__device__ __forceinline__ void stow_rows(uint8_t* hi, int lo_delta, const uint4 (&v)[LOADS<D>],
                                          int pt) {
#pragma unroll
  for (int i = 0; i < LOADS<D>; ++i) {
    const int e = pt + PRODUCERS * i;
    const int r = e / (D / 4), c = e % (D / 4);
    put_split(hi, lo_delta, (c / 8) * 64 * ROW + r * ROW + (((c % 8) ^ (r & 7)) << 4), v[i]);
  }
}

// the blocks of a V tile of a producer thread, 4 keys x 4 columns each:
// block h = pt + PRODUCERS i holds columns 4 (h % (D / 4)) .. + 3 of keys
// 8 g + par + 2 j (j = 0..3), kq = h / (D / 4), g = kq / 2, par = kq % 2,
// key j in v[4 i + j]; keys >= valid read 0
template <int D>
__device__ __forceinline__ void fetch_v(uint4 (&v)[LOADS<D>], const float* base, long long srow,
                                        int valid, int pt) {
#pragma unroll
  for (int i = 0; i < LOADS<D> / 4; ++i) {
    const int h = pt + PRODUCERS * i;
    const int dq = h % (D / 4), kq = h / (D / 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = 8 * (kq / 2) + kq % 2 + 2 * j;
      v[4 * i + j] = key < valid
                         ? *reinterpret_cast<const uint4*>(base + key * srow + 4 * dq)
                         : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// the blocks transposed into V^T: row d (a column of v), keys along the row
// in 32-key boxes; chunk 2 (g % 4) + par of box g / 4 holds keys 8 g + par
// + {0, 2, 4, 6}, so a k8 slice's columns t and t + 4 are keys 2t and 2t + 1
template <int D>
__device__ __forceinline__ void stow_v(uint8_t* hi, int lo_delta, const uint4 (&v)[LOADS<D>],
                                       int pt) {
#pragma unroll
  for (int i = 0; i < LOADS<D> / 4; ++i) {
    const int h = pt + PRODUCERS * i;
    const int dq = h % (D / 4), kq = h / (D / 4);
    const int g = kq / 2, ch = (g % 4) * 2 + kq % 2;
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const int d = 4 * dq + dd;
      const uint4 x = make_uint4(word(v[4 * i], dd), word(v[4 * i + 1], dd),
                                 word(v[4 * i + 2], dd), word(v[4 * i + 3], dd));
      put_split(hi, lo_delta, (g / 4) * D * ROW + d * ROW + ((ch ^ (d & 7)) << 4), x);
    }
  }
}

// a warpgroup's share of the register file: the producer gives registers
// up, the consumers take them (both only with two consumer warpgroups)
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// ---- the kernel -----------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
attn_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, Dims d, float scale) {
  using C = Cfg<D>;
  using L = Layout<D>;
  constexpr int ST = C::STAGES, P = C::PAIR;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full, k_full[ST], k_empty[ST], v_full[ST], v_empty[ST];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int nq = (d.Sq + C::BQ - 1) / C::BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * C::BQ;
  const int hq = blockIdx.y, bi = blockIdx.z;
  const int hk = hq / (d.Hq / d.Hkv);
  // the keys any row of this tile can see: [lo, hi), in tiles from k_first
  int hi = d.Skv;
  if (d.causal) hi = min(hi, q0 + C::BQ);
  const int lo = d.has_window ? max(0, q0 - d.window + 1) : 0;
  const int k_first = lo / BKV * BKV;
  const int n_tiles = hi > k_first ? (hi - k_first + BKV - 1) / BKV : 0;

  if (tid == 0) {
    mbar_init(&q_full, PRODUCERS);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&k_full[s], PRODUCERS);
      mbar_init(&v_full[s], PRODUCERS);
      mbar_init(&k_empty[s], C::CONSUMERS);
      mbar_init(&v_empty[s], C::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= C::CONSUMERS) {  // the producer warpgroup
    if constexpr (C::NWG == 2) regs_dec<PRODUCER_REGS>();
    const int pt0 = tid - C::CONSUMERS;
    uint4 buf[LOADS<D>];
#pragma unroll
    for (int w = 0; w < C::NWG; ++w) {
      const int qw = q0 + 64 * w;
      fetch_rows<D>(buf, q + bi * d.sq[0] + hq * d.sq[1] + qw * d.sq[2], d.sq[2], d.Sq - qw, pt0);
      stow_rows<D>(sm + L::Q_OFF + 2 * w * L::QK_TILE, L::QK_TILE, buf, pt0);
    }
    fence_proxy_async();
    mbar_arrive(&q_full);
    const float* kb = k + bi * d.sk[0] + hk * d.sk[1];
    const float* vb = v + bi * d.sv[0] + hk * d.sv[1];
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = k_first + t * BKV, s = t % ST;
      const uint32_t parity = (t / ST - 1) & 1;  // of the last use of stage s
      const int pt = opaque(pt0);  // the offsets are recomputed, not held, tile to tile
      uint8_t* kt = sm + L::K_OFF + 2 * s * L::QK_TILE;
      uint8_t* vt = sm + L::V_OFF + 2 * s * L::VT_TILE;
      fetch_rows<D>(buf, kb + k0 * d.sk[2], d.sk[2], d.Skv - k0, pt);
      if (t >= ST) mbar_wait(&k_empty[s], parity);  // its last q k^T is done
      stow_rows<D>(kt, L::QK_TILE, buf, pt);
      fence_proxy_async();
      mbar_arrive(&k_full[s]);
      fetch_v<D>(buf, vb + k0 * d.sv[2], d.sv[2], d.Skv - k0, pt);
      if (t >= ST) mbar_wait(&v_empty[s], parity);  // its last p v is done
      stow_v<D>(vt, L::VT_TILE, buf, pt);
      fence_proxy_async();
      mbar_arrive(&v_full[s]);
    }
    return;
  }

  if constexpr (C::NWG == 2) regs_inc<CONSUMER_REGS>();
  // consumer warpgroup w owns query rows q0w .. q0w + 63; this thread's rows
  // are r0 and r0 + 8, its columns in each group of 8 cq and cq + 1
  const int w = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int q0w = q0 + 64 * w;
  const int r0 = q0w + warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  // the keys this warpgroup's rows can see: tiles outside them are skipped
  // (a tile that every row masks changes no bit of m, l or acc)
  const int hi_w = d.causal ? min(d.Skv, q0w + 64) : d.Skv;
  const int lo_w = d.has_window ? max(0, q0w - d.window + 1) : 0;
  const uint8_t* qt = sm + L::Q_OFF + 2 * w * L::QK_TILE;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  mbar_wait(&q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_first + t * BKV, s = t % ST;
    const uint32_t parity = (t / ST) & 1;
    // the tiles' descriptors, derived afresh in every tile: held across the
    // loop, the 48 of them spill (232 bytes against 164, 0.642 ms against
    // 0.578 a call at the Qwen shape)
    const uint64_t qd = opaque(kdesc(qt));
    const uint64_t kd = opaque(kdesc(sm + L::K_OFF + 2 * s * L::QK_TILE));
    const uint64_t vd = opaque(kdesc(sm + L::V_OFF + 2 * s * L::VT_TILE));
    if (k0 >= hi_w || k0 + BKV <= lo_w) {  // every row of this warpgroup masks the tile
      mbar_wait(&k_full[s], parity);
      mbar_arrive(&k_empty[s]);
      mbar_wait(&v_full[s], parity);
      mbar_arrive(&v_empty[s]);
      continue;
    }

    // s = q k^T: per slice of 8 columns of D, lo.hi + hi.lo + hi.hi from
    // zero on the tensor cores, then one IEEE add; P slices a wait
    float sc[32];
    {
      float sb[P][32];
#pragma unroll
      for (int j = 0; j < P; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) sb[j][i] = 0.f;
      mbar_wait(&k_full[s], parity);
#pragma unroll
      for (int kk = 0; kk < D / 8; kk += P) {
#pragma unroll
        for (int j = 0; j < P; ++j) fence_regs(sb[j]);
        wg_fence();
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const int off = ((kk + j) / 4) * 64 * ROW + ((kk + j) % 4) * 32;  // box, slice
          Tf32Mma<64>::ss(sb[j], at(qd, L::QK_TILE + off), at(kd, off), 0);
          Tf32Mma<64>::ss(sb[j], at(qd, off), at(kd, L::QK_TILE + off), 1);
          Tf32Mma<64>::ss(sb[j], at(qd, off), at(kd, off), 1);
        }
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int j = 0; j < P; ++j) {
          fence_regs(sb[j]);
#pragma unroll
          for (int i = 0; i < 32; ++i)
            sc[i] = kk + j == 0 ? sb[j][i] : __fadd_rn(sc[i], sb[j][i]);
        }
      }
    }
    mbar_arrive(&k_empty[s]);  // K of tile t is read

    // scale; mask only tiles that cross the KV tail, the causal diagonal or
    // the window start
    const bool inner = k0 + BKV <= d.Skv && (!d.causal || k0 + BKV - 1 <= q0w) &&
                       (!d.has_window || k0 > q0w + 63 - d.window);
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = __fmul_rn(sc[i], scale);
    if (!inner) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + 8 * i;
        const int vhi = d.causal ? min(d.Skv, row + 1) : d.Skv;  // visible: [vlo, vhi)
        const int vlo = d.has_window ? row - d.window + 1 : 0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = k0 + 8 * j + cq + c;
            float& x = sc[4 * j + 2 * i + c];
            x = col >= vlo && col < vhi ? x : NEG_INF;
          }
      }
    }

    // online softmax per row; p replaces s in sc
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const bool none = m_new <= NEG_INF / 2;  // no visible key in this row yet
      // while none, every score of the row is NEG_INF and exp(NEG_INF) is 0
      const float m_ref = none ? 0.f : m_new;
      float sum = 0.f;  // this thread's part of the row; joined across the row at the end
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = sc[4 * j + 2 * i + c];
          x = expf(__fsub_rn(x, m_ref));
          sum = __fadd_rn(sum, x);
        }
      alpha[i] = none ? 0.f : expf(__fsub_rn(m[i], m_new));
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), sum);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[4 * j + 2 * i] = __fmul_rn(acc[4 * j + 2 * i], alpha[i]);
        acc[4 * j + 2 * i + 1] = __fmul_rn(acc[4 * j + 2 * i + 1], alpha[i]);
      }

    // acc += p v: per slice of 8 keys, p (A fragment: keys 2t, 2t + 1 of
    // rows r0 and r0 + 8, as registers 4 kk + {0, 2, 1, 3}) split in
    // registers, lo.hi + hi.lo + hi.hi from zero, then one IEEE add; P
    // slices a wait
    {
      float pb[P][D / 2];
#pragma unroll
      for (int j = 0; j < P; ++j)
#pragma unroll
        for (int i = 0; i < D / 2; ++i) pb[j][i] = 0.f;
      mbar_wait(&v_full[s], parity);
#pragma unroll
      for (int kk = 0; kk < BKV / 8; kk += P) {
        uint32_t ah[P][4], al[P][4];
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const int c = 4 * (kk + j);
          tf32_split(__float_as_uint(sc[c]), ah[j][0], al[j][0]);
          tf32_split(__float_as_uint(sc[c + 2]), ah[j][1], al[j][1]);
          tf32_split(__float_as_uint(sc[c + 1]), ah[j][2], al[j][2]);
          tf32_split(__float_as_uint(sc[c + 3]), ah[j][3], al[j][3]);
          fence_regs(pb[j]);
        }
        wg_fence();
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const int off = ((kk + j) / 4) * D * ROW + ((kk + j) % 4) * 32;
          Tf32Mma<D>::rs(pb[j], al[j], at(vd, off), 0);
          Tf32Mma<D>::rs(pb[j], ah[j], at(vd, L::VT_TILE + off), 1);
          Tf32Mma<D>::rs(pb[j], ah[j], at(vd, off), 1);
        }
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int j = 0; j < P; ++j) {
          fence_regs(pb[j]);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) acc[i] = __fadd_rn(acc[i], pb[j][i]);
        }
      }
    }
    mbar_arrive(&v_empty[s]);  // V of tile t is read
  }

  float* ob = o + (static_cast<long long>(bi) * d.Hq + hq) * d.Sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 1));
    l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 2));
    const int row = r0 + 8 * i;
    if (row >= d.Sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];  // rows with no visible key give 0
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(ob + static_cast<long long>(row) * D + 8 * j + cq) =
          make_float2(__fdiv_rn(acc[4 * j + 2 * i], li), __fdiv_rn(acc[4 * j + 2 * i + 1], li));
  }
}

// ---- host -----------------------------------------------------------------

// registers a thread of attn_tf32_kernel<D> was built with, or minus a CUDA
// error
template <int D>
int kernel_registers() {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, attn_tf32_kernel<D>);
  return e == cudaSuccess ? a.numRegs : -static_cast<int>(e);
}

template <int D>
int launch_d(const float* q, const float* k, const float* v, float* o, const Dims& d,
             float scale, cudaStream_t stream) {
  using L = Layout<D>;
  if (d.Skv == 0) {  // no key at all: every row gives 0
    cudaMemsetAsync(o, 0, static_cast<size_t>(d.B) * d.Hq * d.Sq * D * sizeof(float), stream);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (Cfg<D>::NWG == 2) {  // the kernel moves registers by setmaxnreg
    const int regs = kernel_registers<D>();
    if (regs < 0) return -regs;
    if (Cfg<D>::THREADS * regs < SETMAXNREG_NEEDS)
      return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const cudaError_t e = cudaFuncSetAttribute(
      attn_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((d.Sq + Cfg<D>::BQ - 1) / Cfg<D>::BQ, d.Hq, d.B);
  attn_tf32_kernel<D><<<grid, Cfg<D>::THREADS, L::SMEM, stream>>>(q, k, v, o, d, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dims: B, Hq, Hkv, Sq, Skv, D, causal, has_window, window, then the four
// element strides of q, k and v. q, k, v are fp32 with unit last strides,
// 16-byte-aligned bases and the other strides multiples of 4 elements (the
// wrapper checks them); o is a contiguous (B, Hq, Sq, D) fp32.
extern "C" int flash_attention_f32_tf32(const void* q, const void* k, const void* v, void* o,
                                        const long long* dims, float scale, void* stream) {
  Dims d;
  d.B = static_cast<int>(dims[0]);
  d.Hq = static_cast<int>(dims[1]);
  d.Hkv = static_cast<int>(dims[2]);
  d.Sq = static_cast<int>(dims[3]);
  d.Skv = static_cast<int>(dims[4]);
  d.causal = static_cast<int>(dims[6]);
  d.has_window = static_cast<int>(dims[7]);
  d.window = static_cast<int>(dims[8]);
  for (int i = 0; i < 4; ++i) {
    d.sq[i] = dims[9 + i];
    d.sk[i] = dims[13 + i];
    d.sv[i] = dims[17 + i];
  }
  if (d.sq[3] != 1 || d.sk[3] != 1 || d.sv[3] != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (d.B * d.Hq == 0 || d.Sq == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  switch (dims[5]) {
    case 64: return launch_d<64>(qf, kf, vf, of, d, scale, s);
    case 128: return launch_d<128>(qf, kf, vf, of, d, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// registers a thread of the head dim's kernel was built with, and through
// *needed the least that its setmaxnreg split takes (0 where it moves
// none); minus a CUDA error, or 0 for another head dim
extern "C" int flash_attention_tf32_registers(int head_dim, int* needed) {
  switch (head_dim) {
    case 64:
      *needed = (SETMAXNREG_NEEDS + Cfg<64>::THREADS - 1) / Cfg<64>::THREADS;
      return kernel_registers<64>();
    case 128:
      *needed = 0;
      return kernel_registers<128>();
    default: return 0;
  }
}

extern "C" const char* flash_attention_tf32_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Flash attention forward for Hopper on the tensor cores, bf16 q, k, v at
// head dims 64 and 128: o = softmax(q k^T * scale + mask) v.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _attn_kernel, pallas_call at :153) for bf16 operands; it computes
// what flash_attention.cu computes (lines 11-16 there):
//
//   s   = (q . k) * scale, masked to NEG_INF where j >= Skv, j > i (causal)
//         or j <= i - window (sliding window)
//   m'  = max(m, max_j s);  alpha = exp(m - m');  p = exp(s - m')
//         (p = 0 and alpha = 0 while m' is still NEG_INF)
//   l'  = l alpha + sum_j p;  acc' = acc alpha + p v
//   o   = acc / (l == 0 ? 1 : l), rounded once to bf16
//
// GQA maps q head h to kv head h / (Hq / Hkv) with no KV copy; rows that see
// no key give exactly 0. fp32 operands, and bf16 at head dims 16, 32 and
// 256, stay on the FFMA kernel of flash_attention.cu.
//
// Bound on the H100: 4 D FLOP per visible (q, k) pair (the q . k and p v
// multiply-adds) against 4 D bf16 elements read or written per token and
// head; at S 2,048 the work is some hundred times the bytes, so the bound is
// the bf16 tensor-core rate, 989 TFLOP/s (0.01738 ms at the Qwen1.5-0.5B
// prefill shape B 2, H 16, S 2,048, D 64). The tensor cores here do 6 D FLOP
// per visible pair, 1.5x the bound's count, because p enters p v as two
// terms (below); the bound keeps 4 D so that it compares with the FFMA
// kernel's.
//
// Design:
//   * grid and order: one CTA per (b, hq, tile of BQ = 64 query rows), the
//     tiles of the last query rows (which see the most keys under the causal
//     mask) launched first. One consumer warpgroup computes the tile; several
//     CTAs share an SM, so one CTA's softmax overlaps another's products. The
//     CTA walks its KV tiles of BKV = 64 keys in order, only those between
//     the window start and the causal diagonal: no split-KV and no atomics,
//     so the output is bit-identical run to run.
//   * loads: a producer warp (one thread of it) copies the q tile once and
//     each K and V tile by TMA into a ring of STAGES buffers, with one
//     mbarrier per buffer for K, one for V (so q k^T starts before V lands)
//     and one the consumers arrive on when they are done with it. The tensor
//     maps are 4-D over (D, S, H, B), built on the host from the operands'
//     own strides, so attention_block's transposed views load with no copy;
//     the KV and query tails are zero-filled by TMA (and the KV tail masked).
//     Rows are 64 bf16 = 128 bytes under TMA's 128-byte swizzle; D 128 takes
//     two boxes side by side. Every tile starts on 1,024 bytes, so TMA's
//     swizzle and the wgmma descriptors' (layout type 1, 128B) agree.
//   * s = q k^T: wgmma m64n64k16, q and k both K-major from shared memory
//     (a k16 slice is the row start + 32 bytes per slice; SBO = 8 rows of
//     128 bytes). bf16 x bf16 products are exact in fp32: only the order of
//     the sums differs from the plain version.
//   * softmax in registers on the accumulator fragment: scores are kept in
//     the log2 domain (scale * log2 e folded into one multiplier), so p =
//     exp2f(s' - m') in fp32; masks only on tiles that cross one; the row
//     max over the 4 threads of a row by shuffles in a fixed order; l summed
//     per thread from the fp32 p and joined across the row at the end.
//   * acc += p v: the TPU kernel keeps p in fp32 in this product, and p
//     rounded once to bf16 moves most outputs by an ulp (the p_bf16 control
//     of chip_smoke.py). So p is split into two bf16 terms, p_hi = bf16(p)
//     and p_lo = bf16(p - p_hi) (p - p_hi is exact in fp32; the pair keeps
//     about 16 bits of p), and two wgmma m64nDk16 add P_hi V and P_lo V into
//     the fp32 accumulator. The A operand comes from registers: the score
//     accumulator's fragment for 16 keys is the A fragment's layout, packed
//     two bf16 a register, with no shuffle. V is the MN-major B operand
//     (transpose bit; LBO = the 64-column box, SBO = 8 key rows).
//   * epilogue: o = acc / (l == 0 ? 1 : l), rounded once to bf16, stored from
//     registers into o (contiguous, B, Hq, Sq, D).
//
// --use_fast_math stays off. The wrapper (kernels/flash_attention.py)
// checks TMA's rules on q, k and v (16-byte-aligned bases, unit last stride,
// other strides multiples of 16 bytes) and raises on operands that break
// them.

#include "sm90.cuh"

namespace {

constexpr int BQ = 64;                // query rows per CTA: one consumer warpgroup
constexpr int BKV = 64;               // keys per tile
constexpr int CONSUMERS = 128;        // warps 0-3
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int ROW_BYTES = 128;        // one swizzled row: 64 bf16
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int STAGES = D == 64 ? 3 : 2;  // K / V ring (smem_bytes in flash_attention_wgmma.py)
  static constexpr int BOXES = D / 64;             // 64-column boxes side by side
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;     // one K or one V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int SMEM = 1024 + V_OFF + STAGES * KV_BYTES;  // + slack to align to 1,024
};

struct Dims {
  int B, Hq, Hkv, Sq, Skv, causal, has_window, window;
};

// ---- wgmma ----------------------------------------------------------------

// s[64 x 64] (+)= q[64 x 16] k[64 x 16]^T, both K-major from shared memory;
// thread t holds rows 16 (t / 32) + (t % 32) / 4 + 8 i, columns
// 8 j + 2 (t % 4) + c in register 4 j + 2 i + c
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// acc[64 x D] += p[64 x 16] v[16 x D]: p from four registers (two bf16
// each, low half the lower column), v MN-major from shared memory
template <int D>
struct PV;

template <>
struct PV<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct PV<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// two floats as bf16x2, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---- the kernel -----------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, Dims d,
                  float scale_log2) {
  using L = Layout<D>;
  constexpr int ST = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full, k_full[ST], v_full[ST], empty[ST];
  // swizzled tiles start on 1,024 bytes: q, then the K ring, then the V ring
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + L::K_OFF;
  uint8_t* vs = qs + L::V_OFF;

  const int tid = threadIdx.x;
  const int nq = (d.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int hq = blockIdx.y, bi = blockIdx.z;
  const int hk = hq / (d.Hq / d.Hkv);
  // the keys any row of this tile can see: [lo, hi), in tiles from k_first
  int hi = d.Skv;
  if (d.causal) hi = min(hi, q0 + BQ);
  const int lo = d.has_window ? max(0, q0 - d.window + 1) : 0;
  const int k_first = lo / BKV * BKV;
  const int n_tiles = hi > k_first ? (hi - k_first + BKV - 1) / BKV : 0;

  if (tid == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one thread issues every copy
    if (tid == CONSUMERS) {
      mbar_expect_tx(&q_full, L::Q_BYTES);
      for (int c = 0; c < L::BOXES; ++c)
        tma_load_4d(qs + c * BQ * ROW_BYTES, &tq, &q_full, 64 * c, q0, hq, bi);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST, k0 = k_first + t * BKV;
        if (t >= ST) mbar_wait(&empty[s], (t / ST - 1) & 1);  // its last tile was consumed
        uint8_t* kt = ks + s * L::KV_BYTES;
        uint8_t* vt = vs + s * L::KV_BYTES;
        mbar_expect_tx(&k_full[s], L::KV_BYTES);
        for (int c = 0; c < L::BOXES; ++c)
          tma_load_4d(kt + c * BKV * ROW_BYTES, &tk, &k_full[s], 64 * c, k0, hk, bi);
        mbar_expect_tx(&v_full[s], L::KV_BYTES);
        for (int c = 0; c < L::BOXES; ++c)
          tma_load_4d(vt + c * BKV * ROW_BYTES, &tv, &v_full[s], 64 * c, k0, hk, bi);
      }
    }
    return;
  }

  // consumers: this thread's rows are r0 and r0 + 8 of the tile; its columns
  // in each group of 8 are cq and cq + 1 (the wgmma accumulator layout)
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = q0 + warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  mbar_wait(&q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % ST, k0 = k_first + t * BKV;
    const uint32_t parity = (t / ST) & 1;
    const uint8_t* kt = ks + s * L::KV_BYTES;
    const uint8_t* vt = vs + s * L::KV_BYTES;

    // s = q k^T, 16 columns of D a slice
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    mbar_wait(&k_full[s], parity);
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * 64 * ROW_BYTES + (kk % 4) * 32;  // box, then slice in the row
      wgmma_qk(sc, desc(qs + off, 16, 8 * ROW_BYTES), desc(kt + off, 16, 8 * ROW_BYTES), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    // scale into the log2 domain; mask only tiles that cross the KV tail,
    // the causal diagonal or the window start
    const bool inner = k0 + BKV <= d.Skv && (!d.causal || k0 + BKV - 1 <= q0) &&
                       (!d.has_window || k0 > q0 + BQ - 1 - d.window);
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= scale_log2;
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

    // online softmax per row; p as two bf16 A fragments, p_hi and p_lo:
    // keys 16 kk .. 16 kk + 15 are registers 4 kk .. 4 kk + 3 of each
    uint32_t ph[16], pl[16];
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
      // while none, every score of the row is NEG_INF and 2^NEG_INF is 0
      const float m_ref = none ? 0.f : m_new;
      float sum = 0.f;  // this thread's part of the row; joined across the row at the end
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = exp2f(sc[4 * j + 2 * i] - m_ref);
        const float p1 = exp2f(sc[4 * j + 2 * i + 1] - m_ref);
        sum += p0;
        sum += p1;
        const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
        ph[2 * j + i] = *reinterpret_cast<const uint32_t*>(&h);
        pl[2 * j + i] = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
      }
      alpha[i] = none ? 0.f : exp2f(m[i] - m_new);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[4 * j + 2 * i] *= alpha[i];
        acc[4 * j + 2 * i + 1] *= alpha[i];
      }

    // acc += p_hi v + p_lo v, 16 keys a slice (16 rows of 128 bytes)
    mbar_wait(&v_full[s], parity);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      PV<D>::mma(acc, ph + 4 * kk, desc(vt + kk * 16 * ROW_BYTES, BKV * ROW_BYTES, 8 * ROW_BYTES));
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      PV<D>::mma(acc, pl + 4 * kk, desc(vt + kk * 16 * ROW_BYTES, BKV * ROW_BYTES, 8 * ROW_BYTES));
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    mbar_arrive(&empty[s]);  // every product has read stage s
  }

  __nv_bfloat16* ob = o + (static_cast<long long>(bi) * d.Hq + hq) * d.Sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = r0 + 8 * i;
    if (row >= d.Sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];  // rows with no visible key give 0
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long long>(row) * D + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] / li, acc[4 * j + 2 * i + 1] / li);
  }
}

// ---- host -----------------------------------------------------------------

// a 4-D map over (D, S, H, B) of q, k or v from its element strides (B, H,
// S, D order; the D stride is 1), boxes of 64 columns x `rows`, 128-byte swizzle
int encode(CUtensorMap* map, const void* ptr, int D, int s, int h, int b, const long long* st,
           int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, const Dims& d,
             const long long* st, float scale, cudaStream_t stream) {
  using L = Layout<D>;
  if (d.Skv == 0) {  // no key at all: every row gives 0
    const size_t n = static_cast<size_t>(d.B) * d.Hq * d.Sq * D * sizeof(__nv_bfloat16);
    cudaMemsetAsync(o, 0, n, stream);
    return static_cast<int>(cudaGetLastError());
  }
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, D, d.Sq, d.Hq, d.B, st, BQ);
  if (!err) err = encode(&tk, k, D, d.Skv, d.Hkv, d.B, st + 4, BKV);
  if (!err) err = encode(&tv, v, D, d.Skv, d.Hkv, d.B, st + 8, BKV);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      attn_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((d.Sq + BQ - 1) / BQ, d.Hq, d.B);
  attn_wgmma_kernel<D><<<grid, THREADS, L::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), d, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dims: B, Hq, Hkv, Sq, Skv, D, causal, has_window, window, then the four
// element strides of q, k and v. q, k, v are bf16 with unit last strides,
// 16-byte-aligned bases and the other strides multiples of 8 elements (TMA's
// rules; the wrapper checks them); o is a contiguous (B, Hq, Sq, D) bf16.
extern "C" int flash_attention_bf16_wgmma(const void* q, const void* k, const void* v, void* o,
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
  if (d.B * d.Hq == 0 || d.Sq == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dims[5]) {
    case 64: return launch_d<64>(q, k, v, o, d, dims + 9, scale, s);
    case 128: return launch_d<128>(q, k, v, o, d, dims + 9, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

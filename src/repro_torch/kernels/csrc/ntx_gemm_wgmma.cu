// NTX matmul on Hopper's tensor cores: C[M,N] = A[M,K] . B[K,N] over K
// tiles of bk, each tile's product summed from zero in fp32 and joined to the
// accumulator in tile order.
//
// Replaces two TPU kernels that compute the same thing:
//   * repro/kernels/ntx_matmul.py::ntx_matmul (body _matmul_kernel,
//     pallas_call at :93): per K tile prod = dot(a, b) in fp32, then
//     acc += prod, or (s, e) = two_sum(acc, prod), acc = s, comp += e; the
//     last tile stores (acc + comp) cast once to the output type;
//   * repro/kernels/streaming.py::streaming_matmul (body _stream_mm_kernel,
//     pallas_call at :123): acc += dot per K tile of _block(K), stored once.
// The wrappers (kernels/ntx_matmul.py, kernels/streaming.py; tiles, split and
// workspace rules in kernels/gemm_wgmma.py) pass bk: the K tiling is the
// numerics, so the kernel keeps the TPU kernels' structure.
//
// Bound on the H100: at GoogLeNet L1 (100,352 x 576 x 192) fp32 operands
// take 3 x 2MNK = 66.6 GFLOP of tf32 products (0.1345 ms at 495 TFLOP/s)
// against 308.7 MB moved (0.0922 ms), so the tensor cores bound it; bf16
// operands take 22.2 GFLOP (0.0225 ms at 989) against 192.9 MB (0.0576 ms),
// so memory does. The training step's products (streaming_matmul) are tiny
// and long-K: there the bound is parallelism, which the split over K gives.
//
// Numerics:
//   * bf16 operands go to wgmma as they are (k16 slices: exact products,
//     fp32 sums). fp32 operands go as 3xTF32 (k8 slices): each element is
//     split into hi = tf32_rn(x) and lo = tf32_rn(x - hi), round to nearest
//     even at TF32's 10 mantissa bits, and a slice takes three products,
//     the small terms first: lo.hi, hi.lo, hi.hi (lo.lo and the split's
//     residue, about 2^-22 of each product, are dropped);
//   * each slice's products are summed from zero on the tensor cores and the
//     slice's sum is added to the tile's sum with __fadd_rn: the tensor
//     cores' own sums, whose rounding is not IEEE's, never run longer than
//     one slice;
//   * slices never cross a K tile boundary; a tile whose width is not a
//     multiple of the stage depth is padded with zeros by the loads' masks
//     (zero products change no sum);
//   * after a tile's last slice its sum is joined: acc += prod, or 2Sum
//     written with __fadd_rn / __fsub_rn (nvcc neither contracts nor
//     reorders them) and comp += e; acc (+ comp) leaves once, rounded once
//     (__float2bfloat16_rn for a bf16 output). No float atomics.
//
// Design:
//   * grid: one CTA per BM x BN = 128 x 64 tile of C (the column tiles of
//     one row tile are neighbours in launch order, so A is read from device
//     memory about once) and per part of the split over K. Two consumer
//     warpgroups own 64 rows each; two producer warpgroups fill alternate
//     stages of a ring (3 stages fp32, 4 bf16), so two stages' loads are in
//     flight. 512 threads at 128 registers, one CTA an SM. Each consumer
//     thread keeps the slice's sum and the tile's sum in registers, and its
//     acc and comp in shared memory, which the join touches once a tile
//     (fp32: 214,016 bytes of shared memory).
//   * a stage is 128 bytes of K for every row of the A tile and of the B
//     tile (32 fp32 or 64 bf16); both operands are stored K-major, which
//     tf32 wgmma requires, so B is transposed on its way in. Rows sit under
//     the 128-byte swizzle (16-byte chunk c of row r at chunk c ^ r % 8),
//     every tile on 1,024 bytes; fp32 stages hold a hi and a lo tile of each.
//   * the producers load through registers: any row and column strides,
//     16-byte loads where 16 bytes of K are contiguous, aligned and whole
//     (for bf16 also 16 bytes along the rows of a row-major B, transposed
//     in registers), else element loads; neighbouring threads walk the
//     operand's unit-stride axis. The layout in shared memory does not
//     depend on the strides, so a strided view and its contiguous copy take
//     the same arithmetic. Each producer thread fences its stores for the
//     async proxy (fence.proxy.async) before it arrives on the stage's full
//     barrier.
//   * a consumer waits for each slice's products before its IEEE add, so its
//     tensor-core work is serialised slice by slice; the two consumer
//     warpgroups take turns.
//   * split over K: where M x N gives too few tiles to fill the card, the K
//     tiles are dealt out in contiguous ranges across CTAs (blockIdx.y). Each
//     CTA then writes each tile's own partial to a workspace of
//     k_tiles x M x N fp32, and a second launch joins the partials in tile
//     order with the same join. A tile's partial does not depend on which
//     CTA formed it, so the split changes no bit.

#include "sm90.cuh"

#include <climits>

namespace {

constexpr int BM = 128;  // rows of C per CTA: two consumer warpgroups of 64
constexpr int BN = 64;   // columns of C per CTA
constexpr int CONSUMERS = 256;  // warps 0-7
constexpr int LOADERS = 128;    // threads of a producer warpgroup, which fills a stage
constexpr int NPROD = 2;       // producer warpgroups: warps 8-15, each filling every other stage
constexpr int PRODUCERS = NPROD * LOADERS;
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int ROW = 128;  // bytes of K of one row in a stage
constexpr int A_BYTES = BM * ROW;
constexpr int B_BYTES = BN * ROW;

enum class Out { kPartial, kAdd, kTwoSum };

// per operand type: tiles per operand and stage (fp32: hi, lo), K elements
// per stage and per wgmma slice, stages in the ring, and the raw element
template <typename T>
struct Fmt;
template <>
struct Fmt<float> {
  static constexpr int PARTS = 2, BK = 32, SLICE = 8, STAGES = 3;
  using Raw = uint32_t;
};
template <>
struct Fmt<__nv_bfloat16> {
  static constexpr int PARTS = 1, BK = 64, SLICE = 16, STAGES = 4;
  using Raw = uint16_t;
};

// dynamic shared memory: 1,024 bytes of slack to align the swizzled tiles,
// the ring, then each consumer thread's accumulator and compensation
template <typename T>
struct Layout {
  static constexpr int STAGE = Fmt<T>::PARTS * (A_BYTES + B_BYTES);
  static constexpr int ACC = Fmt<T>::STAGES * STAGE;  // offset of acc; comp follows
  static constexpr int SMEM = 1024 + ACC + 2 * 32 * CONSUMERS * 4;
};

// an operand as rows of K: element (r, k) at p[r * sr + k * sk]; A's rows
// are m, B's are n
template <typename T>
struct Operand {
  const typename Fmt<T>::Raw* p;
  int rows;
  long long sr, sk;
};

struct Args {
  const void* a;
  const void* b;
  void* c;
  float* ws;
  int M, N, K, bk, k_tiles, per;  // per: K tiles per CTA of the split
  long long sam, sak, sbk, sbn;
};

// ---- the producer ---------------------------------------------------------

// How a producer warpgroup reads an operand into a stage of R rows. Each
// thread holds R / 16 loads of 16 bytes in registers (uint32_t[R / 16][4]):
//   * kChunks: chunk i is 16 bytes of K of one row (chunk_at), neighbouring
//     threads along K; a 16-byte load where the chunk is contiguous, aligned
//     and whole, else element loads (any strides);
//   * kRowsFast: the same chunks, neighbouring threads along the rows (the
//     rows are contiguous, K is not: a.T, or B row-major), element loads;
//   * kBlocks (bf16): the rows are contiguous and every K step 16-byte
//     aligned (B row-major): load i is 8 rows at one k, and four loads
//     (k .. k + 3) make a block of 8 rows x 4 K, transposed in registers on
//     its way into shared memory. fp32 keeps kRowsFast there: the blocks
//     measured slower with the split.
enum class Read { kChunks, kRowsFast, kBlocks };

template <typename T>
__device__ __forceinline__ Read read_of(const Operand<T>& op) {
  if (op.sr != 1 || op.sk == 1) return Read::kChunks;
  const bool aligned = op.sk * sizeof(typename Fmt<T>::Raw) % 16 == 0 &&
                       (reinterpret_cast<uintptr_t>(op.p) & 15) == 0;
  return Fmt<T>::PARTS == 1 && aligned ? Read::kBlocks : Read::kRowsFast;
}

// chunk i of a producer thread (kChunks, kRowsFast): row r, 16-byte chunk c
template <int R>
__device__ __forceinline__ void chunk_at(int i, int pt, Read mode, int& r, int& c) {
  const int e = pt + i * LOADERS;
  r = mode == Read::kRowsFast ? e % R : e / 8;
  c = mode == Read::kRowsFast ? e / R : e % 8;
}

// block h of a producer thread (kBlocks): its first row, and its group of 4 K
template <typename T, int R>
__device__ __forceinline__ void block_at(int h, int pt, int& r, int& kg) {
  constexpr int GROUPS = R * sizeof(typename Fmt<T>::Raw) / 16;  // blocks along the rows
  const int bi = pt + h * LOADERS;
  r = bi % GROUPS * (16 / sizeof(typename Fmt<T>::Raw));
  kg = bi / GROUPS;
}

// this thread's loads of one stage of an operand, rows row0.. and K k0.., into
// registers; 0 past kend and past the operand's last row
template <typename T, int R>
__device__ __forceinline__ void fetch(uint32_t (&v)[R / 16][4], const Operand<T>& op, Read mode,
                                      int row0, int k0, int kend, int pt) {
  using Raw = typename Fmt<T>::Raw;
  constexpr int EPC = 16 / sizeof(Raw);  // elements per 16 bytes
#pragma unroll
  for (int i = 0; i < R / 16; ++i) {
    v[i][0] = v[i][1] = v[i][2] = v[i][3] = 0u;
    if (Fmt<T>::PARTS == 1 && mode == Read::kBlocks) {  // load i: k 4 kg + i % 4 of block i / 4
      int r, kg;
      block_at<T, R>(i / 4, pt, r, kg);
      const int gr = row0 + r, kc = k0 + 4 * kg + i % 4;
      if (gr >= op.rows || kc >= kend) continue;
      const Raw* q = op.p + gr + kc * op.sk;
      if (gr + EPC <= op.rows) {
        const uint4 x = *reinterpret_cast<const uint4*>(q);
        v[i][0] = x.x, v[i][1] = x.y, v[i][2] = x.z, v[i][3] = x.w;
        continue;
      }
#pragma unroll
      for (int j = 0; j < EPC; ++j) {
        const uint32_t x = gr + j < op.rows ? static_cast<uint32_t>(q[j]) : 0u;
        v[i][j * sizeof(Raw) / 4] |= x << (8 * sizeof(Raw) * j % 32);
      }
      continue;
    }
    int r, c;
    chunk_at<R>(i, pt, mode, r, c);
    const int gr = row0 + r, kc = k0 + c * EPC;
    if (gr >= op.rows || kc >= kend) continue;
    const Raw* q = op.p + gr * op.sr + kc * op.sk;
    if (op.sk == 1 && kc + EPC <= kend && (reinterpret_cast<uintptr_t>(q) & 15) == 0) {
      const uint4 x = *reinterpret_cast<const uint4*>(q);
      v[i][0] = x.x, v[i][1] = x.y, v[i][2] = x.z, v[i][3] = x.w;
    } else {
#pragma unroll
      for (int j = 0; j < EPC; ++j) {
        const uint32_t x = kc + j < kend ? static_cast<uint32_t>(q[j * op.sk]) : 0u;
        v[i][j * sizeof(Raw) / 4] |= x << (8 * sizeof(Raw) * j % 32);
      }
    }
  }
}

// x, 16 or 8 bytes of K of row r, at byte b of the row's chunk c in the
// tile(s) at dst: row r at r * ROW, chunk c at chunk c ^ r % 8; fp32 split
// into hi at dst and lo R rows further
template <typename T, int R, int N>
__device__ __forceinline__ void put_k(uint8_t* dst, int r, int c, int b, const uint32_t (&x)[N]) {
  uint8_t* d = dst + r * ROW + ((c ^ (r & 7)) << 4) + b;
  if constexpr (Fmt<T>::PARTS == 2) {
    static_assert(N == 4, "fp32 goes as whole chunks");
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) tf32_split(x[j], hi[j], lo[j]);
    *reinterpret_cast<uint4*>(d) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(d + R * ROW) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint4*>(d) = make_uint4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<uint2*>(d) = make_uint2(x[0], x[1]);
  }
}

// the loads into the operand's swizzled tile(s) at dst
template <typename T, int R>
__device__ __forceinline__ void stow(uint8_t* dst, const uint32_t (&v)[R / 16][4], Read mode,
                                     int pt) {
  constexpr int EPC = 16 / sizeof(typename Fmt<T>::Raw);
  if constexpr (Fmt<T>::PARTS == 1) {
    if (mode == Read::kBlocks) {  // block h: loads 4 h .. 4 h + 3, one k each
#pragma unroll
      for (int h = 0; h < R / 64; ++h) {
        int r, kg;
        block_at<T, R>(h, pt, r, kg);
#pragma unroll
        for (int e = 0; e < EPC; ++e) {  // row r + e: 4 K, element e of each load, 8 bytes
          uint32_t k4[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) k4[j] = (v[4 * h + j][e / 2] >> (16 * (e % 2))) & 0xffffu;
          const uint32_t x[2] = {k4[0] | k4[1] << 16, k4[2] | k4[3] << 16};
          put_k<T, R>(dst, r + e, kg / 2, 8 * (kg % 2), x);
        }
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < R / 16; ++i) {
    int r, c;
    chunk_at<R>(i, pt, mode, r, c);
    put_k<T, R>(dst, r, c, 0, v[i]);
  }
}

// walks the stages of a CTA's K tiles: stage k0.. of tile kt, which ends at kend
template <typename T>
struct Cursor {
  int kt, k0, kend;
  __device__ __forceinline__ void start(const Args& g, int tile) {
    kt = tile;
    k0 = tile * g.bk;
    kend = static_cast<int>(min(static_cast<long long>(tile + 1) * g.bk,
                                static_cast<long long>(g.K)));
  }
  __device__ __forceinline__ void next(const Args& g) {
    k0 += Fmt<T>::BK;
    if (k0 >= kend) start(g, kt + 1);
  }
};

// ---- wgmma ----------------------------------------------------------------

// d[64 x 64] = scale_d d + a[64 x SLICE] b[SLICE x 64], a and b K-major in
// shared memory; thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4
// + 8 i, columns 8 j + 2 (t % 4) + c in register 4 j + 2 i + c
template <typename T>
struct Mma;

template <>
struct Mma<float> {  // tf32
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
    Tf32Mma<64>::ss(d, a, b, scale_d);
  }
};

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : SM90_ACC32(d)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// ---- the join -------------------------------------------------------------

template <bool COMP>
__device__ __forceinline__ void join(float& acc, float& comp, float p) {
  if constexpr (COMP) {  // acc + p = s + e exactly
    const float s = __fadd_rn(acc, p);
    const float bp = __fsub_rn(s, acc);
    const float ap = __fsub_rn(s, bp);
    const float e = __fadd_rn(__fsub_rn(acc, ap), __fsub_rn(p, bp));
    acc = s;
    comp = __fadd_rn(comp, e);
  } else {
    acc = __fadd_rn(acc, p);
  }
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// ---- the kernel -----------------------------------------------------------

// slice kk of a stage (32 bytes of K) into d, from zero: fp32 lo.hi, hi.lo,
// hi.hi (the small terms first); bf16 one product. Committed as one group.
template <typename T>
__device__ __forceinline__ void issue(float (&d)[32], const uint8_t* at, const uint8_t* bt,
                                      int kk) {
  at += 32 * kk;
  bt += 32 * kk;
  fence_regs(d);
  wg_fence();
  if constexpr (Fmt<T>::PARTS == 2) {
    Mma<T>::run(d, kdesc(at + A_BYTES), kdesc(bt), 0);
    Mma<T>::run(d, kdesc(at), kdesc(bt + B_BYTES), 1);
    Mma<T>::run(d, kdesc(at), kdesc(bt), 1);
  } else {
    Mma<T>::run(d, kdesc(at), kdesc(bt), 0);
  }
  wg_commit();
}

// a retired slice's sum d added to the tile's sum with IEEE adds
__device__ __forceinline__ void add_to(float (&prod)[32], float (&d)[32]) {
  fence_regs(d);
#pragma unroll
  for (int i = 0; i < 32; ++i) prod[i] = __fadd_rn(prod[i], d[i]);
}

// fragment register i of a consumer thread: row m, column n of C
__device__ __forceinline__ void frag_at(int i, int row, int col, int& m, int& n) {
  m = row + 8 * ((i / 2) % 2);
  n = col + 8 * (i / 4) + i % 2;
}

template <typename T, Out OUT, typename TOut>
__global__ void __launch_bounds__(THREADS, 1) gemm_kernel(const Args g) {
  using F = Fmt<T>;
  using L = Layout<T>;
  constexpr int STAGES = F::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int n_tiles = (g.N + BN - 1) / BN;
  const int m0 = blockIdx.x / n_tiles * BM;
  const int n0 = blockIdx.x % n_tiles * BN;
  const int kt0 = blockIdx.y * g.per;
  const int kt1 = min(kt0 + g.per, g.k_tiles);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], LOADERS);  // the producer warpgroup that fills the stage
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // producer warpgroup p fills the stages t with t % 2 == p
    const int p = (tid - CONSUMERS) / LOADERS, pt = tid % LOADERS;
    const Operand<T> a{static_cast<const typename F::Raw*>(g.a), g.M, g.sam, g.sak};
    const Operand<T> b{static_cast<const typename F::Raw*>(g.b), g.N, g.sbn, g.sbk};
    const Read ra = read_of(a), rb = read_of(b);
    uint32_t va[BM / 16][4], vb[BN / 16][4];
    Cursor<T> cur;
    cur.start(g, kt0);
    for (int t = 0; cur.kt < kt1; ++t, cur.next(g)) {
      if (t % NPROD != p) continue;
      fetch<T, BM>(va, a, ra, m0, cur.k0, cur.kend, pt);
      fetch<T, BN>(vb, b, rb, n0, cur.k0, cur.kend, pt);
      const int s = t % STAGES;
      if (t >= STAGES) mbar_wait(&empty[s], (t / STAGES - 1) & 1);  // its last stage was consumed
      uint8_t* st = smem + s * L::STAGE;
      stow<T, BM>(st, va, ra, pt);
      stow<T, BN>(st + F::PARTS * A_BYTES, vb, rb, pt);
      fence_proxy_async();
      mbar_arrive(&full[s]);
    }
    return;
  }

  // consumers: warpgroup w owns rows 64 w .. 64 w + 63 of the tile; acc and
  // comp (one slot a thread and fragment register) live in shared memory
  const int w = tid / 128;
  float sl[32], prod[32];
  float* acc = reinterpret_cast<float*>(smem + L::ACC) + tid;
  float* comp = acc + 32 * CONSUMERS;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sl[i] = prod[i] = 0.f;
    if constexpr (OUT != Out::kPartial) acc[i * CONSUMERS] = comp[i * CONSUMERS] = 0.f;
  }
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int row = m0 + 64 * w + 16 * warp + lane / 4;  // + 8 i
  const int col = n0 + 2 * (lane % 4);                 // + 8 j + c

  Cursor<T> cur;
  cur.start(g, kt0);
  for (int t = 0; cur.kt < kt1; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const uint8_t* at = smem + s * L::STAGE + w * 64 * ROW;
    const uint8_t* bt = smem + s * L::STAGE + F::PARTS * A_BYTES;
#pragma unroll
    for (int kk = 0; kk < F::BK / F::SLICE; ++kk) {  // each slice summed from zero, then added
      issue<T>(sl, at, bt, kk);
      wg_wait<0>();
      add_to(prod, sl);
    }
    mbar_arrive(&empty[s]);
    const int kt = cur.kt;
    cur.next(g);
    if (cur.kt == kt) continue;
    // the K tile is complete: its partial to the workspace, or joined in tile order
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if constexpr (OUT == Out::kPartial) {
        int m, n;
        frag_at(i, row, col, m, n);
        if (m < g.M && n < g.N) g.ws[(static_cast<long long>(kt) * g.M + m) * g.N + n] = prod[i];
      } else {
        float sum = acc[i * CONSUMERS], e = comp[i * CONSUMERS];
        join<OUT == Out::kTwoSum>(sum, e, prod[i]);
        acc[i * CONSUMERS] = sum;
        if constexpr (OUT == Out::kTwoSum) comp[i * CONSUMERS] = e;
      }
      prod[i] = 0.f;
    }
  }

  if constexpr (OUT != Out::kPartial) {
    TOut* c = static_cast<TOut*>(g.c);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      int m, n;
      frag_at(i, row, col, m, n);
      if (m < g.M && n < g.N)
        put(c + static_cast<long long>(m) * g.N + n,
            OUT == Out::kTwoSum ? __fadd_rn(acc[i * CONSUMERS], comp[i * CONSUMERS])
                                : acc[i * CONSUMERS]);
    }
  }
}

// the second pass of a split: each element's K-tile partials joined in tile order
template <typename TOut, bool COMP>
__global__ void join_kernel(const float* __restrict__ ws, TOut* __restrict__ c, long long mn,
                            int k_tiles) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < mn;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float acc = 0.f, comp = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt) join<COMP>(acc, comp, ws[kt * mn + i]);
    put(c + i, COMP ? __fadd_rn(acc, comp) : acc);
  }
}

// ---- host -----------------------------------------------------------------

template <typename T, Out OUT, typename TOut>
int launch_gemm(const Args& g, int tiles, int parts, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<T, OUT, TOut>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<T>::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  gemm_kernel<T, OUT, TOut><<<dim3(tiles, parts), THREADS, Layout<T>::SMEM, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_in(const Args& g, int out_type, bool comp, int tiles, int parts, cudaStream_t s) {
  if (parts > 1) return launch_gemm<T, Out::kPartial, float>(g, tiles, parts, s);
  if (out_type == 0)
    return comp ? launch_gemm<T, Out::kTwoSum, float>(g, tiles, 1, s)
                : launch_gemm<T, Out::kAdd, float>(g, tiles, 1, s);
  return comp ? launch_gemm<T, Out::kTwoSum, __nv_bfloat16>(g, tiles, 1, s)
              : launch_gemm<T, Out::kAdd, __nv_bfloat16>(g, tiles, 1, s);
}

template <typename TOut>
void launch_join(const Args& g, bool comp, cudaStream_t s) {
  const long long mn = static_cast<long long>(g.M) * g.N;
  const int blocks = static_cast<int>(mn < 4096LL * 256 ? (mn + 255) / 256 : 4096LL);
  if (comp)
    join_kernel<TOut, true><<<blocks, 256, 0, s>>>(g.ws, static_cast<TOut*>(g.c), mn, g.k_tiles);
  else
    join_kernel<TOut, false><<<blocks, 256, 0, s>>>(g.ws, static_cast<TOut*>(g.c), mn, g.k_tiles);
}

}  // namespace

// C (M, N) contiguous = A (M, K) . B (K, N), A and B of one type (in_type 0
// float32, 1 bfloat16) read through their strides; out_type 0 float32, 1
// bfloat16; K tiles of bk joined in order, by 2Sum if compensated. The K
// tiles are dealt out to `split` CTAs per tile of C (in ranges of
// ceil(k_tiles / split)); where that is more than one, ws holds
// k_tiles x M x N floats.
extern "C" int ntx_gemm_wgmma(const void* a, const void* b, void* c, void* ws, int in_type,
                              int out_type, int compensated, int M, int N, int K, int bk,
                              int split, long long sam, long long sak, long long sbk,
                              long long sbn, void* stream) {
  if (M < 0 || N < 0 || K < 0 || bk < 1 || split < 1 || in_type < 0 || in_type > 1 ||
      out_type < 0 || out_type > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  Args g{a, b, c, static_cast<float*>(ws), M, N, K, bk, 0, 1, sam, sak, sbk, sbn};
  g.k_tiles = K == 0 ? 0 : (K - 1) / bk + 1;
  g.per = g.k_tiles == 0 ? 1 : (g.k_tiles + split - 1) / split;
  const int parts = g.k_tiles == 0 ? 1 : (g.k_tiles + g.per - 1) / g.per;
  const long long tiles = static_cast<long long>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles > INT_MAX || parts > 65535 || (parts > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(tiles);
  const int err = in_type == 0 ? launch_in<float>(g, out_type, compensated, n, parts, s)
                               : launch_in<__nv_bfloat16>(g, out_type, compensated, n, parts, s);
  if (err || parts == 1) return err;
  if (out_type == 0) launch_join<float>(g, compensated, s);
  else launch_join<__nv_bfloat16>(g, compensated, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ntx_gemm_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The SIMT FFMA GEMM loop that the matmul and convolution kernels share.
//
// One CTA of 256 threads sums a BM x BN output block over a reduction of
// length K, BN = 64 and BM = 128 or 64 (a template argument: 64 keeps more
// CTAs busy where M is small); each thread owns a TM x 4 register block,
// TM = BM / 16, fed per reduction step by TM / 4 + 1 16-byte shared loads.
// The reduction is cut into tiles of bk, and each tile into chunks of
// BK = 16 that never cross a tile boundary. A chunk is loaded from device
// memory into registers while the one before it is summed from shared
// memory, then staged into the other of two shared slots.
//
// Two hooks make a kernel of it:
//   * the operand loaders. A loader has load(regs, kc0, kend), which reads
//     this thread's share of reduction indices [kc0, kend) of the chunk
//     (0 past kend or past the operand's edge), and stage(slot, regs).
//     StridedA / StridedB read a matrix through row and column strides;
//     a kernel may bring its own (the convolution's im2col gather);
//   * the join at the end of each K tile: Join::kAdd sums each tile from 0
//     and adds it to the accumulator; Join::kTap does too, for tiles of any
//     length (the convolution's taps, Cin long): its chunks run on across
//     tile ends and the join falls between two reduction steps of a chunk;
//     Join::kTwoSum joins it by 2Sum, written with
//     __fadd_rn / __fsub_rn, which nvcc neither contracts nor reorders, and
//     adds the error to a compensation term.
// The result leaves gemm() once, in `out`; the kernel stores it. No split-K
// and no atomics: the same bits on every run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {
namespace ffma {

constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;  // 16 x 16 threads, each a (BM / 16) x TN output block
constexpr int TN = 4;
constexpr int PAD = 4;  // shared row padding: rows stay 16-byte aligned
constexpr int B_LOADS = BK * BN / THREADS;  // 4
template <int BM>
constexpr int A_LOADS = BM * BK / THREADS;  // 8 or 4

enum class Join { kAdd, kTap, kTwoSum };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int BM>
struct Tiles {
  float a[2][BK][BM + PAD];  // a[k][m]
  float b[2][BK][BN + PAD];  // b[k][n]
};

// Register i of this thread's share of a chunk: neighbouring threads walk
// the operand's unit-stride axis.
template <int BM>
__device__ __forceinline__ void a_slot(int i, bool k_fast, int& mm, int& kk) {
  const int e = threadIdx.x + i * THREADS;
  mm = k_fast ? e / BK : e % BM;
  kk = k_fast ? e % BK : e / BM;
}

__device__ __forceinline__ void b_slot(int i, bool n_fast, int& kk, int& nn) {
  const int e = threadIdx.x + i * THREADS;
  nn = n_fast ? e % BN : e / BK;
  kk = n_fast ? e / BN : e % BK;
}

// Rows m0.. of A[M, K], read through its strides.
template <typename T, int BM>
struct StridedA {
  const T* p;
  int M, m0;
  long long sm, sk;

  __device__ __forceinline__ void load(float (&r)[A_LOADS<BM>], int kc0, int kend) const {
#pragma unroll
    for (int i = 0; i < A_LOADS<BM>; ++i) {
      int mm, kk;
      a_slot<BM>(i, sk == 1, mm, kk);
      const int gm = m0 + mm, gk = kc0 + kk;
      r[i] = (gm < M && gk < kend) ? widen(p[gm * sm + gk * sk]) : 0.f;
    }
  }
  __device__ __forceinline__ void stage(float (&s)[BK][BM + PAD],
                                        const float (&r)[A_LOADS<BM>]) const {
#pragma unroll
    for (int i = 0; i < A_LOADS<BM>; ++i) {
      int mm, kk;
      a_slot<BM>(i, sk == 1, mm, kk);
      s[kk][mm] = r[i];
    }
  }
};

// Columns n0.. of B[K, N], read through its strides.
template <typename T>
struct StridedB {
  const T* p;
  int N, n0;
  long long sk, sn;

  __device__ __forceinline__ void load(float (&r)[B_LOADS], int kc0, int kend) const {
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      int kk, nn;
      b_slot(i, sn == 1, kk, nn);
      const int gk = kc0 + kk, gn = n0 + nn;
      r[i] = (gk < kend && gn < N) ? widen(p[gk * sk + gn * sn]) : 0.f;
    }
  }
  __device__ __forceinline__ void stage(float (&s)[BK][BN + PAD],
                                        const float (&r)[B_LOADS]) const {
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      int kk, nn;
      b_slot(i, sn == 1, kk, nn);
      s[kk][nn] = r[i];
    }
  }
};

// This thread's TM x TN outputs (rows (tid / 16) * TM.., columns
// (tid % 16) * TN.. of the block) summed over K in tiles of bk. Ends with a
// __syncthreads(), so a CTA may call it again on the same Tiles.
template <Join JOIN, int BM, typename LoadA, typename LoadB>
__device__ __forceinline__ void gemm(Tiles<BM>& sm, const LoadA& la, const LoadB& lb, int K,
                                     int bk, float (&out)[BM / 16][TN]) {
  constexpr int TM = BM / 16;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  // The chunk sequence: K tiles of bk, each cut into ceil(bk / BK) chunks;
  // the last tile keeps only its chunks that start below K. kTap's chunks
  // cut all of K as one tile.
  const int cbk = JOIN == Join::kTap ? K : bk;  // the tiles chunks do not cross
  const int cpt = (cbk + BK - 1) / BK;
  const int k_tiles = (K + cbk - 1) / cbk;
  const int n_chunks =
      k_tiles == 0 ? 0 : (k_tiles - 1) * cpt + (K - (k_tiles - 1) * cbk + BK - 1) / BK;

  float ra[A_LOADS<BM>], rb[B_LOADS];
  int kc0 = 0, tile_end = min(cbk, K);  // the next chunk to load starts at kc0
  auto load = [&]() {  // the next chunk from device memory into registers
    const int kend = min(kc0 + BK, tile_end);
    la.load(ra, kc0, kend);
    lb.load(rb, kc0, kend);
    kc0 = kend;
    if (kc0 == tile_end) tile_end = min(tile_end + cbk, K);
  };
  auto join = [&](float (&acc_)[TM][TN], float (&comp_)[TM][TN], float (&prod_)[TM][TN]) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = prod_[i][j];
        if constexpr (JOIN == Join::kTwoSum) {  // acc + p = s + e exactly
          const float s = __fadd_rn(acc_[i][j], p);
          const float bp = __fsub_rn(s, acc_[i][j]);
          const float ap = __fsub_rn(s, bp);
          const float e = __fadd_rn(__fsub_rn(acc_[i][j], ap), __fsub_rn(p, bp));
          acc_[i][j] = s;
          comp_[i][j] = __fadd_rn(comp_[i][j], e);
        } else {
          acc_[i][j] = __fadd_rn(acc_[i][j], p);
        }
        prod_[i][j] = 0.f;
      }
  };
  auto stage = [&](int slot) {  // registers into shared memory
    la.stage(sm.a[slot], ra);
    lb.stage(sm.b[slot], rb);
  };

  float acc[TM][TN], comp[TM][TN], prod[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = comp[i][j] = prod[i][j] = 0.f;

  if (n_chunks > 0) {
    load();
    stage(0);
  }
  __syncthreads();
  int tap_left = bk;  // kTap: reduction steps left in the current tile
  for (int c = 0, jc = 0; c < n_chunks; ++c) {  // jc: chunk c within its K tile
    const int cur = c & 1;
    if (c + 1 < n_chunks) load();  // chunk c + 1, in flight while chunk c is summed
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
#pragma unroll
      for (int q = 0; q < TM; q += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&sm.a[cur][kk][ty * TM + q]);
        a[q] = v.x, a[q + 1] = v.y, a[q + 2] = v.z, a[q + 3] = v.w;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[cur][kk][tx * TN]);
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) prod[i][j] = fmaf(a[i], b[j], prod[i][j]);
      if constexpr (JOIN == Join::kTap) {  // past K only zeros join, adding nothing
        if (--tap_left == 0) {
          join(acc, comp, prod);
          tap_left = bk;
        }
      }
    }
    if (JOIN != Join::kTap && (jc == cpt - 1 || c + 1 == n_chunks)) join(acc, comp, prod);
    jc = jc == cpt - 1 ? 0 : jc + 1;
    if (c + 1 < n_chunks) stage(cur ^ 1);
    __syncthreads();  // chunk c+1 is staged, and nobody reads slot `cur` any more
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      out[i][j] = JOIN == Join::kTwoSum ? __fadd_rn(acc[i][j], comp[i][j]) : acc[i][j];
}

// C[M, N] = A[M, K] . B[K, N], one CTA per BM x BN block of the contiguous C.
template <typename TIn, typename TOut, Join JOIN, int BM>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const TIn* __restrict__ A, const TIn* __restrict__ B, TOut* __restrict__ C,
              int M, int N, int K, int bk, long long sam, long long sak, long long sbk,
              long long sbn) {
  constexpr int TM = BM / 16;
  __shared__ __align__(16) Tiles<BM> sm;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  float out[TM][TN];
  gemm<JOIN>(sm, StridedA<TIn, BM>{A, M, m0, sam, sak}, StridedB<TIn>{B, N, n0, sbk, sbn}, K,
             bk, out);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + (threadIdx.x / 16) * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + (threadIdx.x % 16) * TN + j;
      if (gn < N) put(C + static_cast<long long>(gm) * N + gn, out[i][j]);
    }
  }
}

template <typename TIn, typename TOut, Join JOIN, int BM = 128>
void launch_matmul(const void* a, const void* b, void* c, int M, int N, int K, int bk,
                   long long sam, long long sak, long long sbk, long long sbn,
                   cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  matmul_kernel<TIn, TOut, JOIN, BM><<<grid, THREADS, 0, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b), static_cast<TOut*>(c), M, N, K,
      bk, sam, sak, sbk, sbn);
}

}  // namespace ffma
}  // namespace

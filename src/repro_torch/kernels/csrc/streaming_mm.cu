// Streaming fp32 matmul for Hopper: C[M,N] = A[M,K] . B[K,N].
//
// Replaces the TPU kernel repro/kernels/streaming.py::streaming_matmul
// (body _stream_mm_kernel): M/N output blocks, K streamed through two VMEM
// slots with a manual prefetch of tile k+1 while tile k contracts, into an
// fp32 accumulator that is stored once.
//
// Bound on the H100: at the shapes the training step gives it (im2col
// columns of B*oh*ow rows against 16..32 output channels, the fc head at
// batch 64) N is small and arithmetic intensity is a few FLOP per byte, so
// the bound is device-memory bandwidth, not the 67 TFLOP/s fp32 pipe.
//
// Design:
//   * one CTA per 64x64 output tile; the CTA loops over the K tiles itself,
//     so there is no cross-block reduction and no atomics;
//   * the A and B tiles are staged through two shared-memory buffers with
//     cp.async: tile k+1 is in flight while tile k is contracted (the
//     counterpart of the make_async_copy ping-pong);
//   * ragged M/N/K edges are masked: an out-of-range element is zero-filled
//     by cp.async (src-size 0) instead of padding copies on the host;
//   * A and B are addressed through row and column strides, so transposed
//     views (a.T for dW, b.T for dX) need no copy;
//   * each thread owns a 4x4 sub-tile; the products of one K tile are summed
//     into a tile partial first and then added to the accumulator, as the
//     TPU kernel adds one tile dot at a time. fp32 FFMA, no TF32, no tensor
//     cores. The accumulator leaves registers exactly once.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;  // 16 x 16, each thread a 4x4 sub-tile
constexpr int PAD = 4;        // shared-memory row padding against bank conflicts

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 4 : 0;  // src-size 0 -> the 4 bytes are zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(THREADS)
stream_mm_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
                 int M, int N, int K, long long sam, long long sak, long long sbk, long long sbn) {
  __shared__ float As[2][BK][BM + PAD];  // As[k][m]
  __shared__ float Bs[2][BK][BN + PAD];  // Bs[k][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_tiles = (K + BK - 1) / BK;
  // neighbouring threads walk the operand's unit-stride axis
  const bool a_k_fast = (sak == 1);
  const bool b_n_fast = (sbn == 1);

  auto load = [&](int slot, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int mm = a_k_fast ? e / BK : e % BM;
      const int kk = a_k_fast ? e % BK : e / BM;
      const int gm = m0 + mm, gk = k0 + kk;
      const bool ok = gm < M && gk < K;
      const float* src = ok ? A + gm * sam + gk * sak : A;
      cp_async4(&As[slot][kk][mm], src, ok);
    }
#pragma unroll
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int nn = b_n_fast ? e % BN : e / BK;
      const int kk = b_n_fast ? e / BN : e % BK;
      const int gk = k0 + kk, gn = n0 + nn;
      const bool ok = gk < K && gn < N;
      const float* src = ok ? B + gk * sbk + gn * sbn : B;
      cp_async4(&Bs[slot][kk][nn], src, ok);
    }
    cp_async_commit();
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (k_tiles > 0) load(0, 0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < k_tiles) {
      load(cur ^ 1, kt + 1);  // prefetch the next tile into the other slot
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float t[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) t[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[cur][kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[cur][kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) t[i][j] = fmaf(a[i], b[j], t[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += t[i][j];
    __syncthreads();  // every thread is done with `cur` before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) C[static_cast<long long>(gm) * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int streaming_mm_f32(const void* a, const void* b, void* c, int M, int N, int K,
                                long long sam, long long sak, long long sbk, long long sbn,
                                void* stream) {
  if (M > 0 && N > 0) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    stream_mm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), M, N,
        K, sam, sak, sbk, sbn);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* streaming_mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

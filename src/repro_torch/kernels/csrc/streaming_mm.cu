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
// Design: the shared GEMM loop of ffma_tile.cuh with K tiles of BK = 16
// (Join::kAdd), which is this function:
//   * one CTA per 64 x 64 output tile (4 x 4 a thread: the training step's
//     long-K dW products have M of 75 or 144, and 64 rows spread them over
//     more SMs) loops over the K tiles itself, so there is no cross-block
//     reduction and no atomics;
//   * the A and B tiles are staged through two shared-memory slots: tile
//     k+1 is loaded while tile k is contracted (the counterpart of the
//     make_async_copy ping-pong);
//   * ragged M/N/K edges are masked (read as 0) instead of padded on the
//     host;
//   * A and B are addressed through row and column strides, so transposed
//     views (a.T for dW, b.T for dX) need no copy;
//   * the products of one K tile are summed into a tile partial first and
//     then added to the accumulator, as the TPU kernel adds one tile dot at
//     a time. fp32 FFMA, no TF32, no tensor cores. The accumulator leaves
//     registers exactly once.

#include "ffma_tile.cuh"

extern "C" int streaming_mm_f32(const void* a, const void* b, void* c, int M, int N, int K,
                                long long sam, long long sak, long long sbk, long long sbn,
                                void* stream) {
  if (M > 0 && N > 0)
    ffma::launch_matmul<float, float, ffma::Join::kAdd, 64>(
        a, b, c, M, N, K, ffma::BK, sam, sak, sbk, sbn, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* streaming_mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

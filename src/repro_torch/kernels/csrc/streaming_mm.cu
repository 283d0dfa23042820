// Streaming fp32 matmul for Hopper on the FFMA pipe: C[M,N] = A[M,K] . B[K,N].
//
// The first port of the TPU kernel repro/kernels/streaming.py::streaming_matmul
// (body _stream_mm_kernel). No path of the port launches it any more:
// streaming_matmul launches ntx_gemm_wgmma.cu (3xTF32 tile products on the
// tensor cores, K tiles of the TPU kernel's _block(K), the K tiles split
// across CTAs where the output has few tiles). It stays, reached by name
// through kernels/streaming.py::launch, so that chip_smoke.py can time it
// beside the tensor-core kernel.
//
// Design: the shared GEMM loop of ffma_tile.cuh with K tiles of BK = 16
// (Join::kAdd): one CTA per 64 x 64 output tile loops over all K itself
// (no cross-block reduction, no atomics), two shared-memory slots with the
// next chunk loaded while the current one is summed, ragged edges masked,
// A and B read through their strides. fp32 FFMA, no tensor cores: the
// training step's long-K dW products (M x N of 75 x 16 or 144 x 32) get
// only 2 or 3 CTAs each.

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

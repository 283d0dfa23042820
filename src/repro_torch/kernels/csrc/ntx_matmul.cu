// NTX wide-accumulator matmul for Hopper on the FFMA pipe: C[M,N] = A[M,K] . B[K,N].
//
// The first port of the TPU kernel repro/kernels/ntx_matmul.py::ntx_matmul
// (body _matmul_kernel). No path of the port launches it any more:
// ops.matmul and ntx_matmul launch ntx_gemm_wgmma.cu, which forms each K
// tile's product on the tensor cores. It stays, reached by name through
// kernels/ntx_matmul.py::launch, so that chip_smoke.py can time it beside
// the tensor-core kernel.
//
// It computes the same function: per K tile of bk, prod summed from 0 in
// fp32, then acc += prod, or the 2Sum written with __fadd_rn / __fsub_rn
// (acc, comp); acc (+ comp) leaves registers once, rounded once. Each tile's
// sum is one FFMA chain over the tile's k in order (ffma_tile.cuh: chunks of
// BK = 16 staged through shared memory never cross a tile boundary), the
// order of cuBLAS's fp32 SGEMM at the GoogLeNet im2col widths, where this
// kernel and the plain version agreed bit for bit on an H100. CTA
// tile 128 x 64 outputs, 256 threads, 8 x 4 a thread, one CTA walking all K
// tiles of its outputs: no split-K, no atomics. Ragged edges are masked;
// bf16 operands are widened on load. Bound: the fp32 pipe (67 TFLOP/s),
// tens of FLOPs per byte at those widths.

#include "ffma_tile.cuh"

namespace {

template <typename TOut, bool COMP>
void launch(int in_type, const void* a, const void* b, void* c, int M, int N, int K, int bk,
            long long sam, long long sak, long long sbk, long long sbn, cudaStream_t s) {
  constexpr ffma::Join join = COMP ? ffma::Join::kTwoSum : ffma::Join::kAdd;
  if (in_type == 0)
    ffma::launch_matmul<float, TOut, join>(a, b, c, M, N, K, bk, sam, sak, sbk, sbn, s);
  else
    ffma::launch_matmul<__nv_bfloat16, TOut, join>(a, b, c, M, N, K, bk, sam, sak, sbk, sbn, s);
}

}  // namespace

// in_type / out_type: 0 float32, 1 bfloat16. C is (M, N) contiguous.
extern "C" int ntx_matmul_launch(const void* a, const void* b, void* c, int in_type,
                                 int out_type, int compensated, int M, int N, int K, int bk,
                                 long long sam, long long sak, long long sbk, long long sbn,
                                 void* stream) {
  if (M > 0 && N > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (out_type == 0) {
      if (compensated) launch<float, true>(in_type, a, b, c, M, N, K, bk, sam, sak, sbk, sbn, s);
      else launch<float, false>(in_type, a, b, c, M, N, K, bk, sam, sak, sbk, sbn, s);
    } else {
      if (compensated)
        launch<__nv_bfloat16, true>(in_type, a, b, c, M, N, K, bk, sam, sak, sbk, sbn, s);
      else
        launch<__nv_bfloat16, false>(in_type, a, b, c, M, N, K, bk, sam, sak, sbk, sbn, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ntx_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

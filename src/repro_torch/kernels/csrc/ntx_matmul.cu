// NTX wide-accumulator matmul for Hopper: C[M,N] = A[M,K] . B[K,N].
//
// Replaces the TPU kernel repro/kernels/ntx_matmul.py::ntx_matmul (body
// _matmul_kernel): a (M/bm, N/bn, K/bk) grid whose K axis runs in order; per
// K tile, prod = dot(a, b) in fp32; then acc += prod, or, compensated,
// (s, e) = two_sum(acc, prod), acc = s, comp += e; the last tile stores
// (acc + comp) cast once to the output type.
//
// The K tiling is the numerics: which sums round where depends on bk, so bk
// is a runtime argument and the kernel keeps the TPU kernel's structure:
//   * each bk-wide K tile is summed into a fresh fp32 register tile `prod`,
//     an FFMA chain over the tile's k in order (ffma_tile.cuh: chunks of
//     BK = 16 staged through shared memory never cross a tile boundary, so
//     the tile's sum starts from 0). On an H100 at the GoogLeNet
//     im2col widths cuBLAS's fp32 SGEMM sums in the same order: there the
//     kernel and its plain version agree bit for bit;
//   * after the tile's last chunk, prod joins the accumulator: acc += prod,
//     or the 2Sum written with __fadd_rn / __fsub_rn, which nvcc neither
//     contracts nor reorders. Nothing in it multiplies, so FMA contraction
//     cannot touch it. The build keeps --use_fast_math off, so fp32
//     subnormals are kept;
//   * acc (+ comp) leaves registers once, rounded once (__float2bfloat16_rn
//     for a bf16 output).
// bm and bn set no result, so the CTA tile is chosen for the card: 128 x 64
// outputs, 256 threads, 8 x 4 a thread. One CTA walks all K tiles of its
// outputs in order: no split-K, no atomics, the same bits on every run.
//
// Ragged edges are masked instead of padded: an element past M, N or K is
// read as 0, and zeros change neither sum (two_sum(acc, 0) = (acc, 0)).
// K tiles still start at multiples of bk. bf16 operands are widened on load;
// their products are exact in fp32. A and B are read through row and
// column strides.
//
// Bound on the H100: at the GoogLeNet im2col widths (K 147..576, N 64..192)
// the work is 2MNK FLOPs against (MK + KN + MN) elements moved, tens of
// FLOPs per byte, so the fp32 pipe (67 TFLOP/s, FFMA) bounds it, not memory.
// The design does about that only what a simple kernel does (ffma_tile.cuh):
// a register micro-tile of 8 x 4 outputs fed by three 16-byte shared loads
// per k, and the next chunk's global loads in flight while the current one
// is summed.

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

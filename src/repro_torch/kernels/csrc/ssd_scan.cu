// Mamba-2 SSD chunked scan for Hopper: y = SSD(x, la, b, c), y (B,H,S,P).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (body
// _ssd_kernel): a (B, H, chunks) grid whose chunk axis runs in order on one
// core, with the (P, N) fp32 state carried in VMEM scratch across chunks.
// Per chunk of length Q, with inclusive cumsum cum of the log decay la:
//
//   y[i]  = sum_{j<=i} exp(cum_i - cum_j) (c_i . b_j) x_j     intra-chunk
//         + exp(cum_i) (h c_i)                                 inter-chunk
//   h     = exp(cum_{Q-1}) h + sum_j exp(cum_{Q-1} - cum_j) x_j b_j^T
//
// Bound on the H100: per token and head the dual form does about
// 2Q(P+N) + 4PN operations against 2P + 2N input/output elements, some
// hundred FLOP per byte at the Mamba-2 widths (P 64, N 128, Q 128), so the
// bound is the 67 TFLOP/s fp32 pipe, not device memory.
//
// Design (simple and deterministic first):
//   * one CTA per (b, h) walks its chunks in order, so the sequential grid
//     axis becomes a loop and nothing is reduced across blocks (no atomics);
//   * the state stays in shared memory for the whole sequence; the chunk's
//     x, b and c tiles are converted to fp32 on load, and the Q x Q score
//     block is built ROWS rows at a time, so that P 64, N 128, Q 128 fits in
//     one block's 227 KB;
//   * exp(cum_i - cum_j) is evaluated only for j <= i: above the diagonal it
//     overflows at strong decay, and a 0/1 mask would turn inf into NaN;
//   * rows of b, c and h are padded by one float, so that threads walking
//     j (scores) or p (inter term) hit distinct banks;
//   * inputs are read through their strides (ssm_block passes transposed
//     views), the output is written contiguous; b and c are read at group
//     h / (H / G);
//   * all arithmetic is fp32 FFMA; bf16 inputs are widened on load and y is
//     rounded to nearest even once, on the store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 32;  // score rows held at once (_ROWS in ssd_scan.py)

struct Dims {
  int B, H, G, S, P, N, Q;
  long long sx[4], sla[3], sb[4], sc[4];  // element strides of x, la, b, c
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ la, const T* __restrict__ b,
           const T* __restrict__ c, T* __restrict__ y, Dims d) {
  extern __shared__ float smem[];
  const int P = d.P, N = d.N, Q = d.Q, NP = N + 1;
  const int R = min(ROWS, Q);
  float* xs = smem;          // [Q][P]
  float* bs = xs + Q * P;    // [Q][N+1]
  float* cs = bs + Q * NP;   // [Q][N+1]
  float* hs = cs + Q * NP;   // [P][N+1], the carried state
  float* cum = hs + P * NP;  // [Q]
  float* wts = cum + Q;      // [Q]: exp(cum_{Q-1} - cum_j)
  float* sc = wts + Q;       // [R][Q] score rows

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / d.H;
  const int hi = blockIdx.x % d.H;
  const int gi = hi / (d.H / d.G);
  const T* xb = x + bi * d.sx[0] + hi * d.sx[1];
  const float* lb = la + bi * d.sla[0] + hi * d.sla[1];
  const T* bb = b + bi * d.sb[0] + gi * d.sb[1];
  const T* cb = c + bi * d.sc[0] + gi * d.sc[1];
  T* yb = y + (static_cast<long long>(bi) * d.H + hi) * d.S * P;

  for (int e = tid; e < P * NP; e += THREADS) hs[e] = 0.f;

  for (int c0 = 0; c0 < d.S; c0 += Q) {
    __syncthreads();  // the previous chunk's state update is done with xs / bs
    for (int e = tid; e < Q * P; e += THREADS) {
      const int i = e / P, p = e % P;
      xs[e] = widen(xb[(c0 + i) * d.sx[2] + p * d.sx[3]]);
    }
    for (int e = tid; e < Q * N; e += THREADS) {
      const int i = e / N, n = e % N;
      bs[i * NP + n] = widen(bb[(c0 + i) * d.sb[2] + n * d.sb[3]]);
      cs[i * NP + n] = widen(cb[(c0 + i) * d.sc[2] + n * d.sc[3]]);
    }
    if (tid == 0) {  // inclusive cumsum, in order
      float s = 0.f;
      for (int i = 0; i < Q; ++i) {
        s += lb[(c0 + i) * d.sla[2]];
        cum[i] = s;
      }
    }
    __syncthreads();
    const float total = cum[Q - 1];
    for (int e = tid; e < Q; e += THREADS) wts[e] = expf(total - cum[e]);

    // y, ROWS rows at a time: the score rows, then the rows of y
    for (int r0 = 0; r0 < Q; r0 += R) {
      const int rows = min(R, Q - r0);
      for (int e = tid; e < rows * Q; e += THREADS) {
        const int i = r0 + e / Q, j = e % Q;
        float v = 0.f;
        if (j <= i) {  // never exp above the diagonal
          float dot = 0.f;
          for (int n = 0; n < N; ++n) dot = fmaf(cs[i * NP + n], bs[j * NP + n], dot);
          v = dot * expf(cum[i] - cum[j]);
        }
        sc[e] = v;
      }
      __syncthreads();
      for (int e = tid; e < rows * P; e += THREADS) {
        const int ii = e / P, p = e % P, i = r0 + ii;
        float intra = 0.f;
        for (int j = 0; j <= i; ++j) intra = fmaf(sc[ii * Q + j], xs[j * P + p], intra);
        float inter = 0.f;
        for (int n = 0; n < N; ++n) inter = fmaf(cs[i * NP + n], hs[p * NP + n], inter);
        store(yb + static_cast<long long>(c0 + i) * P + p, intra + expf(cum[i]) * inter);
      }
      __syncthreads();  // every row of y read the old state and this score slice
    }

    // state update
    const float dec = expf(total);
    for (int e = tid; e < P * N; e += THREADS) {
      const int p = e / N, n = e % N;
      float acc = 0.f;
      for (int j = 0; j < Q; ++j) acc = fmaf(xs[j * P + p] * wts[j], bs[j * NP + n], acc);
      hs[p * NP + n] = dec * hs[p * NP + n] + acc;
    }
  }
}

size_t smem_bytes(int P, int N, int Q) {
  const int R = Q < ROWS ? Q : ROWS;
  return sizeof(float) * (static_cast<size_t>(Q) * P + 2ull * Q * (N + 1) +
                          static_cast<size_t>(P) * (N + 1) + 2ull * Q + static_cast<size_t>(R) * Q);
}

template <typename T>
int launch(const void* x, const void* la, const void* b, const void* c, void* y,
           const long long* dims, void* stream) {
  Dims d;
  d.B = static_cast<int>(dims[0]);
  d.H = static_cast<int>(dims[1]);
  d.G = static_cast<int>(dims[2]);
  d.S = static_cast<int>(dims[3]);
  d.P = static_cast<int>(dims[4]);
  d.N = static_cast<int>(dims[5]);
  d.Q = static_cast<int>(dims[6]);
  for (int k = 0; k < 4; ++k) d.sx[k] = dims[7 + k];
  for (int k = 0; k < 3; ++k) d.sla[k] = dims[11 + k];
  for (int k = 0; k < 4; ++k) d.sb[k] = dims[14 + k];
  for (int k = 0; k < 4; ++k) d.sc[k] = dims[18 + k];
  if (d.B * d.H == 0 || d.S == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = smem_bytes(d.P, d.N, d.Q);
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_kernel<T><<<d.B * d.H, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(la), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_scan_f32(const void* x, const void* la, const void* b, const void* c, void* y,
                            const long long* dims, void* stream) {
  return launch<float>(x, la, b, c, y, dims, stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* la, const void* b, const void* c, void* y,
                             const long long* dims, void* stream) {
  return launch<__nv_bfloat16>(x, la, b, c, y, dims, stream);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

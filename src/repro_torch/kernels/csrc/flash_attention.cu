// Flash attention forward for Hopper: o = softmax(q k^T * scale + mask) v.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _attn_kernel): a (B, Hq, q blocks, KV blocks) grid whose KV axis runs
// in order on one core, with the online-softmax statistics m, l and the
// output accumulator carried in fp32 VMEM scratch across KV blocks. GQA maps
// q head h to kv head h / (Hq / Hkv) with no KV copy; KV blocks that the
// causal or sliding-window mask hides entirely are skipped; rows that see no
// key at all give 0.
//
//   s   = (q . k) * scale, masked to NEG_INF where j >= Skv, j > i (causal)
//         or j <= i - window (sliding window)
//   m'  = max(m, max_j s);  alpha = exp(m - m');  p = exp(s - m')
//         (p = 0 and alpha = 0 while m' is still NEG_INF)
//   l'  = l alpha + sum_j p;  acc' = acc alpha + p v
//   o   = acc / (l == 0 ? 1 : l), rounded once to o's type
//
// Bound on the H100: 4 D operations per visible (q, k) pair against 4 D
// input/output elements per token and head, so at S 2,048 (about 1,000
// visible keys per query on average) the work is some hundred times the
// bytes: the bound is the arithmetic, 67 TFLOP/s in fp32 outside the
// tensor cores (989 TFLOP/s in bf16 on them, which this kernel does not use).
//
// Design (simple, right and deterministic first):
//   * one CTA of 256 threads per (b, hq, tile of BQ = 64 query rows) walks its
//     KV tiles of BKV = 64 keys in order, so the sequential grid axis becomes a
//     loop and nothing is reduced across blocks (no atomics: the same bits run
//     to run); the tiles of the last query rows, which see the most keys under
//     the causal mask, are launched first;
//   * only KV tiles between the window start and the causal diagonal of the
//     query tile are visited, so the work is what the masks leave visible,
//     rounded out to whole tiles;
//   * q, k and v are widened to fp32 as they are loaded into shared memory
//     (through their strides: attention_block passes v as a transposed view),
//     and every product is an fp32 FFMA: tensor cores would round (TF32, or p
//     to bf16 under wgmma) where the TPU kernel keeps fp32;
//   * each thread holds a 4 x 4 block of the score tile and a 4 x D/16 block
//     of the accumulator in registers; the score tile goes through shared
//     memory for the row statistics (4 threads per row, reduced with warp
//     shuffles in a fixed order); rows of q, k and the score tile are padded
//     by one float, so the threads of a warp walking them hit distinct banks;
//   * D is a template parameter (16, 32, 64, 128, 256); at D 256 the block
//     uses 214,528 of the 232,448 bytes of shared memory a block may have.
//
// Later work (not here): wgmma with TMA loads and warp specialisation, which
// would round p to bf16 in the p v product and so change the numerics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16
constexpr int BQ = 64;        // query rows per CTA (_BQ in flash_attention.py)
constexpr int BKV = 64;       // keys per tile (_BKV in flash_attention.py)
constexpr float NEG_INF = -1e30f;

struct Dims {
  int B, Hq, Hkv, Sq, Skv, causal, has_window, window;
  long long sq[4], sk[4], sv[4];  // element strides of q, k, v
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(BQ) * (D + 1) + static_cast<size_t>(BKV) * (D + 1) +
         static_cast<size_t>(BKV) * D + static_cast<size_t>(BQ) * (BKV + 1) + 3 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ o, Dims d, float scale) {
  constexpr int DP = D + 1;    // padded q / k row
  constexpr int SP = BKV + 1;  // padded score row
  constexpr int CJ = D / 16;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][DP]
  float* ks = qs + BQ * DP;     // [BKV][DP]
  float* vs = ks + BKV * DP;    // [BKV][D]
  float* ss = vs + BKV * D;     // [BQ][SP] scores, then p
  float* m_s = ss + BQ * SP;    // [BQ] running max
  float* l_s = m_s + BQ;        // [BQ] running sum
  float* a_s = l_s + BQ;        // [BQ] this tile's rescale alpha

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nq = (d.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int hq = blockIdx.y, bi = blockIdx.z;
  const int hk = hq / (d.Hq / d.Hkv);
  const T* qb = q + bi * d.sq[0] + hq * d.sq[1];
  const T* kb = k + bi * d.sk[0] + hk * d.sk[1];
  const T* vb = v + bi * d.sv[0] + hk * d.sv[1];

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    qs[r * DP + c] = q0 + r < d.Sq ? widen(qb[(q0 + r) * d.sq[2] + c * d.sq[3]]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;

  // the keys any row of this tile can see: [lo, hi)
  int hi = d.Skv;
  if (d.causal) hi = min(hi, q0 + BQ);
  const int lo = d.has_window ? max(0, q0 - d.window + 1) : 0;

  for (int k0 = lo / BKV * BKV; k0 < hi; k0 += BKV) {
    __syncthreads();  // the previous tile's p v is done with ks / vs / ss
    for (int e = tid; e < BKV * D; e += THREADS) {
      const int r = e / D, c = e % D, j = k0 + r;
      const bool in = j < d.Skv;  // the KV tail reads as zeros, then is masked
      ks[r * DP + c] = in ? widen(kb[j * d.sk[2] + c * d.sk[3]]) : 0.f;
      vs[r * D + c] = in ? widen(vb[j * d.sv[2] + c * d.sv[3]]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty*4 + i, keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qa[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[(ty * 4 + i) * DP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * DP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        bool vis = col < d.Skv;
        if (d.causal) vis = vis && col <= row;
        if (d.has_window) vis = vis && col > row - d.window;
        ss[(ty * 4 + i) * SP + tx + 16 * j] = vis ? sc[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // row statistics: 4 consecutive lanes per row, reduced in a fixed order
    {
      const int r = tid / 4, part = tid % 4;
      float* srow = ss + r * SP;
      const float m_prev = m_s[r];
      float mx = NEG_INF;
      for (int c = part; c < BKV; c += 4) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      const bool none = m_new <= NEG_INF / 2;  // no visible key in this row yet
      float sum = 0.f;
      for (int c = part; c < BKV; c += 4) {
        const float p = none ? 0.f : expf(srow[c] - m_new);
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = none ? 0.f : expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc alpha + p v: rows ty*4 + i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty * 4 + i) * SP + c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float vv = vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();  // the last tile's l

  T* ob = o + (static_cast<long long>(bi) * d.Hq + hq) * d.Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, row = q0 + r;
    if (row >= d.Sq) continue;
    float l = l_s[r];
    if (l == 0.f) l = 1.f;  // rows with no visible key give 0
#pragma unroll
    for (int j = 0; j < CJ; ++j) store(ob + static_cast<long long>(row) * D + tx + 16 * j, acc[i][j] / l);
  }
}

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, T* o, const Dims& d, float scale,
             cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attn_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((d.Sq + BQ - 1) / BQ, d.Hq, d.B);
  attn_kernel<T, D><<<grid, THREADS, smem, stream>>>(q, k, v, o, d, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, const long long* dims,
           float scale, void* stream) {
  Dims d;
  d.B = static_cast<int>(dims[0]);
  d.Hq = static_cast<int>(dims[1]);
  d.Hkv = static_cast<int>(dims[2]);
  d.Sq = static_cast<int>(dims[3]);
  d.Skv = static_cast<int>(dims[4]);
  const int D = static_cast<int>(dims[5]);
  d.causal = static_cast<int>(dims[6]);
  d.has_window = static_cast<int>(dims[7]);
  d.window = static_cast<int>(dims[8]);
  for (int i = 0; i < 4; ++i) d.sq[i] = dims[9 + i];
  for (int i = 0; i < 4; ++i) d.sk[i] = dims[13 + i];
  for (int i = 0; i < 4; ++i) d.sv[i] = dims[17 + i];
  if (d.B * d.Hq == 0 || d.Sq == 0) return static_cast<int>(cudaGetLastError());
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<T, 16>(qt, kt, vt, ot, d, scale, s);
    case 32: return launch_d<T, 32>(qt, kt, vt, ot, d, scale, s);
    case 64: return launch_d<T, 64>(qt, kt, vt, ot, d, scale, s);
    case 128: return launch_d<T, 128>(qt, kt, vt, ot, d, scale, s);
    case 256: return launch_d<T, 256>(qt, kt, vt, ot, d, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   const long long* dims, float scale, void* stream) {
  return launch<float>(q, k, v, o, dims, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    const long long* dims, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dims, scale, stream);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Fused train-step region for Hopper: fwd, softmax-CE gradient, dW, dX and
// the SGD/momentum update of one region in two launches.
//
// Replaces the TPU kernel repro/kernels/fused.py::build_region_callable
// (kernel body `kernel`, stage math _stage_flow / _stage_updates). The TPU
// kernel walks batch tiles in order on one core: it streams batched inputs
// through a VMEM double buffer, keeps intermediates in VMEM, accumulates
// dW partials across grid steps and runs the update on the last step.
//
// Bound on the H100: the paper CNN step at batch 64 moves about 1 MB of
// inputs and outputs and does 180 MFLOP, 2.7 us at the fp32 FFMA rate, so
// neither HBM bytes nor the fp32 pipe bounds it at a useful size; what
// limits it is latency (dependent loads, barriers) and how many SMs work.
//
// Both entries:
//   * the grid's sequential order does not carry over to CUDA, so the
//     cross-image ordering is made explicit: a body launch, then an epilogue
//     launch that reduces the per-image dW partials in image order
//     (deterministic run to run, no float atomics) and applies the update;
//   * the body walks a stage table compiled on the host from the region
//     spec. Every stage is per-image independent, as the TPU kernel's batch
//     tiles already require;
//   * the matmul forward (the logits' long sum, K = 512 in the paper CNN)
//     is summed as streaming_matmul sums it in the unfused step: K tiles of
//     the TPU kernel's _block(K), each in slices of 8 summed from zero, the
//     slices and then the tiles added in order. One FMA chain over all of K
//     was the larger error of the two steps' logits against the fp64 step.
//     Each slice goes to its own thread (the sums in shared memory), then
//     one thread per output joins them in order: the bits do not depend on
//     the threads;
//   * conv dX is the gather form of "dilate by s, pad by k-1-p, correlate
//     with rot180(w)": no dilated buffer. MaxPool dX routes the gradient to
//     the first maximal tap in row-major order. ReLU dX masks from the relu
//     output. The matmul stages run in this body, as on the TPU.
//
// fused_region_launch (the arena entry): one CTA per image; each stage is a
// block-strided loop over its per-image outputs with an fp32 accumulator and
// __syncthreads() separates stages; intermediates live in a per-image scratch
// arena in device memory (about 100 KB per image for the paper CNN). It
// takes every region; at batch 64 only 64 of the 132 SMs work, and its inner
// loops issue two dependent global or L2 loads per FMA.
//
// fused_region_smem_launch (the shared-memory entry, for regions whose
// layout fits one block): a thread-block cluster of C CTAs per image (C the
// largest of 8, 4, 2, 1 whose B clusters the card runs at once: C 2 at batch
// 64, 128 CTAs; C 4 at batch 16, since only 15 clusters of 8 fit at once).
//   * Each CTA holds, in shared memory, the image's staged inputs and the
//     parameters the body reads (loaded once by cp.async), and every live
//     intermediate, at slots the host lays out by liveness (a slot is reused
//     once its last reader has run and, for a slot peers write into, a
//     cluster barrier has passed). Nothing but dW partials and escaping
//     outputs goes to device memory.
//   * The convs' forward and dX outputs are split over the cluster's CTAs;
//     each CTA writes its share into every CTA's shared memory (DSMEM
//     stores, st.shared::cluster), then a cluster barrier. So every read in
//     the inner loops is a local shared-memory load; the remote traffic is
//     stores nobody waits on until the barrier. (Reading peers' slices
//     instead would put DSMEM's latency in the FMA loops.) The dW partials
//     are split over the cluster and go to device memory. The cheap stages
//     (relu, pool, bias, flatten, the softmax-CE gradient, the 10-wide
//     matmuls) run whole in every CTA on its own copy: no exchange, a
//     __syncthreads() after them.
//   * FFMA from shared memory with register tiles: a thread computes T = 4,
//     2 or 1 output channels of a pixel (conv forward) or of a tap (conv dW)
//     or input channels of a pixel (conv dX, w copied per stage as
//     [tap][co][ci] so that they are one vector load), so each shared load
//     feeds up to four FMAs, T picked so the CTA's tasks still fill its
//     threads. Each output is still one chain in the arena entry's order
//     ((dh, dw, ci) for the forward, (dh, dw, co) for dX), so the two entries
//     give the same bits there; the conv dW chains (256 and 64 pixels in the
//     paper CNN) are cut into sub-sums of whole output rows, at least 32
//     pixels, summed from zero in parallel and joined in order. No sum
//     depends on C or T: C 1, 2, 4 and 8 give the same bits.
//   * Tensor cores are deliberately not used: the whole step is 2.7 us at
//     the FFMA rate, so latency and occupancy are the limit, not the
//     arithmetic rate; and the region-vs-plain and fused-vs-unfused gates
//     (rtol 1e-5, atol 1e-6) leave no room for 3xTF32's loss on short sums.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_BUFS = 64;
constexpr int REC = 16;  // the last int: the stage's scratch slot (shared-memory entry)
constexpr int EPI_REC = 8;
constexpr int EPI_THREADS = 256;
constexpr int FC_SLOTS = 2048;  // shared slice sums of the matmul forward
constexpr int SMEM_THREADS = 512;  // threads of a shared-memory entry CTA, at most
constexpr int MAX_SMEM_STAGES = 48;  // body stages the shared-memory entry takes
constexpr int DW_CHUNK = 32;       // output pixels of one conv-dW sub-sum
constexpr int STAGED = 1, ESCAPES = 2;  // buffer modes of the shared-memory entry

// keep in sync with repro_torch/kernels/fused.py
enum Op {
  OP_CONV_FWD = 1,
  OP_CONV_DW = 2,
  OP_CONV_DX = 3,
  OP_MM_FWD = 4,
  OP_MM_DW = 5,
  OP_MM_DX = 6,
  OP_BIAS_FWD = 7,
  OP_BIAS_DW = 8,
  OP_COPY = 9,
  OP_RELU_FWD = 10,
  OP_RELU_DX = 11,
  OP_POOL_FWD = 12,
  OP_POOL_DX = 13,
  OP_XENT_DX = 14,
};

// Operand buffers, passed by value. stride is the element distance between
// consecutive images (0 for resident buffers: params, momentum, totals).
struct RegionBufs {
  float* ptr[MAX_BUFS];
  long long stride[MAX_BUFS];
};

struct Conv {
  int H, W, Cin, KH, KW, Cout, S, P, OH, OW;
};

__device__ __forceinline__ Conv conv_of(const int* r) {
  return Conv{r[4], r[5], r[6], r[7], r[8], r[9], r[10], r[11], r[12], r[13]};
}

__device__ void conv_fwd(const float* x, const float* w, float* y, Conv c) {
  const int n = c.OH * c.OW * c.Cout;
  for (int o = threadIdx.x; o < n; o += blockDim.x) {
    const int co = o % c.Cout;
    const int pix = o / c.Cout;
    const int ox = pix % c.OW, oy = pix / c.OW;
    float acc = 0.f;
    for (int dh = 0; dh < c.KH; ++dh) {
      const int iy = oy * c.S - c.P + dh;
      if (iy < 0 || iy >= c.H) continue;
      for (int dw = 0; dw < c.KW; ++dw) {
        const int ix = ox * c.S - c.P + dw;
        if (ix < 0 || ix >= c.W) continue;
        const float* xp = x + (iy * c.W + ix) * c.Cin;
        const float* wp = w + (dh * c.KW + dw) * c.Cin * c.Cout + co;
        for (int ci = 0; ci < c.Cin; ++ci) acc = fmaf(xp[ci], wp[ci * c.Cout], acc);
      }
    }
    y[o] = acc;
  }
}

// this image's dW partial: sum over output pixels of x_pad patch * dy
__device__ void conv_dw(const float* x, const float* dy, float* dw_out, Conv c) {
  const int n = c.KH * c.KW * c.Cin * c.Cout;
  for (int o = threadIdx.x; o < n; o += blockDim.x) {
    const int co = o % c.Cout;
    int t = o / c.Cout;
    const int ci = t % c.Cin;
    t /= c.Cin;
    const int dw = t % c.KW, dh = t / c.KW;
    float acc = 0.f;
    for (int oy = 0; oy < c.OH; ++oy) {
      const int iy = oy * c.S - c.P + dh;
      if (iy < 0 || iy >= c.H) continue;
      for (int ox = 0; ox < c.OW; ++ox) {
        const int ix = ox * c.S - c.P + dw;
        if (ix < 0 || ix >= c.W) continue;
        acc = fmaf(x[(iy * c.W + ix) * c.Cin + ci], dy[(oy * c.OW + ox) * c.Cout + co], acc);
      }
    }
    dw_out[o] = acc;
  }
}

// gather form of the transposed conv: input pixel (iy, ix) collects every
// (output pixel, tap) pair whose forward window covered it
__device__ void conv_dx(const float* dy, const float* w, float* dx, Conv c) {
  const int n = c.H * c.W * c.Cin;
  for (int o = threadIdx.x; o < n; o += blockDim.x) {
    const int ci = o % c.Cin;
    const int pix = o / c.Cin;
    const int ix = pix % c.W, iy = pix / c.W;
    float acc = 0.f;
    for (int dh = 0; dh < c.KH; ++dh) {
      const int ty = iy + c.P - dh;
      if (ty < 0 || ty % c.S) continue;
      const int oy = ty / c.S;
      if (oy >= c.OH) continue;
      for (int dw = 0; dw < c.KW; ++dw) {
        const int tx = ix + c.P - dw;
        if (tx < 0 || tx % c.S) continue;
        const int ox = tx / c.S;
        if (ox >= c.OW) continue;
        const float* dyp = dy + (oy * c.OW + ox) * c.Cout;
        const float* wp = w + ((dh * c.KW + dw) * c.Cin + ci) * c.Cout;
        for (int co = 0; co < c.Cout; ++co) acc = fmaf(dyp[co], wp[co], acc);
      }
    }
    dx[o] = acc;
  }
}

__device__ void pool_fwd(const float* x, float* y, const int* r) {
  const int W = r[5], C = r[6], K = r[7], OH = r[8], OW = r[9];
  const int n = OH * OW * C;
  for (int o = threadIdx.x; o < n; o += blockDim.x) {
    const int ch = o % C;
    const int pix = o / C;
    const int ox = pix % OW, oy = pix / OW;
    float m = x[((oy * K) * W + ox * K) * C + ch];
    for (int dh = 0; dh < K; ++dh)
      for (int dw = 0; dw < K; ++dw) m = fmaxf(m, x[((oy * K + dh) * W + ox * K + dw) * C + ch]);
    y[o] = m;
  }
}

// the gradient goes to the FIRST maximal tap of the window in row-major
// order, the tie-breaking of XLA's select-and-scatter (window == stride)
__device__ void pool_dx(const float* x, const float* g, float* dx, const int* r) {
  const int H = r[4], W = r[5], C = r[6], K = r[7], OW = r[9];
  const int n = H * W * C;
  for (int o = threadIdx.x; o < n; o += blockDim.x) {
    const int ch = o % C;
    const int pix = o / C;
    const int ix = pix % W, iy = pix / W;
    const int oy = iy / K, ox = ix / K;
    const float* base = x + ((oy * K) * W + ox * K) * C + ch;
    float m = base[0];
    for (int dh = 0; dh < K; ++dh)
      for (int dw = 0; dw < K; ++dw) m = fmaxf(m, base[(dh * W + dw) * C]);
    int first = -1;
    for (int t = 0; t < K * K && first < 0; ++t)
      if (base[((t / K) * W + t % K) * C] == m) first = t;
    const int mine = (iy - oy * K) * K + (ix - ox * K);
    dx[o] = (mine == first) ? g[(oy * OW + ox) * C + ch] : 0.f;
  }
}

// The stages that run whole over one image in a block, in both entries:
// element-wise ops, pooling, the 10-wide matmul dX and the softmax-CE gradient.
__device__ void run_whole(int op, const int* r, const float* a, const float* b, float* out) {
  switch (op) {
    case OP_MM_DX: {  // dx[k] = sum_n dy[n] w[k, n]
      const int K = r[4], N = r[5];
      for (int k = threadIdx.x; k < K; k += blockDim.x) {
        float acc = 0.f;
        for (int n = 0; n < N; ++n) acc = fmaf(a[n], b[k * N + n], acc);
        out[k] = acc;
      }
      break;
    }
    case OP_BIAS_FWD: {
      const int n = r[4], C = r[5];
      for (int o = threadIdx.x; o < n; o += blockDim.x) out[o] = a[o] + b[o % C];
      break;
    }
    case OP_COPY: {
      const int n = r[4];
      for (int o = threadIdx.x; o < n; o += blockDim.x) out[o] = a[o];
      break;
    }
    case OP_RELU_FWD: {
      const int n = r[4];
      for (int o = threadIdx.x; o < n; o += blockDim.x) out[o] = a[o] > 0.f ? a[o] : 0.f;
      break;
    }
    case OP_RELU_DX: {  // a = relu output, b = dy
      const int n = r[4];
      for (int o = threadIdx.x; o < n; o += blockDim.x) out[o] = a[o] > 0.f ? b[o] : 0.f;
      break;
    }
    case OP_POOL_FWD:
      pool_fwd(a, out, r);
      break;
    case OP_POOL_DX:
      pool_dx(a, b, out, r);
      break;
    case OP_XENT_DX: {  // (softmax(z) - onehot) / batch over one row
      const int C = r[4];
      const float batch = static_cast<float>(r[5]);
      for (int o = threadIdx.x; o < C; o += blockDim.x) {
        float m = a[0];
        for (int j = 1; j < C; ++j) m = fmaxf(m, a[j]);
        float sum = 0.f;
        for (int j = 0; j < C; ++j) sum += expf(a[j] - m);
        out[o] = (expf(a[o] - m) / sum - b[o]) / batch;
      }
      break;
    }
    default:
      __trap();
  }
}

__global__ void __launch_bounds__(1024)
region_body(const int* __restrict__ table, int n_stages, RegionBufs bufs) {
  __shared__ float fc_slices[FC_SLOTS];
  const long long img = blockIdx.x;
  for (int s = 0; s < n_stages; ++s) {
    const int* r = table + s * REC;
    const int op = r[0];
    const float* a = r[1] >= 0 ? bufs.ptr[r[1]] + img * bufs.stride[r[1]] : nullptr;
    const float* b = r[2] >= 0 ? bufs.ptr[r[2]] + img * bufs.stride[r[2]] : nullptr;
    float* out = bufs.ptr[r[3]] + img * bufs.stride[r[3]];
    switch (op) {
      case OP_CONV_FWD:
        conv_fwd(a, b, out, conv_of(r));
        break;
      case OP_CONV_DW:
        conv_dw(a, b, out, conv_of(r));
        break;
      case OP_CONV_DX:
        conv_dx(a, b, out, conv_of(r));
        break;
      case OP_MM_FWD: {  // y[n] = sum_k x[k] w[k, n], in the unfused step's order
        const int K = r[4], N = r[5];
        const int bk = K <= 1 ? 1 : (K < 128 ? 1 << (32 - __clz(K - 1)) : 128);
        const int spt = (bk + 7) / 8;              // slices per K tile
        const int n_sl = (K + bk - 1) / bk * spt;  // slice slots, in K order
        const int cols = min(N, min(static_cast<int>(blockDim.x), FC_SLOTS));
        const int rows = FC_SLOTS / max(cols, 1);
        for (int c0 = 0; c0 < N; c0 += cols) {  // columns c0.. joined by threads 0..
          const int cn = min(cols, N - c0);
          float acc = 0.f, tile = 0.f;
          for (int s0 = 0; s0 < n_sl; s0 += rows) {
            const int sn = min(rows, n_sl - s0);
            for (int o = threadIdx.x; o < sn * cn; o += blockDim.x) {  // one slice from zero
              const int s = s0 + o / cn, t = s / spt;
              const int k0 = t * bk + s % spt * 8, k1 = min(min(k0 + 8, (t + 1) * bk), K);
              float sl = 0.f;
              for (int k = k0; k < k1; ++k) sl = fmaf(a[k], b[k * N + c0 + o % cn], sl);
              fc_slices[o] = sl;
            }
            __syncthreads();
            if (static_cast<int>(threadIdx.x) < cn) {  // slices into tiles, tiles into acc
              for (int q = 0; q < sn; ++q) {
                const int s = s0 + q;
                if (s / spt * bk + s % spt * 8 < K)
                  tile = __fadd_rn(tile, fc_slices[q * cn + threadIdx.x]);
                if (s % spt == spt - 1) {
                  acc = __fadd_rn(acc, tile);
                  tile = 0.f;
                }
              }
            }
            __syncthreads();
          }
          if (static_cast<int>(threadIdx.x) < cn) out[c0 + threadIdx.x] = acc;
        }
        break;
      }
      case OP_MM_DW: {  // this image's partial: x[k] dy[n]
        const int K = r[4], N = r[5];
        for (int o = threadIdx.x; o < K * N; o += blockDim.x) out[o] = a[o / N] * b[o % N];
        break;
      }
      case OP_BIAS_DW: {  // this image's partial: dy summed over its rows
        const int n = r[4], C = r[5];
        for (int ch = threadIdx.x; ch < C; ch += blockDim.x) {
          float acc = 0.f;
          for (int o = ch; o < n; o += C) acc += a[o];
          out[ch] = acc;
        }
        break;
      }
      default:
        run_whole(op, r, a, b, out);
    }
    __syncthreads();
  }
}

// One thread per parameter element, one grid row per parameter. Record:
// numel, partial, d_in, d_out, w, v, w_new, v_new (buffer indices, -1 when
// absent). The _rn intrinsics keep the compiler from contracting mu*v + dw
// and w - lr*v_new into FMAs: two roundings each, as the plain version.
__global__ void region_epilogue(const int* __restrict__ table, int batch, float lr, float mu,
                                RegionBufs bufs) {
  const int* r = table + blockIdx.y * EPI_REC;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r[0]) return;
  float dw;
  if (r[1] >= 0) {
    const float* p = bufs.ptr[r[1]];
    const long long st = bufs.stride[r[1]];
    dw = 0.f;
    for (int b = 0; b < batch; ++b) dw += p[b * st + i];
  } else {
    dw = bufs.ptr[r[2]][i];
  }
  if (r[3] >= 0) bufs.ptr[r[3]][i] = dw;
  if (r[6] >= 0) {
    float v_new = dw;
    if (r[5] >= 0) {
      v_new = __fadd_rn(__fmul_rn(mu, bufs.ptr[r[5]][i]), dw);
      bufs.ptr[r[7]][i] = v_new;
    }
    bufs.ptr[r[6]][i] = __fsub_rn(bufs.ptr[r[4]][i], __fmul_rn(lr, v_new));
  }
}

// ---------------------------------------------------------------------------
// The shared-memory entry: a cluster of C CTAs per image
// ---------------------------------------------------------------------------

// Operand buffers of the shared-memory entry: device memory as for the arena
// entry, plus each buffer's shared-memory slot (floats, -1 for none), its
// element count and its mode (STAGED: loaded at the start; ESCAPES: a stage
// output also written to device memory).
struct SmemBufs {
  RegionBufs g;
  int slot[MAX_BUFS];
  int numel[MAX_BUFS];
  int mode[MAX_BUFS];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cta_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_ctas() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster; the release / acquire pair makes
// the DSMEM stores before it visible to all CTAs after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;"
               ::: "memory");
}

// the address of this CTA's shared location `a` in the cluster window of CTA `rank`
__device__ __forceinline__ uint32_t mapa(uint32_t a, uint32_t rank) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(rank));
  return d;
}

// T = 4, 2 or 1 floats, one vector access
template <int T>
__device__ __forceinline__ void load_t(const float* p, float (&v)[T]) {
  if constexpr (T == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (T == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

template <int T>
__device__ __forceinline__ void store_t(float* p, const float (&v)[T]) {
  if constexpr (T == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (T == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}

// T floats at this CTA's shared location p, into the same location of every
// CTA of the cluster (this one included)
template <int T>
__device__ __forceinline__ void store_cluster(float* p, const float (&v)[T], int C) {
  const uint32_t a = smem_addr(p);
  for (int r = 0; r < C; ++r) {
    const uint32_t d = mapa(a, r);
    if constexpr (T == 4)
      asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(d), "f"(v[0]),
                   "f"(v[1]), "f"(v[2]), "f"(v[3]) : "memory");
    else if constexpr (T == 2)
      asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(d), "f"(v[0]), "f"(v[1])
                   : "memory");
    else
      asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(d), "f"(v[0]) : "memory");
  }
}

// this CTA's share [lo, hi) of n tasks split over the cluster's C CTAs
__device__ __forceinline__ void share(int n, int rank, int C, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<long long>(n) * rank / C);
  hi = static_cast<int>(static_cast<long long>(n) * (rank + 1) / C);
}

// outputs a task computes: the larger of 4 and 2 that divides the channel
// count and still gives every thread of the CTA a task, else 1 (8 read no
// faster on an H100)
__device__ __forceinline__ int tile_width(int tasks, int channels, int C) {
  const int threads = static_cast<int>(blockDim.x);
  for (int t = 4; t > 1; t /= 2)
    if (channels % t == 0 && tasks / t / C >= threads) return t;
  return 1;
}

// a stage's op at tile width 4, 2 or 1
#define BY_WIDTH(w, fn, ...)      \
  switch (w) {                    \
    case 4:                       \
      fn<4>(__VA_ARGS__);         \
      break;                      \
    case 2:                       \
      fn<2>(__VA_ARGS__);         \
      break;                      \
    default:                      \
      fn<1>(__VA_ARGS__);         \
  }

// conv forward, this CTA's share: a task is T output channels of one pixel,
// each one FMA chain over (dh, dw, ci) in order (the arena entry's order);
// written into every CTA, and to device memory where the output escapes
template <int T>
__device__ void conv_fwd_share(const float* x, const float* w, float* y, float* gy, Conv c,
                               int rank, int C) {
  const int groups = c.Cout / T;
  int lo, hi;
  share(c.OH * c.OW * groups, rank, C, lo, hi);
  for (int t = lo + threadIdx.x; t < hi; t += blockDim.x) {
    const int co = t % groups * T, pix = t / groups;
    const int ox = pix % c.OW, oy = pix / c.OW;
    float acc[T];
#pragma unroll
    for (int j = 0; j < T; ++j) acc[j] = 0.f;
    for (int dh = 0; dh < c.KH; ++dh) {
      const int iy = oy * c.S - c.P + dh;
      if (iy < 0 || iy >= c.H) continue;
      for (int dw = 0; dw < c.KW; ++dw) {
        const int ix = ox * c.S - c.P + dw;
        if (ix < 0 || ix >= c.W) continue;
        const float* xp = x + (iy * c.W + ix) * c.Cin;
        const float* wp = w + (dh * c.KW + dw) * c.Cin * c.Cout + co;
#pragma unroll 4
        for (int ci = 0; ci < c.Cin; ++ci) {
          const float xv = xp[ci];
          float wv[T];
          load_t<T>(wp + ci * c.Cout, wv);
#pragma unroll
          for (int j = 0; j < T; ++j) acc[j] = fmaf(xv, wv[j], acc[j]);
        }
      }
    }
    const int o = pix * c.Cout + co;
    store_cluster<T>(y + o, acc, C);
    if (gy) store_t<T>(gy + o, acc);
  }
}

// column j of a row when the row's columns are ordered by their residue
// mod S: neighbouring threads of a warp then share the set of valid taps
__device__ __forceinline__ int column_by_residue(int j, int W, int S) {
  for (int r = 0; r + 1 < S; ++r) {
    const int n = (W - r + S - 1) / S;
    if (j < n) return r + j * S;
    j -= n;
  }
  return S - 1 + j * S;
}

// conv dX (the gather form), this CTA's share: a task is T input channels
// of one input pixel, each one FMA chain over (dh, dw, co) in order (the
// arena entry's order). w is first copied per tap to CTA-local scratch as
// wt[tap][co][ci] (rows of Cin + 4), so the T channels' weights of one co
// are one vector load; pixels go to tasks with their columns ordered by
// residue mod S, so a warp's pixels share their valid taps
template <int T>
__device__ void conv_dx_share(const float* dy, const float* w, float* dx, float* gdx, float* wt,
                              Conv c, int rank, int C) {
  const int rs = c.Cin + 4;
  const int n_w = c.KH * c.KW * c.Cin * c.Cout;
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) {
    const int co = i % c.Cout, rest = i / c.Cout;
    wt[(rest / c.Cin * c.Cout + co) * rs + rest % c.Cin] = w[i];
  }
  __syncthreads();
  const int groups = c.Cin / T;
  int lo, hi;
  share(c.H * c.W * groups, rank, C, lo, hi);
  const bool v4 = c.Cout % 4 == 0;
  for (int t = lo + threadIdx.x; t < hi; t += blockDim.x) {
    const int ci = t % groups * T;
    const int q = t / groups;
    const int iy = q / c.W, ix = column_by_residue(q % c.W, c.W, c.S);
    float acc[T];
#pragma unroll
    for (int i = 0; i < T; ++i) acc[i] = 0.f;
    for (int dh = 0; dh < c.KH; ++dh) {
      const int ty = iy + c.P - dh;
      if (ty < 0 || ty % c.S) continue;
      const int oy = ty / c.S;
      if (oy >= c.OH) continue;
      for (int dw = 0; dw < c.KW; ++dw) {
        const int tx = ix + c.P - dw;
        if (tx < 0 || tx % c.S) continue;
        const int ox = tx / c.S;
        if (ox >= c.OW) continue;
        const float* dyp = dy + (oy * c.OW + ox) * c.Cout;
        const float* wp = wt + (dh * c.KW + dw) * c.Cout * rs + ci;
        if (v4) {
          for (int co = 0; co < c.Cout; co += 4) {
            float d[4];
            load_t<4>(dyp + co, d);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float v[T];
              load_t<T>(wp + (co + j) * rs, v);
#pragma unroll
              for (int i = 0; i < T; ++i) acc[i] = fmaf(d[j], v[i], acc[i]);
            }
          }
        } else {
          for (int co = 0; co < c.Cout; ++co) {
            float v[T];
            load_t<T>(wp + co * rs, v);
#pragma unroll
            for (int i = 0; i < T; ++i) acc[i] = fmaf(dyp[co], v[i], acc[i]);
          }
        }
      }
    }
    const int o = (iy * c.W + ix) * c.Cin + ci;
    store_cluster<T>(dx + o, acc, C);
    if (gdx) store_t<T>(gdx + o, acc);
  }
}

// output rows of one conv-dW sub-sum: whole rows of at least DW_CHUNK pixels
__device__ __forceinline__ int dw_rows(int ow) { return max(1, DW_CHUNK / ow); }

// conv dW, this image's partial, this CTA's share of the outputs: a task is
// T output channels of one (tap, input channel) over one chunk of output
// rows (the valid pixels in raster order), summed from zero into CTA-local
// scratch; then each output joins its chunks in order into device memory
template <int T>
__device__ void conv_dw_share(const float* x, const float* dy, float* part, float* scratch,
                              Conv c, int rank, int C) {
  const int n_out = c.KH * c.KW * c.Cin * c.Cout;
  const int rows = dw_rows(c.OW), chunks = (c.OH + rows - 1) / rows;
  int glo, ghi;
  share(n_out / T, rank, C, glo, ghi);
  const int ng = ghi - glo;
  for (int t = threadIdx.x; t < ng * chunks; t += blockDim.x) {
    const int o = (glo + t % ng) * T, k = t / ng;
    const int co = o % c.Cout;
    int rest = o / c.Cout;
    const int ci = rest % c.Cin;
    rest /= c.Cin;
    const int dw = rest % c.KW, dh = rest / c.KW;
    // the output columns whose input column ox*S - P + dw lies in the image
    const int ox0 = c.P > dw ? (c.P - dw + c.S - 1) / c.S : 0;
    const int ox1 = c.W - 1 + c.P - dw < 0 ? -1 : min(c.OW - 1, (c.W - 1 + c.P - dw) / c.S);
    float acc[T];
#pragma unroll
    for (int j = 0; j < T; ++j) acc[j] = 0.f;
    for (int oy = k * rows; oy < min(c.OH, (k + 1) * rows); ++oy) {
      const int iy = oy * c.S - c.P + dh;
      if (iy < 0 || iy >= c.H) continue;
      const float* xp = x + (iy * c.W + ox0 * c.S - c.P + dw) * c.Cin + ci;
      const float* dp = dy + (oy * c.OW + ox0) * c.Cout + co;
      for (int ox = ox0; ox <= ox1; ++ox, xp += c.S * c.Cin, dp += c.Cout) {
        const float xv = *xp;
        float d[T];
        load_t<T>(dp, d);
#pragma unroll
        for (int j = 0; j < T; ++j) acc[j] = fmaf(xv, d[j], acc[j]);
      }
    }
    store_t<T>(scratch + k * n_out + o, acc);
  }
  __syncthreads();
  for (int o = glo * T + threadIdx.x; o < ghi * T; o += blockDim.x) {
    float sum = scratch[o];
    for (int k = 1; k < chunks; ++k) sum = __fadd_rn(sum, scratch[k * n_out + o]);
    part[o] = sum;
  }
}

// matmul forward, whole in every CTA, in the arena entry's order: the
// slices of 8 summed from zero (one thread each), then each K tile's slices
// joined in order (one thread a tile and output), then the tiles in order
// (one thread an output); the slices and tiles pass through scratch
__device__ void mm_fwd_whole(const float* a, const float* w, float* y, int K, int N, float* sl) {
  const int bk = K <= 1 ? 1 : (K < 128 ? 1 << (32 - __clz(K - 1)) : 128);
  const int spt = (bk + 7) / 8;
  const int tiles = (K + bk - 1) / bk;
  const int n_sl = tiles * spt;
  for (int o = threadIdx.x; o < n_sl * N; o += blockDim.x) {
    const int s = o / N, n = o - s * N, t = s / spt;
    const int k0 = t * bk + (s - t * spt) * 8, k1 = min(min(k0 + 8, (t + 1) * bk), K);
    float v = 0.f;
    for (int k = k0; k < k1; ++k) v = fmaf(a[k], w[k * N + n], v);
    sl[o] = v;
  }
  __syncthreads();
  float* tile = sl + n_sl * N;
  for (int o = threadIdx.x; o < tiles * N; o += blockDim.x) {
    const int t = o / N, n = o - t * N;
    float sum = 0.f;
    for (int q = 0; q < spt && t * bk + q * 8 < K; ++q)
      sum = __fadd_rn(sum, sl[(t * spt + q) * N + n]);
    tile[o] = sum;
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < tiles; ++t) acc = __fadd_rn(acc, tile[t * N + n]);
    y[n] = acc;
  }
}

// max-pool dX, whole in every CTA: a thread a window and channel routes the
// gradient to the window's first maximal tap (row-major), as pool_dx does
__device__ void pool_dx_windows(const float* x, const float* g, float* dx, const int* r) {
  const int W = r[5], C = r[6], K = r[7], OH = r[8], OW = r[9];
  for (int o = threadIdx.x; o < OH * OW * C; o += blockDim.x) {
    const int ch = o % C, pix = o / C;
    const int ox = pix % OW, oy = pix / OW;
    const int base = ((oy * K) * W + ox * K) * C + ch;
    float m = x[base];
    for (int dh = 0; dh < K; ++dh)
      for (int dw = 0; dw < K; ++dw) m = fmaxf(m, x[base + (dh * W + dw) * C]);
    bool found = false;
    for (int dh = 0; dh < K; ++dh)
      for (int dw = 0; dw < K; ++dw) {
        const int i = base + (dh * W + dw) * C;
        const bool first = !found && x[i] == m;
        found = found || first;
        dx[i] = first ? g[o] : 0.f;
      }
  }
}

__device__ __forceinline__ void stage_in(float* dst, const float* src, int n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && n % 4 == 0) {
    for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst + i)),
                   "l"(src + i) : "memory");
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst + i)),
                   "l"(src + i) : "memory");
  }
}

__global__ void __launch_bounds__(SMEM_THREADS, 1)
region_body_smem(const int* __restrict__ table, int n_stages, SmemBufs bufs, int nbuf) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  // the stage table and each buffer's slot, mode, size and device memory for
  // this image, read once: every stage then decodes from shared memory
  __shared__ int tab[MAX_SMEM_STAGES * REC];
  __shared__ int slot[MAX_BUFS], mode[MAX_BUFS], numel[MAX_BUFS];
  __shared__ float* gmem[MAX_BUFS];
  const int C = static_cast<int>(cluster_ctas());
  const int rank = static_cast<int>(cta_rank());
  const long long img = blockIdx.x / C;
  for (int i = threadIdx.x; i < n_stages * REC; i += blockDim.x) tab[i] = table[i];
  for (int i = threadIdx.x; i < nbuf; i += blockDim.x) {
    slot[i] = bufs.slot[i];
    mode[i] = bufs.mode[i];
    numel[i] = bufs.numel[i];
    gmem[i] = bufs.g.ptr[i] ? bufs.g.ptr[i] + img * bufs.g.stride[i] : nullptr;
  }
  for (int i = 0; i < nbuf; ++i)
    if (bufs.mode[i] & STAGED)
      stage_in(sm + bufs.slot[i], bufs.g.ptr[i] + img * bufs.g.stride[i], bufs.numel[i]);
  asm volatile("cp.async.wait_all;" ::: "memory");
  cluster_sync();  // every CTA of the cluster runs, its inputs staged, before any DSMEM store
  for (int s = 0; s < n_stages; ++s) {
    const int* r = tab + s * REC;
    const int op = r[0];
    const float* a = r[1] >= 0 ? sm + slot[r[1]] : nullptr;
    const float* b = r[2] >= 0 ? sm + slot[r[2]] : nullptr;
    const int oi = r[3];
    float* out = slot[oi] >= 0 ? sm + slot[oi] : nullptr;  // none for dW partials
    float* g = gmem[oi];  // device memory: dW partials, escaping outputs
    float* gout = mode[oi] & ESCAPES ? g : nullptr;
    float* scratch = sm + r[REC - 1];
    const bool broadcast = op == OP_CONV_FWD || op == OP_CONV_DX;
    switch (op) {
      case OP_CONV_FWD: {
        const Conv c = conv_of(r);
        BY_WIDTH(tile_width(c.OH * c.OW * c.Cout, c.Cout, C), conv_fwd_share, a, b, out, gout,
                 c, rank, C);
        break;
      }
      case OP_CONV_DX: {
        const Conv c = conv_of(r);
        BY_WIDTH(tile_width(c.H * c.W * c.Cin, c.Cin, C), conv_dx_share, a, b, out, gout,
                 scratch, c, rank, C);
        break;
      }
      case OP_CONV_DW: {
        const Conv c = conv_of(r);
        const int chunks = (c.OH + dw_rows(c.OW) - 1) / dw_rows(c.OW);
        BY_WIDTH(tile_width(c.KH * c.KW * c.Cin * c.Cout * chunks, c.Cout, C), conv_dw_share,
                 a, b, g, scratch, c, rank, C);
        break;
      }
      case OP_MM_FWD:
        mm_fwd_whole(a, b, out, r[4], r[5], scratch);
        break;
      case OP_POOL_DX:
        pool_dx_windows(a, b, out, r);
        break;
      case OP_MM_DW: {  // this image's partial x[k] dy[n], this CTA's share
        const int N = r[5];
        int lo, hi;
        share(r[4] * N, rank, C, lo, hi);
        for (int o = lo + threadIdx.x; o < hi; o += blockDim.x) g[o] = a[o / N] * b[o % N];
        break;
      }
      case OP_BIAS_DW: {  // this image's partial: dy summed over its rows, this CTA's share
        const int n = r[4], Ch = r[5];
        int lo, hi;
        share(Ch, rank, C, lo, hi);
        for (int ch = lo + threadIdx.x; ch < hi; ch += blockDim.x) {
          float acc = 0.f;
          for (int o = ch; o < n; o += Ch) acc += a[o];
          g[ch] = acc;
        }
        break;
      }
      default:
        run_whole(op, r, a, b, out);
    }
    if (gout && !broadcast) {  // a whole stage's escaping output: the owner's share
      __syncthreads();
      int lo, hi;
      share(numel[oi], rank, C, lo, hi);
      for (int o = lo + threadIdx.x; o < hi; o += blockDim.x) gout[o] = out[o];
    }
    if (broadcast)
      cluster_sync();
    else
      __syncthreads();
  }
}

// the epilogue launch of both entries: the dW partials summed in image
// order, the update
cudaError_t launch_epilogue(const void* epi, int n_params, int max_numel, int batch, float lr,
                            float mu, const RegionBufs& bufs, cudaStream_t s) {
  if (n_params > 0 && max_numel > 0) {
    dim3 grid((max_numel + EPI_THREADS - 1) / EPI_THREADS, n_params);
    region_epilogue<<<grid, EPI_THREADS, 0, s>>>(static_cast<const int*>(epi), batch, lr, mu,
                                                  bufs);
  }
  return cudaGetLastError();
}

RegionBufs region_bufs(int nbuf, const long long* ptrs, const long long* strides) {
  RegionBufs bufs;
  for (int i = 0; i < MAX_BUFS; ++i) {
    bufs.ptr[i] = i < nbuf ? reinterpret_cast<float*>(ptrs[i]) : nullptr;
    bufs.stride[i] = i < nbuf ? strides[i] : 0;
  }
  return bufs;
}

}  // namespace

extern "C" int fused_region_launch(const void* body, int n_stages, int threads, const void* epi,
                                   int n_params, int max_numel, int batch, float lr, float mu,
                                   int nbuf, const long long* ptrs, const long long* strides,
                                   void* stream) {
  if (nbuf > MAX_BUFS || threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const RegionBufs bufs = region_bufs(nbuf, ptrs, strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_stages > 0 && batch > 0) {
    region_body<<<batch, threads, 0, s>>>(static_cast<const int*>(body), n_stages, bufs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(launch_epilogue(epi, n_params, max_numel, batch, lr, mu, bufs, s));
}

// The shared-memory entry: `cluster` CTAs per image, `smem_bytes` of dynamic
// shared memory each; slots, numels and modes per buffer as SmemBufs holds them.
extern "C" int fused_region_smem_launch(const void* body, int n_stages, int threads,
                                        const void* epi, int n_params, int max_numel, int batch,
                                        float lr, float mu, int nbuf, const long long* ptrs,
                                        const long long* strides, int cluster, int smem_bytes,
                                        const int* slots, const int* numels, const int* modes,
                                        void* stream) {
  if (nbuf > MAX_BUFS || threads > SMEM_THREADS || cluster < 1 || cluster > 8 ||
      n_stages > MAX_SMEM_STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  SmemBufs bufs;
  bufs.g = region_bufs(nbuf, ptrs, strides);
  for (int i = 0; i < MAX_BUFS; ++i) {
    bufs.slot[i] = i < nbuf ? slots[i] : -1;
    bufs.numel[i] = i < nbuf ? numels[i] : 0;
    bufs.mode[i] = i < nbuf ? modes[i] : 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_stages > 0 && batch > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        region_body_smem, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(batch * cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem_bytes;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, region_body_smem, static_cast<const int*>(body), n_stages,
                             bufs, nbuf);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(launch_epilogue(epi, n_params, max_numel, batch, lr, mu, bufs.g, s));
}

// How many clusters of `cluster` CTAs of the shared-memory entry run at once on
// the device, with `smem_bytes` of shared memory and `threads` threads each.
extern "C" int fused_region_smem_max_clusters(int cluster, int smem_bytes, int threads, int* n) {
  cudaError_t err = cudaFuncSetAttribute(region_body_smem,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(n, region_body_smem, &cfg));
}

extern "C" const char* fused_region_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

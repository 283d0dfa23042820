// Fused train-step region for Hopper: fwd, softmax-CE gradient, dW, dX and
// the SGD/momentum update of one region in two launches.
//
// Replaces the TPU kernel repro/kernels/fused.py::build_region_callable
// (kernel body `kernel`, stage math _stage_flow / _stage_updates). The TPU
// kernel walks batch tiles in order on one core: it streams batched inputs
// through a VMEM double buffer, keeps intermediates in VMEM, accumulates
// dW partials across grid steps and runs the update on the last step.
//
// Bound on the H100: the paper CNN step at batch 64 moves a few MB of
// inputs and outputs and does about 0.4 GFLOP, so neither HBM bytes nor
// the fp32 pipe bounds it at a useful size; what limits this design is
// latency and parallelism inside one CTA per image.
//
// Design:
//   * the grid's sequential order does not carry over to CUDA, so the
//     cross-image ordering is made explicit: a body launch with one CTA per
//     image, then an epilogue launch that reduces the per-image dW partials
//     in a fixed order (deterministic run to run, no float atomics) and
//     applies the update;
//   * the body CTA walks a stage table compiled on the host from the
//     region spec; each stage is a block-strided loop over its per-image
//     output elements with an fp32 accumulator, and __syncthreads()
//     separates stages. Every stage is per-image independent, as the TPU
//     kernel's batch tiles already require;
//   * intermediates live in a per-image scratch arena in device memory
//     (about 100 KB per image for the paper CNN, L2-resident at batch 64);
//   * conv dX is the gather form of "dilate by s, pad by k-1-p, correlate
//     with rot180(w)": no dilated buffer. MaxPool dX routes the gradient to
//     the first maximal tap in row-major order. ReLU dX masks from the relu
//     output. The matmul stages run in this body, as on the TPU.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_BUFS = 64;
constexpr int REC = 16;
constexpr int EPI_REC = 8;
constexpr int EPI_THREADS = 256;

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

__global__ void __launch_bounds__(1024)
region_body(const int* __restrict__ table, int n_stages, RegionBufs bufs) {
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
      case OP_MM_FWD: {  // y[n] = sum_k x[k] w[k, n]
        const int K = r[4], N = r[5];
        for (int n = threadIdx.x; n < N; n += blockDim.x) {
          float acc = 0.f;
          for (int k = 0; k < K; ++k) acc = fmaf(a[k], b[k * N + n], acc);
          out[n] = acc;
        }
        break;
      }
      case OP_MM_DW: {  // this image's partial: x[k] dy[n]
        const int K = r[4], N = r[5];
        for (int o = threadIdx.x; o < K * N; o += blockDim.x) out[o] = a[o / N] * b[o % N];
        break;
      }
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
      case OP_BIAS_DW: {  // this image's partial: dy summed over its rows
        const int n = r[4], C = r[5];
        for (int ch = threadIdx.x; ch < C; ch += blockDim.x) {
          float acc = 0.f;
          for (int o = ch; o < n; o += C) acc += a[o];
          out[ch] = acc;
        }
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

}  // namespace

extern "C" int fused_region_launch(const void* body, int n_stages, int threads, const void* epi,
                                   int n_params, int max_numel, int batch, float lr, float mu,
                                   int nbuf, const long long* ptrs, const long long* strides,
                                   void* stream) {
  if (nbuf > MAX_BUFS || threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
  RegionBufs bufs;
  for (int i = 0; i < nbuf; ++i) {
    bufs.ptr[i] = reinterpret_cast<float*>(ptrs[i]);
    bufs.stride[i] = strides[i];
  }
  for (int i = nbuf; i < MAX_BUFS; ++i) {
    bufs.ptr[i] = nullptr;
    bufs.stride[i] = 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_stages > 0 && batch > 0) {
    region_body<<<batch, threads, 0, s>>>(static_cast<const int*>(body), n_stages, bufs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_params > 0 && max_numel > 0) {
    dim3 grid((max_numel + EPI_THREADS - 1) / EPI_THREADS, n_params);
    region_epilogue<<<grid, EPI_THREADS, 0, s>>>(static_cast<const int*>(epi), batch, lr, mu,
                                                  bufs);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_region_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

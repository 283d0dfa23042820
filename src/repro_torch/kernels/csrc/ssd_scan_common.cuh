// The parts the two tensor-core SSD scans share (ssd_scan_wgmma.cu for bf16,
// ssd_scan_tf32.cu for fp32): the dims of a call, the store of a wgmma
// accumulator tile, and pass 3, the states across chunks, which runs in fp32
// in both.

#pragma once

#include "sm90.cuh"

namespace {

struct Dims {
  int B, H, G, S, P, N, Q, NC;  // NC = S / Q chunks
  long long sla[3];             // element strides of la
};

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_AHEAD = 8;  // chunks whose state loads a scan thread issues at once

// the accumulator tile's columns as fp32 pairs into a row-major matrix with row stride ld
__device__ __forceinline__ void store_tile(float* out, long long ld, const float (&acc)[32],
                                           int lt) {
  const int r0 = 16 * (lt / 32) + (lt % 32) / 4, c0 = 2 * (lt % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(out + (r0 + 8 * i) * ld + 8 * j + c0) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
}

// ---- pass 3: the states across chunks ----------------------------------------

// grid (P N / 4 / SCAN_THREADS, H, B): each thread carries 4 state elements
// through the chunks in order, writing the state each chunk starts from
// over that chunk's own state. The chunks come in groups of SCAN_AHEAD whose
// loads are all issued before the group's first store, so that a thread
// keeps that many loads in flight.
__global__ void __launch_bounds__(SCAN_THREADS)
ssd_chunk_scan(const float* __restrict__ cum_ws, float* __restrict__ st_ws, Dims d) {
  const int per = d.P * d.N / 4;
  const int e = blockIdx.x * SCAN_THREADS + threadIdx.x;
  if (e >= per) return;
  const long long bh = static_cast<long long>(blockIdx.z) * d.H + blockIdx.y;
  float4* s = reinterpret_cast<float4*>(st_ws + bh * d.NC * d.P * d.N) + e;
  const float* total = cum_ws + bh * d.S + d.Q - 1;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < d.NC; c0 += SCAN_AHEAD) {
    const int m = min(SCAN_AHEAD, d.NC - c0);
    float4 v[SCAN_AHEAD];
    float dec[SCAN_AHEAD];
#pragma unroll
    for (int k = 0; k < SCAN_AHEAD; ++k)
      if (k < m) {
        v[k] = s[static_cast<long long>(c0 + k) * per];
        dec[k] = expf(total[static_cast<long long>(c0 + k) * d.Q]);
      }
#pragma unroll
    for (int k = 0; k < SCAN_AHEAD; ++k)
      if (k < m) {
        s[static_cast<long long>(c0 + k) * per] = h;
        h.x = __fadd_rn(__fmul_rn(dec[k], h.x), v[k].x);
        h.y = __fadd_rn(__fmul_rn(dec[k], h.y), v[k].y);
        h.z = __fadd_rn(__fmul_rn(dec[k], h.z), v[k].z);
        h.w = __fadd_rn(__fmul_rn(dec[k], h.w), v[k].w);
      }
  }
}

}  // namespace

// The NTX command kernel: one launch runs one NTX command on a device TCDM.
//
// Replaces no TPU kernel: the JAX package runs NTX programs through its
// numpy interpreter (repro/core/ntx.py::ntx_execute). The host decides each
// command's mode once per program (repro_torch/kernels/ntx_exec.py) and
// uploads a table of 256-byte rows (struct NtxCmd); ntx_exec_program walks
// the host copy and launches one kernel per command on the caller's stream,
// each reading its row from the device copy.
//
// A thread runs `per_thread` consecutive iterations of the five-loop nest in
// issue order, with the loop interpreter's semantics: the accumulator is
// reset when the loops below init_level are all at zero, the opcode runs,
// and the accumulator is stored through the write AGU when the loops below
// store_level are all at their last index. The modes only set the split:
//   region     a thread per accumulation region (the inner init_level loops),
//   streaming  a thread per iteration,
//   sequential one thread for the whole nest.
// The host takes region or streaming only where no thread reads or writes
// an address that another thread stores to, so the result is the
// interpreter's, bit for bit, and the same bits run to run (no atomics).
//
// Numerics: wide commands carry the accumulator in fp64, with the product
// and the add of a `mac` rounded apart (__dmul_rn, __dadd_rn: nvcc would
// otherwise contract them into an FMA), and round it once to fp32 at the
// store; narrow ones round every multiply and add in fp32 (__fmul_rn,
// __fadd_rn). vrecip and vrsqrt are IEEE divisions (and square root); vexp
// is expf.
//
// Bound: latency. A command is typically a few hundred threads, each a
// dependent chain of loads and adds, and one launch; neither the bytes nor
// the operations of a step come near the card's rates.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kLoops = 5;

// One command row (repro_torch/kernels/ntx_exec.py::_row). Outside the
// anonymous namespace: the C entry's signature names it, and a type with
// internal linkage would give the entry internal linkage too.
struct NtxCmd {
  long long loops[kLoops];        // N0..N4, innermost first
  long long opcode;               // index into core/ntx.py's _OPS
  long long init_level;           // clamped to [0, 5] by the host
  long long store_level;
  long long mode;                 // 0 sequential, 1 region, 2 streaming
  double init_value;
  long long flags;                // bit 0 rd0, bit 1 rd1, bit 2 wr present
  long long n_threads;
  long long per_thread;           // iterations each thread runs
  long long base[3];              // rd0, rd1, wr
  long long strides[3][kLoops];
  long long pad;
};
static_assert(sizeof(NtxCmd) == 256, "one command row is 32 int64 words");

namespace {

constexpr int kThreads = 128;

enum Op : long long {
  MAC = 0, VADD, VMUL, VMAX, VMIN, RELU, COPY, MEMSET, ARGMAX, SIGN, CMPGE, VEXP, VRECIP,
  VRSQRT
};

__device__ __forceinline__ double mac_step(double acc, float a, float b) {
  return __dadd_rn(acc, __dmul_rn(static_cast<double>(a), static_cast<double>(b)));
}
__device__ __forceinline__ float mac_step(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}
__device__ __forceinline__ double from_value(double v, double*) { return v; }
__device__ __forceinline__ float from_value(double v, float*) { return __double2float_rn(v); }
__device__ __forceinline__ float to_float(double v) { return __double2float_rn(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// Negative addresses index from the end, as the interpreter's indices do
// (only sequential commands reach them; the host bounds every address).
__device__ __forceinline__ long long wrap(long long a, long long size) {
  return a < 0 ? a + size : a;
}

template <typename Acc>
__global__ void __launch_bounds__(kThreads)
ntx_exec_kernel(const NtxCmd* __restrict__ cmd_ptr, float* __restrict__ mem, long long size) {
  const NtxCmd& c = *cmd_ptr;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= c.n_threads) return;
  const long long op = c.opcode;
  const bool has0 = c.flags & 1, has1 = c.flags & 2, has_wr = c.flags & 4;
  const bool read0 = op != MEMSET;
  const bool read1 = has1 && (op == MAC || op == VADD || op == VMUL || op == CMPGE);
  long long n[kLoops], s0[kLoops], s1[kLoops], sw[kLoops], idx[kLoops];
  long long rem = t * c.per_thread;  // the thread's first iteration
  long long a0 = c.base[0], a1 = c.base[1], aw = c.base[2];
#pragma unroll
  for (int j = 0; j < kLoops; ++j) {
    n[j] = c.loops[j];
    s0[j] = c.strides[0][j];
    s1[j] = c.strides[1][j];
    sw[j] = c.strides[2][j];
    idx[j] = rem % n[j];
    rem /= n[j];
    a0 += idx[j] * s0[j];
    a1 += idx[j] * s1[j];
    aw += idx[j] * sw[j];
  }
  const int init_level = static_cast<int>(c.init_level);
  const int store_level = static_cast<int>(c.store_level);
  const long long per_thread = c.per_thread;
  const Acc init = from_value(c.init_value, static_cast<Acc*>(nullptr));
  Acc acc = init;
  long long counter = 0, arg = 0;
  for (long long it = 0; it < per_thread; ++it) {
    bool fresh = true;
#pragma unroll
    for (int j = 0; j < kLoops; ++j) fresh &= j >= init_level || idx[j] == 0;
    if (fresh) {
      acc = init;
      counter = 0;
      arg = 0;
    }
    const float x = (has0 && read0) ? mem[wrap(a0, size)] : 0.f;
    const float y = read1 ? mem[wrap(a1, size)] : 0.f;
    switch (op) {
      case MAC: acc = mac_step(acc, x, y); break;
      case VADD: acc = static_cast<Acc>(__fadd_rn(x, y)); break;
      case VMUL: acc = static_cast<Acc>(__fmul_rn(x, y)); break;
      case VMAX: {
        const Acc v = static_cast<Acc>(x);
        acc = (counter == 0 || v > acc) ? v : acc;
        break;
      }
      case VMIN: {
        const Acc v = static_cast<Acc>(x);
        acc = (counter == 0 || v < acc) ? v : acc;
        break;
      }
      case RELU: acc = static_cast<Acc>(x > 0.f ? x : 0.f); break;
      case COPY: acc = static_cast<Acc>(x); break;
      case MEMSET: acc = init; break;
      case ARGMAX: {
        const Acc v = static_cast<Acc>(x);
        if (counter == 0 || v > acc) {
          acc = v;
          arg = counter;
        }
        break;
      }
      case SIGN: acc = static_cast<Acc>(x > 0.f ? 1.f : 0.f); break;
      case CMPGE: acc = static_cast<Acc>(x >= y ? 1.f : 0.f); break;
      case VEXP: acc = static_cast<Acc>(expf(x)); break;
      case VRECIP: acc = static_cast<Acc>(__fdiv_rn(1.f, x)); break;
      case VRSQRT: acc = static_cast<Acc>(__fdiv_rn(1.f, __fsqrt_rn(x))); break;
      default: break;
    }
    ++counter;
    bool store = has_wr;
#pragma unroll
    for (int j = 0; j < kLoops; ++j) store &= j >= store_level || idx[j] == n[j] - 1;
    if (store) {
      mem[wrap(aw, size)] = op == ARGMAX ? static_cast<float>(arg) : to_float(acc);
    }
    // the AGUs' odometer: one step of the innermost loop, carries outwards
#pragma unroll
    for (int j = 0; j < kLoops; ++j) {
      a0 += s0[j];
      a1 += s1[j];
      aw += sw[j];
      if (++idx[j] < n[j]) break;
      a0 -= n[j] * s0[j];
      a1 -= n[j] * s1[j];
      aw -= n[j] * sw[j];
      idx[j] = 0;
    }
  }
}

}  // namespace

extern "C" {

// Launch commands [0, count) of the table on `stream`, in order, one kernel
// each. `host` and `dev` hold the same rows; `mem` is the flat fp32 TCDM of
// `size` words. Returns the first CUDA error, or 0.
int ntx_exec_program(const NtxCmd* host, const NtxCmd* dev, long long count, float* mem,
                     long long size, int wide, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (long long i = 0; i < count; ++i) {
    const long long threads = host[i].n_threads;
    const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    if (wide) {
      ntx_exec_kernel<double><<<blocks, kThreads, 0, s>>>(dev + i, mem, size);
    } else {
      ntx_exec_kernel<float><<<blocks, kThreads, 0, s>>>(dev + i, mem, size);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ntx_exec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Streaming softmax entropy + Alg. 3 exit gate, CUDA C++ for Hopper (sm_90a).
//
// Replaces: repro/kernels/entropy_exit.py, entropy_exit_pallas
// (_entropy_kernel), the TPU kernel that streams vocab blocks through VMEM.
//
// Per row of logits x (length V) it keeps three running fp32 values,
//     m = running max,  S = sum e^{x-m},  U = sum e^{x-m} * x,
// rescaling S and U by e^{m_old - m_new} on a new max, and finishes with
//     H = m + log S - U / S   (S clamped >= 1e-30),   exit = H < tau[row].
// The (B, V) softmax is never written to memory.
//
// Design: one block per row, 256 threads striding the vocab so that
// neighbouring threads read neighbouring logits.  Each thread keeps its own
// (m, S, U); the triples merge by warp shuffles, then across the 8 warps
// through shared memory, with the same e^{m_old - m_new} rescale.  Thread 0
// writes H and the exit flag.  tau is a device array, one value per row, so
// reading it never synchronises the host.
//
// Bound on this card: bytes.  The kernel reads each logit once (B*V*2 bytes
// in bf16) and does a few flops per logit.  At the serve shape (8, 151552)
// only 8 of the 132 SMs have a block, so one SM's load bandwidth, not HBM,
// limits it.  A later PR would split the vocab of a row across blocks (a
// second pass, or one merge block, combines the partial triples) and use
// 16-byte loads.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Triple {
  float m, s, u;
};

// Merge two partial (m, S, U) triples; an empty triple has m = -inf.
__device__ __forceinline__ Triple merge(Triple a, Triple b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return a;
  const float fa = (a.m == -INFINITY) ? 0.f : expf(a.m - m);
  const float fb = (b.m == -INFINITY) ? 0.f : expf(b.m - m);
  return {m, a.s * fa + b.s * fb, a.u * fa + b.u * fb};
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
entropy_exit_kernel(const T* __restrict__ logits, long long row_stride,
                    int vocab, const float* __restrict__ tau,
                    float* __restrict__ entropy, int* __restrict__ exit_flag) {
  const T* x = logits + static_cast<long long>(blockIdx.x) * row_stride;
  Triple t = {-INFINITY, 0.f, 0.f};
  for (int i = threadIdx.x; i < vocab; i += kThreads) {
    const float v = to_float(x[i]);
    if (v > t.m) {
      const float f = expf(t.m - v);  // 0 while the triple is empty
      t.s = t.s * f + 1.f;
      t.u = t.u * f + v;
      t.m = v;
    } else {
      const float e = expf(v - t.m);
      t.s += e;
      t.u += e * v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Triple o;
    o.m = __shfl_xor_sync(0xffffffffu, t.m, off);
    o.s = __shfl_xor_sync(0xffffffffu, t.s, off);
    o.u = __shfl_xor_sync(0xffffffffu, t.u, off);
    t = merge(t, o);
  }
  __shared__ Triple warp_part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    Triple r = warp_part[0];
    for (int w = 1; w < kWarps; ++w) r = merge(r, warp_part[w]);
    const float S = fmaxf(r.s, 1e-30f);
    const float H = r.m + logf(S) - r.u / S;
    entropy[blockIdx.x] = H;
    exit_flag[blockIdx.x] = H < tau[blockIdx.x] ? 1 : 0;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int entropy_exit_launch(const void* logits, int dtype,
                                   long long rows, long long row_stride,
                                   int vocab, const float* tau, float* entropy,
                                   int* exit_flag, void* stream) {
  if (rows <= 0 || vocab <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    entropy_exit_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(logits), row_stride, vocab, tau, entropy,
        exit_flag);
  } else if (dtype == 1) {
    entropy_exit_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), row_stride, vocab, tau,
        entropy, exit_flag);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

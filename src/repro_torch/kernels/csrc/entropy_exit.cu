// Streaming softmax entropy + Alg. 3 exit gate, CUDA C++ for Hopper (sm_90a).
//
// Replaces: repro/kernels/entropy_exit.py, entropy_exit_pallas
// (_entropy_kernel), the TPU kernel that streams vocab blocks through VMEM.
//
// Per row of logits x (length V) it keeps three running fp32 values,
//     m = running max,  S = sum e^{x-m},  U = sum e^{x-m} * x,
// rescaling S and U by e^{m_old - m_new} on a new max, and finishes with
//     H = m + log S - U / S   (S clamped >= 1e-30),   exit = H < tau[row].
// The (B, V) softmax is never written to memory.  A -inf element adds 0 to
// S and 0 * -inf = NaN to U, so a row holding one has H = NaN and does not
// exit, as the JAX kernel's p log p gives it (and the plain version's);
// a row of -inf only has m = -inf throughout and H = NaN as well.
//
// Bound on this card: bytes (each logit read once, a few operations on
// it).  At glm4-9b's serve shape, 8 rows of 151552 bf16 (2.4 MB), that is
// 0.72 us at 3.35 TB/s, below what one launch costs on its own.  The
// design keeps the launch the only large cost:
//
//   * Each row's vocab is split over the `splits` blocks of one thread
//     block cluster (grid (splits, rows), a cluster dimension of
//     (splits, 1, 1)), so 8 rows keep 128 SMs busy and not 8.  Slice r of
//     a row is [r * per, (r + 1) * per) clipped to V, per = ceil(V /
//     splits) rounded up to 8 elements (trailing slices may be empty).
//     The wrapper picks `splits` (`gate_splits`): up to 16, a non-portable
//     cluster size, one block a row when the rows alone fill the card.
//   * Every thread issues kUnroll 16-byte loads (8 bf16 or 4 fp32,
//     ld.global.nc, no L1 allocation) before it computes on any of them:
//     at the serve shape the whole 2.4 MB is requested in one round.  A
//     scalar head runs up to the slice's first 16-byte boundary and a
//     scalar tail after its last whole vector, so rows need not be aligned.
//   * No branch per element: a vector's max is taken first and S and U are
//     rescaled at most once a vector; each element then adds
//     e = 2^(x log2e - m log2e) (ex2.approx) to S and e x to U.
//   * A block merges its threads' triples by warp shuffles and across warps
//     in shared memory, then writes its triple into rank 0's shared memory
//     (distributed shared memory) and arrives on the cluster barrier with
//     release semantics; every block but rank 0 then leaves.  Rank 0 waits,
//     takes the row's max, sums the rescaled S and U in rank order and
//     writes H and the exit flag.  An arrive at the kernel's start, waited
//     on before the write, makes sure every block of the cluster has
//     started.  One launch, no global scratch, no atomics: the same input
//     gives the same bits.
//
// Times on an H100 80GB HBM3 at 700 W: PERF.md, section 6 (chip_smoke.py
// phase `timing`).  At the serve shape the kernel takes about twice the
// launch floor (a one-element torch op timed the same way): the launch, a
// DRAM latency and the merges, not the 0.72 us of bytes, make up its time.
#include <atomic>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;          // 16-byte loads in flight per thread
constexpr int kMaxSplits = 16;      // blocks of a cluster (> 8: non-portable)
constexpr int kSliceAlign = 8;      // slice bounds fall on 8-element steps
constexpr int kMaxGridY = 65535;    // rows beyond it go to grid.z
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void unpack(uint4 v, float (&x)[n]) {
    x[0] = __uint_as_float(v.x);
    x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z);
    x[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ float one(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void unpack(uint4 v, float (&x)[n]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float one(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
};

__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

struct Triple {
  float m, s, u;
};

// Merge two partial (m, S, U) triples; an empty triple has m = -inf.  Two
// triples with m = -inf (empty, or -inf entries only: S = 0, U = 0 or NaN)
// merge by adding their U, so a NaN is kept.
__device__ __forceinline__ Triple merge(Triple a, Triple b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return {m, 0.f, a.u + b.u};
  const float fa =
      (a.m == -INFINITY) ? 0.f : hopper::exp2_ftz((a.m - m) * kLog2e);
  const float fb =
      (b.m == -INFINITY) ? 0.f : hopper::exp2_ftz((b.m - m) * kLog2e);
  return {m, a.s * fa + b.s * fb, a.u * fa + b.u * fb};
}

__device__ __forceinline__ Triple shfl_merge(Triple t, int off) {
  Triple o;
  o.m = __shfl_xor_sync(0xffffffffu, t.m, off);
  o.s = __shfl_xor_sync(0xffffffffu, t.s, off);
  o.u = __shfl_xor_sync(0xffffffffu, t.u, off);
  return merge(t, o);
}

// Adds N elements to a thread's triple: the max first (one rescale at
// most), then every element without a branch.  x * log2e - m * log2e
// keeps each exponent <= 0 up to rounding; a -inf element gives e = 0 and
// adds fma(0, -inf) = NaN to U (the rescales and merges keep a NaN: 0 x NaN
// is NaN).
template <int N>
__device__ __forceinline__ void accumulate(Triple& t, const float (&x)[N]) {
  float vm = x[0];
#pragma unroll
  for (int j = 1; j < N; ++j) vm = fmaxf(vm, x[j]);
  const float m = fmaxf(t.m, vm);
  const float f = (m == t.m) ? 1.f : hopper::exp2_ftz((t.m - m) * kLog2e);
  t.s *= f;
  t.u *= f;
  t.m = m;
  const float mb = (m == -INFINITY) ? 0.f : m * kLog2e;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float e = hopper::exp2_ftz(fmaf(x[j], kLog2e, -mb));
    t.s += e;
    t.u = fmaf(e, x[j], t.u);
  }
}

// barrier.cluster in three steps: an early relaxed arrive, a wait that
// acquires, an arrive that releases the writes before it
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One cluster per row (row = blockIdx.z * gridDim.y + blockIdx.y); block
// `rank` reduces slice `rank` of it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
entropy_exit_kernel(const T* __restrict__ logits, long long rows,
                    long long row_stride, int vocab,
                    const float* __restrict__ tau, float* __restrict__ entropy,
                    int* __restrict__ exit_flag) {
  constexpr int kVec = Vec<T>::n;
  __shared__ Triple warp_part[kWarps];
  __shared__ Triple parts[kMaxSplits];    // rank 0's: every block's triple
  cg::cluster_group cluster = cg::this_cluster();
  // the wait below (after the streaming) then finds every block of the
  // cluster started, so rank 0's shared memory may be written
  cluster_arrive_relaxed();
  const long long row =
      static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
  if (row >= rows) return;   // the last grid.z slice's padding clusters
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int per = ((vocab + cs - 1) / cs + kSliceAlign - 1) / kSliceAlign *
                  kSliceAlign;
  const int lo = min(vocab, rank * per), hi = min(vocab, lo + per);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* x = logits + row * row_stride;
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(x + lo) & 15) / sizeof(T));
  const int head = min(hi - lo, mis ? kVec - mis : 0);
  const int nvec = (hi - lo - head) / kVec;
  const int tail = lo + head + nvec * kVec;
  const uint4* vp = reinterpret_cast<const uint4*>(x + lo + head);

  Triple t = {-INFINITY, 0.f, 0.f};
  for (int base = threadIdx.x; base < nvec; base += kThreads * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      v[k] = make_uint4(0u, 0u, 0u, 0u);
      if (base + k * kThreads < nvec)
        v[k] = load_stream(vp + base + k * kThreads);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (base + k * kThreads < nvec) {
        float xs[kVec];
        Vec<T>::unpack(v[k], xs);
        accumulate(t, xs);
      }
    }
  }
  // the head (< kVec elements) and the tail (< kVec): one element each
  // for the first threads
  const int n_tail = hi - tail;
  int idx = -1;
  if (threadIdx.x < head) idx = lo + threadIdx.x;
  else if (threadIdx.x < head + n_tail) idx = tail + threadIdx.x - head;
  if (idx >= 0) {
    const float xs[1] = {Vec<T>::one(x[idx])};
    accumulate(t, xs);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t = shfl_merge(t, off);
  if (lane == 0) warp_part[warp] = t;
  __syncthreads();
  if (warp == 0) {
    Triple w = {-INFINITY, 0.f, 0.f};
    if (lane < kWarps) w = warp_part[lane];
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) w = shfl_merge(w, off);
    t = w;
  }
  cluster_wait();
  if (threadIdx.x == 0) *cluster.map_shared_rank(&parts[rank], 0) = t;
  cluster_arrive_release();
  // the other blocks leave now: nothing reads their shared memory
  if (rank != 0) return;
  cluster_wait();
  if (warp == 0) {
    // lane q holds rank q's triple; the row's max, then each rank's S and
    // U rescaled to it and summed in rank order by every lane
    Triple p = {-INFINITY, 0.f, 0.f};
    if (lane < cs) p = parts[lane];
    float M = p.m;
#pragma unroll
    for (int off = kMaxSplits / 2; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    const float w =
        (p.m == -INFINITY) ? 0.f : hopper::exp2_ftz((p.m - M) * kLog2e);
    const float ws = p.s * w, wu = p.u * w;
    float S = 0.f, U = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q) {
      S += __shfl_sync(0xffffffffu, ws, q);
      U += __shfl_sync(0xffffffffu, wu, q);
    }
    if (lane == 0) {
      S = fmaxf(S, 1e-30f);
      const float H = M + logf(S) - U / S;
      entropy[row] = H;
      exit_flag[row] = H < tau[row] ? 1 : 0;
    }
  }
}

// cudaFuncAttributeNonPortableClusterSizeAllowed on entropy_exit_kernel<T>,
// set once per device: the attribute never changes.  A failure is not
// remembered, so every later launch returns its error again.
template <typename T>
cudaError_t allow_non_portable_clusters() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev].load(std::memory_order_relaxed))
    return cudaSuccess;
  err = cudaFuncSetAttribute(entropy_exit_kernel<T>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && dev < kMaxDevices)
    allowed[dev].store(true, std::memory_order_relaxed);
  return err;
}

template <typename T>
int launch(const void* logits, long long rows, long long row_stride,
           int vocab, int splits, const float* tau, float* entropy,
           int* exit_flag, cudaStream_t stream) {
  cudaError_t err =
      splits > 8 ? allow_non_portable_clusters<T>() : cudaSuccess;
  if (err == cudaSuccess) {
    const long long z = (rows + kMaxGridY - 1) / kMaxGridY;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(splits);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(splits),
                       static_cast<unsigned>((rows + z - 1) / z),
                       static_cast<unsigned>(z));
    cfg.blockDim = dim3(kThreads);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, entropy_exit_kernel<T>,
                             static_cast<const T*>(logits), rows, row_stride,
                             vocab, tau, entropy, exit_flag);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();   // clear it: the next launch of another library
    return static_cast<int>(err);   // must not report it as its own
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; `splits` blocks (1..16) per row, one
// thread block cluster.  Returns the error of the launch itself, else
// cudaGetLastError() after it (0 = launched).
extern "C" int entropy_exit_launch(const void* logits, int dtype,
                                   long long rows, long long row_stride,
                                   int vocab, int splits, const float* tau,
                                   float* entropy, int* exit_flag,
                                   void* stream) {
  if (rows <= 0 || vocab <= 0 || splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(logits, rows, row_stride, vocab, splits, tau,
                         entropy, exit_flag, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(logits, rows, row_stride, vocab, splits,
                                 tau, entropy, exit_flag, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

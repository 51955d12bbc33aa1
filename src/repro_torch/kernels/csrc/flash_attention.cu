// Block-tiled online-softmax attention forward, CUDA C++ for Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention.py, flash_attention_pallas
// (_flash_kernel), the TPU kernel with grid (B, H, q blocks, kv blocks) and
// its running (max, denom, accum) in VMEM scratch.
//
// out[b, h, t] = softmax_s(q[b,h,t] . k[b,kvh,s] / sqrt(D)) @ v[b,kvh,s]
// with GQA head h reading kv head kvh = h / (H / Hkv), and key s masked
// unless s < Tk, s < kv_len[b] (the decode ring's valid prefix, one value
// per row on the device), s <= t when causal, and s > t - window when a
// sliding window is set: every mask of _pair_mask/_block_run.  The softmax
// and the sums run in fp32; the output is written in q's dtype, and the
// per-row logsumexp when its pointer is not null.
//
// Design: the TPU's sequential kv-block grid axis becomes a loop inside the
// block.  A block owns 4 query rows of one (batch, kv head); the rows are
// taken from the flattened (t, g) index over the GQA group, so a decode
// step (Tq = 1) puts 4 heads of one group in a block and every block
// shares its K/V tiles among them.  Each warp owns one row: lane j scores
// key j of the 32-key tile staged in shared memory (fp32, K rows padded by
// one word against bank conflicts), the warp reduces max and sum by
// shuffles, and each lane accumulates D/32 output columns.  Tiles wholly
// outside the causal band, the window or kv_len are never loaded.  Masked
// keys get probability exactly 0, and a row that has seen no key keeps
// m = -1e30, so a fully masked row writes 0 (as the TPU kernel does).
// Operands are addressed through their strides (innermost stride 1), so
// the model's (B, T, H, D) tensors and the KV cache are read in place.
//
// Bound on this card: bytes.  Decode reads the whole KV cache once per
// step and does 4*D flops per cached key and head; the causal prefill at
// Tq <= 128 is small.  Plain FMAs from shared memory keep it simple; a
// later PR would use wgmma with TMA-fed tiles for prefill and split the
// keys of a decode row across blocks (split-K) to fill the 132 SMs.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps;  // one query row per warp
constexpr int kKeys = 32;      // keys per tile, one per lane
constexpr float kNegInf = -1e30f;

}  // namespace

// Mirrored field for field by a ctypes.Structure in flash_attention.py.
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;          // (B, H, Tq) contiguous, or null
  const int* kv_len;   // (B,), or null for "all Tk keys"
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;
  int batch, heads, kv_heads, tq, tk, head_dim;
  int causal, window;  // window <= 0: no sliding window
  int dtype;           // 0 = float32, 1 = bfloat16
  float scale;
};

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const FlashParams p) {
  constexpr int kCols = (D + 31) / 32;  // output columns per lane
  __shared__ float qs[kRows][D];
  __shared__ float ks[kKeys][D + 1];
  __shared__ float vs[kKeys][D];

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int group = p.heads / p.kv_heads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;

  const T* q = static_cast<const T*>(p.q);
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // this warp's row: query position t of head h = kvh * group + g
  const long long my_row = row0 + warp;
  const int t = static_cast<int>(my_row / group);
  const int h = kvh * group + static_cast<int>(my_row % group);
  const bool row_ok = t < p.tq;

  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const long long row = row0 + r;
    const int rt = static_cast<int>(row / group);
    const int rh = kvh * group + static_cast<int>(row % group);
    qs[r][d] = rt < p.tq ? to_float(q[b * p.q_sb + rh * p.q_sh + rt * p.q_st + d])
                         : 0.f;
  }

  // keys any row of this block can see
  const int t_lo = static_cast<int>(row0 / group);
  const int t_hi = min(p.tq - 1, static_cast<int>((row0 + kRows - 1) / group));
  const int kv_limit = p.kv_len ? min(p.tk, p.kv_len[b]) : p.tk;
  const int k_end = p.causal ? min(kv_limit, t_hi + 1) : kv_limit;
  const int k_begin = p.window > 0 ? max(0, t_lo - p.window + 1) : 0;

  float m = kNegInf, l = 0.f;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;

  for (int k0 = (k_begin / kKeys) * kKeys; k0 < k_end; k0 += kKeys) {
    __syncthreads();  // previous tile fully consumed (and qs written)
    for (int i = threadIdx.x; i < kKeys * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const int s = k0 + j;
      const bool in = s < p.tk;
      ks[j][d] = in ? to_float(kp[s * p.k_st + d]) : 0.f;
      vs[j][d] = in ? to_float(vp[s * p.v_st + d]) : 0.f;
    }
    __syncthreads();
    if (!row_ok) continue;

    const int s = k0 + lane;
    bool valid = s < kv_limit;
    if (p.causal) valid = valid && s <= t;
    if (p.window > 0) valid = valid && s > t - p.window;
    float score = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) score = fmaf(qs[warp][d], ks[lane][d], score);
    score = valid ? score * p.scale : -INFINITY;

    const float m_new = fmaxf(m, warp_max(score));  // finite: m starts at -1e30
    const float alpha = expf(m - m_new);
    const float prob = valid ? expf(score - m_new) : 0.f;
    l = l * alpha + warp_sum(prob);
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] *= alpha;
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      const float pj = __shfl_sync(0xffffffffu, prob, j);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        if (d < D) acc[c] = fmaf(pj, vs[j][d], acc[c]);
      }
    }
    m = m_new;
  }

  if (!row_ok) return;
  const float denom = fmaxf(l, 1e-30f);
  T* out = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh + t * p.o_st;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int d = lane + 32 * c;
    if (d < D) store(out + d, acc[c] / denom);
  }
  if (p.lse != nullptr && lane == 0)
    p.lse[(static_cast<long long>(b) * p.heads + h) * p.tq + t] = m + logf(denom);
}

template <typename T, int D>
int launch(const FlashParams& p, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.tq) * (p.heads / p.kv_heads);
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows),
                  static_cast<unsigned>(p.kv_heads),
                  static_cast<unsigned>(p.batch));
  flash_attention_kernel<T, D><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(const FlashParams& p, cudaStream_t stream) {
  switch (p.head_dim) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_launch(const FlashParams* p, void* stream) {
  if (p->batch <= 0 || p->tq <= 0 || p->tk <= 0 || p->kv_heads <= 0 ||
      p->heads % p->kv_heads != 0 || p->batch > 65535 || p->kv_heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->dtype == 0) return launch_dtype<float>(*p, s);
  if (p->dtype == 1) return launch_dtype<__nv_bfloat16>(*p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

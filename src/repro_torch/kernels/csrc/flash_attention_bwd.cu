// Flash-attention backward from the saved LSE, CUDA C++ for Hopper (sm_90a):
// two kernels, dK/dV and dQ.
//
// Replaces: repro/kernels/flash_attention.py,
//   flash_attention_bwd_dkv_pallas (_flash_bwd_dkv_kernel), grid
//   (B, Hkv, kv blocks, G, q blocks) with dK/dV resident in VMEM while the
//   GQA group and the q blocks stream past, and
//   flash_attention_bwd_dq_pallas (_flash_bwd_dq_kernel), grid
//   (B, H, q blocks, kv blocks) with dQ resident while kv blocks stream.
//
// Both rebuild, per (query tile, key tile) pair,
//   P  = exp(S * scale - lse),  S = Q K^T, exactly 0 where the forward
//        masked (key s past Tk, s > t when causal, s <= t - window),
//   dP = dO V^T,  dS = P * (dP - delta) * scale,
// with delta = rowsum(dO * O) computed by the caller (as repro/kernels/
// ops.py does outside its kernels), then
//   dK/dV kernel: dV += P^T dO, dK += dS^T Q, summed over the G query heads
//                 of the kv head (the GQA group sum happens in the block);
//   dQ kernel:    dQ += dS K.
// Everything runs in fp32 from bf16 or fp32 operands; dq, dk and dv are
// written in fp32 (the wrapper casts them to the primal dtypes).
//
// Design: the TPU's sequential grid axes become loops inside one block.
//   dK/dV: one block per (b, kv head, 32-key tile); it loops over the G
//          heads of the group and, for each, over the 32-query tiles the
//          causal band and the window reach (tiles wholly outside are
//          never loaded).  K and V stay in shared memory for the whole
//          block; dK and dV accumulate in registers.
//   dQ:    one block per (b, head, 32-query tile), streaming the 32-key
//          tiles of the band; dQ accumulates in registers.
// 256 threads (8 warps).  Scores: warp w owns query rows 4w..4w+3 of the
// tile and lane j owns key j, so Q/dO reads are broadcasts and K/V reads
// (rows padded to D+1 words) are free of bank conflicts.  Accumulation:
// warp w owns rows 4w..4w+3 of the output tile and lane l owns columns
// l, l+32, ...  Shared memory is dynamic (74.8 KB for dK/dV at D = 128).
// Operands are addressed through their strides (innermost stride 1), so
// the model's (B, T, H, D) tensors are read in place; lse and delta are
// contiguous (B, H, Tq) fp32.
//
// Bound on this card: at the training shape (B = 12, H = 32, Hkv = 2,
// T = 128, D = 128, bf16) each kernel must move ~30 MB (q and dO dominate)
// and do 2.4 (dQ) to 3.2 (dK/dV) GFLOP over the causal band, so the bound
// is bytes, ~9 us.  These kernels do plain fp32 FMAs from shared memory
// (no wgmma, no TMA) and so run far from it.  At G = 16 a dK/dV block
// serialises the 16 heads of its group: 12 * 2 * 4 = 96 blocks, less than
// one wave on 132 SMs.  wgmma tiles, and splitting the group across blocks
// with a reduction, are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;                 // queries and keys per tile
constexpr int kRowsPerWarp = kTile / kWarps;  // 4

}  // namespace

// Mirrored field for field by a ctypes.Structure in flash_attention.py.
struct FlashBwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, Tq) contiguous
  const float* delta;  // (B, H, Tq) contiguous
  float* dq;           // (B, H, Tq, D) contiguous, or null
  float* dk;           // (B, Hkv, Tk, D) contiguous, or null
  float* dv;           // (B, Hkv, Tk, D) contiguous, or null
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long do_sb, do_sh, do_st;
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

__device__ __forceinline__ bool pair_valid(const FlashBwdParams& p, int t,
                                           int s) {
  bool ok = t < p.tq && s < p.tk;
  if (p.causal) ok = ok && s <= t;
  if (p.window > 0) ok = ok && s > t - p.window;
  return ok;
}

// 16 bytes of operand values -> fp32 (a bf16 value is the high half of
// its fp32 value, so the conversion is a shift)
__device__ __forceinline__ void store_vec(float* dst, const uint4& u,
                                          const float*) {
  dst[0] = __uint_as_float(u.x);
  dst[1] = __uint_as_float(u.y);
  dst[2] = __uint_as_float(u.z);
  dst[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void store_vec(float* dst, const uint4& u,
                                          const __nv_bfloat16*) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    dst[2 * k] = __uint_as_float(w[k] << 16);
    dst[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// rows [row0, row0 + kTile) of one (b, head) slice into a padded fp32
// tile; rows past `rows` read as 0.  Rows that start on 16-byte
// boundaries are read as 16-byte vectors, every load of the thread issued
// before its first store, so the loads overlap instead of waiting on
// each other; other layouts are read element by element.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          long long stride_t, int row0,
                                          int rows) {
  constexpr int kVec = 16 / sizeof(T);         // elements per vector
  constexpr int kRowVecs = D / kVec;           // D is a multiple of 8
  constexpr int kVecs = kTile * kRowVecs;
  constexpr int kPer = (kVecs + kThreads - 1) / kThreads;
  const bool aligned = reinterpret_cast<unsigned long long>(src) % 16 == 0 &&
                       (stride_t * static_cast<long long>(sizeof(T))) % 16 == 0;
  if (aligned) {
    uint4 buf[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int t = row0 + i / kRowVecs;
      buf[j] = (i < kVecs && t < rows)
                   ? *reinterpret_cast<const uint4*>(
                         src + t * stride_t + (i % kRowVecs) * kVec)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i < kVecs)
        store_vec(dst + (i / kRowVecs) * (D + 1) + (i % kRowVecs) * kVec,
                  buf[j], src);
    }
    return;
  }
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = row0 + r;
    dst[r * (D + 1) + d] = t < rows ? to_float(src[t * stride_t + d]) : 0.f;
  }
}

// The shared core of both kernels: for this thread's 4 query rows (warp)
// and key `lane`, rebuild P and dS of the (q0, k0) tile pair into
// ps/dss (ps may be null).
template <int D>
__device__ __forceinline__ void rebuild_p_ds(
    const FlashBwdParams& p, const float* qs, const float* dos,
    const float* ks, const float* vs, const float* lse_s,
    const float* delta_s, float* ps, float* dss, int q0, int k0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float s_acc[kRowsPerWarp], dp_acc[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) s_acc[r] = dp_acc[r] = 0.f;
  const float* krow = ks + lane * (D + 1);
  const float* vrow = vs + lane * (D + 1);
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float kd = krow[d], vd = vrow[d];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = warp * kRowsPerWarp + r;
      s_acc[r] = fmaf(qs[i * (D + 1) + d], kd, s_acc[r]);
      dp_acc[r] = fmaf(dos[i * (D + 1) + d], vd, dp_acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = warp * kRowsPerWarp + r;
    const float pv = pair_valid(p, q0 + i, k0 + lane)
                         ? expf(s_acc[r] * p.scale - lse_s[i])
                         : 0.f;
    if (ps != nullptr) ps[i * (kTile + 1) + lane] = pv;
    dss[i * (kTile + 1) + lane] = pv * (dp_acc[r] - delta_s[i]) * p.scale;
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         (4 * kTile * (D + 1) + 2 * kTile * (kTile + 1) + 2 * kTile);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * (kTile + 1) + 2 * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const FlashBwdParams p) {
  constexpr int kCols = (D + 31) / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * (D + 1);
  float* qs = vs + kTile * (D + 1);
  float* dos = qs + kTile * (D + 1);
  float* ps = dos + kTile * (D + 1);
  float* dss = ps + kTile * (kTile + 1);
  float* lse_s = dss + kTile * (kTile + 1);
  float* delta_s = lse_s + kTile;

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int group = p.heads / p.kv_heads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  load_tile<T, D>(ks, static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh,
                  p.k_st, k0, p.tk);
  load_tile<T, D>(vs, static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh,
                  p.v_st, k0, p.tk);

  // query tiles any key of this tile can meet
  const int q_begin = p.causal ? k0 : 0;
  const int q_end = p.window > 0 ? min(p.tq, k0 + kTile - 1 + p.window)
                                 : p.tq;

  float dk_acc[kRowsPerWarp][kCols], dv_acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dop = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const long long row_base = (static_cast<long long>(b) * p.heads + h) * p.tq;
    for (int q0 = (q_begin / kTile) * kTile; q0 < q_end; q0 += kTile) {
      __syncthreads();  // previous tile pair consumed (and ks/vs written)
      load_tile<T, D>(qs, qp, p.q_st, q0, p.tq);
      load_tile<T, D>(dos, dop, p.do_st, q0, p.tq);
      if (threadIdx.x < kTile) {
        const int t = q0 + threadIdx.x;
        lse_s[threadIdx.x] = t < p.tq ? p.lse[row_base + t] : 0.f;
        delta_s[threadIdx.x] = t < p.tq ? p.delta[row_base + t] : 0.f;
      }
      __syncthreads();
      rebuild_p_ds<D>(p, qs, dos, ks, vs, lse_s, delta_s, ps, dss, q0, k0);
      __syncthreads();
      // dV[j] += sum_i P[i][j] dO[i];  dK[j] += sum_i dS[i][j] Q[i]
#pragma unroll 4
      for (int i = 0; i < kTile; ++i) {
        float qv[kCols], dov[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = lane + 32 * c;
          qv[c] = d < D ? qs[i * (D + 1) + d] : 0.f;
          dov[c] = d < D ? dos[i * (D + 1) + d] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int j = warp * kRowsPerWarp + r;
          const float pij = ps[i * (kTile + 1) + j];
          const float dsij = dss[i * (kTile + 1) + j];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            dv_acc[r][c] = fmaf(pij, dov[c], dv_acc[r][c]);
            dk_acc[r][c] = fmaf(dsij, qv[c], dk_acc[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int s = k0 + warp * kRowsPerWarp + r;
    if (s >= p.tk) continue;
    const long long off =
        ((static_cast<long long>(b) * p.kv_heads + kvh) * p.tk + s) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        p.dk[off + d] = dk_acc[r][c];
        p.dv[off + d] = dv_acc[r][c];
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const FlashBwdParams p) {
  constexpr int kCols = (D + 31) / 32;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * (D + 1);
  float* ks = dos + kTile * (D + 1);
  float* vs = ks + kTile * (D + 1);
  float* dss = vs + kTile * (D + 1);
  float* lse_s = dss + kTile * (kTile + 1);
  float* delta_s = lse_s + kTile;

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int kvh = h / (p.heads / p.kv_heads);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row_base = (static_cast<long long>(b) * p.heads + h) * p.tq;

  load_tile<T, D>(qs, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh,
                  p.q_st, q0, p.tq);
  load_tile<T, D>(dos,
                  static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh,
                  p.do_st, q0, p.tq);
  if (threadIdx.x < kTile) {
    const int t = q0 + threadIdx.x;
    lse_s[threadIdx.x] = t < p.tq ? p.lse[row_base + t] : 0.f;
    delta_s[threadIdx.x] = t < p.tq ? p.delta[row_base + t] : 0.f;
  }
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // key tiles any query of this tile can see
  const int k_end = p.causal ? min(p.tk, q0 + kTile) : p.tk;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;

  float acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  for (int k0 = (k_begin / kTile) * kTile; k0 < k_end; k0 += kTile) {
    __syncthreads();  // previous tile consumed (and qs/dos/lse written)
    load_tile<T, D>(ks, kp, p.k_st, k0, p.tk);
    load_tile<T, D>(vs, vp, p.v_st, k0, p.tk);
    __syncthreads();
    rebuild_p_ds<D>(p, qs, dos, ks, vs, lse_s, delta_s, nullptr, dss, q0, k0);
    __syncthreads();
    // dQ[i] += sum_j dS[i][j] K[j]
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float kv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        kv[c] = d < D ? ks[j * (D + 1) + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float dsij = dss[(warp * kRowsPerWarp + r) * (kTile + 1) + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(dsij, kv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = q0 + warp * kRowsPerWarp + r;
    if (t >= p.tq) continue;
    float* out = p.dq + (row_base + t) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) out[d] = acc[r][c];
    }
  }
}

template <typename Kernel>
int launch_kernel(Kernel kernel, dim3 grid, size_t smem, const FlashBwdParams& p,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const FlashBwdParams& p, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((p.tk + kTile - 1) / kTile),
                  static_cast<unsigned>(p.kv_heads),
                  static_cast<unsigned>(p.batch));
  return launch_kernel(flash_bwd_dkv_kernel<T, D>, grid, dkv_smem_bytes<D>(),
                       p, stream);
}

template <typename T, int D>
int launch_dq(const FlashBwdParams& p, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((p.tq + kTile - 1) / kTile),
                  static_cast<unsigned>(p.heads),
                  static_cast<unsigned>(p.batch));
  return launch_kernel(flash_bwd_dq_kernel<T, D>, grid, dq_smem_bytes<D>(), p,
                       stream);
}

template <typename T, bool kDkv>
int launch_dim(const FlashBwdParams& p, cudaStream_t stream) {
  switch (p.head_dim) {
    case 16: return kDkv ? launch_dkv<T, 16>(p, stream) : launch_dq<T, 16>(p, stream);
    case 32: return kDkv ? launch_dkv<T, 32>(p, stream) : launch_dq<T, 32>(p, stream);
    case 64: return kDkv ? launch_dkv<T, 64>(p, stream) : launch_dq<T, 64>(p, stream);
    case 128: return kDkv ? launch_dkv<T, 128>(p, stream) : launch_dq<T, 128>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kDkv>
int launch_any(const FlashBwdParams* p, void* stream) {
  if (p->batch <= 0 || p->tq <= 0 || p->tk <= 0 || p->kv_heads <= 0 ||
      p->heads % p->kv_heads != 0 || p->batch > 65535 || p->heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kDkv ? (p->dk == nullptr || p->dv == nullptr) : p->dq == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->dtype == 0) return launch_dim<float, kDkv>(*p, s);
  if (p->dtype == 1) return launch_dim<__nv_bfloat16, kDkv>(*p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Each returns cudaGetLastError() after its launch (0 = launched).
extern "C" int flash_attention_bwd_dkv_launch(const FlashBwdParams* p,
                                              void* stream) {
  return launch_any<true>(p, stream);
}

extern "C" int flash_attention_bwd_dq_launch(const FlashBwdParams* p,
                                             void* stream) {
  return launch_any<false>(p, stream);
}

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
// is bytes, ~9 us (dK/dV) and ~16 us (dQ; ~23 us with O read and delta
// written when dQ forms delta).  The kernels above do plain fp32 FMAs from
// shared memory; they remain the row routes of dK/dV and dQ (fp32
// operands, head dims 16 and 32, rows not on 16 bytes).
//
// dQ tile route (flash_bwd_dq_tile_kernel): bf16 operands, D in {64, 128}.
// The row route took 0.21 ms at the train shape: one block per (b, head,
// 32-query tile), so the 16 heads of a group loaded the same K/V 16
// times, tiles converted to fp32 behind a barrier, scalar FMAs, and delta
// a separate torch pass with two fp32 copies of dO and O.  Here one
// warpgroup per (b, kv head, 64 flattened (t, g) query rows), as the
// forward's tile route: at G = 16 a block holds 4 positions x 16 heads,
// so every K/V tile serves the whole group (768 blocks at the train
// shape), heaviest row tiles first.  Q and dO are loaded once into
// wgmma's 128-byte-swizzled layout; 64-key K/V tiles of the band and the
// window stream through a two-stage cp.async ring (tiles outside are never
// loaded).  S = Q K^T and dP = dO V^T on wgmma m64n64k16 (S committed
// first, so P = exp(S scale - lse) is formed while dP runs); dS = P (dP -
// delta) scale in registers; dQ += dS K on m64n64k16 per 64 columns, dS
// from registers as bf16 high and low parts, K read with the transpose
// flag, each tile's product started from zero and added to the fp32 dQ
// outside the tensor cores (PR 14's lesson for the 2e-4 gate).  196
// registers at D = 128, no spills, 96 KB of shared memory: two blocks an
// SM.  Given the forward's output (o), the block forms delta =
// rowsum(dO * O) of its 64 rows in fp32 while the first tiles load, uses
// it, and writes it once for the dK/dV kernel, so the training backward
// runs no torch pass for it.  Each block owns its rows: no atomics, the
// same bits on every launch.  Measured on an NVIDIA H100 80GB HBM3 at
// 700 W (PERF.md section 6): 0.043 ms at the train shape with delta fused
// (row route 0.21; SDPA's whole backward 0.108), 0.18 ms at T = 2048
// (SDPA's backward 0.30); bound by bytes at T = 128 (19 us), by
// operations at T = 2048 (3 band products, 52 us), where one warpgroup
// runs the products and the softmax in turn and the block of the last
// row tile walks all 32 key tiles: overlapping them is the next design.
//
// dK/dV tile route (flash_bwd_dkv_tile_kernel): bf16 operands, D in
// {64, 128}.  One block per (b, kv head, 64-key tile, slice of the GQA
// group); the slices of one key tile form a thread block cluster of cs
// blocks, cs the largest divisor of G up to 8 (G = 16: 8 slices of 2
// heads; 12 x 2 x 2 x 8 = 384 blocks at the train shape against 96 for
// the row route).  K and V are loaded once per block; the slice's query
// rows, flattened (t, g) over its heads, stream past in 64-row tiles of Q
// and dO (with their LSE and delta) through a 2-stage cp.async ring, in
// wgmma's 128-byte-swizzled layout.  Two warpgroups split each tile's
// work by role: warpgroup 0 runs S^T = K Q^T on wgmma (m64n64k16, both
// operands from shared memory), rebuilds P = exp(S scale - lse), 0
// wherever the forward masked, and hands P over in shared memory;
// warpgroup 1 runs dP^T = V dO^T and forms dS = P (dP - delta) scale;
// then at once dV += P^T dO (warpgroup 0) and dK += dS^T Q (warpgroup 1)
// (m64nDk16, A from registers, dO and Q read with the transpose flag).
// P and dS enter those products split into a bf16 high part and a bf16
// low part (two products each), so what reaches the tensor cores carries
// 16 bits of each fp32 value, a residual of ~2^-17 of it; each tile's
// product starts from zero and is added to the running fp32 dV or dK in
// registers, since the tensor cores' own accumulation rounds toward zero
// and that bias would grow with the band.  The fp32 outputs stay within
// the 2e-4 gate of the plain fp32 version up to T = 2048 at least.  The
// group sum then runs through distributed shared memory: each block
// writes its partial dK and dV, and cluster rank r sums rows
// r * 64 / cs .. of all cs partials in rank order and writes them once:
// no atomics, the same bits on every launch.
// Bound: bytes at T = 128 (~9 us); at T = 2048 operations (4 band
// products, 69 us at 989 TF/s; the split makes them 6).  Measured on an
// H100 (PERF.md section 6): 0.061 ms at the train shape (the row
// route took 0.50), 0.43 ms at T = 2048, where the block of the first
// key tile walks all 4096 query rows of its slice while the tensor cores
// idle through the softmax, the splits and the barriers between them.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <math.h>

#include "hopper_mma.cuh"

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
  // the dQ tile route's fused delta: given o (the forward's output, q's
  // layout), it forms delta = rowsum(dO * O) itself, uses it, and writes
  // it to delta_out ((B, H, Tq) fp32 contiguous); o null: reads delta
  const void* o;
  long long o_sb, o_sh, o_st;
  float* delta_out;
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
    case 256: return kDkv ? launch_dkv<T, 256>(p, stream) : launch_dq<T, 256>(p, stream);
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

// ---------------------------------------------------------------------------
// dK/dV tile route: wgmma, bf16, D in {64, 128}, the group over a cluster
// ---------------------------------------------------------------------------

constexpr int kTKeys = 64;     // keys per block
constexpr int kTRows = 64;     // query rows per tile
constexpr int kTStages = 2;    // Q/dO ring depth
constexpr float kLog2e = 1.4426950408889634f;

// output columns of one tile-route backward block: all D up to 128; at
// D = 256, 128, so the 64 x 256 fp32 sum a warpgroup would hold (128
// registers a thread, and as many for the tile's product) is split across
// two blocks, each of which forms S, P, dP and dS over the full D
__host__ __device__ constexpr int dcols(int d) { return d > 128 ? 128 : d; }

// shared memory of a dK/dV tile block: K, V, then the ring's Q and dO
// tiles (every tile on a 1024-byte boundary, as the swizzle needs), the
// ring's LSE and delta rows, and P on its way from one warpgroup to the
// other; the partials of the group sum reuse it
template <int D>
struct DkvTile {
  static constexpr size_t kOperand = 64 * D * sizeof(__nv_bfloat16);
  static constexpr size_t kRows = 2 * kTRows * sizeof(float);  // lse, delta
  static constexpr size_t kP = kTKeys * kTRows * sizeof(float);
  static constexpr size_t kLoop = (2 + 2 * kTStages) * kOperand +
                                  kTStages * kRows + kP;
  static constexpr int kPartStride = dcols(D) + 8;  // floats; no conflicts
  static constexpr size_t kParts = 2 * kTKeys * kPartStride * sizeof(float);
  static constexpr size_t kSmem = kLoop > kParts ? kLoop : kParts;
};

// cp.async of one 64 x D bf16 tile into the swizzled layout of
// hopper_mma.cuh by the block's kThreads threads; `row_ptr(r)` is row r's
// first element, or null for a row of zeros (nothing is read; `any` is
// only a well-formed address)
template <int D, int kThreads, typename RowPtr>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* any,
                                                RowPtr row_ptr) {
  constexpr int kChunks = 64 * D / 8;
#pragma unroll
  for (int j = 0; j < kChunks / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / (D / 8), c = i % (D / 8);
    const __nv_bfloat16* src = row_ptr(r);
    hopper::cp_async16(
        reinterpret_cast<char*>(dst) + hopper::chunk_offset<64>(r, c),
        src != nullptr ? src + c * 8 : any, src != nullptr);
  }
}

// a 64 x N fp32 accumulator's A operand for depth step kk, split into
// bf16 high parts and bf16 low parts (value - high)
template <int R>
__device__ __forceinline__ void split_frag(uint32_t (&hi)[4],
                                           uint32_t (&lo)[4],
                                           const float (&d)[R], int kk) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float x0 = d[8 * kk + 2 * e], x1 = d[8 * kk + 2 * e + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    hi[e] = *reinterpret_cast<const uint32_t*>(&h);
    lo[e] = hopper::pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
  }
}

// Two warpgroups with two roles, per query tile:
//   warpgroup 0: S^T = K Q^T, P = exp(S scale - lse) (masked), P to shared
//                memory, then dV += P^T dO;
//   warpgroup 1: dP^T = V dO^T, then, with P, dS = P (dP - delta) scale
//                and dK += dS^T Q;
// so the two products of each pair run at once on the tensor cores, and
// no score is computed twice.  Each keeps its 64 x D fp32 sum in registers.
template <int D>
__global__ void __launch_bounds__(2 * hopper::kWarpgroup)
flash_bwd_dkv_tile_kernel(const FlashBwdParams p) {
  using namespace hopper;
  using bf16 = __nv_bfloat16;
  namespace cg = cooperative_groups;
  using Smem = DkvTile<D>;
  constexpr int kThreads = 2 * kWarpgroup;
  constexpr int DC = dcols(D);   // this block's columns of dK and dV
  constexpr int kO = DC / 2;     // dV or dK accumulator registers per thread
  extern __shared__ __align__(1024) unsigned char dkv_smem[];
  bf16* ks = reinterpret_cast<bf16*>(dkv_smem);
  bf16* vs = ks + 64 * D;
  auto stage_q = [&](int st) { return vs + (1 + st) * 64 * D; };
  auto stage_do = [&](int st) { return vs + (1 + kTStages + st) * 64 * D; };
  float* rows_s = reinterpret_cast<float*>(vs + (1 + 2 * kTStages) * 64 * D);
  auto stage_lse = [&](int st) {   // lse [0, 64), delta [64, 128)
    return rows_s + st * 2 * kTRows;
  };
  float* p_x = rows_s + kTStages * 2 * kTRows;   // P: element e of thread
                                                 // t at e * 128 + t

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.z, kvh = blockIdx.y;
  // clusters along x: (key tile, column slice); blocks of one cluster are
  // the slices of the GQA group
  const int cluster_id = static_cast<int>(blockIdx.x) / cs;
  const int k0 = cluster_id / (D / DC) * kTKeys;
  const int col0 = cluster_id % (D / DC) * DC;   // first dK/dV column
  const int group = p.heads / p.kv_heads, gs = group / cs;
  const int h0 = kvh * group + rank * gs;   // this slice's first head
  const int wg = threadIdx.x / kWarpgroup;  // 0: P and dV; 1: dS and dK
  const int tid = threadIdx.x % kWarpgroup;
  const int warp = tid >> 5, lane = threadIdx.x & 31;

  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb;
  const bf16* dop = static_cast<const bf16*>(p.dout) + b * p.do_sb;

  // the slice's query rows that can meet a key of this tile: positions
  // [q_begin, q_end) x its gs heads, flattened position-major
  const int q_begin = p.causal ? k0 : 0;
  const int q_end = p.window > 0 ? min(p.tq, k0 + kTKeys - 1 + p.window)
                                 : p.tq;
  const int n_rows = max(0, q_end - q_begin) * gs;
  const int n_tiles = (n_rows + kTRows - 1) / kTRows;

  load_tile_async<D, kThreads>(ks, kp, [&](int r) -> const bf16* {
    return k0 + r < p.tk ? kp + (k0 + r) * p.k_st : nullptr;
  });
  load_tile_async<D, kThreads>(vs, vp, [&](int r) -> const bf16* {
    return k0 + r < p.tk ? vp + (k0 + r) * p.v_st : nullptr;
  });
  auto load_rows = [&](int tile) {
    const int st = tile % kTStages;
    auto row = [&](int r, int& t, int& h) {
      const int R = tile * kTRows + r;
      t = q_begin + R / gs;
      h = h0 + R % gs;
      return R < n_rows;
    };
    load_tile_async<D, kThreads>(stage_q(st), qp, [&](int r) -> const bf16* {
      int t, h;
      return row(r, t, h) ? qp + h * p.q_sh + t * p.q_st : nullptr;
    });
    load_tile_async<D, kThreads>(stage_do(st), dop,
                                 [&](int r) -> const bf16* {
      int t, h;
      return row(r, t, h) ? dop + h * p.do_sh + t * p.do_st : nullptr;
    });
    // threads 0-63: lse of row r; 64-127: delta of row r - 64
    if (threadIdx.x < 2 * kTRows) {
      const int r = threadIdx.x & (kTRows - 1);
      int t, h;
      const bool ok = row(r, t, h);
      const float* src = threadIdx.x < kTRows ? p.lse : p.delta;
      cp_async4(stage_lse(st) + threadIdx.x,
                ok ? src + (static_cast<long long>(b) * p.heads + h) * p.tq + t
                   : src,
                ok);
    }
  };
  if (n_tiles > 0) load_rows(0);
  cp_async_commit();
  if (n_tiles > 1) load_rows(1);
  cp_async_commit();

  const float sl2 = p.scale * kLog2e;
  // this thread's accumulator rows are keys k0 + 16 warp + lane / 4 + 8 i,
  // and see query positions t_first[i] <= t < t_end[i] (none past Tk)
  int t_first[2], t_end[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + 16 * warp + lane / 4 + 8 * i;
    t_first[i] = p.causal ? key : 0;
    t_end[i] = key >= p.tk ? 0 : p.window > 0 ? key + p.window : p.tq;
  }
  const unsigned long long inv_gs = (1ull << 32) / gs + 1;
  // the running dV (warpgroup 0) or dK (warpgroup 1): fp32 adds of each
  // tile's products, since the tensor cores' own accumulation rounds
  // toward zero, a bias that would grow with the number of tiles
  float acc[kO], part[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) acc[i] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile % kTStages;
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qs = stage_q(st);
    const bf16* dos = stage_do(st);
    const float* lse_s = stage_lse(st);

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1), 64 keys x
    // 64 query rows
    float x[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.f;
    fence_regs(x);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<0>(x, desc_kmajor<64>(wg == 0 ? ks : vs, 0, kk),
                desc_kmajor<64>(wg == 0 ? qs : dos, 0, kk), kk > 0,
                Int<64>());
    wg_commit();
    wg_wait<0>();
    fence_regs(x);

    if (wg == 0) {
      // P in fp32, masked only on tiles that cross an edge, where the
      // query row of column col is position q_begin + (r0 + col) / gs (a
      // multiply by floor(2^32 / gs) + 1 and a shift: exact below
      // 2^32 / gs)
      const int r0 = tile * kTRows;
      const int t_min = q_begin + r0 / gs;
      const int t_max = q_begin + (r0 + kTRows - 1) / gs;
      const bool edge = r0 + kTRows > n_rows || k0 + kTKeys > p.tk ||
                        (p.causal && k0 + kTKeys - 1 > t_min) ||
                        (p.window > 0 && t_max - p.window >= k0);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + 2 * (lane & 3) + c;
          const float lse2 = lse_s[col] * kLog2e;
          const int t = q_begin + static_cast<int>(
              (static_cast<unsigned long long>(r0 + col) * inv_gs) >> 32);
          const bool row_ok = r0 + col < n_rows;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * j + 2 * i + c;
            float pr = exp2_ftz(fmaf(x[e], sl2, -lse2));
            if (edge && !(row_ok && t >= t_first[i] && t < t_end[i]))
              pr = 0.f;
            x[e] = pr;
            p_x[e * kWarpgroup + tid] = pr;
          }
        }
      asm volatile("bar.arrive 1, %0;\n" ::"n"(kThreads) : "memory");
    } else {
      // dS = P (dP - delta) scale, P from warpgroup 0
      asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
      const float* delta_s = lse_s + kTRows;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float dlt = delta_s[8 * j + 2 * (lane & 3) + c];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * j + 2 * i + c;
            x[e] = p_x[e * kWarpgroup + tid] * (x[e] - dlt) * p.scale;
          }
        }
    }

    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1), the
    // factor from registers split into bf16 high and low parts
    {
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) split_frag(hi[kk], lo[kk], x, kk);
      const bf16* bt = wg == 0 ? dos : qs;
      fence_regs(part);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bd = desc_mn<64>(bt, col0, kk);
        mma_rs<1>(part, hi[kk], bd, kk > 0, Int<DC>());
        mma_rs<1>(part, lo[kk], bd, 1, Int<DC>());
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < kO; ++i) acc[i] += part[i];
    }

    __syncthreads();   // every warp is done with stage st and with P
    if (tile + kTStages < n_tiles) load_rows(tile + kTStages);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();     // the partials below reuse the ring's memory

  // the group sum over the cluster: partials to shared memory, then rank r
  // sums its rows of every block's partial in rank order
  constexpr int kStride = Smem::kPartStride;
  float* dk_part = reinterpret_cast<float*>(dkv_smem);
  float* dv_part = dk_part + kTKeys * kStride;
  float* mine = wg == 0 ? dv_part : dk_part;
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(
          mine + (16 * warp + lane / 4 + 8 * i) * kStride + 8 * j +
          2 * (lane & 3)) = make_float2(acc[4 * j + 2 * i],
                                        acc[4 * j + 2 * i + 1]);
  cluster.sync();
  const int per = (kTKeys + cs - 1) / cs;
  const int row_lo = rank * per, row_hi = min(kTKeys, row_lo + per);
  const long long out0 =
      ((static_cast<long long>(b) * p.kv_heads + kvh) * p.tk + k0) * D + col0;
  for (int idx = threadIdx.x; idx < (row_hi - row_lo) * (DC / 4);
       idx += kThreads) {
    const int row = row_lo + idx / (DC / 4), c4 = idx % (DC / 4);
    if (k0 + row >= p.tk) continue;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int rr = 0; rr < cs; ++rr) {
      const float4 xk = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(dk_part, rr) + row * kStride + 4 * c4);
      const float4 xv = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(dv_part, rr) + row * kStride + 4 * c4);
      sk.x += xk.x; sk.y += xk.y; sk.z += xk.z; sk.w += xk.w;
      sv.x += xv.x; sv.y += xv.y; sv.z += xv.z; sv.w += xv.w;
    }
    *reinterpret_cast<float4*>(p.dk + out0 + row * D + 4 * c4) = sk;
    *reinterpret_cast<float4*>(p.dv + out0 + row * D + 4 * c4) = sv;
  }
  cluster.sync();      // no block leaves while another reads its partials
}

template <int D>
int launch_dkv_tile(const FlashBwdParams& p, cudaStream_t stream) {
  const int group = p.heads / p.kv_heads;
  int cs = 1;   // the largest divisor of G up to 8
  for (int c = min(group, 8); c > 1; --c)
    if (group % c == 0) {
      cs = c;
      break;
    }
  constexpr size_t smem = DkvTile<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tile_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((p.tk + kTKeys - 1) / kTKeys *
                                           (D / dcols(D)) * cs),
                     static_cast<unsigned>(p.kv_heads),
                     static_cast<unsigned>(p.batch));
  cfg.blockDim = dim3(2 * hopper::kWarpgroup);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_bwd_dkv_tile_kernel<D>, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// dQ tile route: wgmma, bf16, D in {64, 128}, delta fused
// ---------------------------------------------------------------------------

// shared memory of a dQ tile block: the Q and dO tiles of its 64 rows, then
// a two-stage ring of (K, V) tile pairs, every tile on a 1024-byte
// boundary, and the block's 64 delta values: 96.25 KB at D = 128, so two
// blocks fit on an SM
template <int D>
constexpr size_t dq_tile_smem_bytes() {
  return 6 * 64 * D * sizeof(__nv_bfloat16) + 64 * sizeof(float);
}
// (192.25 KB at D = 256: one block an SM)

// One block (one warpgroup): 64 flattened (t, g) query rows of one (b, kv
// head), as the forward's tile route; at G = 16, 4 positions x 16 heads,
// so every K/V tile serves the whole GQA group.  Row tiles are launched
// heaviest (latest positions) first.  Per 64-key tile of the band:
// S = Q K^T and dP = dO V^T on wgmma (both operands from shared memory, S
// committed first, so P is formed while dP runs), P = exp(S scale - lse)
// (0 where the forward masked), dS = P (dP - delta) scale, then
// dQ += dS K with dS from registers, split into bf16 high and low parts,
// K read with the transpose flag, in two 64-column halves at D = 128 (each
// tile's product starts from zero and is added to the fp32 dQ outside the
// tensor cores, whose own accumulation rounds toward zero).
template <int D>
__global__ void __launch_bounds__(hopper::kWarpgroup, 2)
flash_bwd_dq_tile_kernel(const FlashBwdParams p) {
  using namespace hopper;
  using bf16 = __nv_bfloat16;
  constexpr int DC = dcols(D);   // this block's columns of dQ
  constexpr int kO = DC / 2;     // dQ accumulator registers per thread
  extern __shared__ __align__(1024) unsigned char dq_smem[];
  bf16* qs = reinterpret_cast<bf16*>(dq_smem);
  bf16* dos = qs + 64 * D;
  auto stage_k = [&](int st) { return dos + (1 + 2 * st) * 64 * D; };
  auto stage_v = [&](int st) { return dos + (2 + 2 * st) * 64 * D; };
  float* delta_s = reinterpret_cast<float*>(dos + 5 * 64 * D);  // 64 rows

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int group = p.heads / p.kv_heads;
  const int rows = p.tq * group;   // the launcher keeps this below 2^31
  // x: (row tile, column slice), heaviest row tiles first
  constexpr int kSlices = D / DC;
  const int row0 =
      static_cast<int>((gridDim.x - 1 - blockIdx.x) / kSlices) * kTRows;
  const int col0 = static_cast<int>(blockIdx.x % kSlices) * DC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb;
  const bf16* dop = static_cast<const bf16*>(p.dout) + b * p.do_sb;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // keys any row of this block can see
  const int t_lo = row0 / group;
  const int t_hi = min(rows - 1, row0 + kTRows - 1) / group;
  const int k_end = p.causal ? min(p.tk, t_hi + 1) : p.tk;
  const int k_begin =
      (p.window > 0 ? max(0, t_lo - p.window + 1) : 0) / kTKeys * kTKeys;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kTKeys - 1) / kTKeys : 0;

  // Q and dO once, with K0 and V0 (one cp.async group), then K1 and V1
  auto row_of = [&](const bf16* base, long long sh, long long st,
                    int r) -> const bf16* {
    const int row = row0 + r;
    if (row >= rows) return nullptr;
    return base + (kvh * group + row % group) * sh + (row / group) * st;
  };
  load_tile_async<D, kWarpgroup>(qs, qp, [&](int r) {
    return row_of(qp, p.q_sh, p.q_st, r);
  });
  load_tile_async<D, kWarpgroup>(dos, dop, [&](int r) {
    return row_of(dop, p.do_sh, p.do_st, r);
  });
  auto load_kv = [&](int tile) {
    const int st = tile & 1, n0 = k_begin + tile * kTKeys;
    load_tile_async<D, kWarpgroup>(stage_k(st), kp, [&](int r) -> const bf16* {
      return n0 + r < p.tk ? kp + (n0 + r) * p.k_st : nullptr;
    });
    load_tile_async<D, kWarpgroup>(stage_v(st), vp, [&](int r) -> const bf16* {
      return n0 + r < p.tk ? vp + (n0 + r) * p.v_st : nullptr;
    });
  };
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();
  if (n_tiles > 1) load_kv(1);
  cp_async_commit();

  // this thread's two accumulator rows 16 warp + lane / 4 + 8 i: their
  // query position, lse (log2 units) and delta.  Fused: the block forms
  // delta = rowsum(dO * O) of its 64 rows in fp32 while the copies run
  // and writes it once.
  int t_row[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 16 * warp + lane / 4 + 8 * i;
    t_row[i] = row < rows ? row / group : p.tq;
    lse2[i] = row < rows
                  ? p.lse[(static_cast<long long>(b) * p.heads + kvh * group +
                           row % group) * p.tq + row / group] * kLog2e
                  : 0.f;
    dlt[i] = 0.f;
  }
  if (p.o != nullptr) {
    // thread i reads 16-byte chunk i % (D / 8) of rows i / (D / 8) +
    // 1024 j / D of dO and O, every load issued before the first product;
    // the D / 8 threads of a row sum by shuffles, and the rows meet the
    // accumulator layout in shared memory
    constexpr int kRowChunks = D / 8, kRowsPer = kWarpgroup / kRowChunks;
    constexpr int kJ = 64 / kRowsPer;
    const bf16* op = static_cast<const bf16*>(p.o) + b * p.o_sb;
    uint4 dv[kJ], ov[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int row = row0 + threadIdx.x / kRowChunks + kRowsPer * j;
      const int c = threadIdx.x % kRowChunks;
      dv[j] = ov[j] = make_uint4(0u, 0u, 0u, 0u);
      if (row < rows) {
        const int h = kvh * group + row % group, t = row / group;
        dv[j] = *reinterpret_cast<const uint4*>(dop + h * p.do_sh +
                                                t * p.do_st + 8 * c);
        ov[j] = *reinterpret_cast<const uint4*>(op + h * p.o_sh +
                                                t * p.o_st + 8 * c);
      }
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const uint32_t* dw = reinterpret_cast<const uint32_t*>(&dv[j]);
      const uint32_t* ow = reinterpret_cast<const uint32_t*>(&ov[j]);
      float x = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x = fmaf(__uint_as_float(dw[e] << 16), __uint_as_float(ow[e] << 16),
                 x);
        x = fmaf(__uint_as_float(dw[e] & 0xffff0000u),
                 __uint_as_float(ow[e] & 0xffff0000u), x);
      }
#pragma unroll
      for (int off = kRowChunks / 2; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
      const int r = threadIdx.x / kRowChunks + kRowsPer * j;
      if (threadIdx.x % kRowChunks == 0) delta_s[r] = x;
    }
    __syncthreads();
    if (col0 == 0 && threadIdx.x < 64 && row0 + threadIdx.x < rows) {
      const int row = row0 + threadIdx.x;
      p.delta_out[(static_cast<long long>(b) * p.heads + kvh * group +
                   row % group) * p.tq + row / group] = delta_s[threadIdx.x];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) dlt[i] = delta_s[16 * warp + lane / 4 + 8 * i];
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 16 * warp + lane / 4 + 8 * i;
      if (row < rows)
        dlt[i] = p.delta[(static_cast<long long>(b) * p.heads + kvh * group +
                          row % group) * p.tq + row / group];
    }
  }

  const float sl2 = p.scale * kLog2e;
  float acc[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) acc[i] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile & 1, n0 = k_begin + tile * kTKeys;
    cp_async_wait<1>();   // K(tile), V(tile) (and Q, dO) are in
    __syncthreads();
    const bf16* ks = stage_k(st);
    const bf16* vs = stage_v(st);

    // S = Q K^T, then dP = dO V^T (64 rows x 64 keys), two groups
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<0>(s, desc_kmajor<64>(qs, 0, kk), desc_kmajor<64>(ks, 0, kk),
                kk > 0, Int<64>());
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<0>(dp, desc_kmajor<64>(dos, 0, kk), desc_kmajor<64>(vs, 0, kk),
                kk > 0, Int<64>());
    wg_commit();
    wg_wait<1>();
    fence_regs(s);

    // P, masked only on tiles on an edge: Tk, the causal diagonal, the
    // window's far side (column 8 j + c of this thread is key
    // n0 + 8 j + 2 (lane % 4) + c)
    const bool edge = n0 + kTKeys > p.tk ||
                      (p.causal && n0 + kTKeys - 1 > t_lo) ||
                      (p.window > 0 && n0 <= t_hi - p.window);
    int lo[2], hi[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int base = n0 + 2 * (lane & 3);
      hi[i] = (p.causal ? min(p.tk - 1, t_row[i]) : p.tk - 1) - base;
      lo[i] = p.window > 0 ? t_row[i] - p.window + 1 - base : -kTKeys;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          float pr = exp2_ftz(fmaf(s[e], sl2, -lse2[i]));
          if (edge && (8 * j + c > hi[i] || 8 * j + c < lo[i])) pr = 0.f;
          s[e] = pr;
        }
    wg_wait<0>();
    fence_regs(dp);
    // dS = P (dP - delta) scale, into S's registers
#pragma unroll
    for (int e = 0; e < 32; ++e)
      s[e] = s[e] * (dp[e] - dlt[(e >> 1) & 1]) * p.scale;

    // dQ += dS K: dS from registers as bf16 high and low parts, K (keys x
    // D) read transposed, 64 columns of dQ at a time
    uint32_t fh[4][4], fl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) split_frag(fh[kk], fl[kk], s, kk);
#pragma unroll
    for (int half = 0; half < DC / 64; ++half) {
      float part[32];
      fence_regs(part);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bd = desc_mn<64>(ks, col0 + 64 * half, kk);
        mma_rs<1>(part, fh[kk], bd, kk > 0, Int<64>());
        mma_rs<1>(part, fl[kk], bd, 1, Int<64>());
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[32 * half + e] += part[e];
    }

    __syncthreads();   // every warp is done with stage st
    if (tile + 2 < n_tiles) load_kv(tile + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // dq rows (fp32, contiguous (B, H, Tq, D)): 8-byte stores, four lanes
  // per 32 contiguous bytes
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 16 * warp + lane / 4 + 8 * i;
    if (row >= rows) continue;
    float* out = p.dq + ((static_cast<long long>(b) * p.heads + kvh * group +
                          row % group) * p.tq + row / group) * D + col0;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j)
      *reinterpret_cast<float2*>(out + 8 * j + 2 * (lane & 3)) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

template <int D>
int launch_dq_tile(const FlashBwdParams& p, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.tq) * (p.heads / p.kv_heads);
  const dim3 grid(static_cast<unsigned>((rows + kTRows - 1) / kTRows *
                                       (D / dcols(D))),
                  static_cast<unsigned>(p.kv_heads),
                  static_cast<unsigned>(p.batch));
  constexpr size_t smem = dq_tile_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tile_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_tile_kernel<D><<<grid, hopper::kWarpgroup, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
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

// The dQ tile route: bf16 operands, head_dim 64, 128 or 256, 16-byte
// aligned rows; with o set, delta is formed in the kernel and written to delta_out.
extern "C" int flash_attention_bwd_dq_tile_launch(const FlashBwdParams* p,
                                                  void* stream) {
  if (p->batch <= 0 || p->tq <= 0 || p->tk <= 0 || p->kv_heads <= 0 ||
      p->heads % p->kv_heads != 0 || p->batch > 65535 ||
      p->kv_heads > 65535 || p->dtype != 1 || p->dq == nullptr ||
      (p->o != nullptr ? p->delta_out == nullptr : p->delta == nullptr) ||
      static_cast<long long>(p->tq) * p->heads >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->head_dim) {
    case 64: return launch_dq_tile<64>(*p, s);
    case 128: return launch_dq_tile<128>(*p, s);
    case 256: return launch_dq_tile<256>(*p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dK/dV tile route: bf16 operands, head_dim 64, 128 or 256, 16-byte
// aligned rows.
extern "C" int flash_attention_bwd_dkv_tile_launch(const FlashBwdParams* p,
                                                   void* stream) {
  if (p->batch <= 0 || p->tq <= 0 || p->tk <= 0 || p->kv_heads <= 0 ||
      p->heads % p->kv_heads != 0 || p->batch > 65535 ||
      p->kv_heads > 65535 || p->dtype != 1 || p->dk == nullptr ||
      p->dv == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->head_dim) {
    case 64: return launch_dkv_tile<64>(*p, s);
    case 128: return launch_dkv_tile<128>(*p, s);
    case 256: return launch_dkv_tile<256>(*p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

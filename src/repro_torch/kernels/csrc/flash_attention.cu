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
// Row route design: the TPU's sequential kv-block grid axis becomes a loop
// inside the block. A block owns 4 query rows of one (batch, kv head); the
// rows are taken from the flattened (t, g) index over the GQA group, so a
// decode step (Tq = 1) puts 4 heads of one group in a block and every block
// shares its K/V tiles among them. Each warp owns one row: lane j scores
// key j of the 32-key tile staged in shared memory (fp32, K rows padded by
// one word against bank conflicts), the warp reduces max and sum by
// shuffles, and each lane accumulates D/32 output columns. Tiles wholly
// outside the causal band, the window or kv_len are never loaded. Masked
// keys get probability exactly 0, and a row that has seen no key keeps m =
// -1e30, so a fully masked row writes 0 (as the TPU kernel does).
// Operands are addressed through their strides (innermost stride 1), so
// the model's (B, T, H, D) tensors and the KV cache are read in place.
//
// Two routes, both counterparts of flash_attention_pallas; the wrapper
// picks one by a fixed rule (kernels/flash_attention.py, attention_route):
//
// Row route (flash_attention_kernel): fp32 operands, head dims 16 and 32,
// and blocks too small to fill a 64-row tile (decode: Tq * G < 64).  The
// design above.  Bound: bytes.  Decode reads the whole KV cache once per
// step and does 4*D flops per cached key and head; plain FMAs from shared
// memory take ~0.04 ms at (8,32,1,128)/(8,2,161,128), where SDPA takes
// ~0.02 on the card's clock (PERF.md section 6): splitting a row's keys
// across blocks to fill the 132 SMs is the next design.
//
// Tile route (flash_attention_tile_kernel): bf16 operands, D in {64, 128},
// Tq * G >= 64.  One warpgroup (128 threads) owns 64 flattened (t, g) rows
// of one (batch, kv head) -- at G = 16, 4 positions x 16 heads, so every
// K/V tile serves the whole GQA group and the causal band per tile stays
// narrow; 12 x 2 x 32 = 768 blocks at the train shape.  64-key tiles of K
// and V stream through a two-stage cp.async ring (16-byte copies, keys
// past Tk or kv_len zero-filled) in wgmma's 128-byte-swizzled layout
// (hopper_mma.cuh): the next K tile loads while this tile's softmax and
// P V run, the next V tile while the next S runs.  S = Q K^T on wgmma
// (m64n64k16, Q and K from shared memory, fp32 accumulators); the online
// softmax in registers (one FMNMX and one FFMA + ex2 per score, log2(e)
// folded into the scale); P rounded once to bf16 and fed from registers
// as wgmma's A operand for O += P V (m64nDk16, V read with the transpose
// flag).  The LSE comes from the fp32 scores of the same bf16 values.
// Only tiles on the causal diagonal, the window's edge or the Tk / kv_len
// edge are masked; tiles wholly outside are never loaded.  The output
// leaves through shared memory in 16-byte stores.  48 KB of shared memory
// and ~160 registers a thread put three blocks on an SM, so one block's
// loads and softmax overlap another's products.  Row tiles are launched
// heaviest (latest positions) first.
// Bound: bytes at the train shape ((12,32,128,128)/(12,2,128,128):
// 26.7 MB, 8.0 us at 3.35 TB/s, against 1.6 GFLOP over the causal band,
// 1.6 us at 989 TF/s); operations from T ~ 1k up (T = 2048, B = 1:
// 34 GFLOP, 35 us).  Measured on an H100 (PERF.md section 6):
// 0.026 ms at the train shape (the row route took 0.389; SDPA 0.021),
// 0.139 ms at T = 2048 (SDPA 0.087): one warpgroup runs S, the softmax
// and P V in turn, so its tensor-core work idles through the softmax; a
// later design ping-pongs two warpgroups.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "hopper_mma.cuh"

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

// ---------------------------------------------------------------------------
// tile route: wgmma, bf16, D in {64, 128}
// ---------------------------------------------------------------------------

constexpr int kTileRows = 64;   // flattened (t, g) rows per block
constexpr int kTileKeys = 64;   // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

// shared memory: the block's Q tile, then a two-stage ring of 64-key
// tiles that holds one K and one V tile (K of the next key tile loads
// while this tile's softmax and P V run, V of the next while its S runs);
// every tile on a 1024-byte boundary, as the swizzle needs.  48 KB at
// D = 128: three blocks fit on an SM.
template <int D>
constexpr size_t tile_smem_bytes() {
  return sizeof(__nv_bfloat16) * 3 * kTileRows * D;
}

// cp.async of one 64 x D bf16 tile into the swizzled layout of
// hopper_mma.cuh: chunk i of the tile is row i / (D / 8), 16-byte column
// i % (D / 8); `row_ptr(r)` is row r's first element, or null for a row of
// zeros (the copy then reads nothing; `any` is only its well-formed
// address)
template <int D, typename RowPtr>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* any,
                                                RowPtr row_ptr) {
  constexpr int kChunks = 64 * D / 8;
#pragma unroll
  for (int j = 0; j < kChunks / hopper::kWarpgroup; ++j) {
    const int i = threadIdx.x + j * hopper::kWarpgroup;
    const int r = i / (D / 8), c = i % (D / 8);
    const __nv_bfloat16* src = row_ptr(r);
    hopper::cp_async16(
        reinterpret_cast<char*>(dst) + hopper::chunk_offset<64>(r, c),
        src != nullptr ? src + c * 8 : any, src != nullptr);
  }
}

// One block (one warpgroup): 64 flattened (t, g) rows of one (batch, kv
// head).  Row tiles are launched heaviest (latest positions) first.
template <int D>
__global__ void __launch_bounds__(hopper::kWarpgroup, 3)
flash_attention_tile_kernel(const FlashParams p) {
  using namespace hopper;
  using bf16 = __nv_bfloat16;
  constexpr int kO = D / 2;  // output accumulator registers per thread
  extern __shared__ __align__(1024) unsigned char tile_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tile_smem);
  bf16* ks = qs + kTileRows * D;      // ring stage 0: K tiles
  bf16* vs = ks + kTileKeys * D;      // ring stage 1: V tiles

  const int b = blockIdx.z, kvh = blockIdx.y;
  const int group = p.heads / p.kv_heads;
  const int rows = p.tq * group;   // the launcher keeps this below 2^31
  const int row0 = static_cast<int>(gridDim.x - 1 - blockIdx.x) * kTileRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // keys any row of this block can see
  const int t_lo = row0 / group;
  const int t_hi = min(rows - 1, row0 + kTileRows - 1) / group;
  const int kv_limit = p.kv_len ? min(p.tk, p.kv_len[b]) : p.tk;
  const int k_end = p.causal ? min(kv_limit, t_hi + 1) : kv_limit;
  const int k_begin =
      (p.window > 0 ? max(0, t_lo - p.window + 1) : 0) / kTileKeys * kTileKeys;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kTileKeys - 1) / kTileKeys : 0;

  // one cp.async group per operand tile, in use order: Q and K0, V0, then
  // K(i + 1) once S(i) is done with K(i), V(i + 1) once P V(i) is done
  auto load = [&](bf16* dst, const bf16* base, long long stride, int tile) {
    const int n0 = k_begin + tile * kTileKeys;
    load_tile_async<D>(dst, base, [&](int r) -> const bf16* {
      return n0 + r < kv_limit ? base + (n0 + r) * stride : nullptr;
    });
  };
  load_tile_async<D>(qs, q, [&](int r) -> const bf16* {
    const int row = row0 + r;
    if (row >= rows) return nullptr;
    return q + (kvh * group + row % group) * p.q_sh + (row / group) * p.q_st;
  });
  if (n_tiles > 0) load(ks, kp, p.k_st, 0);
  cp_async_commit();
  if (n_tiles > 0) load(vs, vp, p.v_st, 0);
  cp_async_commit();

  // this thread's two accumulator rows: 16 warp + lane / 4 + 8 i
  int t_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 16 * warp + lane / 4 + 8 * i;
    t_row[i] = row < rows ? row / group : p.tq;
  }
  const float sl2 = p.scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int n0 = k_begin + tile * kTileKeys;
    cp_async_wait<1>();   // K(tile) is in; V(tile) may still be loading
    __syncthreads();

    // S = Q K^T (64 rows x 64 keys)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<0>(s, desc_kmajor<64>(qs, 0, kk), desc_kmajor<64>(ks, 0, kk),
                kk > 0, Int<64>());
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    __syncthreads();   // every warp is done with K(tile)
    if (tile + 1 < n_tiles) load(ks, kp, p.k_st, tile + 1);
    cp_async_commit();

    // mask only tiles on an edge: Tk / kv_len, the causal diagonal, the
    // window's far side; on such a tile, row i keeps the scores of
    // columns lo[i] .. hi[i] (column 8 j + c of this thread is key
    // n0 + 8 j + 2 (lane % 4) + c).  Then the row max of the raw scores
    // (scale > 0) and p = 2^(s sl2 - m): one FMNMX and one FFMA a score.
    const bool edge = n0 + kTileKeys > kv_limit ||
                      (p.causal && n0 + kTileKeys - 1 > t_lo) ||
                      (p.window > 0 && n0 <= t_hi - p.window);
    int lo[2], hi[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int base = n0 + 2 * (lane & 3);
      hi[i] = (p.causal ? min(kv_limit - 1, t_row[i]) : kv_limit - 1) - base;
      lo[i] = p.window > 0 ? t_row[i] - p.window + 1 - base : -kTileKeys;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[4 * j + 2 * i + c];
          if (edge && (8 * j + c > hi[i] || 8 * j + c < lo[i])) x = -INFINITY;
          s[4 * j + 2 * i + c] = x;
          mx[i] = fmaxf(mx[i], x);
        }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i] * sl2);
      alpha[i] = exp2_ftz(m[i] - m_new);   // m starts finite: no inf - inf
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float pr = exp2_ftz(fmaf(s[4 * j + 2 * i + c], sl2, -m[i]));
          s[4 * j + 2 * i + c] = pr;
          l[i] += pr;
        }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[4 * j + 2 * i] *= alpha[i];
        o[4 * j + 2 * i + 1] *= alpha[i];
      }

    // O += P V: P (bf16) from registers, V (keys x D) read transposed
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(a[kk], s, kk);
    cp_async_wait<1>();   // V(tile) is in; K(tile + 1) may still be loading
    __syncthreads();
    fence_regs(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs<1>(o, a[kk], desc_mn<64>(vs, 0, kk), 1, Int<D>());
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    __syncthreads();   // every warp is done with V(tile)
    if (tile + 1 < n_tiles) load(vs, vp, p.v_st, tile + 1);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // O / l through the Q tile (read by no product any more), then out in
  // 16-byte stores, eight threads per 128 bytes of a row
  __syncthreads();
  unsigned char* ot = reinterpret_cast<unsigned char*>(qs);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = 16 * warp + lane / 4 + 8 * i;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ot + chunk_offset<64>(r, j) +
                                         4 * (lane & 3)) =
          __floats2bfloat162_rn(o[4 * j + 2 * i] * inv,
                                o[4 * j + 2 * i + 1] * inv);
    const int row = row0 + r;
    if (p.lse != nullptr && (lane & 3) == 0 && row < rows)
      p.lse[(static_cast<long long>(b) * p.heads + kvh * group +
             row % group) * p.tq + row / group] =
          (m[i] + log2f(fmaxf(l[i], 1e-30f))) / kLog2e;
  }
  __syncthreads();
  bf16* out = static_cast<bf16*>(p.out) + b * p.o_sb;
#pragma unroll
  for (int j = 0; j < 64 * D / 8 / kWarpgroup; ++j) {
    const int i = threadIdx.x + j * kWarpgroup;
    const int r = i / (D / 8), c = i % (D / 8);
    const int row = row0 + r;
    if (row < rows)
      *reinterpret_cast<uint4*>(out + (kvh * group + row % group) * p.o_sh +
                                (row / group) * p.o_st + 8 * c) =
          *reinterpret_cast<const uint4*>(ot + chunk_offset<64>(r, c));
  }
}

template <int D>
int launch_tile(const FlashParams& p, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.tq) * (p.heads / p.kv_heads);
  const dim3 grid(static_cast<unsigned>((rows + kTileRows - 1) / kTileRows),
                  static_cast<unsigned>(p.kv_heads),
                  static_cast<unsigned>(p.batch));
  constexpr size_t smem = tile_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tile_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_tile_kernel<D>
      <<<grid, hopper::kWarpgroup, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
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

// Each returns cudaGetLastError() after its launch (0 = launched).
extern "C" int flash_attention_launch(const FlashParams* p, void* stream) {
  if (p->batch <= 0 || p->tq <= 0 || p->tk <= 0 || p->kv_heads <= 0 ||
      p->heads % p->kv_heads != 0 || p->batch > 65535 || p->kv_heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->dtype == 0) return launch_dtype<float>(*p, s);
  if (p->dtype == 1) return launch_dtype<__nv_bfloat16>(*p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tile route: bf16 operands, head_dim 64 or 128, 16-byte aligned rows.
extern "C" int flash_attention_tile_launch(const FlashParams* p,
                                           void* stream) {
  if (p->batch <= 0 || p->tq <= 0 || p->tk <= 0 || p->kv_heads <= 0 ||
      p->heads % p->kv_heads != 0 || p->batch > 65535 ||
      p->kv_heads > 65535 || p->dtype != 1 ||
      static_cast<long long>(p->tq) * p->heads >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->head_dim) {
    case 64: return launch_tile<64>(*p, s);
    case 128: return launch_tile<128>(*p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

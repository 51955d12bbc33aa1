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
// Three routes, all counterparts of flash_attention_pallas; the wrapper
// picks one by a fixed rule (kernels/flash_attention.py, attention_route):
//
// Row route (flash_attention_kernel): fp32 operands, head dims 16 and 32,
// rows not on 16 bytes.  The design above.  Bound: bytes.  Plain FMAs
// from shared memory: 0.041 ms at the decode shape
// (8,32,1,128)/(8,2,161,128), where it served decode until the decode
// route below (PERF.md section 6).
//
// Decode route (flash_attention_decode_kernel): bf16 operands, D in
// {64, 128, 256}, Tq * G < 64 rows (glm4-9b decode: 16 rows, the GQA group).
// Bound: bytes, the valid K/V prefix read once (0.2 us at the decode
// shape, 10 us over a 4096-key cache at (8,2,4096,128)).  The row route
// read each kv head's prefix once per 4 rows and walked a row's keys in
// one block of 64 for 132 SMs.  Here one thread block cluster per
// (batch, kv head) splits the key range, clipped on the device to
// kv_len[b], Tk and the causal band, into contiguous runs of 64-key tiles,
// one run per block (cs blocks, cs from kernels/flash_attention.py
// decode_splits: enough to fill the SMs, at most 8); every block holds
// all Tq * G rows of the group (padded to 16, 32 or 64), so each K/V byte
// is read once.  K and V come through 16-byte cp.async into a two-stage
// ring (the ring is read in place through its strides, keys past kv_len
// zero-filled).  S = Q K^T and O += P V run on mma.sync m16n8k16 (a
// 64-row wgmma would be 3/4 empty at 16 rows): Q and K through ldmatrix,
// P from the S accumulators straight into the A fragment, V through
// ldmatrix.trans.  The four warps of a block split each tile's keys (16
// each at 16 rows), each with its own running (m, l, O); after the loop
// every warp's partial goes to shared memory and cluster rank r merges
// rows r * per .. of every partial of every block in rank order through
// distributed shared memory and writes them once: one launch, no second
// pass, no atomics, the same bits on every launch.  A row that saw no key
// writes 0 and the row route's LSE.  Measured on an NVIDIA H100 80GB HBM3
// at 700 W (PERF.md section 6): 0.012 ms at the decode shape (row route
// 0.041, SDPA 0.021 with the same mask); 0.029 ms over the 4096-key
// cache (SDPA 0.037), a third of the bound's rate: each block streams its
// run with one tile in flight, and deeper rings or eight warps were not
// faster, so more bytes in flight per SM is the next design.
//
// Tile route (flash_attention_tile_kernel): bf16 operands, D in {64, 128, 256},
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
#include <cooperative_groups.h>
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

// shared memory of a row-route block: Q rows, then K (rows padded by one
// word) and V of one 32-key tile, fp32.  Static up to D = 128 (35 KB);
// 69.8 KB at D = 256, past the 48 KB of static shared memory, so there
// it is dynamic
template <int D>
__host__ __device__ constexpr size_t row_smem_bytes() {
  return sizeof(float) * (kRows * D + kKeys * (D + 1) + kKeys * D);
}
template <int D>
__host__ __device__ constexpr bool row_smem_dynamic() {
  return row_smem_bytes<D>() > 48 * 1024;
}

template <typename T, int D>
__device__ __forceinline__ void row_attention(const FlashParams& p,
                                              float (*qs)[D],
                                              float (*ks)[D + 1],
                                              float (*vs)[D]) {
  constexpr int kCols = (D + 31) / 32;  // output columns per lane

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
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const FlashParams p) {
  if constexpr (!row_smem_dynamic<D>()) {
    __shared__ float qs[kRows][D];
    __shared__ float ks[kKeys][D + 1];
    __shared__ float vs[kKeys][D];
    row_attention<T, D>(p, qs, ks, vs);
  } else {
    extern __shared__ float row_smem[];
    row_attention<T, D>(
        p, reinterpret_cast<float (*)[D]>(row_smem),
        reinterpret_cast<float (*)[D + 1]>(row_smem + kRows * D),
        reinterpret_cast<float (*)[D]>(row_smem + kRows * D +
                                        kKeys * (D + 1)));
  }
}

// ---------------------------------------------------------------------------
// tile route: wgmma, bf16, D in {64, 128, 256}
// ---------------------------------------------------------------------------

constexpr int kTileRows = 64;   // flattened (t, g) rows per block
constexpr int kTileKeys = 64;   // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

// shared memory: the block's Q tile, then a two-stage ring of 64-key
// tiles that holds one K and one V tile (K of the next key tile loads
// while this tile's softmax and P V run, V of the next while its S runs);
// every tile on a 1024-byte boundary, as the swizzle needs.  48 KB at
// D = 128: three blocks fit on an SM; 96 KB at D = 256: two.
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

// blocks of the tile route an SM holds: three up to D = 128; at D = 256
// the 128 fp32 accumulators of O, the 32 of S and P's 16 A-operand
// registers need ~210 registers a thread, so two
template <int D>
constexpr int tile_min_blocks() {
  return D > 128 ? 2 : 3;
}

// One block (one warpgroup): 64 flattened (t, g) rows of one (batch, kv
// head).  Row tiles are launched heaviest (latest positions) first.
template <int D>
__global__ void __launch_bounds__(hopper::kWarpgroup, tile_min_blocks<D>())
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

// ---------------------------------------------------------------------------
// decode route: mma.sync, bf16, D in {64, 128, 256}, Tq * G < 64, the keys of
// one (batch, kv head) split across a thread block cluster
// ---------------------------------------------------------------------------

constexpr int kDecKeys = 64;      // keys per K/V tile
constexpr int kDecWarps = 4;

// shared memory of a decode block: the Q tile (the group's Tq * G rows
// padded to 64 / KS), then a two-stage ring of (K, V) tile pairs, every
// tile on a 1024-byte boundary (80 KB at most: D = 128, KS = 1).  After
// the loop the same memory holds each warp's partial (O, m, l) for the
// merge: 16 rows x D fp32 per warp.
template <int D, int KS>
struct DecodeSmem {
  static constexpr int kRowsP = 64 / KS;   // padded query rows
  static constexpr size_t kQ = kRowsP * D * sizeof(__nv_bfloat16);
  static constexpr size_t kTile = kDecKeys * D * sizeof(__nv_bfloat16);
  static constexpr size_t kLoop = kQ + 4 * kTile;
  static constexpr int kPartStride = D + 8;  // floats; no bank conflicts
  static constexpr size_t kParts =
      kDecWarps * 16 * (kPartStride + 2) * sizeof(float);
  static constexpr size_t kSmem = kLoop > kParts ? kLoop : kParts;
};

// One cluster per (batch, kv head); block `rank` of its cs blocks takes a
// contiguous run of the 64-key tiles that the row's kv_len, Tk, the causal
// band and the window leave.  Every block holds all Tq * G query rows of
// the group.  KS = 4 / (padded rows / 16) warps share one 16-row slice of
// the rows and split each key tile between them (decode at G = 16: all
// four warps on the same 16 rows, 16 keys each).
template <int D, int KS>
__global__ void __launch_bounds__(kDecWarps * 32)
flash_attention_decode_kernel(const FlashParams p) {
  using namespace hopper;
  using bf16 = __nv_bfloat16;
  namespace cg = cooperative_groups;
  using Smem = DecodeSmem<D, KS>;
  constexpr int kRowsP = Smem::kRowsP;
  constexpr int kNK = kDecKeys / KS;   // keys of a tile per warp
  constexpr int kNT = kNK / 8;         // 8-key column tiles of S per warp
  constexpr int kPS = Smem::kPartStride;
  extern __shared__ __align__(1024) unsigned char dec_smem[];
  bf16* qs = reinterpret_cast<bf16*>(dec_smem);
  auto stage_k = [&](int st) {
    return reinterpret_cast<bf16*>(dec_smem + Smem::kQ + 2 * st * Smem::kTile);
  };
  auto stage_v = [&](int st) {
    return reinterpret_cast<bf16*>(dec_smem + Smem::kQ +
                                   (2 * st + 1) * Smem::kTile);
  };

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int group = p.heads / p.kv_heads;
  const int rows = p.tq * group;   // < 64 (the launcher checks)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mi = warp / KS, ks = warp % KS;   // row slice, key slice

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // the keys any row can see, in 64-key tiles; this block's run of them
  const int kv_limit = p.kv_len ? min(p.tk, p.kv_len[b]) : p.tk;
  // (the first row is position 0, so the window clips no key in front)
  const int k_end = p.causal ? min(kv_limit, p.tq) : kv_limit;
  const int all_tiles = (max(0, k_end) + kDecKeys - 1) / kDecKeys;
  const int per = (all_tiles + cs - 1) / cs;
  const int tile_lo = min(all_tiles, rank * per);
  const int n_tiles = min(all_tiles, tile_lo + per) - tile_lo;
  const int k_begin = tile_lo * kDecKeys;

  // Q: rows r < rows are (t, g) = (r / G, r % G); the rest zeros
  for (int i = threadIdx.x; i < kRowsP * D / 8; i += kDecWarps * 32) {
    const int r = i / (D / 8), c = i % (D / 8);
    const bool ok = r < rows;
    const bf16* src =
        ok ? q + (kvh * group + r % group) * p.q_sh + (r / group) * p.q_st
           : q;
    cp_async16(reinterpret_cast<char*>(qs) + chunk_offset<kRowsP>(r, c),
               src + (ok ? c * 8 : 0), ok);
  }
  auto load_kv = [&](int tile) {
    const int n0 = k_begin + tile * kDecKeys, st = tile & 1;
    load_tile_async<D>(stage_k(st), kp, [&](int r) -> const bf16* {
      return n0 + r < kv_limit ? kp + (n0 + r) * p.k_st : nullptr;
    });
    load_tile_async<D>(stage_v(st), vp, [&](int r) -> const bf16* {
      return n0 + r < kv_limit ? vp + (n0 + r) * p.v_st : nullptr;
    });
  };
  if (n_tiles > 0) load_kv(0);   // one cp.async group with Q
  cp_async_commit();

  // this thread's rows: 16 mi + lane / 4 + 8 i
  int t_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * mi + lane / 4 + 8 * i;
    t_row[i] = r < rows ? r / group : 0;
  }
  const float sl2 = p.scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < n_tiles) load_kv(tile + 1);   // into the other stage
    cp_async_commit();
    cp_async_wait<1>();   // tile's K and V (and Q) are in
    __syncthreads();
    const int n0 = k_begin + tile * kDecKeys;
    const int key0 = ks * kNK;   // this warp's first key of the tile
    const char* kt = reinterpret_cast<const char*>(stage_k(st));
    const char* vt = reinterpret_cast<const char*>(stage_v(st));
    const char* qt = reinterpret_cast<const char*>(qs);

    // S = Q K^T: 16 rows x kNK keys
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qt + chunk_offset<kRowsP>(
                              16 * mi + (lane & 7) + 8 * ((lane >> 3) & 1),
                              2 * kk + (lane >> 4)));
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kt + chunk_offset<kDecKeys>(
                                 key0 + 16 * j + (lane & 7) + 8 * (lane >> 4),
                                 2 * kk + ((lane >> 3) & 1)));
        mma_16816(s[2 * j], a, bk[0], bk[1]);
        mma_16816(s[2 * j + 1], a, bk[2], bk[3]);
      }
    }

    // masks on tiles that cross an edge (kv_len / Tk, the causal band,
    // the window), then the online softmax, log2(e) folded into the scale
    const bool edge = n0 + kDecKeys > kv_limit || p.causal || p.window > 0;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[j][2 * i + c];
          if (edge) {
            const int key = n0 + key0 + 8 * j + 2 * (lane & 3) + c;
            bool ok = key < kv_limit;
            if (p.causal) ok = ok && key <= t_row[i];
            if (p.window > 0) ok = ok && key > t_row[i] - p.window;
            if (!ok) x = -INFINITY;
          }
          s[j][2 * i + c] = x;
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
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float pr = exp2_ftz(fmaf(s[j][2 * i + c], sl2, -m[i]));
          s[j][2 * i + c] = pr;
          l[i] += pr;
        }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];

    // O += P V: P from the S registers (bf16), V read transposed
#pragma unroll
    for (int kk = 0; kk < kNK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        uint32_t bv[4];
        ldmatrix_x4_trans(
            bv, vt + chunk_offset<kDecKeys>(
                         key0 + 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1),
                         2 * j + (lane >> 4)));
        mma_16816(o[2 * j], a, bv[0], bv[1]);
        mma_16816(o[2 * j + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();   // every warp is done with stage st
  }
  cp_async_wait<0>();
  __syncthreads();     // the partials below reuse the ring's memory

  // each warp's partial (O, m, l) of its 16 rows; then block rank r merges
  // rows r * per_r .. of every warp of every block in rank order through
  // distributed shared memory and writes them once
  float* part_o = reinterpret_cast<float*>(dec_smem);
  float* part_m = part_o + kDecWarps * 16 * kPS;
  float* part_l = part_m + kDecWarps * 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int rl = warp * 16 + lane / 4 + 8 * i;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(part_o + rl * kPS + 8 * j + 2 * (lane & 3)) =
          make_float2(o[j][2 * i], o[j][2 * i + 1]);
    if ((lane & 3) == 0) {
      part_m[rl] = m[i];
      part_l[rl] = l[i];
    }
  }
  cluster.sync();
  const int per_r = (rows + cs - 1) / cs;
  const int r_lo = min(rows, rank * per_r), r_hi = min(rows, r_lo + per_r);
  bf16* out = static_cast<bf16*>(p.out) + b * p.o_sb;
  for (int idx = threadIdx.x; idx < (r_hi - r_lo) * (D / 4);
       idx += kDecWarps * 32) {
    const int r = r_lo + idx / (D / 4), c4 = idx % (D / 4);
    const int w0 = (r / 16) * KS, rl = r % 16;   // the row's first warp
    float M = kNegInf;
    for (int rr = 0; rr < cs; ++rr) {
      const float* pm = cluster.map_shared_rank(part_m, rr);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) M = fmaxf(M, pm[(w0 + kk) * 16 + rl]);
    }
    float L = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int rr = 0; rr < cs; ++rr) {
      const float* pm = cluster.map_shared_rank(part_m, rr);
      const float* pl = cluster.map_shared_rank(part_l, rr);
      const float* po = cluster.map_shared_rank(part_o, rr);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int w = (w0 + kk) * 16 + rl;
        const float wt = exp2_ftz(pm[w] - M);
        L += wt * pl[w];
        const float4 x =
            *reinterpret_cast<const float4*>(po + w * kPS + 4 * c4);
        acc.x += wt * x.x;
        acc.y += wt * x.y;
        acc.z += wt * x.z;
        acc.w += wt * x.w;
      }
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    const int t = r / group, h = kvh * group + r % group;
    const __nv_bfloat162 lo2 = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
    const __nv_bfloat162 hi2 = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&lo2);
    packed.y = *reinterpret_cast<const uint32_t*>(&hi2);
    *reinterpret_cast<uint2*>(out + h * p.o_sh + t * p.o_st + 4 * c4) = packed;
    // a row that saw no key writes 0 and the row route's LSE
    if (p.lse != nullptr && c4 == 0)
      p.lse[(static_cast<long long>(b) * p.heads + h) * p.tq + t] =
          L > 0.f ? (M + log2f(L)) / kLog2e : kNegInf;
  }
  cluster.sync();      // no block leaves while another reads its partials
}

template <int D, int KS>
int launch_decode_ks(const FlashParams& p, int splits, cudaStream_t stream) {
  constexpr size_t smem = DecodeSmem<D, KS>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_decode_kernel<D, KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(splits),
                     static_cast<unsigned>(p.kv_heads),
                     static_cast<unsigned>(p.batch));
  cfg.blockDim = dim3(kDecWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_attention_decode_kernel<D, KS>, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_decode(const FlashParams& p, int splits, cudaStream_t stream) {
  const int rows = p.tq * (p.heads / p.kv_heads);
  if (rows <= 16) return launch_decode_ks<D, 4>(p, splits, stream);
  if (rows <= 32) return launch_decode_ks<D, 2>(p, splits, stream);
  return launch_decode_ks<D, 1>(p, splits, stream);
}

template <typename T, int D>
int launch(const FlashParams& p, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.tq) * (p.heads / p.kv_heads);
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows),
                  static_cast<unsigned>(p.kv_heads),
                  static_cast<unsigned>(p.batch));
  constexpr size_t smem = row_smem_dynamic<D>() ? row_smem_bytes<D>() : 0;
  if (smem > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(const FlashParams& p, cudaStream_t stream) {
  switch (p.head_dim) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
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

// The decode route: bf16 operands, head_dim 64, 128 or 256, Tq * G < 64 rows,
// 16-byte aligned rows; `splits` blocks (1..8) per (batch, kv head), one
// thread block cluster.
extern "C" int flash_attention_decode_launch(const FlashParams* p, int splits,
                                             void* stream) {
  if (p->batch <= 0 || p->tq <= 0 || p->tk <= 0 || p->kv_heads <= 0 ||
      p->heads % p->kv_heads != 0 || p->batch > 65535 ||
      p->kv_heads > 65535 || p->dtype != 1 || splits < 1 || splits > 8 ||
      static_cast<long long>(p->tq) * (p->heads / p->kv_heads) >= 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->head_dim) {
    case 64: return launch_decode<64>(*p, splits, s);
    case 128: return launch_decode<128>(*p, splits, s);
    case 256: return launch_decode<256>(*p, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tile route: bf16 operands, head_dim 64, 128 or 256, 16-byte aligned
// rows.
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
    case 256: return launch_tile<256>(*p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Chunked RWKV6 wkv, forward and backward, CUDA C++ for Hopper (sm_90a).
//
// Replaces: repro/kernels/rwkv_wkv.py,
//   _wkv_call (rwkv_wkv_pallas and rwkv_wkv_fwd_pallas, one kernel with a
//   flag that also emits every chunk's entry state), grid (B*H, T/chunk)
//   with the state S (K x K fp32) carried in VMEM across the sequential
//   chunk axis, and
//   rwkv_wkv_bwd_pallas (_wkv_bwd_kernel), the same grid walked in reverse
//   with the state adjoint G carried in VMEM.
//
// Per head, per key channel k, with log-decays lw_t <= 0 and, inside a chunk
// of Q tokens, L_t = sum_{s<=t} lw_s (L_{-1} = 0):
//   y_t  = sum_{i<t} (sum_k r_tk k_ik e^{L_{t-1,k} - L_ik}) v_i      (intra)
//        + (sum_k r_tk u_k k_tk) v_t                                (bonus)
//        + sum_k r_tk e^{L_{t-1,k}} S_k                             (inter)
//   S'_k = e^{L_{Q-1,k}} S_k + sum_i k_ik e^{L_{Q-1,k} - L_ik} v_i
// and the backward is the adjoint of that algebra, chunk by chunk in reverse
// (dr, dk, dv, dlog_w, du; G_prev = diag(e^{L_{Q-1}}) G + (r e^{L_prev})^T dy).
//
// Numerics.  The TPU kernel forms k e^{-L} and r e^{L_prev} separately; at
// chunk 128 with strong decays -L passes fp32's ~88 and the product turns
// into inf * 0.  These kernels use the PAIRWISE form: every intra-chunk
// weight is computed as expf(L_{t-1,k} - L_ik) with i < t, an exponent <= 0,
// so nothing overflows; every other exponential here (e^{L_prev},
// e^{L_{Q-1}}, e^{L_{Q-1} - L_i}) has an exponent <= 0 as well.  The
// backward's log-decay path is rewritten in the same terms (d_kw * kw =
// k * dk_intra, d_rw * rw = r * (dr_intra + e^{L_prev} dy S0^T)).  Same
// function, different rounding: the plain versions follow the TPU algebra.
//
// Design.  The TPU's sequential chunk axis becomes a loop inside the block.
//   Forward: one block per (b*h, value-column tile).  y[:, j] and S[:, j]
//   depend only on v[:, j] and S[:, j], so the value columns split across
//   blocks with no reduction (the wrapper splits them when b*h alone does
//   not fill the card, as at prefill: 40 heads on 132 SMs); each block
//   recomputes the chunk's scores.  The state tile lives in shared memory.
//   Backward: one block per b*h (dr, dk and dlog_w sum over the value
//   columns, so a value split would need a reduction), G in shared memory,
//   seeded from dS_T; four passes per chunk:
//     A  rows t:    dS[t, i] = dy_t . v_i, dr, and dL_prev (to scratch);
//     B  columns i: scores A[t, i] and dS[t, i] for t > i, dk, dv, dL;
//     C  channels k: dL_Q, the in-chunk reverse cumsum giving dlog_w, du;
//     D  G update.
//   256 threads (8 warps).  A warp owns one row (or column) at a time:
//   lane l scores token i0 + l of a 32-token tile, the warp broadcasts the
//   scores by shuffles and lane l accumulates channels l, l + 32.  Rows of
//   r/k/L/dy in shared memory are padded to K + 1 words, so reads with a
//   lane-varying token are free of bank conflicts.  Ragged last chunks:
//   only the first nv = T - t0 tokens are loaded and every loop stops at
//   nv, which is what padding with log_w = 0, k = 0 steps computes (the
//   chunk decay e^{L_{nv-1}} equals e^{L_{Q-1}} of the padded chunk), so
//   the returned state is that of the T real tokens.  Operands are read
//   through the model layout's strides (B, T, H, K), innermost stride 1;
//   r/k/v in fp32 or bf16, log_w, u and dy in fp32; every output is fp32.
//
// Bound on this card: operations.  At the training shape (B = 12, T = 512,
// H = 40, K = 64, chunk 128) the forward needs 8.08 GFLOP of products over
// the causal pairs (B T H K (2(Q + 1) + 4K); the JAX package's roofline
// counts the full Q x Q square) and moves ~50 MB, so max(50 MB / 3.35 TB/s,
// 8.08 GFLOP / 67 TFLOP/s fp32) = 0.121 ms; the backward needs 18.2 GFLOP
// (B T H K (5(Q + 1) + 8K)), 0.272 ms.  These kernels do plain fp32 FMAs
// and one expf per (t, i, k) triple of the intra-chunk work (Q^2 K / 2 per
// chunk in the forward, three times that in the backward), so the
// exponentials, not the products, set their time.  Next: factor the
// off-diagonal 32-token tiles through a per-tile reference decay (exponents
// stay <= 0, exponentials drop ~16x), then wgmma for the tile products.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

}  // namespace

// Mirrored field for field by a ctypes.Structure in rwkv_wkv.py.
struct WkvParams {
  const void* r;        // (B, T, H, K) through strides, dtype below
  const void* k;
  const void* v;
  const float* log_w;   // (B, T, H, K) through strides, fp32
  const float* u;       // (H, K) contiguous fp32
  const float* dy;      // backward: (B, T, H, K) through strides, fp32
  const float* s0_in;   // backward: (B*H, nc, K, K) contiguous, entry states
  const float* dsT;     // backward: (B*H, K, K) contiguous
  float* y;             // forward: (B, T, H, K) contiguous
  float* sT;            // forward: (B*H, K, K) contiguous
  float* s0;            // forward: (B*H, nc, K, K) contiguous, or null
  float* dr;            // backward: (B, T, H, K) contiguous
  float* dk;
  float* dv;
  float* dlw;
  float* du;            // backward: (B*H, K) per row
  float* scratch;       // backward: (B*H, chunk, K)
  long long r_sb, r_st, r_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long w_sb, w_st, w_sh;
  long long dy_sb, dy_st, dy_sh;
  int batch, seq, heads, head_dim, chunk, v_split;
  int dtype;            // r/k/v: 0 = float32, 1 = bfloat16
};

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int K>
size_t fwd_smem_bytes(int chunk, int vt) {
  return sizeof(float) * (3 * static_cast<size_t>(chunk) * (K + 1) +
                          static_cast<size_t>(chunk) * vt +
                          static_cast<size_t>(K) * vt + kWarps * K);
}

template <int K>
size_t bwd_smem_bytes(int chunk) {
  return sizeof(float) * (5 * static_cast<size_t>(chunk) * (K + 1) +
                          2 * static_cast<size_t>(K) * (K + 1) +
                          2 * kWarps * K + 2 * static_cast<size_t>(chunk));
}

// In-chunk inclusive cumsum of the log-decays, one thread per channel.
template <int K>
__device__ __forceinline__ void chunk_cumsum(float* Ls, int nv) {
  constexpr int KP = K + 1;
  if (threadIdx.x < K) {
    float acc = 0.f;
    for (int t = 0; t < nv; ++t) {
      acc += Ls[t * KP + threadIdx.x];
      Ls[t * KP + threadIdx.x] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int K>
__global__ void __launch_bounds__(kThreads) wkv_fwd_kernel(const WkvParams p) {
  constexpr int KP = K + 1;
  constexpr int kC = (K + 31) / 32;  // channels (or value columns) per lane
  extern __shared__ float smem[];
  const int Q = p.chunk;
  const int VT = K / p.v_split;
  float* rs = smem;            // [Q][KP]
  float* ks = rs + Q * KP;     // [Q][KP]
  float* Ls = ks + Q * KP;     // [Q][KP] inclusive cumsum of log_w
  float* vs = Ls + Q * KP;     // [Q][VT]
  float* S = vs + Q * VT;      // [K][VT] carried state, this block's columns
  float* wb = S + K * VT;      // [kWarps][K] per-warp row buffer

  const int bh = blockIdx.x;
  const int b = bh / p.heads, h = bh % p.heads;
  const int col0 = blockIdx.y * VT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nc = (p.seq + Q - 1) / Q;

  const T* r = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + col0;
  const float* lw = p.log_w + b * p.w_sb + h * p.w_sh;
  float u_l[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int kk = lane + 32 * c;
    u_l[c] = kk < K ? p.u[h * K + kk] : 0.f;
  }
  for (int i = threadIdx.x; i < K * VT; i += kThreads) S[i] = 0.f;

  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * Q;
    const int nv = min(Q, p.seq - t0);
    __syncthreads();  // the previous chunk's state update is complete
    if (p.s0 != nullptr) {
      float* s0 = p.s0 + (static_cast<long long>(bh) * nc + ci) * K * K + col0;
      for (int i = threadIdx.x; i < K * VT; i += kThreads)
        s0[(i / VT) * K + i % VT] = S[i];
    }
    for (int i = threadIdx.x; i < nv * K; i += kThreads) {
      const int t = i / K, kk = i % K;
      const long long tt = t0 + t;
      rs[t * KP + kk] = to_float(r[tt * p.r_st + kk]);
      ks[t * KP + kk] = to_float(kp[tt * p.k_st + kk]);
      Ls[t * KP + kk] = lw[tt * p.w_st + kk];
    }
    for (int i = threadIdx.x; i < nv * VT; i += kThreads) {
      const int t = i / VT, j = i % VT;
      vs[t * VT + j] = to_float(v[(t0 + t) * p.v_st + j]);
    }
    __syncthreads();
    chunk_cumsum<K>(Ls, nv);
    __syncthreads();

    for (int t = warp; t < nv; t += kWarps) {
      const float* rt = rs + t * KP;
      const float* Lpt = Ls + max(t - 1, 0) * KP;  // read only when t > 0
      float acc[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[c] = 0.f;
      // intra: lane l scores token i0 + l, the warp broadcasts the scores
      for (int i0 = 0; i0 < t; i0 += 32) {
        const int i = i0 + lane;
        float a = 0.f;
        if (i < t) {
          const float* ki = ks + i * KP;
          const float* Li = Ls + i * KP;
#pragma unroll 8
          for (int kk = 0; kk < K; ++kk)
            a = fmaf(rt[kk] * ki[kk], expf(Lpt[kk] - Li[kk]), a);
        }
        const int n = min(32, t - i0);
        for (int jj = 0; jj < n; ++jj) {
          const float aj = __shfl_sync(kFull, a, jj);
          const float* vi = vs + (i0 + jj) * VT;
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            const int j = lane + 32 * c;
            if (j < VT) acc[c] = fmaf(aj, vi[j], acc[c]);
          }
        }
      }
      // bonus diagonal, and this row's decayed query into the warp buffer
      float bonus = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int kk = lane + 32 * c;
        if (kk < K) {
          bonus += rt[kk] * u_l[c] * ks[t * KP + kk];
          wb[warp * K + kk] = rt[kk] * expf(t > 0 ? Lpt[kk] : 0.f);
        }
      }
      bonus = warp_sum(bonus);
      __syncwarp();
      float* y = p.y + ((static_cast<long long>(b) * p.seq + t0 + t) * p.heads
                        + h) * K + col0;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int j = lane + 32 * c;
        if (j < VT) {
          float inter = 0.f;
          for (int kk = 0; kk < K; ++kk)
            inter = fmaf(wb[warp * K + kk], S[kk * VT + j], inter);
          y[j] = acc[c] + bonus * vs[t * VT + j] + inter;
        }
      }
      __syncwarp();  // the buffer is rewritten by this warp's next row
    }
    __syncthreads();

    // state update: k_i e^{L_{nv-1} - L_i} in place, then S' column by column
    for (int i = threadIdx.x; i < nv * K; i += kThreads) {
      const int t = i / K, kk = i % K;
      ks[t * KP + kk] *= expf(Ls[(nv - 1) * KP + kk] - Ls[t * KP + kk]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < K * VT; i += kThreads) {
      const int kk = i / VT, j = i % VT;
      float s = S[i] * expf(Ls[(nv - 1) * KP + kk]);
      for (int t = 0; t < nv; ++t) s = fmaf(ks[t * KP + kk], vs[t * VT + j], s);
      S[i] = s;
    }
  }
  __syncthreads();
  float* sT = p.sT + static_cast<long long>(bh) * K * K + col0;
  for (int i = threadIdx.x; i < K * VT; i += kThreads)
    sT[(i / VT) * K + i % VT] = S[i];
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

template <typename T, int K>
__global__ void __launch_bounds__(kThreads) wkv_bwd_kernel(const WkvParams p) {
  constexpr int KP = K + 1;
  constexpr int kC = (K + 31) / 32;
  extern __shared__ float smem[];
  const int Q = p.chunk;
  float* rs = smem;             // [Q][KP]
  float* ks = rs + Q * KP;      // [Q][KP]
  float* vs = ks + Q * KP;      // [Q][KP]
  float* dys = vs + Q * KP;     // [Q][KP]
  float* Ls = dys + Q * KP;     // [Q][KP] inclusive cumsum of log_w
  float* S0s = Ls + Q * KP;     // [K][KP] the chunk's entry state
  float* Gs = S0s + K * KP;     // [K][KP] adjoint of the chunk's exit state
  float* wb = Gs + K * KP;      // [kWarps][K] per-warp row buffer
  float* xpart = wb + kWarps * K;  // [kWarps][K] partial sums for dL_Q
  float* dbs = xpart + kWarps * K;  // [Q] dy_t . v_t
  float* bs = dbs + Q;              // [Q] sum_k r_tk u_k k_tk

  const int bh = blockIdx.x;
  const int b = bh / p.heads, h = bh % p.heads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nc = (p.seq + Q - 1) / Q;

  const T* r = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* lw = p.log_w + b * p.w_sb + h * p.w_sh;
  const float* dy = p.dy + b * p.dy_sb + h * p.dy_sh;
  float* scr = p.scratch + static_cast<long long>(bh) * Q * K;  // [Q][K]
  float u_l[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int kk = lane + 32 * c;
    u_l[c] = kk < K ? p.u[h * K + kk] : 0.f;
  }
  for (int i = threadIdx.x; i < K * K; i += kThreads)
    Gs[(i / K) * KP + i % K] = p.dsT[static_cast<long long>(bh) * K * K + i];
  float du_acc = 0.f;  // thread k < K owns du[k]

  for (int ci = nc - 1; ci >= 0; --ci) {
    const int t0 = ci * Q;
    const int nv = min(Q, p.seq - t0);
    // element (t, k) of this chunk in the contiguous (B, T, H, K) outputs
    auto out_at = [&](int t, int kk) {
      return ((static_cast<long long>(b) * p.seq + t0 + t) * p.heads + h) * K
             + kk;
    };
    __syncthreads();  // the previous (later) chunk is complete
    for (int i = threadIdx.x; i < nv * K; i += kThreads) {
      const int t = i / K, kk = i % K;
      const long long tt = t0 + t;
      rs[t * KP + kk] = to_float(r[tt * p.r_st + kk]);
      ks[t * KP + kk] = to_float(kp[tt * p.k_st + kk]);
      vs[t * KP + kk] = to_float(v[tt * p.v_st + kk]);
      dys[t * KP + kk] = dy[tt * p.dy_st + kk];
      Ls[t * KP + kk] = lw[tt * p.w_st + kk];
    }
    const float* s0 = p.s0_in + (static_cast<long long>(bh) * nc + ci) * K * K;
    for (int i = threadIdx.x; i < K * K; i += kThreads)
      S0s[(i / K) * KP + i % K] = s0[i];
    __syncthreads();
    chunk_cumsum<K>(Ls, nv);
    __syncthreads();

    // --- pass A, rows t: dr and dL_prev ----------------------------------
    for (int t = warp; t < nv; t += kWarps) {
      const float* rt = rs + t * KP;
      const float* kt = ks + t * KP;
      const float* dyt = dys + t * KP;
      float lp[kC], acc[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int kk = lane + 32 * c;
        lp[c] = (kk < K && t > 0) ? Ls[(t - 1) * KP + kk] : 0.f;
        acc[c] = 0.f;
      }
      for (int i0 = 0; i0 < t; i0 += 32) {
        const int i = i0 + lane;
        float ds = 0.f;  // dS[t, i] = dy_t . v_i
        if (i < t) {
          const float* vi = vs + i * KP;
#pragma unroll 8
          for (int j = 0; j < K; ++j) ds = fmaf(dyt[j], vi[j], ds);
        }
        const int n = min(32, t - i0);
        for (int jj = 0; jj < n; ++jj) {
          const float d = __shfl_sync(kFull, ds, jj);
          const float* ki = ks + (i0 + jj) * KP;
          const float* Li = Ls + (i0 + jj) * KP;
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            const int kk = lane + 32 * c;
            if (kk < K) acc[c] = fmaf(d * ki[kk], expf(lp[c] - Li[kk]), acc[c]);
          }
        }
      }
      float db = 0.f, bb = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int kk = lane + 32 * c;
        if (kk < K) {
          db += dyt[kk] * vs[t * KP + kk];
          bb += rt[kk] * u_l[c] * kt[kk];
        }
      }
      db = warp_sum(db);
      bb = warp_sum(bb);
      if (lane == 0) {
        dbs[t] = db;
        bs[t] = bb;
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int kk = lane + 32 * c;
        if (kk < K) {
          const float* s0k = S0s + kk * KP;
          float dys0 = 0.f;  // (dy S0^T)[t, k]
          for (int j = 0; j < K; ++j) dys0 = fmaf(dyt[j], s0k[j], dys0);
          const float core = acc[c] + expf(lp[c]) * dys0;  // d_rw * e^{L_prev}
          p.dr[out_at(t, kk)] = core + u_l[c] * kt[kk] * db;
          scr[t * K + kk] = rt[kk] * core;  // dL_prev = d_rw * rw
        }
      }
    }
    __syncthreads();

    // --- pass B, columns i: dk, dv, dL ------------------------------------
    float xacc[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) xacc[c] = 0.f;
    for (int i = warp; i < nv; i += kWarps) {
      const float* ki = ks + i * KP;
      const float* ri = rs + i * KP;
      const float* vi = vs + i * KP;
      const float* dyi = dys + i * KP;
      const float* Li = Ls + i * KP;
      float li[kC], dk_acc[kC], dv_acc[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int kk = lane + 32 * c;
        li[c] = kk < K ? Li[kk] : 0.f;
        dk_acc[c] = 0.f;
        dv_acc[c] = 0.f;
      }
      for (int tb = i + 1; tb < nv; tb += 32) {
        const int t = tb + lane;
        float ds = 0.f, a = 0.f;  // dS[t, i] and the score A[t, i]
        if (t < nv) {
          const float* dyt = dys + t * KP;
          const float* rt = rs + t * KP;
          const float* Lpt = Ls + (t - 1) * KP;
#pragma unroll 8
          for (int j = 0; j < K; ++j) ds = fmaf(dyt[j], vi[j], ds);
#pragma unroll 8
          for (int kk = 0; kk < K; ++kk)
            a = fmaf(rt[kk] * ki[kk], expf(Lpt[kk] - Li[kk]), a);
        }
        const int n = min(32, nv - tb);
        for (int tt = 0; tt < n; ++tt) {
          const float d = __shfl_sync(kFull, ds, tt);
          const float aa = __shfl_sync(kFull, a, tt);
          const float* rt = rs + (tb + tt) * KP;
          const float* Lpt = Ls + (tb + tt - 1) * KP;
          const float* dyt = dys + (tb + tt) * KP;
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            const int kk = lane + 32 * c;
            if (kk < K) {
              dk_acc[c] = fmaf(d * rt[kk], expf(Lpt[kk] - li[c]), dk_acc[c]);
              dv_acc[c] = fmaf(aa, dyt[kk], dv_acc[c]);
            }
          }
        }
      }
      // state path: S' = diag(e^{L_Q}) S0 + (k * tail)^T v
      float tail[kC], dkt[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int kk = lane + 32 * c;
        tail[c] = 0.f;
        dkt[c] = 0.f;
        if (kk < K) {
          tail[c] = expf(Ls[(nv - 1) * KP + kk] - li[c]);
          const float* gk = Gs + kk * KP;
          float s = 0.f;  // (v G^T)[i, k]
          for (int j = 0; j < K; ++j) s = fmaf(vi[j], gk[j], s);
          dkt[c] = s;
          wb[warp * K + kk] = ki[kk] * tail[c];
        }
      }
      __syncwarp();
      const float db_i = dbs[i], b_i = bs[i];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int kk = lane + 32 * c;  // channel k, and value column j = kk
        if (kk < K) {
          float dvs = 0.f;  // ((k * tail) G)[i, j]
          for (int m = 0; m < K; ++m)
            dvs = fmaf(wb[warp * K + m], Gs[m * KP + kk], dvs);
          const long long g = out_at(i, kk);
          p.dk[g] = dk_acc[c] + tail[c] * dkt[c] + u_l[c] * ri[kk] * db_i;
          p.dv[g] = dv_acc[c] + b_i * dyi[kk] + dvs;
          const float x = ki[kk] * dkt[c] * tail[c];  // d_tail * tail
          xacc[c] += x;
          const float dL = -ki[kk] * dk_acc[c] - x;   // -d_kw kw - d_tail tail
          scr[i * K + kk] += dL;  // dL + dL_prev
          p.dlw[g] = dL;
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int kk = lane + 32 * c;
      if (kk < K) xpart[warp * K + kk] = xacc[c];
    }
    __syncthreads();

    // --- pass C, channels k: dlog_w by the in-chunk reverse cumsum, du ------
    if (threadIdx.x < K) {
      const int kk = threadIdx.x;
      float gs = 0.f;
      for (int j = 0; j < K; ++j) gs = fmaf(Gs[kk * KP + j], S0s[kk * KP + j], gs);
      float run = expf(Ls[(nv - 1) * KP + kk]) * gs;  // dL_Q
      for (int w = 0; w < kWarps; ++w) run += xpart[w * K + kk];
      // dlog_w_t = dL_Q + sum_{i>t} (dL_i + dL_prev_i) + dL_t
#pragma unroll 4
      for (int t = nv - 1; t >= 0; --t) {
        const long long g = out_at(t, kk);
        p.dlw[g] += run;
        run += scr[t * K + kk];
        du_acc = fmaf(rs[t * KP + kk] * ks[t * KP + kk], dbs[t], du_acc);
      }
    }
    __syncthreads();

    // --- pass D: G_prev = diag(e^{L_Q}) G + (r e^{L_prev})^T dy -------------
    for (int i = threadIdx.x; i < nv * K; i += kThreads) {
      const int t = i / K, kk = i % K;
      rs[t * KP + kk] *= expf(t > 0 ? Ls[(t - 1) * KP + kk] : 0.f);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < K * K; i += kThreads) {
      const int kk = i / K, j = i % K;
      float g = Gs[kk * KP + j] * expf(Ls[(nv - 1) * KP + kk]);
      for (int t = 0; t < nv; ++t) g = fmaf(rs[t * KP + kk], dys[t * KP + j], g);
      Gs[kk * KP + j] = g;
    }
  }
  if (threadIdx.x < K) p.du[static_cast<long long>(bh) * K + threadIdx.x] = du_acc;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int launch_kernel(Kernel kernel, dim3 grid, size_t smem, const WkvParams& p,
                  cudaStream_t stream) {
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int launch_k(const WkvParams& p, bool fwd, cudaStream_t stream) {
  const unsigned bh = static_cast<unsigned>(p.batch * p.heads);
  if (fwd) {
    if (p.v_split <= 0 || K % p.v_split != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_kernel(wkv_fwd_kernel<T, K>,
                         dim3(bh, static_cast<unsigned>(p.v_split)),
                         fwd_smem_bytes<K>(p.chunk, K / p.v_split), p, stream);
  }
  return launch_kernel(wkv_bwd_kernel<T, K>, dim3(bh), bwd_smem_bytes<K>(p.chunk),
                       p, stream);
}

template <typename T>
int launch_dtype(const WkvParams& p, bool fwd, cudaStream_t stream) {
  switch (p.head_dim) {
    case 16: return launch_k<T, 16>(p, fwd, stream);
    case 32: return launch_k<T, 32>(p, fwd, stream);
    case 64: return launch_k<T, 64>(p, fwd, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_any(const WkvParams* p, bool fwd, void* stream) {
  if (p->batch <= 0 || p->seq <= 0 || p->heads <= 0 || p->chunk <= 0 ||
      p->chunk > p->seq || static_cast<long long>(p->batch) * p->heads > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (fwd ? (p->y == nullptr || p->sT == nullptr)
          : (p->dy == nullptr || p->s0_in == nullptr || p->dsT == nullptr ||
             p->dr == nullptr || p->dk == nullptr || p->dv == nullptr ||
             p->dlw == nullptr || p->du == nullptr || p->scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->dtype == 0) return launch_dtype<float>(*p, fwd, s);
  if (p->dtype == 1) return launch_dtype<__nv_bfloat16>(*p, fwd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Each returns cudaGetLastError() after its launch (0 = launched).
extern "C" int rwkv_wkv_fwd_launch(const WkvParams* p, void* stream) {
  return launch_any(p, true, stream);
}

extern "C" int rwkv_wkv_bwd_launch(const WkvParams* p, void* stream) {
  return launch_any(p, false, stream);
}

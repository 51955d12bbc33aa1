"""State-space and linear-attention mixers: Mamba2 (SSD) and RWKV6 (Finch)
(counterpart of ``repro/models/ssm.py``).

Mamba2 recurrence per head (scalar decay a_t = exp(A * dt_t)):
    h_t = a_t * h_{t-1} + dt_t * x_t (outer) B_t        h: (P, S)
    y_t = h_t @ C_t + D * x_t
Train and prefill run the chunked SSD form (:func:`_mamba2_core_chunked`:
quadratic inside a chunk, a loop over chunk states across chunks) in plain
torch products, as the JAX package runs it in einsums (no kernel); a
single-token decode step runs the recurrence above.  The dtypes follow the
JAX package's promotions: the chunked form computes in fp32 from the
projections' dtype, the decode step casts its output back to it.

RWKV6 recurrence per head, per key channel (decay w_t in (0, 1)):
    S_t = diag(w_t) S_{t-1} + k_t (outer) v_t           S: (K, V)
    y_t = r_t @ (S_{t-1} + diag(u) k_t (outer) v_t)
Train and prefill run the chunked parallel form on the ``cfg.kernels``
backend (the ``cuda`` backend's kernels, or :func:`_wkv_chunked`, the plain
version); a single-token decode step runs the recurrence above in plain
torch, as the JAX package does.

Cache contracts (decode), the JAX leaves: Mamba2 ``{"conv": (B, d_conv-1,
conv_ch), "state": (B, H, P, S) fp32}``; RWKV6 ``{"tm_last": (B, 1, d),
"cm_last": (B, 1, d), "state": (B, H, K, K) fp32}``, the block keeping the
channel mix's own ``cm_last`` beside it.  A cache is updated IN PLACE (the
caller's tensors, e.g. the ServeSession slot pool, are written).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.launch import tensor_parallel as tp
from repro_torch.models.common import fan_in_init, init_rmsnorm, rmsnorm


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------


def _mamba_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.d_state            # xBC go through the conv
    return s, d_inner, nheads, conv_ch


def init_mamba2(cfg: ModelConfig, generator, device) -> dict:
    s, d_inner, nheads, conv_ch = _mamba_dims(cfg)
    d, dt = cfg.d_model, cfg.param_dtype
    d_proj = 2 * d_inner + 2 * s.d_state + nheads   # z, xBC, dt
    return {
        "in_proj": fan_in_init((d, d_proj), dt, generator, device),
        "conv_w": fan_in_init((s.d_conv, conv_ch), dt, generator, device,
                              fan_in=s.d_conv),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads,
                                          device=device)).float(),
        "dt_bias": torch.zeros((nheads,), dtype=torch.float32,
                               device=device),
        "D": torch.ones((nheads,), dtype=torch.float32, device=device),
        "out_norm": init_rmsnorm(d_inner, dt, device),
        "out_proj": fan_in_init((d_inner, d), dt, generator, device),
    }


def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    s, _, nheads, conv_ch = _mamba_dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_ch), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, nheads, s.head_dim, s.d_state),
                             dtype=torch.float32, device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d.  x (B, T, C), w (K, C); ``history`` is the
    (B, K-1, C) tail of the previous tokens (decode) or None (zero pad)."""
    K, T = w.shape[0], x.shape[1]
    if history is None:
        history = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([history, x], dim=1)                     # (B, T+K-1, C)
    out = xp[:, 0:T] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + T] * w[i]
    return F.silu(out + b)


def _mamba2_split(params, x, cfg):
    """z, xBC, dt from ``in_proj`` (d, 2 d_inner + 2 S + H), held whole or
    as this rank's chunk of either dim: a column chunk straddles z / xBC /
    dt, so its output is gathered (the conv and the SSD scan run whole)."""
    s, d_inner, nheads, conv_ch = _mamba_dims(cfg)
    proj, split = tp.linear(x, params["in_proj"], x.shape[-1],
                            2 * d_inner + 2 * s.d_state + nheads)
    proj = tp.whole(proj, split)
    return (proj[..., :d_inner], proj[..., d_inner:d_inner + conv_ch],
            proj[..., d_inner + conv_ch:])                  # z, xBC, dt


def _mamba2_core_chunked(xh, B, C, log_a, dt, D, chunk: int):
    """Chunked SSD.  xh (B, T, H, P), B/C (B, T, S), log_a (B, T, H) the
    per-token log decay (negative), dt (B, T, H) -> ``(y (B, T, H, P),
    h_T (B, H, P, S) fp32)``; y in the promoted dtype of ``xh`` and ``dt``
    (fp32 for the fp32 ``dt`` of :func:`mamba2_forward`)."""
    Bb, T0, H, P = xh.shape
    S = B.shape[-1]
    Q = min(chunk, T0)
    pad = (-T0) % Q
    if pad:
        # dt = 0 and log_a = 0 make the padded steps identities (decay 1,
        # no input), so the final state is unaffected
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        B, C, log_a, dt = (F.pad(a, (0, 0, 0, pad))
                           for a in (B, C, log_a, dt))
    T = T0 + pad
    nc = T // Q

    def r(t):                                   # time -> (chunks, Q)
        return t.reshape(t.shape[0], nc, Q, *t.shape[2:])

    xh_c, B_c, C_c = r(xh), r(B), r(C)
    la_c, dt_c = r(log_a).float(), r(dt).float()            # (B, nc, Q, H)
    Lc = torch.cumsum(la_c, dim=2)                          # within a chunk
    u = xh_c * dt_c[..., None]                              # weighted input

    # intra-chunk: y_t = sum_{i<=t} exp(L_t - L_i) (C_t . B_i) u_i
    scores = torch.einsum("bnqs,bnks->bnqk", C_c, B_c)      # (B, nc, Q, Q)
    seg = Lc[:, :, :, None, :] - Lc[:, :, None, :, :]       # L_t - L_i
    causal = torch.ones((Q, Q), dtype=torch.bool,
                        device=xh.device).tril()[None, None, :, :, None]
    # seg is masked BEFORE exp: the non-causal entries (i > t) have seg > 0
    # and can overflow exp to inf, which the outer where hides in the
    # forward but turns into inf * 0 = NaN in the backward
    decay = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)),
                        0.0)
    attn = scores[..., None] * decay                        # (B,nc,Q,Q,H)
    y_intra = torch.einsum("bnqkh,bnkhp->bnqhp", attn.to(u.dtype), u)

    # chunk summary state S_n = sum_i exp(L_Q - L_i) u_i (outer) B_i
    tail = torch.exp(Lc[:, :, -1:, :] - Lc)                 # (B, nc, Q, H)
    Sn = torch.einsum("bnqh,bnqhp,bnqs->bnhps", tail.to(u.dtype), u,
                      B_c.to(u.dtype))                      # (B,nc,H,P,S)
    chunk_decay = torch.exp(Lc[:, :, -1, :]).float()        # (B, nc, H)
    h = torch.zeros((Bb, H, P, S), dtype=torch.float32, device=xh.device)
    h_prev = []
    for n in range(nc):                 # the state *before* each chunk
        h_prev.append(h)
        h = h * chunk_decay[:, n, :, None, None] + Sn[:, n].float()
    h_prev = torch.stack(h_prev, dim=1)                     # (B,nc,H,P,S)

    # inter-chunk: y_t += exp(L_t) C_t . h_{chunk start}
    inter_w = torch.exp(Lc).to(u.dtype)                     # (B, nc, Q, H)
    y_inter = torch.einsum("bnqs,bnhps,bnqh->bnqhp", C_c.to(u.dtype),
                           h_prev.to(u.dtype), inter_w)
    y = ((y_intra + y_inter).reshape(Bb, T, H, P)
         + D[:, None] * xh * dt[..., None])
    return y[:, :T0], h


def mamba2_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                   cache: Optional[dict] = None
                   ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Train (no cache), prefill (T > 1) or a single-token decode step; the
    cache is updated in place.  A prefill starts from a zero state, as the
    JAX package's does."""
    s, d_inner, nheads, _ = _mamba_dims(cfg)
    P, S = s.head_dim, s.d_state
    Bsz, T, _ = x.shape
    z, xBC, dt = _mamba2_split(params, x, cfg)
    A = -torch.exp(params["A_log"])                         # (H,) negative
    dt_sp = F.softplus(dt.float() + params["dt_bias"])

    if cache is None or T > 1:
        hist = cache["conv"] if cache is not None else None
        if cache is not None:
            # concat then tail: a prompt shorter than d_conv - 1 keeps the
            # older history in front of it
            new_hist = torch.cat([hist, xBC], dim=1)[:, -(s.d_conv - 1):]
        xBC = _causal_conv(xBC, params["conv_w"], params["conv_b"],
                           history=hist)
        xi = xBC[..., :d_inner].reshape(Bsz, T, nheads, P)
        Bm, Cm = xBC[..., d_inner:d_inner + S], xBC[..., d_inner + S:]
        y, hT = _mamba2_core_chunked(xi, Bm, Cm, dt_sp * A, dt_sp,
                                     params["D"], s.chunk_size)
        if cache is not None:
            cache["conv"].copy_(new_hist)
            cache["state"].copy_(hT)
    else:
        hist = cache["conv"]
        new_hist = torch.cat([hist, xBC], dim=1)[:, 1:]
        xBC = _causal_conv(xBC, params["conv_w"], params["conv_b"],
                           history=hist)
        xi = xBC[..., :d_inner].reshape(Bsz, 1, nheads, P)
        Bm, Cm = xBC[:, 0, d_inner:d_inner + S], xBC[:, 0, d_inner + S:]
        a = torch.exp(dt_sp * A)[:, 0]                      # (B, H)
        u = (xi * dt_sp[..., None])[:, 0]                   # (B, H, P)
        h = (cache["state"] * a[..., None, None]
             + u.float()[..., None] * Bm.float()[:, None, None, :])
        y = (torch.einsum("bhps,bs->bhp", h, Cm.float())
             + params["D"][:, None] * xi[:, 0] * dt_sp[:, 0, :, None])
        y = y[:, None].to(x.dtype)                          # (B, 1, H, P)
        cache["conv"].copy_(new_hist)
        cache["state"].copy_(h)

    y = y.reshape(Bsz, T, d_inner) * F.silu(z)
    y = rmsnorm(params["out_norm"], y, cfg.norm_eps)
    out, split = tp.linear(y, params["out_proj"].to(y.dtype), d_inner,
                           cfg.d_model)
    return tp.whole(out, split).to(x.dtype), cache


# ---------------------------------------------------------------------------
# RWKV6 (Finch)
# ---------------------------------------------------------------------------


def _rwkv_dims(cfg: ModelConfig):
    s = cfg.ssm
    K = s.head_dim
    return s, cfg.d_model // K, K


def _lora_dim(d: int) -> int:
    """The decay LoRA's width."""
    return max(32, d // 16)


def init_rwkv6(cfg: ModelConfig, generator, device) -> dict:
    """RWKV6 time mix: token-shift lerp, r/k/v/g projections, data-dependent
    per-channel decay w via a LoRA on the shifted input, bonus u."""
    _, H, K = _rwkv_dims(cfg)
    d, dt = cfg.d_model, cfg.param_dtype
    lora = _lora_dim(d)
    init = lambda shape: fan_in_init(shape, dt, generator, device)  # noqa: E731
    return {
        "mix": torch.full((5, d), 0.5, dtype=dt, device=device),  # r,k,v,g,w
        "wr": init((d, d)),
        "wk": init((d, d)),
        "wv": init((d, d)),
        "wg": init((d, d)),
        "w_base": torch.full((d,), -6.0, dtype=torch.float32, device=device),
        "w_lora_a": init((d, lora)),
        "w_lora_b": torch.zeros((lora, d), dtype=dt, device=device),
        "u": torch.zeros((H, K), dtype=torch.float32, device=device),
        "out_norm": init_rmsnorm(d, dt, device),
        "wo": init((d, d)),
    }


def init_rwkv6_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    _, H, K = _rwkv_dims(cfg)
    return {
        "tm_last": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                               device=device),
        "cm_last": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                               device=device),
        "state": torch.zeros((batch, H, K, K), dtype=torch.float32,
                             device=device),
    }


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _wkv_chunked(r, k, v, log_w, u, chunk: int):
    """Chunked RWKV6 wkv, the ``ref`` backend.  r/k/v/log_w (B, T, H, K)
    (log_w < 0), u (H, K) -> ``(y (B, T, H, K), S_T (B, H, K, K))`` fp32."""
    B, T0, H, K = r.shape
    Q = min(chunk, T0)
    pad = (-T0) % Q
    if pad:            # log w = 0 -> decay 1, k = 0 -> no-op steps
        r, k, v, log_w = (F.pad(a, (0, 0, 0, 0, 0, pad))
                          for a in (r, k, v, log_w))
    T = T0 + pad
    nc = T // Q

    def sp(t):
        return t.reshape(B, nc, Q, H, K).float()

    r_c, k_c, v_c, lw = sp(r), sp(k), sp(v), sp(log_w)
    # L_t = sum_{j<=t} log w_j within the chunk
    L = torch.cumsum(lw, dim=2)
    L_prev = L - lw
    rw = r_c * L_prev.exp()
    kw = k_c * (-L).exp()
    scores = torch.einsum("bnqhk,bnihk->bnhqi", rw, kw)
    strict = torch.ones((Q, Q), dtype=torch.bool, device=r.device).tril(-1)
    scores = torch.where(strict, scores, 0.0)
    diag = torch.einsum("bnqhk,hk,bnqhk->bnqh", r_c, u.float(), k_c)
    y_intra = (torch.einsum("bnhqi,bnihk->bnqhk", scores, v_c)
               + diag[..., None] * v_c)

    # chunk summary: S_n = sum_i exp(L_Q - L_i) k_i (outer) v_i; decay e^{L_Q}
    tail = (L[:, :, -1:] - L).exp()
    Sn = torch.einsum("bnqhk,bnqhv->bnhkv", k_c * tail, v_c)
    cdecay = L[:, :, -1].exp()                              # (B, n, H, K)
    S = torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
    S_prev = []
    for n in range(nc):
        S_prev.append(S)
        S = S * cdecay[:, n, ..., None] + Sn[:, n]
    y_inter = torch.einsum("bnqhk,bnhkv->bnqhv", rw,
                           torch.stack(S_prev, dim=1))
    y = (y_intra + y_inter).reshape(B, T, H, K)
    return y[:, :T0], S


def _heads(t: torch.Tensor, split: bool, local: bool) -> torch.Tensor:
    """A projection's output (..., d), whole or this rank's chunk
    (``split``), as the wkv reads it: this rank's heads where ``local``,
    else every head."""
    if not local:
        return tp.whole(t, split)
    return t if split else tp.scatter_in(t, tp.active())


def _norm_squares(s: torch.Tensor) -> torch.Tensor:
    """A split row's sums of squares summed over the model group (a module
    function: ``parity.per_rank_norm_squares`` replaces it)."""
    return tp.sum_over_group(s, tp.active())


def _out_norm(params: dict, y: torch.Tensor, d: int, eps: float
              ) -> torch.Tensor:
    """RMSNorm over the whole ``d`` of ``y``, held whole or as this rank's
    chunk of its last dim (its sum of squares taken over the group, the
    scale narrowed to the chunk)."""
    if y.shape[-1] == d:
        return rmsnorm(params, y, eps)
    yf = y.float()
    var = _norm_squares(yf.square().sum(dim=-1, keepdim=True)) / d
    scale = tp.local(params["scale"], y.shape[-1]).float()
    return (yf * torch.rsqrt(var + eps) * scale).to(y.dtype)


def rwkv6_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  cache: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Train (no cache), chunked prefill (T > 1) or a single-token decode
    step; the cache is updated in place.

    Over a ``"model"`` group each projection multiplies with this rank's
    chunk (``shardings.tp_roles``).  Where the group's size divides H, the
    wkv of train and prefill runs on this rank's H/P heads: r, k, v, g and
    the decay reach it as this rank's chunk (a whole output cut to it),
    ``u`` narrowed; the output norm takes its sum of squares over the
    group and ``wo`` reads the chunk row-parallel.  A prefill gathers its
    final state's heads into the cache, whose state stays whole.  A decode
    step, and any step where P does not divide H, runs every head: the
    split outputs are gathered (a decode's r, k, v, w are (B, 1, d), the
    state it would otherwise gather B x H x K x K)."""
    s, H, K = _rwkv_dims(cfg)
    B, T, d = x.shape
    g = tp.active()
    local = (g is not None and H % g.size == 0
             and (cache is None or T > 1))
    h = H // g.size if local else H
    last = cache["tm_last"] if cache is not None else None
    xs = _token_shift(x, last)
    mixed = [x + m * (xs - x) for m in params["mix"]]       # r,k,v,g,w inputs

    def proj(i, name):
        return _heads(*tp.linear(mixed[i], params[name], d, d), local)

    r = proj(0, "wr").view(B, T, h, K)
    k = proj(1, "wk").view(B, T, h, K)
    v = proj(2, "wv").view(B, T, h, K)
    gate = F.silu(proj(3, "wg"))
    lora = _lora_dim(d)
    a, asplit = tp.linear(mixed[4], params["w_lora_a"], d, lora)
    dd = _heads(*tp.linear(a, params["w_lora_b"], lora, d, split_in=asplit),
                local)
    w_dd = tp.local(params["w_base"], dd.shape[-1]) + dd.float()
    log_w = -torch.exp(w_dd).view(B, T, h, K)               # < 0
    u = tp.local(params["u"], h, dim=0)

    if cache is None or T > 1:
        # train / chunked prefill on the cfg.kernels backend
        y, ST = dispatch.backend_for(cfg).wkv(r, k, v, log_w, u,
                                              chunk=s.chunk_size)
        if cache is not None:
            cache["tm_last"].copy_(x[:, -1:])
            cache["state"].copy_(tp.whole(ST, local, dim=1))
    else:
        S = cache["state"]                                  # (B, H, K, V)
        r1, k1, v1 = r[:, 0].float(), k[:, 0].float(), v[:, 0].float()
        w1 = torch.exp(log_w[:, 0])                         # (B, H, K)
        kv = k1[..., None] * v1[..., None, :]
        y = torch.einsum("bhk,bhkv->bhv", r1,
                         S + u[None, :, :, None] * kv)[:, None]
        cache["state"].copy_(S * w1[..., None] + kv)
        cache["tm_last"].copy_(x)

    y = y.reshape(B, T, h * K).to(x.dtype) * gate.to(x.dtype)
    y = _out_norm(params["out_norm"], y, d, cfg.norm_eps)
    out, split = tp.linear(y, params["wo"], d, d, split_in=local)
    return tp.whole(out, split).to(x.dtype), cache


# --- RWKV channel mix (the FFN of an RWKV block) ---------------------------


def init_rwkv_cm(cfg: ModelConfig, generator, device) -> dict:
    d, dt = cfg.d_model, cfg.param_dtype
    return {
        "mix": torch.full((2, d), 0.5, dtype=dt, device=device),  # k, r
        "wk": fan_in_init((d, cfg.d_ff), dt, generator, device),
        "wv": fan_in_init((cfg.d_ff, d), dt, generator, device),
        "wr": fan_in_init((d, d), dt, generator, device),
    }


def rwkv_cm_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Over a ``"model"`` group each of the three products multiplies with
    this rank's chunk through ``tensor_parallel.linear`` (megatron: ``wk``
    column-parallel over d_ff, the hidden gathered for ``wv``'s
    column-parallel output, ``wr`` whole)."""
    d = x.shape[-1]
    xs = _token_shift(x, last)
    xk = x + params["mix"][0] * (xs - x)
    xr = x + params["mix"][1] * (xs - x)
    k, ks = tp.linear(xk, params["wk"], d, cfg.d_ff)
    k = torch.square(F.relu(k))
    v, vs = tp.linear(k, params["wv"], cfg.d_ff, d, split_in=ks)
    r, rs = tp.linear(xr, params["wr"], d, d)
    return (torch.sigmoid(tp.whole(r, rs)) * tp.whole(v, vs)).to(x.dtype)

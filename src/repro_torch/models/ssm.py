"""RWKV6 (Finch) time mix and channel mix (counterpart of the RWKV6 half
of ``repro/models/ssm.py``; Mamba2 is still to be ported).

Recurrence per head, per key channel (decay w_t in (0, 1)):
    S_t = diag(w_t) S_{t-1} + k_t (outer) v_t           S: (K, V)
    y_t = r_t @ (S_{t-1} + diag(u) k_t (outer) v_t)
Train and prefill run the chunked parallel form on the ``cfg.kernels``
backend (the ``cuda`` backend's kernels, or :func:`_wkv_chunked`, the plain
version); a single-token decode step runs the recurrence above in plain
torch, as the JAX package does.

Cache contract (decode): ``{"tm_last": (B, 1, d), "cm_last": (B, 1, d),
"state": (B, H, K, K) fp32}`` — the JAX leaves; the block keeps the channel
mix's own ``cm_last`` beside it.  A cache is updated IN PLACE (the caller's
tensors, e.g. the ServeSession slot pool, are written).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.models.common import fan_in_init, init_rmsnorm, rmsnorm


def _rwkv_dims(cfg: ModelConfig):
    s = cfg.ssm
    K = s.head_dim
    return s, cfg.d_model // K, K


def init_rwkv6(cfg: ModelConfig, generator, device) -> dict:
    """RWKV6 time mix: token-shift lerp, r/k/v/g projections, data-dependent
    per-channel decay w via a LoRA on the shifted input, bonus u."""
    _, H, K = _rwkv_dims(cfg)
    d, dt = cfg.d_model, cfg.param_dtype
    lora = max(32, d // 16)
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


def rwkv6_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  cache: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    s, H, K = _rwkv_dims(cfg)
    B, T, d = x.shape
    last = cache["tm_last"] if cache is not None else None
    xs = _token_shift(x, last)
    mixed = [x + m * (xs - x) for m in params["mix"]]       # r,k,v,g,w inputs
    r = (mixed[0] @ params["wr"]).view(B, T, H, K)
    k = (mixed[1] @ params["wk"]).view(B, T, H, K)
    v = (mixed[2] @ params["wv"]).view(B, T, H, K)
    g = F.silu(mixed[3] @ params["wg"])
    w_dd = (params["w_base"]
            + ((mixed[4] @ params["w_lora_a"]) @ params["w_lora_b"]).float())
    log_w = -torch.exp(w_dd).view(B, T, H, K)               # < 0

    if cache is None or T > 1:
        # train / chunked prefill on the cfg.kernels backend
        y, ST = dispatch.backend_for(cfg).wkv(r, k, v, log_w, params["u"],
                                              chunk=s.chunk_size)
        if cache is not None:
            cache["tm_last"].copy_(x[:, -1:])
            cache["state"].copy_(ST)
    else:
        S = cache["state"]                                  # (B, H, K, V)
        r1, k1, v1 = r[:, 0].float(), k[:, 0].float(), v[:, 0].float()
        w1 = torch.exp(log_w[:, 0])                         # (B, H, K)
        kv = k1[..., None] * v1[..., None, :]
        y = torch.einsum("bhk,bhkv->bhv", r1,
                         S + params["u"][None, :, :, None] * kv)[:, None]
        cache["state"].copy_(S * w1[..., None] + kv)
        cache["tm_last"].copy_(x)

    y = y.reshape(B, T, d).to(x.dtype) * g.to(x.dtype)
    y = rmsnorm(params["out_norm"], y, cfg.norm_eps)
    return (y @ params["wo"]).to(x.dtype), cache


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
    xs = _token_shift(x, last)
    xk = x + params["mix"][0] * (xs - x)
    xr = x + params["mix"][1] * (xs - x)
    k = torch.square(F.relu(xk @ params["wk"]))
    r = torch.sigmoid(xr @ params["wr"])
    return (r * (k @ params["wv"])).to(x.dtype)

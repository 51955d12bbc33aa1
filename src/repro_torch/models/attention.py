"""GQA attention with RoPE and an optional sliding window (counterpart of
``repro/models/attention.py``; MLA and cross attention are still to be
ported).  The score/value contraction routes through
``repro_torch.kernels.dispatch``.

Cache contract (decode): ``{"k": (B, W, Hkv, hd), "v": (B, W, Hkv, hd)}``
with W = window or max_len.  Keys are stored already roped, token position
p at slot p % W.  ``cache_len`` (B,) holds the tokens already written in
each row: JAX vmaps a B=1 step over the decode slots, the port writes the
slot batch out.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.models.common import fan_in_init
from repro_torch.models.rope import apply_rope


def init_gqa(cfg: ModelConfig, generator, device) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    dt = cfg.param_dtype
    p = {
        "wq": fan_in_init((d, H, hd), dt, generator, device, fan_in=d),
        "wk": fan_in_init((d, Hkv, hd), dt, generator, device, fan_in=d),
        "wv": fan_in_init((d, Hkv, hd), dt, generator, device, fan_in=d),
        "wo": fan_in_init((H, hd, d), dt, generator, device, fan_in=H * hd),
    }
    if cfg.use_qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((Hkv, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((Hkv, hd), dtype=dt, device=device)
    return p


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
    W = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, W, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B,T,d) x (d,heads,hd) -> (B,T,heads,hd), one plain matrix product."""
    d, heads, hd = w.shape
    return (x @ w.reshape(d, heads * hd)).view(*x.shape[:2], heads, hd)


def gqa_forward(params: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, cache: Optional[dict] = None,
                cache_len: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full causal attention (train/prefill) when ``cache is None``;
    otherwise writes (k, v) into the ring ``cache`` IN PLACE (the caller's
    tensors, e.g. the ServeSession slot pool, are updated) and attends over
    it.  ``positions`` (B, T) or (1, T); ``cache_len`` (B,) integers."""
    backend = dispatch.backend_for(cfg)
    B, T, _ = x.shape
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.use_qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = backend.attention(q, k, v, causal=True, window=cfg.sliding_window)
    else:
        W = cache["k"].shape[1]
        if T > 1 and T >= W:
            # prefill longer than the window: full in-flight SWA attention,
            # then keep only the last W tokens, rolled to slot p % W
            out = backend.attention(q, k, v, causal=True,
                                    window=cfg.sliding_window)
            shift = (T - W) % W
            cache["k"].copy_(torch.roll(k[:, T - W:], shift, dims=1))
            cache["v"].copy_(torch.roll(v[:, T - W:], shift, dims=1))
        else:
            # row b writes its tokens at (cache_len[b] + t) % W — the JAX
            # dynamic_update_slice at cache_len % W whenever it fits
            rows = torch.arange(B, device=x.device)[:, None]
            slots = (cache_len.long()[:, None]
                     + torch.arange(T, device=x.device)) % W
            cache["k"][rows, slots] = k
            cache["v"][rows, slots] = v
            if T > 1:
                # short prefill: causal over the freshly written [0, T)
                # slots (ragged Tq < Tk — the diagonal masks slots >= T)
                out = backend.attention(q, cache["k"], cache["v"], causal=True,
                                        window=cfg.sliding_window)
            else:
                # decode: each row's valid ring prefix, on the device
                n_valid = torch.clamp(cache_len + 1, max=W).to(torch.int32)
                out = backend.attention(q, cache["k"], cache["v"],
                                        kv_valid=n_valid)
    H, hd, d = params["wo"].shape
    out = out.reshape(B, T, H * hd) @ params["wo"].reshape(H * hd, d)
    return out.to(x.dtype), cache

"""Attention mixers: GQA with RoPE and an optional sliding window,
DeepSeek's multi-head latent attention (MLA), and Whisper's cross
attention (counterpart of ``repro/models/attention.py``).  The
score/value contractions of GQA and of cross attention route through
``repro_torch.kernels.dispatch``; MLA runs plain torch products, as the
JAX package runs it in einsums (no kernel).

Cache contracts (decode), W = window or max_len, token position p at slot
p % W:
  GQA : ``{"k": (B, W, Hkv, hd), "v": (B, W, Hkv, hd)}``, keys stored
        already roped;
  MLA : ``{"ckv": (B, W, kv_lora), "k_rope": (B, W, rope_dim)}``, the
        normed latent and the roped shared key.
``cache_len`` (B,) holds the tokens already written in each row: JAX vmaps
a B=1 step over the decode slots, the port writes the slot batch out.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.models.common import fan_in_init, init_rmsnorm, rmsnorm
from repro_torch.models.rope import apply_rope

NEG_INF = -1e30


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

    if cache is not None:
        _ring_write(cache, {"k": k, "v": v}, cache_len)
    if cache is None or T >= max(2, cache["k"].shape[1]):
        # train, or a prefill longer than the window: full in-flight SWA
        # attention (the ring kept the last W tokens)
        out = backend.attention(q, k, v, causal=True, window=cfg.sliding_window)
    elif T > 1:
        # short prefill: causal over the freshly written [0, T) slots
        # (ragged Tq < Tk: the diagonal masks slots >= T)
        out = backend.attention(q, cache["k"], cache["v"], causal=True,
                                window=cfg.sliding_window)
    else:
        # decode: each row's valid ring prefix, on the device
        n_valid = torch.clamp(cache_len + 1,
                              max=cache["k"].shape[1]).to(torch.int32)
        out = backend.attention(q, cache["k"], cache["v"], kv_valid=n_valid)
    H, hd, d = params["wo"].shape
    out = out.reshape(B, T, H * hd) @ params["wo"].reshape(H * hd, d)
    return out.to(x.dtype), cache


def _ring_write(cache: dict, new: dict, cache_len: torch.Tensor) -> None:
    """Writes each leaf of ``new`` (B, T, ...) into ``cache``'s ring in
    place: row b's tokens at (cache_len[b] + t) % W, or, for a prefill of
    T >= W tokens, the last W rolled to slot p % W."""
    some = next(iter(new.values()))
    B, T = some.shape[:2]
    W = next(iter(cache.values())).shape[1]
    if T > 1 and T >= W:
        for key, t in new.items():
            cache[key].copy_(torch.roll(t[:, T - W:], (T - W) % W, dims=1))
        return
    rows = torch.arange(B, device=some.device)[:, None]
    slots = (cache_len.long()[:, None]
             + torch.arange(T, device=some.device)) % W
    for key, t in new.items():
        cache[key][rows, slots] = t


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------


def init_mla(cfg: ModelConfig, generator, device) -> dict:
    m = cfg.mla
    d, H, dt = cfg.d_model, cfg.num_heads, cfg.param_dtype
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    init = lambda shape, **kw: fan_in_init(  # noqa: E731
        shape, dt, generator, device, **kw)
    return {
        "w_dq": init((d, m.q_lora_rank)),
        "q_norm": init_rmsnorm(m.q_lora_rank, dt, device),
        "w_uq": init((m.q_lora_rank, H, qk_dim), fan_in=m.q_lora_rank),
        "w_dkv": init((d, m.kv_lora_rank + m.qk_rope_head_dim)),
        "kv_norm": init_rmsnorm(m.kv_lora_rank, dt, device),
        "w_uk": init((m.kv_lora_rank, H, m.qk_nope_head_dim),
                     fan_in=m.kv_lora_rank),
        "w_uv": init((m.kv_lora_rank, H, m.v_head_dim),
                     fan_in=m.kv_lora_rank),
        "wo": init((H, m.v_head_dim, d), fan_in=H * m.v_head_dim),
    }


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
    m = cfg.mla
    W = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    return {"ckv": torch.zeros((batch, W, m.kv_lora_rank), dtype=dtype,
                               device=device),
            "k_rope": torch.zeros((batch, W, m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def _mla_project_q(params, x, positions, cfg):
    m = cfg.mla
    cq = rmsnorm(params["q_norm"], x @ params["w_dq"], cfg.norm_eps)
    q = _project(cq, params["w_uq"])
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q[..., :m.qk_nope_head_dim], q_rope


def _mla_project_kv(params, x, positions, cfg):
    m = cfg.mla
    dkv = x @ params["w_dkv"]
    ckv = rmsnorm(params["kv_norm"], dkv[..., :m.kv_lora_rank], cfg.norm_eps)
    k_rope = apply_rope(dkv[..., m.kv_lora_rank:].unsqueeze(-2), positions,
                        cfg.rope_theta)[..., 0, :]
    return ckv, k_rope                            # (B,T,r), (B,T,rope)


def mla_forward(params: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, cache: Optional[dict] = None,
                cache_len: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Train and prefill (T > 1) expand the latent into per-head keys and
    values and attend causally, a prefill writing its latents into the
    ``cache`` ring in place: a prefill with a cache equals the cache-free
    forward.  A decode step (T == 1) writes its latent at ``cache_len[b] %
    W`` and attends in the latent space, weights absorbed (q against the
    latent through ``w_uk``, the output through ``w_uv``), each row over
    its own valid prefix.  (The JAX package takes the decode branch for a
    prefill with a cache too, where each prompt token sees slot 0 only;
    ROADMAP.md Queue 3.)"""
    m = cfg.mla
    B, T, _ = x.shape
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = _mla_project_q(params, x, positions, cfg)
    ckv, k_rope = _mla_project_kv(params, x, positions, cfg)

    if cache is None or T > 1:
        k_nope = _project(ckv, params["w_uk"])
        v = _project(ckv, params["w_uv"])
        logits = (torch.einsum("bthk,bshk->bhts", q_nope, k_nope)
                  + torch.einsum("bthk,bsk->bhts", q_rope, k_rope)
                  ).float() * scale
        qpos = torch.arange(T, device=x.device)[:, None]
        kpos = torch.arange(T, device=x.device)[None, :]
        mask = kpos <= qpos
        if cfg.sliding_window is not None:
            mask &= kpos > qpos - cfg.sliding_window
        logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhts,bshk->bthk", probs, v)
        if cache is not None:
            _ring_write(cache, {"ckv": ckv, "k_rope": k_rope}, cache_len)
    else:
        _ring_write(cache, {"ckv": ckv, "k_rope": k_rope}, cache_len)
        W = cache["ckv"].shape[1]
        n_valid = torch.clamp(cache_len.long() + 1, max=W)
        mask = (torch.arange(W, device=x.device)[None, :]
                < n_valid[:, None])[:, None, None, :]          # (B,1,1,W)
        # q_abs[b,t,h,:] = w_uk[:, h, :] @ q_nope[b,t,h,:]
        q_abs = torch.einsum("bthk,rhk->bthr", q_nope, params["w_uk"])
        logits = (torch.einsum("bthr,bsr->bhts", q_abs, cache["ckv"])
                  + torch.einsum("bthk,bsk->bhts", q_rope, cache["k_rope"])
                  ).float() * scale
        logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        o_lat = torch.einsum("bhts,bsr->bthr", probs, cache["ckv"])
        out = torch.einsum("bthr,rhk->bthk", o_lat, params["w_uv"])
    H, hv, d = params["wo"].shape
    out = out.reshape(B, T, H * hv) @ params["wo"].reshape(H * hv, d)
    return out.to(x.dtype), cache


# ---------------------------------------------------------------------------
# Cross attention (whisper decoder)
# ---------------------------------------------------------------------------


def init_cross_attn(cfg: ModelConfig, generator, device) -> dict:
    """No biases, even under ``use_qkv_bias`` (as in the JAX package)."""
    d, hd, H = cfg.d_model, cfg.head_dim, cfg.num_heads
    dt = cfg.param_dtype
    return {
        "wq": fan_in_init((d, H, hd), dt, generator, device, fan_in=d),
        "wk": fan_in_init((d, H, hd), dt, generator, device, fan_in=d),
        "wv": fan_in_init((d, H, hd), dt, generator, device, fan_in=d),
        "wo": fan_in_init((H, hd, d), dt, generator, device, fan_in=H * hd),
    }


def cross_attn_forward(params: dict, x: torch.Tensor, enc: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    """x (B, T, d) decoder stream; enc (B, S, d) encoder states (the stub
    frontend's, projected) -> (B, T, d).  Non-causal over all S states,
    through the kernel backend: no cache, the keys and values recomputed
    from ``enc`` on every call, as the JAX package does."""
    q = _project(x, params["wq"])
    k = _project(enc, params["wk"])
    v = _project(enc, params["wv"])
    out = dispatch.backend_for(cfg).attention(q, k, v)
    B, T = x.shape[:2]
    H, hd, d = params["wo"].shape
    out = out.reshape(B, T, H * hd) @ params["wo"].reshape(H * hd, d)
    return out.to(x.dtype)

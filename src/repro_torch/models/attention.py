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

A ring split over ranks along its sequence (a ``ServeSession`` over a
mesh whose recipe shards the decode cache's sequence over ``"model"``) is
a :class:`ShardedRing`: each rank holds slots ``[i * W/P, (i+1) * W/P)``
of the whole ring.  A token is written only by the rank that owns its
slot, and a decode step attends over this rank's part alone
(:meth:`KernelBackend.attention_lse`, its ``kv_valid`` the part of the
row's valid prefix that falls here, 0 where none does) and combines the
parts' outputs by their LSEs (:func:`combine_parts`), the reduction XLA's
partitioner emits for a contraction over a sharded dim.  No rank gathers
the keys.

Over a ``"model"`` group (``launch/tensor_parallel.py``) GQA, cross
attention and MLA (:func:`mla_forward`) multiply with each rank's chunk
of their weights.  Under
``megatron`` ``wq``/``wk``/``wv`` are column-parallel over heads and
``wo`` row-parallel: each rank runs the attention kernels on its query
heads and the KV heads they read (replicated ``wk``/``wv``, where H_kv
does not divide over the group, are computed whole and cut to those).
Other placements (``greedy``'s ``d``-split ``wq``, a column-parallel
``wo``) take the same products with the activations gathered or cut
where a product needs them so.  A decode cache is written with every KV
head; a decode over a split ring attends over all heads of this rank's
part (the new token's q, k and v gathered over the group), and the
output keeps this rank's heads for ``wo``; a whole cache is read for
this rank's KV heads only.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.launch import tensor_parallel as tp
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


@dataclass(frozen=True)
class RingPart:
    """This rank's part of a decode ring split along its sequence:
    ``index`` of ``parts`` equal parts of a ring of ``width`` slots;
    ``gather(x)`` all-gathers ``x`` over the ring's ranks, ``(parts,
    *x.shape)`` in part order."""
    width: int
    parts: int
    index: int
    gather: Callable[[torch.Tensor], torch.Tensor]


class ShardedRing(dict):
    """A layer's decode cache (``{"k", "v"}`` or ``{"ckv", "k_rope"}``,
    each ``(B, W/P, ...)``) that holds one :class:`RingPart` of the ring."""

    def __init__(self, leaves: dict, part: RingPart):
        super().__init__(leaves)
        self.part = part


def combine_parts(out: torch.Tensor, lse: torch.Tensor,
                  has_keys: torch.Tensor, part: RingPart) -> torch.Tensor:
    """The attention over a whole ring from each rank's part: ``out`` (B,
    T, H, D) and ``lse`` (B, H, T) of this rank's part, ``has_keys`` (B,)
    whether the row has a valid key here.  O = sum_r exp(LSE_r - LSE) O_r
    with LSE = logsumexp_r LSE_r, in fp32, one all-gather of the small
    ``(B, T, H, D + 1)`` buffer; a part without a key adds exactly 0
    (whatever its output and LSE read).  Every rank computes the same
    sum in the same order."""
    lse = lse.transpose(1, 2).float()                          # (B, T, H)
    lse = torch.where(has_keys[:, None, None], lse, -torch.inf)
    o = torch.where(has_keys[:, None, None, None], out.float(), 0.0)
    every = part.gather(torch.cat([o, lse[..., None]], dim=-1))
    lses = every[..., -1]                                      # (P, B, T, H)
    w = torch.exp(lses - lses.amax(0))
    o = (w[..., None] * every[..., :-1]).sum(0) / w.sum(0)[..., None]
    return o.to(out.dtype)


def _part_valid(cache_len: torch.Tensor, part: RingPart, width: int
                ) -> torch.Tensor:
    """(B,) int32: the keys of each row's valid ring prefix that fall in
    this rank's part of ``width`` slots."""
    n_valid = torch.clamp(cache_len.long() + 1, max=part.width)
    return (n_valid - part.index * width).clamp(0, width).to(torch.int32)


def _project(x: torch.Tensor, w: torch.Tensor, heads: int = 0
             ) -> Tuple[torch.Tensor, bool]:
    """(B,T,k) x (k,heads,hd) -> ``(y, split)``: y (B,T,heads,hd), one
    plain matrix product.  Over an active ``"model"`` group the weight
    may be this rank's chunk of k or of the whole ``heads`` (``split``: y
    holds this rank's heads); ``heads`` 0: the weight is held whole."""
    k, h, hd = w.shape
    y, split = tp.linear(x, w.reshape(k, h * hd), x.shape[-1],
                         (heads or h) * hd)
    return y.view(*x.shape[:2], -1, hd), split


def _heads_for(t, split: bool, q_split: bool, heads: int, kv_heads: int):
    """Keys or values ``t`` (B, S, kv heads or this rank's chunk, hd) as
    the attention over the query heads reads them: whole where the
    queries are whole, else the KV heads this rank's query heads read."""
    if not q_split:
        return tp.whole(t, split, dim=-2)
    if split:                          # kv chunk r serves query chunk r
        return t
    g = tp.active()
    first, n = tp.head_range(heads, kv_heads, g)
    return tp.copy_in(t, g).narrow(-2, first, n)


def _out_proj(out, split: bool, wo, heads: int, d: int) -> torch.Tensor:
    """``out`` (B, T, heads or this rank's, hd) by ``wo`` (H, hd, d), held
    whole or as this rank's chunk of H or d -> (B, T, d)."""
    B, T = out.shape[:2]
    h, hd, dl = wo.shape
    y, ysplit = tp.linear(out.reshape(B, T, -1), wo.reshape(h * hd, dl),
                          heads * hd, d, split_in=split)
    return tp.whole(y, ysplit)


def gqa_forward(params: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, cache: Optional[dict] = None,
                cache_len: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full causal attention (train/prefill) when ``cache is None``;
    otherwise writes (k, v) into the ring ``cache`` IN PLACE (the caller's
    tensors, e.g. the ServeSession slot pool, are updated) and attends over
    it.  ``positions`` (B, T) or (1, T); ``cache_len`` (B,) integers."""
    backend = dispatch.backend_for(cfg)
    T = x.shape[1]
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    q, qs = _project(x, params["wq"], H)
    k, ks = _project(x, params["wk"], Hkv)
    v, vs = _project(x, params["wv"], Hkv)
    if cfg.use_qkv_bias:
        q = q + tp.local(params["bq"], q.shape[-2], dim=-2)
        k = k + tp.local(params["bk"], k.shape[-2], dim=-2)
        v = v + tp.local(params["bv"], v.shape[-2], dim=-2)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    part = getattr(cache, "part", None)
    if cache is not None:
        # the cache holds every KV head
        k, v = tp.whole(k, ks, dim=-2), tp.whole(v, vs, dim=-2)
        ks = vs = False
        _ring_write(cache, {"k": k, "v": v}, cache_len)
    if cache is None or T >= max(2, cache["k"].shape[1]) or (
            part is not None and T > 1):
        # train, a prefill longer than the window (the ring kept the last
        # W tokens), or a prefill into a split ring (its slots [0, T) hold
        # these keys): full in-flight SWA attention
        out = backend.attention(q, _heads_for(k, ks, qs, H, Hkv),
                                _heads_for(v, vs, qs, H, Hkv), causal=True,
                                window=cfg.sliding_window)
    elif part is not None:
        # decode over this rank's part of the ring, combined over the
        # parts: every head (the token's q gathered over a model group),
        # this rank's heads kept for wo
        valid = _part_valid(cache_len, part, cache["k"].shape[1])
        out, lse = backend.attention_lse(tp.whole(q, qs, dim=-2),
                                         cache["k"], cache["v"],
                                         kv_valid=valid)
        out = combine_parts(out, lse, valid > 0, part)
        if qs:
            out = tp.scatter_in(out, tp.active(), -2)
    else:
        # a whole cache, read for the KV heads this rank's queries read
        ck = _heads_for(cache["k"], False, qs, H, Hkv)
        cv = _heads_for(cache["v"], False, qs, H, Hkv)
        if T > 1:
            # short prefill: causal over the freshly written [0, T) slots
            # (ragged Tq < Tk: the diagonal masks slots >= T)
            out = backend.attention(q, ck, cv, causal=True,
                                    window=cfg.sliding_window)
        else:
            # decode: each row's valid ring prefix, on the device
            n_valid = torch.clamp(cache_len + 1,
                                  max=cache["k"].shape[1]).to(torch.int32)
            out = backend.attention(q, ck, cv, kv_valid=n_valid)
    return _out_proj(out, qs, params["wo"], H, cfg.d_model).to(x.dtype), cache


def _ring_write(cache: dict, new: dict, cache_len: torch.Tensor) -> None:
    """Writes each leaf of ``new`` (B, T, ...) into ``cache``'s ring in
    place: row b's tokens at (cache_len[b] + t) % W, or, for a prefill of
    T >= W tokens, the last W rolled to slot p % W.  Into a
    :class:`ShardedRing` only the slots of this rank's part are written."""
    some = next(iter(new.values()))
    B, T = some.shape[:2]
    width = next(iter(cache.values())).shape[1]
    part = getattr(cache, "part", None)
    W = part.width if part is not None else width
    lo = part.index * width if part is not None else 0
    if T > 1 and T >= W:
        for key, t in new.items():
            cache[key].copy_(torch.roll(t[:, T - W:], (T - W) % W,
                                        dims=1)[:, lo:lo + width])
        return
    rows = torch.arange(B, device=some.device)[:, None]
    slots = (cache_len.long()[:, None]
             + torch.arange(T, device=some.device)) % W - lo
    if part is None:
        for key, t in new.items():
            cache[key][rows, slots] = t
        return
    mine = (slots >= 0) & (slots < width)
    if T == 1:
        # one token a row: a row whose slot is elsewhere rewrites its
        # own slot 0 with what it holds (no host sync)
        at = torch.where(mine, slots, 0)
        for key, t in new.items():
            keep = mine.reshape(B, 1, *([1] * (t.dim() - 2)))
            cache[key][rows, at] = torch.where(keep, t,
                                               cache[key][rows, at])
        return
    for key, t in new.items():
        cache[key][rows.expand(B, T)[mine], slots[mine]] = t[mine]


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


def _latent(x, w, n: int):
    """x (B, T, d) by a latent down-projection of whole shape (d, n), held
    whole or as this rank's chunk of either dim -> (B, T, n) whole: the
    norm and the rope part read the whole latent."""
    y, split = tp.linear(x, w, x.shape[-1], n)
    return tp.whole(y, split)


def _mla_project_q(params, x, positions, cfg):
    """-> ``(q_nope, q_rope, split)``: every head, or this rank's heads
    where ``w_uq`` is column-parallel over them (``split``)."""
    m = cfg.mla
    cq = rmsnorm(params["q_norm"], _latent(x, params["w_dq"],
                                           m.q_lora_rank), cfg.norm_eps)
    q, split = _project(cq, params["w_uq"], cfg.num_heads)
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q[..., :m.qk_nope_head_dim], q_rope, split


def _mla_project_kv(params, x, positions, cfg):
    m = cfg.mla
    dkv = _latent(x, params["w_dkv"],
                  m.kv_lora_rank + m.qk_rope_head_dim)
    ckv = rmsnorm(params["kv_norm"], dkv[..., :m.kv_lora_rank], cfg.norm_eps)
    k_rope = apply_rope(dkv[..., m.kv_lora_rank:].unsqueeze(-2), positions,
                        cfg.rope_theta)[..., 0, :]
    return ckv, k_rope                            # (B,T,r), (B,T,rope)


def _own_heads(w, dim: int, heads: int):
    """This rank's heads of a per-head weight held whole (its cotangent
    summed over the group)."""
    g = tp.active()
    n = heads // g.size
    return tp.copy_in(w, g).narrow(dim, g.index * n, n)


def _absorb_q(q, w, mine: bool, heads: int, rank: int):
    """q_abs = q_nope (B,T,h,k) through ``w_uk`` (rank, H, k) -> (B,T,h,
    rank), over this rank's heads where ``mine`` (q holds them) or every
    head; ``w_uk`` held whole, as its chunk of the heads, or of the latent
    (then q holds every head, and q_abs's latent chunks are gathered)."""
    g = tp.active()
    if g is None:
        return torch.einsum("bthk,rhk->bthr", q, w)
    if w.shape[0] != rank:
        return tp.gather_out(torch.einsum("bthk,rhk->bthr",
                                          tp.copy_in(q, g), w), g, -1)
    if w.shape[1] != heads:
        if mine:
            return torch.einsum("bthk,rhk->bthr", q, w)
        return tp.gather_out(torch.einsum(
            "bthk,rhk->bthr", tp.scatter_in(q, g, -2), w), g, -2)
    return torch.einsum("bthk,rhk->bthr", q,
                        _own_heads(w, 1, heads) if mine else w)


def _absorb_out(o, w, mine: bool, heads: int, rank: int):
    """The latent output o (B,T,h,rank) through ``w_uv`` (rank, H, v) ->
    ``(out (B,T,h',v), split)``, ``split``: out holds this rank's heads
    (o holds them where ``mine``, else every head)."""
    g = tp.active()
    if g is None:
        return torch.einsum("bthr,rhk->bthk", o, w), False
    if w.shape[0] != rank:
        return tp.reduce_out(torch.einsum(
            "bthr,rhk->bthk", tp.scatter_in(o, g, -1), w), g), False
    if w.shape[1] != heads:
        if not mine:
            o = tp.scatter_in(o, g, -2)
        return torch.einsum("bthr,rhk->bthk", o, w), True
    return torch.einsum("bthr,rhk->bthk", o,
                        _own_heads(w, 1, heads) if mine else w), mine


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
    ROADMAP.md Queue 3.)

    Over a ``"model"`` group each projection multiplies with this rank's
    chunk (``shardings.tp_roles``): the latent down-projections' outputs
    are gathered before their norms; ``w_uq``/``w_uk``/``w_uv`` split
    over the heads give this rank's heads (``wo`` row-parallel over
    them), split over the latent they contract a chunk and reduce.  The
    weight-absorbed decode runs on this rank's heads where the queries and
    both absorbed weights hold them and the ring is whole; over a ring
    split along its sequence it attends over this rank's part for every
    head (the parts combined by their LSEs) and keeps its own heads for
    ``w_uv`` and ``wo``, as GQA does."""
    m = cfg.mla
    H = cfg.num_heads
    B, T, _ = x.shape
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope, qs = _mla_project_q(params, x, positions, cfg)
    ckv, k_rope = _mla_project_kv(params, x, positions, cfg)

    if cache is None or T > 1:
        k_nope, ks = _project(ckv, params["w_uk"], H)
        v, vs = _project(ckv, params["w_uv"], H)
        k_nope = _heads_for(k_nope, ks, qs, H, H)
        v = _heads_for(v, vs, qs, H, H)
        # the shared rope key enters every rank's heads
        kr = tp.copy_in(k_rope, tp.active()) if qs else k_rope
        logits = (torch.einsum("bthk,bshk->bhts", q_nope, k_nope)
                  + torch.einsum("bthk,bsk->bhts", q_rope, kr)
                  ).float() * scale
        qpos = torch.arange(T, device=x.device)[:, None]
        kpos = torch.arange(T, device=x.device)[None, :]
        mask = kpos <= qpos
        if cfg.sliding_window is not None:
            mask &= kpos > qpos - cfg.sliding_window
        logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhts,bshk->bthk", probs, v)
        split = qs
        if cache is not None:
            _ring_write(cache, {"ckv": ckv, "k_rope": k_rope}, cache_len)
    else:
        _ring_write(cache, {"ckv": ckv, "k_rope": k_rope}, cache_len)
        W = cache["ckv"].shape[1]
        part = getattr(cache, "part", None)
        n_valid = (torch.clamp(cache_len.long() + 1, max=W) if part is None
                   else _part_valid(cache_len, part, W))
        mask = (torch.arange(W, device=x.device)[None, :]
                < n_valid[:, None])[:, None, None, :]          # (B,1,1,W)
        r = m.kv_lora_rank
        mine = (qs and part is None and params["w_uk"].shape[0] == r
                and params["w_uv"].shape[0] == r)
        if qs and not mine:
            q_nope = tp.whole(q_nope, True, dim=-2)
            q_rope = tp.whole(q_rope, True, dim=-2)
        # q_abs[b,t,h,:] = w_uk[:, h, :] @ q_nope[b,t,h,:]
        q_abs = _absorb_q(q_nope, params["w_uk"], mine, H, r)
        logits = (torch.einsum("bthr,bsr->bhts", q_abs, cache["ckv"])
                  + torch.einsum("bthk,bsk->bhts", q_rope, cache["k_rope"])
                  ).float() * scale
        logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        o_lat = torch.einsum("bhts,bsr->bthr", probs, cache["ckv"])
        if part is not None:
            # this rank's part of the latent ring, combined over the parts
            o_lat = combine_parts(o_lat, torch.logsumexp(logits, dim=-1),
                                  n_valid > 0, part)
        out, split = _absorb_out(o_lat, params["w_uv"], mine, H, r)
    return _out_proj(out, split, params["wo"], H, cfg.d_model).to(x.dtype), \
        cache


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
    H = cfg.num_heads
    q, qs = _project(x, params["wq"], H)
    k, ks = _project(enc, params["wk"], H)
    v, vs = _project(enc, params["wv"], H)
    out = dispatch.backend_for(cfg).attention(
        q, _heads_for(k, ks, qs, H, H), _heads_for(v, vs, qs, H, H))
    return _out_proj(out, qs, params["wo"], H, cfg.d_model).to(x.dtype)

"""Segmented decoder backbone with Hetero-SplitEE exit heads (counterpart
of ``repro/models/backbone.py``).

``cfg.exit_layers`` partitions the layers into *segments*; an exit head
(the paper's client output layer) follows every segment but the last.
The JAX package stacks runs of identical layers and drives them with
``lax.scan``; the port keeps one parameter dict per layer
(``params["segments"][si][li]``) and loops over them in Python.
Zamba2's globally shared attention block is one top-level parameter set,
``params["shared_attn"]`` (an ``"attn"`` block with the FFN of the first
shared layer); each shared layer holds an empty ``{}`` in its place, as
the JAX package's tree does, and has a KV cache of its own.
Audio and VLM configs hold the stub frontend's projector,
``params["frontend"]`` (``models/frontend.py``): Whisper's encoder states
``enc`` are projected and feed every block's cross attention; paligemma's
patch embeddings ``embeds`` are projected and come before the tokens.
Training passes ``split_ids``: each example's residual stream is cut from
the gradient at its own boundary (the paper's routing), and ``remat``
recomputes each block's activations in the backward pass.  MoE blocks'
router aux losses are summed per segment, then over the segments, as the
JAX package sums them per run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import blocks as blocks_mod
from repro_torch.models import frontend as frontend_mod
from repro_torch.models import heads as heads_mod
from repro_torch.models.common import embed, init_embedding


@dataclass(frozen=True)
class Run:
    mixer: str            # "attn" | "mla" | "mamba2" | "rwkv6" | "shared_attn"
    ffn: str
    start: int            # absolute layer index of the first layer in the run
    length: int

    @property
    def shared(self) -> bool:
        return self.mixer == "shared_attn"


def build_plan(cfg: ModelConfig) -> Tuple[Tuple[Run, ...], ...]:
    """Runs of identical (mixer, ffn) layers, per segment (the layout of the
    JAX package's stacked parameters, which ``convert`` unstacks)."""
    plan: List[Tuple[Run, ...]] = []
    for (lo, hi) in cfg.segments():
        runs: List[Run] = []
        l = lo
        while l < hi:
            kind = (cfg.block_pattern[l], cfg.ffn_pattern[l])
            if cfg.block_pattern[l] == "shared_attn":
                runs.append(Run("shared_attn", cfg.ffn_pattern[l], l, 1))
                l += 1
                continue
            n = 1
            while (l + n < hi
                   and (cfg.block_pattern[l + n], cfg.ffn_pattern[l + n]) == kind
                   and cfg.block_pattern[l + n] != "shared_attn"):
                n += 1
            runs.append(Run(kind[0], kind[1], l, n))
            l += n
        plan.append(tuple(runs))
    return tuple(plan)


def segment_layers(cfg: ModelConfig, si: int) -> List[Tuple[str, str]]:
    """(mixer, ffn) of each layer of segment ``si``, in order; a layer of
    the shared block reads ``"shared_attn"``."""
    return [(run.mixer, run.ffn) for run in build_plan(cfg)[si]
            for _ in range(run.length)]


def init_backbone(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random weights drawn from ``generator``, on the generator's device."""
    device = generator.device
    params: dict = {"embed": init_embedding(cfg.vocab_size, cfg.d_model,
                                            cfg.param_dtype, generator, device)}
    feat = {"audio": frontend_mod.WHISPER_FRAME_DIM,
            "vlm": frontend_mod.SIGLIP_PATCH_DIM}.get(cfg.arch_type)
    if feat is not None:
        params["frontend"] = frontend_mod.init_projector(feat, cfg, generator,
                                                         device)
    if "shared_attn" in cfg.block_pattern:
        first = cfg.block_pattern.index("shared_attn")
        params["shared_attn"] = blocks_mod.init_block(
            cfg, "attn", cfg.ffn_pattern[first], generator, device)
    params["segments"] = [
        [{} if mixer == "shared_attn"      # reads params["shared_attn"]
         else blocks_mod.init_block(cfg, mixer, ffn, generator, device)
         for mixer, ffn in segment_layers(cfg, si)]
        for si in range(len(cfg.segments()))]
    if cfg.exit_layers:
        params["exit_heads"] = [heads_mod.init_exit_head(cfg, generator, device)
                                for _ in cfg.exit_layers]
    params["head"] = heads_mod.init_lm_head(cfg, generator, device)
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device) -> list:
    """Decode cache mirroring the parameters: per segment, per layer (each
    layer of the shared block has a KV cache of its own)."""
    return [[blocks_mod.init_block_cache(cfg, _mixer(mixer), ffn, batch,
                                         max_len, dtype, device)
             for mixer, ffn in segment_layers(cfg, si)]
            for si in range(len(cfg.segments()))]


def _mixer(kind: str) -> str:
    """The block kind a layer runs: the shared block is an ``"attn"``
    block."""
    return "attn" if kind == "shared_attn" else kind


@dataclass
class BackboneOutput:
    logits: torch.Tensor                               # final (server) logits
    exit_logits: Tuple[Optional[torch.Tensor], ...]    # one per exit boundary
    aux_loss: torch.Tensor                             # MoE load balance, fp32
    cache: Optional[list]                              # updated in place


def add_aux(total: Optional[torch.Tensor], aux: Optional[torch.Tensor]
            ) -> Optional[torch.Tensor]:
    """``total + aux``, where ``None`` stands for no router loss."""
    if aux is None:
        return total
    return aux if total is None else total + aux


def segment_forward(params: dict, cfg: ModelConfig, si: int, x: torch.Tensor,
                    positions: torch.Tensor, cache: Optional[list] = None,
                    cache_len: Optional[torch.Tensor] = None,
                    remat: bool = False, moe_groups: int = 1,
                    enc: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layers of segment ``si`` -> ``(x, aux)``: ``aux`` sums the MoE
    blocks' router losses (``None`` in a segment without one).  ``params``
    holds ``"segments"`` and, for Zamba2, ``"shared_attn"``, which every
    shared layer runs.  The caches are updated in place.  ``remat``
    checkpoints each block (no cache): its activations are recomputed in
    the backward pass instead of kept.  ``moe_groups``: the routing groups
    of ``models/moe.py``.  ``enc`` (B, S, d), the projected encoder
    states, feeds the blocks' cross attention."""
    aux = None
    for li, (kind, ffn) in enumerate(segment_layers(cfg, si)):
        p = (params["shared_attn"] if kind == "shared_attn"
             else params["segments"][si][li])
        mixer = _mixer(kind)
        if remat:
            x, a = checkpoint(
                lambda h, p=p, mixer=mixer, ffn=ffn: blocks_mod.block_forward(
                    p, h, positions, cfg, mixer, ffn,
                    moe_groups=moe_groups, enc=enc)[::2],
                x, use_reentrant=False)
        else:
            x, _, a = blocks_mod.block_forward(
                p, x, positions, cfg, mixer, ffn,
                cache=cache[si][li] if cache is not None else None,
                cache_len=cache_len, moe_groups=moe_groups, enc=enc)
        aux = add_aux(aux, a)
    return x, aux


def backbone_forward(params: dict, cfg: ModelConfig, *,
                     tokens: Optional[torch.Tensor] = None,
                     embeds: Optional[torch.Tensor] = None,
                     enc: Optional[torch.Tensor] = None,
                     split_ids: Optional[torch.Tensor] = None,
                     cache: Optional[list] = None,
                     cache_len: Optional[torch.Tensor] = None,
                     exit_heads: Optional[Iterable[int]] = None,
                     remat: bool = False,
                     moe_groups: int = 1) -> BackboneOutput:
    """Run the full network.

    tokens     : (B, T) integers, or None when ``embeds`` is given alone.
    embeds     : (B, S, feat) precomputed frontend embeddings (VLM
                 patches), projected by ``params["frontend"]`` and placed
                 *before* the tokens; positions count them.
    enc        : (B, S, feat) stubbed encoder states (audio), projected by
                 ``params["frontend"]`` (where the params hold one) and
                 attended by every block's cross attention.
    split_ids  : (B,) boundary index per example (Hetero-SplitEE training):
                 after boundary ``si`` the residual stream of the examples
                 with ``split_ids == si`` is detached, so the server loss
                 trains only the layers above each example's cut.  ``None``
                 = no split semantics.
    cache      : decode cache from ``init_cache``, updated in place;
                 ``cache_len`` (B,) tokens already written per row.
    exit_heads : the boundaries whose exit logits to compute (``None`` = all,
                 as training needs; the others come back as ``None``).
                 Under ``jit`` XLA drops exit heads nobody reads; eager
                 PyTorch is told instead.
    remat      : recompute each block in the backward pass (training only).
    moe_groups : routing groups the rows form in MoE blocks (``models/
                 moe.py``): 1 routes the whole batch together, as training
                 does; ``B`` routes each row alone, as a decode tick does.
    ``aux_loss`` sums the MoE blocks' router losses (0 without any).
    """
    if remat and cache is not None:
        raise ValueError("remat applies to training; a decode cache was "
                         "given")
    n_seg = len(cfg.segments())
    want = set(range(n_seg - 1) if exit_heads is None else exit_heads)
    enc = frontend_mod.project_enc(params, enc, cfg)
    parts = []
    if embeds is not None and "frontend" in params:
        parts.append(frontend_mod.project(params["frontend"], embeds))
    if tokens is not None:
        parts.append(embed(params["embed"], tokens,
                           cfg.vocab_size).to(cfg.dtype))
    x = torch.cat([t.to(cfg.dtype) for t in parts], dim=1)
    steps = torch.arange(x.shape[1], device=x.device)
    positions = (steps[None] if cache_len is None
                 else cache_len.long()[:, None] + steps)

    exit_logits: List[Optional[torch.Tensor]] = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for si in range(n_seg):
        x, aux = segment_forward(params, cfg, si, x, positions, cache,
                                 cache_len, remat, moe_groups, enc)
        aux_total = add_aux(aux_total, aux)
        if si < n_seg - 1:
            exit_logits.append(
                heads_mod.exit_head(params["exit_heads"][si], x, cfg)
                if si in want else None)
            if split_ids is not None:
                is_cut = (split_ids == si)[:, None, None]
                x = torch.where(is_cut, x.detach(), x)
    logits = heads_mod.lm_head(params["head"], x, cfg)
    return BackboneOutput(logits=logits, exit_logits=tuple(exit_logits),
                          aux_loss=aux_total, cache=cache)

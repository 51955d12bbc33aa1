"""Meta-tensor stand-ins for every input of a step (counterpart of
``repro/launch/inputs.py``): the shapes and dtypes of the port's layout,
allocation-free.  The dry run (``launch/dryrun.py``) turns them into fake
tensors.

The port's trees differ from the JAX package's only in layout: one dict
per layer where JAX stacks runs (``launch.shardings.jax_layout`` restacks
them), and ``cache_len`` one entry per row (the port's decode rows carry
their own positions) where JAX's stand-in is one scalar.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.models import frontend as fe
from repro_torch.models.backbone import init_backbone, init_cache


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig
                      ) -> Dict[str, Any]:
    """Inputs of the fused Hetero-SplitEE train (or prefill) step.  Audio
    ``enc`` follows the JAX stand-in, min(T, ``cross_source_len``) frames;
    the port's training legs (``e2e_train``, phase ``train``) feed all
    ``cross_source_len`` frames (ROADMAP.md Queue 3)."""
    B, T = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {"split_ids": _meta((B,), torch.int32)}
    if cfg.arch_type == "audio":
        specs["enc"] = _meta((B, min(T, cfg.cross_source_len),
                              fe.WHISPER_FRAME_DIM), cfg.dtype)
        specs["tokens"] = _meta((B, T), torch.int32)
        specs["labels"] = _meta((B, T), torch.int32)
    elif cfg.arch_type == "vlm":
        P = fe.NUM_VISION_PATCHES
        t = max(T - P, 1)
        specs["embeds"] = _meta((B, P, fe.SIGLIP_PATCH_DIM), cfg.dtype)
        specs["tokens"] = _meta((B, t), torch.int32)
        specs["labels"] = _meta((B, P + t), torch.int32)
    else:
        specs["tokens"] = _meta((B, T), torch.int32)
        specs["labels"] = _meta((B, T), torch.int32)
    return specs


def serve_input_specs(cfg: ModelConfig, shape: ShapeConfig
                      ) -> Dict[str, Any]:
    """Inputs of the one-token decode step: one new token per row, a cache
    of ``seq_len`` context (``init_cache`` on the meta device), and
    ``cache_len`` (B,) int32."""
    B, S = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {
        "tokens": _meta((B, 1), torch.int32),
        "cache": init_cache(cfg, B, S, cfg.dtype, "meta"),
        "cache_len": _meta((B,), torch.int32),
    }
    if cfg.arch_type == "audio":
        specs["enc"] = _meta((B, cfg.cross_source_len, fe.WHISPER_FRAME_DIM),
                             cfg.dtype)
    # vlm decode: prefix patches already live in the cache; tokens only.
    return specs


class _MetaGenerator:
    """Stands in for a ``torch.Generator``: the initialisers draw on the
    generator's device, and a draw on the meta device allocates
    nothing."""

    device = torch.device("meta")


def abstract_params(cfg: ModelConfig):
    """The parameter tree as meta tensors (``init_backbone`` on the meta
    device: nothing allocated, nothing drawn)."""
    return init_backbone(_MetaGenerator(), cfg)

"""Stub modality frontends (counterpart of ``repro/models/frontend.py``;
the one allowed carve-out, docs/DESIGN.md §4).

Audio and VLM architectures take *precomputed* frame or patch embeddings
of the right shape (zeros or seeded arrays stand in for audio and images);
this module holds only the linear projector that maps the frontend's
feature dim into ``d_model``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.common import fan_in_init

# feature dims of the (stubbed) frontends
WHISPER_FRAME_DIM = 768          # whisper-small encoder state dim
SIGLIP_PATCH_DIM = 1152          # SigLIP-So400m patch embedding dim
NUM_VISION_PATCHES = 256         # paligemma 224px / 14px patches
WHISPER_SOURCE_LEN = 1500        # 30 s of audio after conv striding


def init_projector(in_dim: int, cfg: ModelConfig, generator,
                   device) -> dict:
    return {"w": fan_in_init((in_dim, cfg.d_model), cfg.param_dtype,
                             generator, device)}


def project(params: dict, feats: torch.Tensor) -> torch.Tensor:
    """(B, S, feat) -> (B, S, d_model), one plain matrix product in the
    promoted dtype of the two operands (as ``jnp.einsum`` promotes)."""
    w = params["w"]
    dt = torch.promote_types(feats.dtype, w.dtype)
    return feats.to(dt) @ w.to(dt)


def project_enc(params: dict, enc: Optional[torch.Tensor],
                cfg: ModelConfig) -> Optional[torch.Tensor]:
    """The encoder states cross attention reads: ``enc`` projected through
    ``params["frontend"]`` and cast to ``cfg.dtype`` where ``params`` (a
    backbone's, or one side's of the split model) holds the projector;
    ``enc`` as it is where they do not, and None for None."""
    if enc is None or "frontend" not in params:
        return enc
    return project(params["frontend"], enc).to(cfg.dtype)


def stub_enc(cfg: ModelConfig, batch: int, device) -> Optional[torch.Tensor]:
    """The documented zeros stub of the encoder states that the JAX
    package's serving and split-model paths feed a cross-attending config:
    (batch, ``cfg.cross_source_len``, ``WHISPER_FRAME_DIM``) in
    ``cfg.dtype``, unprojected; None for a config without cross
    attention.  Its projection is zero, so cross attention then adds
    exactly 0 (ROADMAP.md Queue 3)."""
    if not cfg.cross_attention:
        return None
    return torch.zeros((batch, cfg.cross_source_len, WHISPER_FRAME_DIM),
                       dtype=cfg.dtype, device=device)


def frontend_batch(cfg: ModelConfig, toks: np.ndarray, labels: np.ndarray,
                   rng: np.random.Generator, device,
                   patches: int = NUM_VISION_PATCHES) -> dict:
    """One training batch of ``cfg`` from a (B, T) token batch, with the
    stub frontend's inputs drawn from ``rng`` (standard normal, in
    ``cfg.dtype``): audio adds ``enc`` (B, ``cross_source_len``, 768); VLM
    puts ``embeds`` (B, ``patches``, 1152) before the first
    max(T - ``patches``, 1) tokens, and its labels cover the patches
    (labelled 0) and the tokens.  Other configs get the tokens and labels
    as they are."""
    B, T = toks.shape
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    draw = lambda *shape: torch.as_tensor(  # noqa: E731
        rng.standard_normal(shape, dtype=np.float32),
        device=device).to(cfg.dtype)
    if cfg.arch_type == "audio":
        return {"tokens": as_t(toks), "labels": as_t(labels),
                "enc": draw(B, cfg.cross_source_len, WHISPER_FRAME_DIM)}
    if cfg.arch_type == "vlm":
        P = patches
        t = max(T - P, 1)
        return {"tokens": as_t(toks[:, :t]),
                "labels": as_t(np.concatenate(
                    [np.zeros((B, P), labels.dtype), labels[:, :t]], 1)),
                "embeds": draw(B, P, SIGLIP_PATCH_DIM)}
    return {"tokens": as_t(toks), "labels": as_t(labels)}

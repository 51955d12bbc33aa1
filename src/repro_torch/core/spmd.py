"""Step configuration and the gated serve step (counterpart of the serving
part of ``repro/core/spmd.py``; the training steps come with the training
slice)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.config import ModelConfig, SplitEEConfig
from repro_torch.core.losses import softmax_entropy
from repro_torch.kernels import dispatch
from repro_torch.models.backbone import backbone_forward


@dataclass(frozen=True)
class StepConfig:
    model: ModelConfig
    splitee: SplitEEConfig
    train: Any = None                 # TrainConfig, with the training slice
    grad_mode: str = "eq1"            # "eq1" | "sum"


def make_serve_step(sc: StepConfig, boundary: int = 0) -> Callable:
    """One decode step with the Alg. 3 entropy gate at the client boundary:
    both the exit and the full path are computed and each row selects.

    ``boundary`` indexes ``sorted(cfg.exit_layers)``, the order
    ``backbone_forward`` emits ``exit_logits`` in.  The returned
    ``serve_step(params, tokens, cache, cache_len, tau=None)`` takes
    ``tau`` as a float or one threshold per row on the device (defaults to
    ``sc.splitee.entropy_threshold``); ``cache`` is updated in place."""
    cfg = sc.model
    tau_default = sc.splitee.entropy_threshold
    backend = dispatch.backend_for(cfg)

    def serve_step(params, tokens, cache, cache_len, tau=None):
        tau_ = tau_default if tau is None else tau
        out = backbone_forward(params, cfg, tokens=tokens, cache=cache,
                               cache_len=cache_len, exit_heads=(boundary,))
        if cfg.exit_layers:
            e_logits = out.exit_logits[boundary]
            H, exit_now = backend.entropy_gate(e_logits, tau_)   # (B, T)
            final = torch.where(exit_now[..., None], e_logits, out.logits)
        else:
            H = softmax_entropy(out.logits)
            exit_now = torch.zeros_like(H, dtype=torch.bool)
            final = out.logits
        return {"logits": final, "exited": exit_now, "entropy": H,
                "cache": out.cache}

    return serve_step

"""Confidence measure for Hetero-SplitEE (counterpart of
``repro/core/losses.py``; the training losses come with the training
slice)."""
from __future__ import annotations

import torch


def softmax_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Paper Alg. 3: H = -sum_j p_j log p_j, computed stably in fp32.
    Returns shape logits.shape[:-1]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(logp.exp() * logp).sum(dim=-1)

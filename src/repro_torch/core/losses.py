"""Losses and confidence measures for Hetero-SplitEE (counterpart of
``repro/core/losses.py``): the training cross-entropy and accuracy, and
the Alg. 3 entropy."""
from __future__ import annotations

from typing import Optional

import torch


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean CE in fp32.  logits (..., V), labels (...) integers; ``mask``
    (...) selects the contributing elements (the mean is over them)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    ce = logz - gold
    if mask is None:
        return ce.mean()
    m = mask.float()
    return (ce * m).sum() / torch.clamp(m.sum(), min=1.0)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    hit = (logits.argmax(dim=-1) == labels).float()
    if mask is None:
        return hit.mean()
    m = mask.float()
    return (hit * m).sum() / torch.clamp(m.sum(), min=1.0)


def softmax_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Paper Alg. 3: H = -sum_j p_j log p_j, computed stably in fp32.
    Returns shape logits.shape[:-1]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(logp.exp() * logp).sum(dim=-1)

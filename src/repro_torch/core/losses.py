"""Losses and confidence measures for Hetero-SplitEE (counterpart of
``repro/core/losses.py``): the training cross-entropy and accuracy, and
the Alg. 3 entropy.  Logits that a vocab-parallel head left split over an
active ``"model"`` group (``launch/tensor_parallel.py``; ``vocab`` names
the whole V) take the vocab-parallel cross entropy and argmax."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.launch import tensor_parallel as tp


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          vocab: int = 0) -> torch.Tensor:
    """Mean CE in fp32.  logits (..., V), labels (...) integers; ``mask``
    (...) selects the contributing elements (the mean is over them).
    ``vocab``: the whole V, where ``logits`` may be this rank's chunk
    (required under an active model group, ``tp.vocab_split``)."""
    if tp.vocab_split(logits.shape[-1], vocab):
        ce = tp.vocab_cross_entropy(logits, labels)
    else:
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        ce = logz - gold
    if mask is None:
        return ce.mean()
    m = mask.float()
    return (ce * m).sum() / torch.clamp(m.sum(), min=1.0)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None,
             vocab: int = 0) -> torch.Tensor:
    pick = (tp.vocab_argmax(logits) if tp.vocab_split(logits.shape[-1], vocab)
            else logits.argmax(dim=-1))
    hit = (pick == labels).float()
    if mask is None:
        return hit.mean()
    m = mask.float()
    return (hit * m).sum() / torch.clamp(m.sum(), min=1.0)


def softmax_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Paper Alg. 3: H = -sum_j p_j log p_j, computed stably in fp32.
    Returns shape logits.shape[:-1]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(logp.exp() * logp).sum(dim=-1)

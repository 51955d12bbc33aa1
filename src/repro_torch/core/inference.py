"""Algorithm 3: entropy-gated adaptive client/server inference
(counterpart of ``repro/core/inference.py``).

The paper writes confidence C = -H and sweeps tau in [0, 4] with "larger
tau => more conservative"; since C <= 0 < tau that literal predicate never
fires.  The JAX package, and so the port, implement the consistent
reading **exit iff H < tau_H**, and report the paper's axis as
``tau_paper = H_CAP - tau_H``.

The gate is the kernel backend's ``entropy_gate``: on CUDA tensors the
kernel of ``kernels/csrc/entropy_exit.cu``, on CPU tensors its plain
version.  ``AdaptiveInferenceEngine`` is the host-side router: it runs the
client net, gates each request on its exit head's entropy, and sends only
the requests below the confidence bar to the server.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.kernels.dispatch import get_backend

H_CAP = 4.0     # the paper's sweep upper bound (~ln(55))


def exit_decision(logits: torch.Tensor, tau) -> torch.Tensor:
    """True where the early exit is confident enough (H < tau)."""
    return get_backend("auto").entropy_gate(logits, tau)[1]


def paper_tau_to_entropy(tau_paper: float) -> float:
    """The paper's conservativeness knob as an entropy threshold."""
    return H_CAP - tau_paper


@dataclass
class AdaptiveStats:
    total: int = 0
    exited: int = 0
    entropy_sum: float = 0.0

    @property
    def client_ratio(self) -> float:
        return self.exited / max(1, self.total)

    @property
    def mean_entropy(self) -> float:
        return self.entropy_sum / max(1, self.total)


class AdaptiveInferenceEngine:
    """Routes a batch of requests through the client net and offloads the
    low-confidence rest to the server, padded to a multiple of
    ``pad_bucket`` rows so the server sees few distinct shapes."""

    def __init__(self, client_fn: Callable, server_fn: Callable, tau: float,
                 pad_bucket: int = 8):
        self.client_fn = client_fn            # x -> (h, exit_logits)
        self.server_fn = server_fn            # h -> logits
        self.tau = tau
        self.pad_bucket = pad_bucket
        self.stats = AdaptiveStats()

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        h, exit_logits = self.client_fn(x)
        H, exit_mask = get_backend("auto").entropy_gate(exit_logits,
                                                        self.tau)
        preds = exit_logits.argmax(dim=-1)
        idx = torch.nonzero(~exit_mask).flatten()
        n = len(idx)
        if n:
            padded = -(-n // self.pad_bucket) * self.pad_bucket
            sel = torch.cat([idx, idx[-1:].expand(padded - n)])
            preds[idx] = self.server_fn(h[sel])[:n].argmax(dim=-1)
        self.stats.total += len(x)
        self.stats.exited += len(x) - n
        self.stats.entropy_sum += H.sum().item()
        return preds

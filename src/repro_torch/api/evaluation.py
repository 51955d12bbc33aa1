"""Batched evaluation over a ``TrainState`` (counterpart of
``repro/api/evaluation.py``).

The test set is padded to whole batches with a validity mask, so the tail
batch is scored, not dropped.  Per client, the batches' sums accumulate
in one 5-vector on the device and the host reads it once.  Each client's
nets come from ``state.nets``: a state kept as each rank's chunks (the
spmd engine's) gathers one client's nets at a time, on every rank.  The Alg. 3
gate is the kernel backend's ``entropy_gate``: on the card the kernel of
``kernels/csrc/entropy_exit.cu``, on the CPU its plain version (the JAX
evaluator computes the same entropy with plain ``softmax_entropy``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.api.state import TrainState
from repro_torch.config import HeteroProfile
from repro_torch.kernels.dispatch import get_backend

# the accumulator's layout
_CLIENT_OK, _SERVER_OK, _ADAPTIVE_OK, _EXITS, _ENT_SUM = range(5)


def pad_batches(x: np.ndarray, y: np.ndarray, batch_size: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """A test set as ``[nb, B, ...]`` whole batches plus a 0/1 validity
    mask, the tail batch padded by repeating the last sample.  Returns
    ``(xb, yb, mask, n)`` with ``mask.sum() == n == len(x)``."""
    n = len(x)
    if n == 0:
        raise ValueError("cannot evaluate an empty dataset")
    bs = min(batch_size, n)
    nb = -(-n // bs)
    pad = nb * bs - n
    if pad:
        x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
        y = np.concatenate([y, np.repeat(y[-1:], pad, axis=0)])
    mask = np.zeros((nb * bs,), np.float32)
    mask[:n] = 1.0
    return (x.reshape(nb, bs, *x.shape[1:]), y.reshape(nb, bs),
            mask.reshape(nb, bs), n)


class SplitEvaluator:
    """Per-client accuracy of the client's exit, of its server, and of the
    entropy-gated choice between them (Alg. 3)."""

    def __init__(self, model, profile: HeteroProfile, strategy: str):
        self.model = model
        self.profile = profile
        self.strategy = strategy

    @torch.no_grad()
    def _sums(self, li: int, client, server, xb, yb, mask, tau: float
              ) -> np.ndarray:
        model, gate = self.model, get_backend("auto").entropy_gate
        acc = torch.zeros(5, dtype=torch.float32, device=xb.device)
        for x, y, m in zip(xb, yb, mask):
            h, clog, _ = model.client_forward(client["trainable"],
                                              client["state"], x, train=False)
            slog, _ = model.server_forward(server["trainable"],
                                           server["state"], h, li,
                                           train=False)
            cpred, spred = clog.argmax(dim=-1), slog.argmax(dim=-1)
            H, exits = gate(clog, tau)             # Alg. 3: exit iff H < tau
            apred = torch.where(exits, cpred, spred)
            acc += torch.stack([((cpred == y) * m).sum(),
                                ((spred == y) * m).sum(),
                                ((apred == y) * m).sum(),
                                (exits * m).sum(),
                                (H * m).sum()])
        return acc.cpu().numpy()                   # one host read a client

    def _per_client_sums(self, state: TrainState, x, y, tau: float,
                         batch_size: int) -> Tuple[List[np.ndarray], int]:
        xb, yb, mask, n = pad_batches(np.asarray(x), np.asarray(y),
                                      batch_size)
        dev = self.model.device
        xb, yb, mask = (torch.from_numpy(a).to(dev) for a in (xb, yb, mask))
        out = []
        for i, li in enumerate(self.profile.split_layers):
            sidx = 0 if self.strategy == "sequential" else i
            client, server = state.nets(i, sidx)
            out.append(self._sums(li, client, server, xb, yb, mask, tau))
            del client, server
        return out, n

    def evaluate(self, state: TrainState, x, y, batch_size: int = 512
                 ) -> Dict[str, Any]:
        """Per-client accuracy of the exit and of the server over the full
        test set (tail batch included)."""
        sums, n = self._per_client_sums(state, x, y, 0.0, batch_size)
        return {"client_acc": [float(s[_CLIENT_OK]) / n for s in sums],
                "server_acc": [float(s[_SERVER_OK]) / n for s in sums],
                "split_layers": list(self.profile.split_layers)}

    def evaluate_adaptive(self, state: TrainState, x, y, tau: float,
                          batch_size: int = 512) -> Dict[str, Any]:
        """Alg. 3 collaborative inference at entropy threshold ``tau``
        (exit iff H < tau)."""
        sums, n = self._per_client_sums(state, x, y, tau, batch_size)
        return {"acc": [float(s[_ADAPTIVE_OK]) / n for s in sums],
                "client_ratio": [float(s[_EXITS]) / n for s in sums],
                "mean_entropy": [float(s[_ENT_SUM]) / n for s in sums]}

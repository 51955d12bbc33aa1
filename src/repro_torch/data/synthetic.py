"""Synthetic token streams (a copy of ``repro/data/synthetic.py``'s
``SyntheticLMDataset``; numpy only, so both packages draw the same
batches from the same seed).

Each sequence follows t_{i+1} = (a*t_i + b) mod V on ``structure`` of its
steps and uniform noise otherwise, which a small transformer learns
quickly."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass
class SyntheticLMDataset:
    vocab_size: int = 32_000
    seq_len: int = 256
    seed: int = 0
    structure: float = 0.9          # fraction of affine next-token steps

    def batches(self, batch_size: int, num_batches: int
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        V, T = self.vocab_size, self.seq_len
        for _ in range(num_batches):
            a = rng.integers(1, 64, size=(batch_size, 1))
            b = rng.integers(0, V, size=(batch_size, 1))
            toks = np.empty((batch_size, T + 1), np.int64)
            toks[:, 0] = rng.integers(0, V, size=batch_size)
            for t in range(T):
                nxt = (a[:, 0] * toks[:, t] + b[:, 0]) % V
                noise = rng.integers(0, V, size=batch_size)
                use_noise = rng.random(batch_size) > self.structure
                toks[:, t + 1] = np.where(use_noise, noise, nxt)
            yield toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)

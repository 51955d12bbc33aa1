"""Host-side data pipeline: a copy of ``repro/data/pipeline.py`` (numpy
only, so both packages draw the same batches from the same seeds).  IID
and Dirichlet client partitioning (paper §IV-A), the seeded batch
iterators, and the group-contiguous global batch of the fused step
(client group g owns slice g of the batch)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class ClientPartitioner:
    """Uniform-at-random IID split of (x, y) across N clients.  The same
    partition (same seed) is reused by every strategy/baseline so that
    'observed performance differences isolate the effect of collaborative
    aggregation' (paper §IV-A4)."""

    num_clients: int
    seed: int = 0

    def split(self, x: np.ndarray, y: np.ndarray
              ) -> List[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(len(x))
        shards = np.array_split(perm, self.num_clients)
        return [(x[s], y[s]) for s in shards]


@dataclass
class DirichletPartitioner:
    """Label-skewed non-IID split of (x, y) across N clients.

    For each class, per-client proportions are drawn from
    ``Dirichlet(alpha, ..., alpha)`` and the class's (shuffled) examples
    are sliced accordingly — the standard federated non-IID construction
    (Hsu et al., 2019; used by FedSplitX/AdaSplit for heterogeneous-client
    evaluation).  Small ``alpha`` concentrates each class on few clients
    (heavy skew); large ``alpha`` approaches the IID
    :class:`ClientPartitioner`.  Shards are disjoint and exhaustive by
    construction.  ``min_size > 0`` rebalances by moving examples from the
    largest shard until every shard holds at least ``min_size`` examples
    (so every client can fill a whole staged batch)."""

    num_clients: int
    alpha: float = 0.5
    seed: int = 0
    min_size: int = 0

    def split(self, x: np.ndarray, y: np.ndarray
              ) -> List[Tuple[np.ndarray, np.ndarray]]:
        if self.alpha <= 0:
            raise ValueError(f"alpha must be > 0, got {self.alpha}")
        if self.min_size * self.num_clients > len(x):
            raise ValueError(
                f"min_size={self.min_size} x {self.num_clients} clients "
                f"exceeds the {len(x)} available examples")
        rng = np.random.default_rng(self.seed)
        y = np.asarray(y)
        parts: List[List[np.ndarray]] = [[] for _ in range(self.num_clients)]
        for c in np.unique(y):
            idx = np.flatnonzero(y == c)
            rng.shuffle(idx)
            p = rng.dirichlet(np.full(self.num_clients, self.alpha))
            cuts = (np.cumsum(p)[:-1] * len(idx)).astype(int)
            for i, sl in enumerate(np.split(idx, cuts)):
                parts[i].append(sl)
        shards = [np.sort(np.concatenate(p)) if p else
                  np.empty((0,), np.int64) for p in parts]
        if self.min_size > 0:
            shards = self._rebalance(shards, rng)
        return [(x[s], y[s]) for s in shards]

    def _rebalance(self, shards: List[np.ndarray], rng
                   ) -> List[np.ndarray]:
        sizes = np.array([len(s) for s in shards])
        while sizes.min() < self.min_size:
            src, dst = int(np.argmax(sizes)), int(np.argmin(sizes))
            need = min(self.min_size - sizes[dst],
                       sizes[src] - self.min_size)
            take = rng.choice(len(shards[src]), size=int(need),
                              replace=False)
            moved = shards[src][take]
            shards[src] = np.delete(shards[src], take)
            shards[dst] = np.sort(np.concatenate([shards[dst], moved]))
            sizes = np.array([len(s) for s in shards])
        return shards


def effective_batch_size(n: int, batch_size: int) -> int:
    """The batch size :func:`batch_iterator` actually emits for a shard of
    ``n`` samples: tiny client shards fall back to full-shard batches.  The
    single source of truth for every consumer (cohort stacking is
    validated against this)."""
    return min(batch_size, n)


def batch_iterator(x: np.ndarray, y: np.ndarray, batch_size: int, *,
                   seed: int = 0, augment=None, epochs: int = 1_000_000
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    n = len(x)
    bs = effective_batch_size(n, batch_size)
    for _ in range(epochs):
        perm = rng.permutation(n)
        for i in range(0, n - bs + 1, bs):
            idx = perm[i : i + bs]
            bx = x[idx]
            if augment is not None:
                bx = augment(rng, bx)
            yield bx, y[idx]


def prestage_batches(it: Iterator[Tuple[np.ndarray, np.ndarray]],
                     rounds: int, local_epochs: int,
                     out: Optional[Tuple[np.ndarray, np.ndarray]] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Draw ``rounds * local_epochs`` consecutive batches from a
    :func:`batch_iterator` into ``[rounds, local_epochs, B, ...]`` host
    tensors, ready to be moved to the device once.  Consuming the *same*
    iterator the reference engine would consume keeps the minibatch
    sequence bit-identical between engines.

    Each drawn batch is written straight into its slot — one host copy per
    batch, instead of the list + ``np.stack`` + ``reshape`` path that held
    two full extra copies of every chunk.  ``out=(bx, by)`` fills
    caller-owned buffers in place (the engines pass views into the
    preallocated cohort-stacked chunk, eliminating the lane-stacking copy
    as well); buffers may be non-contiguous views but must have the
    ``[rounds, local_epochs, ...batch shape]`` leading layout."""
    bx = by = None
    if out is not None:
        bx, by = out
    for r in range(rounds):
        for e in range(local_epochs):
            x, y = next(it)
            if bx is None:
                bx = np.empty((rounds, local_epochs, *x.shape), x.dtype)
                by = np.empty((rounds, local_epochs, *y.shape), y.dtype)
            bx[r, e] = x
            by[r, e] = y
    return bx, by


def global_hetero_batch(client_batches: Sequence[Tuple[np.ndarray, np.ndarray]],
                        split_boundary_ids: Sequence[int]
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Assemble the fused-SPMD global batch: concatenate per-client batches in
    group order and emit the per-example split-boundary id vector."""
    xs = np.concatenate([b[0] for b in client_batches], axis=0)
    ys = np.concatenate([b[1] for b in client_batches], axis=0)
    ids = np.concatenate([
        np.full((len(b[0]),), sid, np.int32)
        for b, sid in zip(client_batches, split_boundary_ids)
    ])
    return xs, ys, ids

"""The simulated client pool and its staging cursor (a copy of
``repro/population/population.py``).

:class:`ClientPopulation` owns P simulated clients (split point, data
shard, availability/straggler knobs) plus the profile-shaped slot layout
and the :class:`~repro_torch.population.schedule.ParticipationSchedule` that
maps clients onto slots every round.  :class:`PopulationCursor` is the
engines' staging interface: per round it materializes the plan's slot
batches from each assigned client's seeded iterator — the population
analogue of ``repro_torch.api.engines.DataCursor``, addressed by round index
instead of per-slot draw counts (the schedule is a pure function of the
round, so a restored session replays rounds ``[0, t)`` to reproduce the
exact upcoming batch sequence).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.pipeline import batch_iterator
from repro_torch.population.schedule import (ParticipationPlan,
                                             ParticipationSchedule)


@dataclass
class PopulationClient:
    """One simulated device: a data shard plus resource/availability knobs.

    ``availability`` is the per-round probability the client is reachable
    at all (churn); ``straggler_rate`` the probability an assigned client
    exceeds its round deadline; ``step_budget`` a deterministic cap — the
    client straggles whenever a round asks for more than ``step_budget``
    local steps (the paper's heterogeneous-capability axis)."""

    cid: int
    split: int
    x: np.ndarray = field(repr=False)
    y: np.ndarray = field(repr=False)
    availability: float = 1.0
    straggler_rate: float = 0.0
    step_budget: Optional[int] = None


class ClientPopulation:
    """A pool of simulated clients scheduled onto fixed cohort slots."""

    def __init__(self, clients: Sequence[PopulationClient],
                 slot_splits: Sequence[int], *,
                 participation_rate: float = 1.0, churn_seed: int = 0,
                 kind: str = "shards", alpha: Optional[float] = None):
        if not clients:
            raise ValueError("a ClientPopulation needs at least one client")
        self.clients = list(clients)
        self.slot_splits = tuple(int(s) for s in slot_splits)
        self.kind = kind
        self.alpha = alpha
        self.schedule = ParticipationSchedule(
            [c.split for c in self.clients], self.slot_splits,
            participation_rate=participation_rate, churn_seed=churn_seed,
            availability=[c.availability for c in self.clients],
            straggler_rates=[c.straggler_rate for c in self.clients],
            step_budgets=[c.step_budget for c in self.clients])

    # ------------------------------------------------------- constructors
    @classmethod
    def from_shards(cls, shards: Sequence[Tuple[np.ndarray, np.ndarray]],
                    splits: Sequence[int], *,
                    slot_splits: Optional[Sequence[int]] = None,
                    availability: Optional[Sequence[float]] = None,
                    straggler_rates: Optional[Sequence[float]] = None,
                    step_budgets: Optional[Sequence[Optional[int]]] = None,
                    participation_rate: float = 1.0,
                    churn_seed: int = 0) -> "ClientPopulation":
        """Population from explicit per-client shards and split points.
        With ``slot_splits`` omitted the population is slot-shaped (P == E,
        client i homed on slot i under full participation) — the
        participation-parity configuration the CI gate exercises."""
        P = len(shards)
        if len(splits) != P:
            raise ValueError(f"{P} shards but {len(splits)} split points")
        avail = list(availability) if availability is not None else [1.0] * P
        strag = (list(straggler_rates) if straggler_rates is not None
                 else [0.0] * P)
        budget = list(step_budgets) if step_budgets is not None else [None] * P
        clients = [PopulationClient(i, int(splits[i]), shards[i][0],
                                    shards[i][1], availability=avail[i],
                                    straggler_rate=strag[i],
                                    step_budget=budget[i])
                   for i in range(P)]
        return cls(clients, slot_splits if slot_splits is not None else splits,
                   participation_rate=participation_rate,
                   churn_seed=churn_seed, kind="shards")

    @classmethod
    def dirichlet(cls, x: np.ndarray, y: np.ndarray, num_clients: int,
                  slot_splits: Sequence[int], *, alpha: float = 0.5,
                  seed: int = 0, participation_rate: float = 1.0,
                  churn_seed: int = 0, straggler_rate: float = 0.0,
                  availability: float = 1.0,
                  min_shard: int = 1) -> "ClientPopulation":
        """Population over a non-IID label-skewed Dirichlet partition of
        ``(x, y)``.  Client i's split point cycles ``slot_splits`` so every
        cohort always has candidates in proportion to its slot count; pass
        ``min_shard >= batch_size`` so every shard can fill a full staged
        batch (the session validates this at bind time)."""
        from repro_torch.data.pipeline import DirichletPartitioner
        shards = DirichletPartitioner(num_clients, alpha=alpha, seed=seed,
                                      min_size=min_shard).split(x, y)
        splits = [int(slot_splits[i % len(slot_splits)])
                  for i in range(num_clients)]
        pop = cls.from_shards(
            shards, splits, slot_splits=slot_splits,
            availability=[availability] * num_clients,
            straggler_rates=[straggler_rate] * num_clients,
            participation_rate=participation_rate, churn_seed=churn_seed)
        pop.kind, pop.alpha = "dirichlet", float(alpha)
        return pop

    # --------------------------------------------------------- properties
    @property
    def num_clients(self) -> int:
        return len(self.clients)

    @property
    def num_slots(self) -> int:
        return len(self.slot_splits)

    def shard_sizes(self) -> List[int]:
        return [len(c.x) for c in self.clients]

    # -------------------------------------------------------- session API
    def validate_for(self, profile_split_layers: Sequence[int],
                     batch_size: int) -> None:
        """Raise unless this population can drive a session with the given
        profile: the slot layout must equal the profile's split layers
        (slots ARE the profile's client groups), and every shard must fill
        a whole staged batch — cohort lanes are stacked into one fixed
        ``[k, B, ...]`` tensor, so a short shard would change staged shapes
        depending on which client lands on the slot."""
        if tuple(self.slot_splits) != tuple(profile_split_layers):
            raise ValueError(
                f"population slot layout {self.slot_splits} does not match "
                f"the profile's split layers "
                f"{tuple(profile_split_layers)}")
        short = {c.cid: len(c.x) for c in self.clients
                 if len(c.x) < batch_size}
        if short:
            raise ValueError(
                f"population shards {short} are smaller than "
                f"batch_size={batch_size}; every client must fill a whole "
                f"staged batch (shrink batch_size, or repartition with "
                f"min_shard >= batch_size)")

    def slot_stubs(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Per-slot placeholder shards for the parts of the engine stack
        that size buffers/shardings from ``ctx.client_data`` (effective
        batch size, staging budget, spmd batch shardings).  Every slot of a
        cohort gets the same view — its cohort's first client's shard — so
        effective batch sizes stay uniform; the actual staged batches come
        from :class:`PopulationCursor`, never from these stubs."""
        first_of = {}
        for c in self.clients:
            first_of.setdefault(c.split, (c.x, c.y))
        return [first_of[li] for li in self.slot_splits]

    def meta(self) -> Dict:
        """Checkpoint-manifest fingerprint: everything that determines the
        participation schedule and the per-client data replay."""
        return {
            "num_clients": self.num_clients,
            "kind": self.kind,
            "alpha": self.alpha,
            "shard_sizes": self.shard_sizes(),
            "schedule": self.schedule.signature(),
        }

    def check_meta(self, saved: Dict) -> None:
        """Validate this population against a checkpoint's recorded
        fingerprint; any mismatch means the resumed run would replay a
        different participation schedule or batch stream."""
        mine = self.meta()
        diff = sorted(k for k in set(mine) | set(saved)
                      if mine.get(k) != saved.get(k))
        if diff:
            raise ValueError(
                f"population mismatch on restore: field(s) {diff} differ "
                f"from the checkpoint (saved "
                f"{ {k: saved.get(k) for k in diff} }, got "
                f"{ {k: mine.get(k) for k in diff} }); the resumed run "
                f"would replay a different participation schedule")


class PopulationCursor:
    """Round-addressed staging streams for a population session.

    Draw rule: a client draws ``local_epochs`` batches in a round iff its
    slot mask is 1 (assigned and not straggling) — stragglers' discarded
    work is not simulated, so their batch streams do not advance.
    ``align(t)`` reuses the live iterators when the cursor already sits at
    round ``t`` (run-after-run) and otherwise rebuilds from the seed and
    replays rounds ``[0, t)``, which reproduces the exact upcoming plan
    and batch sequence after a checkpoint restore.  Replay assumes the run
    used one ``local_epochs`` throughout (it enters the step-budget
    straggler rule), matching how the engines call it."""

    def __init__(self, population: ClientPopulation, batch_size: int,
                 seed: int):
        self.pop = population
        self.batch_size = batch_size
        self.seed = seed
        self._iters: Optional[List] = None
        self._round = 0

    def _rebuild(self) -> None:
        # seeded seed + cid, mirroring DataCursor's seed + i: a population
        # whose first K clients mirror a fixed K-client session draws the
        # identical batch streams (the participation-parity contract)
        self._iters = [batch_iterator(c.x, c.y, self.batch_size,
                                      seed=self.seed + c.cid)
                       for c in self.pop.clients]
        self._round = 0

    def align(self, t: int, local_epochs: int) -> None:
        if self._iters is not None and self._round == int(t):
            return
        self._rebuild()
        for _ in range(int(t)):
            self.next_round(local_epochs, _discard=True)

    def next_round(self, local_epochs: int, _discard: bool = False
                   ) -> Tuple[ParticipationPlan,
                              Dict[int, List[Tuple[np.ndarray, np.ndarray]]]]:
        """The next round's plan plus ``{slot: [batch, ...]}`` for every
        active slot (``local_epochs`` batches each)."""
        assert self._iters is not None, "align() before next_round()"
        plan = self.pop.schedule.plan(self._round, local_epochs)
        slot_batches: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}
        for e, cid in enumerate(plan.slot_client):
            if cid < 0 or plan.slot_mask[e] <= 0:
                continue
            drawn = [next(self._iters[cid]) for _ in range(local_epochs)]
            if not _discard:
                slot_batches[e] = drawn
        self._round += 1
        return plan, slot_batches

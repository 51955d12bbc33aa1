"""Seeded per-round participation schedules for simulated client pools
(a copy of ``repro/population/schedule.py``).

A :class:`ParticipationSchedule` is a *pure function* of its configuration
and the round index: ``plan(t)`` derives every draw from
``np.random.default_rng([churn_seed, t])``, so the schedule for any round
can be recomputed at any time — a restored session replays the identical
remaining schedule without serializing per-round state (the session
manifest records only the schedule's configuration fingerprint).

Per round the schedule:

  1. samples client *availability* (seeded Bernoulli per client, churn),
  2. samples which cohort slots *participate* this round
     (``participation_rate``, partial participation a la FedAvg),
  3. assigns available clients to their cohort's participating slots —
     ascending client id onto ascending slot id, with a seeded subsample
     when more candidates are available than slots (so a population whose
     first K clients mirror a fixed K-client cohort maps them onto the
     same lanes: the participation-parity contract),
  4. samples *stragglers* among the assigned clients (seeded rate and/or a
     deterministic per-client ``step_budget`` exceeded by the round's
     ``local_epochs``); stragglers stay assigned but are masked out of the
     round's aggregation — graceful degradation, never a stalled cohort.

The result is a :class:`ParticipationPlan`: the slot->client assignment
plus the per-slot 0/1 participation mask the engine stages to the device
(fixed ``[E]`` shape, so churn never changes a round's launches).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class ParticipationPlan:
    """One round's mapping of active population clients onto cohort slots.

    ``slot_client[e]`` is the population client id assigned to slot ``e``
    (-1 = unfilled); ``slot_mask[e]`` is 1.0 only when the slot is filled
    AND its client did not straggle — exactly the value staged into the
    engine's staged participation mask.  ``stragglers`` lists the client
    ids that were assigned but masked out this round."""

    round: int
    slot_client: Tuple[int, ...]
    slot_mask: Tuple[float, ...]
    stragglers: Tuple[int, ...]

    @property
    def num_active(self) -> int:
        """Slots contributing to this round's aggregation."""
        return int(sum(1 for m in self.slot_mask if m > 0))

    @property
    def num_stragglers(self) -> int:
        return len(self.stragglers)


class ParticipationSchedule:
    """Deterministic availability/assignment/straggler process (see module
    docstring).  All per-client vectors are indexed by population client
    id; ``slot_splits`` is the session profile's ``split_layers``."""

    def __init__(self, client_splits: Sequence[int],
                 slot_splits: Sequence[int], *,
                 participation_rate: float = 1.0,
                 churn_seed: int = 0,
                 availability: Sequence[float] = (),
                 straggler_rates: Sequence[float] = (),
                 step_budgets: Sequence[Optional[int]] = ()):
        P = len(client_splits)
        if not 0.0 < participation_rate <= 1.0:
            raise ValueError(f"participation_rate must be in (0, 1], got "
                             f"{participation_rate}")
        missing = sorted(set(client_splits) - set(slot_splits))
        if missing:
            raise ValueError(
                f"population clients use split layers {missing} that no "
                f"cohort slot offers (slot splits: "
                f"{sorted(set(slot_splits))}); such clients could never be "
                f"scheduled")
        self.client_splits = tuple(int(s) for s in client_splits)
        self.slot_splits = tuple(int(s) for s in slot_splits)
        self.participation_rate = float(participation_rate)
        self.churn_seed = int(churn_seed)
        self.availability = (tuple(float(a) for a in availability)
                            or (1.0,) * P)
        self.straggler_rates = (tuple(float(r) for r in straggler_rates)
                               or (0.0,) * P)
        self.step_budgets = (tuple(step_budgets) or (None,) * P)
        for name, vec in (("availability", self.availability),
                          ("straggler_rates", self.straggler_rates),
                          ("step_budgets", self.step_budgets)):
            if len(vec) != P:
                raise ValueError(f"{name} has {len(vec)} entries for "
                                 f"{P} clients")
        #: cohort cut layer -> its slot indices, ascending
        self._cohort_slots: Dict[int, Tuple[int, ...]] = {
            li: tuple(e for e, s in enumerate(self.slot_splits) if s == li)
            for li in sorted(set(self.slot_splits))}
        #: cohort cut layer -> its population client ids, ascending
        self._cohort_clients: Dict[int, Tuple[int, ...]] = {
            li: tuple(i for i, s in enumerate(self.client_splits) if s == li)
            for li in sorted(set(self.slot_splits))}

    @property
    def num_clients(self) -> int:
        return len(self.client_splits)

    @property
    def num_slots(self) -> int:
        return len(self.slot_splits)

    def plan(self, t: int, local_epochs: int = 1) -> ParticipationPlan:
        """The round-``t`` plan.  Deterministic in ``(config, t,
        local_epochs)`` — ``local_epochs`` only enters the deterministic
        ``step_budget`` straggler check, never the random draws."""
        E, P = self.num_slots, self.num_clients
        rng = np.random.default_rng([self.churn_seed, int(t)])
        # fixed draw order so every plan consumes the same rng sequence
        u_avail = rng.random(P)
        u_slot = rng.random(E)
        u_strag = rng.random(E)

        available = u_avail < np.asarray(self.availability)
        slot_take = u_slot < self.participation_rate

        slot_client = [-1] * E
        stragglers = []
        mask = [0.0] * E
        for li, slots in self._cohort_slots.items():
            open_slots = [e for e in slots if slot_take[e]]
            candidates = [i for i in self._cohort_clients[li]
                          if available[i]]
            if len(candidates) > len(open_slots):
                chosen = sorted(rng.choice(candidates, size=len(open_slots),
                                           replace=False).tolist())
            else:
                chosen = candidates            # already ascending
            for e, i in zip(open_slots, chosen):
                slot_client[e] = i
                straggle = (u_strag[e] < self.straggler_rates[i]
                            or (self.step_budgets[i] is not None
                                and local_epochs > self.step_budgets[i]))
                if straggle:
                    stragglers.append(i)
                else:
                    mask[e] = 1.0
        return ParticipationPlan(int(t), tuple(slot_client), tuple(mask),
                                 tuple(stragglers))

    def signature(self) -> Dict:
        """Schedule configuration fingerprint for checkpoint manifests:
        two sessions with equal signatures replay identical plans."""
        return {
            "client_splits": list(self.client_splits),
            "slot_splits": list(self.slot_splits),
            "participation_rate": self.participation_rate,
            "churn_seed": self.churn_seed,
            "availability": list(self.availability),
            "straggler_rates": list(self.straggler_rates),
            "step_budgets": [b if b is None else int(b)
                             for b in self.step_budgets],
        }

"""Engine registry and the engine contract (counterpart of
``repro/api/engines.py``).

An engine executes the paper's strategies as ``TrainState -> TrainState``:
it receives a state, runs some rounds and returns a new state and the
per-round metrics, leaving the state it was given untouched.  The spmd
engine's state is each rank's chunks (``api.state.ShardedTrainState``),
which its next run takes as its carry; ``Engine.place`` turns a state
into the form an engine's runs take.

The port registers ``"reference"`` (the per-client loop of Alg. 1/2, every
strategy), ``"fused"`` (cohort lanes, Averaging and distributed) and
``"spmd"`` (the fused round body over the ranks of a ``torch.distributed``
world, placed by a sharding recipe).  ``"auto"`` resolves to the widest
engine that can run the session, with a note that says why each wider one
was skipped.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np

from repro_torch.config import OptimizerConfig, SplitEEConfig
from repro_torch.core.spmd import GRAD_MODES
from repro_torch.data.pipeline import batch_iterator, effective_batch_size
from repro_torch.optim import make_schedule
from repro_torch.population import PopulationCursor

class DataCursor:
    """Seeded per-client batch streams addressed by draw count.

    ``align(cursor)`` positions every client's ``batch_iterator`` after the
    given number of drawn batches: the live iterators when the cursor
    matches (one run after another), else rebuilt from the seed and
    replayed, which reproduces the upcoming batches (and augmentation
    draws) after a state rewind."""

    def __init__(self, client_data: Sequence[Tuple[np.ndarray, np.ndarray]],
                 batch_size: int, seed: int, augment=None):
        self.client_data = client_data
        self.batch_size = batch_size
        self.seed = seed
        self.augment = augment
        self._iters: Optional[list] = None
        self._pos: Optional[Tuple[int, ...]] = None

    def align(self, cursor: Sequence[int]) -> None:
        want = tuple(int(c) for c in cursor)
        if self._pos == want:
            return
        self._iters = [
            batch_iterator(x, y, self.batch_size, seed=self.seed + i,
                           augment=self.augment)
            for i, (x, y) in enumerate(self.client_data)]
        for it, k in zip(self._iters, want):
            for _ in range(k):
                next(it)
        self._pos = want

    def draw(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        assert self._iters is not None, "align() before draw()"
        batch = next(self._iters[i])
        pos = list(self._pos)
        pos[i] += 1
        self._pos = tuple(pos)
        return batch


class SessionContext:
    """What a session and its engine share and never change: the model
    adapter, the configs, the gradient mode, the schedule and the data
    cursor, or under a client population (``repro_torch.population``) the
    population and its round-addressed cursor; ``mesh`` and the resolved
    ``recipe`` for the spmd engine."""

    def __init__(self, model, splitee_cfg: SplitEEConfig,
                 opt_cfg: OptimizerConfig,
                 client_data: Optional[Sequence[Tuple[np.ndarray,
                                                      np.ndarray]]],
                 batch_size: int, *, augment=None, seed: int = 0,
                 mesh=None, grad_mode: str = "eq1", recipe=None,
                 population=None):
        # resolved eagerly, so a bad recipe name dies at the facade and not
        # inside an engine; the spmd engine reads the resolved dataclass
        from repro_torch.launch.shardings import recipe_name, resolve_recipe
        self.recipe = resolve_recipe(recipe)
        self.recipe_name = recipe_name(recipe)
        self.mesh = mesh
        if grad_mode not in GRAD_MODES:
            raise ValueError(f"unknown grad_mode {grad_mode!r}; expected "
                             f"one of {GRAD_MODES}")
        self.model = model
        self.grad_mode = grad_mode
        self.cfg = splitee_cfg
        self.opt_cfg = opt_cfg
        self.batch_size = batch_size
        self.augment = augment
        self.seed = seed
        self.population = population
        self.profile = splitee_cfg.profile
        self.strategy = splitee_cfg.strategy
        self.N = self.profile.num_groups
        if population is not None:
            # the population drives the data: its slot layout is the
            # profile's client groups, and the per-slot "shards" that size
            # the staging buffers are placeholder views
            if client_data is not None:
                raise ValueError(
                    "pass either client_data or population, not both: a "
                    "population session draws every staged batch from the "
                    "population's per-client shards")
            if augment is not None:
                raise ValueError(
                    "augment is not supported with a client population "
                    "yet; bake augmentation into the population shards")
            population.validate_for(self.profile.split_layers, batch_size)
            client_data = population.slot_stubs()
        elif client_data is None:
            raise ValueError("client_data is required without a population")
        self.client_data = client_data
        if len(client_data) != self.N:
            raise ValueError(f"profile has {self.N} client groups but "
                             f"{len(client_data)} data shards were given")
        self.schedule = make_schedule(opt_cfg)
        self.server_lr_div = splitee_cfg.resolved_server_lr_divisor()
        self.data = DataCursor(client_data, batch_size, seed, augment)
        self.pop_cursor = (PopulationCursor(population, batch_size, seed)
                           if population is not None else None)


class Engine:
    """Base class: a ``state -> state`` executor bound to a context."""

    name: str = "?"

    def __init__(self, ctx: SessionContext):
        reason = self.supports(ctx)
        if reason:
            raise ValueError(reason)
        self.ctx = ctx

    @classmethod
    def supports(cls, ctx: SessionContext) -> Optional[str]:
        """``None`` if this engine can run the session, else the reason."""
        return None

    def place(self, state):
        """``state`` as this engine's runs take it: a whole ``TrainState``
        (another engine's chunks gathered: collective over its ranks).
        The session keeps what this returns, so a state it replaces can
        be let go before a run."""
        return state.whole()

    def run(self, state, rounds: int, local_epochs: int = 1,
            log_every: int = 0, chunk_rounds: int = 0):
        """Train ``rounds`` rounds from ``state``; returns
        ``(new_state, [RoundMetrics])``.  Must not change ``state`` (the
        spmd engine's chunks are the exception: a run takes them as its
        carry).  ``chunk_rounds`` bounds the rounds an engine stages at
        once (0 = the engine's choice)."""
        raise NotImplementedError


_REGISTRY: Dict[str, Type[Engine]] = {}

#: auto-selection preference, widest engine first (as in the JAX package)
AUTO_ORDER = ("spmd", "fused", "reference")


def register_engine(name: str) -> Callable[[Type[Engine]], Type[Engine]]:
    def deco(cls: Type[Engine]) -> Type[Engine]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_engine(name: str) -> Type[Engine]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown engine {name!r}; registered engines: "
                         f"{available_engines()}") from None


def available_engines() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_engine(name: str, ctx: SessionContext
                   ) -> Tuple[Type[Engine], Optional[str]]:
    """An engine name (or ``"auto"``) resolved against a session: returns
    ``(engine_cls, selection_note)``.  ``"auto"`` takes the first engine of
    :data:`AUTO_ORDER` that can run the session, and the note says why
    each wider one was skipped (``TrainSession.engine_name`` shows it); an
    explicit name resolves with no note or raises with the reason."""
    if name == "auto":
        skipped: List[Tuple[List[str], str]] = []
        for cand in AUTO_ORDER:
            cls = _REGISTRY[cand]
            reason = cls.supports(ctx)
            if reason is None:
                note = "; ".join(f"{'/'.join(names)} unavailable: {r}"
                                 for names, r in skipped) or None
                return cls, note
            if skipped and skipped[-1][1] == reason:
                skipped[-1][0].append(cand)
            else:
                skipped.append(([cand], reason))
        raise ValueError("no registered engine supports this session ("
                         + "; ".join(f"{'/'.join(names)}: {r}"
                                     for names, r in skipped) + ")")
    cls = get_engine(name)
    reason = cls.supports(ctx)
    if reason:
        raise ValueError(reason)
    return cls, None


def cohort_layout(split_layers: Sequence[int]
                  ) -> Tuple[Tuple[int, ...], Dict[int, List[int]]]:
    """Client indices grouped by cut layer: the sorted distinct cut layers
    and ``{li: [client indices]}``."""
    lis = tuple(sorted(set(split_layers)))
    lanes = {li: [i for i, l in enumerate(split_layers) if l == li]
             for li in lis}
    return lis, lanes


def ragged_cohort_reason(ctx: SessionContext) -> Optional[str]:
    """Cohort lanes stack into one ``[k, B, ...]`` tensor, so clients that
    share a cut layer must draw equal effective batch sizes; the offending
    cohort's description if they do not (the reference engine has no
    such constraint)."""
    _, lanes = cohort_layout(ctx.profile.split_layers)
    for li, members in lanes.items():
        bs = {i: effective_batch_size(len(ctx.client_data[i][0]),
                                      ctx.batch_size)
              for i in members}
        if len(set(bs.values())) > 1:
            return (f"cohort l_i={li} mixes effective batch sizes {bs} "
                    f"(batch_size={ctx.batch_size} clamped to shard "
                    f"length); equalize client shards or use the "
                    f"reference engine")
    return None

"""``TrainSession``: the front door for Hetero-SplitEE training (counterpart
of ``repro/api/session.py``).

A session binds a ``SplitModel`` adapter, the paper's configs, per-client
data shards and a registered engine; all progress lives in one
:class:`~repro_torch.api.state.TrainState`, which the engine takes and
returns.  The session runs where its model's nets live (``model.device``:
the CUDA card unless the adapter was built with ``device="cpu"``).

    model = ResNetSplitModel(resnet18_cifar.config("cifar10"))
    session = TrainSession.from_config(model, splitee_cfg, opt_cfg,
                                       client_data, batch_size=64)
    session.train(rounds=100)
    session.evaluate(x_test, y_test)
    session.evaluate_adaptive(x_test, y_test, tau=1.0)

Checkpoints (``save``, ``restore``, ``restore_latest``) wait for
ROADMAP.md Queue 1 item 6.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api import fused_engine as _fused_engine  # noqa: F401 (registers)
from repro_torch.api import reference_engine as _reference_engine  # noqa: F401 (registers)
from repro_torch.api.engines import SessionContext, resolve_engine
from repro_torch.api.evaluation import SplitEvaluator
from repro_torch.api.protocol import assert_split_model
from repro_torch.api.state import TrainState, init_train_state
from repro_torch.config import OptimizerConfig, SplitEEConfig
from repro_torch.core.strategies import RoundMetrics


class TrainSession:
    """Facade over (model adapter, configs, data, engine, TrainState)."""

    def __init__(self, model, splitee_cfg: SplitEEConfig,
                 opt_cfg: OptimizerConfig,
                 client_data: Optional[Sequence[Tuple[np.ndarray,
                                                      np.ndarray]]],
                 batch_size: int, *, engine: str = "auto",
                 augment=None, seed: int = 0,
                 mesh=None, grad_mode: str = "eq1", recipe=None,
                 population=None,
                 state: Optional[TrainState] = None,
                 history: Optional[List[RoundMetrics]] = None):
        assert_split_model(model)
        self.ctx = SessionContext(model, splitee_cfg, opt_cfg, client_data,
                                  batch_size, augment=augment, seed=seed,
                                  mesh=mesh, grad_mode=grad_mode,
                                  recipe=recipe, population=population)
        engine_cls, self._engine_note = resolve_engine(engine, self.ctx)
        self.engine = engine_cls(self.ctx)
        self.state = (state if state is not None
                      else init_train_state(model, splitee_cfg, opt_cfg))
        self.history: List[RoundMetrics] = list(history or [])
        self._evaluator = SplitEvaluator(model, self.ctx.profile,
                                         self.ctx.strategy)

    @classmethod
    def from_config(cls, model, splitee_cfg: SplitEEConfig,
                    opt_cfg: OptimizerConfig,
                    data: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]],
                    batch_size: int = 64, *, engine: str = "auto",
                    augment=None, seed: int = 0, mesh=None,
                    grad_mode: str = "eq1", recipe=None,
                    population=None) -> "TrainSession":
        """The canonical constructor (the arguments of ``__init__``).
        ``grad_mode`` is ``"eq1"`` (paper-faithful, every engine) or
        ``"sum"`` (one backward of the summed losses; the fused engine).
        ``mesh``, ``recipe`` (ROADMAP.md Queue 1 item 9) and
        ``population`` (item 8) raise until those items are ported."""
        return cls(model, splitee_cfg, opt_cfg, data, batch_size,
                   engine=engine, augment=augment, seed=seed, mesh=mesh,
                   grad_mode=grad_mode, recipe=recipe,
                   population=population)

    @property
    def model(self):
        return self.ctx.model

    @property
    def round(self) -> int:
        """Global rounds completed so far."""
        return self.state.round

    @property
    def engine_name(self) -> str:
        """The engine, with the reason wider candidates were skipped when
        ``engine="auto"`` chose it, e.g. ``"reference (spmd unavailable:
        ...; fused unavailable: ...)"``; ``session.engine.name`` is the
        bare name."""
        if self._engine_note:
            return f"{self.engine.name} ({self._engine_note})"
        return self.engine.name

    def train(self, rounds: int, local_epochs: int = 1, log_every: int = 0,
              chunk_rounds: int = 0) -> List[RoundMetrics]:
        """Advance the state by ``rounds`` rounds; returns their metrics
        (also appended to ``self.history``).  ``chunk_rounds`` bounds the
        rounds the fused engine stages at once (0 = its staging budget)."""
        self.state, metrics = self.engine.run(
            self.state, rounds, local_epochs=local_epochs,
            log_every=log_every, chunk_rounds=chunk_rounds)
        self.history.extend(metrics)
        return metrics

    def run(self, rounds: int, local_epochs: int = 1, log_every: int = 0,
            chunk_rounds: int = 0) -> List[RoundMetrics]:
        """:meth:`train`, returning the whole history."""
        self.train(rounds, local_epochs, log_every, chunk_rounds)
        return self.history

    def evaluate(self, x, y, batch_size: int = 512) -> Dict[str, Any]:
        return self._evaluator.evaluate(self.state, x, y, batch_size)

    def evaluate_adaptive(self, x, y, tau: float, batch_size: int = 512
                          ) -> Dict[str, Any]:
        return self._evaluator.evaluate_adaptive(self.state, x, y, tau,
                                                 batch_size)

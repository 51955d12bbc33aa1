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
    session.train(rounds=100, save_every=20, save_dir="ckpt/run1")
    session = TrainSession.restore_latest("ckpt/run1", model, client_data)
    session.train(rounds=100)            # continues round 100..199
    session.evaluate(x_test, y_test)
    session.evaluate_adaptive(x_test, y_test, tau=1.0)

Under the spmd engine ``session.state`` is each rank's chunks
(``api.state.ShardedTrainState``); ``session.state.whole()`` returns the
whole ``TrainState`` on every engine (collective over the spmd engine's
ranks).  The session's initial state is whole, as the JAX package builds
it on one device before placing it; the session lets go of it once the
first run's carry is cut.

Checkpoints are the JAX package's: ``save`` writes the state in the JAX
layout (``convert.state_to_jax``) through ``repro_torch.checkpoint`` with
the JAX session's manifest, so a checkpoint written by either package's
``TrainSession.save`` restores in the other's.  Training 2k rounds equals
training k, saving, restoring and training k (``tests/
test_torch_checkpoint.py``).
"""
from __future__ import annotations

import dataclasses
import glob as _glob
import json
import os
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api import fused_engine as _fused_engine  # noqa: F401 (registers)
from repro_torch.api import reference_engine as _reference_engine  # noqa: F401 (registers)
from repro_torch.api import spmd_engine as _spmd_engine  # noqa: F401 (registers)
from repro_torch.api.engines import SessionContext, resolve_engine
from repro_torch.api.evaluation import SplitEvaluator
from repro_torch.api.protocol import assert_split_model
from repro_torch.api.state import (ShardedTrainState, TrainState,
                                   init_train_state)
from repro_torch.checkpoint import save_pytree
from repro_torch.config import HeteroProfile, OptimizerConfig, SplitEEConfig
from repro_torch.convert import load_split_state, state_to_jax
from repro_torch.core.strategies import RoundMetrics
from repro_torch.launch.distributed import is_coordinator
from repro_torch.launch.shardings import recipe_from_meta, recipe_to_meta

#: checkpoint manifest format version (the JAX package's)
CHECKPOINT_FORMAT = 1

def _model_name(model) -> str:
    """The adapter's identity in a manifest: its ``name``
    (``BackboneSplitModel`` reports its config's) or the adapter's class
    name (the MLP and ResNet adapters), as the JAX package records it."""
    return str(getattr(model, "name", type(model).__name__))


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def read_manifest(path: str, model, what: str = "loaded") -> Dict[str, Any]:
    """The metadata of checkpoint ``path``, after the checks every restore
    makes: a ``TrainSession`` checkpoint, of this format, saved with this
    ``model``."""
    with open(path + ".json") as f:
        meta = json.load(f)["metadata"]
    if meta.get("kind") != "train_session":
        raise ValueError(f"{path} is not a TrainSession checkpoint")
    if meta.get("format") != CHECKPOINT_FORMAT:
        raise ValueError(
            f"{path} has checkpoint format {meta.get('format')!r}; this "
            f"version reads format {CHECKPOINT_FORMAT}")
    saved_model = meta.get("model")          # absent in older manifests
    if saved_model is not None and saved_model != _model_name(model):
        raise ValueError(
            f"checkpoint was saved with model {saved_model!r} but restore "
            f"got {_model_name(model)!r}; the state cannot be {what} as a "
            f"different architecture")
    return meta


def manifest_configs(meta: Dict[str, Any]
                     ) -> Tuple[SplitEEConfig, OptimizerConfig]:
    """The session configs a manifest records."""
    sp = meta["splitee"]
    splitee_cfg = SplitEEConfig(
        profile=HeteroProfile(tuple(sp["split_layers"])),
        strategy=sp["strategy"],
        server_lr_divisor=sp["server_lr_divisor"],
        aggregate_every=sp["aggregate_every"],
        entropy_threshold=sp["entropy_threshold"])
    opt = dict(meta["optimizer"])
    opt["state_dtype"] = getattr(torch, opt["state_dtype"])
    return splitee_cfg, OptimizerConfig(**opt)


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
        ``population`` (a ``repro_torch.population.ClientPopulation``)
        replaces ``data``: each round's batches come from the population's
        scheduled clients, masked onto the profile's cohort slots (the
        fused and spmd engines).  ``mesh`` (a ``launch.mesh`` mesh or a
        ``MeshSpec`` of the world's size) and ``recipe`` (a
        ``launch.shardings.NAMED_RECIPES`` name or a ``ShardingRecipe``)
        place the spmd engine's ranks and tensors."""
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
              chunk_rounds: int = 0, *, save_every: int = 0,
              save_dir: Optional[str] = None,
              keep_last: int = 3) -> List[RoundMetrics]:
        """Advance the state by ``rounds`` rounds; returns their metrics
        (also appended to ``self.history``).  ``chunk_rounds`` bounds the
        rounds the fused engine stages at once (0 = its staging budget).

        ``save_every=N`` checkpoints into ``save_dir`` every N rounds (and
        once more at the end when ``rounds`` is not a multiple), keeping
        only the newest ``keep_last`` checkpoints; :meth:`restore_latest`
        picks the run back up."""
        if save_every < 0 or (save_every and not save_dir):
            raise ValueError("save_every needs save_dir (and save_every "
                             f">= 0); got save_every={save_every} "
                             f"save_dir={save_dir!r}")
        if not save_every:
            return self._train_segment(rounds, local_epochs, log_every,
                                       chunk_rounds)
        metrics: List[RoundMetrics] = []
        done = 0
        while done < rounds:
            n = min(save_every, rounds - done)
            metrics.extend(self._train_segment(n, local_epochs, log_every,
                                               chunk_rounds))
            done += n
            self._save_rotating(save_dir, keep_last)
        return metrics

    def _train_segment(self, rounds, local_epochs, log_every, chunk_rounds
                       ) -> List[RoundMetrics]:
        # the engine's form of the state first, so the session lets go of
        # a state it replaces (the spmd engine's: the whole state once its
        # chunks are cut) before the run
        self.state = self.engine.place(self.state)
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
        """Per-client accuracy of the exit and of the server.  Under the
        spmd engine every rank calls it (each client's nets are gathered
        in turn) and every rank gets the same numbers."""
        return self._evaluator.evaluate(self.state, x, y, batch_size)

    def evaluate_adaptive(self, x, y, tau: float, batch_size: int = 512
                          ) -> Dict[str, Any]:
        return self._evaluator.evaluate_adaptive(self.state, x, y, tau,
                                                 batch_size)

    # -------------------------------------------------------- checkpointing
    def save(self, path: str) -> None:
        """Write ``path + '.npz'`` (the whole ``TrainState`` in the JAX
        package's layout) and ``path + '.json'`` (the manifest, with the
        JAX session's metadata).  The model adapter and the data are not
        saved: pass the same ones to :meth:`restore`.  A state kept as
        each rank's chunks (the spmd engine) is gathered one leaf at a
        time to host memory: every rank calls ``save`` and only the
        coordinator writes."""
        state = self.state
        if isinstance(state, ShardedTrainState):
            state = state.whole(device="cpu")
            if not is_coordinator():
                return
        ctx = self.ctx
        opt = dataclasses.asdict(ctx.opt_cfg)
        opt["state_dtype"] = _dtype_name(opt["state_dtype"])
        meta = {
            "format": CHECKPOINT_FORMAT,
            "kind": "train_session",
            "engine": self.engine.name,
            # restore refuses a different model, so a state is never
            # loaded into another architecture
            "model": _model_name(ctx.model),
            "splitee": {
                "split_layers": list(ctx.profile.split_layers),
                "strategy": ctx.cfg.strategy,
                "server_lr_divisor": ctx.cfg.server_lr_divisor,
                "aggregate_every": ctx.cfg.aggregate_every,
                "entropy_threshold": ctx.cfg.entropy_threshold,
            },
            "optimizer": opt,
            "grad_mode": ctx.grad_mode,
            # the spmd sharding recipe is layout, not math: recorded, and
            # read back by restore unless it is given another
            "recipe": {"name": ctx.recipe_name,
                       **recipe_to_meta(ctx.recipe)},
            # the kernel backend is layout, not math: recorded only
            "kernels": getattr(getattr(ctx.model, "cfg", None), "kernels",
                               None),
            "batch_size": ctx.batch_size,
            "seed": ctx.seed,
            # the augment callable is not serializable, but whether one
            # was active is: the replayed data differs if it differs
            "augmented": ctx.augment is not None,
            # a resumed population run must replay the same remaining
            # participation schedule: restore checks this fingerprint
            "population": (ctx.population.meta()
                           if ctx.population is not None else None),
            "round": self.round,
            "history": [dataclasses.asdict(m) for m in self.history],
        }
        save_pytree(path, state_to_jax(state, ctx.model), metadata=meta)

    def _save_rotating(self, save_dir: str, keep_last: int) -> None:
        """``save_dir/ckpt-<round>``, then only the newest ``keep_last``
        ``.npz``/``.json`` pairs are kept.  Only the coordinator rank writes
        (a whole state is the same on every rank; chunks are gathered by
        every rank's :meth:`save`)."""
        if is_coordinator():
            os.makedirs(save_dir, exist_ok=True)
        elif not isinstance(self.state, ShardedTrainState):
            return
        self.save(os.path.join(save_dir, f"ckpt-{self.round:08d}"))
        if not is_coordinator():
            return
        stems = sorted(p[:-5] for p in
                       _glob.glob(os.path.join(save_dir, "ckpt-*.json")))
        for stem in stems[:-max(1, keep_last)]:
            for ext in (".npz", ".json"):
                try:
                    os.remove(stem + ext)
                except FileNotFoundError:
                    pass

    @classmethod
    def restore_latest(cls, save_dir: str, model,
                       client_data: Optional[Sequence[Tuple[np.ndarray,
                                                            np.ndarray]]],
                       *, engine: Optional[str] = None, augment=None,
                       mesh=None, recipe=None,
                       population=None) -> "TrainSession":
        """Resume from the newest readable checkpoint under ``save_dir``
        (the layout ``train(save_every=...)`` writes).  Checkpoints are
        tried newest first; a pair that cannot be read or parsed (a crash
        in the middle of a save) is skipped with a warning.  A checkpoint
        that reads but cannot build a session raises: a configuration
        error is never taken for a damaged file."""
        stems = sorted((p[:-5] for p in
                        _glob.glob(os.path.join(save_dir, "ckpt-*.json"))),
                       reverse=True)
        errors = []
        for stem in stems:
            try:
                with open(stem + ".json") as f:
                    json.load(f)
                np.load(stem + ".npz").close()
            except Exception as e:                        # noqa: BLE001
                warnings.warn(f"skipping unreadable checkpoint {stem}: {e}")
                errors.append(f"{os.path.basename(stem)}: {e}")
                continue
            return cls.restore(stem, model, client_data, engine=engine,
                               augment=augment, mesh=mesh, recipe=recipe,
                               population=population)
        detail = f" (tried: {'; '.join(errors)})" if errors else ""
        raise FileNotFoundError(
            f"no readable TrainSession checkpoint under "
            f"{save_dir!r}{detail}")

    @classmethod
    def restore(cls, path: str, model,
                client_data: Optional[Sequence[Tuple[np.ndarray,
                                                     np.ndarray]]],
                *, engine: Optional[str] = None, augment=None,
                mesh=None, recipe=None, population=None) -> "TrainSession":
        """A session rebuilt from :meth:`save`'s output (either package's).
        The configuration comes from the manifest; ``model`` and
        ``client_data`` must be the ones the run was built with (the state
        holds every learned tensor, the adapter only its architecture and
        seed).  ``engine`` overrides the saved engine: a state saved by one
        engine continues in any other that runs its strategy.  A population
        run restores with the same ``population`` (and
        ``client_data=None``); its fingerprint is checked against the
        manifest, so the resumed run replays the same remaining schedule.
        ``mesh`` (not serializable) is given again when the spmd engine
        should run on a particular mesh; ``recipe`` overrides the saved
        sharding recipe (a recipe is layout, so a state saved under one
        continues under any other)."""
        meta = read_manifest(path, model)
        if meta["augmented"] != (augment is not None):
            raise ValueError(
                f"checkpoint was saved with augment "
                f"{'active' if meta['augmented'] else 'inactive'} but "
                f"restore got augment={augment!r}; the replayed data stream "
                f"would diverge: pass the original augment function")
        saved_pop = meta.get("population")      # absent in older manifests
        if saved_pop is not None and population is None:
            raise ValueError(
                f"checkpoint was saved from a client-population session "
                f"({saved_pop['num_clients']} clients) but restore got "
                f"population=None; the replayed participation schedule "
                f"and batch streams would diverge: pass the original "
                f"ClientPopulation")
        if population is not None:
            if saved_pop is None:
                raise ValueError(
                    "checkpoint was saved from a fixed-cohort session but "
                    "restore got a ClientPopulation; the replayed data "
                    "stream would diverge: restore with client_data "
                    "instead")
            population.check_meta(saved_pop)
        splitee_cfg, opt_cfg = manifest_configs(meta)
        if recipe is None and "recipe" in meta:
            saved = dict(meta["recipe"])
            name = saved.pop("name", "custom")
            recipe = name if name != "custom" else recipe_from_meta(saved)
        session = cls(model, splitee_cfg, opt_cfg, client_data,
                      meta["batch_size"], engine=engine or meta["engine"],
                      augment=augment, seed=meta["seed"], mesh=mesh,
                      grad_mode=meta.get("grad_mode", "eq1"),
                      recipe=recipe, population=population)
        # a fresh init has the saved structure: restore into it
        session.state = load_split_state(path, model, session.state)
        session.history = [RoundMetrics(**m) for m in meta["history"]]
        return session

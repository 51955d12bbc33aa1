"""``TrainState``: the whole training state of a Hetero-SplitEE run as one
immutable record (counterpart of ``repro/api/state.py``).

  * ``clients[i]``      — ``{"trainable": ..., "state": ...}`` of client i
  * ``client_opts[i]``  — its ``AdamState``
  * ``servers[j]``      — server nets: one shared net under Sequential,
    one per client under Averaging and distributed
  * ``server_opts[j]``  — an ``AdamState`` per server net
  * ``round``           — rounds completed, a host ``int``
  * ``batches_drawn``   — minibatches drawn per client, a tuple of host
    ``int``s: the data cursor replays each seeded batch iterator to it.
    Under a client population they are bookkeeping only: the
    population's streams are addressed by round, and a restore replays
    the seeded schedule from round 0 to ``round``

The counters are host integers where the JAX package keeps int32 arrays
(a checkpoint writes them as such): the engine reads them every round,
and a device scalar would cost a sync.
The record is frozen, but the tensors in it are not; an engine clones the
state it is given before its in-place Adam steps (``run`` must leave its
input untouched).

The spmd engine keeps the state between runs as each rank's chunks
(:class:`ShardedTrainState`, the counterpart of the JAX engine's carry
left on its ``NamedSharding`` s): every tensor on a rank is its chunk of
the cohort carry, placed by the sharding recipe.  Both records answer
:meth:`TrainState.whole` (the whole state; collective over the ranks for
the chunks) and :meth:`TrainState.nets` (one client's client and server
nets), so evaluation, checkpoints and engine hand-offs read either.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple

import torch

from repro_torch.config import OptimizerConfig, SplitEEConfig
from repro_torch.optim import AdamState, adam_init
from repro_torch.tree import tree_map


@dataclass(frozen=True)
class TrainState:
    clients: Tuple[Any, ...]
    client_opts: Tuple[AdamState, ...]
    servers: Tuple[Any, ...]
    server_opts: Tuple[AdamState, ...]
    round: int
    batches_drawn: Tuple[int, ...]

    @property
    def num_clients(self) -> int:
        return len(self.clients)

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)

    def map_tensors(self, fn) -> "TrainState":
        """The state with ``fn`` applied to every tensor (nets, BatchNorm
        statistics, Adam moments)."""
        nets = lambda tree: tree_map(fn, tree)  # noqa: E731

        def opt(s: AdamState) -> AdamState:
            return AdamState(step=s.step, m=nets(s.m), v=nets(s.v))

        return self.replace(
            clients=tuple(nets(c) for c in self.clients),
            client_opts=tuple(opt(s) for s in self.client_opts),
            servers=tuple(nets(s) for s in self.servers),
            server_opts=tuple(opt(s) for s in self.server_opts))

    def clone(self) -> "TrainState":
        """A copy whose every tensor is a copy."""
        return self.map_tensors(torch.clone)

    def to(self, device) -> "TrainState":
        """A copy on ``device``."""
        return self.map_tensors(lambda t: t.to(device, copy=True))

    def whole(self) -> "TrainState":
        """The whole state: this record itself."""
        return self

    def nets(self, i: int, server: int) -> Tuple[Any, Any]:
        """Client ``i``'s net and server net ``server``."""
        return self.clients[i], self.servers[server]


class ShardedTrainState:
    """A ``TrainState`` held as this rank's chunks of the spmd engine's
    cohort carry (``api/spmd_engine.py``): ``carry`` ``{cut layer:
    (clients, client Adam states, servers, server Adam states)}``, each
    stacked over this rank's lanes of the cohort and every leaf cut to its
    chunk by the recipe's specs; each client's Adam steps (client, server)
    as host integers beside them; the round and the draw counts as a
    ``TrainState`` keeps them.  No rank holds another rank's lanes or
    chunks.

    The engine that made it takes the chunks as the carry of its next run
    (no gather, no cut): that run updates them in place, so the record
    it was given is spent and refuses to be read.  Reading whole values is
    explicit and collective -- every rank of the engine's mesh calls it,
    in the same order: :meth:`whole` gathers the state one leaf at a
    time, :meth:`nets` one client's nets."""

    def __init__(self, engine, carry, steps, round: int,
                 batches_drawn: Tuple[int, ...]):
        self.engine = engine
        self._carry = carry
        self.steps = [tuple(s) for s in steps]
        self.round = round
        self.batches_drawn = tuple(batches_drawn)

    @property
    def num_clients(self) -> int:
        return len(self.steps)

    def replace(self, **kw) -> "ShardedTrainState":
        """A record of the same chunks with ``round`` and/or
        ``batches_drawn`` replaced; the chunks move to it (this record is
        spent)."""
        bad = set(kw) - {"round", "batches_drawn"}
        if bad:
            raise TypeError(f"a ShardedTrainState replaces round and "
                            f"batches_drawn only, not {sorted(bad)}")
        return ShardedTrainState(self.engine, self.take(), self.steps,
                                 kw.get("round", self.round),
                                 kw.get("batches_drawn",
                                        self.batches_drawn))

    @property
    def carry(self):
        """This rank's chunks (raises once a run has taken them)."""
        if self._carry is None:
            raise RuntimeError(
                "this ShardedTrainState was advanced by a later run of its "
                "engine, which took its chunks as the carry and updated "
                "them in place; read the session's current state (or call "
                "whole() before training to keep a copy)")
        return self._carry

    def take(self):
        """The chunks, handed to a run that updates them in place: this
        record is spent afterwards."""
        carry, self._carry = self.carry, None
        return carry

    @property
    def nbytes(self) -> int:
        """Bytes of the state's tensors on this rank (its chunks)."""
        from repro_torch.launch.shardings import tree_paths
        return sum(t.numel() * t.element_size()
                   for entry in self.carry.values()
                   for _, t in tree_paths(entry)
                   if isinstance(t, torch.Tensor))

    def whole(self, device=None) -> TrainState:
        """The whole ``TrainState``, the same on every rank (collective:
        every rank of the mesh calls it).  Gathered one leaf at a time;
        with ``device`` (e.g. ``"cpu"`` for a checkpoint) each whole leaf
        moves there before the next is gathered."""
        return self.engine.whole_state(self, device)

    def nets(self, i: int, server: int) -> Tuple[Any, Any]:
        """Client ``i``'s net and its server net, whole and the same on
        every rank (collective): only that client's lane is gathered."""
        if server != i:
            raise ValueError(f"the spmd engine keeps one server a client "
                             f"(client {i}, server {server})")
        return self.engine.client_nets(self, i)


def init_train_state(model, splitee_cfg: SplitEEConfig,
                     opt_cfg: OptimizerConfig) -> TrainState:
    """Round-zero state: every net from the adapter's seed (paper §III-B:
    common layers start identical across clients)."""
    splits = splitee_cfg.profile.split_layers
    clients = tuple(model.make_client(li) for li in splits)
    client_opts = tuple(adam_init(c["trainable"], opt_cfg) for c in clients)
    if splitee_cfg.strategy == "sequential":
        servers = (model.make_server(min(splits)),)   # one shared server
    elif splitee_cfg.strategy in ("averaging", "distributed"):
        servers = tuple(model.make_server(li) for li in splits)
    else:
        raise ValueError(f"unknown strategy {splitee_cfg.strategy!r}")
    return TrainState(
        clients=clients, client_opts=client_opts, servers=servers,
        server_opts=tuple(adam_init(s["trainable"], opt_cfg)
                          for s in servers),
        round=0, batches_drawn=(0,) * len(splits))

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

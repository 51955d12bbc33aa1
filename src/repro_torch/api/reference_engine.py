"""The reference engine: the paper's per-client loop as a
``TrainState -> TrainState`` executor (counterpart of
``repro/api/reference_engine.py``).

Literally Alg. 1 / Alg. 2: each round, each client takes E local minibatch
steps on its exit head's loss, and its server takes one step per
transmitted minibatch: the shared server under Sequential (server LR
divided by N, paper Table II), the client's own under Averaging and
distributed, with Eq. (1) cross-layer aggregation on Averaging's
boundaries.  ``h`` enters the server step detached, so no gradient reaches
the client.  One ``.item()`` per loss: slow but literal, the engine every
other is held against.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.api.engines import Engine, SessionContext, register_engine
from repro_torch.api.state import TrainState
from repro_torch.core.aggregation import cross_layer_aggregate
from repro_torch.core.strategies import (RoundMetrics, make_client_step,
                                         make_server_step)


@register_engine("reference")
class ReferenceEngine(Engine):

    def __init__(self, ctx: SessionContext):
        super().__init__(ctx)
        # the client step does not depend on l_i (the trainable's own
        # layer keys set the depth); one server step per cut layer
        self._cstep = make_client_step(ctx.model, ctx.opt_cfg)
        self._sstep: Dict[int, Callable] = {}

    @classmethod
    def supports(cls, ctx: SessionContext):
        if ctx.strategy not in ("sequential", "averaging", "distributed"):
            return f"unknown strategy {ctx.strategy!r}"
        if ctx.grad_mode != "eq1":
            return (f"the reference engine implements the paper-faithful "
                    f"'eq1' gradient routing only, not {ctx.grad_mode!r}: "
                    f"use the fused engine for 'sum'")
        if ctx.population is not None:
            return ("the client-population simulation runs over masked "
                    "cohort lanes (repro_torch.population); use the fused "
                    "or spmd engine")
        return None

    def _server_step(self, li: int) -> Callable:
        if li not in self._sstep:
            self._sstep[li] = make_server_step(self.ctx.model,
                                               self.ctx.opt_cfg, li)
        return self._sstep[li]

    def run(self, state: TrainState, rounds: int, local_epochs: int = 1,
            log_every: int = 0, chunk_rounds: int = 0
            ) -> Tuple[TrainState, List[RoundMetrics]]:
        """``state`` is cloned first, since the steps update in place.
        ``chunk_rounds`` is ignored: this engine stages nothing ahead."""
        ctx = self.ctx
        dev = ctx.model.device
        ctx.data.align(state.batches_drawn)
        work = state.clone()
        clients, copts = list(work.clients), list(work.client_opts)
        servers, sopts = list(work.servers), list(work.server_opts)
        t0 = state.round
        metrics: List[RoundMetrics] = []

        for r in range(rounds):
            t = t0 + r
            lr = ctx.schedule(t)
            lr_server = lr / ctx.server_lr_div
            closses, slosses = [], []

            for i, li in enumerate(ctx.profile.split_layers):
                sstep = self._server_step(li)
                sidx = 0 if ctx.strategy == "sequential" else i
                client, copt = clients[i], copts[i]
                server, sopt = servers[sidx], sopts[sidx]

                for _ in range(local_epochs):
                    x, y = ctx.data.draw(i)
                    x = torch.from_numpy(x).to(dev)
                    y = torch.from_numpy(y).to(dev)
                    # client-side training (Alg. 1/2 lines 6-11)
                    tr, st, copt, h, closs = self._cstep(
                        client["trainable"], client["state"], copt, x, y, lr)
                    client = {"trainable": tr, "state": st}
                    # server-side training on h_i (lines 12-16)
                    str_, sst, sopt, sloss = sstep(
                        server["trainable"], server["state"], sopt,
                        h.detach(), y, lr_server)
                    server = {"trainable": str_, "state": sst}
                    closses.append(closs.item())
                    slosses.append(sloss.item())

                clients[i], copts[i] = client, copt
                servers[sidx], sopts[sidx] = server, sopt

            # cross-layer aggregation (Alg. 2 lines 20-30)
            if (ctx.strategy == "averaging"
                    and (t + 1) % ctx.cfg.aggregate_every == 0):
                splits = list(ctx.profile.split_layers)
                trainables = cross_layer_aggregate(
                    [s["trainable"] for s in servers], splits)
                states = cross_layer_aggregate(
                    [s["state"] for s in servers], splits,
                    extra_shared_keys=())
                servers = [{"trainable": tr, "state": st}
                           for tr, st in zip(trainables, states)]

            m = RoundMetrics(t, float(np.mean(closses)),
                             float(np.mean(slosses)))
            metrics.append(m)
            if log_every and (t % log_every == 0):
                print(f"round {t:4d}  client_loss {m.client_loss:.4f}  "
                      f"server_loss {m.server_loss:.4f}")

        new_state = work.replace(
            clients=tuple(clients), client_opts=tuple(copts),
            servers=tuple(servers), server_opts=tuple(sopts),
            round=t0 + rounds,
            batches_drawn=tuple(c + rounds * local_epochs
                                for c in state.batches_drawn))
        return new_state, metrics

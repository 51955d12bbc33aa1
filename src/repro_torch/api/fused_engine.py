"""The fused cohort engine (counterpart of ``repro/api/fused_engine.py``):
the Averaging and distributed strategies as a ``TrainState -> TrainState``
executor that steps every cohort's clients at once.

  * **Cohorts as lanes.**  Clients that share a cut layer have nets of one
    structure, so each cohort is stacked along a leading lane axis once per
    run and stepped by ``core.spmd.make_cohort_train_step``: the adapter's
    forward under ``torch.func.vmap``, plain autograd of the lanes' summed
    losses, one Adam update per stacked leaf.
  * **Chunks of rounds.**  The minibatches the reference engine would draw
    are staged as ``{li: [rounds, E, k, B, ...]}`` device tensors a chunk
    at a time (pinned host buffers, copied on a stream of their own while
    the previous chunk computes; ``data.staging``).  A Python loop over the
    chunk's rounds takes the place of the JAX engine's ``lax.scan``: the
    learning rate comes from the schedule on the host, losses are summed on
    the device, and the host reads them once per chunk, after the next
    chunk has been dispatched.
  * **Eq. (1) on the stacked servers** (``stacked_cross_layer_aggregate``,
    in place) on the rounds where ``(t + 1) % aggregate_every == 0``; ``t``
    is a host integer, so the boundary costs no sync.
  * **Client populations** (``repro_torch.population``): each round the
    producer draws the participation plan, fills each active slot's lane
    from its assigned client's seeded stream and leaves the other lanes
    zero, and stages a ``[rounds, k]`` 0/1 mask per cohort beside the
    batches.  The masked cohort step (``core.spmd.make_masked_cohort_step``)
    and the masked Eq. (1) read the mask on the device, so a round launches
    the same kernels whatever its active set, and the host reads no mask:
    the per-round active and straggler counts and each client's Adam step
    come from the staged plans.

In ``eq1`` grad mode the engine composes the reference engine's step math
and matches it to 1e-5 (``tests/test_torch_fused.py``).  The Sequential
strategy is ordered across clients and stays with the reference engine.
"""
from __future__ import annotations

import collections
import itertools
import os
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.api.engines import (Engine, SessionContext, cohort_layout,
                                     ragged_cohort_reason, register_engine)
from repro_torch.api.state import TrainState
from repro_torch.convert import torch_dtype
from repro_torch.core.aggregation import (masked_stacked_cross_layer_aggregate,
                                          stacked_cross_layer_aggregate)
from repro_torch.core.splitee import stack_pytrees
from repro_torch.core.spmd import (make_cohort_train_step,
                                   make_masked_cohort_step)
from repro_torch.core.strategies import RoundMetrics
from repro_torch.data.pipeline import effective_batch_size, prestage_batches
from repro_torch.data.staging import StagedChunkPipeline
from repro_torch.optim import AdamState
from repro_torch.tree import tree_leaves


def _stack_opts(opts) -> AdamState:
    """A cohort's Adam states stacked along the lane axis, the host steps
    becoming an int32 ``[k]`` tensor beside the moments (a pinned host
    copy on the card, so the upload is no host sync)."""
    m = stack_pytrees([s.m for s in opts])
    dev = next(iter(tree_leaves(m))).device
    steps = torch.tensor([s.step for s in opts], dtype=torch.int32,
                         pin_memory=dev.type == "cuda")
    return AdamState(step=steps.to(dev, non_blocking=True), m=m,
                     v=stack_pytrees([s.v for s in opts]))


def _lane(tree, j: int, step: int = 0):
    """Lane ``j`` of a stacked tree, as tensors of its own; an ``AdamState``
    takes the host ``step`` (the engine counts steps on the host, so
    unstacking reads nothing back from the card)."""
    if isinstance(tree, AdamState):
        return AdamState(step=step, m=_lane(tree.m, j), v=_lane(tree.v, j))
    if isinstance(tree, dict):
        return {k: _lane(v, j) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_lane(v, j) for v in tree]
    return tree[j].clone()


@register_engine("fused")
class FusedEngine(Engine):

    #: staging budget (bytes) for the auto ``chunk_rounds``: a run whose
    #: staged ``[rounds, E, k, B, ...]`` batches would exceed it is split
    #: into budget-sized chunks.  Under the overlapped pipeline it is
    #: divided by ``pipeline_depth``, so the staged-ahead chunks together
    #: still fit.  Override per instance or with REPRO_STAGE_BUDGET_MB;
    #: strictly positive either way.
    stage_budget_bytes: int = 1 << 30

    #: overlapped staging: stage chunk n+1 on a background thread while
    #: chunk n computes, and read chunk n's losses only after chunk n+1 is
    #: dispatched.  The trajectory is bit-identical either way;
    #: REPRO_OVERLAP_STAGING=0 is the kill switch.
    overlap_staging: bool = True

    #: staged chunks resident at once under the pipeline (2 = one in
    #: compute, one staged ahead); also the pinned buffers kept per shape
    pipeline_depth: int = 2

    #: with overlapped staging, a budget-sized single-chunk plan is cut into
    #: up to this many chunks so the pipeline has work to overlap (an
    #: explicit ``chunk_rounds`` is never cut; chunking does not change the
    #: trajectory)
    pipeline_min_chunks: int = 4

    def __init__(self, ctx: SessionContext):
        super().__init__(ctx)
        self._cohort_lis, self._lanes = cohort_layout(
            ctx.profile.split_layers)
        self._counts: Dict[int, int] = {li: len(v)
                                        for li, v in self._lanes.items()}
        #: client index -> (cohort cut layer, lane position in the cohort)
        self._lane_pos: Dict[int, Tuple[int, int]] = {
            i: (li, j) for li in self._cohort_lis
            for j, i in enumerate(self._lanes[li])}
        self._steps: Dict[int, Callable] = self._build_steps()
        #: staging accounting of the latest :meth:`run`
        #: (``data.staging.StageStats.as_dict``)
        self.last_stage_stats: Dict = {}
        #: host reads of device results in the latest :meth:`run` (one per
        #: chunk)
        self.last_host_syncs = 0
        #: per-round participation accounting of the latest :meth:`run` of
        #: a population session ({} for fixed cohorts)
        self.last_participation_stats: Dict = {}
        self._pinned: Dict[tuple, collections.deque] = {}
        self._copy_stream = None

    @classmethod
    def supports(cls, ctx: SessionContext):
        if ctx.strategy not in ("averaging", "distributed"):
            return (f"supports averaging/distributed only, not "
                    f"{ctx.strategy!r} (the Sequential strategy is ordered "
                    f"across clients: use the reference engine)")
        return ragged_cohort_reason(ctx)

    def _build_steps(self) -> Dict[int, Callable]:
        """Each cohort's step, as :meth:`_cohort_step` calls it."""
        ctx = self.ctx
        make = (make_masked_cohort_step if ctx.population is not None
                else make_cohort_train_step)
        return {li: make(ctx.model, ctx.opt_cfg, li, ctx.grad_mode)
                for li in self._cohort_lis}

    # ------------------------------------------------------------- staging
    def _host_buffer(self, key: tuple, shape, dtype) -> list:
        """A ``[tensor, copy event]`` host buffer for ``key``.  On the card
        the buffers are pinned and each shape keeps ``pipeline_depth`` of
        them in a ring; a buffer is reused only after the copy that last
        read it has finished (its event)."""
        dev = self.ctx.model.device
        if dev.type != "cuda":
            return [torch.empty(shape, dtype=dtype), None]
        ring = self._pinned.setdefault(key + (tuple(shape), dtype),
                                       collections.deque())
        if len(ring) < self.pipeline_depth:
            return [torch.empty(shape, dtype=dtype, pin_memory=True), None]
        entry = ring.popleft()
        entry[1].synchronize()
        return entry

    def _put(self, entries: Dict[tuple, list]):
        """The host buffers on the model's device: on the card, copies on
        the engine's copy stream and the event the consumer waits on; on
        the CPU the buffers themselves."""
        dev = self.ctx.model.device
        if dev.type != "cuda":
            return {k: e[0] for k, e in entries.items()}, None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(self._copy_stream):
            out = {k: e[0].to(dev, non_blocking=True)
                   for k, e in entries.items()}
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        for k, e in entries.items():
            e[1] = event
            self._pinned[k + (tuple(e[0].shape), e[0].dtype)].append(e)
        return out, event

    def _stage_chunk(self, rounds: int, local_epochs: int):
        """Draw the chunk's minibatches through the session's data cursor
        (the per-client sequence the reference engine would consume, in
        client-index order) straight into ``{li: [rounds, E, k, B, ...]}``
        host buffers, then move them to the device.  Returns ``(xs, ys,
        event)``."""
        def drawn(i):
            while True:
                yield self.ctx.data.draw(i)

        entries: Dict[tuple, list] = {}
        for i in range(self.ctx.N):
            li, j = self._lane_pos[i]
            it = drawn(i)
            first = next(it)          # fixes the staged shapes and dtypes
            if (li, "x") not in entries:
                k = self._counts[li]
                for name, a in zip("xy", first):
                    entries[li, name] = self._host_buffer(
                        (li, name), (rounds, local_epochs, k, *a.shape),
                        torch_dtype(a.dtype))
            bx, by = (entries[li, name][0].numpy() for name in "xy")
            prestage_batches(itertools.chain([first], it), rounds,
                             local_epochs, out=(bx[:, :, j], by[:, :, j]))
        out, event = self._put(entries)
        return ({li: out[li, "x"] for li in self._cohort_lis},
                {li: out[li, "y"] for li in self._cohort_lis}, None, event,
                None)

    def _stage_population_chunk(self, rounds: int, local_epochs: int):
        """Population staging: per round, the participation plan from the
        population cursor, each active slot's lane filled from its
        assigned client's seeded stream, the other lanes zero; beside the
        batches a ``[rounds, k]`` 0/1 mask per cohort, copied with them.
        Returns ``(xs, ys, ms, event, plans)``, ``plans`` the host record
        of each round: ``(active, stragglers, slot mask)``."""
        ctx = self.ctx
        entries: Dict[tuple, list] = {}
        for li in self._cohort_lis:
            x0, y0 = ctx.client_data[self._lanes[li][0]]
            k, B = self._counts[li], ctx.batch_size
            for name, a in (("x", x0), ("y", y0)):
                entries[li, name] = self._host_buffer(
                    (li, name), (rounds, local_epochs, k, B, *a.shape[1:]),
                    torch_dtype(a.dtype))
            entries[li, "m"] = self._host_buffer((li, "m"), (rounds, k),
                                                 torch.float32)
        for e in entries.values():
            e[0].zero_()                # pinned buffers are reused
        host = {key: e[0].numpy() for key, e in entries.items()}
        plans = []
        for r in range(rounds):
            plan, slot_batches = ctx.pop_cursor.next_round(local_epochs)
            plans.append((plan.num_active, plan.num_stragglers,
                          plan.slot_mask))
            for e, drawn in slot_batches.items():
                li, j = self._lane_pos[e]
                host[li, "m"][r, j] = 1.0
                for ei, (x, y) in enumerate(drawn):
                    host[li, "x"][r, ei, j] = x
                    host[li, "y"][r, ei, j] = y
        out, event = self._put(entries)
        return ({li: out[li, "x"] for li in self._cohort_lis},
                {li: out[li, "y"] for li in self._cohort_lis},
                {li: out[li, "m"] for li in self._cohort_lis}, event, plans)

    def _round_stage_bytes(self, local_epochs: int) -> int:
        """Host bytes one round of staged batches occupies (every client's
        ``local_epochs`` minibatches, x and y)."""
        total = 0
        for x, y in self.ctx.client_data:
            eb = effective_batch_size(len(x), self.ctx.batch_size)
            per_example = (x.dtype.itemsize * int(np.prod(x.shape[1:]))
                           + y.dtype.itemsize * int(np.prod(y.shape[1:])))
            total += local_epochs * eb * per_example
        return total

    def _auto_chunk_rounds(self, rounds: int, local_epochs: int,
                           overlap: bool = False) -> int:
        """The chunk size for ``chunk_rounds=0``: as many rounds as fit the
        staging budget (at least one), the budget divided by
        ``pipeline_depth`` under overlap.  An explicit per-instance
        ``stage_budget_bytes`` wins over REPRO_STAGE_BUDGET_MB; either must
        be strictly positive."""
        budget = self.stage_budget_bytes
        env = os.environ.get("REPRO_STAGE_BUDGET_MB")
        if env and budget == FusedEngine.stage_budget_bytes:
            try:
                budget = int(env) << 20
            except ValueError:
                raise ValueError(
                    f"REPRO_STAGE_BUDGET_MB={env!r} is not an integer "
                    f"megabyte count") from None
            if budget <= 0:
                raise ValueError(
                    f"REPRO_STAGE_BUDGET_MB={env} must be strictly "
                    f"positive: a 0/negative staging budget cannot hold "
                    f"even one round of staged batches")
        if budget <= 0:
            raise ValueError(
                f"stage_budget_bytes={budget} must be strictly positive: "
                f"a 0/negative staging budget cannot hold even one round "
                f"of staged batches (set FusedEngine.stage_budget_bytes "
                f"or REPRO_STAGE_BUDGET_MB to a real byte/MB count)")
        if overlap:
            budget //= self.pipeline_depth
        per_round = max(1, self._round_stage_bytes(local_epochs))
        return max(1, min(rounds, budget // per_round))

    def _overlap_enabled(self) -> bool:
        """The ``overlap_staging`` knob, REPRO_OVERLAP_STAGING (0 / false /
        off / no disables, anything else enables) taking precedence."""
        env = os.environ.get("REPRO_OVERLAP_STAGING")
        if env is not None:
            return env.strip().lower() not in ("0", "false", "off", "no")
        return self.overlap_staging

    def _chunk_plan(self, rounds: int, chunk_rounds: int,
                    local_epochs: int, overlap: bool) -> List[int]:
        """The run's chunk sizes in execution order.  An explicit
        ``chunk_rounds`` is honoured exactly; the auto default is the
        staging-budget chunk, cut into up to ``pipeline_min_chunks`` equal
        pieces when overlap is on and the budget covers the run in one
        chunk."""
        chunk = (chunk_rounds if chunk_rounds > 0
                 else self._auto_chunk_rounds(rounds, local_epochs, overlap))
        if (chunk_rounds <= 0 and overlap and chunk >= rounds
                and rounds >= 2):
            pieces = min(self.pipeline_min_chunks, rounds)
            chunk = -(-rounds // pieces)                   # ceil
        plan = []
        done = 0
        while done < rounds:
            n = min(chunk, rounds - done)
            plan.append(n)
            done += n
        return plan

    # --------------------------------------------------------------- carry
    def _stack_carry(self, state: TrainState) -> Dict[int, tuple]:
        """Each cohort's (client, copt, server, sopt) stacked along the lane
        axis: copies, so the steps' in-place updates leave ``state``
        alone."""
        model = self.ctx.model
        carry = {}
        for li in self._cohort_lis:
            lanes = self._lanes[li]
            carry[li] = (
                model.stack_clients([state.clients[i] for i in lanes]),
                _stack_opts([state.client_opts[i] for i in lanes]),
                model.stack_clients([state.servers[i] for i in lanes]),
                _stack_opts([state.server_opts[i] for i in lanes]))
        return carry

    def _host_steps(self, state: TrainState) -> List[List[int]]:
        """Each client's Adam steps ``[client, server]`` on the host."""
        return [[c.step, s.step] for c, s in zip(state.client_opts,
                                                 state.server_opts)]

    def _unstack_carry(self, carry, state: TrainState,
                       steps: List[Tuple[int, int]]) -> TrainState:
        """The carry as per-client tensors of their own, client ``i``'s Adam
        states at the host steps ``steps[i]`` (client, server)."""
        parts = [list(state.clients), list(state.client_opts),
                 list(state.servers), list(state.server_opts)]
        for li in self._cohort_lis:
            for j, i in enumerate(self._lanes[li]):
                at = (0, steps[i][0], 0, steps[i][1])
                for part, tree, step in zip(parts, carry[li], at):
                    part[i] = _lane(tree, j, step)
        return state.replace(clients=tuple(parts[0]),
                             client_opts=tuple(parts[1]),
                             servers=tuple(parts[2]),
                             server_opts=tuple(parts[3]))

    # ------------------------------------------------------------ training
    def _cohort_step(self, li: int, carry, x, y, lr, lr_s, m=None):
        """One step of cohort ``li`` (``m``: its lanes' mask under a
        population).  Returns the new carry entry and the lanes' (client,
        server) losses."""
        c, co, s, so, cl, sl = self._steps[li](
            *carry, x, y, lr, lr_s, *(() if m is None else (m,)))
        return (c, co, s, so), cl, sl

    def _aggregate(self, carry, ms, r: int) -> None:
        """Eq. (1) on the stacked servers of every cohort, in place (masked
        by round ``r``'s masks under a population)."""
        for part in ("trainable", "state"):
            servers = {li: carry[li][2][part] for li in self._cohort_lis}
            if ms is None:
                stacked_cross_layer_aggregate(servers, self._lanes)
            else:
                masked_stacked_cross_layer_aggregate(
                    servers, {li: ms[li][r] for li in ms}, self._lanes)

    def _reduce_losses(self, closs, sloss, ms, n: int, local_epochs: int):
        """The per-round (client, server) mean losses of a chunk's steps'
        lane losses, as two ``[n]`` float64 tensors on the device: over
        every client, or over the round's active clients (an all-masked
        round reads 0)."""
        if ms is None:
            denom = float(self.ctx.N * local_epochs)
        else:
            active = sum(m.sum(1) for m in ms.values())
            denom = active.clamp(min=1.0).double() * local_epochs
        per_round = lambda ls: (torch.cat(ls).double().view(n, -1)  # noqa: E731
                                .sum(1) / denom)
        return per_round(closs), per_round(sloss)

    def _run_chunk(self, carry, t0: int, n: int, xs, ys, ms,
                   local_epochs: int):
        """``n`` rounds from round ``t0`` on the staged batches (and, under a
        population, the staged masks ``ms``); the carry is updated in place.
        Returns :meth:`_reduce_losses` of the chunk."""
        ctx = self.ctx
        closs, sloss = [], []
        for r in range(n):
            t = t0 + r
            lr = ctx.schedule(t)
            lr_s = lr / ctx.server_lr_div
            for e in range(local_epochs):
                for li in self._cohort_lis:
                    carry[li], cl, sl = self._cohort_step(
                        li, carry[li], xs[li][r, e], ys[li][r, e], lr, lr_s,
                        None if ms is None else ms[li][r])
                    closs.append(cl)
                    sloss.append(sl)
            if (ctx.strategy == "averaging"
                    and (t + 1) % ctx.cfg.aggregate_every == 0):
                self._aggregate(carry, ms, r)
        return self._reduce_losses(closs, sloss, ms, n, local_epochs)

    def _chunk_metrics(self, t0: int, n: int, closs, sloss, plans,
                       log_every: int) -> List[RoundMetrics]:
        """The chunk's metrics (``plans``: the staged population plans, or
        ``None``); the one host read of the chunk."""
        losses = torch.stack([closs, sloss]).cpu()       # one sync a chunk
        self.last_host_syncs += 1
        metrics = []
        for r in range(n):
            a, st = plans[r][:2] if plans is not None else (-1, 0)
            m = RoundMetrics(t0 + r, float(losses[0, r]),
                             float(losses[1, r]), active_clients=a,
                             stragglers=st)
            metrics.append(m)
            if log_every and (m.round % log_every == 0):
                extra = (f"  active {a}/{self.ctx.N}  stragglers {st}"
                         if plans is not None else "")
                print(f"round {m.round:4d}  client_loss {m.client_loss:.4f}"
                      f"  server_loss {m.server_loss:.4f}{extra}")
        return metrics

    def run(self, state: TrainState, rounds: int, local_epochs: int = 1,
            log_every: int = 0, chunk_rounds: int = 0
            ) -> Tuple[TrainState, List[RoundMetrics]]:
        """``chunk_rounds`` bounds how many rounds of staged data are
        resident at once (0 = auto: budget-sized chunks, cut for the
        staging pipeline; chunking never changes the trajectory).

        The carry is stacked once per run and stays on the device across
        chunks; a background producer stages chunk n+1 while chunk n's
        launches run, and the host reads chunk n's losses only after chunk
        n+1 is dispatched."""
        if rounds <= 0:
            return state, []
        ctx = self.ctx
        population = ctx.population is not None
        if population:
            # round-addressed: the seeded schedule replays rounds [0, t0)
            # after a restore or a rewind
            ctx.pop_cursor.align(state.round, local_epochs)
        else:
            ctx.data.align(state.batches_drawn)
        overlap = self._overlap_enabled()
        plan = self._chunk_plan(rounds, chunk_rounds, local_epochs, overlap)
        # each client's Adam steps (client, server), counted on the host
        # from the staged plans
        steps = self._host_steps(state)
        carry = self._stack_carry(state)
        t0 = state.round
        self.last_host_syncs = 0
        stage = (self._stage_population_chunk if population
                 else self._stage_chunk)
        pipeline = StagedChunkPipeline(
            lambda n: stage(n, local_epochs), plan,
            depth=self.pipeline_depth, overlap=overlap)
        metrics: List[RoundMetrics] = []
        pending = None          # (chunk start, n, closs, sloss, plans)
        try:
            t = t0
            for n in plan:
                xs, ys, ms, event, plans = pipeline.get()
                if event is not None:
                    stream = torch.cuda.current_stream(ctx.model.device)
                    stream.wait_event(event)
                    for a in itertools.chain(xs.values(), ys.values(),
                                             (ms or {}).values()):
                        a.record_stream(stream)
                closs, sloss = self._run_chunk(carry, t, n, xs, ys, ms,
                                               local_epochs)
                del xs, ys, ms
                for i in range(ctx.N):
                    took = local_epochs * (n if plans is None else sum(
                        p[2][i] > 0 for p in plans))
                    steps[i] = [steps[i][0] + took, steps[i][1] + took]
                # only now read the previous chunk's losses: reading this
                # chunk's would wait for its launches to finish
                if pending is not None:
                    metrics.extend(self._chunk_metrics(*pending, log_every))
                    pipeline.release()
                pending = (t, n, closs, sloss, plans)
                t += n
            metrics.extend(self._chunk_metrics(*pending, log_every))
            pipeline.release()
        finally:
            pipeline.close()
            self.last_stage_stats = pipeline.stats.as_dict()
        if population:
            actives = [m.active_clients for m in metrics]
            strags = [m.stragglers for m in metrics]
            self.last_participation_stats = {
                "rounds": len(metrics),
                "slots": ctx.N,
                "population": ctx.population.num_clients,
                "active_total": int(sum(actives)),
                "active_mean": (float(np.mean(actives)) if actives
                                else 0.0),
                "straggler_total": int(sum(strags)),
                "masked_total": int(len(metrics) * ctx.N - sum(actives)),
                "active_per_round": actives,
                "stragglers_per_round": strags,
            }
        new_state = self._unstack_carry(carry, state, steps).replace(
            round=t0 + rounds,
            batches_drawn=tuple(c + rounds * local_epochs
                                for c in state.batches_drawn))
        return new_state, metrics

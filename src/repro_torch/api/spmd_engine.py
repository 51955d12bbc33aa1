"""SPMD engine: the fused round body over the ranks of a
``torch.distributed`` world, placed by a sharding recipe (counterpart of
``repro/api/spmd_engine.py``).

This is the scaling story for the Averaging and distributed strategies.
The JAX engine compiles the fused engine's scanned round body with
``NamedSharding`` constraints from ``launch.shardings`` and lets XLA's
partitioner insert the collectives.  The port runs the fused engine's
chunk loop on every rank and places and moves the tensors itself, by the
same recipe rules:

  * **Placement.**  Every carry leaf (stacked clients and servers, Adam
    moments, BatchNorm statistics, each ``[E, ...]``) is placed by
    ``launch.shardings.train_state_specs`` on the JAX package's layout
    of the carry (``shardings.jax_layout``; the specs mapped back onto the
    port's leaves): a lane dim over ``"lanes"`` leaves each rank its slice
    of the cohort's lanes, a dim over ``"data"`` (FSDP) or ``"model"`` its
    chunk.  Adam moments mirror their params.
  * **Batches.**  Every rank draws the same seeded stream (the data layer
    is deterministic) and keeps its lanes and rows of each staged
    ``[rounds, local_epochs, E, B, ...]`` chunk by ``stage_batch_spec``:
    no batch data crosses ranks.  Population masks follow the lanes.
  * **A step.**  The rank all-gathers its lanes' sharded leaves into whole
    tensors, runs the cohort's forward and backward on its rows
    (``core.spmd.make_cohort_grad_step``), averages the gradients over the
    batch axes, and updates its chunk of each parameter and moment in
    place (the clip norm taken over the whole gradient).  BatchNorm's
    batch statistics are summed over the batch axes
    (``models.sync_stats``), so the forward, the gradients and the running
    statistics are the whole-batch values.  A MoE block routes the whole
    batch as one group through the same context (``models/moe.py``): the
    capacity and the router aux loss are taken over the whole batch, the
    expert loads summed over the batch ranks.
  * **Eq. (1)** sums over lanes: with lanes spread over ranks, each rank
    sums its lanes per layer and the partial sums (and, under a
    population, the masked counts) are summed over the lanes group before
    the division (``core.aggregation.partial_cross_layer_aggregate``).
  * **Results.**  Losses are summed over the lanes and batch ranks once per
    chunk.  A run returns the state as this rank's chunks
    (``api.state.ShardedTrainState``): the carry itself, each leaf cut by
    the specs above and only this rank's lanes of a cohort spread over
    the lanes axis, the Adam steps on the host beside them -- the port's
    counterpart of the JAX engine's device-resident slices.  The next run
    on the same engine takes them as its carry (no gather, no cut); a
    whole ``TrainState`` (the session's initial one, a restored
    checkpoint, another engine's state) is cut once, by :meth:`place`.
    Whole values are read explicitly and collectively:
    ``ShardedTrainState.whole`` (checkpoints, hand-offs: one leaf at a
    time) and ``ShardedTrainState.nets`` (evaluation: one client's nets
    at a time).  :attr:`SpmdEngine.state_bytes` counts the bytes a rank
    holds.

  * **Tensor parallelism over ``"model"``** (a ``BackboneSplitModel``).
    ``launch.shardings.tp_roles`` reads each leaf's ``"model"`` dim
    against its product: attention's, MLA's, RWKV6's (time and channel
    mix) and Mamba2's projections, the SwiGLU's three weights (a MoE
    block's shared expert too), the embedding and the heads' unembedding
    split over the vocab are ``column`` or ``row``, and an expert stack
    is ``expert`` over the grid or ``column``/``row`` over its hidden
    dims; each stays this rank's ``"model"`` chunk for compute (gathered
    over its FSDP axes only; an expert stack keeps its "data" chunk too,
    below).
    The step runs inside ``launch.tensor_parallel.model_parallel`` over
    the rank's model group, whose products multiply with the chunks (the
    logits stay split over the vocab into the vocab-parallel cross
    entropy), and their gradients are the chunks' own.  Every other leaf
    (norms, the router, the token-shift mixes, Mamba2's conv and scan
    parameters, the frontend, an indivisible head count; each role says
    why) is gathered whole, and its gradient is whole and equal on every
    model rank.  The clip norm sums the split leaves' squares over the
    group and counts the others once.

  * **Expert parallelism over the batch ranks** (a MoE backbone whose
    expert stacks have E over "data": the grid, or the data layout).
    Each rank keeps its chunk of the experts for compute -- over the
    grid chunk i * P + m of rank (i, m) -- and no expert weight is
    gathered in a step.  The step runs inside
    ``launch.tensor_parallel.expert_parallel`` over the rank's data
    group, where a MoE block's dispatch and combine are an all_to_all
    over it (``models/moe.py``).  An owner's expert gradient already sums
    every batch rank's entries: those leaves skip the all-reduce over the
    batch axes they are kept over (:func:`grad_reduce_axes`) but take the
    same ``/dp``, and the clip norm sums their squares over their axes.

The gathers and the gradients' reduction use all_reduce and all_gather,
the experts' exchange all_to_all (gloo and NCCL take them;
``launch/meshcomm.py``).  Sequence parallelism, reduce-scatter and
overlapping the gathers with compute are not done (ROADMAP.md item 9b-4).

Meshes: ``TrainSession(..., mesh=...)`` -- a live mesh from
``launch.mesh`` (``make_lane_host_mesh(2)``, ``make_host_mesh((2, 2, 1),
("lanes", "data", "model"))``, ``make_production_mesh()``) or a
``MeshSpec`` of the world's size -- or none, for the default data mesh
over every rank.  Recipes: ``TrainSession(..., recipe=...)``, a name of
``launch.shardings.NAMED_RECIPES`` or a ``ShardingRecipe``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional

import torch

from repro_torch.api.engines import (SessionContext, cohort_layout,
                                     register_engine)
from repro_torch.api.fused_engine import FusedEngine, _stack_opts
from repro_torch.api.state import ShardedTrainState, TrainState
from repro_torch.core.aggregation import partial_cross_layer_aggregate
from repro_torch.core.spmd import make_cohort_grad_step
from repro_torch.core.strategies import masked_update
from repro_torch.data.pipeline import effective_batch_size
from repro_torch.launch.mesh import (MeshSpec, as_spec, axis_sizes,
                                     batch_axes, lane_axis, live_mesh,
                                     world_size)
from repro_torch.launch.meshcomm import (  # noqa: F401 (re-exported)
    MeshComm, _axes, all_reduce_plan, chunk_shapes, gather_plan, plan_bytes,
    unshard_plan)
from repro_torch.launch.shardings import (_lookup, compute_spec,
                                          expert_axes, is_expert_stack,
                                          jax_layout, kept_experts,
                                          kept_spec,
                                          map_with_path,
                                          port_specs, resolve_recipe,
                                          spec_leaves, stage_batch_spec,
                                          tp_roles, train_state_specs,
                                          tree_paths)
from repro_torch.launch.tensor_parallel import (ExpertGroup, ModelGroup,
                                                expert_parallel,
                                                model_parallel)
from repro_torch.models.sync_stats import synced_batch_stats
from repro_torch.optim.adam import adam_update, lane_norms


def default_mesh_spec() -> MeshSpec:
    """A 1-D data-parallel mesh over every rank of the world."""
    return MeshSpec((world_size(), 1), ("data", "model"))


def resolve_mesh(ctx: SessionContext):
    """The mesh this session's spmd engine runs on, as a spec or a live
    mesh: ``ctx.mesh`` when one was supplied, else the default data
    mesh."""
    return ctx.mesh if ctx.mesh is not None else default_mesh_spec()


def data_parallelism(mesh) -> int:
    """Total batch-axis parallelism of ``mesh`` (product of the ``pod`` and
    ``data`` axis sizes present)."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in batch_axes(mesh))


def _model_cfg(model):
    """The backbone config of a ``BackboneSplitModel`` (its carry is
    restacked per run for the recipe), else ``None`` (conv weights are the
    one layout to map)."""
    from repro_torch.core.backbone_splitee import BackboneSplitModel
    return model.cfg if isinstance(model, BackboneSplitModel) else None


def _model_num_experts(model) -> int:
    cfg = getattr(model, "cfg", None)
    moe = getattr(cfg, "moe", None)
    return int(moe.num_experts) if moe is not None else -1


def abstract_cohort_carry(model, split_layers, opt_cfg):
    """The engines' cohort carry ``{li: (client, client_opt, server,
    server_opt)}`` as meta tensors, every leaf with a leading lane dim:
    one lane's nets are built and their shapes widened to the cohort (no
    cohort-sized tensor is allocated)."""
    from repro_torch.api.fused_engine import _stack_opts
    from repro_torch.optim import adam_init
    lis, lanes = cohort_layout(split_layers)
    carry = {}
    for li in lis:
        c, s = model.make_client(li), model.make_server(li)
        one = (model.stack_clients([c]),
               _stack_opts([adam_init(c["trainable"], opt_cfg)]),
               model.stack_clients([s]),
               _stack_opts([adam_init(s["trainable"], opt_cfg)]))
        k = len(lanes[li])
        carry[li] = map_with_path(
            lambda _, t, k=k: torch.empty((k,) + tuple(t.shape[1:]),
                                          dtype=t.dtype, device="meta"), one)
    return carry


def carry_specs(recipe, mesh, carry, model):
    """The recipe's spec of every leaf of a port cohort carry (whole or
    local lanes; only its shapes are read): ``train_state_specs`` on the
    carry's JAX-package layout, mapped back onto the port's leaves."""
    cfg = _model_cfg(model)
    specs = train_state_specs(recipe, mesh, jax_layout(carry, cfg, lead=1),
                              num_experts=_model_num_experts(model))
    return port_specs(specs, carry, cfg, lead=1)


def _on_meta(_, t):
    """A tensor's shape and dtype on the meta device (anything else as
    it is: an Adam state's host step)."""
    if isinstance(t, torch.Tensor):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")
    return t


def grad_reduce_axes(batch_axes, experts) -> tuple:
    """The axes a leaf's gradient is all-reduced over: the batch axes but
    those its expert stack keeps its chunk over, where an owner's
    gradient already sums every batch rank's entries (a module function:
    ``parity.reduced_expert_grads`` replaces it)."""
    return tuple(a for a in batch_axes if a not in experts)


def resume_carry(engine: "SpmdEngine", state: ShardedTrainState):
    """The carry of a run that starts from ``engine``'s own chunks: the
    chunks themselves, taken from ``state`` (a module function:
    ``parity.shifted_chunks`` replaces it)."""
    return state.take()


@register_engine("spmd")
class SpmdEngine(FusedEngine):
    """The fused engine's round body over the ranks of a mesh, placed by a
    sharding recipe: the fused chunk loop with its step, Eq. (1) and loss
    hooks run over this rank's lanes and rows."""

    def __init__(self, ctx: SessionContext):
        super().__init__(ctx)
        mesh = resolve_mesh(ctx)
        self.mesh = live_mesh(mesh) if isinstance(mesh, MeshSpec) else mesh
        self.recipe = resolve_recipe(ctx.recipe)
        self.comm = MeshComm(self.mesh)
        sizes = axis_sizes(self.mesh)
        self._batch_axes = tuple(a for a in batch_axes(self.mesh)
                                 if sizes[a] > 1)
        self._dp = self.comm.size(self._batch_axes)
        lax_name = lane_axis(self.mesh)
        self._lane_axes = ((lax_name,) if lax_name and sizes[lax_name] > 1
                           else ())
        # per cohort: the local lanes (positions in the cohort) and rows
        self._local: Dict[int, List[int]] = {}
        self._rows: Dict[int, Optional[slice]] = {}
        self._owned: Dict[int, bool] = {}
        self._lane_sharded = False
        for li in self._cohort_lis:
            i0 = self._lanes[li][0]
            eb = effective_batch_size(len(ctx.client_data[i0][0]),
                                      ctx.batch_size)
            spec = stage_batch_spec(self.recipe, self.mesh, self._counts[li],
                                    eb)
            k = self._counts[li]
            if spec[2] is not None:
                n = self.comm.size(_axes(spec[2]))
                j = self.comm.index(_axes(spec[2]))
                self._local[li] = list(range(j * k // n, (j + 1) * k // n))
                self._owned[li] = True
                self._lane_sharded = True
            else:
                self._local[li] = list(range(k))
                self._owned[li] = all(self.comm.coord[a] == 0
                                      for a in self._lane_axes)
            if spec[3] is not None:
                n = self.comm.size(_axes(spec[3]))
                j = self.comm.index(_axes(spec[3]))
                self._rows[li] = slice(j * eb // n, (j + 1) * eb // n)
            else:
                self._rows[li] = None
        self._specs: Dict[int, tuple] = {}
        # the tensor-parallel group over the model axis (a backbone only)
        tp_axis = self.recipe.tp_axis
        self._tp: Optional[ModelGroup] = None
        if (_model_cfg(ctx.model) is not None
                and sizes.get(tp_axis, 1) > 1):
            pg, _ = self.comm.group((tp_axis,))
            self._tp = ModelGroup(pg, sizes[tp_axis],
                                  self.comm.index((tp_axis,)))
        self._roles: Dict[int, tuple] = {}
        self._cspecs: Dict[int, tuple] = {}
        # the expert-parallel group over the batch ranks (set with the
        # roles, where an expert stack keeps its chunk over them)
        self._ep: Optional[ExpertGroup] = None
        #: bytes gathered per cohort step in the latest run (this rank)
        self.last_gathered_bytes_per_step = 0.0
        #: bytes of the tensor-parallel collectives per cohort step
        self.last_tp_bytes_per_step = 0.0
        #: bytes of the experts' dispatch and combine exchanges per cohort
        #: step (this rank's entries' rows that crossed ranks, both ways)
        self.last_exchange_bytes_per_step = 0.0
        #: the experts of an expert stack a rank holds for compute (0: no
        #: expert stack)
        self.experts_per_rank = 0
        #: bytes of the session's state this rank holds (its chunks of the
        #: latest state this engine placed or returned)
        self.state_bytes = 0

    @classmethod
    def supports(cls, ctx: SessionContext) -> Optional[str]:
        reason = super().supports(ctx)           # strategy + ragged cohorts
        if reason:
            return reason
        n = world_size()
        if ctx.mesh is None and n < 2:
            return ("needs a mesh (TrainSession(..., mesh=...)) or more "
                    "than one rank (launch with --host-devices N or "
                    "--distributed); only 1 rank in the torch.distributed "
                    "world")
        mesh = resolve_mesh(ctx)
        spec = as_spec(mesh)
        recipe = resolve_recipe(ctx.recipe)
        sizes = axis_sizes(mesh)
        dp = data_parallelism(mesh)
        lax_name = lane_axis(mesh)
        lane_sz = (sizes.get(lax_name, 1)
                   if lax_name and recipe.shard_lanes else 1)
        tensor_parallel = (_model_cfg(ctx.model) is not None
                           and sizes.get(recipe.tp_axis, 1) > 1)
        if dp < 2 and lane_sz < 2 and not tensor_parallel:
            if lax_name and sizes.get(lax_name, 1) > 1:
                return (f"mesh {sizes} only has parallelism on its lanes "
                        f"axis, which recipe {ctx.recipe_name!r} disables "
                        f"(shard_lanes=False); pick a lane-sharding recipe "
                        f"or a mesh with batch-axis parallelism")
            return (f"mesh {sizes} has no parallelism on its batch axes "
                    f"{batch_axes(mesh)} or a lanes axis")
        for i, (xd, _) in enumerate(ctx.client_data):
            eb = effective_batch_size(len(xd), ctx.batch_size)
            if dp > 1 and eb % dp != 0:
                return (f"client {i}'s effective batch size {eb} does not "
                        f"divide over the data-parallel size {dp}; adjust "
                        f"batch_size or the mesh")
        if lane_sz > 1:
            _, lanes = cohort_layout(ctx.profile.split_layers)
            counts = {li: len(v) for li, v in lanes.items()}
            if not any(c % lane_sz == 0 for c in counts.values()):
                return (f"the mesh's {lane_sz}-way lanes axis divides no "
                        f"cohort's lane count {counts}; equalize cohort "
                        f"sizes, shrink the lanes axis, or use a mesh "
                        f"without one")
        if spec.size != n:
            return (f"mesh {sizes} has {spec.size} ranks but the "
                    f"torch.distributed world has {n}")
        return None

    # ------------------------------------------------------------- layout
    def _carry_specs(self, carry) -> Dict[int, tuple]:
        """The spec of every leaf of the local-lane carry, computed on the
        whole carry's shapes."""
        def whole(path, t):
            k = self._counts[path[0]]
            return torch.empty((k,) + tuple(t.shape[1:]), dtype=t.dtype,
                               device="meta")
        return carry_specs(self.recipe, self.mesh,
                           map_with_path(whole, carry), self.ctx.model)

    def _shard(self, t: torch.Tensor, spec) -> torch.Tensor:
        """This rank's chunk of a local-lane tensor (its lane dim already
        local)."""
        return self.comm.shard(t, spec)

    def _unshard(self, tree, specs, lanes: bool = False):
        """``tree`` with every leaf whole again (and, with ``lanes``, the
        lane dim gathered over the lanes axis)."""
        return self.comm.unshard(tree, specs,
                                 self._lane_axes if lanes else ())

    def _tree(self, fn, tree, specs):
        return map_with_path(lambda p, t: fn(t, _lookup(specs, p)), tree)

    # --------------------------------------------------------------- carry
    def place(self, state) -> ShardedTrainState:
        """``state`` as this rank's chunks: this engine's own chunks as
        they are; a whole ``TrainState`` cut by :meth:`_cut`; another
        engine's chunks gathered whole first (collective)."""
        if isinstance(state, ShardedTrainState):
            if state.engine is self:
                return state
            state = state.whole()
        out = ShardedTrainState(
            self, self._cut(state), self._host_steps(state), state.round,
            state.batches_drawn)
        self.state_bytes = out.nbytes
        return out

    def _host_steps(self, state) -> List[List[int]]:
        if isinstance(state, ShardedTrainState):
            return [list(s) for s in state.steps]
        return super()._host_steps(state)

    def _stack_carry(self, state):
        """The run's carry: the chunks of ``state`` placed by
        :meth:`place` (:func:`resume_carry`)."""
        return resume_carry(self, self.place(state))

    def _cut(self, state: TrainState):
        """This rank's lanes of each cohort, stacked, each leaf cut to its
        chunk by the recipe.  The specs are read on the stacked shapes
        alone, and each part of a cohort is stacked and cut before the
        next, so a rank never holds a stacked copy of the whole carry."""
        model = self.ctx.model
        stackers = (model.stack_clients, _stack_opts, model.stack_clients,
                    _stack_opts)

        def lanes(li, on_meta=False):
            ids = [self._lanes[li][j] for j in self._local[li]]
            parts = ([state.clients[i] for i in ids],
                     [state.client_opts[i] for i in ids],
                     [state.servers[i] for i in ids],
                     [state.server_opts[i] for i in ids])
            if on_meta:
                parts = tuple([map_with_path(_on_meta, t) for t in trees]
                              for trees in parts)
            return parts

        carry = {li: tuple(stack(trees) for stack, trees in zip(
                     stackers, lanes(li, on_meta=True)))
                 for li in self._cohort_lis}
        self._specs = self._carry_specs(carry)
        cfg = _model_cfg(self.ctx.model)
        for li in carry:
            specs = self._specs[li]
            if cfg is None:
                self._cspecs[li] = specs
                continue
            roles = tp_roles(carry[li], specs, self.mesh, cfg, self.recipe,
                             lead=1)
            self._roles[li] = roles
            axes = expert_axes(roles)
            if axes and self._ep is None:
                pg, _ = self.comm.group(axes)
                self._ep = ExpertGroup(pg, self.comm.size(axes),
                                       self.comm.index(axes), kept_experts(
                                           roles, cfg.moe.num_experts,
                                           self.comm.sizes,
                                           self.recipe.tp_axis))
            self._cspecs[li] = map_with_path(
                lambda p, _: compute_spec(_lookup(specs, p),
                                          _lookup(roles, p),
                                          self.recipe.tp_axis), carry[li])
            for p, t in tree_paths(carry[li]):
                if is_expert_stack(cfg, p):
                    kept = kept_spec(_lookup(specs, p), _lookup(roles, p),
                                     self.recipe.tp_axis)
                    self.experts_per_rank = t.shape[1] // self.comm.size(
                        _axes(kept[1]))
        out = {li: tuple(self._tree(self._shard, stack(trees), specs)
                         for stack, trees, specs in zip(
                             stackers, lanes(li), self._specs[li]))
               for li in carry}
        self._chunks = {li: map_with_path(_on_meta, out[li]) for li in out}
        return out

    def planned_gathered_bytes_per_step(self, experts: bool = False
                                        ) -> float:
        """The bytes a cohort step gathers on this rank by
        :func:`unshard_plan` (the client's and the server's chunks of each
        cohort), averaged over the cohorts, which step equally often: what
        :attr:`last_gathered_bytes_per_step` measures.  ``experts``: of
        the expert stacks' leaves alone (0 where they keep their chunks
        over the batch ranks)."""
        cfg = _model_cfg(self.ctx.model)

        def only(li, part):
            tree = self._chunks[li][part]
            if not experts:
                return tree
            return map_with_path(
                lambda p, t: t if cfg is not None and is_expert_stack(
                    cfg, p) else None, tree)

        per = [plan_bytes(unshard_plan(only(li, part),
                                       self._cspecs[li][part],
                                       self.comm.sizes))
               for li in self._cohort_lis for part in (0, 2)]
        n = len(self._cohort_lis)
        return sum(per) / n

    def _unstack_carry(self, carry, state, steps) -> ShardedTrainState:
        """The carry as the run's result: this rank's chunks, the host
        steps beside them (nothing gathered)."""
        out = ShardedTrainState(self, carry, steps, state.round,
                                state.batches_drawn)
        self.state_bytes = out.nbytes
        return out

    def _lane_axes_of(self, li: int) -> tuple:
        """The axes cohort ``li``'s lanes are spread over (none where each
        rank holds them all)."""
        return (self._lane_axes
                if len(self._local[li]) != self._counts[li] else ())

    def whole_state(self, sts: ShardedTrainState, device=None) -> TrainState:
        """``ShardedTrainState.whole``: every leaf gathered over its shards
        and lanes and unstacked as the fused engine does (client ``i``'s
        Adam states at its host steps).  One leaf at a time: beside the
        chunks and the whole state a rank holds at most one whole stacked
        leaf; with ``device`` each whole leaf moves there first."""
        carry = sts.carry
        parts = [[None] * sts.num_clients for _ in range(4)]
        for li in self._cohort_lis:
            ids = self._lanes[li]
            for k in range(4):
                cut = {}
                for path, t in tree_paths(carry[li][k]):
                    whole = self.comm.unshard(
                        t, _lookup(self._specs[li][k], path),
                        self._lane_axes_of(li))
                    if device is not None:
                        whole = whole.to(device)
                    cut[path] = ([whole[0]] if len(ids) == 1 else
                                 [whole[j].clone() for j in range(len(ids))])
                    del whole
                for j, i in enumerate(ids):
                    tree = map_with_path(lambda p, _: cut[p][j],
                                         self._chunks[li][k])
                    if k % 2:
                        tree = dataclasses.replace(
                            tree, step=sts.steps[i][k // 2])
                    parts[k][i] = tree
        return TrainState(clients=tuple(parts[0]),
                          client_opts=tuple(parts[1]),
                          servers=tuple(parts[2]),
                          server_opts=tuple(parts[3]), round=sts.round,
                          batches_drawn=sts.batches_drawn)

    def client_nets(self, sts: ShardedTrainState, i: int):
        """``ShardedTrainState.nets``: client ``i``'s client and server
        nets whole, its lane alone gathered over the shards (and, where
        the cohort's lanes are spread, from the rank that holds it)."""
        li, j = self._lane_pos[i]
        axes = self._lane_axes_of(li)
        at, owner = j, 0
        if axes:
            per = len(self._local[li])
            owner = j // per
            at = j - owner * per if self.comm.index(axes) == owner else 0

        def net(part):
            lane = map_with_path(lambda _, t: t.narrow(0, at, 1),
                                 sts.carry[li][part])
            whole = self.comm.unshard(lane, self._specs[li][part], axes)
            return map_with_path(lambda _, t: t[owner], whole)
        return net(0), net(2)

    # ------------------------------------------------------------- staging
    def _keep_local(self, xs, ys, ms):
        """This rank's lanes and rows of a staged chunk (views)."""
        def cut(t, li, rows=True):
            lanes = self._local[li]
            if len(lanes) != self._counts[li]:
                t = t.narrow(2 if rows else 1, lanes[0], len(lanes))
            if rows and self._rows[li] is not None:
                r = self._rows[li]
                t = t.narrow(3, r.start, r.stop - r.start)
            return t
        xs = {li: cut(t, li) for li, t in xs.items()}
        ys = {li: cut(t, li) for li, t in ys.items()}
        if ms is not None:
            ms = {li: cut(t, li, rows=False) for li, t in ms.items()}
        return xs, ys, ms

    def _stage_chunk(self, rounds: int, local_epochs: int):
        xs, ys, ms, event, plans = super()._stage_chunk(rounds, local_epochs)
        return (*self._keep_local(xs, ys, ms), event, plans)

    def _stage_population_chunk(self, rounds: int, local_epochs: int):
        xs, ys, ms, event, plans = super()._stage_population_chunk(
            rounds, local_epochs)
        return (*self._keep_local(xs, ys, ms), event, plans)

    # ------------------------------------------------------------ training
    def _build_steps(self):
        """Each cohort's forward and backward; Adam runs on the shards in
        :meth:`_cohort_step`."""
        ctx = self.ctx
        return {li: make_cohort_grad_step(ctx.model, li, ctx.grad_mode)
                for li in self._cohort_lis}

    def _cohort_step(self, li: int, carry, x, y, lr, lr_s, m=None):
        """One cohort step on this rank's lanes and rows: gather, forward
        and backward, gradients averaged over the batch axes, the shards
        updated in place.  Returns the new carry entry and this rank's
        share of the lanes' (client, server) losses: float64, masked, and
        weighted so that their sum over the lanes and batch ranks counts
        every lane once."""
        c, co, s, so = carry
        sc, _, ss, _ = self._cspecs[li]
        before = self.comm.gathered_bytes
        fc = self._unshard(c, sc)
        fs = self._unshard(s, ss)
        self._gathered += self.comm.gathered_bytes - before
        self._steps_run += 1
        tp_before = self._tp.total_bytes if self._tp is not None else 0.0
        ep_before = self._ep.total_bytes if self._ep is not None else 0.0
        if self._dp > 1:
            pg, _ = self.comm.group(self._batch_axes)
            sync = synced_batch_stats(pg, self._dp,
                                      self.comm.index(self._batch_axes))
        else:
            sync = contextlib.nullcontext()
        with sync, model_parallel(self._tp), expert_parallel(self._ep):
            gc, gs, closs, sloss, cst, sst = self._steps[li](fc, fs, x, y)
        gc, gs = list(gc), list(gs)
        roles = self._roles.get(li)

        def leaf_roles(part, net):
            return [None if roles is None else
                    _lookup(roles[part]["trainable"], p)
                    for p, _ in tree_paths(net["trainable"])]

        if self._dp > 1:
            # one all-reduce over the batch axes; an expert stack kept over
            # some of them is summed over the others alone
            by_axes: Dict[tuple, list] = {}
            for part, net, grads in ((0, c, gc), (2, s, gs)):
                for r, g in zip(leaf_roles(part, net), grads):
                    if g is not None:
                        by_axes.setdefault(grad_reduce_axes(
                            self._batch_axes, r.experts if r else ()),
                            []).append(g)
            for axes, live in by_axes.items():
                self.comm.all_reduce(live, axes)
                for g in live:
                    g.div_(self._dp)
        w = (1.0 if self._owned[li] else 0.0) / self._dp
        if m is not None:
            cst = masked_update(m, cst, fc["state"])
            sst = masked_update(m, sst, fs["state"])
            closs, sloss = closs * m.to(closs.dtype), sloss * m.to(sloss.dtype)
        out = []
        for part, (net, full, g, opt, specs, st, rate) in zip((0, 2), (
                (c, fc, gc, co, sc, cst, lr), (s, fs, gs, so, ss, sst, lr_s))):
            norms = None
            if self.ctx.opt_cfg.grad_clip > 0:
                split = [self._norm_axes(r) for r in leaf_roles(part, net)]
                norms = lane_norms(g, split if any(split) else None,
                                   self.comm.all_reduce)
            leaf_specs = spec_leaves(specs["trainable"], net["trainable"])
            g = [None if gr is None else self._shard(gr, sp)
                 for gr, sp in zip(g, leaf_specs)]
            tr, opt = adam_update(net["trainable"], g, opt, self.ctx.opt_cfg,
                                  rate, lanes=True, mask=m, norms=norms)
            out += [{"trainable": tr,
                     "state": self._tree(self._shard, st, specs["state"])},
                    opt]
        if self._tp is not None:
            self._tp_bytes += self._tp.total_bytes - tp_before
        if self._ep is not None:
            self._ep_bytes += self._ep.total_bytes - ep_before
        return tuple(out), closs.double() * w, sloss.double() * w

    def _norm_axes(self, role) -> tuple:
        """The axes over which a leaf's gradient is split, so its squares
        are summed over them for the clip norm: an expert stack's batch
        axes, a tensor-parallel chunk's model axis (those of one rank
        left out)."""
        if role is None:
            return ()
        axes = role.experts + ((self.recipe.tp_axis,) if role.split else ())
        return tuple(a for a in axes if self.comm.sizes.get(a, 1) > 1)

    def _aggregate(self, carry, ms, r: int) -> None:
        """Eq. (1) on the stacked servers of every cohort: the fused
        engine's in-rank form while no cohort's lanes are spread over
        ranks, else partial sums over the lanes group."""
        if not self._lane_sharded:
            return super()._aggregate(carry, ms, r)
        masks = None if ms is None else {li: ms[li][r] for li in ms}
        lanes = {li: [self._lanes[li][j] for j in self._local[li]]
                 for li in self._cohort_lis}
        for part in ("trainable", "state"):
            servers = {li: carry[li][2][part] for li in self._cohort_lis}
            partial_cross_layer_aggregate(
                servers, lanes, self._counts, self._owned,
                lambda ts: self.comm.all_reduce(ts, self._lane_axes), masks)

    def _reduce_losses(self, closs, sloss, ms, n: int, local_epochs: int):
        """The fused engine's per-round means, the sums (and, under a
        population, the active counts of the owned lanes) summed over the
        lanes and batch ranks first: one all_reduce a chunk."""
        sums = [torch.cat(ls).view(n, -1).sum(1) for ls in (closs, sloss)]
        if ms is not None:
            lead = all(self.comm.coord[a] == 0 for a in self._batch_axes)
            active = torch.zeros_like(sums[0])
            for li in self._cohort_lis:
                if self._owned[li] and lead:
                    active += ms[li].double().sum(1)
            sums.append(active)
        self.comm.all_reduce(sums, self._lane_axes + self._batch_axes)
        if ms is None:
            denom = float(self.ctx.N * local_epochs)
        else:
            denom = sums[2].clamp(min=1.0) * local_epochs
        return sums[0] / denom, sums[1] / denom

    def run(self, state, rounds: int, local_epochs: int = 1,
            log_every: int = 0, chunk_rounds: int = 0):
        """The fused engine's run from this rank's chunks (``state``
        placed by :meth:`place`); returns the new chunks.  The chunks of a
        ``ShardedTrainState`` this engine returned are taken as the carry
        and updated in place."""
        state = self.place(state)
        self._gathered = 0
        self._tp_bytes = self._ep_bytes = 0.0
        self._steps_run = 0
        out = super().run(state, rounds, local_epochs, log_every,
                          chunk_rounds)
        steps = max(1, self._steps_run)
        self.last_gathered_bytes_per_step = self._gathered / steps
        self.last_tp_bytes_per_step = self._tp_bytes / steps
        self.last_exchange_bytes_per_step = self._ep_bytes / steps
        return out

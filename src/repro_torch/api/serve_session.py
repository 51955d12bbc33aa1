"""``ServeSession`` — Alg. 3 entropy-gated serving with continuous batching
(counterpart of ``repro/api/serve_session.py``).

A fixed pool of decode slots serves a stream of requests: a request is
prefilled alone at its exact prompt length, its cache page is copied into
a free slot, and every tick decodes one gated token on all slots at once.
The gate is :func:`repro_torch.core.spmd.make_serve_step`'s: entropy at
the client-boundary exit head, exit iff H < tau.  Two exit policies, as in
the JAX package:

  * ``"select"``: every tick computes the exit and the full path and each
    slot takes one — token for token what :func:`sequential_reference`
    serves for the request alone.
  * ``"sticky"``: a slot whose gate fires adopts the client path.  Ticks on
    which every occupied slot has adopted run segments ``0..boundary`` and
    the exit head only; on mixed ticks adopted slots get ``tau = +inf`` so
    they keep taking the exit head's token (their stale server pages are
    never read for output).  :func:`sequential_sticky_reference` is the
    oracle.

What JAX's ``vmap`` over slots hid is written out here: ``cache_len``,
``kv_valid`` and ``tau`` are one value per slot, kept on the device, so the
kernels read them without a host sync; a tick brings its tokens, exits and
entropies to the host in one transfer.  The decode step writes each slot's
new K/V into the pool in place.  MoE blocks route each slot's token alone
(one routing group per slot), as JAX's one-row step does under ``vmap``:
a slot's expert capacity and drops do not depend on the other slots.
Prefill routes the one request's prompt as one group.

Cross-attending configs (Whisper) are served on the documented zeros
stub of the encoder states (``models/frontend.stub_enc``), as the JAX
package serves them: prefill, every tick and both sequential references
project it and recompute the cross keys and values from it, as the JAX
package does per tick (caching them is ROADMAP.md performance work).
VLM configs are served token-only, as in the JAX package.

``restore`` serves a ``TrainSession`` checkpoint (either package's):
:func:`assemble_serve_params` composes one full network from the trained
client and server nets.

Sharding rides the recipe rules training uses.  ``ServeSession(mesh=,
recipe=)`` serves over the ranks of a ``torch.distributed`` world
(:class:`RankPlacement`): ``launch.shardings.serve_state_specs`` places
the parameter tree (per ``ShardingRecipe``) and the slot-paged cache
(slot dim over the batch axes, the decode ring's sequence over
``"model"``), computed on the JAX package's layout of the serving tree
and mapped back onto the port's leaves, and each rank keeps only its
chunk of every leaf.  Every rank runs the host scheduler on the same
submissions and makes the same admissions.  A tick gathers the sharded
weights whole (freed at its end) but the expert stacks; the data group
that owns a free slot prefills its request whole, each of its ranks
keeping its part of the page; every rank decodes its data group's slots,
attention over its part of each split ring combined over the ring's ranks
(``models.attention.combine_parts``), and the tick's tokens, gates and
entropies are all-gathered over the batch ranks, so ``results``, the
counts of ``stats`` and ``run()`` are the same on every rank.  Where the
slots do not divide over the batch ranks they stay replicated and every
data group runs every slot.

An expert stack whose E dim lies over the batch axes (``"data"``: the
data layout, or the ``("data", "model")`` grid) stays this rank's chunk
-- E / D experts, over the grid chunk i * P + m of rank (i, m), as a
train step keeps it -- and the tick runs inside
``launch.tensor_parallel.expert_parallel`` over the rank's data group
(:attr:`RankPlacement.ep`): each MoE block sends every kept entry to its
expert's owner and back (``models/moe.py``).  Each slot is still its
own routing group, whole on its data group, so a slot's capacity and
drops do not depend on the other slots and no loads are summed; the
owners' buffers hold every data rank's groups side by side
(``ExpertGroup.groups``).  Every data rank makes the same exchanges in
the same order: a tick decodes every rank's slots, occupied or not, and
a data rank whose group does not prefill a request runs its experts'
side of each MoE block of that prefill (``models.moe.serve_exchange``).
``stats.exchange_bytes`` counts the exchange.

Over ``"model"`` the products are tensor-parallel
(``launch/tensor_parallel.py``): a leaf that ``launch.shardings.tp_roles``
finds ``column``, ``row`` or ``expert`` (attention's, MLA's, RWKV6's and
Mamba2's projections, the SwiGLU's weights, the expert stacks, the
embedding and the heads split over the vocab) is read in place as this
rank's chunk, gathered over its data axes only (a grid-placed expert
stack over one data rank: this rank's experts), and the tick runs inside
``model_parallel``
over the rank's model group; only the other leaves (norms, the router,
the token-shift mixes, Mamba2's conv and scan parameters, the frontend)
are gathered whole (an expert stack over the batch axes is not
gathered at all).  A decode over a split ring gathers the new token's
q, k and v heads (MLA: its absorbed query), attends over this rank's
part for every head and keeps its own heads for ``wo``; an RWKV6 decode
step runs every head on the whole state; the logits are gathered over
the vocab for the gate (the entropy kernel runs on whole rows) and the
token pick.
``stats.weight_gathered_bytes`` counts the weights a tick gathers (the
kept expert stacks read 0), ``stats.tp_bytes`` the tensor-parallel
collectives.
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import HeteroProfile, ModelConfig, SplitEEConfig
from repro_torch.core.spmd import StepConfig, make_serve_step
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import (MeshSpec, axis_sizes, batch_axes,
                                     live_mesh)
from repro_torch.launch.meshcomm import MeshComm, _axes, chunk_shapes
from repro_torch.launch.shardings import (_lookup, compute_spec,
                                          expert_axes, expert_blocks,
                                          jax_layout, kept_experts,
                                          map_with_path,
                                          port_specs, resolve_recipe,
                                          serve_state_specs, tp_roles)
from repro_torch.launch.tensor_parallel import (ExpertGroup, ModelGroup,
                                                expert_parallel,
                                                model_parallel,
                                                routing_groups)
from repro_torch.models.frontend import project_enc, stub_enc
from repro_torch.models import heads as heads_mod
from repro_torch.models.backbone import (backbone_forward, init_cache,
                                         segment_forward)
from repro_torch.models.attention import RingPart, ShardedRing
from repro_torch.models.common import embed
from repro_torch.tree import tree_leaves, tree_map


def resolve_serve_boundary(cfg: ModelConfig, boundary: int
                           ) -> Tuple[Tuple[int, ...], int, float]:
    """``(exits, cut, skip_frac)`` for gate boundary ``boundary``, all from
    the one sorted list of exit layers."""
    exits = tuple(sorted(cfg.exit_layers))
    if not exits:
        raise ValueError(f"{cfg.name}: serving needs exit_layers (the gate "
                         f"sits at an exit head)")
    if not 0 <= boundary < len(exits):
        raise ValueError(f"boundary {boundary} out of range for "
                         f"{len(exits)} exit boundaries {exits}")
    cut = exits[boundary]
    return exits, cut, 1.0 - cut / cfg.num_layers


def serve_step_config(cfg: ModelConfig, tau: float, boundary: int
                      ) -> Tuple[StepConfig, int, float]:
    """The ``StepConfig`` for :func:`make_serve_step` plus ``(cut,
    skip_frac)``, all derived through :func:`resolve_serve_boundary`."""
    _, cut, skip_frac = resolve_serve_boundary(cfg, boundary)
    sc = StepConfig(model=cfg, splitee=SplitEEConfig(
        profile=HeteroProfile(split_layers=(cut,) * 4),
        entropy_threshold=tau))
    return sc, cut, skip_frac


def assemble_serve_params(model, state, boundary: int) -> dict:
    """One full-network parameter tree from a split ``TrainState``.

    ``model`` is a ``BackboneSplitModel`` (``cfg``, ``plan``,
    ``full_params``); the serving identity is the first client whose cut
    boundary equals ``boundary``: its embed, segments and exit head cover
    the layers up to the cut, its server's ``seg{si}`` and ``head`` the
    rest, the composed network that client's requests went through in
    training.  The exit heads at other boundaries come from clients that
    trained them where there are any (else the adapter's init); the
    forward computes them but the gate never reads them.  A state kept
    as each rank's chunks (the spmd engine's) is gathered whole first
    (collective over its ranks)."""
    state = state.whole()
    cfg = model.cfg
    exits = tuple(sorted(cfg.exit_layers))
    # a client at boundary b holds segments 0..b, so its boundary can be
    # read off the state alone
    splits = tuple(len(c["trainable"]["segments"]) - 1 for c in state.clients)
    try:
        ci = splits.index(boundary)
    except ValueError:
        raise ValueError(
            f"no client in the checkpoint serves boundary {boundary} "
            f"(cut layer {exits[boundary]}); client boundaries: "
            f"{sorted(set(splits))}") from None
    client = state.clients[ci]["trainable"]
    server = state.servers[ci if len(state.servers) > 1 else 0]["trainable"]

    segments = [client["segments"][si] for si in range(boundary + 1)]
    for si in range(boundary + 1, len(model.plan)):
        segments.append(server[f"seg{si}"])

    exit_heads = []
    for b in range(len(exits)):
        if b == boundary:
            exit_heads.append(client["out"])
            continue
        owner = next((i for i, sb in enumerate(splits) if sb == b), None)
        exit_heads.append(state.clients[owner]["trainable"]["out"]
                          if owner is not None
                          else model.full_params["exit_heads"][b])
    params = {"embed": client["embed"], "segments": segments,
              "exit_heads": exit_heads, "head": server["head"]}
    # Zamba2's shared block and Whisper's frontend: the serving client's
    # copy (a VLM's projector, not trained, the adapter's init)
    for key in ("shared_attn", "frontend"):
        if key in client:
            params[key] = client[key]
        elif key in model.full_params:
            params[key] = model.full_params[key]
    return params


@dataclass
class ServeRequest:
    rid: int
    prompt: np.ndarray                 # (P,) int32
    decode_tokens: int


@dataclass
class ServeResult:
    """One request's served stream.  ``tokens[0]`` is the prefill token
    (full path, ungated); ``tokens[1 + i]`` is gated decode tick ``i`` with
    decision ``exited[i]`` and gate entropy ``entropy[i]``.  The sequential
    references also keep ``top2_gap[j]``, the gap between the two largest
    logits that chose ``tokens[j]``, and ``top_logit[j]``, the largest:
    two paths that round differently may part only at a near tie."""
    rid: int
    prompt: np.ndarray
    tokens: List[int] = field(default_factory=list)
    exited: List[bool] = field(default_factory=list)
    entropy: List[float] = field(default_factory=list)
    top2_gap: List[float] = field(default_factory=list)
    top_logit: List[float] = field(default_factory=list)

    @property
    def adoption_ratio(self) -> float:
        return float(np.mean(self.exited)) if self.exited else 0.0


@dataclass
class ServeStats:
    requests: int = 0
    decode_ticks: int = 0
    tokens: int = 0                    # gated decode tokens served
    exited: int = 0
    client_only_ticks: int = 0         # sticky ticks that skipped the server
    wall_s: float = 0.0                # whole ticks, admissions included
    prefill_s: float = 0.0             # admissions alone (prefill + join)
    gathered_bytes: int = 0            # received by this rank's all_gathers
    weight_gathered_bytes: int = 0     # of them, the weights' gathers
    tp_bytes: float = 0.0              # tensor-parallel collectives
    tp_prefill_bytes: float = 0.0      # of them, the admissions'
    exchange_bytes: float = 0.0        # the experts' dispatch and combine
    exchange_prefill_bytes: float = 0.0    # of them, the admissions'

    @property
    def exchange_bytes_per_tick(self) -> float:
        """The experts' exchange bytes of this rank's entries a tick
        (admissions included), as a train step's
        ``SpmdEngine.last_exchange_bytes_per_step`` counts them."""
        return self.exchange_bytes / max(1, self.decode_ticks)

    @property
    def exchange_decode_bytes_per_tick(self) -> float:
        """The experts' exchange bytes of a tick's decode step alone."""
        return ((self.exchange_bytes - self.exchange_prefill_bytes)
                / max(1, self.decode_ticks))

    @property
    def gathered_bytes_per_tick(self) -> float:
        return self.gathered_bytes / max(1, self.decode_ticks)

    @property
    def weight_gathered_bytes_per_tick(self) -> float:
        return self.weight_gathered_bytes / max(1, self.decode_ticks)

    @property
    def tp_bytes_per_tick(self) -> float:
        return self.tp_bytes / max(1, self.decode_ticks)

    @property
    def tp_decode_bytes_per_tick(self) -> float:
        """The tensor-parallel bytes of a tick's decode step alone (the
        admissions' prefills left out)."""
        return ((self.tp_bytes - self.tp_prefill_bytes)
                / max(1, self.decode_ticks))

    @property
    def adoption_ratio(self) -> float:
        return self.exited / max(1, self.tokens)


_RING_KEYS = ("k", "v", "ckv", "k_rope")


def serve_placement(recipe, mesh, cfg: ModelConfig, params, pool):
    """``(param specs, cache specs)`` of a serving tree (any leaves with
    ``.shape``, e.g. meta tensors) on ``mesh`` (live or a ``MeshSpec``):
    ``serve_state_specs`` on the JAX package's layout of the tree, mapped
    back onto the port's leaves, the axes of one rank dropped (they move
    nothing)."""
    sizes = axis_sizes(mesh)
    specs = serve_state_specs(
        recipe, mesh, jax_layout(params, cfg),
        jax_layout({"segments": pool}, cfg)["segments"], cfg)
    pspecs = port_specs(specs["params"], params, cfg)
    cspecs = port_specs({"segments": specs["cache"]}, {"segments": pool},
                        cfg)["segments"]

    def live(spec):
        return tuple(e if math.prod(sizes[a] for a in _axes(e)) > 1
                     else None for e in spec)
    return (map_with_path(lambda p, t: live(_lookup(pspecs, p)), params),
            map_with_path(lambda p, t: live(_lookup(cspecs, p)), pool))


def tick_gather_spec(path, spec, batch_all) -> tuple:
    """The dims of a cache leaf (at ``path``, placed by ``spec``) that a
    tick gathers: every split dim but the slot dim over the batch axes
    ``batch_all`` and a decode ring's sequence."""
    spec = list(spec)
    if set(_axes(spec[0])) <= set(batch_all):
        spec[0] = None                          # this group's slots
    if path[-1] in _RING_KEYS:
        spec[1] = None                          # the ring stays split
    return tuple(spec)


class RankPlacement:
    """A serving session's state over the ranks of a mesh: this rank's
    chunk of every parameter and cache leaf, placed by
    :func:`serve_placement` under ``recipe``, and the collectives of a
    tick (``launch.meshcomm.MeshComm``).

    A parameter leaf whose ``"model"`` chunk a tensor-parallel product
    reads (``roles``, ``launch.shardings.tp_roles``) is gathered for a
    tick over its other axes only (``compute_specs``); ``tp`` is the
    rank's model group (``None`` without a model split).  An expert
    stack whose E dim lies over the batch axes stays this rank's chunk
    (``Role.experts``): ``ep`` is the rank's expert group over the data
    ranks (``None`` where no stack keeps such a chunk), whose MoE blocks
    exchange their entries with the experts' owners.

    A cache leaf's slot dim over the batch axes leaves this rank its data
    group's slots ``[lo, hi)``; a decode ring's sequence over ``"model"``
    stays split (:class:`~repro_torch.models.attention.ShardedRing`);
    any other split dim (a recurrent state's heads, or the slot dim where
    the rules put a stacked run's layers over the batch axes) is gathered
    for the tick and this rank's chunk written back after it.  A leaf
    whose slot dim is not split holds every slot, of which only the owning
    data group's rows are kept current: no rank reads another group's."""

    def __init__(self, mesh, recipe, cfg: ModelConfig, params: dict,
                 slots: int, max_len: int, device):
        mesh = live_mesh(mesh) if isinstance(mesh, MeshSpec) else mesh
        self.comm = comm = MeshComm(mesh)
        self.recipe = resolve_recipe(recipe)
        pool = init_cache(cfg, slots, max_len, cfg.dtype, "meta")
        self.param_specs, self.cache_specs = serve_placement(
            self.recipe, mesh, cfg, params, pool)
        self.params = map_with_path(
            lambda p, t: comm.shard(t.to(device), _lookup(self.param_specs,
                                                          p), lead=0),
            params)
        self.pool = map_with_path(
            lambda p, t: torch.zeros(t.shape, dtype=t.dtype, device=device),
            chunk_shapes(pool, self.cache_specs, comm.sizes, lead=0))
        ax = self.recipe.tp_axis
        self.tp: Optional[ModelGroup] = None
        self.ep: Optional[ExpertGroup] = None
        self.roles = None
        self.compute_specs = self.param_specs
        split = comm.sizes.get(ax, 1) > 1
        if split or cfg.moe is not None:
            self.roles = tp_roles(params, self.param_specs, mesh, cfg,
                                  self.recipe)
            # a split leaf keeps its "model" chunk, an expert stack its
            # chunk over the batch ranks too: no expert weight is gathered
            self.compute_specs = map_with_path(
                lambda p, _: compute_spec(_lookup(self.param_specs, p),
                                          _lookup(self.roles, p), ax),
                params)
        if split:
            pg, _ = comm.group((ax,))
            self.tp = ModelGroup(pg, comm.sizes[ax], comm.index((ax,)),
                                 expert_blocks=expert_blocks(self.roles))
        self._batch_all = batch_axes(mesh)
        self.batch = tuple(a for a in self._batch_all
                           if comm.sizes[a] > 1)
        axes = expert_axes(self.roles) if self.roles is not None else ()
        if axes:
            if tuple(axes) != self.batch:
                raise ValueError(
                    f"{cfg.name}: serving keeps the experts over {axes}, "
                    f"but the slots split over the batch axes "
                    f"{self.batch}; the expert exchange needs them to be "
                    f"the same axes")
            pg, _ = comm.group(axes)
            self.ep = ExpertGroup(pg, comm.size(axes), comm.index(axes),
                                  kept_experts(self.roles, cfg.moe.num_experts,
                                               comm.sizes, ax))
        dp = comm.size(self.batch)
        if dp > 1 and slots % dp == 0:
            n = slots // dp
            self.lo = comm.index(self.batch) * n
            self.hi = self.lo + n
            self.slots_split = True
        else:
            self.lo, self.hi, self.slots_split = 0, slots, False
        self.slots = slots
        # per cache leaf: the dims a tick gathers (the rest kept split)
        self._gather_specs = map_with_path(
            lambda p, _: tick_gather_spec(p, _lookup(self.cache_specs, p),
                                          self._batch_all), pool)

    # ------------------------------------------------------------- a tick
    def whole_params(self) -> dict:
        """The parameter tree a tick computes with: each sharded leaf
        all-gathered, a tensor-parallel leaf over its other axes only (its
        ``"model"`` chunk read in place), a kept expert stack not at
        all."""
        return self.comm.unshard(self.params, self.compute_specs, lead=0)

    def _range(self, spec, d: int, size: int):
        """(start, length) of this rank's chunk of dim ``d`` (``size``
        whole)."""
        axes = _axes(spec[d])
        n = size // self.comm.size(axes)
        return self.comm.index(axes) * n, n

    def admit_page(self, s: int, page) -> None:
        """Copies slot ``s``'s whole prefilled page (B = 1) into this
        rank's chunks: its part of every split dim, where its chunk holds
        slot ``s``."""
        def put(path, chunk):
            spec = _lookup(self.cache_specs, path)
            src = _lookup(page, path)[0]
            start, n = self._range(spec, 0, self.slots)
            if not start <= s < start + n:
                return chunk
            for d in range(1, chunk.dim()):
                lo, n_d = self._range(spec, d, src.shape[d - 1])
                src = src.narrow(d - 1, lo, n_d)
            chunk[s - start].copy_(src)
            return chunk
        map_with_path(put, self.pool)

    def working_cache(self):
        """The tick's cache of this group's slots: each leaf's rows
        ``[lo, hi)`` (views of this rank's chunks, or of leaves gathered
        whole), split rings wrapped with their part.  Returns it and the
        gathered leaves to :meth:`write_back`."""
        whole = self.comm.unshard(self.pool, self._gather_specs, lead=0)
        back = []

        def rows(path, t):
            chunk = _lookup(self.pool, path)
            if t is not chunk:
                back.append((chunk, t, _lookup(self._gather_specs, path)))
            # a leaf that holds every slot: this group's rows of it
            return (t[self.lo:self.hi] if t.shape[0] != self.hi - self.lo
                    else t)
        cache = map_with_path(rows, whole)
        for si, seg in enumerate(cache):
            for li, layer in enumerate(seg):
                mixer = layer["mixer"]
                key = next((k for k in mixer if k in _RING_KEYS), None)
                if key is None:
                    continue
                axes = _axes(_lookup(self.cache_specs,
                                     (si, li, "mixer", key))[1])
                if axes:
                    layer["mixer"] = ShardedRing(mixer, RingPart(
                        width=mixer[key].shape[1] * self.comm.size(axes),
                        parts=self.comm.size(axes),
                        index=self.comm.index(axes),
                        gather=lambda x, axes=axes: self.comm.gather(
                            [(x[None], 0, axes)])[0]))
        return cache, back

    def write_back(self, back) -> None:
        """This rank's chunk of every leaf :meth:`working_cache` gathered
        (its part of each gathered dim), written back into its stored
        chunk."""
        for chunk, whole, spec in back:
            src = whole
            for d in range(chunk.dim()):
                lo, n = self._range(spec, d, whole.shape[d])
                src = src.narrow(d, lo, n)
            chunk.copy_(src)

    def gather_slots(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (..., hi - lo) of this group's slots -> (..., slots), every
        group's in slot order (``x`` itself when the slots are not
        split)."""
        if not self.slots_split:
            return x
        return self.comm.gather([(x, x.dim() - 1, self.batch)])[0]


class ServeSession:
    """Continuous-batching entropy-gated decode over a fixed slot pool."""

    def __init__(self, cfg: ModelConfig, params: dict, *, tau: float,
                 boundary: int = 0, slots: int = 8, max_len: int = 128,
                 exit_policy: str = "select", kernels: Optional[str] = None,
                 device=None, mesh=None, recipe=None):
        if exit_policy not in ("select", "sticky"):
            raise ValueError(f"unknown exit_policy {exit_policy!r}; "
                             f"expected 'select' or 'sticky'")
        if kernels is not None:
            dispatch.resolve_kernels(kernels)     # validate loudly
            cfg = cfg.with_(kernels=kernels)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tau = float(tau)
        self.boundary = boundary
        self.slots = slots
        self.max_len = max_len
        self.exit_policy = exit_policy
        self.sc, self.cut, self.skip_frac = serve_step_config(
            cfg, tau, boundary)
        if mesh is not None:
            #: the placement over the mesh's ranks (``None`` on one rank)
            self.placement = RankPlacement(mesh, recipe, cfg, params, slots,
                                           max_len, self.device)
            self.params = self.placement.params     # this rank's chunks
            self._pool = self.placement.pool
            self._lo, self._hi = self.placement.lo, self.placement.hi
        else:
            self.placement = None
            self.params = tree_map(lambda t: t.to(self.device), params)
            self._pool = init_cache(cfg, slots, max_len, cfg.dtype,
                                    self.device)
            self._lo, self._hi = 0, slots
        self._step = make_serve_step(self.sc, boundary=boundary)
        self._gate = dispatch.backend_for(cfg)

        # host-side scheduler state
        self._queue: deque = deque()
        self._slot_res: List[Optional[ServeResult]] = [None] * slots
        self._slot_left = np.zeros(slots, np.int64)
        self._slot_sticky = np.zeros(slots, bool)
        self._active = np.zeros(slots, bool)
        # per-slot device state: last token, tokens already cached, and
        # the prefill token of a slot admitted this tick
        self._toks = torch.zeros(slots, dtype=torch.int32, device=self.device)
        self._lens = torch.zeros(slots, dtype=torch.int32, device=self.device)
        self._tok0 = torch.zeros(slots, dtype=torch.int32, device=self.device)
        self._next_rid = 0
        self._done: List[ServeResult] = []
        self.stats = ServeStats()

    # -------------------------------------------------------------- restore
    @classmethod
    def restore(cls, path: str, model, *, tau: Optional[float] = None,
                boundary: Optional[int] = None, slots: int = 8,
                max_len: int = 128, exit_policy: str = "select",
                kernels: Optional[str] = None, mesh=None,
                recipe=None) -> "ServeSession":
        """A serving session straight from a ``TrainSession`` checkpoint
        (the ``path + '.npz'/'.json'`` pair either package's
        ``TrainSession.save`` writes), on ``model.device``.  ``model`` is
        the ``BackboneSplitModel`` the run trained: the manifest's kind,
        format and model are checked before any tensor is read, as
        ``TrainSession.restore`` checks them.  ``tau`` defaults to the
        checkpoint's ``entropy_threshold``, ``boundary`` to the shallowest
        trained cut; ``mesh`` and ``recipe`` as for the constructor."""
        from repro_torch.api.session import manifest_configs, read_manifest
        from repro_torch.api.state import init_train_state
        from repro_torch.convert import load_split_state
        meta = read_manifest(path, model, what="served")
        splitee_cfg, opt_cfg = manifest_configs(meta)
        state = load_split_state(
            path, model, init_train_state(model, splitee_cfg, opt_cfg))
        if boundary is None:
            boundary = min(model._boundary_of(li)
                           for li in splitee_cfg.profile.split_layers)
        params = assemble_serve_params(model, state, boundary)
        tau = splitee_cfg.entropy_threshold if tau is None else tau
        return cls(model.cfg, params, tau=tau, boundary=boundary,
                   slots=slots, max_len=max_len, exit_policy=exit_policy,
                   kernels=kernels, device=model.device, mesh=mesh,
                   recipe=recipe)

    # ------------------------------------------------------------ admission
    def submit(self, prompt: Sequence[int], decode_tokens: int = 16) -> int:
        """Enqueue one request; returns its id.  The request joins a slot at
        the next :meth:`step` with one free."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if decode_tokens < 1:
            raise ValueError(f"decode_tokens must be >= 1, got "
                             f"{decode_tokens}")
        if len(prompt) + 1 + decode_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + decode ({decode_tokens}) tokens "
                f"exceed the slot page (max_len={self.max_len})")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(ServeRequest(rid, prompt, decode_tokens))
        return rid

    def _admit(self, params: dict) -> List[int]:
        """Queued requests into the free slots, in slot order; returns the
        slots admitted.  A slot of this rank's data group is prefilled
        here; the other groups' admissions move no data on this rank, but
        where the experts are split over the data ranks this rank runs
        its experts' side of each MoE block's exchange
        (``models.moe.serve_exchange``)."""
        admitted = []
        ep = self.placement.ep if self.placement is not None else None
        # a request is one routing group: its one data group's where the
        # slots split, else each data rank's copy of it
        first, total = ((0, 1) if ep is None or self.placement.slots_split
                        else (ep.index, ep.size))
        for s in range(self.slots):
            if self._active[s] or not self._queue:
                continue
            t0 = time.perf_counter()
            req = self._queue.popleft()
            if not self._lo <= s < self._hi:
                if ep is not None:
                    with routing_groups(ep, first, total):
                        _join_prefill(self.cfg, params, len(req.prompt))
            else:
                with routing_groups(ep, first, total):
                    page, logits = _prefill(self.cfg, params, req.prompt,
                                            self.max_len, self.device)
                tok0 = int(logits.argmax(-1))
                if self.placement is None:
                    for pool_t, page_t in zip(tree_leaves(self._pool),
                                              tree_leaves(page)):
                        pool_t[s].copy_(page_t[0])
                else:
                    self.placement.admit_page(s, page)
                self._toks[s] = tok0
                self._tok0[s] = tok0
                # int(...) above waited for the device: this is device time
                self.stats.prefill_s += time.perf_counter() - t0
            self._lens[s] = len(req.prompt)
            self._slot_res[s] = ServeResult(req.rid, req.prompt)
            self._slot_left[s] = req.decode_tokens
            self._slot_sticky[s] = False
            self._active[s] = True
            admitted.append(s)
        return admitted

    # --------------------------------------------------------------- ticks
    def step(self) -> bool:
        """One scheduler tick: admit queued requests into free slots, decode
        one gated token on every occupied slot, evict finished requests.
        Returns False when queue and slots are both empty."""
        if not self._queue and not self._active.any():
            return False
        t0 = time.perf_counter()
        pl = self.placement
        with model_parallel(pl.tp if pl is not None else None), \
                expert_parallel(pl.ep if pl is not None else None):
            return self._tick(t0, pl)

    def _slot_groups(self):
        """The routing groups of a decode tick over the expert group: this
        rank's slots, one group each, after the lower data ranks'."""
        ep = self.placement.ep if self.placement is not None else None
        n = self._hi - self._lo
        return routing_groups(ep, ep.index * n if ep else 0,
                              ep.size * n if ep else n)

    def _tick(self, t0: float, pl) -> bool:
        before = pl.comm.gathered_bytes if pl is not None else 0
        tp_before = pl.tp.total_bytes if pl is not None and pl.tp else 0.0
        ep_before = pl.ep.total_bytes if pl is not None and pl.ep else 0.0
        params = pl.whole_params() if pl is not None else self.params
        if pl is not None:
            self.stats.weight_gathered_bytes += (pl.comm.gathered_bytes
                                                 - before)
        tp_admit = pl.tp.total_bytes if pl is not None and pl.tp else 0.0
        ep_admit = pl.ep.total_bytes if pl is not None and pl.ep else 0.0
        admitted = self._admit(params)
        if pl is not None and pl.tp is not None:
            self.stats.tp_prefill_bytes += pl.tp.total_bytes - tp_admit
        if pl is not None and pl.ep is not None:
            self.stats.exchange_prefill_bytes += pl.ep.total_bytes - ep_admit
        occupied = np.nonzero(self._active)[0]

        sticky_policy = self.exit_policy == "sticky"
        client_only = sticky_policy and bool(self._slot_sticky[occupied].all())
        ctrl = torch.from_numpy(np.stack(
            [self._active, self._slot_sticky & sticky_policy])).to(self.device)
        active, sticky = ctrl[0], ctrl[1]
        mine = slice(self._lo, self._hi)
        tau = torch.full((self._hi - self._lo,), self.tau,
                         dtype=torch.float32, device=self.device)
        if pl is not None:
            cache, back = pl.working_cache()
        else:
            cache, back = self._pool, ()
        with self._slot_groups():
            if client_only:
                tokens, exited, H = self._client_tick(params, cache, tau,
                                                      sticky[mine])
            else:
                # adopted slots are forced onto the exit head: tau = +inf
                tokens, exited, H = self._full_tick(
                    params, cache, torch.where(sticky[mine], torch.inf, tau))
        if pl is not None:
            pl.write_back(back)
        del params, cache, back
        # every slot's token, gate, entropy and prefill token (token ids
        # < 2**24 are exact in float32), every group's gathered
        rows = torch.stack([tokens.float(), exited.float(), H,
                            self._tok0[mine].float()])
        rows = pl.gather_slots(rows) if pl is not None else rows
        host = rows.cpu().numpy()     # the tick's one device-to-host copy
        self._lens += active.to(torch.int32)
        self._toks = torch.where(active, rows[0].to(torch.int32), self._toks)

        for s in admitted:
            self._slot_res[s].tokens.append(int(host[3, s]))
        for s in occupied:
            res = self._slot_res[s]
            res.tokens.append(int(host[0, s]))
            res.exited.append(bool(host[1, s]))
            res.entropy.append(float(host[2, s]))
            self._slot_sticky[s] |= bool(host[1, s])
            self._slot_left[s] -= 1
            self.stats.tokens += 1
            self.stats.exited += int(host[1, s])
            if self._slot_left[s] <= 0:
                self._done.append(res)
                self.stats.requests += 1
                self._slot_res[s] = None
                self._active[s] = False
        self.stats.decode_ticks += 1
        self.stats.client_only_ticks += int(client_only)
        if pl is not None:
            self.stats.gathered_bytes += pl.comm.gathered_bytes - before
            if pl.tp is not None:
                self.stats.tp_bytes += pl.tp.total_bytes - tp_before
            if pl.ep is not None:
                self.stats.exchange_bytes += pl.ep.total_bytes - ep_before
        self.stats.wall_s += time.perf_counter() - t0
        return bool(self._queue) or bool(self._active.any())

    def _full_tick(self, params: dict, cache, tau: torch.Tensor):
        mine = slice(self._lo, self._hi)
        out = self._step(params, self._toks[mine, None], cache,
                         self._lens[mine], tau=tau,
                         enc=stub_enc(self.cfg, self._hi - self._lo,
                                      self.device))
        tokens = out["logits"][:, 0].argmax(-1).to(torch.int32)
        return tokens, out["exited"][:, 0], out["entropy"][:, 0]

    def _client_tick(self, params: dict, cache, tau: torch.Tensor,
                     sticky: torch.Tensor):
        """Segments ``0..boundary`` + exit head only: the server layers do
        no work.  Runs only when every occupied slot has adopted; the
        server pages it leaves stale are never read for their output."""
        cfg = self.cfg
        mine = slice(self._lo, self._hi)
        n = self._hi - self._lo
        x = embed(params["embed"], self._toks[mine, None],
                  cfg.vocab_size).to(cfg.dtype)
        positions = self._lens[mine].long()[:, None]
        enc = project_enc(params, stub_enc(cfg, n, self.device), cfg)
        for si in range(self.boundary + 1):
            x, _ = segment_forward(params, cfg, si, x, positions, cache,
                                   self._lens[mine], moe_groups=n, enc=enc)
        e_logits = heads_mod.whole_logits(heads_mod.exit_head(
            params["exit_heads"][self.boundary], x, cfg), cfg)
        H, gate = self._gate.entropy_gate(e_logits, tau)
        tokens = e_logits[:, 0].argmax(-1).to(torch.int32)
        # every occupied slot has adopted: its token is the exit head's
        return tokens, sticky | gate[:, 0], H[:, 0]

    def run(self) -> List[ServeResult]:
        """Drain the queue; returns all finished results in completion
        order (also kept on ``self.results``)."""
        while self.step():
            pass
        return self.results

    @property
    def results(self) -> List[ServeResult]:
        return list(self._done)


def _join_prefill(cfg: ModelConfig, params: dict, n_tokens: int) -> None:
    """This rank's part in another data group's prefill of ``n_tokens``
    tokens: its experts' side of every MoE block's exchange, in the
    order the prefill runs the blocks (``models.moe.serve_exchange``)."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.backbone import segment_layers
    for si in range(len(cfg.segments())):
        for li, (kind, ffn) in enumerate(segment_layers(cfg, si)):
            if ffn == "moe":
                p = (params["shared_attn"] if kind == "shared_attn"
                     else params["segments"][si][li])
                moe_mod.serve_exchange(p["ffn"], cfg, n_tokens)


def _prefill(cfg: ModelConfig, params: dict, prompt: np.ndarray,
             max_len: int, device) -> Tuple[list, torch.Tensor]:
    """Prefill one request alone at its exact prompt length into a fresh
    B=1 page (the previous occupant's tokens never leak): ``(page, logits
    (V,) of the last prompt token)``, left on the device."""
    page = init_cache(cfg, 1, max_len, cfg.dtype, device)
    tokens = torch.as_tensor(prompt, dtype=torch.long, device=device)[None]
    out = backbone_forward(params, cfg, tokens=tokens, cache=page,
                           cache_len=torch.zeros(1, dtype=torch.int32,
                                                 device=device),
                           exit_heads=(), enc=stub_enc(cfg, 1, device))
    return page, heads_mod.whole_logits(out.logits[0, -1], cfg)


# ---------------------------------------------------------------------------
# sequential references (the parity oracles)
# ---------------------------------------------------------------------------


def _sequential(cfg: ModelConfig, params: dict, prompt: Sequence[int],
                decode_tokens: int, *, tau: float, boundary: int,
                max_len: int, device, sticky_policy: bool) -> ServeResult:
    device = resolve_device(device)
    params = tree_map(lambda t: t.to(device), params)
    sc, _, _ = serve_step_config(cfg, tau, boundary)
    step = make_serve_step(sc, boundary=boundary)
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    cache, logits = _prefill(cfg, params, prompt, max_len, device)
    res = ServeResult(rid=-1, prompt=prompt)

    def take(logits):
        top2 = logits.float().topk(2).values
        res.top2_gap.append(float(top2[0] - top2[1]))
        res.top_logit.append(float(top2[0]))
        tok = logits.argmax(-1).to(torch.int32)
        res.tokens.append(int(tok))
        return tok

    tok = take(logits)
    sticky = False
    for i in range(decode_tokens):
        tau_i = torch.full((1,), torch.inf if sticky else tau,
                           dtype=torch.float32, device=device)
        o = step(params, tok.reshape(1, 1), cache,
                 torch.full((1,), len(prompt) + i, dtype=torch.int32,
                            device=device), tau=tau_i,
                 enc=stub_enc(cfg, 1, device))
        tok = take(o["logits"][0, 0])
        res.exited.append(bool(o["exited"][0, 0]))
        res.entropy.append(float(o["entropy"][0, 0]))
        sticky = sticky_policy and (sticky or res.exited[-1])
    return res


def sequential_reference(cfg: ModelConfig, params: dict,
                         prompt: Sequence[int], decode_tokens: int, *,
                         tau: float, boundary: int = 0, max_len: int = 128,
                         device=None) -> ServeResult:
    """Serve ONE request alone: B=1 prefill + a raw ``make_serve_step``
    decode loop — the stream the batched engine must reproduce token for
    token, gate decisions included."""
    return _sequential(cfg, params, prompt, decode_tokens, tau=tau,
                       boundary=boundary, max_len=max_len, device=device,
                       sticky_policy=False)


def sequential_sticky_reference(cfg: ModelConfig, params: dict,
                                prompt: Sequence[int], decode_tokens: int,
                                *, tau: float, boundary: int = 0,
                                max_len: int = 128,
                                device=None) -> ServeResult:
    """Serve ONE request alone under the sticky policy: after the first gate
    fire every later tick runs with ``tau = +inf``.  This loop computes the
    full path every tick, so every cache page stays coherent."""
    return _sequential(cfg, params, prompt, decode_tokens, tau=tau,
                       boundary=boundary, max_len=max_len, device=device,
                       sticky_policy=True)


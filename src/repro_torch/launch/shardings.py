"""Sharding recipes: spec trees for parameters, optimizer state, batches
and caches (counterpart of ``repro/launch/shardings.py``), the rule set of
the live spmd engine (:func:`train_state_specs` is its entry point).

A spec is a tuple with one entry per dim of its leaf: ``None``
(replicated), a mesh axis name, or a tuple of axis names (the dim split
over their product, row-major in the tuple's order) -- a JAX
``PartitionSpec`` written out to the leaf's rank.  The functions read
shapes only: leaves are anything with ``.shape`` (meta tensors for trees
that must never be materialised at full size).

Scheme (MaxText-style, tunable via ``ShardingRecipe``):
  * batch dims shard over ("pod", "data") when divisible, else replicate;
  * cohort-stacked engine carries (leading lane dim ``E``) shard the lane
    dim over the mesh's ``"lanes"`` axis when divisible;
  * 2D+ weights: tensor-parallel shard the largest divisible dim over
    "model"; with FSDP on, additionally shard the largest remaining
    divisible dim over the fsdp axes;
  * MoE expert stacks (leading dim == num_experts): expert-parallel --
    E over ("data", "model") when it matches the full grid, otherwise E
    over "data" with the expert hidden dim over "model";
  * stacked-run leaves (leading layer axis of the JAX package's scanned
    runs) never shard the layer-stack dim;
  * 1D / tiny params (``min_shard_elems``) replicate (the lane dim still
    shards).

The rules are written against the JAX package's layout (stacked runs,
HWIO conv weights).  The port keeps one dict per layer and OIHW conv
weights, so :func:`jax_layout` gives a port tree's shapes in the JAX
layout and :func:`port_specs` maps the specs computed there back onto the
port's leaves: a rank then holds the same slice of every tensor as the
JAX package's device would.
"""
from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import torch

from repro_torch.launch.mesh import LANE_AXIS, axis_sizes, batch_axes

#: a per-leaf spec: one entry per dim (None, an axis name or a tuple)
Spec = Tuple[Any, ...]


@dataclass(frozen=True)
class ShardingRecipe:
    scheme: str = "greedy"               # greedy | megatron | hybrid
    tp_axis: str = "model"
    fsdp: bool = True
    fsdp_axes: Tuple[str, ...] = ("data",)
    expert_mode: str = "auto"            # auto | data | grid
    min_shard_elems: int = 1 << 16       # replicate tiny leaves
    shard_cache_seq: bool = True         # shard decode cache seq dim on model
    shard_lanes: bool = True             # cohort lane dim over the lanes axis


#: the recipes the CLI and the session accept by name (``--recipe``).
#: "replicate" is batch-only sharding, everything else replicated.
NAMED_RECIPES: Dict[str, ShardingRecipe] = {
    "greedy": ShardingRecipe(),
    "megatron": ShardingRecipe(scheme="megatron"),
    "hybrid": ShardingRecipe(scheme="hybrid"),
    "fsdp-off": ShardingRecipe(fsdp=False),
    "replicate": ShardingRecipe(fsdp=False, shard_lanes=False,
                                min_shard_elems=1 << 62),
}


def resolve_recipe(recipe: Union[str, ShardingRecipe, None]
                   ) -> ShardingRecipe:
    """Name / instance / None -> a concrete :class:`ShardingRecipe`
    (``None`` means the default "greedy" recipe)."""
    if recipe is None:
        return NAMED_RECIPES["greedy"]
    if isinstance(recipe, ShardingRecipe):
        return recipe
    try:
        return NAMED_RECIPES[recipe]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown sharding recipe {recipe!r}; named recipes: "
            f"{sorted(NAMED_RECIPES)} (or pass a ShardingRecipe)") from None


def recipe_name(recipe: Union[str, ShardingRecipe, None]) -> str:
    """The manifest-facing name: the matching registry name, else
    "custom"."""
    if recipe is None:
        return "greedy"
    if isinstance(recipe, str):
        return recipe
    for name, r in NAMED_RECIPES.items():
        if r == recipe:
            return name
    return "custom"


def recipe_to_meta(recipe: ShardingRecipe) -> dict:
    """JSON-able checkpoint metadata for a recipe."""
    d = dataclasses.asdict(recipe)
    d["fsdp_axes"] = list(d["fsdp_axes"])
    return d


def recipe_from_meta(meta: dict) -> ShardingRecipe:
    d = dict(meta)
    d["fsdp_axes"] = tuple(d.get("fsdp_axes", ("data",)))
    return ShardingRecipe(**d)


def default_recipe(cfg, mesh) -> ShardingRecipe:
    return ShardingRecipe()


# Megatron-style name rules: which named dim to tensor-parallel shard.
# (param-name, dim-index-after-optional-layer-stack) -> role
#   "col": shard an OUTPUT dim (column parallel)
#   "row": shard the CONTRACTING dim (row parallel)
_MEGATRON_RULES = {
    "wq": ("col", 1), "wk": ("col", 1), "wv": ("col", 1), "wo": ("row", 0),
    "w_uq": ("col", 1), "w_uk": ("col", 1), "w_uv": ("col", 1),
    "w_dq": ("col", 1), "w_dkv": ("col", 1),
    "w_gate": ("col", 1), "w_up": ("col", 1), "w_down": ("row", 0),
    "table": ("col", 0), "w": ("col", 1),
    "wg": ("col", 1),
    "in_proj": (None, None), "out_proj": (None, None),
    "w_lora_a": (None, None), "w_lora_b": (None, None),
}


# ---------------------------------------------------------------------------
# trees: dicts (sorted keys), lists, tuples and dataclass records; a path
# entry is a dict key, a sequence index or a dataclass field name
# ---------------------------------------------------------------------------


def _is_record(tree) -> bool:
    return dataclasses.is_dataclass(tree) and not isinstance(tree, type)


def tree_paths(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs in the JAX package's flattening order (dict
    keys sorted, records by field); ``None`` is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, path + (i,))
    elif _is_record(tree):
        for f in dataclasses.fields(tree):
            yield from tree_paths(getattr(tree, f.name), path + (f.name,))
    elif tree is not None:
        yield path, tree


def map_with_path(fn, tree, path: Tuple = ()):
    """``fn(path, leaf)`` over ``tree``, keeping its containers (records
    are rebuilt with ``dataclasses.replace``)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    if _is_record(tree):
        return dataclasses.replace(tree, **{
            f.name: map_with_path(fn, getattr(tree, f.name),
                                  path + (f.name,))
            for f in dataclasses.fields(tree)})
    if tree is None:
        return None
    return fn(path, tree)


def spec_leaves(specs, like) -> list:
    """The specs of a spec tree in the flattening order of ``like``, the
    tree they were computed for (specs are tuples, so the spec tree alone
    does not say where its leaves are)."""
    return [tuple(_lookup(specs, path)) for path, _ in tree_paths(like)]


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(s) for s in leaf.shape)


# ---------------------------------------------------------------------------
# leaf rules
# ---------------------------------------------------------------------------


def _pick_dim(shape, size, skip=(), taken=()):
    """Largest dim divisible by ``size``, excluding ``skip``/``taken``."""
    best, best_dim = 0, None
    for i, s in enumerate(shape):
        if i in skip or i in taken:
            continue
        if s % size == 0 and s > best:
            best, best_dim = s, i
    return best_dim


def _leaf_spec(leaf, sizes: Dict[str, int], recipe: ShardingRecipe,
               skip_dim0: bool, is_expert: bool, num_experts: int,
               name: str = "", skip_dims: Optional[Tuple[int, ...]] = None
               ) -> Spec:
    shape = _shape(leaf)
    ndim = len(shape)
    if math.prod(shape) < recipe.min_shard_elems or ndim < 2:
        return (None,) * ndim
    spec = [None] * ndim
    # ``skip_dims``: a contiguous leading prefix (lane and/or layer-stack
    # dims), the general form of ``skip_dim0``
    skip = skip_dims if skip_dims is not None else ((0,) if skip_dim0 else ())
    lead = (max(skip) + 1) if skip else 0   # first "real" dim after stacking

    if is_expert:
        grid = sizes.get("data", 1) * sizes.get(recipe.tp_axis, 1)
        e_dim = lead

        def pod_fsdp():
            # 3-axis FSDP: shard one remaining dim over "pod" when enabled
            if (recipe.fsdp and "pod" in recipe.fsdp_axes
                    and sizes.get("pod", 1) > 1):
                fd = _pick_dim(shape, sizes["pod"], skip=skip + (e_dim,),
                               taken=tuple(i for i, s in enumerate(spec)
                                           if s is not None))
                if fd is not None:
                    spec[fd] = "pod"

        if (recipe.expert_mode in ("auto", "grid")
                and num_experts % grid == 0 and grid > 1):
            spec[e_dim] = ("data", recipe.tp_axis)
            pod_fsdp()
            return tuple(spec)
        if num_experts % sizes.get("data", 1) == 0:
            spec[e_dim] = "data"
            tp = _pick_dim(shape, sizes.get(recipe.tp_axis, 1),
                           skip=skip + (e_dim,))
            if tp is not None:
                spec[tp] = recipe.tp_axis
            pod_fsdp()
            return tuple(spec)
        # fall through to the generic rules

    tp_size = sizes.get(recipe.tp_axis, 1)
    if recipe.scheme in ("megatron", "hybrid"):
        rule = _MEGATRON_RULES.get(name)
        tp_dim = None
        if rule and rule[0] is not None:
            cand = rule[1] + lead
            if cand < ndim and shape[cand] % tp_size == 0:
                tp_dim = cand
        # megatron: no rule or indivisible -> replicate the TP dim and rely
        # on FSDP; hybrid: fall back to the greedy pick instead
        if tp_dim is None and recipe.scheme == "hybrid":
            tp_dim = _pick_dim(shape, tp_size, skip=skip)
    else:
        tp_dim = _pick_dim(shape, tp_size, skip=skip)
    if tp_dim is not None and tp_size > 1:
        spec[tp_dim] = recipe.tp_axis
    else:
        tp_dim = None          # an inert 1-way TP pick must not block FSDP
    if recipe.fsdp:
        fsdp_size = math.prod(sizes.get(a, 1) for a in recipe.fsdp_axes)
        if fsdp_size > 1:
            fd = _pick_dim(shape, fsdp_size, skip=skip,
                           taken=() if tp_dim is None else (tp_dim,))
            if fd is not None:
                ax = (recipe.fsdp_axes if len(recipe.fsdp_axes) > 1
                      else recipe.fsdp_axes[0])
                spec[fd] = ax
    return tuple(spec)


# ---------------------------------------------------------------------------
# spec trees
# ---------------------------------------------------------------------------


def _str_keys(path) -> list:
    return [k for k in path if isinstance(k, str)]


def _is_stacked(run_params) -> bool:
    """A stacked run has every leaf sharing the same leading (layer) dim
    and norm scales of ndim 2 instead of 1."""
    shapes = [_shape(l) for _, l in tree_paths(run_params)]
    if not shapes:
        return False
    return (min(len(s) for s in shapes) >= 2
            and len({s[0] for s in shapes}) == 1)


def param_specs(abstract_params: Any, cfg, mesh,
                recipe: Optional[ShardingRecipe] = None):
    """Spec tree matching the backbone parameter structure (the JAX
    package's layout: one tree per run of a segment)."""
    recipe = recipe or default_recipe(cfg, mesh)
    sizes = axis_sizes(mesh)
    n_exp = cfg.moe.num_experts if cfg.moe else -1

    def walk(tree, skip_dim0):
        def visit(path, leaf):
            keys = _str_keys(path)
            name = keys[-1] if keys else ""
            shape = _shape(leaf)
            is_expert = (n_exp > 1 and len(shape) >= 2
                         and shape[int(skip_dim0)] == n_exp
                         and any(k in ("w_gate", "w_up", "w_down")
                                 for k in keys))
            return _leaf_spec(leaf, sizes, recipe, skip_dim0, is_expert,
                              n_exp, name=name)
        return map_with_path(visit, tree)

    specs = {}
    for key, sub in abstract_params.items():
        if key == "segments":
            specs[key] = [[walk(run_p, skip_dim0=_is_stacked(run_p))
                           for run_p in seg] for seg in sub]
        else:
            specs[key] = walk(sub, skip_dim0=False)
    return specs


def batch_specs(input_specs: Dict[str, Any], mesh):
    """Shard batch dims over ("pod", "data") where divisible."""
    axes = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in axes)
    ax = axes if len(axes) > 1 else axes[0]

    def visit(_, leaf):
        shape = _shape(leaf)
        if not shape or shape[0] % dp != 0:
            return (None,) * len(shape)
        return (ax,) + (None,) * (len(shape) - 1)

    return map_with_path(visit, input_specs)


def cache_specs(cache_abstract: Any, cfg, mesh,
                recipe: Optional[ShardingRecipe] = None):
    """Decode caches: batch dim over ("pod", "data") when divisible; the
    sequence/window dim over "model" when divisible (k/v/ckv buffers)."""
    recipe = recipe or default_recipe(cfg, mesh)
    axes = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in axes)
    tp = sizes.get(recipe.tp_axis, 1)
    ax = axes if len(axes) > 1 else axes[0]

    def visit(_, leaf):
        shape = _shape(leaf)
        ndim = len(shape)
        if ndim < 2:
            return (None,) * ndim
        spec = [None] * ndim
        # stacked run caches have a leading layer dim; batch is dim 0 or 1
        bdim = 0
        if ndim >= 3 and shape[0] <= 128 and shape[1] != 1:
            if shape[0] % dp != 0 and shape[1] % dp == 0:
                bdim = 1
        if shape[bdim] % dp == 0:
            spec[bdim] = ax
        if recipe.shard_cache_seq and ndim >= bdim + 2:
            sdim = bdim + 1
            if shape[sdim] % tp == 0 and shape[sdim] >= 2 * tp:
                spec[sdim] = recipe.tp_axis
        return tuple(spec)

    return map_with_path(visit, cache_abstract)


# ---------------------------------------------------------------------------
# engine carry specs -- the live training entry point (api/spmd_engine.py)
# ---------------------------------------------------------------------------

_SEG_KEY_RE = re.compile(r"seg\d+$")


def _run_prefix(path) -> Optional[Tuple]:
    """For a leaf inside a backbone run tree, the path prefix naming its
    run: ``.../segments/[si]/[ri]`` (client layout) or ``.../seg{si}/[ri]``
    (server layout); ``None`` elsewhere."""
    for i, k in enumerate(path):
        if k == "segments" and i + 2 < len(path):
            return tuple(path[:i + 3])
        if isinstance(k, str) and _SEG_KEY_RE.match(k) and i + 1 < len(path):
            return tuple(path[:i + 2])
    return None


def _stacked_run_group(shapes) -> bool:
    """A stacked run (lane dim already dropped by the caller): every leaf
    shares the leading layer-stack dim and norm scales are 2-D."""
    if not shapes:
        return False
    return (min(len(s) for s in shapes) >= 2
            and len({s[0] for s in shapes}) == 1)


def train_state_specs(recipe: ShardingRecipe, mesh, carry: Any,
                      *, num_experts: int = -1):
    """Spec tree for a cohort-stacked engine carry ``{li: (client,
    client_opt, server, server_opt)}`` in the JAX package's layout, every
    leaf with a leading cohort-lane dim.  Per leaf:

      * the lane dim shards over the mesh's ``"lanes"`` axis when the
        cohort's lane count divides it (``recipe.shard_lanes``);
      * remaining dims get the recipe's TP/FSDP/expert rules, with
        stacked-run layer dims never sharded;
      * leaves below ``recipe.min_shard_elems`` per lane and every 1-D
        leaf (Adam steps, biases, norm scales) keep only the lane spec;
      * Adam moments mirror their params (same structure, shapes and
        names, so the same rules)."""
    sizes = axis_sizes(mesh)
    lane_sz = sizes.get(LANE_AXIS, 1) if recipe.shard_lanes else 1

    flat = list(tree_paths(carry))
    groups: Dict[Tuple, list] = {}
    for path, leaf in flat:
        rp = _run_prefix(path)
        if rp is not None:
            groups.setdefault(rp, []).append(_shape(leaf)[1:])
    stacked = {rp: _stacked_run_group(shapes)
               for rp, shapes in groups.items()}

    def spec_for(path, leaf):
        shape = _shape(leaf)
        ndim = len(shape)
        if ndim == 0:
            return ()
        lane = (LANE_AXIS if lane_sz > 1 and shape[0] % lane_sz == 0
                else None)
        per_lane = math.prod(shape) // max(1, shape[0])
        if per_lane < recipe.min_shard_elems or ndim < 2:
            return (lane,) + (None,) * (ndim - 1)
        rp = _run_prefix(path)
        skip = (0, 1) if (rp is not None and stacked[rp]) else (0,)
        keys = _str_keys(path)
        name = keys[-1] if keys else ""
        is_expert = (num_experts > 1 and ndim > len(skip) + 1
                     and shape[len(skip)] == num_experts
                     and any(k in ("w_gate", "w_up", "w_down")
                             for k in keys))
        inner = _leaf_spec(leaf, sizes, recipe, False, is_expert,
                           num_experts, name=name, skip_dims=skip)
        return (lane,) + tuple(inner[1:])

    return map_with_path(spec_for, carry)


def serve_state_specs(recipe: ShardingRecipe, mesh, params_abstract: Any,
                      cache_abstract: Any, cfg) -> Dict[str, Any]:
    """Spec trees for a serving session's carry: ``{"params": ...,
    "cache": ...}`` -- :func:`param_specs` and :func:`cache_specs` under
    one recipe."""
    return {"params": param_specs(params_abstract, cfg, mesh, recipe),
            "cache": cache_specs(cache_abstract, cfg, mesh, recipe)}


def stage_batch_spec(recipe: ShardingRecipe, mesh, lane_count: int,
                     batch: int) -> Spec:
    """Spec of one cohort's staged ``[rounds, local_epochs, E, B, ...]``
    minibatch tensor, its first four dims: the lane dim over ``"lanes"``
    and the per-lane batch dim over the mesh's batch axes, each when
    divisible (trailing feature dims replicate)."""
    sizes = axis_sizes(mesh)
    axes = batch_axes(mesh)
    dp = math.prod(sizes[a] for a in axes) if axes else 1
    lane_sz = sizes.get(LANE_AXIS, 1) if recipe.shard_lanes else 1
    lane = LANE_AXIS if lane_sz > 1 and lane_count % lane_sz == 0 else None
    if dp > 1 and batch % dp == 0:
        b_ax = axes if len(axes) > 1 else axes[0]
    else:
        b_ax = None
    return (None, None, lane, b_ax)


# ---------------------------------------------------------------------------
# the JAX package's layout of a port tree, and specs back onto the port's
# ---------------------------------------------------------------------------

# a port conv weight (cout, cin, kh, kw) -> the JAX package's (kh, kw, cin,
# cout), as ``convert.CONV_OIHW_TO_HWIO``
_OIHW_TO_HWIO = (2, 3, 1, 0)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _runs(cfg, si: int):
    from repro_torch.models.backbone import build_plan
    return build_plan(cfg)[si]


def jax_layout(tree, cfg=None, lead: int = 0):
    """``tree`` (a port parameter tree, net, Adam state or engine carry) as
    meta tensors in the JAX package's layout.  With ``cfg`` (a backbone
    config) every segment's layers are restacked into one leaf per run, the
    layer dim after the ``lead`` leading (lane) dims; without it, every
    leaf of rank ``lead + 4`` is a conv weight and goes OIHW -> HWIO.  No
    data is read or allocated."""
    if cfg is None:
        def leaf(_, t):
            shape = _shape(t)
            if len(shape) == lead + 4:
                body = shape[lead:]
                shape = shape[:lead] + tuple(body[p] for p in _OIHW_TO_HWIO)
            return _meta(shape, t.dtype)
        return map_with_path(leaf, tree)

    def restack(layers, si):
        out, i = [], 0
        for run in _runs(cfg, si):
            group = layers[i:i + run.length]
            i += run.length
            if run.length == 1:
                out.append(walk(group[0]))
                continue

            def stack(_, t, n=run.length):
                s = _shape(t)
                return _meta(s[:lead] + (n,) + s[lead:], t.dtype)
            out.append(map_with_path(stack, group[0]))
        return out

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == "segments":
                    out[k] = [restack(seg, si) for si, seg in enumerate(v)]
                elif isinstance(k, str) and _SEG_KEY_RE.match(k):
                    out[k] = restack(v, int(k[3:]))
                else:
                    out[k] = walk(v)
            return out
        if isinstance(node, (list, tuple)):
            out = [walk(v) for v in node]
            return type(node)(out) if isinstance(node, tuple) else out
        if _is_record(node):
            return dataclasses.replace(node, **{
                f.name: walk(getattr(node, f.name))
                for f in dataclasses.fields(node)})
        if node is None:
            return None
        return _meta(_shape(node), node.dtype)

    return walk(tree)


def port_specs(specs, tree, cfg=None, lead: int = 0):
    """Inverse of :func:`jax_layout` for specs: ``specs`` were computed on
    ``jax_layout(tree, cfg, lead)``; returns the spec of every leaf of the
    port's ``tree`` (the same structure as ``tree``).  A run's spec loses
    its layer entry on each of the run's layers; a conv weight's spec is
    permuted back to OIHW."""
    if cfg is None:
        inv = [0] * 4
        for i, p in enumerate(_OIHW_TO_HWIO):
            inv[p] = i

        def leaf(path, t):
            s = _lookup(specs, path)
            if len(_shape(t)) == lead + 4:
                body = s[lead:]
                s = tuple(s[:lead]) + tuple(body[inv[j]] for j in range(4))
            return tuple(s)
        return map_with_path(leaf, tree)

    def unstack(layers, run_specs, si):
        out, i = [], 0
        for run, rs in zip(_runs(cfg, si), run_specs):
            for layer in layers[i:i + run.length]:
                if run.length == 1:
                    out.append(map_with_path(
                        lambda p, t, rs=rs: tuple(_lookup(rs, p)), layer))
                else:
                    out.append(map_with_path(
                        lambda p, t, rs=rs: _drop(_lookup(rs, p), lead),
                        layer))
            i += run.length
        return out

    def walk(node, sp):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == "segments":
                    out[k] = [unstack(seg, sp[k][si], si)
                              for si, seg in enumerate(v)]
                elif isinstance(k, str) and _SEG_KEY_RE.match(k):
                    out[k] = unstack(v, sp[k], int(k[3:]))
                else:
                    out[k] = walk(v, sp[k])
            return out
        if isinstance(node, (list, tuple)):
            out = [walk(v, s) for v, s in zip(node, sp)]
            return type(node)(out) if isinstance(node, tuple) else out
        if _is_record(node):
            return dataclasses.replace(node, **{
                f.name: walk(getattr(node, f.name), getattr(sp, f.name))
                for f in dataclasses.fields(node)})
        if node is None:
            return None
        return tuple(sp)

    return walk(tree, specs)


def _lookup(specs, path):
    node = specs
    for k in path:
        node = getattr(node, k) if _is_record(node) else node[k]
    return node


def _drop(spec, i: int) -> Spec:
    return tuple(spec[:i]) + tuple(spec[i + 1:])


# ---------------------------------------------------------------------------
# tensor-parallel roles: how each leaf's "model" split enters its product
# ---------------------------------------------------------------------------


class Role:
    """A leaf's part in the tensor-parallel products
    (``launch/tensor_parallel.py``): ``"column"`` (its ``"model"`` dim
    ``dim`` is an output dim), ``"row"`` (the contracting dim),
    ``"expert"`` (an expert stack whose expert dim ``dim`` is split over
    a tuple of axes ending in ``"model"``, data-major: after a gather
    over the other axes, ``blocks`` of them, model rank m holds the
    experts of chunks m, P + m, 2P + m, ... -- ``tensor_parallel.
    expert_ids``, where no batch axis keeps the experts), or
    ``"gathered"`` (held whole for compute: ``reason`` says why).  A
    split role may carry a ``reason`` too (a note on the compute it
    feeds).  ``experts``: the batch axes over which an expert stack's
    expert dim stays split for compute, in a train step and serving
    (``("data",)`` where that axis holds more than one rank, else empty)
    -- expert parallelism, the dispatch and combine an exchange over
    those ranks (``tensor_parallel.ExpertGroup``).  Not a tuple or a
    record, so a tree of roles is walked as the tree it mirrors."""

    __slots__ = ("kind", "dim", "reason", "blocks", "experts")

    def __init__(self, kind: str, dim: Optional[int] = None,
                 reason: str = "", blocks: int = 1,
                 experts: Tuple[str, ...] = ()):
        self.kind, self.dim, self.reason = kind, dim, reason
        self.blocks, self.experts = blocks, experts

    @property
    def split(self) -> bool:
        return self.kind in ("column", "row", "expert")

    def __repr__(self):
        return (f"Role({self.kind!r}, {self.dim}, {self.reason!r}"
                + (f", experts={self.experts}" if self.experts else "")
                + ")")


_ROW_COL = {0: "row", 1: "column"}

#: per family, per leaf name: the leaf's dims (after the lane dims) that
#: a product splits, and how.  Attention weights (d, heads, hd) and (H,
#: hd, d); the SwiGLU's (d, d_ff) and (d_ff, d) (a MoE block's shared
#: expert too); the embedding (V, d); a head's unembedding (d, V), split
#: over the vocab only.  MLA's latent projections (d, rank) and per-head
#: expansions (rank, H, hd); RWKV6's (d, d) projections and decay LoRA,
#: the channel mix's three; Mamba2's in_proj (d, z|xBC|dt) and out_proj;
#: an expert stack's (E, d, f) / (E, f, d) split over its hidden dims
#: (the data layout; the grid layout is the ``expert`` role).  A head-dim
#: split (dim 2 of a per-head weight) enters no split product.
_TP_DIMS = {
    "attn": {"wq": {0: "row", 1: "column"}, "wk": {0: "row", 1: "column"},
             "wv": {0: "row", 1: "column"}, "wo": {0: "row", 2: "column"},
             "bq": {0: "column"}, "bk": {0: "column"}, "bv": {0: "column"}},
    "mlp": {"w_gate": {0: "row", 1: "column"},
            "w_up": {0: "row", 1: "column"},
            "w_down": {0: "row", 1: "column"}, "b_up": {0: "column"}},
    "embed": {"table": {0: "column"}},
    "head": {"w": {1: "column"}},
    "mla": {"w_dq": _ROW_COL, "w_dkv": _ROW_COL, "w_uq": _ROW_COL,
            "w_uk": _ROW_COL, "w_uv": _ROW_COL,
            "wo": {0: "row", 2: "column"}},
    "rwkv6": {n: _ROW_COL for n in ("wr", "wk", "wv", "wg", "wo",
                                    "w_lora_a", "w_lora_b")},
    "rwkv_cm": {n: _ROW_COL for n in ("wk", "wv", "wr")},
    "mamba2": {"in_proj": _ROW_COL, "out_proj": _ROW_COL},
    "moe": {n: {1: "row", 2: "column"} for n in ("w_gate", "w_up",
                                                 "w_down")},
}

#: why a leaf of a covered family is held whole for compute
_KEPT_WHOLE = {
    "rwkv6": {"mix": "the token-shift mix is elementwise: no product "
                     "splits it",
              "u": "the wkv's bonus is elementwise: narrowed to the "
                   "rank's heads where the wkv runs on them"},
    "rwkv_cm": {"mix": "the token-shift mix is elementwise: no product "
                       "splits it"},
    "mamba2": {n: "the depthwise conv and the chunked SSD scan stay whole"
               for n in ("conv_w", "conv_b", "A_log", "dt_bias", "D")},
    "moe": {"router": "the router's logits decide a discrete top-k: a "
                      "split sum would reorder them"},
}

#: why a family keeps its "model" chunks gathered
_NOT_COVERED = {
    "frontend": "the stub frontend's projector stays whole",
    "norm": "a norm scale stays whole",
}


def _families(cfg, path) -> Tuple[Optional[str], str]:
    """``(family, leaf name)`` of a leaf at ``path`` in a port tree (full
    tree, client or server net, carry or Adam state) of a backbone."""
    keys = [k for k in path if isinstance(k, str)]
    name = keys[-1] if keys else ""
    if "frontend" in keys:
        return "frontend", name
    if "embed" in keys:
        return "embed", name
    if any(k in ("head", "out", "exit_heads") for k in keys):
        return ("head" if name == "w" else "norm"), name
    from repro_torch.models.backbone import segment_layers
    kind = None
    for i, k in enumerate(path):
        if k == "shared_attn":
            first = cfg.block_pattern.index("shared_attn")
            kind = ("attn", cfg.ffn_pattern[first])
            break
        if k == "segments" and i + 2 < len(path):
            kind = segment_layers(cfg, path[i + 1])[path[i + 2]]
            break
        if isinstance(k, str) and _SEG_KEY_RE.match(k) and i + 1 < len(path):
            kind = segment_layers(cfg, int(k[3:]))[path[i + 1]]
            break
    if kind is None:
        return None, name
    mixer, ffn = kind
    mixer = "attn" if mixer == "shared_attn" else mixer
    if "cross" in keys:
        return "attn", name
    if "mixer" in keys:
        return mixer, name
    if "ffn" in keys:
        # a MoE block's shared expert is a SwiGLU
        return ("mlp" if ffn == "moe" and "shared" in keys else ffn), name
    return "norm", name


def is_expert_stack(cfg, path) -> bool:
    """Whether the leaf at ``path`` of a port backbone tree is one of a
    MoE block's stacked expert weights (E, d, f) / (E, f, d)."""
    fam, name = _families(cfg, path)
    return fam == "moe" and name in _TP_DIMS["moe"]


def tp_roles(tree, specs, mesh, cfg, recipe: Optional[ShardingRecipe] = None,
             lead: int = 0):
    """The :class:`Role` of every leaf of a port backbone tree (any leaves
    with ``.shape``) placed by ``specs`` on ``mesh``: its ``"model"`` dim
    (``recipe.tp_axis``) read against the family's products
    (:data:`_TP_DIMS`), the ``lead`` lane dims skipped.  A leaf that a
    product splits is ``column`` or ``row``, an expert stack over the
    grid ``expert``; any other, ``gathered`` with its reason.  An expert
    stack whose E dim is over "data" (of more than one rank) also names
    that axis in ``Role.experts``, whatever its kind.  GQA's query
    heads go column only where each rank's heads read whole KV groups (or
    one KV head), and a bias only beside its column-parallel weight.  An
    RWKV6 projection whose chunk does not hold whole heads (P does not
    divide H) says that the wkv runs whole."""
    recipe = recipe or default_recipe(cfg, mesh)
    ax = recipe.tp_axis
    sizes = axis_sizes(mesh)
    P = sizes.get(ax, 1)

    def first(path, t) -> Role:
        spec = tuple(_lookup(specs, path))
        fam, name = _families(cfg, path)
        dims = [d for d, e in enumerate(spec) if e == ax]
        if not dims:
            tup = [d for d, e in enumerate(spec)
                   if isinstance(e, tuple) and ax in e]
            if not tup:
                return Role("gathered", reason="no dim over the model axis")
            d = tup[0]
            if (fam == "moe" and name in _TP_DIMS["moe"] and d == lead
                    and spec[d][-1] == ax):
                return Role("expert", d, blocks=math.prod(
                    sizes.get(a, 1) for a in spec[d][:-1]))
            return Role("gathered", d, f"split over a tuple of axes {spec}")
        d = dims[0]
        rules = _TP_DIMS.get(fam, {}).get(name)
        if rules is None:
            why = _KEPT_WHOLE.get(fam, {}).get(name) or _NOT_COVERED.get(
                fam, f"{fam} leaf {name!r} is not tensor-parallel")
            return Role("gathered", d, why)
        kind = rules.get(d - lead)
        if kind is None:
            return Role("gathered", d, f"{name}'s dim {d - lead} over the "
                        f"model axis enters no split product")
        if fam == "attn" and name == "wq" and kind == "column":
            G = cfg.num_heads // cfg.num_kv_heads
            per = cfg.num_heads // P
            if per % G and G % per:
                return Role("gathered", d, f"{per} query heads a rank do "
                            f"not read whole KV groups of {G}")
        if fam == "rwkv6" and cfg.num_heads % P:
            return Role(kind, d, f"the wkv runs whole: {cfg.num_heads} "
                        f"heads do not divide over {P} ranks")
        return Role(kind, d)

    def role(path, t) -> Role:
        r = first(path, t)
        if (sizes.get("data", 1) > 1 and is_expert_stack(cfg, path)
                and "data" in _entry_axes(tuple(_lookup(specs, path))[lead])):
            r.experts = ("data",)
        return r

    roles = map_with_path(role, tree)

    def bias(path, _) -> Role:
        r, name = _lookup(roles, path), path[-1]
        if r.kind == "column" and name in ("bq", "bk", "bv", "b_up"):
            w = {"bq": "wq", "bk": "wk", "bv": "wv", "b_up": "w_up"}[name]
            if _lookup(roles, tuple(path[:-1]) + (w,)).kind != "column":
                return Role("gathered", r.dim, f"{name} beside a {w} that "
                            f"is not column-parallel")
        return r
    return map_with_path(bias, tree)


def _entry_axes(e) -> Tuple[str, ...]:
    if e is None:
        return ()
    return tuple(e) if isinstance(e, tuple) else (e,)


def _entry(axes: Tuple[str, ...]):
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _kept_axes(role: Role, tp_axis: str, experts: bool) -> set:
    keep = set(role.experts) if experts else set()
    if role.split:
        keep.add(tp_axis)
    return keep


def compute_spec(spec, role: Role, tp_axis: str = "model",
                 experts: bool = True) -> Spec:
    """The spec a leaf is gathered over for compute: a split leaf keeps
    its ``tp_axis`` chunk (that axis dropped from its entry), and with
    ``experts`` (a train step and serving alike) an expert stack keeps
    its chunk over ``role.experts`` too, so an expert stack over the grid
    is not gathered at all and one in the data layout only over a "pod"
    split; any other leaf is gathered whole."""
    keep = _kept_axes(role, tp_axis, experts)
    if not keep:
        return tuple(spec)
    return tuple(_entry(tuple(a for a in _entry_axes(e) if a not in keep))
                 for e in spec)


def kept_spec(spec, role: Role, tp_axis: str = "model",
              experts: bool = True) -> Spec:
    """The split a leaf keeps for compute (what :func:`compute_spec`
    leaves out): the compute chunk's shape is the whole shape cut by this
    spec."""
    keep = _kept_axes(role, tp_axis, experts)
    return tuple(_entry(tuple(a for a in _entry_axes(e) if a in keep))
                 for e in spec)


def expert_axes(roles) -> Tuple[str, ...]:
    """The batch axes the expert stacks of a tree of roles keep their
    chunks over, in a train step and serving (``Role.experts``; empty
    where none does)."""
    for _, r in tree_paths(roles):
        if r.experts:
            return r.experts
    return ()


def kept_experts(roles, num_experts: int, sizes, tp_axis: str = "model"
                 ) -> int:
    """The experts a rank keeps of each expert stack split over the batch
    ranks (the first role with ``Role.experts``): E over
    those ranks, and over ``tp_axis`` too in the grid (an ``"expert"``
    role); 0 where no stack keeps such a chunk.  The
    ``tensor_parallel.ExpertGroup``'s ``experts``."""
    for _, r in tree_paths(roles):
        if r.experts:
            n = num_experts // math.prod(sizes[a] for a in r.experts)
            return n // sizes.get(tp_axis, 1) if r.kind == "expert" else n
    return 0


def expert_blocks(roles) -> int:
    """The ``blocks`` of the expert stacks in a tree of roles (1 where no
    leaf has the ``expert`` role): the model group's
    ``ModelGroup.expert_blocks``."""
    for _, r in tree_paths(roles):
        if r.kind == "expert":
            return r.blocks
    return 1

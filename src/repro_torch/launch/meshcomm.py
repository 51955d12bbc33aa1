"""The collectives of a mesh of ranks, shared by the spmd engine
(``api/spmd_engine.py``) and the serving session over ranks
(``api/serve_session.py``).

A leaf placed by a spec (``launch/shardings.py``) is held on each rank as
its chunk: every sharded dim cut to the rank's index along that dim's axes.
:meth:`MeshComm.shard` cuts a whole tensor to this rank's chunk;
:meth:`MeshComm.unshard` all-gathers a tree of chunks back into whole
tensors, every leaf of a pass in one collective per (axes, dtype).  The
plans (:func:`gather_plan`, :func:`unshard_plan`, :func:`all_reduce_plan`)
are pure functions of shapes, specs and axis sizes: the dry run reads them
without a world, and the ranks count the bytes they move
(:attr:`MeshComm.gathered_bytes`, ``kernels.sites.collective``) by the same
plans.  The gathers and reductions here are all_reduce and all_gather;
a train step's expert exchange is an all_to_all
(``launch/tensor_parallel.dispatch``).  gloo and NCCL take all three,
on CUDA tensors too.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import sites
from repro_torch.launch.mesh import axis_sizes
from repro_torch.launch.shardings import _lookup, map_with_path, tree_paths


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _elsize(dtype) -> int:
    return torch.empty((), dtype=dtype, device="meta").element_size()


def gather_plan(items, sizes) -> List[dict]:
    """The all_gathers :meth:`MeshComm.gather` issues for ``items``,
    ``(chunk shape, dtype, dim, axes)`` each: one per (axes, dtype), in
    the order of first appearance, the chunks travelling flattened in one
    buffer.  Each entry: ``axes``, ``dtype``, ``index`` (the items it
    carries), ``elements`` (of this rank's buffer) and ``bytes`` (received
    by this rank: the buffers of the group's other ranks)."""
    groups: Dict[tuple, List[int]] = {}
    for i, (_, dtype, _, axes) in enumerate(items):
        groups.setdefault((tuple(axes), dtype), []).append(i)
    plan = []
    for (axes, dtype), idx in groups.items():
        n = sum(math.prod(items[i][0]) for i in idx)
        ranks = math.prod(sizes[a] for a in axes)
        plan.append({"axes": axes, "dtype": dtype, "index": idx,
                     "elements": n,
                     "bytes": n * _elsize(dtype) * (ranks - 1)})
    return plan


def _gather_dims(spec, lane_axes=(), lead: int = 1,
                 sizes=None) -> List[tuple]:
    """The (dim, axes) a leaf is gathered along, in the order
    :func:`unshard_plan` pops them (the last first): each sharded dim from
    ``lead`` on (1: past an engine carry's lane dim; 0 for a parameter
    tree), and with ``lane_axes`` the lane dim first.  With ``sizes``, a
    dim over axes of one rank in all is left out (nothing to gather: a
    grid-placed expert stack's "data" part on a mesh of one data rank)."""
    dims = [(d, _axes(e)) for d, e in enumerate(spec)
            if d >= lead and _axes(e)]
    if lane_axes:
        dims.insert(0, (0, tuple(lane_axes)))
    if sizes is not None:
        dims = [(d, a) for d, a in dims if math.prod(sizes[x] for x in a) > 1]
    return dims


def unshard_plan(tree, specs, sizes, lane_axes=(),
                 lead: int = 1) -> List[List[dict]]:
    """The passes of :meth:`MeshComm.unshard` over ``tree`` (this rank's
    chunks: anything with ``.shape`` and ``.dtype``) placed by ``specs``:
    per pass, the :func:`gather_plan` of the leaves that still have a dim
    to gather, each leaf's last remaining dim (``lead`` as for
    :func:`_gather_dims`)."""
    shapes, dtypes, todo = [], [], []
    for path, t in tree_paths(tree):
        shapes.append(list(t.shape))
        dtypes.append(t.dtype)
        todo.append(_gather_dims(_lookup(specs, path), lane_axes, lead,
                                 sizes))
    passes = []
    while any(todo):
        idx = [i for i, dims in enumerate(todo) if dims]
        items = []
        for i in idx:
            d, axes = todo[i].pop()
            items.append((tuple(shapes[i]), dtypes[i], d, axes))
        passes.append(gather_plan(items, sizes))
        for i, (_, _, d, axes) in zip(idx, items):
            shapes[i][d] *= math.prod(sizes[a] for a in axes)
    return passes


def plan_bytes(passes) -> int:
    """Bytes a rank receives over the passes of :func:`unshard_plan`."""
    return sum(g["bytes"] for plan in passes for g in plan)


def all_reduce_plan(items, axes, sizes) -> List[dict]:
    """The all_reduces :meth:`MeshComm.all_reduce` issues for ``items``,
    ``(shape, dtype)`` each, over ``axes``: one per dtype, in the order of
    first appearance (none when the axes hold one rank).  Each entry:
    ``dtype``, ``index``, ``elements`` and ``bytes`` of the buffer."""
    if not [a for a in axes if sizes.get(a, 1) > 1]:
        return []
    groups: Dict[torch.dtype, List[int]] = {}
    for i, (_, dtype) in enumerate(items):
        groups.setdefault(dtype, []).append(i)
    plan = []
    for dtype, idx in groups.items():
        n = sum(math.prod(items[i][0]) for i in idx)
        plan.append({"dtype": dtype, "index": idx, "elements": n,
                     "bytes": n * _elsize(dtype)})
    return plan


def chunk_shapes(tree, specs, sizes, lead: int = 1):
    """Meta tensors of this rank's chunk of every leaf of ``tree`` (whole
    shapes) placed by ``specs``: each sharded dim from ``lead`` on divided
    by its axes' sizes, as :meth:`MeshComm.shard` cuts it."""
    def chunk(path, t):
        shape = list(t.shape)
        for d, axes in _gather_dims(_lookup(specs, path), lead=lead):
            shape[d] //= math.prod(sizes[a] for a in axes)
        return torch.empty(shape, dtype=t.dtype, device="meta")
    return map_with_path(chunk, tree)


class MeshComm:
    """Process groups over sets of axes of a live mesh, and the
    collectives the engine and the serving session run on them.  Groups
    are made on first use; every rank asks for the same groups in the same
    order (they follow from the recipe's specs, which every rank computes
    alike)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.sizes = axis_sizes(mesh)
        self.ranks = mesh.mesh
        self.coord = dict(zip(self.names, mesh.get_coordinate()))
        self._groups: Dict[frozenset, tuple] = {}
        #: bytes this rank received from all_gathers since the last reset
        self.gathered_bytes = 0

    def size(self, axes) -> int:
        return math.prod(self.sizes[a] for a in axes)

    def index(self, axes) -> int:
        """This rank's chunk index along ``axes`` (row-major, in the
        tuple's order, as a JAX ``PartitionSpec`` entry splits a dim)."""
        i = 0
        for a in axes:
            i = i * self.sizes[a] + self.coord[a]
        return i

    def group(self, axes) -> Tuple[object, List[int]]:
        """``(process group, its global ranks sorted)`` of the ranks that
        share this rank's coordinates off ``axes``."""
        import torch.distributed as dist
        key = frozenset(axes)
        if key not in self._groups:
            others = [a for a in self.names if a not in key]
            mine = None
            for fixed in itertools.product(
                    *(range(self.sizes[a]) for a in others)):
                index = []
                for a in self.names:
                    index.append(fixed[others.index(a)] if a in others
                                 else slice(None))
                ranks = sorted(int(r) for r in
                               self.ranks[tuple(index)].flatten().tolist())
                pg = dist.new_group(ranks=ranks)
                if all(self.coord[a] == f for a, f in zip(others, fixed)):
                    mine = (pg, ranks)
            self._groups[key] = mine
        return self._groups[key]

    def _rank_at(self, axes, chunk: int) -> int:
        """The global rank holding chunk ``chunk`` along ``axes`` among
        this rank's group."""
        index = []
        rest = chunk
        for a in reversed(axes):
            index.append(rest % self.sizes[a])
            rest //= self.sizes[a]
        pos = dict(zip(reversed(axes), index))
        at = tuple(pos[a] if a in pos else self.coord[a] for a in self.names)
        return int(self.ranks[at])

    def all_reduce(self, tensors: List[torch.Tensor], axes) -> None:
        """Sum ``tensors`` over the ranks along ``axes``, in place, in one
        collective per dtype."""
        import torch.distributed as dist
        axes = tuple(a for a in axes if self.sizes.get(a, 1) > 1)
        if not axes or not tensors:
            return
        pg, _ = self.group(axes)
        for entry in all_reduce_plan([(t.shape, t.dtype) for t in tensors],
                                     axes, self.sizes):
            ts = [tensors[i] for i in entry["index"]]
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.all_reduce(flat, group=pg)
            sites.collective("all_reduce", entry["bytes"])
            off = 0
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()

    def gather(self, items) -> List[torch.Tensor]:
        """The whole tensors of ``items``, ``(chunk, dim, axes)`` triples:
        each chunk split along ``dim`` over ``axes``.  One all_gather per
        (axes, dtype): the chunks travel flattened in one buffer, as
        :func:`gather_plan` lays them out."""
        import torch.distributed as dist
        out: List[Optional[torch.Tensor]] = [None] * len(items)
        plan = gather_plan([(tuple(t.shape), t.dtype, d, axes)
                            for t, d, axes in items], self.sizes)
        for entry in plan:
            axes, idx = entry["axes"], entry["index"]
            pg, ranks = self.group(axes)
            flat = torch.cat([items[i][0].reshape(-1) for i in idx])
            parts = [torch.empty_like(flat) for _ in ranks]
            dist.all_gather(parts, flat, group=pg)
            del flat                    # this rank's chunk is in parts too
            self.gathered_bytes += entry["bytes"]
            sites.collective("all_gather", entry["bytes"])
            by_rank = dict(zip(ranks, parts))
            chunks = [by_rank[self._rank_at(axes, c)]
                      for c in range(len(ranks))]
            off = 0
            for i in idx:
                t, d, _ = items[i]
                n = t.numel()
                out[i] = torch.cat([c[off:off + n].view_as(t)
                                    for c in chunks], dim=d)
                off += n
        return out

    def shard(self, t: torch.Tensor, spec, lead: int = 1) -> torch.Tensor:
        """This rank's chunk of ``t`` placed by ``spec`` (each sharded dim
        from ``lead`` on): a tensor of its own where the spec splits a dim,
        else ``t``."""
        out = t
        for d, axes in _gather_dims(spec, lead=lead):
            c = t.shape[d] // self.size(axes)
            out = out.narrow(d, self.index(axes) * c, c)
        return out if out is t else out.clone()

    def unshard(self, tree, specs, lane_axes=(), lead: int = 1):
        """``tree`` with every leaf whole again: each sharded dim from
        ``lead`` on gathered over its axes (and, with ``lane_axes``, the
        lane dim over them), all leaves of a pass in one collective per
        group, as :func:`unshard_plan` plans it."""
        paths, cur, todo = [], [], []
        for path, t in tree_paths(tree):
            paths.append(path)
            cur.append(t)
            todo.append(_gather_dims(_lookup(specs, path), lane_axes, lead,
                                     self.sizes))
        while any(todo):
            idx = [i for i, dims in enumerate(todo) if dims]
            items = [(cur[i],) + todo[i].pop() for i in idx]
            for i, whole in zip(idx, self.gather(items)):
                cur[i] = whole
        by_path = dict(zip(paths, cur))
        return map_with_path(lambda p, t: by_path[p], tree)

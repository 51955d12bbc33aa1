"""Step analysis: FLOPs, bytes, collectives and peak memory of a region of
the port's eager PyTorch (counterpart of ``repro/launch/hlo_analysis.py``).

The JAX package lowers a step and parses its HLO, multiplying each
``while`` body by its trip count.  The port runs eagerly and every layer
is a Python call, so there is no program to parse and no trip count to
recover: :class:`StepAnalysis` is a ``TorchDispatchMode`` that sees every
aten op the region runs -- forward, autograd's backward, remat's
recomputation, the optimizer -- on real CPU tensors, real CUDA tensors or
``FakeTensor`` stand-ins (``launch/dryrun.py``), and counts:

  * ``flops``: dot and convolution FLOPs of the aten ops outside any
    kernel site, by the formulas of ``torch.utils.flop_counter`` (ops it
    has no formula for are decomposed first, as ``FlopCounterMode`` does);
  * ``site_flops``, ``site_calls``, ``site_bytes`` by site name
    (``attention_fwd``, ``attention_dkv``, ``attention_dq``, ``wkv_fwd``,
    ``wkv_bwd``, ``gate``): what the kernel wrappers record through
    ``kernels/sites.py``, by the model-level formulas of
    ``kernels/dispatch.py``, on every device alike;
  * ``site_op_flops``: the aten FLOPs run *inside* sites, i.e. the plain
    versions' own work on the CPU (0 on the card and under fake tensors,
    where the wrappers launch or allocate).  ``flops + site_op_flops`` is
    what the JAX package's HLO count of a ``kernels="ref"`` step compares
    with;
  * ``hbm_bytes``: unfused op-level traffic -- each aten op's tensor
    inputs plus outputs, outside sites, without view and aliasing ops and
    allocations (the counterpart of ``_NO_TRAFFIC_OPS``) -- plus
    ``site_bytes``.  A fused program moves less;
  * ``peak_bytes``: the most bytes of storage alive at once during the
    region above what was alive when it opened: each storage an op
    creates is counted from its creation until it dies (a weak reference
    to it), shared by its views;
  * ``collectives``: bytes and counts by kind (``all_gather``: bytes
    received by this rank; ``all_reduce`` and ``broadcast``: bytes of the
    buffer), recorded by ``launch/meshcomm.MeshComm`` and the dry run
    through ``kernels/sites.collective``.

Use: ``with StepAnalysis() as a: step(...)`` then ``a.result()``.
"""
from __future__ import annotations

import functools
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import sites

aten = torch.ops.aten

# metadata queries: answered without running an op (as FlopCounterMode)
_METADATA_OPS = frozenset({
    aten.sym_is_contiguous.default, aten.is_contiguous.default,
    aten.is_contiguous.memory_format, aten.is_strides_like_format.default,
    aten.is_non_overlapping_and_dense.default, aten.size.default,
    aten.sym_size.default, aten.stride.default, aten.sym_stride.default,
    aten.storage_offset.default, aten.sym_storage_offset.default,
    aten.numel.default, aten.sym_numel.default, aten.dim.default,
    torch.ops.prim.layout.default,
})

# ops that move no HBM bytes of their own: aliasing, detaching and
# allocating without writing (view ops are found by ``OpOverload.is_view``)
_NO_TRAFFIC_OPS = frozenset({
    aten.detach, aten.alias, aten._unsafe_view, aten.lift_fresh,
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten.set_, aten.resize_, torch.ops.prim.device,
})

COLLECTIVE_KINDS = ("all_gather", "all_reduce", "broadcast")

_COMPOSITE = torch._C.DispatchKey.CompositeImplicitAutograd
_decomposes: Dict[object, bool] = {}


def _has_decomposition(func) -> bool:
    """Whether ``func.decompose`` would run a composite kernel (asked once
    per op: most ops have none, and trying costs a mode re-entry)."""
    known = _decomposes.get(func)
    if known is None:
        known = _decomposes[func] = (
            func is not torch.ops.prim.device.default
            and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), _COMPOSITE))
    return known


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class StepAnalysis(TorchDispatchMode):
    """Counts the work of the region it is entered around (see the module
    docstring); :meth:`result` reads the counts."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.site_op_flops = 0
        self.op_bytes = 0
        self.site_flops: Dict[str, float] = {}
        self.site_calls: Dict[str, int] = {}
        self.site_bytes: Dict[str, float] = {}
        self.collectives = {k: {"bytes": 0.0, "count": 0}
                            for k in COLLECTIVE_KINDS}
        self._live: Dict[int, tuple] = {}
        self._cur = 0
        self.peak_bytes = 0

    # ---------------------------------------------------------- recording
    def add_site(self, name: str, flops: float, nbytes: float) -> None:
        self.site_flops[name] = self.site_flops.get(name, 0.0) + flops
        self.site_calls[name] = self.site_calls.get(name, 0) + 1
        self.site_bytes[name] = self.site_bytes.get(name, 0.0) + nbytes

    def add_collective(self, kind: str, nbytes: float, count: int = 1
                       ) -> None:
        c = self.collectives.setdefault(kind, {"bytes": 0.0, "count": 0})
        c["bytes"] += nbytes
        c["count"] += count

    def _free(self, key: int, _ref) -> None:
        entry = self._live.pop(key, None)
        if entry is not None:
            self._cur -= entry[1]

    def _track(self, ins, outs) -> None:
        """Counts every storage of ``outs`` that the op created (not one
        of its inputs', not one already counted) until it dies."""
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = (weakref.ref(st, functools.partial(
                self._free, key)), n)
            self._cur += n
            self.peak_bytes = max(self.peak_bytes, self._cur)

    # ----------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA_OPS:
            return NotImplemented
        if _has_decomposition(func):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        flops = formula(*args, **kwargs, out_val=out) if formula else 0
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if sites.inside():
            self.site_op_flops += flops
        else:
            self.flops += flops
            if not (func.is_view or packet in _NO_TRAFFIC_OPS):
                self.op_bytes += _bytes(ins) + _bytes(outs)
        self._track(ins, outs)
        return out

    def __enter__(self):
        sites.listen(self)
        return super().__enter__()

    def __exit__(self, *exc):
        sites.unlisten(self)
        return super().__exit__(*exc)

    # ------------------------------------------------------------ reading
    def result(self) -> dict:
        site_bytes = sum(self.site_bytes.values())
        return {
            "flops": float(self.flops),
            "site_flops": dict(self.site_flops),
            "site_calls": dict(self.site_calls),
            "site_bytes": dict(self.site_bytes),
            "site_op_flops": float(self.site_op_flops),
            "hbm_bytes": float(self.op_bytes + site_bytes),
            "peak_bytes": int(self.peak_bytes),
            "collectives": {k: dict(v) for k, v in self.collectives.items()},
        }

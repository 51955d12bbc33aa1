"""Optional in-model activation sharding constraints (counterpart of
``repro/models/sharding_ctx.py``).

The JAX package's step functions activate a context with the mesh's axis
sizes, and model code pins hot intermediate activations (the MoE dispatch
buffers) with ``lax.with_sharding_constraint``.  The port keeps the API
and the rule that chooses an axis per dim (:func:`constrained_spec`).  The
port splits its compute explicitly instead: over ``"model"`` the products
of every mixer, the SwiGLU, the expert stacks and the vocab heads run on
each rank's chunks of their weights (``launch/tensor_parallel.py``),
their activations whole or split as each product needs; in a train step
an expert stack whose E dim is over "data" stays this rank's chunk of
the experts, and the dispatch buffer of those experts alone, (E/D, C, d),
is filled by an exchange over the batch ranks (``models/moe.py``), as
the JAX package's constraint on that buffer places it.  So
:func:`constrain` returns ``x`` itself, inside the context or not: the
chosen spec says where the JAX package would place it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

from repro_torch.launch.mesh import axis_sizes

_state = threading.local()


def _sizes() -> Optional[Dict[str, int]]:
    return getattr(_state, "sizes", None)


@contextlib.contextmanager
def activation_sharding(mesh):
    """Enable activation constraints for ``mesh`` (a live ``DeviceMesh``
    or a ``MeshSpec``) in this thread."""
    prev = _sizes()
    _state.sizes = axis_sizes(mesh)
    try:
        yield
    finally:
        _state.sizes = prev


def constrained_spec(shape, *dim_axes) -> Optional[Tuple]:
    """The spec :func:`constrain` picks for a tensor of ``shape``: dim i
    over ``dim_axes[i]`` -- a mesh axis name, a tuple of names, None, or a
    LIST of such candidates (the first whose size exists, exceeds 1 and
    divides the dim wins).  Each mesh axis is used at most once.  ``None``
    outside an ``activation_sharding`` context."""
    sizes = _sizes()
    if sizes is None:
        return None
    spec = []
    used: set = set()

    def fits(ax, dim):
        axes = ax if isinstance(ax, tuple) else (ax,)
        if any(a not in sizes or a in used for a in axes):
            return False
        n = 1
        for a in axes:
            n *= sizes[a]
        return n > 1 and dim % n == 0

    for i, cand in enumerate(dim_axes):
        cands = cand if isinstance(cand, list) else [cand]
        chosen = None
        for ax in cands:
            if ax is None:
                continue
            if fits(ax, shape[i]):
                chosen = ax
                break
        spec.append(chosen)
        if chosen is not None:
            used.update(chosen if isinstance(chosen, tuple) else (chosen,))
    return tuple(spec)


def constrain(x, *dim_axes):
    """``x`` placed by :func:`constrained_spec` -- in the port, whose
    tensor-parallel products place their own activations
    (``launch/tensor_parallel.py``) and whose MoE blocks build the
    dispatch buffers of the rank's own experts (``models/moe.py``), ``x``
    itself."""
    return x

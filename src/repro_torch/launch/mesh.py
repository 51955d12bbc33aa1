"""Mesh construction and axis queries (counterpart of
``repro/launch/mesh.py``).

A mesh lays the ranks of the ``torch.distributed`` world out on named
axes, the JAX package's names:

  * ``"pod"``   -- optional leading data-parallel axis across pods;
  * ``"lanes"`` -- optional cohort-lane axis: the fused and spmd engines
    stack the clients that share a cut layer along a leading lane
    dimension, and a mesh with a ``lanes`` axis spreads those lanes over
    its ranks (each rank holds and steps only its lanes);
  * ``"data"``  -- per-lane batch parallelism;
  * ``"model"`` -- tensor parallelism (``launch/shardings.py`` recipes).

A live mesh is a ``torch.distributed.device_mesh.DeviceMesh`` built by
``init_device_mesh`` over the world of ranks (rank r sits at the row-major
position r of the shape).  :class:`MeshSpec` is a device-free description:
``axis_sizes`` / ``batch_axes`` / ``lane_axis`` take either, so sharding
recipes are computed and checked on any topology, including ones larger
than the running world.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

#: the cohort-lane mesh axis name (see launch/shardings.py recipes)
LANE_AXIS = "lanes"


@dataclass(frozen=True)
class MeshSpec:
    """Named axis sizes without ranks: enough to compute and check the
    spec trees of ``launch.shardings`` off any topology."""

    axis_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_shape) != len(self.axis_names):
            raise ValueError(f"MeshSpec shape {self.axis_shape} does not "
                             f"match axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_shape))

    @property
    def size(self) -> int:
        return math.prod(self.axis_shape)


def axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a :class:`MeshSpec` or a live ``DeviceMesh``."""
    if isinstance(mesh, MeshSpec):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` for a live mesh or a :class:`MeshSpec`."""
    if isinstance(mesh, MeshSpec):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes a (per-lane) batch shards over."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def lane_axis(mesh) -> Optional[str]:
    """The cohort-lane axis name if the mesh has one, else ``None``."""
    return LANE_AXIS if LANE_AXIS in axis_names(mesh) else None


def as_spec(mesh) -> MeshSpec:
    """The :class:`MeshSpec` of a live mesh (a spec is returned as is)."""
    if isinstance(mesh, MeshSpec):
        return mesh
    return MeshSpec(tuple(int(s) for s in mesh.mesh.shape),
                    tuple(mesh.mesh_dim_names))


def world_size() -> int:
    """Ranks in the ``torch.distributed`` world (1 when none was set up)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def mesh_device_type() -> str:
    """The device type a live mesh is built for: ``"cuda"`` under NCCL,
    ``"cpu"`` under gloo (gloo also carries CUDA tensors)."""
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def live_mesh(spec: MeshSpec):
    """A ``DeviceMesh`` of ``spec``'s shape and names over the world of
    ranks; the world must hold exactly ``spec.size`` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = world_size()
    if not dist.is_initialized() or n != spec.size:
        raise ValueError(
            f"a mesh of shape {spec.axis_shape} needs {spec.size} ranks but "
            f"the torch.distributed world has {n} (launch with "
            f"--host-devices {spec.size} or {spec.size} --distributed "
            f"processes)")
    return init_device_mesh(mesh_device_type(), spec.axis_shape,
                            mesh_dim_names=spec.axis_names)


def production_mesh_spec(*, multi_pod: bool = False,
                         lanes: int = 1) -> MeshSpec:
    """The shape of the 256-rank (single-pod) / 512-rank (multi-pod)
    production mesh.  ``lanes > 1`` factors a leading cohort-lane axis out
    of the 16-wide data axis (total rank count unchanged)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if lanes > 1:
        data = shape[-2]
        if data % lanes:
            raise ValueError(f"lanes={lanes} does not divide the data axis "
                             f"({data} chips); pick a divisor of {data}")
        shape = shape[:-2] + (lanes, data // lanes, shape[-1])
        axes = axes[:-2] + (LANE_AXIS, "data", "model")
    return MeshSpec(shape, axes)


def make_production_mesh(*, multi_pod: bool = False, lanes: int = 1):
    """The production mesh, live: the world must hold exactly 256 (512)
    ranks.  Its shape alone is :func:`production_mesh_spec`."""
    return live_mesh(production_mesh_spec(multi_pod=multi_pod, lanes=lanes))


def make_host_mesh(shape: Tuple[int, ...] = (2, 2),
                   axes: Tuple[str, ...] = ("data", "model")):
    """A mesh over the world's ranks, e.g. ``make_host_mesh((2, 2, 1),
    ("lanes", "data", "model"))`` on 4 ranks splits cohort lanes over two
    ranks and each lane's batch over the other two."""
    return live_mesh(MeshSpec(tuple(shape), tuple(axes)))


def make_lane_host_mesh(lanes: int, devices: Optional[int] = None):
    """The canonical ``(lanes, n/lanes, 1)`` lanes/data/model mesh over the
    world's ranks (``devices`` names the count to check instead): cohort
    lanes over the leading axis, each lane's batch over the rest."""
    n = devices if devices is not None else world_size()
    if lanes < 1 or n % lanes:
        raise ValueError(f"lanes={lanes} does not divide the {n} devices")
    return make_host_mesh((lanes, n // lanes, 1),
                          (LANE_AXIS, "data", "model"))

"""Multi-process launch wiring (counterpart of
``repro/launch/distributed.py``): the ``torch.distributed`` process group,
resolved from CLI flags or the environment.

The spmd engine runs over whatever world of ranks ``torch.distributed``
holds.  Going past one process is a launch concern, handled here:

  * :func:`resolve_options` reads ``--distributed --coordinator HOST:PORT
    --num-processes N --process-id I`` from argv, with the environment
    fallbacks ``REPRO_DISTRIBUTED``, ``REPRO_COORDINATOR``,
    ``REPRO_NUM_PROCESSES`` and ``REPRO_PROCESS_ID``;
  * :func:`maybe_initialize` joins the process group
    (``init_method=tcp://<coordinator>``): NCCL when every rank of this
    host has a card of its own (``torch.cuda.set_device(local rank)``
    first), gloo otherwise, with a timeout so that a dead peer cannot hang
    the run.

The JAX launch also sets XLA's latency-hiding flags; they have no
counterpart here.  ``launch.hostdevices`` runs N ranks on one host (the
CPU demo and the tests) over the same group setup.
"""
from __future__ import annotations

import datetime
import os
import sys
from dataclasses import dataclass
from typing import Optional, Sequence

#: how long a collective may wait for its peers before the rank fails
TIMEOUT = datetime.timedelta(seconds=300)


@dataclass(frozen=True)
class DistributedOptions:
    """A launch's resolved multi-process request (``enabled=False`` for the
    ordinary single-process run)."""

    enabled: bool = False
    coordinator: Optional[str] = None      # "host:port"
    num_processes: Optional[int] = None
    process_id: Optional[int] = None


def _argv_value(flag: str, argv: Sequence[str]) -> Optional[str]:
    for i, a in enumerate(argv):
        if a == flag and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith(flag + "="):
            return a.split("=", 1)[1]
    return None


def _truthy(v: Optional[str]) -> bool:
    return v is not None and v.strip().lower() not in ("", "0", "false",
                                                       "off", "no")


def _int_option(flag: str, env: str, argv: Sequence[str]) -> Optional[int]:
    """An integer launch option from argv (preferred) or the ``env``
    fallback.  A malformed argv value resolves to ``None`` (argparse parses
    the same flag later and gives the canonical error); a malformed env var
    raises here, since nothing else ever reads it."""
    v = _argv_value(flag, argv)
    if v is not None:
        try:
            return int(v)
        except ValueError:
            return None
    v = os.environ.get(env)
    if v is None or not v.strip():
        return None
    try:
        return int(v)
    except ValueError:
        raise ValueError(
            f"{env}={v!r} is not an integer (fix or unset it; a dropped "
            f"value would leave the rank unknown)") from None


def resolve_options(argv: Optional[Sequence[str]] = None
                    ) -> DistributedOptions:
    """The launch's :class:`DistributedOptions` from argv flags, with
    ``REPRO_*`` environment fallbacks."""
    argv = sys.argv if argv is None else argv
    coord = (_argv_value("--coordinator", argv)
             or os.environ.get("REPRO_COORDINATOR"))
    nproc = _int_option("--num-processes", "REPRO_NUM_PROCESSES", argv)
    pid = _int_option("--process-id", "REPRO_PROCESS_ID", argv)
    enabled = ("--distributed" in argv
               or _truthy(os.environ.get("REPRO_DISTRIBUTED"))
               or coord is not None)
    return DistributedOptions(enabled=enabled, coordinator=coord,
                              num_processes=nproc, process_id=pid)


def pick_backend(local_rank: int, local_world: int,
                 device: Optional[str] = None,
                 backend: Optional[str] = None) -> str:
    """``backend`` if named, else ``"nccl"`` when every rank of this host
    has a card of its own (and the run is not asked onto the CPU), else
    ``"gloo"``.  Under NCCL card ``local_rank`` becomes the current one."""
    import torch
    if backend is None:
        backend = ("nccl" if device != "cpu" and torch.cuda.is_available()
                   and torch.cuda.device_count() >= local_world else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    return backend


def init_group(init_method: str, rank: int, world: int, *,
               local_rank: int, local_world: int,
               device: Optional[str] = None,
               backend: Optional[str] = None) -> str:
    """Join the world's process group; returns the backend in use
    (:func:`pick_backend`)."""
    import torch.distributed as dist
    backend = pick_backend(local_rank, local_world, device, backend)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    return backend


def maybe_initialize(opts: DistributedOptions,
                     device: Optional[str] = None) -> Optional[str]:
    """Join the process group of a distributed launch; returns the backend
    (``None`` when the launch is not distributed).  The coordinator, the
    process count and this process's id must all be given."""
    if not opts.enabled:
        return None
    missing = [name for name, v in (("--coordinator", opts.coordinator),
                                    ("--num-processes", opts.num_processes),
                                    ("--process-id", opts.process_id))
               if v is None]
    if missing:
        raise ValueError(f"a --distributed launch needs {', '.join(missing)}"
                         f" (or the REPRO_* environment fallbacks)")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", opts.num_processes))
    local_rank = int(os.environ.get("LOCAL_RANK",
                                    opts.process_id % local_world))
    backend = init_group(f"tcp://{opts.coordinator}", opts.process_id,
                         opts.num_processes, local_rank=local_rank,
                         local_world=local_world, device=device)
    print(f"[rank {opts.process_id}/{opts.num_processes}] "
          f"torch.distributed backend={backend}", flush=True)
    return backend


def is_coordinator() -> bool:
    """True on the rank that owns shared-filesystem side effects
    (checkpoints, driver sidecars): rank 0, or the one process of a run
    without a process group."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0

"""N ranks on one host (counterpart of ``repro/launch/hostdevices.py``).

The JAX package turns ``--host-devices N`` into N fake XLA CPU devices in
one process (``force_host_devices``).  The port's counterpart is N
processes, one rank each, joined over gloo (NCCL when every rank has a
card of its own): ``launch.train --host-devices N``, the spmd engine's
tests, and the card check where two ranks share one card.

:func:`run_host_ranks` spawns them (``multiprocessing`` ``spawn``
context) with a ``file://`` rendezvous in a fresh temporary directory, so
parallel launches never share a port or a file.  Each rank's standard
output and error go to a log of its own; a rank that raises ends every
rank, and the launcher raises :class:`RankFailed` with that rank's log.
"""
from __future__ import annotations

import os
import pickle
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple


class RankFailed(RuntimeError):
    """A rank of :func:`run_host_ranks` exited with an error."""

    def __init__(self, rank: int, code: int, log: str):
        self.rank, self.code, self.log = rank, code, log
        super().__init__(f"rank {rank} exited with code {code}:\n"
                         f"{log[-6000:]}")


def _rank_main(rank: int, world: int, init: str, tmp: str,
               device: Optional[str], backend: Optional[str],
               target: Callable, args: Sequence):
    log = os.path.join(tmp, f"rank{rank}.log")
    fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    sys.stdout = os.fdopen(1, "w", buffering=1)
    sys.stderr = os.fdopen(2, "w", buffering=1)
    import torch
    import torch.distributed as dist

    from repro_torch.launch.distributed import init_group
    if device == "cpu":
        # ranks share the host's cores
        torch.set_num_threads(max(1, min(2, (os.cpu_count() or 1) // world)))
    try:
        backend = init_group(init, rank, world, local_rank=rank,
                             local_world=world, device=device,
                             backend=backend)
        print(f"[rank {rank}/{world}] torch.distributed backend={backend}",
              flush=True)
        result = target(*args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()


class HostRanks:
    """``n`` local ranks of one process group running ``target(*args)``,
    started at construction; :meth:`wait` returns each rank's ``(log,
    return value)`` in rank order.  ``target`` must be importable (it is
    pickled by name) and its return value picklable.  ``device="cpu"``
    keeps the group on gloo and each rank to a share of the cores;
    ``backend`` names the group's backend (``"gloo"`` lets ranks share a
    card), else it is picked as a launch picks it."""

    def __init__(self, n: int, target: Callable, args: Sequence = (), *,
                 device: Optional[str] = None,
                 backend: Optional[str] = None, timeout: float = 1800.0):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.n = n
        self._tmp = tempfile.TemporaryDirectory(prefix="repro-ranks-")
        init = "file://" + os.path.join(self._tmp.name, "rendezvous")
        self._deadline = time.monotonic() + timeout
        self._timeout = timeout
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, n, init, self._tmp.name, device,
                                         backend, target, args))
                       for r in range(n)]
        for p in self._procs:
            p.start()

    def wait(self) -> List[Tuple[str, Any]]:
        procs, tmp = self._procs, self._tmp.name
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)]
                if bad:
                    failed = bad[0]
                    break
                if time.monotonic() > self._deadline:
                    failed = -1
                    break
                procs[0].join(0.1)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(30)
                if p.is_alive():
                    p.kill()
                    p.join()
        try:
            logs = []
            for r in range(self.n):
                path = os.path.join(tmp, f"rank{r}.log")
                logs.append(open(path).read() if os.path.exists(path)
                            else "")
            if failed is None:
                bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
                failed = bad[0] if bad else None
            if failed == -1:
                raise RankFailed(0, -1, f"timed out after "
                                 f"{self._timeout:.0f} s\n" + logs[0])
            if failed is not None:
                raise RankFailed(failed, procs[failed].exitcode,
                                 logs[failed])
            results = []
            for r in range(self.n):
                with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                    results.append(pickle.load(f))
            return list(zip(logs, results))
        finally:
            self._tmp.cleanup()


def run_host_ranks(n: int, target: Callable, args: Sequence = (), *,
                   device: Optional[str] = None,
                   timeout: float = 1800.0) -> List[Tuple[str, Any]]:
    """:class:`HostRanks` started and waited for."""
    return HostRanks(n, target, args, device=device, timeout=timeout).wait()

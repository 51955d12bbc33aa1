"""Double-buffered host->device chunk staging for the fused engine (a copy
of ``repro/data/staging.py``: pure Python threads, no framework).

The fused engine executes a run as a sequence of pre-staged chunks
(``[rounds, E, k, B, ...]`` device tensors stepped by its round loop).
Staging a chunk is host work (drawing minibatches through the session's
``DataCursor``, filling the cohort-stacked buffers, enqueueing their copies
to the card) while executing a chunk is device work, and CUDA launches are
asynchronous.  Running them back to back idles the card during staging and
the host during compute.

:class:`StagedChunkPipeline` overlaps the two: a background producer
thread stages chunk *n+1* while chunk *n* runs, bounded by a
``depth``-deep buffer pool (depth 2 = the classic double buffer: one
chunk in compute, one staged ahead).  The consumer releases a buffer slot
only once a chunk's results have been fetched, so at most ``depth``
chunks of staged data are resident at any moment, and the engine sizes
its auto chunks with the staging budget divided by the depth
(``FusedEngine._auto_chunk_rounds``), so the resident total stays within
``stage_budget_bytes`` rather than depth times it.

Determinism: the producer stages chunks strictly in plan order through
the *same* stage callable the serial path uses, so the ``DataCursor``
draw sequence, and therefore the training trajectory and the batch
cursors, is bit-identical with the pipeline on or off
(``tests/test_torch_fused.py``).

``overlap=False`` degrades to synchronous staging inside :meth:`get`
(no thread): the kill switch (``REPRO_OVERLAP_STAGING=0``) and the
baseline of an overlap measurement.
"""
from __future__ import annotations

import queue
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence


@dataclass
class StageStats:
    """Wall-clock accounting for one pipeline run.

    ``stage_s`` is total producer time spent staging (draw + stack +
    copy dispatch); ``wait_s`` is total consumer time blocked
    waiting for a chunk that was not ready.  Staging time not spent
    waiting was hidden behind compute, so the *overlap fraction* is
    ``1 - wait_s / stage_s`` (0 when nothing was hidden — e.g. the
    serial path, where the consumer waits for every staging in full)."""

    chunks: int = 0
    stage_s: float = 0.0
    wait_s: float = 0.0
    overlap: bool = field(default=False)

    @property
    def overlap_fraction(self) -> float:
        if self.stage_s <= 0.0:
            return 0.0
        return max(0.0, min(1.0, 1.0 - self.wait_s / self.stage_s))

    def as_dict(self) -> dict:
        return {"chunks": self.chunks, "stage_s": self.stage_s,
                "wait_s": self.wait_s, "overlap": self.overlap,
                "overlap_fraction": self.overlap_fraction}


class StagedChunkPipeline:
    """Bounded producer/consumer staging of a run's chunk plan.

    ``stage_fn(n)`` stages one ``n``-round chunk (the engine's
    ``_stage_chunk`` bound to the run's ``local_epochs``); ``plan`` is
    the run's chunk sizes in execution order.  The consumer protocol:

        pipeline = StagedChunkPipeline(stage_fn, plan)
        for n in plan:
            xs, ys = pipeline.get()       # blocks until chunk is staged
            ... dispatch the chunk's rounds on (xs, ys) ...
            ... fetch the previous chunk's losses ...
            pipeline.release()            # that chunk's buffers are dead
        pipeline.close()                  # also safe mid-run on error

    ``release()`` must be called once per completed chunk (it frees a
    buffer slot for the producer); ``close()`` is idempotent and must
    run on every exit path so the producer thread never outlives the
    run."""

    def __init__(self, stage_fn: Callable[[int], Any], plan: Sequence[int],
                 *, depth: int = 2, overlap: bool = True):
        if depth < 2:
            raise ValueError(f"pipeline depth must be >= 2 (one chunk in "
                             f"compute plus >= 1 staged ahead); got {depth}")
        self._stage_fn = stage_fn
        self._plan = list(plan)
        self._overlap = overlap
        self.stats = StageStats(overlap=overlap)
        self._serial_next = 0
        if not overlap:
            return
        self._q: queue.Queue = queue.Queue()
        self._slots = threading.Semaphore(depth)
        self._cancelled = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, name="staged-chunk-producer", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- producer
    def _produce(self) -> None:
        try:
            for n in self._plan:
                self._slots.acquire()
                if self._cancelled.is_set():
                    return
                t0 = time.perf_counter()
                chunk = self._stage_fn(n)
                dt = time.perf_counter() - t0
                # re-check after the (possibly long) stage_fn: once close()
                # has cancelled us, the consumer may already be reading
                # stats — stop mutating shared state and drawing from the
                # session's data cursor
                if self._cancelled.is_set():
                    return
                self.stats.stage_s += dt
                self._q.put((chunk, None))
        except BaseException as e:                        # noqa: BLE001
            # surface staging failures at the consumer's next get(), with
            # the original traceback chained
            self._q.put((None, e))

    # ------------------------------------------------------------- consumer
    def get(self) -> Any:
        """The next staged chunk, in plan order (blocks until ready)."""
        if not self._overlap:
            n = self._plan[self._serial_next]
            self._serial_next += 1
            t0 = time.perf_counter()
            chunk = self._stage_fn(n)
            dt = time.perf_counter() - t0
            self.stats.stage_s += dt
            self.stats.wait_s += dt       # serial: every staging is waited
            self.stats.chunks += 1
            return chunk
        t0 = time.perf_counter()
        chunk, err = self._q.get()
        self.stats.wait_s += time.perf_counter() - t0
        if err is not None:
            self.close()
            raise err
        self.stats.chunks += 1
        return chunk

    def release(self) -> None:
        """Mark one previously-``get``'d chunk's buffers dead (its compute
        results were fetched), freeing a slot for the producer."""
        if self._overlap:
            self._slots.release()

    def close(self) -> None:
        """Stop the producer (idempotent; safe on error paths)."""
        if not self._overlap:
            return
        self._cancelled.set()
        self._slots.release()             # unblock a producer parked on acquire
        self._thread.join(timeout=60.0)
        if self._thread.is_alive():
            # a stuck stage_fn: the daemon thread is still drawing from the
            # session's DataCursor, so stats may be incomplete and the
            # session must not run again in this process (the cursor's
            # draw bookkeeping would be corrupted)
            warnings.warn(
                "staged-chunk producer thread did not exit within 60s "
                "(stage_fn stuck?); staging stats may be incomplete and "
                "this session is unsafe to reuse until the thread dies",
                RuntimeWarning, stacklevel=2)

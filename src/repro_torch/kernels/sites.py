"""Site scopes: the kernel wrappers and the dispatch name the work of each
hot-site call for a step analysis (``launch/step_analysis.py``).

A site is one call of a routed kernel: ``attention_fwd`` (every attention
forward: training, prefill, decode, cross), ``attention_dkv`` and
``attention_dq`` (the two backward kernels), ``wkv_fwd``, ``wkv_bwd`` and
``gate`` (the Alg. 3 entropy gate).  Its FLOPs and bytes come from the
shapes by the formulas of ``kernels/dispatch.py``, whatever runs inside:
the CUDA kernel, its plain version on the CPU, or nothing (a fake tensor
in a dry run).  So a card run, a CPU run and a dry run of one step read
the same site numbers.

While a scope is open, the aten ops run inside it (the plain versions'
own work, and the wrappers' casts and copies) belong to the site: an
analysis counts them apart.  Scopes nest; only the outermost records
(``flash_attention_bwd`` records dK/dV and dQ, and the two wrappers it
calls record nothing again).  With no analysis listening a scope costs
one list check.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

from torch._subclasses.fake_tensor import FakeTensor

#: analyses listening (``launch.step_analysis.StepAnalysis`` instances)
_listeners: list = []
_depth = 0

Entry = Tuple[str, float, float]         # (site name, flops, bytes)


def listen(analysis) -> None:
    _listeners.append(analysis)


def unlisten(analysis) -> None:
    _listeners.remove(analysis)


def inside() -> bool:
    """Whether a site scope is open (its ops belong to the site)."""
    return _depth > 0


class scope:
    """``with scope(entries):`` -- ``entries`` a callable returning the
    site entries ``(name, flops, bytes)`` of this call, evaluated only when
    an analysis listens and no scope is open already."""

    __slots__ = ("entries",)

    def __init__(self, entries: Callable[[], Iterable[Entry]]):
        self.entries = entries

    def __enter__(self):
        global _depth
        if _depth == 0 and _listeners:
            for name, flops, nbytes in self.entries():
                for a in _listeners:
                    a.add_site(name, flops, nbytes)
        _depth += 1
        return self

    def __exit__(self, *exc):
        global _depth
        _depth -= 1
        return False


def collective(kind: str, nbytes: float, count: int = 1) -> None:
    """``count`` collectives of ``kind`` (``all_gather``: bytes received
    by this rank; ``all_reduce``, ``broadcast``: bytes of the buffer)."""
    for a in _listeners:
        a.add_collective(kind, nbytes, count)


def nbytes(*tensors) -> float:
    """Bytes of the tensors' elements (``None`` entries skipped)."""
    return float(sum(t.numel() * t.element_size() for t in tensors
                     if t is not None))


def is_fake(t) -> bool:
    """Whether ``t`` is a ``FakeTensor`` (a dry run's stand-in): it takes
    the kernel path's allocations on any device and launches nothing."""
    return isinstance(t, FakeTensor)


# ---------------------------------------------------------------------------
# per-call FLOPs (the formulas of kernels/dispatch.py's model-level counts)
# ---------------------------------------------------------------------------

#: each attention kernel's block matmuls over the forward's two (S = QK^T,
#: O = PV): dK/dV recomputes S and forms dP, dV, dK (4); dQ recomputes S
#: and forms dP, dQ (3); together JAX's fused backward, 3.5 x forward
ATTENTION_SHARES = {"fwd": 1.0, "dkv": 2.0, "dq": 1.5}


def attention_call_flops(batch: int, heads: int, tq: int, tk: int,
                         head_dim: int, window: Optional[int] = None,
                         kind: str = "fwd") -> float:
    """FLOPs of one attention kernel call, the model-level count: the full
    Tq x Tk rectangle (keys capped at the window), ``4 * B * H * Tq * Tk *
    D`` for the forward, times :data:`ATTENTION_SHARES` for the backward
    kernels.  Causal masking is not subtracted (see
    ``dispatch.attention_site_flops``)."""
    tk = min(tk, window) if window else tk
    return 4.0 * batch * heads * tq * tk * head_dim * ATTENTION_SHARES[kind]


def wkv_call_flops(batch: int, seq: int, heads: int, head_dim: int,
                   chunk: int, kind: str = "fwd") -> float:
    """FLOPs of one chunked wkv call, the model-level count: per token per
    head ``4*Q*K`` intra-chunk plus ``4*K*K`` state work (Q = min(chunk,
    T)); the backward twice the forward."""
    q = min(chunk, seq)
    f = batch * seq * heads * head_dim * (4.0 * q + 4.0 * head_dim)
    return 2.0 * f if kind == "bwd" else f

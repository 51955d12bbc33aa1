"""Streaming softmax entropy + exit gate: the wrapper of
``csrc/entropy_exit.cu`` (which replaces the TPU kernel
``repro/kernels/entropy_exit.py:entropy_exit_pallas``).

The kernel splits each row's vocab over the blocks of one thread block
cluster; :func:`gate_splits` picks how many from the shape.  For a tensor
on the CPU the wrapper runs the plain version
(``kernels/ref.py:entropy_exit_ref``); for a CUDA tensor it launches the
kernel or raises; for a ``FakeTensor`` on any device (a dry run) it
allocates the kernel's outputs and launches nothing.  It opens the
``gate`` site scope (``kernels/sites.py``) on every device.
``entropy_exit.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, sites
from repro_torch.kernels.ref import entropy_exit_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# entropy_exit_launch(logits, dtype, rows, row_stride, vocab, splits, tau,
#                     entropy, exit_flag, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]

# the kernel's largest cluster (above 8: non-portable), and the largest
# gate_splits picks: 16 blocks beat 8 at glm4-9b's serve shape on an H100
# (PERF.md, section 6)
MAX_SPLITS = 16
MIN_SLICE = 4096     # elements a block takes at least when a row is split
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("entropy_exit.cu")
        lib.entropy_exit_launch.argtypes = _ARGTYPES
        lib.entropy_exit_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (read once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def gate_splits(rows: int, vocab: int, sms: int) -> int:
    """Blocks (one cluster) per row: 1 when the rows alone fill half the
    SMs or a row holds fewer than 2 x ``MIN_SLICE`` elements; else enough
    to fill the SMs, at most ``MAX_SPLITS`` and at most one per
    ``MIN_SLICE`` elements."""
    if 2 * rows >= sms:
        return 1
    return max(1, min(MAX_SPLITS, -(-sms // rows), vocab // MIN_SLICE))


def gate_site(logits):
    """The gate's site entry: no dot FLOPs; the (B, V) logits read once, H
    and the exit flags (B,) written once."""
    return (("gate", 0.0, sites.nbytes(logits) + 8.0 * logits.shape[0]),)


def entropy_exit(logits: torch.Tensor, tau):
    """logits (B, V) float32 or bfloat16; ``tau`` a float or (B,) per-row
    thresholds -> ``(entropy (B,) float32, exit (B,) int32)``, exit iff
    H < tau.  ``tau`` stays on the device: reading it does not sync.

    A row holding a -inf logit, or of -inf only, has H = NaN and never
    exits, on either device: p log p = 0 x -inf = NaN there, as the JAX
    kernel computes it."""
    if logits.ndim != 2:
        raise ValueError(f"entropy_exit expects (B, V) logits, got "
                         f"{tuple(logits.shape)}")
    B, V = logits.shape
    with sites.scope(lambda: gate_site(logits)):
        tau = torch.as_tensor(tau, dtype=torch.float32,
                              device=logits.device).expand(B).contiguous()
        fake = sites.is_fake(logits)
        if logits.device.type == "cpu" and not fake:
            return entropy_exit_ref(logits, tau)
        if logits.device.type != "cuda" and not fake:
            raise ValueError(f"entropy_exit: unsupported device "
                             f"{logits.device}")
        return _entropy_exit_kernel(logits, tau, fake)


def _entropy_exit_kernel(logits, tau, fake: bool):
    B, V = logits.shape
    if logits.dtype not in _DTYPES:
        raise ValueError(f"entropy_exit: dtype {logits.dtype} not supported; "
                         f"expected one of {tuple(_DTYPES)}")
    if logits.stride(-1) != 1 or B == 0 or V == 0:
        raise ValueError(f"entropy_exit: logits {tuple(logits.shape)} with "
                         f"strides {logits.stride()} must be non-empty with "
                         f"a unit vocab stride")
    H = torch.empty(B, dtype=torch.float32, device=logits.device)
    ex = torch.empty(B, dtype=torch.int32, device=logits.device)
    if fake:
        return H, ex
    splits = gate_splits(B, V, sm_count(logits.device.index))
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        rc = _library().entropy_exit_launch(
            logits.data_ptr(), _DTYPES[logits.dtype], B, logits.stride(0), V,
            splits, tau.data_ptr(), H.data_ptr(), ex.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"entropy_exit kernel launch failed: CUDA error "
                           f"{rc} at logits {tuple(logits.shape)}, a cluster "
                           f"of {splits} blocks per row")
    entropy_exit.launches += 1
    return H, ex


entropy_exit.launches = 0

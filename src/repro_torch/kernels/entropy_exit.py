"""Streaming softmax entropy + exit gate: the wrapper of
``csrc/entropy_exit.cu`` (which replaces the TPU kernel
``repro/kernels/entropy_exit.py:entropy_exit_pallas``).

For a tensor on the CPU the wrapper runs the plain version
(``kernels/ref.py:entropy_exit_ref``); for a CUDA tensor it launches the
kernel or raises.  ``entropy_exit.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import entropy_exit_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _launcher():
    global _lib
    if _lib is None:
        lib = build.load("entropy_exit.cu")
        fn = lib.entropy_exit_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


def entropy_exit(logits: torch.Tensor, tau):
    """logits (B, V) float32 or bfloat16; ``tau`` a float or (B,) per-row
    thresholds -> ``(entropy (B,) float32, exit (B,) int32)``, exit iff
    H < tau.  ``tau`` stays on the device: reading it does not sync."""
    if logits.ndim != 2:
        raise ValueError(f"entropy_exit expects (B, V) logits, got "
                         f"{tuple(logits.shape)}")
    B, V = logits.shape
    tau = torch.as_tensor(tau, dtype=torch.float32,
                          device=logits.device).expand(B).contiguous()
    if logits.device.type == "cpu":
        return entropy_exit_ref(logits, tau)
    if logits.device.type != "cuda":
        raise ValueError(f"entropy_exit: unsupported device {logits.device}")
    if logits.dtype not in _DTYPES:
        raise ValueError(f"entropy_exit: dtype {logits.dtype} not supported; "
                         f"expected one of {tuple(_DTYPES)}")
    if logits.stride(-1) != 1 or B == 0 or V == 0:
        raise ValueError(f"entropy_exit: logits {tuple(logits.shape)} with "
                         f"strides {logits.stride()} must be non-empty with "
                         f"a unit vocab stride")
    H = torch.empty(B, dtype=torch.float32, device=logits.device)
    ex = torch.empty(B, dtype=torch.int32, device=logits.device)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        rc = _launcher()(logits.data_ptr(), _DTYPES[logits.dtype], B,
                         logits.stride(0), V, tau.data_ptr(), H.data_ptr(),
                         ex.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"entropy_exit kernel launch failed: CUDA error "
                           f"{rc} at logits {tuple(logits.shape)}")
    entropy_exit.launches += 1
    return H, ex


entropy_exit.launches = 0

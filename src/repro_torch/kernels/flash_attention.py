"""Flash attention forward: the wrapper of ``csrc/flash_attention.cu``
(which replaces the TPU kernel
``repro/kernels/flash_attention.py:flash_attention_pallas``).

The kernel masks its own ragged edges (keys past ``Tk``, the causal
diagonal of a ragged ``Tq < Tk`` prefill, the decode ring's ``kv_valid``),
so the padding of ``repro/kernels/ops.py`` has no counterpart here.  For
tensors on the CPU the wrapper runs the plain version
(``kernels/ref.py:flash_attention_ref``); for CUDA tensors it launches the
kernel or raises.  ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


class _FlashParams(ctypes.Structure):
    """Mirrors ``struct FlashParams`` in csrc/flash_attention.cu."""
    _fields_ = ([(n, ctypes.c_void_p)
                 for n in ("q", "k", "v", "out", "lse", "kv_len")]
                + [(f"{t}_s{a}", ctypes.c_longlong)
                   for t in "qkvo" for a in "bht"]
                + [(n, ctypes.c_int)
                   for n in ("batch", "heads", "kv_heads", "tq", "tk",
                             "head_dim", "causal", "window", "dtype")]
                + [("scale", ctypes.c_float)])


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention.cu").flash_attention_launch
        fn.argtypes = [ctypes.POINTER(_FlashParams), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_operands(q, k, v, kv_valid) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"attention operands must be rank-4 (B, H, T, D): "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q/k batch or head-dim mismatch: q {tuple(q.shape)} "
                         f"vs k {tuple(k.shape)}")
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"GQA head mismatch: H={q.shape[1]} is not a "
                         f"multiple of Hkv={k.shape[1]}")
    if kv_valid is not None and tuple(kv_valid.shape) != (q.shape[0],):
        raise ValueError(f"kv_valid must hold one value per row, shape "
                         f"({q.shape[0]},); got {tuple(kv_valid.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    kv_valid: Optional[torch.Tensor] = None,
                    return_lse: bool = False):
    """q (B, H, Tq, D); k/v (B, Hkv, Tk, D) with H % Hkv == 0 -> out
    (B, H, Tq, D) in q's dtype [+ lse (B, H, Tq) float32].  ``kv_valid``
    (B,) int32 masks keys at ``kpos >= kv_valid[b]`` in row b.

    On the card the operands may have any strides whose innermost one is 1
    (transposed views of the model's (B, T, H, D) tensors are read in
    place); the output has q's strides."""
    _check_operands(q, k, v, kv_valid)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   kv_valid=kv_valid, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes q {q.dtype}, k {k.dtype}, "
                         f"v {v.dtype}; expected one of {tuple(_DTYPES)}, "
                         f"all equal")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if min(B, Tq, Tk) == 0 or any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: operands must be non-empty with "
                         "a unit innermost stride")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got "
                         f"{window}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("flash_attention: q, k and v must share a device")
    if kv_valid is not None and (kv_valid.dtype != torch.int32
                                 or kv_valid.device != q.device
                                 or not kv_valid.is_contiguous()):
        raise ValueError("flash_attention: kv_valid must be a contiguous "
                         "int32 tensor on q's device")
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    p = _FlashParams(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        kv_valid.data_ptr() if kv_valid is not None else None,
        *(s for t in (q, k, v, out) for s in (t.stride(0), t.stride(1),
                                               t.stride(2))),
        B, H, Hkv, Tq, Tk, D, int(causal), window or 0, _DTYPES[q.dtype],
        1.0 / math.sqrt(D))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _launcher()(ctypes.byref(p), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{rc} at q {tuple(q.shape)}, k {tuple(k.shape)}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0

"""Flash attention: the wrappers of ``csrc/flash_attention.cu`` (the
forward, which replaces the TPU kernel
``repro/kernels/flash_attention.py:flash_attention_pallas``) and
``csrc/flash_attention_bwd.cu`` (the dK/dV and dQ kernels, which replace
``flash_attention_bwd_dkv_pallas`` and ``flash_attention_bwd_dq_pallas``).

Each kernel has routes chosen by a fixed rule (:func:`attention_route`,
:func:`dkv_route`, :func:`dq_route`): for bf16 and head dims 64, 128 and
256, tensor-core "tile" routes (wgmma; the backward's at 256 split the
output columns across two blocks), and for the forward a "decode" route
(mma.sync, the keys split across a thread block cluster,
:func:`decode_splits`) when Tq * G is below one 64-row tile; the "row"
routes of plain FMAs take everything else (fp32, other head dims, rows
not on 16 bytes).  The dQ tile route can form delta = rowsum(dO * O)
itself (``o=``), and :func:`flash_attention_bwd` then hands what it wrote
to the dK/dV kernel.

The kernels mask their own ragged edges (keys past ``Tk``, the causal
diagonal of a ragged ``Tq < Tk`` prefill, the decode ring's ``kv_valid``),
so the padding of ``repro/kernels/ops.py`` has no counterpart here.  For
tensors on the CPU each wrapper runs its plain version
(``kernels/ref.py``) and returns its results in the kernel's layout; for
CUDA tensors it launches its kernel or raises;
for a ``FakeTensor`` on any device (a dry run, ``launch/dryrun.py``) it
allocates what the launching branch allocates, by the same function, and
launches nothing.  Each wrapper opens a site scope (``kernels/sites.py``)
around its work on every device.  ``launches`` on each wrapper counts
kernel launches, and ``row_launches``, ``tile_launches`` and (forward)
``decode_launches`` count them by route.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build, sites
from repro_torch.kernels.ref import (flash_attention_bwd_dkv_ref,
                                     flash_attention_bwd_dq_ref,
                                     flash_attention_bwd_ref,
                                     flash_attention_ref)

HEAD_DIMS = (16, 32, 64, 128, 256)
TILE_HEAD_DIMS = (64, 128, 256)
TILE_ROWS = 64          # flattened (t, g) query rows of one tile-route block
TILE_KEYS = 64          # keys of one K/V tile
NUM_SMS = 132           # streaming multiprocessors of an H100 SXM
MAX_CLUSTER = 8         # the portable thread block cluster size
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fns: dict = {}


def attention_route(dtype: torch.dtype, head_dim: int, tq: int,
                    group: int) -> str:
    """The forward kernel for these operands: ``"tile"`` (wgmma) for bf16,
    head dim 64, 128 or 256 and at least one full tile of Tq * G query
    rows; ``"decode"`` (mma.sync, the keys split across a cluster) for
    bf16, head dim 64, 128 or 256 and fewer rows (decode's Tq * G = G rows
    would leave most of a 64-row tile empty); ``"row"`` for everything
    else (fp32 must stay exact to 2e-5; head dims 16 and 32)."""
    if dtype != torch.bfloat16 or head_dim not in TILE_HEAD_DIMS:
        return "row"
    return "tile" if tq * group >= TILE_ROWS else "decode"


def dkv_route(dtype: torch.dtype, head_dim: int) -> str:
    """The dK/dV kernel for these operands: ``"tile"`` (wgmma, the GQA
    group split across a thread block cluster) for bf16 and head dim 64,
    128 or 256, ``"row"`` for everything else."""
    return ("tile" if dtype == torch.bfloat16 and head_dim in TILE_HEAD_DIMS
            else "row")


def dq_route(dtype: torch.dtype, head_dim: int) -> str:
    """The dQ kernel for these operands: ``"tile"`` (wgmma, 64 flattened
    (t, g) rows a block, delta fused) for bf16 and head dim 64, 128 or
    256, ``"row"`` for everything else; the same rule as
    :func:`dkv_route`."""
    return dkv_route(dtype, head_dim)


def decode_splits(batch_kv_heads: int, key_tiles: int) -> int:
    """Blocks of the decode route's cluster per (batch, kv head): enough
    to fill the card's SMs, at most the portable cluster size and at most
    one per 64-key tile."""
    want = -(-NUM_SMS // max(1, batch_kv_heads))
    return max(1, min(MAX_CLUSTER, key_tiles, want))


def _base_aligned(t: torch.Tensor) -> bool:
    """``t``'s first element sits on 16 bytes: its address on the card; a
    fake tensor has none, and its offset into its storage stands in (the
    caching allocator's blocks start on 512 bytes)."""
    if sites.is_fake(t):
        return t.storage_offset() * t.element_size() % 16 == 0
    return t.data_ptr() % 16 == 0


def _rows_aligned(*tensors) -> bool:
    """Every row starts on 16 bytes (the tile routes copy rows in 16-byte
    pieces): aligned base pointers and strides of whole 16-byte units."""
    return all(_base_aligned(t)
               and all(t.stride(i) * t.element_size() % 16 == 0
                       for i in range(3)) for t in tensors)


def _on_card(name: str, t: torch.Tensor) -> bool:
    """Whether ``t`` takes the kernel path: a CUDA tensor (launches) or a
    fake tensor on any device (allocates only); False for a real CPU
    tensor (the plain version); raises for any other device."""
    if sites.is_fake(t) or t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def fwd_site(q, k, v, window, return_lse, kv_valid):
    """The forward's site entry: the model-level FLOPs; q, k, v (and
    kv_valid) read, the output (and the LSE) written once."""
    B, H, Tq, D = q.shape
    lse = B * H * Tq * 4 if return_lse else 0
    return (("attention_fwd",
             sites.attention_call_flops(B, H, Tq, k.shape[2], D, window),
             sites.nbytes(q, k, v, kv_valid, q) + lse),)


def _fwd_outputs(q, return_lse: bool):
    """The forward's outputs as the kernels write them: out with q's
    strides, the LSE (B, H, Tq) float32."""
    B, H, Tq, _ = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    return out, lse


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


def _launcher(route: str):
    if route not in _fns:
        lib = build.load("flash_attention.cu")
        fn = getattr(lib, {"row": "flash_attention_launch",
                           "tile": "flash_attention_tile_launch",
                           "decode": "flash_attention_decode_launch"}[route])
        fn.argtypes = ([ctypes.POINTER(_FlashParams)]
                       + ([ctypes.c_int] if route == "decode" else [])
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[route] = fn
    return _fns[route]


def _pick_route(name: str, rule: str, route: Optional[str], aligned) -> str:
    """The rule's route, the row route where the tile routes' 16-byte rows
    do not hold; ``route`` given (a comparison on the card) must be the
    rule's or "row"."""
    if rule != "row" and not aligned():
        rule = "row"
    if route is None:
        return rule
    if route not in (rule, "row"):
        raise ValueError(f"{name}: route {route!r} cannot take these "
                         f"operands (the rule picks {rule!r})")
    return route


def _count(wrapper, route: str) -> None:
    """One launch of ``wrapper``'s kernel on ``route``."""
    wrapper.launches += 1
    setattr(wrapper, f"{route}_launches",
            getattr(wrapper, f"{route}_launches") + 1)


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


def _check_kernel_operands(name: str, tensors, window) -> None:
    """What the CUDA kernels take: float32 or bfloat16 operands of one
    dtype on q's device, a supported head dim, non-empty, unit innermost
    stride, a positive window."""
    q = tensors[0]
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"{name}: dtypes "
                         f"{[str(t.dtype) for t in tensors]}; expected one "
                         f"of {tuple(_DTYPES)}, all equal")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {q.shape[-1]} not in {HEAD_DIMS}")
    if any(t.numel() == 0 or t.stride(-1) != 1 for t in tensors):
        raise ValueError(f"{name}: operands must be non-empty with a unit "
                         f"innermost stride")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window must be positive, got {window}")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: operands must share a device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    kv_valid: Optional[torch.Tensor] = None,
                    return_lse: bool = False, route: Optional[str] = None):
    """q (B, H, Tq, D); k/v (B, Hkv, Tk, D) with H % Hkv == 0 -> out
    (B, H, Tq, D) in q's dtype [+ lse (B, H, Tq) float32].  ``kv_valid``
    (B,) int32 masks keys at ``kpos >= kv_valid[b]`` in row b.

    On the card the operands may have any strides whose innermost one is 1
    (transposed views of the model's (B, T, H, D) tensors are read in
    place); the output has q's strides.  ``route`` None takes
    :func:`attention_route`'s kernel; "row" forces the row kernel (to
    compare the two on the card)."""
    _check_operands(q, k, v, kv_valid)
    with sites.scope(lambda: fwd_site(q, k, v, window, return_lse,
                                       kv_valid)):
        if not _on_card("flash_attention", q):
            # the plain version's results in the kernel's layout
            got = flash_attention_ref(q, k, v, causal=causal, window=window,
                                      kv_valid=kv_valid, return_lse=True)
            out, lse = _fwd_outputs(q, return_lse)
            out.copy_(got[0])
            if return_lse:
                lse.copy_(got[1])
            return (out, lse) if return_lse else out
        return _flash_attention_kernel(q, k, v, causal, window, kv_valid,
                                       return_lse, route)


def _flash_attention_kernel(q, k, v, causal, window, kv_valid, return_lse,
                            route):
    _check_kernel_operands("flash_attention", (q, k, v), window)
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if kv_valid is not None and (kv_valid.dtype != torch.int32
                                 or kv_valid.device != q.device
                                 or not kv_valid.is_contiguous()):
        raise ValueError("flash_attention: kv_valid must be a contiguous "
                         "int32 tensor on q's device")
    out, lse = _fwd_outputs(q, return_lse)
    if sites.is_fake(q):
        return (out, lse) if return_lse else out
    route = _pick_route("flash_attention",
                        attention_route(q.dtype, D, Tq, H // Hkv), route,
                        lambda: _rows_aligned(q, k, v, out))
    p = _FlashParams(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        kv_valid.data_ptr() if kv_valid is not None else None,
        *(s for t in (q, k, v, out) for s in (t.stride(0), t.stride(1),
                                               t.stride(2))),
        B, H, Hkv, Tq, Tk, D, int(causal), window or 0, _DTYPES[q.dtype],
        1.0 / math.sqrt(D))
    extra = ()
    if route == "decode":
        keys = min(Tk, Tq) if causal else Tk
        extra = (decode_splits(B * Hkv, -(-keys // TILE_KEYS)),)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _launcher(route)(ctypes.byref(p), *extra, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention {route} kernel launch failed: "
                           f"CUDA error {rc} at q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}")
    _count(flash_attention, route)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.row_launches = 0
flash_attention.tile_launches = 0
flash_attention.decode_launches = 0


# ---------------------------------------------------------------------------
# backward: dK/dV and dQ from the saved LSE
# ---------------------------------------------------------------------------


class _FlashBwdParams(ctypes.Structure):
    """Mirrors ``struct FlashBwdParams`` in csrc/flash_attention_bwd.cu."""
    _fields_ = ([(n, ctypes.c_void_p)
                 for n in ("q", "k", "v", "dout", "lse", "delta", "dq", "dk",
                           "dv")]
                + [(f"{t}_s{a}", ctypes.c_longlong)
                   for t in ("q", "k", "v", "do") for a in "bht"]
                + [(n, ctypes.c_int)
                   for n in ("batch", "heads", "kv_heads", "tq", "tk",
                             "head_dim", "causal", "window", "dtype")]
                + [("scale", ctypes.c_float), ("o", ctypes.c_void_p)]
                + [(f"o_s{a}", ctypes.c_longlong) for a in "bht"]
                + [("delta_out", ctypes.c_void_p)])


_bwd_fns: dict = {}


def _bwd_launcher(which: str):
    """``which``: "dkv" or "dq" (row routes), "dkv_tile" or "dq_tile"."""
    if which not in _bwd_fns:
        fn = getattr(build.load("flash_attention_bwd.cu"),
                     f"flash_attention_bwd_{which}_launch")
        fn.argtypes = [ctypes.POINTER(_FlashBwdParams), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_fns[which] = fn
    return _bwd_fns[which]


def _check_bwd_rows(q, do, **rows) -> None:
    """dO has q's shape; each of ``rows`` (lse, delta) is (B, H, Tq)."""
    if do.shape != q.shape:
        raise ValueError(f"cotangent shape {tuple(do.shape)} != q's "
                         f"{tuple(q.shape)}")
    for name, t in rows.items():
        if t.shape != q.shape[:3]:
            raise ValueError(f"{name} shape {tuple(t.shape)}, expected "
                             f"{tuple(q.shape[:3])}")


def _bwd_site(which: str, q, k, v, window, fused: bool = True):
    """A backward kernel's site entry: the model-level FLOPs (dK/dV 2.0 x,
    dQ 1.5 x the forward); read once: q, k, v, dO (in q's dtype), the LSE
    and delta (dK/dV) or, fused, the output O (dQ, which writes delta);
    written once: dk and dv, or dq (and delta), in float32."""
    B, H, Tq, D = q.shape
    rows = B * H * Tq * 4
    operands = sites.nbytes(q, k, v, q)
    if which == "dkv":
        nb = operands + 2 * rows + 2 * 4 * k.numel()
    else:
        nb = (operands + rows + (sites.nbytes(q) + rows if fused else rows)
              + 4 * q.numel())
    return (f"attention_{which}",
            sites.attention_call_flops(B, H, Tq, k.shape[2], D, window,
                                       which), nb)


def _launch_bwd(which: str, q, k, v, do, lse, delta, causal, window, outs,
                route=None, o=None) -> Optional[str]:
    """Checks what the CUDA kernel takes, then launches ``which`` ("dkv" or
    "dq") writing into ``outs`` (fp32, contiguous: dk and dv, or dq and,
    given ``o``, delta); raises on a failed launch.  Returns the route it
    launched ("row" or "tile"), or None for fake operands (nothing
    launched)."""
    name = f"flash_attention_bwd_{which}"
    _check_kernel_operands(name, (q, k, v, do) + ((o,) if o is not None
                                                  else ()), window)
    rule = (dkv_route if which == "dkv" else dq_route)(q.dtype, q.shape[-1])
    route = _pick_route(name, rule, route,
                        lambda: _rows_aligned(q, k, v, do,
                                              *(() if o is None else (o,))))
    if o is not None and route != "tile":
        raise ValueError(f"{name}: the fused delta (o=) needs the tile "
                         f"route; these operands take {route!r}")
    lse = lse.float().contiguous()
    if delta is not None:
        delta = delta.float().contiguous()
    if any(t is not None and t.device != q.device for t in (lse, delta)):
        raise ValueError(f"{name}: lse and delta must lie on q's device")
    if sites.is_fake(q):
        return None
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    ptrs = {n: t.data_ptr() for n, t in outs.items()}
    p = _FlashBwdParams(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr() if delta is not None else None,
        ptrs.get("dq"), ptrs.get("dk"), ptrs.get("dv"),
        *(s for t in (q, k, v, do) for s in (t.stride(0), t.stride(1),
                                              t.stride(2))),
        B, H, Hkv, Tq, Tk, D, int(causal), window or 0, _DTYPES[q.dtype],
        1.0 / math.sqrt(D), o.data_ptr() if o is not None else None,
        *((o.stride(0), o.stride(1), o.stride(2)) if o is not None
          else (0, 0, 0)), ptrs.get("delta"))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _bwd_launcher(which + ("_tile" if route == "tile" else ""))(
            ctypes.byref(p), stream)
    if rc != 0:
        raise RuntimeError(f"{name} {route} kernel launch failed: CUDA error "
                           f"{rc} at q {tuple(q.shape)}, k {tuple(k.shape)}")
    return route


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                            window: Optional[int] = None):
    """dK and dV, the GQA group summed: q/do (B, H, Tq, D), k/v
    (B, Hkv, Tk, D), ``lse`` and ``delta = rowsum(dO * O)`` (B, H, Tq)
    -> ``(dk, dv)`` (B, Hkv, Tk, D) float32."""
    _check_operands(q, k, v, None)
    _check_bwd_rows(q, do, lse=lse, delta=delta)
    with sites.scope(lambda: (_bwd_site("dkv", q, k, v, window),)):
        if not _on_card("flash_attention_bwd_dkv", q):
            return tuple(t.contiguous() for t in flash_attention_bwd_dkv_ref(
                q, k, v, do, lse, delta, causal=causal, window=window))
        dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
        route = _launch_bwd("dkv", q, k, v, do, lse, delta, causal, window,
                            {"dk": dk, "dv": dv})
        if route is not None:
            _count(flash_attention_bwd_dkv, route)
        return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta=None, *,
                           causal: bool = True, window: Optional[int] = None,
                           o: Optional[torch.Tensor] = None,
                           route: Optional[str] = None):
    """dQ: the operands of :func:`flash_attention_bwd_dkv` -> dq
    (B, H, Tq, D) float32.

    Fused form: given the forward's output ``o`` (q's shape) instead of
    ``delta``, returns ``(dq, delta)`` with delta = rowsum(dO * O) (B, H,
    Tq) float32, formed inside the tile-route kernel on the card (the CPU
    runs the plain expression).  ``route`` None takes :func:`dq_route`'s
    kernel; "row" forces the row kernel (to compare the two on the
    card)."""
    _check_operands(q, k, v, None)
    if (o is None) == (delta is None):
        raise ValueError("flash_attention_bwd_dq: give exactly one of "
                         "delta and o")
    if o is not None and o.shape != q.shape:
        raise ValueError(f"output shape {tuple(o.shape)} != q's "
                         f"{tuple(q.shape)}")
    _check_bwd_rows(q, do, lse=lse,
                    **({"delta": delta} if delta is not None else {}))
    with sites.scope(lambda: (_bwd_site("dq", q, k, v, window,
                                        fused=o is not None),)):
        if not _on_card("flash_attention_bwd_dq", q):
            if o is not None:
                delta = (do.float() * o.float()).sum(dim=-1)
            dq = flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                            causal=causal,
                                            window=window).contiguous()
            return (dq, delta) if o is not None else dq
        dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        outs = {"dq": dq}
        if o is not None:
            outs["delta"] = torch.empty(q.shape[:3], dtype=torch.float32,
                                        device=q.device)
        route = _launch_bwd("dq", q, k, v, do, lse, delta, causal, window,
                            outs, route=route, o=o)
        if route is not None:
            _count(flash_attention_bwd_dq, route)
        return (dq, outs["delta"]) if o is not None else dq


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: Optional[int] = None):
    """Gradients of :func:`flash_attention` (``kv_valid`` not given) from
    its output ``o``, its ``lse`` and the cotangent ``do``: returns
    ``(dq, dk, dv)`` in the dtypes of q, k and v.

    delta = rowsum(dO * O): where dQ takes the tile route (bf16, head dim
    64, 128 or 256, 16-byte rows) the dQ kernel forms it and runs first, and
    the dK/dV kernel reads what it wrote; elsewhere it is one elementwise
    pass in torch, outside the kernels, as ``repro/kernels/ops.py``
    computes it outside the Pallas kernels (counted by
    ``flash_attention_bwd.torch_delta_passes``).  For CPU tensors the
    plain version (``flash_attention_bwd_ref``) runs.  On every device it
    records the dQ and dK/dV sites, the card's pair of kernels."""
    _check_operands(q, k, v, None)
    _check_bwd_rows(q, do, lse=lse)
    if o.shape != q.shape:
        raise ValueError(f"output shape {tuple(o.shape)} != q's "
                         f"{tuple(q.shape)}")
    with sites.scope(lambda: (_bwd_site("dq", q, k, v, window),
                              _bwd_site("dkv", q, k, v, window))):
        if not _on_card("flash_attention_bwd", q):
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                 causal=causal, window=window)
            return tuple(g.to(t.dtype).contiguous()
                         for g, t in ((dq, q), (dk, k), (dv, v)))
        do = do.to(q.dtype)
        if do.stride(-1) != 1:
            do = do.contiguous()
        if (dq_route(q.dtype, q.shape[-1]) == "tile" and o.dtype == q.dtype
                and o.stride(-1) == 1 and _rows_aligned(q, k, v, do, o)):
            dq, delta = flash_attention_bwd_dq(q, k, v, do, lse, o=o,
                                               causal=causal, window=window)
        else:
            delta = (do.float() * o.float()).sum(dim=-1)
            if not sites.is_fake(q):
                flash_attention_bwd.torch_delta_passes += 1
            dq = flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                        causal=causal, window=window)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                         causal=causal, window=window)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


flash_attention_bwd.torch_delta_passes = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.row_launches = 0
flash_attention_bwd_dkv.tile_launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.row_launches = 0
flash_attention_bwd_dq.tile_launches = 0

"""Chunked RWKV6 wkv: the wrappers of the CUDA kernels that replace the TPU
kernels ``repro/kernels/rwkv_wkv.py:rwkv_wkv_pallas`` and
``rwkv_wkv_fwd_pallas`` (one kernel, ``_wkv_call``, with a flag that also
emits the per-chunk entry states) and ``rwkv_wkv_bwd_pallas``.

The kernels (``csrc/rwkv_wkv.cu``) take head dims 16/32/64, any chunk
<= T, ragged T and fp32 or bf16 r/k/v.  Decays are factored per 16-token
sub-tile and the chunks run in parallel: the forward is a state pass and an
output pass, the backward an adjoint pass, a gradient pass and the du sum;
gradients are written in the primal dtypes.

The wrappers take the model layout (B, T, H, K), u (H, K), as
``repro/kernels/ops.py`` does.  On the card the kernels read the operands
through their strides and mask the ragged last chunk themselves, so the
layout change and the padding of ``ops._wkv_flatten`` have no counterpart
there; the per-chunk entry states ``s0`` keep the kernel layout
(B*H, ceil(T / chunk), K, K), an opaque residual handed back to
:func:`rwkv_wkv_bwd`.  For tensors on the CPU each wrapper runs its plain
version, :func:`rwkv_wkv_plain` or :func:`rwkv_wkv_bwd_plain` (the
flattening and padding of ``ops`` around ``kernels/ref.py``), its results
in the kernel's layout (contiguous); for CUDA tensors it launches its
kernels or raises; for a ``FakeTensor`` on any device (a dry run) it
allocates what the launching branch allocates, by the same code, and
launches nothing.  Each wrapper opens a site scope (``kernels/sites.py``)
around its work on every device.  ``rwkv_wkv.launches`` counts calls that
launched the forward (by :func:`rwkv_wkv` and :func:`rwkv_wkv_fwd`; two
kernels a call), ``rwkv_wkv_bwd.launches`` calls of the backward (three
kernels a call).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, sites
from repro_torch.kernels.ref import rwkv_wkv_bwd_ref, rwkv_wkv_chunked_ref

HEAD_DIMS = (16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fns: dict = {}


class _WkvParams(ctypes.Structure):
    """Mirrors ``struct WkvParams`` in csrc/rwkv_wkv.cu."""
    _fields_ = ([(n, ctypes.c_void_p)
                 for n in ("r", "k", "v", "log_w", "u", "dy", "dsT", "s0_in",
                           "y", "sT", "s0", "dr", "dk", "dv", "dlw", "du", "g",
                           "du_part")]
                + [(f"{t}_s{a}", ctypes.c_longlong)
                   for t in ("r", "k", "v", "w", "dy") for a in "bth"]
                + [(n, ctypes.c_int)
                   for n in ("batch", "seq", "heads", "head_dim", "chunk",
                             "scan_split", "dtype")])


def _lib(name: str):
    if name not in _fns:
        fn = getattr(build.load("rwkv_wkv.cu"), name)
        fn.argtypes = [ctypes.POINTER(_WkvParams), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check_operands(r, k, v, log_w, u) -> None:
    if r.ndim != 4:
        raise ValueError(f"wkv operands must be rank-4 (B, T, H, K): got r "
                         f"{tuple(r.shape)}")
    for name, a in (("k", k), ("v", v), ("log_w", log_w)):
        if a.shape != r.shape:
            raise ValueError(f"wkv operand shape mismatch: r "
                             f"{tuple(r.shape)} vs {name} {tuple(a.shape)}")
    if u.shape != r.shape[2:]:
        raise ValueError(f"wkv bonus shape mismatch: u {tuple(u.shape)}, "
                         f"expected (H, K) = {tuple(r.shape[2:])} from r "
                         f"{tuple(r.shape)}")


# ---------------------------------------------------------------------------
# CPU path: the layout change and padding of ops._wkv_flatten, plain versions
# ---------------------------------------------------------------------------


def _flatten(x, ch: int):
    """(B, T, H, K) -> (B*H, Tp, K), zero-padded to a multiple of ch."""
    B, T, H, K = x.shape
    x = x.movedim(2, 1).reshape(B * H, T, K)
    return torch.nn.functional.pad(x, (0, 0, 0, (-T) % ch))


def _unflatten(x, B: int, T: int, H: int):
    K = x.shape[-1]
    return x[:, :T].reshape(B, H, T, K).movedim(1, 2)


def rwkv_wkv_plain(r, k, v, log_w, u, *, chunk: int,
                   emit_chunk_states: bool = False):
    """The plain version of the forward kernel in the model layout, on any
    device: flattened and padded as ``ops._wkv_flatten`` does, then
    ``ref.rwkv_wkv_chunked_ref``.  ``chunk`` <= T.  Returns ``(y, S_T)``
    [+ ``s0`` (B*H, ceil(T / chunk), K, K)], all float32."""
    B, T, H, K = r.shape
    uf = u[None].expand(B, H, K).reshape(B * H, K)
    out = rwkv_wkv_chunked_ref(*(_flatten(a, chunk) for a in (r, k, v, log_w)),
                               uf, chunk=chunk,
                               emit_chunk_states=emit_chunk_states)
    return (_unflatten(out[0], B, T, H), out[1].reshape(B, H, K, K),
            *out[2:])


def rwkv_wkv_bwd_plain(r, k, v, log_w, u, s0, dy, dsT, *, chunk: int):
    """The plain version of the backward kernel in the model layout, on any
    device (``ref.rwkv_wkv_bwd_ref`` around the same flattening; padded
    tokens get dy = 0).  ``chunk`` <= T.  Returns float32 ``(dr, dk, dv,
    dlog_w)`` (B, T, H, K) and ``du`` (B*H, K) per row."""
    B, T, H, K = r.shape
    uf = u[None].expand(B, H, K).reshape(B * H, K)
    dr, dk, dv, dlw, du = rwkv_wkv_bwd_ref(
        *(_flatten(a, chunk) for a in (r, k, v, log_w)), uf,
        _flatten(dy.float(), chunk), s0, dsT.reshape(B * H, K, K),
        chunk=chunk)
    return (*(_unflatten(x, B, T, H) for x in (dr, dk, dv, dlw)), du)


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------


def _strides(t):
    """(batch, time, head) strides of a (B, T, H, K) tensor."""
    return t.stride(0), t.stride(1), t.stride(2)


def _on_card(name: str, r) -> bool:
    """Whether ``r`` takes the kernel path: a CUDA tensor (launches) or a
    fake tensor on any device (allocates only); False for a real CPU
    tensor (the plain version); raises for any other device."""
    if sites.is_fake(r) or r.device.type == "cuda":
        return True
    if r.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {r.device}")


def fwd_site(r, k, v, log_w, u, ch: int):
    """The forward's site entry: the model-level FLOPs; r, k, v, log_w and
    u read once; y, S_T and every chunk's entry state written once."""
    B, T, H, K = r.shape
    states = B * H * (1 + -(-T // ch)) * K * K * 4
    return (("wkv_fwd", sites.wkv_call_flops(B, T, H, K, ch),
             sites.nbytes(r, k, v, log_w, u) + 4 * r.numel() + states),)


def _bwd_site(r, k, v, log_w, u, s0, ch: int):
    """The backward's site entry: twice the forward's FLOPs; the operands,
    s0, dy and dS_T (float32) read once; the gradients written once (dr,
    dk, dv in r's dtype, dlog_w and du float32)."""
    B, T, H, K = r.shape
    return (("wkv_bwd", sites.wkv_call_flops(B, T, H, K, ch, "bwd"),
             2 * sites.nbytes(r, k, v, log_w, u) + sites.nbytes(s0)
             + 4 * (r.numel() + B * H * K * K)),)


def _check_kernel_operands(name: str, r, k, v, log_w, u) -> None:
    """What the CUDA kernels take: r/k/v float32 or bfloat16 of one dtype,
    log_w and u float32, a supported head dim, all on r's device, unit
    innermost strides."""
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"{name}: r/k/v dtypes {r.dtype}, {k.dtype}, "
                         f"{v.dtype}; expected one of {tuple(_DTYPES)}, all "
                         f"equal")
    if log_w.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"{name}: log_w and u must be float32, got "
                         f"{log_w.dtype} and {u.dtype}")
    if r.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {r.shape[-1]} not in {HEAD_DIMS}")
    if any(t.device != r.device for t in (k, v, log_w, u)):
        raise ValueError(f"{name}: operands must share a device")
    if any(t.numel() == 0 or t.stride(-1) != 1 for t in (r, k, v, log_w)):
        raise ValueError(f"{name}: operands must be non-empty with a unit "
                         f"innermost stride")


def _params(r, k, v, log_w, u, ch: int, dy=None, **ptrs):
    """The kernels' parameters for these operands; ``ptrs`` the other
    buffers by field name."""
    B, T, H, K = r.shape
    p = _WkvParams(r=r.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                   log_w=log_w.data_ptr(), u=u.data_ptr(),
                   dy=None if dy is None else dy.data_ptr(),
                   **{n: t.data_ptr() for n, t in ptrs.items()})
    for name, t in (("r", r), ("k", k), ("v", v), ("w", log_w),
                    ("dy", dy if dy is not None else r)):
        for axis, s in zip("bth", _strides(t)):
            setattr(p, f"{name}_s{axis}", s)
    p.batch, p.seq, p.heads, p.head_dim = B, T, H, K
    p.chunk, p.dtype = ch, _DTYPES[r.dtype]
    p.scan_split = _scan_split(r.device, B, H, K)
    return p


def _launch(fn_name: str, p: _WkvParams, device, what: str) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _lib(fn_name)(ctypes.byref(p), stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"(1: a shape the kernel does not take, or more "
                           f"shared memory than a block may have) at "
                           f"(B, T, H, K) = ({p.batch}, {p.seq}, {p.heads}, "
                           f"{p.head_dim}), chunk {p.chunk}")


def _scan_split(device, B: int, H: int, K: int) -> int:
    """Value-column tiles per head of the state and adjoint passes: 1 when
    B*H rows fill the card, else K / 16 tiles of 16 columns, so prefill (40
    rows) runs 160 blocks on 132 SMs."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 1 if B * H >= sms else K // 16


def _rows_on_16_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when every (b, t, h) row starts on 16 bytes (the
    kernels copy rows in 16-byte pieces), else a contiguous copy."""
    size = t.element_size()
    # a fake tensor has no address: its offset into its storage stands in
    # (the caching allocator's blocks start on 512 bytes)
    base = (t.storage_offset() * size if sites.is_fake(t)
            else t.data_ptr())
    if base % 16 == 0 and all(x * size % 16 == 0 for x in _strides(t)):
        return t
    return t.contiguous()


def _kernel_fwd(r, k, v, log_w, u, ch: int):
    """Launches the forward: ``(y, S_T, s0)``, every chunk's entry state
    ``s0`` written because the output pass reads it (fake operands: the
    buffers, unwritten)."""
    _check_kernel_operands("rwkv_wkv", r, k, v, log_w, u)
    B, T, H, K = r.shape
    dev = r.device
    u = u.contiguous()
    nc = -(-T // ch)
    y = torch.empty((B, T, H, K), dtype=torch.float32, device=dev)
    sT = torch.empty((B, H, K, K), dtype=torch.float32, device=dev)
    s0 = torch.empty((B * H, nc, K, K), dtype=torch.float32, device=dev)
    r, k, v, log_w = (_rows_on_16_bytes(t) for t in (r, k, v, log_w))
    if sites.is_fake(r):
        return y, sT, s0
    p = _params(r, k, v, log_w, u, ch, y=y, sT=sT, s0=s0)
    _launch("rwkv_wkv_fwd_launch", p, dev, "rwkv_wkv")
    rwkv_wkv.launches += 1
    return y, sT, s0


# ---------------------------------------------------------------------------
# public wrappers (the signatures of repro/kernels/ops.py)
# ---------------------------------------------------------------------------


def rwkv_wkv(r, k, v, log_w, u, *, chunk: int = 64,
             return_state: bool = False):
    """r/k/v/log_w (B, T, H, K), u (H, K) -> y (B, T, H, K) float32 for any
    T (chunk clamps to T); with ``return_state`` also the final carried
    state S_T (B, H, K, K) float32, that of the T tokens alone."""
    _check_operands(r, k, v, log_w, u)
    ch = min(chunk, r.shape[1])
    with sites.scope(lambda: fwd_site(r, k, v, log_w, u, ch)):
        if not _on_card("rwkv_wkv", r):
            y, sT = (t.contiguous() for t in rwkv_wkv_plain(
                r, k, v, log_w, u, chunk=ch))
        else:
            y, sT, _ = _kernel_fwd(r, k, v, log_w, u, ch)
    return (y, sT) if return_state else y


def rwkv_wkv_fwd(r, k, v, log_w, u, *, chunk: int = 64):
    """The training forward: ``((y, S_T), s0)`` with every chunk's entry
    state ``s0`` (B*H, ceil(T / chunk), K, K) float32, the residual the
    backward replays chunks from."""
    _check_operands(r, k, v, log_w, u)
    ch = min(chunk, r.shape[1])
    with sites.scope(lambda: fwd_site(r, k, v, log_w, u, ch)):
        if not _on_card("rwkv_wkv_fwd", r):
            y, sT, s0 = (t.contiguous() for t in rwkv_wkv_plain(
                r, k, v, log_w, u, chunk=ch, emit_chunk_states=True))
        else:
            y, sT, s0 = _kernel_fwd(r, k, v, log_w, u, ch)
    return (y, sT), s0


def rwkv_wkv_bwd(r, k, v, log_w, u, s0, dy, dsT, *, chunk: int = 64):
    """Gradients of :func:`rwkv_wkv_fwd` from its residual ``s0`` and the
    cotangents ``dy`` (B, T, H, K) and ``dsT`` (B, H, K, K): ``(dr, dk, dv,
    dlog_w, du)`` in the dtypes of r, k, v, log_w and u, ``du`` (H, K)
    summed over the batch (as ``ops.rwkv_wkv_bwd``).  On the card the
    kernels write them in those dtypes and sum ``du`` over batch and chunks
    in a fixed order."""
    _check_operands(r, k, v, log_w, u)
    B, T, H, K = r.shape
    ch = min(chunk, T)
    nc = -(-T // ch)
    if tuple(s0.shape) != (B * H, nc, K, K):
        raise ValueError(f"chunk-state residual shape mismatch: s0 "
                         f"{tuple(s0.shape)}, expected {(B * H, nc, K, K)}")
    if dy.shape != r.shape or tuple(dsT.shape) != (B, H, K, K):
        raise ValueError(f"cotangent shapes dy {tuple(dy.shape)}, dsT "
                         f"{tuple(dsT.shape)}; expected {tuple(r.shape)} and "
                         f"{(B, H, K, K)}")
    with sites.scope(lambda: _bwd_site(r, k, v, log_w, u, s0, ch)):
        if not _on_card("rwkv_wkv_bwd", r):
            dr, dk, dv, dlw, du = rwkv_wkv_bwd_plain(r, k, v, log_w, u, s0,
                                                     dy, dsT, chunk=ch)
            return (*(g.to(t.dtype).contiguous() for g, t in
                      ((dr, r), (dk, k), (dv, v), (dlw, log_w))),
                    du.reshape(B, H, K).sum(0).to(u.dtype))
        return _kernel_bwd(r, k, v, log_w, u, s0, dy, dsT, ch)


def _kernel_bwd(r, k, v, log_w, u, s0, dy, dsT, ch: int):
    """Launches the backward (fake operands: its buffers, unwritten)."""
    B, T, H, K = r.shape
    nc = -(-T // ch)
    _check_kernel_operands("rwkv_wkv_bwd", r, k, v, log_w, u)
    dev = r.device
    # every buffer the kernels read is bound here until they have launched
    dy = dy.float()
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    u_c, s0_c = u.contiguous(), s0.float().contiguous()
    dsT_c = dsT.float().contiguous()
    r, k, v, log_w, dy = (_rows_on_16_bytes(t) for t in (r, k, v, log_w, dy))
    dr, dk, dv = (torch.empty((B, T, H, K), dtype=r.dtype, device=dev)
                  for _ in range(3))
    dlw = torch.empty((B, T, H, K), dtype=torch.float32, device=dev)
    du = torch.empty((H, K), dtype=torch.float32, device=dev)
    g = torch.empty((B * H, nc, K, K), dtype=torch.float32, device=dev)
    du_part = torch.empty((B * H, nc, K), dtype=torch.float32, device=dev)
    if sites.is_fake(r):
        return dr, dk, dv, dlw, du
    p = _params(r, k, v, log_w, u_c, ch, dy=dy, s0_in=s0_c, dsT=dsT_c,
                dr=dr, dk=dk, dv=dv, dlw=dlw, du=du, g=g, du_part=du_part)
    _launch("rwkv_wkv_bwd_launch", p, dev, "rwkv_wkv_bwd")
    rwkv_wkv_bwd.launches += 1
    return dr, dk, dv, dlw, du


rwkv_wkv.launches = 0
rwkv_wkv_bwd.launches = 0

"""Kernel-backend dispatch (counterpart of ``repro/kernels/dispatch.py``):
routes the model's three hot sites — GQA attention (serving and training),
the RWKV6 wkv recurrence (prefill and training) and the Alg. 3 entropy
gate — to the CUDA kernels or to their plain versions.

``ModelConfig.kernels`` in ``{"auto", "ref"}``:

  * ``"auto"`` -> the ``cuda`` backend: the kernel wrappers, which launch
    the CUDA kernels for CUDA tensors and run the plain versions for CPU
    tensors (never a fallback from one to the other);
  * ``"ref"``  -> the ``ref`` backend: the plain versions everywhere, the
    oracle the kernels are held against.

Both backends take the model's layouts — q (B, T, H, hd), k/v
(B, S, Hkv, hd), r/k/v/log_w (B, T, H, K) — and one ``kv_valid``/``tau``
value per row (the decode slots of a ``ServeSession``), and return the
same dtypes.

Training differentiates attention and the wkv.  The ``ref`` backend leaves
that to autograd of the plain versions (the oracle).  The ``cuda`` backend
runs the training sites through :class:`FlashAttentionFn`, the counterpart
of the JAX package's ``_flash_vjp`` (its forward saves the output and the
per-row LSE, its backward runs the dK/dV and dQ kernels), and
:class:`WkvFn`, the counterpart of ``_wkv_vjp`` (its forward saves every
chunk's entry state, its backward runs the adjoint and gradient passes).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import KERNEL_CHOICES
from repro_torch.kernels import ref as kref
from repro_torch.kernels.entropy_exit import entropy_exit
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.rwkv_wkv import (rwkv_wkv, rwkv_wkv_bwd,
                                          rwkv_wkv_fwd)


def resolve_kernels(name: str = "auto") -> str:
    """The backend a ``kernels`` setting selects: ``"cuda"`` for
    ``"auto"``, ``"ref"`` for ``"ref"``."""
    if name not in KERNEL_CHOICES:
        raise ValueError(f"unknown kernels setting {name!r}; expected one of "
                         f"{KERNEL_CHOICES}")
    return "cuda" if name == "auto" else "ref"


def _gate_rows(logits: torch.Tensor, tau):
    """Flatten (..., V) logits to rows and broadcast ``tau`` (a float, or one
    value per leading row b) to one threshold per row."""
    lead = logits.shape[:-1]
    tau = torch.as_tensor(tau, dtype=torch.float32, device=logits.device)
    if tau.ndim == 1:
        tau = tau.reshape(tau.shape[0], *([1] * (len(lead) - 1)))
    return logits.reshape(-1, logits.shape[-1]), tau.expand(lead).reshape(-1)


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention at the training site (kernel layout
    (B, H, T, D)): forward = :func:`flash_attention` with ``return_lse``,
    saving q, k, v, the output and the LSE; backward =
    :func:`flash_attention_bwd` (the dK/dV and dQ kernels on the card)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


class WkvFn(torch.autograd.Function):
    """Differentiable chunked wkv at the training site (model layout):
    forward = :func:`rwkv_wkv_fwd`, saving r, k, v, log_w, u and every
    chunk's entry state; backward = :func:`rwkv_wkv_bwd` (the adjoint and
    gradient passes on the card) from ``dy`` and ``dsT``, which autograd
    hands in as zeros when S_T is unused, as it is in training."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u, chunk: int):
        (y, sT), s0 = rwkv_wkv_fwd(r, k, v, log_w, u, chunk=chunk)
        ctx.save_for_backward(r, k, v, log_w, u, s0)
        ctx.chunk = chunk
        return y, sT

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dsT):
        r, k, v, log_w, u, s0 = ctx.saved_tensors
        return (*rwkv_wkv_bwd(r, k, v, log_w, u, s0, dy, dsT,
                              chunk=ctx.chunk), None)


class KernelBackend:
    """One implementation of the routed hot sites (model layouts)."""

    name = "base"

    def _attention(self, q, k, v, *, causal, window, kv_valid):
        raise NotImplementedError

    def _entropy_exit(self, logits, tau):
        raise NotImplementedError

    def attention(self, q, k, v, *, causal: bool = False,
                  window: Optional[int] = None,
                  kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q (B,T,H,hd), k/v (B,S,Hkv,hd) -> (B,T,H,hd).  ``kv_valid`` (B,)
        int32 masks keys at ``kpos >= kv_valid[b]`` in row b."""
        out = self._attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window,
                              kv_valid=kv_valid)
        return out.transpose(1, 2)

    def wkv(self, r, k, v, log_w, u, *, chunk: int):
        """RWKV6 wkv.  r/k/v/log_w (B, T, H, K), u (H, K) ->
        ``(y (B, T, H, K) float32, S_T (B, H, K, K) float32)``."""
        raise NotImplementedError

    def entropy_gate(self, logits: torch.Tensor, tau):
        """logits (..., V); ``tau`` a float or (B,) per leading row ->
        ``(H (...) float32, exit (...) bool)`` with exit iff H < tau."""
        rows, tau_rows = _gate_rows(logits, tau)
        H, ex = self._entropy_exit(rows, tau_rows)
        lead = logits.shape[:-1]
        return H.reshape(lead), ex.reshape(lead).bool()


class ReferenceBackend(KernelBackend):
    """The plain PyTorch versions, on any device."""

    name = "ref"

    def _attention(self, q, k, v, *, causal, window, kv_valid):
        return kref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        kv_valid=kv_valid)

    def wkv(self, r, k, v, log_w, u, *, chunk: int):
        from repro_torch.models.ssm import _wkv_chunked
        return _wkv_chunked(r, k, v, log_w, u, chunk)

    def _entropy_exit(self, logits, tau):
        return kref.entropy_exit_ref(logits, tau)


class CudaBackend(KernelBackend):
    """The kernel wrappers: CUDA kernels for CUDA tensors, the plain
    versions for CPU tensors.  While autograd records (an operand requires
    grad) attention without ``kv_valid`` goes through
    :class:`FlashAttentionFn` and the wkv through :class:`WkvFn`; the
    decode path never differentiates."""

    name = "cuda"

    def _attention(self, q, k, v, *, causal, window, kv_valid):
        if (kv_valid is None and torch.is_grad_enabled()
                and (q.requires_grad or k.requires_grad or v.requires_grad)):
            return FlashAttentionFn.apply(q, k, v, causal, window)
        return flash_attention(q, k, v, causal=causal, window=window,
                               kv_valid=kv_valid)

    def wkv(self, r, k, v, log_w, u, *, chunk: int):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (r, k, v, log_w, u)):
            return WkvFn.apply(r, k, v, log_w, u, chunk)
        return rwkv_wkv(r, k, v, log_w, u, chunk=chunk, return_state=True)

    def _entropy_exit(self, logits, tau):
        return entropy_exit(logits, tau)


_BACKENDS = {b.name: b for b in (ReferenceBackend(), CudaBackend())}


def get_backend(name: str = "auto") -> KernelBackend:
    return _BACKENDS[resolve_kernels(name)]


def backend_for(cfg) -> KernelBackend:
    """The backend a ``ModelConfig`` selects (``cfg.kernels``)."""
    return get_backend(cfg.kernels)


def wkv_site_flops(cfg, batch: int, seq_len: int,
                   kind: str = "train") -> float:
    """FLOPs of the routed chunked wkv, over every rwkv6 layer (the count
    of ``repro/kernels/dispatch.py:wkv_site_flops``).  One forward
    ("train"/"decode"): per token per head ``4*Q*K`` intra-chunk (scores
    and values over the Q-token chunk) plus ``4*K*K`` inter-chunk/state
    work.  "bwd" is the chunked backward, twice the forward."""
    if cfg.ssm is None or cfg.ssm.kind != "rwkv6":
        return 0.0
    s, K = cfg.ssm, cfg.ssm.head_dim
    H = cfg.d_model // K
    T = 1 if kind == "decode" else seq_len
    Q = min(s.chunk_size, T)
    n_wkv = sum(b == "rwkv6" for b in cfg.block_pattern)
    per_fwd = batch * T * H * K * (4.0 * Q + 4.0 * K) * n_wkv
    return 2.0 * per_fwd if kind == "bwd" else per_fwd


def wkv_causal_flops(batch: int, seq_len: int, heads: int, head_dim: int,
                     chunk: int, kind: str = "fwd") -> float:
    """FLOPs one chunked wkv call needs: only the causal pairs (i <= t,
    the diagonal being the bonus) of each chunk, the last chunk ragged.
    Per chunk of q tokens, p = q (q + 1) / 2 pairs and K = V = head_dim:
    "fwd" 4pK (scores and their values) + 4qK^2 (y from the entry state,
    the state update); "bwd" 10pK (scores again, dS, dv, dr, dk) + 8qK^2
    (dr and dk from the states, dv and the adjoint update from G)."""
    if kind not in ("fwd", "bwd"):
        raise ValueError(f"wkv_causal_flops: kind {kind!r} not fwd/bwd")
    K, Q = head_dim, min(chunk, seq_len)
    a, b = (4, 4) if kind == "fwd" else (10, 8)
    total = 0
    for t0 in range(0, seq_len, Q):
        q = min(Q, seq_len - t0)
        total += a * q * (q + 1) // 2 * K + b * q * K * K
    return float(batch * heads * total)

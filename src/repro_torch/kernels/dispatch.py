"""Kernel-backend dispatch (counterpart of ``repro/kernels/dispatch.py``):
routes the model's two hot sites — GQA attention (serving and training)
and the Alg. 3 entropy gate — to the CUDA kernels or to their plain
versions.

``ModelConfig.kernels`` in ``{"auto", "ref"}``:

  * ``"auto"`` -> the ``cuda`` backend: the kernel wrappers, which launch
    the CUDA kernels for CUDA tensors and run the plain versions for CPU
    tensors (never a fallback from one to the other);
  * ``"ref"``  -> the ``ref`` backend: the plain versions everywhere, the
    oracle the kernels are held against.

Both backends take the model's layouts — q (B, T, H, hd), k/v
(B, S, Hkv, hd) — and one ``kv_valid``/``tau`` value per row (the decode
slots of a ``ServeSession``), and return the same dtypes.

Training differentiates attention.  The ``ref`` backend leaves that to
autograd of the plain version (the oracle).  The ``cuda`` backend runs the
training site through :class:`FlashAttentionFn`, the counterpart of the
JAX package's ``_flash_vjp``: its forward saves the output and the per-row
LSE, its backward runs the dK/dV and dQ kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import KERNEL_CHOICES
from repro_torch.kernels import ref as kref
from repro_torch.kernels.entropy_exit import entropy_exit
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)


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

    def _entropy_exit(self, logits, tau):
        return kref.entropy_exit_ref(logits, tau)


class CudaBackend(KernelBackend):
    """The kernel wrappers: CUDA kernels for CUDA tensors, the plain
    versions for CPU tensors.  While autograd records (an operand requires
    grad) attention without ``kv_valid`` goes through
    :class:`FlashAttentionFn`; the decode path never differentiates."""

    name = "cuda"

    def _attention(self, q, k, v, *, causal, window, kv_valid):
        if (kv_valid is None and torch.is_grad_enabled()
                and (q.requires_grad or k.requires_grad or v.requires_grad)):
            return FlashAttentionFn.apply(q, k, v, causal, window)
        return flash_attention(q, k, v, causal=causal, window=window,
                               kv_valid=kv_valid)

    def _entropy_exit(self, logits, tau):
        return entropy_exit(logits, tau)


_BACKENDS = {b.name: b for b in (ReferenceBackend(), CudaBackend())}


def get_backend(name: str = "auto") -> KernelBackend:
    return _BACKENDS[resolve_kernels(name)]


def backend_for(cfg) -> KernelBackend:
    """The backend a ``ModelConfig`` selects (``cfg.kernels``)."""
    return get_backend(cfg.kernels)

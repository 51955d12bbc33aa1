"""Plain PyTorch versions of the kernels (counterpart of ``repro/kernels/
ref.py``): the CPU path of every kernel wrapper, the ``kernels="ref"``
backend, and the function each CUDA kernel is held against on the card.

Where the JAX oracles take one scalar ``kv_valid``/``tau`` (JAX vmaps a
B=1 serve step over the decode slots), these take one value per row."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        kv_valid: Optional[torch.Tensor] = None,
                        return_lse: bool = False):
    """q: (B,H,Tq,D), k/v: (B,Hkv,Tk,D) -> (B,H,Tq,D) in q's dtype, fp32
    softmax.  GQA head h reads kv head ``h // (H // Hkv)``.  ``kv_valid``
    (B,) integers masks keys at ``kpos >= kv_valid[b]`` in row b — the
    decode ring's valid prefix.  With ``return_lse`` also returns the
    per-row logsumexp of the scaled scores, (B,H,Tq) fp32."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, Tq, D).float()
    s = torch.einsum("bhgtd,bhsd->bhgts", qg, k.float()) / math.sqrt(D)
    qpos = torch.arange(Tq, device=q.device)[:, None]
    kpos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((1, Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    if kv_valid is not None:
        mask = mask & (kpos[None] < kv_valid.reshape(-1, 1, 1))
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgts,bhsd->bhgtd", p, v.float())
    out = out.reshape(B, H, Tq, D).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(B, H, Tq)
    return out


def _pair_mask(Tq: int, Tk: int, causal: bool, window: Optional[int],
               device) -> torch.Tensor:
    """(Tq, Tk) bool: the training forward's mask (causal diagonal,
    sliding window)."""
    qpos = torch.arange(Tq, device=device)[:, None]
    kpos = torch.arange(Tk, device=device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def _rebuild_p_ds(q, k, v, do, lse, delta, causal, window):
    """P = exp(S * scale - LSE), exactly 0 where the forward masked, and
    dS = P * (dP - delta) * scale with dP = dO V^T, in fp32, grouped as
    (B, Hkv, G, Tq, Tk).  Returns (q, dO) grouped as (B, Hkv, G, Tq, D),
    P and dS."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, Hkv, g, Tq, D)
    dog = do.float().reshape(B, Hkv, g, Tq, D)
    s = torch.einsum("bhgtd,bhsd->bhgts", qg, k.float()) * scale
    mask = _pair_mask(Tq, Tk, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse.float().reshape(
        B, Hkv, g, Tq, 1)), 0.0)
    dp = torch.einsum("bhgtd,bhsd->bhgts", dog, v.float())
    ds = p * (dp - delta.float().reshape(B, Hkv, g, Tq, 1)) * scale
    return qg, dog, p, ds


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, *,
                                causal: bool = True,
                                window: Optional[int] = None):
    """Plain version of the dK/dV kernel: ``lse``/``delta`` (B, H, Tq)
    -> (dk, dv) (B, Hkv, Tk, D) fp32, the GQA group summed."""
    qg, dog, p, ds = _rebuild_p_ds(q, k, v, do, lse, delta, causal, window)
    dv = torch.einsum("bhgts,bhgtd->bhsd", p, dog)
    dk = torch.einsum("bhgts,bhgtd->bhsd", ds, qg)
    return dk, dv


def flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, *,
                               causal: bool = True,
                               window: Optional[int] = None):
    """Plain version of the dQ kernel -> dq (B, H, Tq, D) fp32."""
    _, _, _, ds = _rebuild_p_ds(q, k, v, do, lse, delta, causal, window)
    dq = torch.einsum("bhgts,bhsd->bhgtd", ds, k.float())
    return dq.reshape(q.shape)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: Optional[int] = None):
    """Plain version of the two backward kernels together: the gradients
    of ``flash_attention_ref(q, k, v, causal=, window=)`` from its output
    ``o``, its per-row ``lse`` and the cotangent ``do``, with
    delta = rowsum(dO * O).  Returns fp32 ``(dq, dk, dv)``."""
    delta = (do.float() * o.float()).sum(dim=-1)
    dk, dv = flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                         causal=causal, window=window)
    dq = flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal=causal,
                                    window=window)
    return dq, dk, dv


def entropy_exit_ref(logits, tau):
    """(B, V) logits, ``tau`` a float or (B,) per-row thresholds ->
    ``(entropy (B,) fp32, exit (B,) int32)`` with exit iff H < tau."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    H = -(logp.exp() * logp).sum(dim=-1)
    tau = torch.as_tensor(tau, dtype=torch.float32, device=H.device)
    return H, (H < tau).to(torch.int32)

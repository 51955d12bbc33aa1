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


def entropy_exit_ref(logits, tau):
    """(B, V) logits, ``tau`` a float or (B,) per-row thresholds ->
    ``(entropy (B,) fp32, exit (B,) int32)`` with exit iff H < tau."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    H = -(logp.exp() * logp).sum(dim=-1)
    tau = torch.as_tensor(tau, dtype=torch.float32, device=H.device)
    return H, (H < tau).to(torch.int32)

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

Under a ``FakeTensor`` (a dry run, ``launch/dryrun.py``) the ``cuda``
backend takes the card's route on any device: the Functions record the
card's saved tensors (O and the LSE, every chunk's entry state) and the
wrappers allocate their outputs without launching.  The wrappers open
the site scopes of ``kernels/sites.py``; the ``ref`` backend opens the
forward sites around its plain versions (their backward is autograd of
the plain forward: aten ops outside any site).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import KERNEL_CHOICES
from repro_torch.kernels import entropy_exit as _gate_mod
from repro_torch.kernels import flash_attention as _attn_mod
from repro_torch.kernels import ref as kref
from repro_torch.kernels import rwkv_wkv as _wkv_mod
from repro_torch.kernels import sites
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


def _lanes_first(x, d, n: int):
    """``x`` with its lane dim ``d`` moved to the front (a view), or
    broadcast to ``n`` lanes where it has none (``d`` None)."""
    return x.movedim(d, 0) if d is not None else x.expand(n, *x.shape)


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention at the training site (kernel layout
    (B, H, T, D)): forward = :func:`flash_attention` with ``return_lse``,
    saving q, k, v, the output and the LSE; backward =
    :func:`flash_attention_bwd` (the dK/dV and dQ kernels on the card).
    ``apply`` returns ``(out, lse)``; the LSE is not differentiable.

    Under ``torch.func.vmap`` (the fused engine's client lanes) the rule
    :meth:`vmap` folds the lanes into the batch, (k, B, H, T, D) ->
    (k*B, H, T, D), and applies the Function once on the folded plain
    tensors: autograd records one forward and one backward launch for all
    lanes, and the kernels never see a batched tensor.  The fold is a view
    when the lane and batch strides nest (as the model's projections lay
    them out), else a copy."""

    @staticmethod
    def forward(q, k, v, causal: bool, window: Optional[int]):
        return flash_attention(q, k, v, causal=causal, window=window,
                               return_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        ctx.mark_non_differentiable(lse)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window):
        n = info.batch_size
        q, k, v = (_lanes_first(t, d, n) for t, d in zip((q, k, v), in_dims))
        fold = lambda t: t.reshape(n * t.shape[1], *t.shape[2:])  # noqa: E731
        out, lse = FlashAttentionFn.apply(fold(q), fold(k), fold(v), causal,
                                          window)
        return ((out.view(n, -1, *out.shape[1:]),
                 lse.view(n, -1, *lse.shape[1:])), (0, 0))


class WkvFn(torch.autograd.Function):
    """Differentiable chunked wkv at the training site (model layout):
    forward = :func:`rwkv_wkv_fwd`, saving r, k, v, log_w, u and every
    chunk's entry state; backward = :func:`rwkv_wkv_bwd` (the adjoint and
    gradient passes on the card) from ``dy`` and ``dsT`` (zeros for the one
    autograd leaves undefined: S_T is unused in training).  ``apply``
    returns ``(y, S_T, s0)``; the entry states ``s0`` are not
    differentiable.

    Under ``torch.func.vmap`` the rule :meth:`vmap` folds the lanes into
    the *heads*, (k, B, T, H, K) -> (B, T, k*H, K) and u (k, H, K) ->
    (k*H, K): each lane has its own bonus u and the kernel takes one u for
    the whole batch, so lanes cannot go into the batch.  The kernel then
    sums du over the batch per (lane, head), which is each lane's own
    gradient.  Folding r/k/v/log_w is a copy (lane and head dims are not
    adjacent in memory); y and S_T unfold as views."""

    @staticmethod
    def forward(r, k, v, log_w, u, chunk: int):
        (y, sT), s0 = rwkv_wkv_fwd(r, k, v, log_w, u, chunk=chunk)
        return y, sT, s0

    @staticmethod
    def setup_context(ctx, inputs, output):
        r, k, v, log_w, u, chunk = inputs
        ctx.save_for_backward(r, k, v, log_w, u, output[2])
        ctx.chunk = chunk
        ctx.mark_non_differentiable(output[2])
        ctx.set_materialize_grads(False)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dsT, _ds0):
        r, k, v, log_w, u, s0 = ctx.saved_tensors
        B, T, H, K = r.shape
        if dy is None:
            dy = torch.zeros((B, T, H, K), dtype=torch.float32,
                             device=r.device)
        if dsT is None:
            dsT = torch.zeros((B, H, K, K), dtype=torch.float32,
                              device=r.device)
        return (*rwkv_wkv_bwd(r, k, v, log_w, u, s0, dy, dsT,
                              chunk=ctx.chunk), None)

    @staticmethod
    def vmap(info, in_dims, r, k, v, log_w, u, chunk):
        n = info.batch_size
        r, k, v, log_w, u = (_lanes_first(t, d, n) for t, d in
                             zip((r, k, v, log_w, u), in_dims))
        _, B, T, H, K = r.shape

        def fold(t):                     # (n, B, T, H, K) -> (B, T, n*H, K)
            return t.movedim(0, 2).reshape(B, T, n * H, K)

        y, sT, s0 = WkvFn.apply(fold(r), fold(k), fold(v), fold(log_w),
                                u.reshape(n * H, K), chunk)
        return ((y.view(B, T, n, H, K), sT.view(B, n, H, K, K),
                 s0.view(B, n, H, *s0.shape[1:])), (2, 1, 1))


class KernelBackend:
    """One implementation of the routed hot sites (model layouts)."""

    name = "base"

    def _attention(self, q, k, v, *, causal, window, kv_valid):
        raise NotImplementedError

    def _entropy_exit(self, logits, tau):
        raise NotImplementedError

    def _attention_lse(self, q, k, v, *, kv_valid):
        raise NotImplementedError

    def attention_lse(self, q, k, v, *, kv_valid: torch.Tensor):
        """Non-causal attention over a part of a decode ring, with its LSE:
        q (B,T,H,hd), k/v (B,S,Hkv,hd), ``kv_valid`` (B,) int32 (0 where a
        row has no key in the part) -> ``(out (B,T,H,hd), lse (B,H,T)
        float32)``, what the parts' combine reads."""
        out, lse = self._attention_lse(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), kv_valid=kv_valid)
        return out.transpose(1, 2), lse

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
    """The plain PyTorch versions, on any device, each in its forward site
    scope (the sites the wrappers record)."""

    name = "ref"

    def _attention(self, q, k, v, *, causal, window, kv_valid):
        with sites.scope(lambda: _attn_mod.fwd_site(q, k, v, window, False,
                                                    kv_valid)):
            return kref.flash_attention_ref(q, k, v, causal=causal,
                                            window=window, kv_valid=kv_valid)

    def _attention_lse(self, q, k, v, *, kv_valid):
        with sites.scope(lambda: _attn_mod.fwd_site(q, k, v, None, True,
                                                    kv_valid)):
            return kref.flash_attention_ref(q, k, v, causal=False,
                                            kv_valid=kv_valid,
                                            return_lse=True)

    def wkv(self, r, k, v, log_w, u, *, chunk: int):
        from repro_torch.models.ssm import _wkv_chunked
        ch = min(chunk, r.shape[1])
        with sites.scope(lambda: _wkv_mod.fwd_site(r, k, v, log_w, u, ch)):
            return _wkv_chunked(r, k, v, log_w, u, chunk)

    def _entropy_exit(self, logits, tau):
        with sites.scope(lambda: _gate_mod.gate_site(logits)):
            return kref.entropy_exit_ref(logits, tau)


def _via_function(*operands) -> bool:
    """Whether a training site goes through its autograd Function: an
    operand batched by ``torch.func.vmap`` (the kernel wrappers take plain
    tensors only, and a batched tensor reports ``requires_grad`` False
    whatever it wraps), or grad mode on and an operand requiring grad."""
    if any(torch._C._functorch.is_batchedtensor(t) for t in operands):
        return True
    return torch.is_grad_enabled() and any(t.requires_grad for t in operands)


class CudaBackend(KernelBackend):
    """The kernel wrappers: CUDA kernels for CUDA tensors, the plain
    versions for CPU tensors.  While autograd records (an operand requires
    grad, or is batched by ``torch.func.vmap``) attention without
    ``kv_valid`` goes through :class:`FlashAttentionFn` and the wkv through
    :class:`WkvFn`; the decode path never differentiates."""

    name = "cuda"

    def _attention(self, q, k, v, *, causal, window, kv_valid):
        if kv_valid is None and _via_function(q, k, v):
            return FlashAttentionFn.apply(q, k, v, causal, window)[0]
        return flash_attention(q, k, v, causal=causal, window=window,
                               kv_valid=kv_valid)

    def _attention_lse(self, q, k, v, *, kv_valid):
        return flash_attention(q, k, v, causal=False, kv_valid=kv_valid,
                               return_lse=True)

    def wkv(self, r, k, v, log_w, u, *, chunk: int):
        if _via_function(r, k, v, log_w, u):
            return WkvFn.apply(r, k, v, log_w, u, chunk)[:2]
        return rwkv_wkv(r, k, v, log_w, u, chunk=chunk, return_state=True)

    def _entropy_exit(self, logits, tau):
        return entropy_exit(logits, tau)


_BACKENDS = {b.name: b for b in (ReferenceBackend(), CudaBackend())}


def get_backend(name: str = "auto") -> KernelBackend:
    return _BACKENDS[resolve_kernels(name)]


def backend_for(cfg) -> KernelBackend:
    """The backend a ``ModelConfig`` selects (``cfg.kernels``)."""
    return get_backend(cfg.kernels)


# ---------------------------------------------------------------------------
# model-level FLOP counts of the routed sites
# ---------------------------------------------------------------------------
#
# These are the counts the JAX package's roofline uses
# (``repro/kernels/dispatch.py``): attention over the full Tq x Tk
# rectangle and the wkv over whole chunks, whatever the mask.  They stay
# the same whatever implements a site (a Pallas kernel, a CUDA kernel, a
# plain version), so a share of the step (an MFU) built on them compares
# implementations.  PERF.md section 6's bounds count instead the causal
# band and causal chunk pairs (``wkv_causal_flops``): the work a causal
# kernel does, about half of these on causal shapes (T (T + 1) / 2 pairs
# of the T^2), which bounds a kernel's time.  Each count answers its own
# question, so both exist.


def attention_site_flops(cfg, batch: int, seq_len: int,
                         kind: str = "train") -> float:
    """FLOPs of the routed attention matmuls over every attention layer
    (``"attn"`` and ``"shared_attn"``; the count of
    ``repro/kernels/dispatch.py:attention_site_flops``).  ``kind``
    "train"/"prefill" is one forward, ``2 * 2 * B * H * Tq * Tk_eff * hd``
    per layer (Tk_eff the window where one caps it); "decode" the same at
    Tq = 1 against a ``seq_len``-deep cache; "bwd" the fused backward,
    3.5 x forward, whose per-kernel shares are "bwd_dkv" (2.0 x: S, dP,
    dV, dK) and "bwd_dq" (1.5 x: S, dP, dQ)."""
    Tq = 1 if kind == "decode" else seq_len
    kernels = {"bwd": ("dkv", "dq"), "bwd_dkv": ("dkv",),
               "bwd_dq": ("dq",)}.get(kind, ("fwd",))
    per_layer = sum(sites.attention_call_flops(
        batch, cfg.num_heads, Tq, seq_len, cfg.head_dim, cfg.sliding_window,
        k) for k in kernels)
    n_attn = sum(b in ("attn", "shared_attn") for b in cfg.block_pattern)
    return per_layer * n_attn


def wkv_site_flops(cfg, batch: int, seq_len: int,
                   kind: str = "train", ranks: int = 1) -> float:
    """FLOPs of the routed chunked wkv, over every rwkv6 layer (the count
    of ``repro/kernels/dispatch.py:wkv_site_flops``).  One forward
    ("train"/"decode"): per token per head ``4*Q*K`` intra-chunk (scores
    and values over the Q-token chunk) plus ``4*K*K`` inter-chunk/state
    work.  "bwd" is the chunked backward, twice the forward (one kernel
    call: its share is all of it).  ``ranks``: one rank's share over a
    ``"model"`` group of that size, whose wkv runs on the rank's H /
    ranks heads where they divide (``models/ssm.rwkv6_forward``), else
    on every head."""
    if cfg.ssm is None or cfg.ssm.kind != "rwkv6":
        return 0.0
    K = cfg.ssm.head_dim
    H = cfg.d_model // K
    T = 1 if kind == "decode" else seq_len
    n_wkv = sum(b == "rwkv6" for b in cfg.block_pattern)
    return n_wkv * sites.wkv_call_flops(
        batch, T, H // ranks if H % ranks == 0 else H, K,
        cfg.ssm.chunk_size, "bwd" if kind == "bwd" else "fwd")


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

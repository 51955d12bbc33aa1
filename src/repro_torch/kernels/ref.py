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


def gate_slice_bounds(vocab: int, splits: int):
    """The slices of a row that ``csrc/entropy_exit.cu`` gives the
    ``splits`` blocks of its cluster: slice r is [r * per, (r + 1) * per)
    clipped to ``vocab``, per = ceil(vocab / splits) rounded up to 8
    elements, so trailing slices may be empty."""
    per = -(-(-(-vocab // splits)) // 8) * 8
    return [(min(vocab, r * per), min(vocab, (r + 1) * per))
            for r in range(splits)]


def gate_slice_triples(logits, splits: int):
    """Each slice's ``(m, S, U)``, each (B,) fp32: m its max, S = sum
    e^{x-m}, U = sum e^{x-m} x.  A -inf element adds 0 to S and 0 * -inf
    = NaN to U, as in the kernel; an empty slice is the empty triple
    (m = -inf, S = U = 0)."""
    x = logits.float()
    B, V = x.shape
    triples = []
    for lo, hi in gate_slice_bounds(V, splits):
        if hi == lo:
            m = torch.full((B,), -torch.inf, device=x.device)
            triples.append((m, torch.zeros_like(m), torch.zeros_like(m)))
            continue
        xs = x[:, lo:hi]
        m = xs.max(dim=-1).values
        e = torch.exp(xs - torch.where(m == -torch.inf, 0.0, m)[:, None])
        u = (e * xs).sum(dim=-1)
        triples.append((m, e.sum(dim=-1), u))
    return triples


def gate_merge(triples):
    """The kernel's merge of the slices' triples: the row's max M, then
    each slice's S and U rescaled by e^{m - M} (0 for a slice with m =
    -inf, whose NaN U stays NaN) and summed in rank order.  Returns
    ``(M, S, U)``."""
    M = torch.stack([m for m, _, _ in triples]).max(dim=0).values
    S = torch.zeros_like(M)
    U = torch.zeros_like(M)
    for m, s, u in triples:
        w = torch.where(m == -torch.inf, 0.0, torch.exp(m - M))
        S = S + w * s
        U = U + w * u
    return M, S, U


def entropy_exit_split_ref(logits, tau, splits: int):
    """Plain mirror of the kernel's algorithm: per-slice triples at its
    slice bounds (:func:`gate_slice_bounds`), merged as it merges them
    (:func:`gate_merge`), finished as it finishes, H = M + log S - U / S
    with S clamped >= 1e-30.  Same outputs as :func:`entropy_exit_ref`,
    NaN where a row holds a -inf logit; no path runs it (the tests hold it
    against the JAX package)."""
    M, S, U = gate_merge(gate_slice_triples(logits, splits))
    S = S.clamp(min=1e-30)
    H = M + torch.log(S) - U / S
    tau = torch.as_tensor(tau, dtype=torch.float32, device=H.device)
    return H, (H < tau).to(torch.int32)


# ---------------------------------------------------------------------------
# RWKV6 wkv
# ---------------------------------------------------------------------------


def rwkv_wkv_ref_state(r, k, v, log_w, u):
    """Token-by-token recurrence (the oracle).  r/k/v/log_w (BH, T, K), u
    (BH, K) -> ``(y (BH, T, K) fp32, S_T (BH, K, K) fp32)``."""
    BH, T, K = r.shape
    rf, kf, vf = (a.float() for a in (r, k, v))
    wf = log_w.float().exp()
    uf = u.float()
    S = torch.zeros((BH, K, K), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(T):
        kv = kf[:, t, :, None] * vf[:, t, None, :]
        ys.append(torch.einsum("bk,bkv->bv", rf[:, t],
                               S + uf[..., None] * kv))
        S = S * wf[:, t, :, None] + kv
    return torch.stack(ys, dim=1), S


def rwkv_wkv_ref_model(r, k, v, log_w, u):
    """Model-layout oracle: r/k/v/log_w (B, T, H, K), u (H, K) ->
    ``(y (B, T, H, K) fp32, S_T (B, H, K, K) fp32)``."""
    B, T, H, K = r.shape

    def flat(x):
        return x.movedim(2, 1).reshape(B * H, T, K)

    uf = u[None].expand(B, H, K).reshape(B * H, K)
    y, ST = rwkv_wkv_ref_state(flat(r), flat(k), flat(v), flat(log_w), uf)
    return y.reshape(B, H, T, K).movedim(1, 2), ST.reshape(B, H, K, K)


def _chunk_decays(lw):
    """Cumulative log-decay L (.., Q, K) of a chunk and its exclusive
    version L_prev = L - lw."""
    L = torch.cumsum(lw, dim=-2)
    return L, L - lw


def _chunk_fwd(r, k, v, lw, u, S):
    """One chunk of the recurrence for every row at once, in fp32: inputs
    (BH, Q, K), u (BH, 1, K), the carried state S (BH, K, K) -> (y, S')."""
    Q = r.shape[1]
    L, L_prev = _chunk_decays(lw)
    rw = r * L_prev.exp()
    kw = k * (-L).exp()
    lower = torch.ones((Q, Q), dtype=torch.bool, device=r.device).tril(-1)
    scores = torch.where(lower, rw @ kw.transpose(1, 2), 0.0)
    y = scores @ v + (r * u * k).sum(-1, keepdim=True) * v + rw @ S
    tail = (L[:, -1:] - L).exp()
    s_new = L[:, -1, :, None].exp() * S + (k * tail).transpose(1, 2) @ v
    return y, s_new


def _check_wkv_kernel_layout(r, k, v, log_w, u, chunk: int) -> None:
    BH, T, K = r.shape
    for name, a in (("k", k), ("v", v), ("log_w", log_w)):
        if a.shape != r.shape:
            raise ValueError(f"wkv operand shape mismatch: r "
                             f"{tuple(r.shape)} vs {name} {tuple(a.shape)}")
    if tuple(u.shape) != (BH, K):
        raise ValueError(f"wkv bonus shape mismatch: u {tuple(u.shape)}, "
                         f"expected (BH, K) = {(BH, K)}")
    if T % chunk != 0:
        raise ValueError(f"unpadded sequence length: T={T} must be a "
                         f"multiple of chunk={chunk}")


def rwkv_wkv_chunked_ref(r, k, v, log_w, u, *, chunk: int,
                         emit_chunk_states: bool = False):
    """Plain version of the chunked forward kernel, in its layout:
    r/k/v/log_w (BH, T, K) with T a multiple of ``chunk``, u (BH, K) ->
    ``(y (BH, T, K), S_T (BH, K, K))``, plus every chunk's entry state
    ``S0 (BH, T / chunk, K, K)`` with ``emit_chunk_states``; all fp32.
    Follows the TPU kernel's chunk algebra (``k e^{-L}``, ``r e^{L_prev}``)."""
    _check_wkv_kernel_layout(r, k, v, log_w, u, chunk)
    BH, T, K = r.shape
    uf = u.float()[:, None]
    S = torch.zeros((BH, K, K), dtype=torch.float32, device=r.device)
    ys, states = [], []
    for c0 in range(0, T, chunk):
        sl = slice(c0, c0 + chunk)
        states.append(S)
        y, S = _chunk_fwd(r[:, sl].float(), k[:, sl].float(),
                          v[:, sl].float(), log_w[:, sl].float(), uf, S)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    if emit_chunk_states:
        return y, S, torch.stack(states, dim=1)
    return y, S


def rwkv_wkv_bwd_ref(r, k, v, log_w, u, dy, s0, dsT, *, chunk: int):
    """Plain version of the chunked backward kernel, in its layout: the
    forward's operands (BH, T, K) and u (BH, K), the cotangent ``dy``
    (BH, T, K), the entry states ``s0`` (BH, T / chunk, K, K) and the
    cotangent ``dsT`` (BH, K, K) of the final state -> fp32 ``(dr, dk, dv,
    dlog_w, du)``, ``du`` (BH, K) summed over the sequence.  Walks the
    chunks last to first with the state adjoint G, as ``_wkv_bwd_kernel``
    does."""
    _check_wkv_kernel_layout(r, k, v, log_w, u, chunk)
    BH, T, K = r.shape
    nc = T // chunk
    if tuple(s0.shape) != (BH, nc, K, K):
        raise ValueError(f"chunk-state residual shape mismatch: s0 "
                         f"{tuple(s0.shape)}, expected {(BH, nc, K, K)}")
    uf = u.float()[:, None]
    lower = torch.ones((chunk, chunk), dtype=torch.bool,
                       device=r.device).tril(-1)
    G = dsT.float()
    du = torch.zeros((BH, K), dtype=torch.float32, device=r.device)
    outs = [[None] * nc for _ in range(4)]
    for c in reversed(range(nc)):
        sl = slice(c * chunk, (c + 1) * chunk)
        rc, kc, vc, lw, dyc = (a[:, sl].float()
                               for a in (r, k, v, log_w, dy))
        S0 = s0[:, c].float()
        L, L_prev = _chunk_decays(lw)
        eLp, eLn = L_prev.exp(), (-L).exp()
        rw, kw = rc * eLp, kc * eLn
        eLQ = L[:, -1].exp()                                  # (BH, K)
        tail = (L[:, -1:] - L).exp()

        # state path: S' = diag(eLQ) S0 + (k * tail)^T v
        d_kt = vc @ G.transpose(1, 2)
        dk_state = tail * d_kt
        d_tail = kc * d_kt
        dv_state = (kc * tail) @ G

        # output path: y = scores v + (r.u.k) v + rw S0
        scores = torch.where(lower, rw @ kw.transpose(1, 2), 0.0)
        d_scores = torch.where(lower, dyc @ vc.transpose(1, 2), 0.0)
        dv_intra = scores.transpose(1, 2) @ dyc
        d_rw = d_scores @ kw + dyc @ S0.transpose(1, 2)
        d_kw = d_scores.transpose(1, 2) @ rw
        db = (dyc * vc).sum(-1, keepdim=True)
        b = (rc * uf * kc).sum(-1, keepdim=True)

        dr = d_rw * eLp + uf * kc * db
        dk = d_kw * eLn + dk_state + uf * rc * db
        dv = dv_intra + b * dyc + dv_state
        du = du + (rc * kc * db).sum(1)

        # log-decay path: L = cumsum(lw); L_Q = L[-1] feeds eLQ and tail
        dLQ = eLQ * (G * S0).sum(-1) + (d_tail * tail).sum(1)
        dL = -d_kw * kw - d_tail * tail
        dL_prev = d_rw * rw
        A = dL + dL_prev
        A[:, -1] += dLQ
        revcum = A.sum(1, keepdim=True) - A.cumsum(1) + A
        dlw = revcum - dL_prev
        for i, x in enumerate((dr, dk, dv, dlw)):
            outs[i][c] = x
        # adjoint of the chunk's entry state = the previous chunk's exit
        G = eLQ[..., None] * G + rw.transpose(1, 2) @ dyc
    dr, dk, dv, dlw = (torch.cat(o, dim=1) for o in outs)
    return dr, dk, dv, dlw, du


# ---------------------------------------------------------------------------
# RWKV6 wkv, the kernels' factored algebra (tests only)
#
# Plain mirrors of csrc/rwkv_wkv.cu, in the kernel layout
# (BH, T, K) with any T (no padding).  Every chunk is cut into sub-tiles of
# ``tile`` tokens that start at the chunk's start; Λ is the tile-local
# inclusive cumsum of the log-decays (Λ_{-1} = 0, Λ_e its last row).  With
# the state S before a tile and the adjoint G of the state after it:
#   y_t   = (r_t e^{Λ_{t-1}}) S + sum_{i<t} A[t, i] v_i + b_t v_t
#   A[t, i] = sum_k r_tk k_ik e^{Λ_{t-1,k} - Λ_ik}      (pairwise, i < t)
#   S'    = e^{Λ_e} S + (k e^{Λ_e - Λ})^T v
#   G_in  = e^{Λ_e} G + (r e^{Λ_{t-1}})^T dy
# Every exponent is <= 0.  The passes:
#   state pass     S at every chunk start (s0) and S_T, tiles in order;
#   adjoint pass   G at every chunk end from dS_T, tiles in reverse;
#   output pass    every chunk from its s0 (tiles in order);
#   gradient pass  every chunk from its s0 and G: dr and dlog_w's
#                  r * dr_core in order, then dk, dv and dlog_w in reverse,
#                  dlog_w_t = rowsum(G * S_exit) + sum_{i>t} r_i dr_core_i
#                             - sum_{i>=t} k_i dk_i' (dk' without the bonus).
# ---------------------------------------------------------------------------

WKV_TILE = 16


def wkv_tiles(T: int, chunk: int, tile: int = WKV_TILE):
    """``[(chunk index, [(start, end) of each tile])]``: each chunk of
    ``chunk`` tokens (the last may be short) cut into tiles of ``tile``
    tokens from its start (the last may be short)."""
    return [(c, [(s, min(s + tile, c0 + chunk, T))
                 for s in range(c0, min(c0 + chunk, T), tile)])
            for c, c0 in enumerate(range(0, T, chunk))]


def wkv_tile_decays(lw):
    """One tile's decays from its log-decays (BH, n, K): ``(qf, kf, dec,
    W)`` = e^{Λ_{t-1}} (the query factor), e^{Λ_e - Λ_i} (the key factor),
    e^{Λ_e} (the tile's decay, (BH, K)) and the pairwise
    W[t, i] = e^{Λ_{t-1} - Λ_i} for i < t, 0 elsewhere (BH, n, n, K)."""
    lam = torch.cumsum(lw, dim=1)
    lam_prev = lam - lw
    n = lw.shape[1]
    lower = torch.ones((n, n), dtype=torch.bool, device=lw.device).tril(-1)
    expo = lam_prev[:, :, None, :] - lam[:, None, :, :]
    W = torch.where(lower[None, :, :, None],
                    torch.where(lower[None, :, :, None], expo, 0.0).exp(), 0.0)
    return lam_prev.exp(), (lam[:, -1:] - lam).exp(), lam[:, -1].exp(), W


def _wkv_pair_scores(r, k, u, W):
    """A[t, i] over a tile, pairwise below the diagonal, b_t on it."""
    A = torch.einsum("btk,bik,btik->bti", r, k, W)
    return A + torch.diag_embed((r * u * k).sum(-1))


def wkv_state_scan_ref(k, v, log_w, *, chunk: int, tile: int = WKV_TILE):
    """The forward's state pass: ``(s0 (BH, nc, K, K), S_T (BH, K, K))``,
    the state before every chunk and after the last token."""
    BH, T, K = k.shape
    S = torch.zeros((BH, K, K), dtype=torch.float32, device=k.device)
    s0 = []
    for _, tiles in wkv_tiles(T, chunk, tile):
        s0.append(S)
        for s, e in tiles:
            _, kf, dec, _ = wkv_tile_decays(log_w[:, s:e].float())
            S = dec[..., None] * S + (k[:, s:e].float() * kf).transpose(
                1, 2) @ v[:, s:e].float()
    return torch.stack(s0, dim=1), S


def wkv_adjoint_scan_ref(r, log_w, dy, dsT, *, chunk: int,
                         tile: int = WKV_TILE):
    """The backward's adjoint pass: G (BH, nc, K, K), the adjoint of the
    state after every chunk, from ``dsT`` back through the tiles."""
    BH, T, K = r.shape
    G = dsT.float()
    out = []
    for _, tiles in reversed(wkv_tiles(T, chunk, tile)):
        out.append(G)
        for s, e in reversed(tiles):
            qf, _, dec, _ = wkv_tile_decays(log_w[:, s:e].float())
            G = dec[..., None] * G + (r[:, s:e].float() * qf).transpose(
                1, 2) @ dy[:, s:e].float()
    return torch.stack(out[::-1], dim=1)


def rwkv_wkv_factored_ref(r, k, v, log_w, u, *, chunk: int,
                          tile: int = WKV_TILE,
                          emit_chunk_states: bool = False):
    """The factored forward (state pass, then the output pass of every
    chunk from its entry state): r/k/v/log_w (BH, T, K), u (BH, K) ->
    ``(y, S_T)`` [+ ``s0``], all float32, as ``rwkv_wkv_chunked_ref``."""
    BH, T, K = r.shape
    r, k, v, lw = (a.float() for a in (r, k, v, log_w))
    uf = u.float()[:, None]
    s0, sT = wkv_state_scan_ref(k, v, lw, chunk=chunk, tile=tile)
    y = torch.empty((BH, T, K), dtype=torch.float32, device=r.device)
    for c, tiles in wkv_tiles(T, chunk, tile):
        S = s0[:, c]
        for s, e in tiles:
            qf, kf, dec, W = wkv_tile_decays(lw[:, s:e])
            rt, kt, vt = r[:, s:e], k[:, s:e], v[:, s:e]
            y[:, s:e] = (rt * qf) @ S + _wkv_pair_scores(rt, kt, uf, W) @ vt
            S = dec[..., None] * S + (kt * kf).transpose(1, 2) @ vt
    return (y, sT, s0) if emit_chunk_states else (y, sT)


def wkv_du_sum(parts, heads: int):
    """du (H, K) from per-chunk partials (B*H, nc, K) in the kernel's fixed
    order: over the batch, and inside each batch row over the chunks, one
    float32 add at a time."""
    BH, nc, K = parts.shape
    rows = parts.reshape(BH // heads, heads, nc, K)
    acc = torch.zeros((heads, K), dtype=torch.float32, device=parts.device)
    for b in range(rows.shape[0]):
        for c in range(nc):
            acc = acc + rows[b, :, c]
    return acc


def rwkv_wkv_factored_bwd_ref(r, k, v, log_w, u, dy, s0, dsT, *, chunk: int,
                              tile: int = WKV_TILE,
                              heads: Optional[int] = None):
    """The factored backward (adjoint pass, then the gradient pass of
    every chunk from its entry state and exit adjoint): the arguments of
    ``rwkv_wkv_bwd_ref`` with any T -> fp32 ``(dr, dk, dv, dlog_w, du)``,
    ``du`` (BH, K) summed over each row's chunks in order, or with
    ``heads`` (H, K) by :func:`wkv_du_sum`, as the kernels sum it."""
    BH, T, K = r.shape
    r, k, v, lw, dy = (a.float() for a in (r, k, v, log_w, dy))
    uf = u.float()[:, None]
    G_out = wkv_adjoint_scan_ref(r, lw, dy, dsT, chunk=chunk, tile=tile)
    dr, dk, dv, dlw = (torch.empty((BH, T, K), dtype=torch.float32,
                                   device=r.device) for _ in range(4))
    du_parts = []
    for c, tiles in wkv_tiles(T, chunk, tile):
        S = s0[:, c].float()
        dLp = {}
        for s, e in tiles:                                   # in order
            qf, kf, dec, W = wkv_tile_decays(lw[:, s:e])
            rt, kt, vt, dyt = r[:, s:e], k[:, s:e], v[:, s:e], dy[:, s:e]
            dS = dyt @ vt.transpose(1, 2)                    # dy_t . v_i
            db = torch.diagonal(dS, dim1=1, dim2=2)[..., None]
            core = qf * (dyt @ S.transpose(1, 2)) + torch.einsum(
                "bti,bik,btik->btk", dS, kt, W)
            dr[:, s:e] = core + uf * kt * db
            dLp[s] = rt * core
            S = dec[..., None] * S + (kt * kf).transpose(1, 2) @ vt
        G = G_out[:, c]
        run = (G * S).sum(-1)                                # (BH, K)
        du = torch.zeros((BH, K), dtype=torch.float32, device=r.device)
        for s, e in reversed(tiles):                         # in reverse
            qf, kf, dec, W = wkv_tile_decays(lw[:, s:e])
            rt, kt, vt, dyt = r[:, s:e], k[:, s:e], v[:, s:e], dy[:, s:e]
            dS = dyt @ vt.transpose(1, 2)
            db = torch.diagonal(dS, dim1=1, dim2=2)[..., None]
            dk_in = kf * (vt @ G.transpose(1, 2)) + torch.einsum(
                "bti,btk,btik->bik", dS, rt, W)
            dk[:, s:e] = dk_in + uf * rt * db
            A = _wkv_pair_scores(rt, kt, uf, W)
            dv[:, s:e] = (kt * kf) @ G + A.transpose(1, 2) @ dyt
            dL = -kt * dk_in
            for t in reversed(range(e - s)):
                dlw[:, s + t] = run + dL[:, t]
                run = run + dL[:, t] + dLp[s][:, t]
            du = du + (rt * kt * db).sum(1)
            G = dec[..., None] * G + (rt * qf).transpose(1, 2) @ dyt
        du_parts.append(du)
    parts = torch.stack(du_parts, dim=1)                     # (BH, nc, K)
    if heads is not None:
        return dr, dk, dv, dlw, wkv_du_sum(parts, heads)
    return dr, dk, dv, dlw, wkv_du_sum(parts, BH)

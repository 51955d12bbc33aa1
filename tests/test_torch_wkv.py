"""The wkv kernels' factored algebra (``kernels/ref.py`` mirrors of
``csrc/rwkv_wkv.cu``) against the JAX package, on the CPU.

The CUDA kernels cannot run here; their plain mirrors follow the same
passes (state pass, output pass, adjoint pass, gradient pass, du in a
fixed order) with the same per-sub-tile factored decays, so these tests
hold the algebra the card runs.  Inputs are seeded numpy in the model
layout, flattened to the kernel layout (B*H, T, K) for the mirrors; the
JAX side runs its Pallas kernels in interpret mode, as its own tests do.

Tolerances, fp32: 1e-4 the forward (y, S_T, the entry states) and 5e-4
abs + 1e-3 rel the backward, the JAX kernel-level gates; against the token
oracle and autograd through it the same two gates.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import rwkv_wkv as wkv_mod
from repro_torch.kernels.rwkv_wkv import (rwkv_wkv, rwkv_wkv_bwd,
                                          rwkv_wkv_bwd_plain, rwkv_wkv_fwd,
                                          rwkv_wkv_plain)

# (B, T, H, K, chunk, log_w range): chunks 8-128, head dims 16/32/64,
# ragged T, chunks that are not a multiple of the 16-token sub-tile.  The
# JAX tests' decays -U(0.05, 1) up to chunk 64; at chunk 128 the model's
# range (per-token decays e^-0.0025 .. e^-0.37, as the card tests draw
# them): there -U(0.05, 1) takes the TPU algebra's e^{-L} to ~e^67, where
# the JAX reference itself keeps only ~1e-5 of y's scale (the token-oracle
# test below holds the mirrors at those decays and stronger)
CASES = [
    (2, 19, 2, 16, 8, (0.05, 1.0)),
    (1, 48, 2, 32, 16, (0.05, 1.0)),
    (2, 100, 1, 64, 32, (0.05, 1.0)),
    (1, 90, 2, 32, 20, (0.05, 1.0)),
    (1, 128, 2, 64, 64, (0.05, 1.0)),
    (1, 300, 1, 64, 128, (0.0025, 0.37)),
]


def _inputs(seed, B, T, H, K, lo=0.05, hi=1.0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, K)).astype(np.float32)
               for _ in range(3))
    lw = -rng.uniform(lo, hi, (B, T, H, K)).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32)
    dy = rng.standard_normal((B, T, H, K)).astype(np.float32)
    dsT = rng.standard_normal((B, H, K, K)).astype(np.float32)
    return r, k, v, lw, u, dy, dsT


def _flat(x):
    """(B, T, H, K) numpy -> (B*H, T, K) tensor."""
    B, T, H, K = x.shape
    return torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 2, 1, 3).reshape(B * H, T, K)))


def _unflat(x, B, H):
    BH, T, K = x.shape
    return x.reshape(B, H, T, K).transpose(1, 2)


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol)


def _mirror(r, k, v, lw, u, dy, dsT, chunk):
    """The factored forward and backward mirrors on model-layout numpy
    inputs: ``(y, S_T, s0), (dr, dk, dv, dlog_w, du (H, K))``."""
    B, T, H, K = r.shape
    xs = [_flat(a) for a in (r, k, v, lw)]
    uf = torch.from_numpy(u)[None].expand(B, H, K).reshape(B * H, K)
    y, sT, s0 = kref.rwkv_wkv_factored_ref(*xs, uf, chunk=chunk,
                                           emit_chunk_states=True)
    grads = kref.rwkv_wkv_factored_bwd_ref(
        *xs, uf, _flat(dy), s0, torch.from_numpy(dsT).reshape(B * H, K, K),
        chunk=chunk, heads=H)
    return ((_unflat(y, B, H), sT.reshape(B, H, K, K), s0),
            (*(_unflat(g, B, H) for g in grads[:4]), grads[4]))


@pytest.mark.parametrize("B,T,H,K,chunk,decay", CASES)
def test_factored_mirrors_match_jax(B, T, H, K, chunk, decay):
    r, k, v, lw, u, dy, dsT = _inputs(0, B, T, H, K, *decay)
    J = [jnp.asarray(a) for a in (r, k, v, lw, u)]
    (jy, jsT), js0 = jops.rwkv_wkv_fwd(*J, chunk=chunk, interpret=True)
    want = jops.rwkv_wkv_bwd(*J, js0, jnp.asarray(dy), jnp.asarray(dsT),
                             chunk=chunk, interpret=True)
    (y, sT, s0), grads = _mirror(r, k, v, lw, u, dy, dsT, chunk)
    _close(y, jy, 1e-4)
    _close(sT, jsT, 1e-4)
    _close(s0, js0, 1e-4)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        _close(g, w, 5e-4, 1e-3)


def test_factored_mirrors_stay_finite_where_the_tpu_algebra_does_not():
    """log_w ~ -U(0.7, 1) at chunk 128: e^{-L} of the TPU algebra passes
    fp32's range (its plain version is not finite); the factored mirrors'
    exponents are all <= 0, and they match the token oracle and autograd
    through it."""
    B, T, H, K = 1, 256, 2, 64
    r, k, v, lw, u, dy, dsT = _inputs(1, B, T, H, K, 0.7, 1.0)
    (y, sT, s0), grads = _mirror(r, k, v, lw, u, dy, dsT, 128)
    for x in (y, sT, s0, *grads):
        assert torch.isfinite(x).all()
    uf = torch.from_numpy(u)[None].expand(B, H, K).reshape(B * H, K)
    tpu_y, _ = kref.rwkv_wkv_chunked_ref(*(_flat(a) for a in (r, k, v, lw)),
                                         uf, chunk=128)
    assert not torch.isfinite(tpu_y).all()
    leaves = [torch.from_numpy(a).requires_grad_() for a in (r, k, v, lw, u)]
    wy, wsT = kref.rwkv_wkv_ref_model(*leaves)
    loss = ((wy * torch.from_numpy(dy)).sum()
            + (wsT * torch.from_numpy(dsT)).sum())
    wants = torch.autograd.grad(loss, leaves)
    _close(y, wy.detach(), 1e-4)
    _close(sT, wsT.detach(), 1e-4)
    for g, w in zip(grads, wants):
        _close(g, w, 5e-4, 1e-3)


@pytest.mark.parametrize("T,chunk", [(37, 16), (64, 64), (40, 8)])
def test_factored_passes_agree_with_the_chunked_reference(T, chunk):
    """The state and adjoint passes alone: s0 and S_T against the TPU
    chunk algebra's entry states, and G (the adjoint of every chunk's exit
    state) against autograd of the token oracle through the chunk
    boundaries."""
    B, H, K = 1, 2, 16
    r, k, v, lw, u, dy, dsT = _inputs(2, B, T, H, K)
    xs = [_flat(a) for a in (r, k, v, lw)]
    s0, sT = kref.wkv_state_scan_ref(xs[1], xs[2], xs[3], chunk=chunk)
    Tp = -(-T // chunk) * chunk
    pad = [torch.nn.functional.pad(x, (0, 0, 0, Tp - T)) for x in xs]
    uf = torch.from_numpy(u).repeat(B, 1)
    _, want_sT, want_s0 = kref.rwkv_wkv_chunked_ref(*pad, uf, chunk=chunk,
                                                    emit_chunk_states=True)
    _close(s0, want_s0, 1e-5)
    _close(sT, want_sT, 1e-5)
    G = kref.wkv_adjoint_scan_ref(xs[0], xs[3], _flat(dy),
                                  torch.from_numpy(dsT).reshape(B * H, K, K),
                                  chunk=chunk)
    # G[c] = dLoss/dS after chunk c, against autograd of the token
    # recurrence taken at the chunk boundaries' states
    y_parts, S = [], torch.zeros(B * H, K, K, requires_grad=True)
    states = []
    for c0 in range(0, T, chunk):
        states.append(S)
        sl = slice(c0, min(c0 + chunk, T))
        y_c, S = _token_chunk(*(x[:, sl] for x in xs), uf, S)
        y_parts.append(y_c)
    loss = (torch.cat(y_parts, 1) * _flat(dy)).sum() + (
        S * torch.from_numpy(dsT).reshape(B * H, K, K)).sum()
    grads = torch.autograd.grad(loss, states[1:]) if len(states) > 1 else ()
    for c, g in enumerate(grads):
        _close(G[:, c], g, 1e-4)
    _close(G[:, -1], torch.from_numpy(dsT).reshape(B * H, K, K), 0.0)


def _token_chunk(r, k, v, lw, u, S):
    """Token-by-token recurrence over one chunk from state S."""
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, None] * v[:, t, None, :]
        ys.append(torch.einsum("bk,bkv->bv", r[:, t], S + u[..., None] * kv))
        S = S * lw[:, t].exp()[..., None] + kv
    return torch.stack(ys, 1), S


def test_du_is_summed_in_a_fixed_order():
    """du (H, K) adds the per-chunk partials one at a time, batch rows
    outer, chunks inner: the order is visible where float addition does not
    associate, and two calls give the same bits."""
    # partials (B*H = 2 rows, 2 chunks, K = 1): batch-outer order gives
    # ((1e8 + 1) - 1e8) + 1 = 1 in float32, chunk-outer (1e8 - 1e8) + 2 = 2
    parts = torch.tensor([[[1e8], [1.0]], [[-1e8], [1.0]]],
                         dtype=torch.float32)
    assert kref.wkv_du_sum(parts, heads=1).item() == 1.0
    assert (parts[0, 0] + parts[1, 0] + parts[0, 1] + parts[1, 1]).item() == 2
    r, k, v, lw, u, dy, dsT = _inputs(3, 2, 40, 2, 16)
    a = _mirror(r, k, v, lw, u, dy, dsT, 16)[1][4]
    b = _mirror(r, k, v, lw, u, dy, dsT, 16)[1][4]
    assert a.shape == (2, 16) and torch.equal(a, b)


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """CPU tensors take the plain versions and count no launch; the
    backward returns the primal dtypes (bf16 r/k/v here) and du summed over
    the batch, as the kernels do on the card."""
    r, k, v, lw, u, dy, dsT = (torch.from_numpy(a)
                               for a in _inputs(4, 2, 20, 2, 16))
    r, k, v = (t.to(torch.bfloat16) for t in (r, k, v))
    counts = (rwkv_wkv.launches, rwkv_wkv_bwd.launches)
    (y, sT), s0 = rwkv_wkv_fwd(r, k, v, lw, u, chunk=8)
    y2, sT2 = rwkv_wkv(r, k, v, lw, u, chunk=8, return_state=True)
    grads = rwkv_wkv_bwd(r, k, v, lw, u, s0, dy, dsT, chunk=8)
    assert counts == (rwkv_wkv.launches, rwkv_wkv_bwd.launches)
    want_y, want_sT, want_s0 = rwkv_wkv_plain(r, k, v, lw, u, chunk=8,
                                              emit_chunk_states=True)
    for got, want in ((y, want_y), (sT, want_sT), (s0, want_s0), (y2, y),
                      (sT2, sT)):
        assert torch.equal(got, want)
    wants = rwkv_wkv_bwd_plain(r, k, v, lw, u, s0, dy, dsT, chunk=8)
    wants = (*wants[:4], wants[4].reshape(2, 2, 16).sum(0))
    for got, want, primal in zip(grads, wants, (r, k, v, lw, u)):
        assert got.dtype == primal.dtype and got.shape == primal.shape
        assert torch.equal(got, want.to(primal.dtype))


def test_params_mirror_the_kernel_struct():
    """The ctypes parameters name the fields of ``struct WkvParams`` in
    csrc/rwkv_wkv.cu in its order, with pointers, strides and ints in the
    C widths."""
    src = (Path(wkv_mod.__file__).parent / "csrc" / "rwkv_wkv.cu").read_text()
    body = re.search(r"struct WkvParams \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        ctype = "ptr" if "*" in decl else decl.split()[0]
        names = decl.replace("*", " ").split(None, 2 if ctype == "long"
                                             else 1)[-1]
        fields += [(n.strip().split()[-1], ctype) for n in names.split(",")]
    kinds = {"ptr": wkv_mod.ctypes.c_void_p, "long": wkv_mod.ctypes.c_longlong,
             "int": wkv_mod.ctypes.c_int}
    assert [(n, kinds[c]) for n, c in fields] == list(
        wkv_mod._WkvParams._fields_)

"""The port's plain kernel versions against the JAX package's kernels.

Same numpy inputs (seeded) go through ``repro.kernels.ops`` — the Pallas
kernels in interpret mode, as the JAX package's own tests run them on the
CPU — and through ``repro_torch.kernels``.  Tolerances are the per-site
gates of docs/ENGINES.md: attention 2e-5, entropy 1e-4, and gate decisions
equal wherever |H - tau| > 1e-3.  On the CPU the kernel wrappers run these
plain versions and launch nothing; the CUDA kernels themselves are held
against them in tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.losses import softmax_entropy as jax_softmax_entropy
from repro.kernels import ops
from repro_torch.core.losses import softmax_entropy
from repro_torch.kernels import dispatch
from repro_torch.kernels.entropy_exit import entropy_exit
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import entropy_exit_ref, flash_attention_ref

ATOL_ATTN = 2e-5
ATOL_H = 1e-4
GATE_MARGIN = 1e-3


def _qkv(seed, B, H, Hkv, Tq, Tk, D=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Tq, D), np.float32),
            rng.standard_normal((B, Hkv, Tk, D), np.float32),
            rng.standard_normal((B, Hkv, Tk, D), np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# GQA ratios 2, 4 and 16; causal, sliding window, ragged Tq < Tk
ATTN_CASES = [
    # (H, Hkv, Tq, Tk, causal, window)
    (4, 2, 12, 12, True, None),
    (8, 2, 12, 12, True, 5),
    (16, 1, 9, 21, True, None),      # ragged prefill: Tq < Tk, ratio 16
    (8, 2, 7, 19, True, 4),          # ragged + window
    (4, 1, 10, 10, False, None),
]


@pytest.mark.parametrize("H,Hkv,Tq,Tk,causal,window", ATTN_CASES)
def test_flash_attention_ref_matches_jax_kernel(H, Hkv, Tq, Tk, causal,
                                                window):
    q, k, v = _qkv(0, 2, H, Hkv, Tq, Tk)
    want = np.asarray(ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, interpret=True))
    got = flash_attention_ref(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_ATTN, rtol=0)


# head dim 256 (paligemma-3b: H 8, Hkv 1): ragged Tq != Tk, causal and
# not, a window; the forward with its LSE and both backward plain
# versions against the JAX kernels in interpret mode
D256_CASES = [
    # (H, Hkv, Tq, Tk, causal, window)
    (8, 1, 9, 21, True, None),
    (8, 1, 13, 13, True, 5),
    (8, 1, 7, 19, False, None),
    (8, 2, 11, 11, False, None),
]


@pytest.mark.parametrize("H,Hkv,Tq,Tk,causal,window", D256_CASES)
def test_head_dim_256_plain_versions_match_jax_kernels(H, Hkv, Tq, Tk,
                                                       causal, window):
    from repro_torch.kernels.ref import flash_attention_bwd_ref
    q, k, v = _qkv(5, 2, H, Hkv, Tq, Tk, D=256)
    do = np.random.default_rng(6).standard_normal(q.shape).astype(
        np.float32)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = ops.flash_attention_fwd(jq, jk, jv, causal=causal,
                                     window=window, interpret=True)
    got, got_lse = flash_attention_ref(*_t(q, k, v), causal=causal,
                                       window=window, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(o), atol=ATOL_ATTN,
                               rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), atol=1e-4,
                               rtol=0)
    want = ops.flash_attention_bwd(jq, jk, jv, o, lse, jdo, causal=causal,
                                   window=window, interpret=True)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    grads = flash_attention_bwd_ref(*_t(q, k, v), t(o), t(lse), t(do),
                                    causal=causal, window=window)
    for g, w in zip(grads, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=0)


@pytest.mark.parametrize("H,Hkv", [(4, 2), (8, 2), (16, 1)])
def test_decode_per_row_kv_valid_matches_scalar_jax_calls(H, Hkv):
    """One kv_valid per row in one call == the JAX kernel called row by row
    with that row's scalar prefix (what vmap over slots did)."""
    B, Tk = 4, 23
    q, k, v = _qkv(1, B, H, Hkv, 1, Tk)
    kv_valid = np.array([1, 7, 23, 12], np.int32)
    got = flash_attention_ref(*_t(q, k, v), causal=False,
                              kv_valid=torch.from_numpy(kv_valid)).numpy()
    for b in range(B):
        want = np.asarray(ops.flash_attention(
            jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
            jnp.asarray(v[b:b + 1]), causal=False,
            kv_valid=jnp.int32(kv_valid[b]), interpret=True))
        np.testing.assert_allclose(got[b:b + 1], want, atol=ATOL_ATTN, rtol=0)


@pytest.mark.parametrize("window", [None, 4])
def test_flash_attention_lse_matches_jax_kernel(window):
    q, k, v = _qkv(2, 2, 8, 2, 11, 11)
    out, lse = ops.flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=True,
                                       window=window, interpret=True)
    got, got_lse = flash_attention_ref(*_t(q, k, v), causal=True,
                                       window=window, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=ATOL_ATTN,
                               rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse),
                               atol=ATOL_ATTN, rtol=0)


def test_wrapper_runs_plain_version_on_cpu_and_launches_nothing():
    q, k, v = _t(*_qkv(3, 2, 4, 2, 5, 9))
    kv = torch.tensor([3, 9], dtype=torch.int32)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=False, kv_valid=kv)
    want = flash_attention_ref(q, k, v, causal=False, kv_valid=kv)
    assert torch.equal(got, want)
    assert flash_attention.launches == before


@pytest.mark.parametrize("bad", [
    dict(k=(2, 3, 9, 16)),          # H=4 not a multiple of Hkv=3
    dict(v=(2, 2, 8, 16)),          # k/v mismatch
    dict(kv_valid=(3,)),            # not one value per row
])
def test_wrapper_rejects_malformed_operands(bad):
    shapes = dict(q=(2, 4, 5, 16), k=(2, 2, 9, 16), v=(2, 2, 9, 16))
    shapes.update({n: s for n, s in bad.items() if n != "kv_valid"})
    q, k, v = (torch.zeros(shapes[n]) for n in "qkv")
    kv = (torch.ones(bad["kv_valid"], dtype=torch.int32)
          if "kv_valid" in bad else None)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, kv_valid=kv)


@pytest.mark.parametrize("V", [97, 2048 + 5])
def test_entropy_exit_matches_jax_kernel_and_oracle(V):
    """H at 1e-4 against the Pallas kernel (interpret) and softmax_entropy;
    per-row tau; decisions equal away from the threshold."""
    rng = np.random.default_rng(V)
    B = 6
    logits = (3 * rng.standard_normal((B, V))).astype(np.float32)
    H_jax, _ = ops.entropy_exit(jnp.asarray(logits), 0.0, interpret=True)
    H_jax = np.asarray(H_jax)
    np.testing.assert_allclose(
        np.asarray(jax_softmax_entropy(jnp.asarray(logits))), H_jax,
        atol=ATOL_H)
    tau = (H_jax + np.array([-0.5, 0.5, -2e-3, 2e-3, -5e-4, 5e-4])
           ).astype(np.float32)
    for H, ex in (entropy_exit(torch.from_numpy(logits),
                               torch.from_numpy(tau)),
                  entropy_exit_ref(torch.from_numpy(logits),
                                   torch.from_numpy(tau))):
        np.testing.assert_allclose(H.numpy(), H_jax, atol=ATOL_H, rtol=0)
        assert ex.dtype == torch.int32
        for b in range(B):
            _, ex_jax = ops.entropy_exit(jnp.asarray(logits[b:b + 1]),
                                         jnp.float32(tau[b]), interpret=True)
            if abs(H_jax[b] - tau[b]) > GATE_MARGIN:
                assert bool(ex[b]) == bool(np.asarray(ex_jax)[0]), b
    np.testing.assert_allclose(softmax_entropy(torch.from_numpy(logits)),
                               H_jax, atol=ATOL_H, rtol=0)


@pytest.mark.parametrize("kernels", ["auto", "ref"])
def test_backends_take_model_layouts_and_per_row_thresholds(kernels):
    backend = dispatch.get_backend(kernels)
    q, k, v = _t(*_qkv(4, 3, 8, 2, 1, 10))
    kv = torch.tensor([1, 5, 10], dtype=torch.int32)
    out = backend.attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), kv_valid=kv)
    want = flash_attention_ref(q, k, v, causal=False, kv_valid=kv)
    assert out.shape == (3, 1, 8, 16)
    torch.testing.assert_close(out, want.transpose(1, 2), atol=0, rtol=0)

    logits = torch.randn(3, 1, 50, generator=torch.Generator().manual_seed(0))
    H_all, _ = backend.entropy_gate(logits, 0.0)
    tau = H_all[:, 0] + torch.tensor([-1.0, 1.0, torch.inf])
    H, ex = backend.entropy_gate(logits, tau)
    assert H.shape == ex.shape == (3, 1) and ex.dtype == torch.bool
    assert ex[:, 0].tolist() == [False, True, True]


def test_resolve_kernels():
    assert dispatch.resolve_kernels("auto") == "cuda"
    assert dispatch.resolve_kernels("ref") == "ref"
    with pytest.raises(ValueError, match="kernels"):
        dispatch.resolve_kernels("pallas")


# the forward's route rule: bf16 and head dim 64, 128 or 256 take the
# tile route from Tq * G >= 64 rows, the decode route below; the rest the
# row route
@pytest.mark.parametrize("dtype,D,Tq,G,route", [
    (torch.bfloat16, 256, 1, 8, "decode"),   # paligemma decode: 8 rows
    (torch.bfloat16, 256, 7, 8, "decode"),   # 56 rows: below one tile
    (torch.bfloat16, 256, 8, 8, "tile"),     # 64 rows: one full tile
    (torch.bfloat16, 256, 512, 8, "tile"),   # paligemma prefill, training
    (torch.float32, 256, 512, 8, "row"),
    (torch.bfloat16, 128, 1, 16, "decode"),  # decode: 16 rows, glm4-9b
    (torch.bfloat16, 128, 3, 16, "decode"),  # 48 rows: just below one tile
    (torch.bfloat16, 128, 4, 16, "tile"),    # 64 rows: one full tile
    (torch.bfloat16, 128, 128, 16, "tile"),  # glm4-9b prefill and training
    (torch.bfloat16, 64, 63, 1, "decode"),
    (torch.bfloat16, 64, 64, 1, "tile"),
    (torch.bfloat16, 64, 16, 4, "tile"),
    (torch.bfloat16, 32, 128, 16, "row"),    # head dim 32: row kernel only
    (torch.bfloat16, 16, 128, 16, "row"),
    (torch.float32, 128, 128, 16, "row"),    # fp32 stays exact to 2e-5
    (torch.float16, 128, 128, 16, "row"),
])
def test_attention_route_rule(dtype, D, Tq, G, route):
    from repro_torch.kernels.flash_attention import attention_route
    assert attention_route(dtype, D, Tq, G) == route


@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 128, "tile"), (torch.bfloat16, 64, "tile"),
    (torch.bfloat16, 256, "tile"), (torch.float32, 256, "row"),
    (torch.bfloat16, 32, "row"), (torch.float32, 128, "row"),
    (torch.float32, 64, "row"),
])
def test_dkv_route_rule(dtype, D, route):
    from repro_torch.kernels.flash_attention import dkv_route
    assert dkv_route(dtype, D) == route


@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 128, "tile"), (torch.bfloat16, 64, "tile"),
    (torch.bfloat16, 256, "tile"), (torch.float32, 256, "row"),
    (torch.bfloat16, 32, "row"), (torch.bfloat16, 16, "row"),
    (torch.float32, 128, "row"), (torch.float16, 128, "row"),
])
def test_dq_route_rule(dtype, D, route):
    from repro_torch.kernels.flash_attention import dq_route
    assert dq_route(dtype, D) == route


# the decode route's split rule: (B * Hkv, key tiles) -> blocks per
# cluster
@pytest.mark.parametrize("bh,tiles,splits", [
    (16, 3, 3),        # glm4-9b serving: 8 slots x 2 kv heads, 161 keys
    (16, 64, 8),       # a 4096-key cache: 8 x 16 = 128 blocks
    (20, 64, 7), (24, 64, 6), (32, 64, 5), (40, 64, 4), (48, 64, 3),
    (80, 64, 2),
    (132, 64, 1),      # one cluster a SM already fills the card
    (1000, 64, 1),
    (1, 1, 1),         # one key tile: nothing to split
    (1, 64, 8),        # the portable cluster size caps it
])
def test_decode_split_rule(bh, tiles, splits):
    from repro_torch.kernels.flash_attention import (MAX_CLUSTER, NUM_SMS,
                                                     decode_splits)
    got = decode_splits(bh, tiles)
    assert got == splits
    assert 1 <= got <= min(MAX_CLUSTER, tiles)
    # the fewest splits that fill the SMs, unless a cap binds first
    assert bh * got >= NUM_SMS or got == min(MAX_CLUSTER, tiles)
    assert got == 1 or bh * (got - 1) < NUM_SMS


def test_cpu_tensors_take_no_route():
    """Tile- and decode-shaped bf16 calls on the CPU run the plain versions
    and count no launch on any route, forward, dK/dV or dQ, and no delta
    pass."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    wrappers = (flash_attention, flash_attention_bwd_dkv,
                flash_attention_bwd_dq)

    def counts():
        return [getattr(w, a, None) for w in wrappers
                for a in ("launches", "row_launches", "tile_launches",
                          "decode_launches")] + [
            flash_attention_bwd.torch_delta_passes]

    q, k, v = (t.to(torch.bfloat16) for t in _t(*_qkv(5, 1, 8, 2, 16, 16,
                                                      D=64)))
    before = counts()
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    flash_attention(q[:, :, :1], k, v, causal=False)       # decode-shaped
    flash_attention_bwd(q, k, v, out, lse, torch.ones_like(q), causal=True)
    flash_attention_bwd_dq(q, k, v, torch.ones_like(q), lse, o=out)
    assert counts() == before

"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips when no CUDA device is present (the check
runs inside the fixture, never at import).  On a machine with a card
(``--noconftest``: tests/conftest.py imports JAX, which that machine need
not have):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 attention 2e-5 and entropy 1e-4 (reassociation only);
bf16 attention outputs compared in fp32 at 2e-2 (the kernel and the plain
version round to bf16 at different points); gate decisions equal wherever
|H - tau| > 1e-3.  Attention backward: each kernel's fp32 output within
2e-4 of its plain version for fp32 and bf16 operands alike (both compute in
fp32 from the same values: reassociation only); the wrapper's gradients,
cast to bf16, within 1e-2 + 1e-2 |g| (one bf16 rounding); the autograd
site within 1e-4 (fp32) of autograd of the plain forward, and in bf16
within 1e-2 of each tensor's largest magnitude: the kernels form
delta = rowsum(dO * O) from the bf16 output, where autograd of the plain
forward differentiates through fp32 probabilities (measured on the CPU
with the plain versions: 3.4e-3 of the scale).
"""
import contextlib

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("H,Hkv,Tq,Tk,causal,window,ragged", [
    (32, 2, 1, 161, False, None, True),      # decode, per-row kv_valid
    (32, 2, 37, 161, True, None, False),     # ragged causal prefill
    (8, 2, 64, 64, True, 16, False),         # sliding window
    (4, 4, 5, 70, False, None, False),
])
@pytest.mark.parametrize("D", [32, 128])
def test_flash_attention_kernel_matches_plain(dev, dtype, tol, H, Hkv, Tq, Tk,
                                              causal, window, ragged, D):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    g = torch.Generator(device=dev).manual_seed(0)
    B = 3
    q, k, v = (torch.randn(B, T, h, D, generator=g, device=dev).to(dtype)
               .transpose(1, 2) for T, h in ((Tq, H), (Tk, Hkv), (Tk, Hkv)))
    kv = (torch.tensor([1, Tk // 2, Tk], dtype=torch.int32, device=dev)
          if ragged else None)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, causal=causal, window=window,
                               kv_valid=kv, return_lse=True)
    want, want_lse = flash_attention_ref(q, k, v, causal=causal,
                                         window=window, kv_valid=kv,
                                         return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == want.shape
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,V,layout", [
    (8, 97, None), (8, 2053, None), (8, 151552, None),
    (8, 65536, None),                   # rwkv6-3b's serve shape
    (1, 151552, None), (300, 151552, None),   # 300 rows: one block a row
    (65537, 97, None),                  # beyond grid.y: two grid.z slices
    (8, 151552, "misaligned"), (8, 2053, "misaligned"),
    (8, 151552, "max last"), (8, 151552, "-inf"), (3, 97, "-inf"),
])
def test_entropy_exit_kernel_matches_plain(dev, dtype, B, V, layout):
    """H within 1e-4 of the plain version, exits equal away from tau, the
    same bits from a second launch.  A row holding a -inf logit has H =
    NaN on both sides (p log p = 0 * -inf) and does not exit."""
    from repro_torch.kernels.entropy_exit import entropy_exit
    from repro_torch.kernels.ref import entropy_exit_ref
    from repro_torch.parity import gate_logits, gate_thresholds
    g = torch.Generator(device=dev).manual_seed(1)
    x = gate_logits(g, dtype, B, V, layout)
    tau = gate_thresholds(entropy_exit_ref(x, 0.0)[0])
    before = entropy_exit.launches
    H, ex = entropy_exit(x, tau)
    H2, ex2 = entropy_exit(x, tau)
    H_ref, ex_ref = entropy_exit_ref(x, tau)
    torch.cuda.synchronize()
    assert entropy_exit.launches == before + 2
    # the same bits: compared as integers, so a NaN equals itself
    assert torch.equal(H.view(torch.int32), H2.view(torch.int32))
    assert torch.equal(ex, ex2)
    torch.testing.assert_close(H, H_ref, atol=1e-4, rtol=0, equal_nan=True)
    assert torch.isnan(H).any() == (layout == "-inf")
    assert not ex[torch.isnan(H)].any()
    far = (H_ref - tau).abs() > 1e-3
    assert torch.equal(ex[far], ex_ref[far])


@pytest.mark.parametrize("splits", range(1, 17))
@pytest.mark.parametrize("dtype,layout", [
    (torch.bfloat16, None), (torch.float32, "misaligned"),
    (torch.bfloat16, "max last"), (torch.bfloat16, "-inf")])
def test_entropy_exit_every_cluster_size(dev, splits, dtype, layout):
    """Every cluster size the kernel takes, at a row width for which the
    wrapper picks it: H within 1e-4 of the plain version (and of the
    kernel's plain mirror at that split), the same bits from a second
    launch."""
    from repro_torch.kernels.entropy_exit import (entropy_exit, gate_splits,
                                                  sm_count)
    from repro_torch.kernels.ref import (entropy_exit_ref,
                                         entropy_exit_split_ref)
    from repro_torch.parity import (GATE_CLUSTER_ROWS, gate_cluster_vocab,
                                    gate_logits)
    B, V = GATE_CLUSTER_ROWS, gate_cluster_vocab(splits)
    assert gate_splits(B, V, sm_count(0)) == splits
    g = torch.Generator(device=dev).manual_seed(splits)
    x = gate_logits(g, dtype, B, V, layout)
    H, _ = entropy_exit(x, 0.0)
    H2, _ = entropy_exit(x, 0.0)
    H_ref, _ = entropy_exit_ref(x, 0.0)
    H_mirror, _ = entropy_exit_split_ref(x, 0.0, splits)
    torch.cuda.synchronize()
    assert torch.equal(H.view(torch.int32), H2.view(torch.int32))
    torch.testing.assert_close(H, H_ref, atol=1e-4, rtol=0, equal_nan=True)
    torch.testing.assert_close(H, H_mirror, atol=1e-4, rtol=0,
                               equal_nan=True)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    from repro_torch.kernels.entropy_exit import entropy_exit
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.zeros(1, 2, 3, 48, device=dev)          # head_dim 48
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="dtype"):
        entropy_exit(torch.zeros(2, 10, dtype=torch.float16, device=dev), 1.0)


def test_serve_session_on_the_card_matches_sequential(dev):
    """glm4-9b smoke in fp32 on the card, through both kernels: the batched
    session equals the sequential oracle token for token."""
    from repro_torch.api.serve_session import (ServeSession,
                                               sequential_reference)
    from repro_torch.configs import glm4_9b
    from repro_torch.kernels.entropy_exit import entropy_exit
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.backbone import init_backbone
    cfg = glm4_9b.smoke()
    params = init_backbone(torch.Generator(device=dev).manual_seed(0), cfg)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(4, 10)))
               for _ in range(4)]
    sess = ServeSession(cfg, params, tau=2.0, slots=2, max_len=24)
    for p in prompts:
        sess.submit(p, decode_tokens=5)
    n_attn, n_gate = flash_attention.launches, entropy_exit.launches
    got = {r.rid: r for r in sess.run()}
    assert flash_attention.launches > n_attn and entropy_exit.launches > n_gate
    for rid, p in enumerate(prompts):
        ref = sequential_reference(cfg, params, p, 5, tau=2.0, max_len=24)
        assert (got[rid].tokens, got[rid].exited) == (ref.tokens, ref.exited)
        np.testing.assert_allclose(got[rid].entropy, ref.entropy, atol=1e-4)


# the tile and decode routes (bf16, head dims 64 and 128) against the
# plain versions, at the tolerances chip_smoke.py holds them to
TILE_FWD_CASES = [
    # (B, H, Hkv, Tq, Tk, causal, window, kv_valid, route)
    (2, 32, 2, 128, 161, True, None, None, "tile"),   # prefill over the ring
    (1, 32, 2, 37, 161, True, None, None, "tile"),    # ragged prefill
    (2, 8, 2, 100, 100, True, 16, None, "tile"),      # window, GQA 4
    (3, 4, 4, 70, 70, False, None, None, "tile"),     # non-causal, GQA 1
    (3, 4, 4, 63, 70, False, None, None, "decode"),   # 63 rows: below a tile
    (3, 4, 4, 64, 70, True, None, None, "tile"),      # 64 rows: one tile
    (3, 32, 2, 3, 161, False, None, (1, 80, 161), "decode"),  # 48 rows
    (3, 32, 2, 4, 161, False, None, (1, 80, 161), "tile"),  # 64 rows
    (2, 8, 2, 90, 130, False, 33, (77, 130), "tile"),  # window + kv_valid
]


@pytest.mark.parametrize("B,H,Hkv,Tq,Tk,causal,window,kv,route",
                         TILE_FWD_CASES)
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_attention_tile_route_matches_plain(dev, B, H, Hkv, Tq, Tk,
                                                  causal, window, kv, route,
                                                  D):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn(B, T, h, D, generator=g, device=dev)
               .to(torch.bfloat16).transpose(1, 2)
               for T, h in ((Tq, H), (Tk, Hkv), (Tk, Hkv)))
    kv = (None if kv is None
          else torch.tensor(kv, dtype=torch.int32, device=dev))
    routes = ("tile", "decode", "row")
    before = [getattr(flash_attention, f"{r}_launches") for r in routes]
    out, lse = flash_attention(q, k, v, causal=causal, window=window,
                               kv_valid=kv, return_lse=True)
    want, want_lse = flash_attention_ref(q, k, v, causal=causal,
                                         window=window, kv_valid=kv,
                                         return_lse=True)
    torch.cuda.synchronize()
    assert [getattr(flash_attention, f"{r}_launches") - n
            for r, n in zip(routes, before)] == [int(r == route)
                                                 for r in routes]
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)


def test_misaligned_rows_take_the_row_route(dev):
    """The tile and decode routes copy rows in 16-byte pieces: bf16
    operands whose rows do not start on 16 bytes (a view one element in)
    run the row kernels, forward (tile- and decode-shaped), dK/dV and dQ,
    and still match the plain versions."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from repro_torch.kernels.ref import (flash_attention_bwd_dkv_ref,
                                         flash_attention_bwd_dq_ref,
                                         flash_attention_ref)
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, do = (torch.randn(2, 64, h, 129, generator=g, device=dev)
                   .to(torch.bfloat16)[..., 1:].transpose(1, 2)
                   for h in (8, 2, 2, 8))
    wrappers = (flash_attention, flash_attention_bwd_dkv,
                flash_attention_bwd_dq)

    def counts():
        return [getattr(w, f"{r}_launches") for w in wrappers
                for r in ("row", "tile", "decode") if hasattr(
                    w, f"{r}_launches")]

    before = counts()
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    dec = flash_attention(q[:, :, :1], k, v, causal=False)
    delta = (do.float() * out.float()).sum(-1)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=True)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True)
    want, want_lse = flash_attention_ref(q, k, v, causal=True,
                                         return_lse=True)
    want_dec = flash_attention_ref(q[:, :, :1], k, v, causal=False)
    want_dk, want_dv = flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                   causal=True)
    want_dq = flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                         causal=True)
    torch.cuda.synchronize()
    # forward: row 2, tile 0, decode 0; dK/dV: row 1, tile 0; dQ: the same
    assert [n - b for n, b in zip(counts(), before)] == [2, 0, 0, 1, 0, 1, 0]
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(dec.float(), want_dec.float(), atol=2e-2,
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    torch.testing.assert_close(dk, want_dk, atol=2e-4, rtol=0)
    torch.testing.assert_close(dv, want_dv, atol=2e-4, rtol=0)
    torch.testing.assert_close(dq, want_dq, atol=2e-4, rtol=0)
    with pytest.raises(ValueError, match="fused delta"):
        flash_attention_bwd_dq(q, k, v, do, lse, o=out, causal=True)


# the decode route (mma.sync, the keys split across a cluster)
DECODE_CASES = [
    # (B, H, Hkv, Tq, Tk, causal, window, kv_valid: None, "ones", "ragged")
    (8, 32, 2, 1, 161, False, None, "ragged"),   # glm4-9b serving
    (4, 4, 4, 1, 161, False, None, "ones"),      # GQA 1, 1 row
    (4, 8, 2, 1, 100, False, None, "ragged"),    # GQA 4, ragged Tk
    (3, 32, 2, 1, 65, False, None, None),        # one key past a tile
    (2, 4, 4, 17, 40, True, None, "ragged"),     # 17 rows: two 16-row slices
    (2, 8, 2, 8, 130, True, None, "ones"),       # 32 rows, causal
    (2, 32, 2, 2, 161, True, 1, None),           # causal window 1
    (2, 8, 2, 15, 161, True, 5, None),           # 60 rows, window 5
    (2, 4, 4, 63, 200, False, 9, None),          # 63 rows, window 9
    (8, 32, 2, 1, 4096, False, None, None),      # 8 splits of a long cache
    (24, 32, 2, 1, 4096, False, None, "ragged"),  # 3 splits
    (66, 32, 2, 1, 4096, False, None, None),     # 1 split
]


@pytest.mark.parametrize("B,H,Hkv,Tq,Tk,causal,window,kv", DECODE_CASES)
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_attention_decode_route_matches_plain(dev, B, H, Hkv, Tq, Tk,
                                                    causal, window, kv, D):
    """Out within 2e-2 (bf16) and LSE within 1e-4 of the plain version,
    on the decode route, the same bits on a second launch (the cluster
    merges its blocks' partials in rank order)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (torch.randn(B, T, h, D, generator=g, device=dev)
               .to(torch.bfloat16).transpose(1, 2)
               for T, h in ((Tq, H), (Tk, Hkv), (Tk, Hkv)))
    kv_valid = {None: None,
                "ones": torch.ones(B, dtype=torch.int32, device=dev),
                "ragged": torch.randint(1, Tk + 1, (B,), generator=g,
                                        device=dev, dtype=torch.int32)}[kv]
    kw = dict(causal=causal, window=window, kv_valid=kv_valid,
              return_lse=True)
    before = flash_attention.decode_launches
    out, lse = flash_attention(q, k, v, **kw)
    out2, lse2 = flash_attention(q, k, v, **kw)
    want, want_lse = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.decode_launches == before + 2
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)


DQ_TILE_CASES = [
    # (B, H, Hkv, T, causal, window)
    (12, 32, 2, 128, True, None),     # the training shape, GQA 16
    (1, 32, 2, 1000, True, None),     # a ragged long band
    (1, 32, 2, 2048, True, None),     # the long shape of chip_smoke.py
    (2, 8, 2, 150, True, 24),         # window, GQA 4
    (2, 4, 4, 70, False, None),       # non-causal, GQA 1
]


@pytest.mark.parametrize("B,H,Hkv,T,causal,window", DQ_TILE_CASES)
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_attention_bwd_dq_tile_route_matches_plain(dev, B, H, Hkv, T,
                                                         causal, window, D):
    """The dQ tile route with delta given and with delta fused (``o=``):
    dQ within 2e-4 of the plain version, the delta it writes within 1e-4
    of the largest |delta| of the torch sum, the same bits on a second
    launch (each block owns its rows: no cross-block sum)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_dq
    from repro_torch.kernels.ref import (flash_attention_bwd_dq_ref,
                                         flash_attention_ref)
    q, k, v, do = _bwd_inputs(dev, torch.bfloat16, B, H, Hkv, T, D, seed=9)
    o, lse = flash_attention_ref(q, k, v, causal=causal, window=window,
                                 return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    kw = dict(causal=causal, window=window)
    tiles = flash_attention_bwd_dq.tile_launches
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dq_f, delta_f = flash_attention_bwd_dq(q, k, v, do, lse, o=o, **kw)
    dq_f2, delta_f2 = flash_attention_bwd_dq(q, k, v, do, lse, o=o, **kw)
    want = flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd_dq.tile_launches == tiles + 3
    assert torch.equal(dq_f, dq_f2) and torch.equal(delta_f, delta_f2)
    torch.testing.assert_close(dq, want, atol=2e-4, rtol=0)
    torch.testing.assert_close(dq_f, want, atol=2e-4, rtol=0)
    assert ((delta_f - delta).abs().max()
            <= 1e-4 * delta.abs().max()).item()


TILE_BWD_CASES = [
    # (B, H, Hkv, T, causal, window)
    (12, 32, 2, 128, True, None),     # the training shape, GQA 16
    (2, 8, 2, 100, True, 16),         # window, GQA 4, T not a tile multiple
    (2, 4, 4, 70, False, None),       # non-causal, GQA 1
    (1, 8, 1, 45, False, 8),          # non-causal window, GQA 8
    (2, 12, 1, 77, True, None),       # GQA 12: clusters of 6 blocks
    (1, 32, 2, 1000, True, None),     # long band: 16 query tiles per block
]


@pytest.mark.parametrize("B,H,Hkv,T,causal,window", TILE_BWD_CASES)
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_attention_bwd_dkv_tile_route_matches_plain(dev, B, H, Hkv, T,
                                                          causal, window, D):
    """The cluster dK/dV kernel: fp32 outputs within 2e-4 of the plain
    version (P and dS split into bf16 high and low parts), and the same
    bits on a second launch (the group sum runs in a fixed order)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_dkv
    from repro_torch.kernels.ref import (flash_attention_bwd_dkv_ref,
                                         flash_attention_ref)
    q, k, v, do = _bwd_inputs(dev, torch.bfloat16, B, H, Hkv, T, D, seed=5)
    o, lse = flash_attention_ref(q, k, v, causal=causal, window=window,
                                 return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    tiles = flash_attention_bwd_dkv.tile_launches
    kw = dict(causal=causal, window=window)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dk2, dv2 = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    want_dk, want_dv = flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                   **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd_dkv.tile_launches == tiles + 2
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    torch.testing.assert_close(dk, want_dk, atol=2e-4, rtol=0)
    torch.testing.assert_close(dv, want_dv, atol=2e-4, rtol=0)


# cross attention (non-causal, Tq != Tk, Tk ragged at 64 keys): whisper's
# decode tick and training shapes at D = 64, and paligemma's GQA 8 at
# D = 256 (H 8, Hkv 1) on a ragged prefill and a decode tick
CROSS_CASES = [
    # (B, H, Hkv, Tq, Tk, D, causal, route)
    (8, 12, 12, 1, 1500, 64, False, "decode"),    # whisper decode tick
    (12, 12, 12, 448, 1500, 64, False, "tile"),   # whisper training
    (2, 8, 1, 77, 333, 256, True, "tile"),        # GQA 8, ragged causal
    (3, 8, 1, 90, 150, 256, False, "tile"),
    (8, 8, 1, 1, 300, 256, False, "decode"),      # paligemma decode tick
]


@pytest.mark.parametrize("B,H,Hkv,Tq,Tk,D,causal,route", CROSS_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_tq_ne_tk_matches_plain(dev, B, H, Hkv, Tq, Tk, D,
                                                causal, route, dtype):
    """Forward with LSE, dK/dV and dQ at Tq != Tk against the plain
    versions, at the limits of the other shapes: bf16 on the tile and
    decode routes (the backward's tile routes), fp32 on the row routes."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from repro_torch.kernels.ref import (flash_attention_bwd_dkv_ref,
                                         flash_attention_bwd_dq_ref,
                                         flash_attention_ref)
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v, do = (torch.randn(B, T, h, D, generator=g, device=dev)
                   .to(dtype).transpose(1, 2)
                   for T, h in ((Tq, H), (Tk, Hkv), (Tk, Hkv), (Tq, H)))
    want_route = route if dtype == torch.bfloat16 else "row"
    before = getattr(flash_attention, f"{want_route}_launches")
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    want, want_lse = flash_attention_ref(q, k, v, causal=causal,
                                         return_lse=True)
    torch.cuda.synchronize()
    assert getattr(flash_attention, f"{want_route}_launches") == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    if Tq == 1:
        return
    delta = (do.float() * want.float()).sum(-1)
    bwd_route = "tile" if dtype == torch.bfloat16 else "row"
    counts = (getattr(flash_attention_bwd_dkv, f"{bwd_route}_launches"),
              getattr(flash_attention_bwd_dq, f"{bwd_route}_launches"))
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, want_lse, delta,
                                     causal=causal)
    dq = flash_attention_bwd_dq(q, k, v, do, want_lse, delta, causal=causal)
    want_dk, want_dv = flash_attention_bwd_dkv_ref(q, k, v, do, want_lse,
                                                   delta, causal=causal)
    want_dq = flash_attention_bwd_dq_ref(q, k, v, do, want_lse, delta,
                                         causal=causal)
    torch.cuda.synchronize()
    assert (getattr(flash_attention_bwd_dkv, f"{bwd_route}_launches"),
            getattr(flash_attention_bwd_dq, f"{bwd_route}_launches")) == (
                counts[0] + 1, counts[1] + 1)
    for got, ref in ((dk, want_dk), (dv, want_dv), (dq, want_dq)):
        torch.testing.assert_close(got, ref, atol=2e-4, rtol=0)


def test_autograd_site_bf16_runs_the_tile_routes(dev):
    """FlashAttentionFn in bf16 at D = 64, GQA 4, a window and T = 100:
    the forward, dK/dV and dQ take the tile routes, delta is formed in the
    dQ kernel (no delta pass in torch), and the site stays within 1e-2 of
    each tensor's largest magnitude of autograd of the plain forward."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    g = torch.Generator(device=dev).manual_seed(6)
    leaves = [torch.randn(2, 100, h, 64, generator=g, device=dev)
              .to(torch.bfloat16) for h in (8, 2, 2)]
    cot = torch.randn(2, 100, 8, 64, generator=g, device=dev).to(
        torch.bfloat16)
    grads = []
    for name in ("auto", "ref"):
        q, k, v = (t.clone().requires_grad_() for t in leaves)
        counts = (flash_attention.tile_launches,
                  flash_attention_bwd_dkv.tile_launches,
                  flash_attention_bwd_dq.tile_launches,
                  flash_attention_bwd.torch_delta_passes)
        out = dispatch.get_backend(name).attention(q, k, v, causal=True,
                                                   window=24)
        out.backward(cot)
        torch.cuda.synchronize()
        assert (flash_attention.tile_launches - counts[0],
                flash_attention_bwd_dkv.tile_launches - counts[1],
                flash_attention_bwd_dq.tile_launches - counts[2],
                flash_attention_bwd.torch_delta_passes - counts[3]) == (
                    (1, 1, 1, 0) if name == "auto" else (0, 0, 0, 0))
        grads.append((out.float(), q.grad.float(), k.grad.float(),
                      v.grad.float()))
    for got, want in zip(*grads):
        assert (got - want).abs().max() <= 1e-2 * want.abs().max()


BWD_CASES = [
    # (B, H, Hkv, T, causal, window)
    (12, 32, 2, 128, True, None),     # the training shape, GQA 16
    (2, 8, 2, 100, True, 16),         # sliding window, ragged last tile
    (2, 4, 4, 70, False, None),       # non-causal
    (1, 8, 1, 45, False, 8),          # non-causal window, GQA 8
]


def _bwd_inputs(dev, dtype, B, H, Hkv, T, D, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(B, T, h, D, generator=g, device=dev).to(dtype)
                 .transpose(1, 2) for h in (H, Hkv, Hkv, H))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,T,causal,window", BWD_CASES)
@pytest.mark.parametrize("D", [32, 128, 256])
def test_flash_attention_bwd_kernels_match_plain(dev, dtype, B, H, Hkv, T,
                                                 causal, window, D):
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from repro_torch.kernels.ref import (flash_attention_bwd_dkv_ref,
                                         flash_attention_bwd_dq_ref,
                                         flash_attention_bwd_ref,
                                         flash_attention_ref)
    q, k, v, do = _bwd_inputs(dev, dtype, B, H, Hkv, T, D)
    o, lse = flash_attention_ref(q, k, v, causal=causal, window=window,
                                 return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    n_dkv = flash_attention_bwd_dkv.launches
    n_dq = flash_attention_bwd_dq.launches
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=causal,
                                     window=window)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal,
                                window=window)
    want_dk, want_dv = flash_attention_bwd_dkv_ref(
        q, k, v, do, lse, delta, causal=causal, window=window)
    want_dq = flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                         causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_bwd_dkv.launches == n_dkv + 1
    assert flash_attention_bwd_dq.launches == n_dq + 1
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        torch.testing.assert_close(got, want, atol=2e-4, rtol=0)
    grads = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                window=window)
    wants = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                    window=window)
    torch.cuda.synchronize()
    tol = (dict(atol=2e-4, rtol=0) if dtype == torch.float32
           else dict(atol=1e-2, rtol=1e-2))
    for got, want, primal in zip(grads, wants, (q, k, v)):
        assert got.dtype == primal.dtype
        torch.testing.assert_close(got.float(), want, **tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24)])
def test_autograd_site_matches_plain_autograd(dev, dtype, tol, causal,
                                              window):
    """CudaBackend.attention under autograd (FlashAttentionFn: the forward
    and both backward kernels) against autograd of the plain forward."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    g = torch.Generator(device=dev).manual_seed(3)
    B, T, H, Hkv, D = 4, 128, 32, 2, 128
    leaves = [torch.randn(B, T, h, D, generator=g, device=dev).to(dtype)
              for h in (H, Hkv, Hkv)]
    cot = torch.randn(B, T, H, D, generator=g, device=dev).to(dtype)
    grads = []
    for name in ("auto", "ref"):
        q, k, v = (t.clone().requires_grad_() for t in leaves)
        counts = (flash_attention.launches, flash_attention_bwd_dkv.launches,
                  flash_attention_bwd_dq.launches)
        out = dispatch.get_backend(name).attention(q, k, v, causal=causal,
                                                   window=window)
        out.backward(cot)
        torch.cuda.synchronize()
        launched = (flash_attention.launches - counts[0],
                    flash_attention_bwd_dkv.launches - counts[1],
                    flash_attention_bwd_dq.launches - counts[2])
        assert launched == ((1, 1, 1) if name == "auto" else (0, 0, 0))
        grads.append((out.float(), q.grad.float(), k.grad.float(),
                      v.grad.float()))
    for got, want in zip(*grads):
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=tol, rtol=0)
        else:
            assert (got - want).abs().max() <= tol * want.abs().max()


def test_train_step_on_the_card_matches_plain(dev):
    """Two eq1 steps of glm4-9b smoke (fp32) with the kernels against the
    plain versions: losses at 1e-5, params as chip_smoke.py holds them (at
    most 1 in 10^3 elements beyond 1e-6, none beyond lr; Adam turns a 1e-9
    gradient difference near g = 0 into an update difference up to lr)."""
    from repro_torch.config import (OptimizerConfig, SplitEEConfig,
                                    TrainConfig)
    from repro_torch.configs import glm4_9b
    from repro_torch.core.spmd import (StepConfig, boundary_ids_for_batch,
                                       make_train_step)
    from repro_torch.kernels.flash_attention import flash_attention_bwd_dq
    from repro_torch.models.backbone import init_backbone
    from repro_torch.optim import adam_init
    from repro_torch.tree import tree_leaves
    base = glm4_9b.smoke()
    profile = glm4_9b.profile().__class__((1, 1, 2, 2))
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.as_tensor(rng.integers(0, 512, (8, 16)),
                                          device=dev),
                "labels": torch.as_tensor(rng.integers(0, 512, (8, 16)),
                                          device=dev),
                "split_ids": boundary_ids_for_batch(profile, base, 8, dev)}
               for _ in range(2)]
    runs = []
    for kernels in ("auto", "ref"):
        cfg = base.with_(kernels=kernels)
        sc = StepConfig(model=cfg, splitee=SplitEEConfig(profile=profile),
                        train=TrainConfig(optimizer=OptimizerConfig(
                            total_steps=4)))
        params = init_backbone(torch.Generator(device=dev).manual_seed(0),
                               cfg)
        opt = adam_init(params, sc.train.optimizer)
        step = make_train_step(sc)
        n_dq = flash_attention_bwd_dq.launches
        for b in batches:
            params, opt, m = step(params, opt, b)
        # per eq1 step: the client pull reaches layers 0-1, the server
        # pull layers 1-3 (splits 1, 1, 2, 2): 5 backward launches
        launched = flash_attention_bwd_dq.launches - n_dq
        assert launched == (10 if kernels == "auto" else 0)
        runs.append((params, m))
    (p0, m0), (p1, m1) = runs
    for key in m0:
        assert abs(float(m0[key]) - float(m1[key])) <= 1e-5, key
    d = torch.cat([(a - b).abs().flatten() for a, b in
                   zip(tree_leaves(p0), tree_leaves(p1))])
    assert d.max().item() <= 1e-3
    assert (d > 1e-6).sum().item() <= 1e-3 * d.numel()


# ---------------------------------------------------------------------------
# RWKV6 wkv: forward and backward kernels, the autograd site, rwkv6 smoke
# ---------------------------------------------------------------------------

WKV_CASES = [
    # (B, T, H, K, chunk, log_w range (lo, hi): log_w ~ -U(lo, hi))
    (2, 128, 4, 64, 8, (0.05, 1.0)),       # the JAX tests' decays
    (2, 128, 4, 64, 64, (0.05, 1.0)),
    (2, 100, 4, 64, 32, (0.05, 1.0)),      # T not a chunk multiple
    (3, 19, 2, 32, 8, (0.05, 1.0)),        # head_dim 32, ragged
    (2, 16, 2, 16, 32, (0.05, 1.0)),       # chunk > T, head_dim 16
    (12, 70, 12, 32, 32, (0.05, 1.0)),     # B*H >= SMs at head_dim 32
    (1, 300, 40, 64, 128, (0.0025, 0.37)),  # prefill, value columns split
    (12, 512, 40, 64, 128, (0.0025, 0.37)),  # the training shape
]


def _wkv_inputs(dev, dtype, B, T, H, K, decay, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (torch.randn(B, T, H, K, generator=g, device=dev).to(dtype)
               for _ in range(3))
    lo, hi = decay
    log_w = -(lo + (hi - lo) * torch.rand(B, T, H, K, generator=g,
                                          device=dev))
    u = torch.randn(H, K, generator=g, device=dev)
    dy = torch.randn(B, T, H, K, generator=g, device=dev)
    dsT = torch.randn(B, H, K, K, generator=g, device=dev)
    return r, k, v, log_w, u, dy, dsT


def _scaled(got, want):
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp(min=1.0)).item()


def _wkv_counts():
    from repro_torch.kernels.rwkv_wkv import rwkv_wkv, rwkv_wkv_bwd
    return [rwkv_wkv.launches, rwkv_wkv_bwd.launches]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,K,chunk,decay", WKV_CASES)
def test_wkv_kernels_match_plain(dev, dtype, B, T, H, K, chunk, decay):
    """Each output against the plain version, over its largest magnitude:
    1e-4 forward, 5e-4 backward (reassociation and the factored
    exponentials against the TPU algebra's), 1e-2 for bf16 gradients (one
    bf16 rounding); the same bits on a second launch."""
    from repro_torch.kernels.rwkv_wkv import (rwkv_wkv_bwd,
                                              rwkv_wkv_bwd_plain,
                                              rwkv_wkv_fwd, rwkv_wkv_plain)
    r, k, v, lw, u, dy, dsT = _wkv_inputs(dev, dtype, B, T, H, K, decay)
    before = _wkv_counts()
    (y, sT), s0 = rwkv_wkv_fwd(r, k, v, lw, u, chunk=chunk)
    grads = rwkv_wkv_bwd(r, k, v, lw, u, s0, dy, dsT, chunk=chunk)
    after = _wkv_counts()
    ch = min(chunk, T)
    want_y, want_sT, want_s0 = rwkv_wkv_plain(r, k, v, lw, u, chunk=ch,
                                              emit_chunk_states=True)
    wants = rwkv_wkv_bwd_plain(r, k, v, lw, u, want_s0, dy, dsT, chunk=ch)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(after, before)] == [1, 1]
    for got, want in ((y, want_y), (sT, want_sT), (s0, want_s0)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert _scaled(got, want) <= 1e-4
    tol = 5e-4 if dtype == torch.float32 else 1e-2
    wants = (*wants[:4], wants[4].reshape(B, H, K).sum(0))
    for got, want, primal in zip(grads, wants, (r, k, v, lw, u)):
        assert got.dtype == primal.dtype and got.shape == primal.shape
        assert _scaled(got, want) <= tol
    (y2, sT2), s02 = rwkv_wkv_fwd(r, k, v, lw, u, chunk=chunk)
    grads2 = rwkv_wkv_bwd(r, k, v, lw, u, s0, dy, dsT, chunk=chunk)
    torch.cuda.synchronize()
    for a, b in zip((y, sT, s0, *grads), (y2, sT2, s02, *grads2)):
        assert torch.equal(a, b)


def test_wkv_kernels_take_decays_the_plain_chunked_form_cannot(dev):
    """log_w ~ -U(0.7, 1) at chunk 128: e^{-L} passes fp32's range in the
    TPU algebra; the kernels' exponents (all <= 0) match the token oracle
    and autograd through it."""
    from repro_torch.kernels.ref import rwkv_wkv_ref_model
    from repro_torch.kernels.rwkv_wkv import rwkv_wkv_bwd, rwkv_wkv_fwd
    r, k, v, lw, u, dy, dsT = _wkv_inputs(dev, torch.float32, 1, 256, 4, 64,
                                          (0.7, 1.0), seed=1)
    before = _wkv_counts()
    (y, sT), s0 = rwkv_wkv_fwd(r, k, v, lw, u, chunk=128)
    grads = rwkv_wkv_bwd(r, k, v, lw, u, s0, dy, dsT, chunk=128)
    assert [a - b for a, b in zip(_wkv_counts(), before)] == [1, 1]
    leaves = [t.clone().requires_grad_() for t in (r, k, v, lw, u)]
    want_y, want_sT = rwkv_wkv_ref_model(*leaves)
    wants = torch.autograd.grad((want_y * dy).sum() + (want_sT * dsT).sum(),
                                leaves)
    assert _scaled(y, want_y.detach()) <= 1e-4
    assert _scaled(sT, want_sT.detach()) <= 1e-4
    for got, want in zip(grads, wants):
        assert _scaled(got, want) <= 5e-4


def test_wkv_autograd_site_matches_plain_autograd(dev):
    """CudaBackend.wkv under autograd (WkvFn: both kernels) against
    autograd of the plain forward (models/ssm._wkv_chunked)."""
    from repro_torch.kernels import dispatch
    leaves = _wkv_inputs(dev, torch.float32, 2, 200, 8, 64, (0.0025, 0.37),
                         seed=2)
    res = []
    for name in ("auto", "ref"):
        xs = [t.clone().requires_grad_() for t in leaves[:5]]
        counts = _wkv_counts()
        y, sT = dispatch.get_backend(name).wkv(*xs, chunk=128)
        ((y * leaves[5]).sum() + (sT * leaves[6]).sum()).backward()
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(_wkv_counts(), counts)] == (
            [1, 1] if name == "auto" else [0, 0])
        res.append([y.detach(), sT.detach(), *(t.grad for t in xs)])
    for got, want in zip(*res):
        assert _scaled(got, want) <= 5e-4


def test_wkv_wrappers_reject_what_the_kernels_do_not_take(dev):
    from repro_torch.kernels.rwkv_wkv import rwkv_wkv
    x = torch.zeros(1, 8, 2, 48, device=dev)             # head_dim 48
    with pytest.raises(ValueError, match="head_dim"):
        rwkv_wkv(x, x, x, x, torch.zeros(2, 48, device=dev), chunk=4)
    x = torch.zeros(1, 8, 2, 64, device=dev)
    with pytest.raises(ValueError, match="float32"):
        rwkv_wkv(x, x, x, x.half(), torch.zeros(2, 64, device=dev), chunk=4)
    # the kernels walk any chunk in 16-token tiles: a chunk of 512 tokens
    # needs no more shared memory than one of 16
    long = (torch.zeros(1, 512, 2, 64, device=dev),) * 4
    y = rwkv_wkv(*long, torch.zeros(2, 64, device=dev), chunk=512)
    torch.cuda.synchronize()
    assert y.shape == long[0].shape and not y.any()


def test_rwkv_serve_session_and_train_step_on_the_card(dev):
    """rwkv6 smoke in fp32 on the card: the batched session equals the
    sequential oracle (prefill through the forward kernel), and two eq1
    steps with the kernels match the plain versions."""
    from repro_torch.api.serve_session import (ServeSession,
                                               sequential_reference)
    from repro_torch.config import (HeteroProfile, OptimizerConfig,
                                    SplitEEConfig, TrainConfig)
    from repro_torch.configs import rwkv6_3b
    from repro_torch.core.spmd import (StepConfig, boundary_ids_for_batch,
                                       make_train_step)
    from repro_torch.kernels.rwkv_wkv import rwkv_wkv, rwkv_wkv_bwd
    from repro_torch.models.backbone import init_backbone
    from repro_torch.optim import adam_init
    from repro_torch.tree import tree_leaves
    cfg = rwkv6_3b.smoke()
    params = init_backbone(torch.Generator(device=dev).manual_seed(0), cfg)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 20)))
               for _ in range(4)]
    sess = ServeSession(cfg, params, tau=2.0, slots=2, max_len=32)
    for p in prompts:
        sess.submit(p, decode_tokens=5)
    n_fwd = rwkv_wkv.launches
    got = {r.rid: r for r in sess.run()}
    assert rwkv_wkv.launches > n_fwd
    for rid, p in enumerate(prompts):
        ref = sequential_reference(cfg, params, p, 5, tau=2.0, max_len=32)
        assert (got[rid].tokens, got[rid].exited) == (ref.tokens, ref.exited)

    profile = HeteroProfile((1, 1, 2, 2))
    batches = [{"tokens": torch.as_tensor(rng.integers(0, 512, (8, 20)),
                                          device=dev),
                "labels": torch.as_tensor(rng.integers(0, 512, (8, 20)),
                                          device=dev),
                "split_ids": boundary_ids_for_batch(
                    profile, cfg.with_(exit_layers=(1, 2)), 8, dev)}
               for _ in range(2)]
    runs = []
    for kernels in ("auto", "ref"):
        c = cfg.with_(kernels=kernels, exit_layers=(1, 2))
        sc = StepConfig(model=c, splitee=SplitEEConfig(profile=profile),
                        train=TrainConfig(optimizer=OptimizerConfig(
                            total_steps=4)))
        p = init_backbone(torch.Generator(device=dev).manual_seed(0), c)
        opt = adam_init(p, sc.train.optimizer)
        step = make_train_step(sc)
        n_bwd = rwkv_wkv_bwd.launches
        for b in batches:
            p, opt, m = step(p, opt, b)
        assert (rwkv_wkv_bwd.launches > n_bwd) == (kernels == "auto")
        runs.append((p, m))
    (p0, m0), (p1, m1) = runs
    for key in m0:
        assert abs(float(m0[key]) - float(m1[key])) <= 1e-5, key
    d = torch.cat([(a - b).abs().flatten() for a, b in
                   zip(tree_leaves(p0), tree_leaves(p1))])
    assert d.max().item() <= 1e-3
    assert (d > 1e-6).sum().item() <= 1e-3 * d.numel()


# bf16 at full head width: the routes the fp32 head-dim-32 smokes never
# take, held to the limits of repro_torch/parity.py (chip_smoke.py's phase
# parity holds the same ones and shows each rejects a planted fault)


@pytest.mark.parametrize("family", ["glm4_9b", "phi3_medium_14b",
                                    "minitron_8b", "command_r_35b",
                                    "qwen3_moe_235b_a22b", "rwkv6_3b"])
def test_bf16_smoke_at_full_head_width_matches_plain(dev, family):
    """The attention families' smokes at head dim 64 (attention tile and
    decode routes; glm4-9b GQA 2, phi3 and minitron 4, command-r 8,
    qwen3-moe 2 with fp32 routers) and rwkv6 smoke at head dim 64, chunk
    16 (the wkv kernels), bf16, in the
    setup of chip_smoke.py's phase parity (whose readings set the limits):
    ServeSession with the kernels against each request served alone on the
    plain versions, the first eq1 step's gradients leaf by leaf, then
    three eq1 steps' losses."""
    from repro_torch import configs
    from repro_torch.api.serve_session import (ServeSession,
                                               sequential_reference)
    from repro_torch.config import (HeteroProfile, OptimizerConfig,
                                    SplitEEConfig, TrainConfig)
    from repro_torch.core.spmd import (StepConfig, make_grad_step,
                                       make_train_step)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd_dq)
    from repro_torch.kernels.rwkv_wkv import rwkv_wkv, rwkv_wkv_bwd
    from repro_torch.models.backbone import init_backbone
    from repro_torch.optim import adam_init
    from repro_torch.parity import (TOL_GRAD_BF16, TOL_H_BF16, TOL_LOSS_BF16,
                                    TRAIN_LR, TRAIN_PROFILE, TRAIN_STEPS,
                                    Routes, grad_rel_errors, live_rwkv,
                                    pinned_routes, smoke_batches,
                                    stream_parity)
    cfg = configs.get(family).smoke_bf16()
    if family != "rwkv6_3b":
        counts = lambda: (flash_attention.tile_launches,  # noqa: E731
                          flash_attention.decode_launches,
                          flash_attention.row_launches,
                          flash_attention_bwd_dq.tile_launches)
        ok = lambda n: n[0] > 0 and n[1] > 0 and n[2] == 0  # noqa: E731
        trained = lambda n: n[3] > 0  # noqa: E731
    else:
        counts = lambda: (rwkv_wkv.launches,  # noqa: E731
                          rwkv_wkv_bwd.launches)
        ok = lambda n: n[0] > 0  # noqa: E731
        trained = lambda n: n[1] > 0  # noqa: E731
    params = init_backbone(torch.Generator(device=dev).manual_seed(0), cfg)
    live_rwkv(params)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(12, 49)))
               for _ in range(6)]
    decodes = [6, 9, 4, 7, 5, 8]
    probe = ServeSession(cfg, params, tau=0.0, slots=1, max_len=64)
    probe.submit(prompts[0], decode_tokens=6)
    tau = float(np.median(probe.run()[0].entropy))
    sess = ServeSession(cfg, params, tau=tau, slots=3, max_len=64)
    for p, d in zip(prompts, decodes):
        sess.submit(p, decode_tokens=d)
    before = counts()
    got = {r.rid: r for r in sess.run()}
    assert ok([a - b for a, b in zip(counts(), before)])
    ref_cfg = cfg.with_(kernels="ref")
    before = counts()
    wants = [sequential_reference(ref_cfg, params, p, d, tau=tau, max_len=64)
             for p, d in zip(prompts, decodes)]
    assert counts() == before
    res = stream_parity(got, wants, tau)
    assert res.ok and res.max_dh <= TOL_H_BF16, res

    base = cfg.with_(exit_layers=(1, 2))
    batches = smoke_batches(base, device=dev)
    losses, grads = [], []
    # MoE: the kernels' run replays the plain run's routing (top-k is
    # discontinuous; parity.pinned_routes says why)
    routes = Routes()
    for kernels in ("ref", "auto"):
        c = base.with_(kernels=kernels)
        pin = (pinned_routes(routes, replay=kernels == "auto") if c.moe
               else contextlib.nullcontext())
        with pin:
            sc = StepConfig(model=c, splitee=SplitEEConfig(
                profile=HeteroProfile(TRAIN_PROFILE)),
                train=TrainConfig(optimizer=OptimizerConfig(
                    lr=TRAIN_LR, total_steps=2 * TRAIN_STEPS)))
            p = init_backbone(torch.Generator(device=dev).manual_seed(0), c)
            live_rwkv(p)
            before = counts()
            grads.append(make_grad_step(sc)(p, batches[0])[0])
            opt = adam_init(p, sc.train.optimizer)
            step = make_train_step(sc)
            ms = []
            for b in batches:
                p, opt, m = step(p, opt, b)
                ms.append([float(v) for k, v in sorted(m.items())
                           if k != "lr"])
        n = [a - b for a, b in zip(counts(), before)]
        assert (trained(n) if kernels == "auto" else not any(n))
        losses.append(np.asarray(ms))
    assert max(grad_rel_errors(grads[1], grads[0])) <= TOL_GRAD_BF16
    assert np.abs(losses[0] - losses[1]).max() <= TOL_LOSS_BF16[family]


@pytest.mark.parametrize("groups", [1, 8])
def test_moe_forward_on_the_card_is_deterministic_and_matches_the_cpu(
        dev, groups):
    """``models/moe.py`` on the qwen3 smoke's widths in fp32 at capacity
    factor 0.5 (experts overflow): two runs give the same bits, forward
    and gradients (no atomics in the dispatch or the combine); the
    experts chosen equal the CPU's, and the output, aux and gradients
    agree with the CPU's within 1e-5 of each tensor's largest magnitude
    (at least 1): fp32 with TF32 off, so reassociation only (an H100 read
    3.7e-5 absolute on one router-gradient element of ~0.15, summed over
    96 tokens in another order)."""
    import dataclasses

    from repro_torch.configs import qwen3_moe_235b_a22b
    from repro_torch.models import moe
    from repro_torch.tree import tree_leaves, tree_map
    base = qwen3_moe_235b_a22b.smoke()
    cfg = base.with_(moe=dataclasses.replace(base.moe, capacity_factor=0.5))
    params = moe.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(8, 12, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))

    def run(device):
        p = tree_map(lambda t: t.to(device).requires_grad_(True), params)
        xd = x.to(device).requires_grad_(True)
        out, aux = moe.moe_forward(p, xd, cfg, groups)
        (out.square().sum() + aux).backward()
        topi = moe.route(p, xd.detach().reshape(groups, -1, cfg.d_model),
                         cfg.moe)[0]
        return [out.detach(), aux.detach(), xd.grad,
                *(t.grad for t in tree_leaves(p))], topi

    a, topi = run(dev)
    b, _ = run(dev)
    want, topi_cpu = run("cpu")
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert torch.equal(topi.cpu(), topi_cpu)
    gaps = [float((got.cpu() - w).abs().max() / w.abs().max().clamp(min=1))
            for got, w in zip(a, want)]
    print(f"reading moe_forward card vs CPU, groups={groups}: largest "
          f"|d| / max(1, scale) over output, aux and gradients "
          f"{max(gaps):.2e}")
    assert max(gaps) <= 1e-5


@pytest.mark.parametrize("B,V", [(512, 10), (500, 10), (512, 100),
                                 (500, 100)])
def test_gate_at_the_evaluators_shapes_matches_plain(dev, B, V):
    """The Alg. 3 gate as the paper's evaluator calls it: fp32 client
    logits, a batch of 512 and the 500-row tail, 10 and 100 classes."""
    from repro_torch.kernels.entropy_exit import entropy_exit
    from repro_torch.kernels.ref import entropy_exit_ref
    from repro_torch.parity import gate_logits
    g = torch.Generator(device=dev).manual_seed(B + V)
    x = gate_logits(g, torch.float32, B, V)
    tau = 0.5 * float(np.log(V))
    before = entropy_exit.launches
    H, ex = entropy_exit(x, tau)
    H_ref, ex_ref = entropy_exit_ref(x, tau)
    assert entropy_exit.launches == before + 1
    assert float((H - H_ref).abs().max()) <= 1e-4
    far = (H_ref - tau).abs() > 1e-4
    assert torch.equal(ex[far], ex_ref[far])


@pytest.mark.parametrize("strategy", ["averaging", "sequential"])
def test_paper_session_on_the_card_matches_the_cpu(dev, strategy):
    """The ResNet smoke's TrainSession on the card against the same run on
    the CPU from one round-0 state (repro_torch/parity.py's setup and
    limits), and the CPU's final state evaluated on both devices: equal
    accuracies and client ratios, the gate kernel launched."""
    from repro_torch.kernels.entropy_exit import entropy_exit
    from repro_torch.parity import (PAPER_EPOCHS, PAPER_ROUNDS,
                                    TOL_PAPER_LOSS, TOL_PAPER_PARAMS,
                                    paper_data, paper_drift, paper_session)
    data, (x, y), augment = paper_data()
    cpu = paper_session("cpu", strategy, data, augment)
    start = cpu.state.clone()
    card = paper_session(dev, strategy, data, augment, state=start)
    for a, b in zip(card.run(PAPER_ROUNDS, PAPER_EPOCHS),
                    cpu.run(PAPER_ROUNDS, PAPER_EPOCHS)):
        assert abs(a.client_loss - b.client_loss) <= TOL_PAPER_LOSS
        assert abs(a.server_loss - b.server_loss) <= TOL_PAPER_LOSS
    drift = paper_drift(card.state, cpu.state, start)
    assert max(drift["clients"], drift["servers"]) <= TOL_PAPER_PARAMS
    same = paper_session(dev, strategy, data, augment, state=cpu.state)
    before = entropy_exit.launches
    assert same.evaluate(x, y) == cpu.evaluate(x, y)
    for tau in (1.0, 2.2):
        got = same.evaluate_adaptive(x, y, tau)
        want = cpu.evaluate_adaptive(x, y, tau)
        assert got["acc"] == want["acc"]
        assert got["client_ratio"] == want["client_ratio"]
        np.testing.assert_allclose(got["mean_entropy"], want["mean_entropy"],
                                   atol=1e-5, rtol=0)
    # 4 clients x (512 + 500 rows) x 3 evaluations
    assert entropy_exit.launches - before == 4 * 2 * 3


# ---------------------------------------------------------------------------
# the fused engine's lanes (repro_torch/parity.py's setups and limits)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("site", ["attention", "cross", "wkv"])
def test_lane_rules_match_per_lane_launches(dev, site):
    """Each training site's vmap rule launches each kernel once for all
    lanes, and equals a per-lane loop of plain launches: attention and
    cross attention (Tq != Tk, non-causal; lanes folded into the batch)
    bit for bit, the wkv (lanes folded into the heads, u per lane) within
    1e-4 of each output's scale."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from repro_torch.kernels.rwkv_wkv import rwkv_wkv, rwkv_wkv_bwd
    from repro_torch.parity import lane_loop_gaps, lane_sites
    fn, inputs = lane_sites(dev)[site]
    wrappers = ((flash_attention, flash_attention_bwd_dkv,
                 flash_attention_bwd_dq) if site != "wkv"
                else (rwkv_wkv, rwkv_wkv_bwd))
    before = [w.launches for w in wrappers]
    r = lane_loop_gaps(fn, inputs)
    torch.cuda.synchronize()
    lanes = len(inputs[0])
    assert [w.launches - b for w, b in zip(wrappers, before)] == \
        [1 + lanes] * len(wrappers)
    if site != "wkv":
        assert r["out"] == 0.0 and r["grad"] == 0.0, r
    else:
        assert max(r["out"] / max(1.0, r["out_scale"]),
                   r["grad"] / max(1.0, r["grad_scale"])) <= 1e-4, r


@pytest.mark.parametrize("family", ["glm4_9b", "rwkv6_3b",
                                    "qwen3_moe_235b_a22b"])
def test_fused_lanes_launch_the_backward_kernels(dev, family):
    """BackboneSplitModel's bf16 smoke on the fused engine: every cohort
    step launches each layer's forward and backward kernels once for all
    its lanes, and the losses stay within the family's bf16 limit of the
    same run on the plain versions."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from repro_torch.kernels.rwkv_wkv import rwkv_wkv, rwkv_wkv_bwd
    from repro_torch.parity import (LANE_ROUNDS, TOL_LOSS_BF16,
                                    backbone_session)
    wrappers = ((flash_attention, flash_attention_bwd_dkv,
                 flash_attention_bwd_dq) if family != "rwkv6_3b"
                else (rwkv_wkv, rwkv_wkv_bwd))
    sess = backbone_session(family, "auto", dev)
    plain = backbone_session(family, "ref", dev, state=sess.state.clone())
    assert sess.engine.name == "fused"
    before = [w.launches for w in wrappers]
    hist = sess.train(LANE_ROUNDS)
    torch.cuda.synchronize()
    cohorts = len(set(sess.ctx.profile.split_layers))
    per_round = sess.model.num_layers * cohorts
    assert [w.launches - b for w, b in zip(wrappers, before)] == \
        [LANE_ROUNDS * per_round] * len(wrappers)
    want = plain.train(LANE_ROUNDS)
    for a, b in zip(hist, want):
        assert abs(a.client_loss - b.client_loss) <= TOL_LOSS_BF16[family]
        assert abs(a.server_loss - b.server_loss) <= TOL_LOSS_BF16[family]


@pytest.mark.parametrize("grad_mode", ["eq1", "sum"])
def test_fused_paper_session_on_the_card_matches_the_cpu(dev, grad_mode):
    """The ResNet smoke on the fused engine (two lanes at cut 3), the card
    against the CPU from one round-0 state, at phase paper's limits; one
    host read of the losses per chunk."""
    from repro_torch.parity import (PAPER_EPOCHS, PAPER_ROUNDS,
                                    TOL_PAPER_LOSS, TOL_PAPER_PARAMS,
                                    paper_data, paper_drift, paper_session)
    data, _, augment = paper_data()
    cpu = paper_session("cpu", "averaging", data, augment, engine="fused",
                        grad_mode=grad_mode)
    start = cpu.state.clone()
    card = paper_session(dev, "averaging", data, augment, state=start,
                         engine="fused", grad_mode=grad_mode)
    for a, b in zip(card.run(PAPER_ROUNDS, PAPER_EPOCHS),
                    cpu.run(PAPER_ROUNDS, PAPER_EPOCHS)):
        assert abs(a.client_loss - b.client_loss) <= TOL_PAPER_LOSS
        assert abs(a.server_loss - b.server_loss) <= TOL_PAPER_LOSS
    drift = paper_drift(card.state, cpu.state, start)
    assert max(drift["clients"], drift["servers"]) <= TOL_PAPER_PARAMS
    eng = card.engine
    assert eng.last_host_syncs == eng.last_stage_stats["chunks"]


# ---------------------------------------------------------------------------
# client populations on the card
# ---------------------------------------------------------------------------


def test_lane_adam_matches_the_per_client_update_bit_for_bit(dev):
    """The stacked Adam with per-lane steps against the one-net update
    with a host step (both read their bias corrections from one table on
    the card), client by client: bit for bit, lanes at different steps; a
    masked lane keeps parameters, moments and step."""
    from repro_torch.config import OptimizerConfig
    from repro_torch.optim import AdamState, adam_init, adam_update
    cfg = OptimizerConfig(lr=1e-3)
    gen = torch.Generator(device=dev).manual_seed(0)
    k, shape = 3, (64, 33)
    p0 = [torch.randn(shape, generator=gen, device=dev) for _ in range(k)]
    grads = [[torch.randn(shape, generator=gen, device=dev)
              for _ in range(k)] for _ in range(6)]
    masks = [[1, 1, 1], [1, 0, 1], [0, 1, 1], [1, 1, 0], [1, 1, 1],
             [0, 0, 1]]
    ref = [{"w": p.clone()} for p in p0]
    ropt = [adam_init(r, cfg) for r in ref]
    st = {"w": torch.stack(p0)}
    so = AdamState(step=torch.zeros(k, dtype=torch.int32, device=dev),
                   m={"w": torch.zeros(k, *shape, device=dev)},
                   v={"w": torch.zeros(k, *shape, device=dev)})
    for g, m in zip(grads, masks):
        for j in range(k):
            if m[j]:
                ref[j], ropt[j] = adam_update(ref[j], {"w": g[j]}, ropt[j],
                                              cfg, 1e-3)
        st, so = adam_update(st, {"w": torch.stack(g)}, so, cfg, 1e-3,
                             lanes=True, mask=torch.tensor(
                                 m, dtype=torch.float32, device=dev))
    assert so.step.tolist() == [r.step for r in ropt]
    assert len(set(so.step.tolist())) > 1
    for j in range(k):
        assert torch.equal(st["w"][j], ref[j]["w"])
        assert torch.equal(so.m["w"][j], ropt[j].m["w"])
        assert torch.equal(so.v["w"][j], ropt[j].v["w"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_aggregation_all_ones_is_the_unmasked_one_on_the_card(
        dev, dtype):
    """The masked Eq. (1) with every lane active equals the unmasked one
    bit for bit on the card (the count's reciprocal as CUDA divides by a
    host count), and with none active leaves every lane alone."""
    from repro_torch.core.aggregation import (
        masked_stacked_cross_layer_aggregate, stacked_cross_layer_aggregate)
    lanes = {1: [0, 2, 4], 2: [1, 3]}
    gen = torch.Generator(device=dev).manual_seed(0)

    def nets():
        return {1: {"layer2": {"w": torch.randn(3, 8, 5, generator=gen,
                                                device=dev).to(dtype)},
                    "head": {"w": torch.randn(3, 4, generator=gen,
                                              device=dev).to(dtype)}},
                2: {"head": {"w": torch.randn(2, 4, generator=gen,
                                              device=dev).to(dtype)}}}

    a = nets()
    b = {li: {k: {"w": v["w"].clone()} for k, v in n.items()}
         for li, n in a.items()}
    c = {li: {k: {"w": v["w"].clone()} for k, v in n.items()}
         for li, n in a.items()}
    stacked_cross_layer_aggregate(a, lanes)
    ones = {li: torch.ones(len(v), device=dev) for li, v in lanes.items()}
    masked_stacked_cross_layer_aggregate(b, ones, lanes)
    zeros = {li: torch.zeros(len(v), device=dev) for li, v in lanes.items()}
    before = {li: {k: v["w"].clone() for k, v in n.items()}
              for li, n in c.items()}
    masked_stacked_cross_layer_aggregate(c, zeros, lanes)
    for li in a:
        for k in a[li]:
            assert torch.equal(a[li][k]["w"], b[li][k]["w"]), (li, k)
            assert torch.equal(c[li][k]["w"], before[li][k]), (li, k)


def test_population_smoke_on_the_card_matches_the_cpu(dev):
    """The churning population smoke (repro_torch/parity.py) on the card
    against the CPU from one round-0 state, at phase paper's limits, with
    the same active counts; one host read of the losses per chunk."""
    from repro_torch.parity import (PAPER_EPOCHS, POP_SMOKE_ROUNDS,
                                    TOL_PAPER_LOSS, TOL_PAPER_PARAMS,
                                    paper_drift, population_session,
                                    population_smoke_data)
    x, y = population_smoke_data()
    cpu = population_session("cpu", x, y)
    start = cpu.state.clone()
    card = population_session(dev, x, y, state=start)
    hc = card.train(POP_SMOKE_ROUNDS, PAPER_EPOCHS)
    hp = cpu.train(POP_SMOKE_ROUNDS, PAPER_EPOCHS)
    assert [m.active_clients for m in hc] == [m.active_clients for m in hp]
    for a, b in zip(hc, hp):
        assert abs(a.client_loss - b.client_loss) <= TOL_PAPER_LOSS
        assert abs(a.server_loss - b.server_loss) <= TOL_PAPER_LOSS
    drift = paper_drift(card.state, cpu.state, start)
    assert max(drift["clients"], drift["servers"]) <= TOL_PAPER_PARAMS
    eng = card.engine
    assert eng.last_host_syncs == eng.last_stage_stats["chunks"]


def test_population_smoke_float64_on_the_card_stays_on_the_cpu(dev):
    """The population smoke in float64 (model, data, Adam moments; Adam's
    arithmetic stays fp32, as JAX's) on the card against the CPU over
    twice phase lifecycle's rounds: in fp32 the two runs part further each
    round (the limits hold over POP_SMOKE_ROUNDS), in float64 they must
    stay together (an H100 read the drift at 2.7e-6 at most), so no fault
    of the card's population path hides behind fp32 rounding."""
    import dataclasses
    from repro_torch.api import TrainSession
    from repro_torch.config import (HeteroProfile, OptimizerConfig,
                                    SplitEEConfig)
    from repro_torch.configs import resnet18_cifar
    from repro_torch.core.splitee import ResNetSplitModel
    from repro_torch.parity import (PAPER_BATCH, PAPER_EPOCHS, PAPER_LR,
                                    PAPER_SPLITS, POP_SMOKE_ROUNDS,
                                    paper_drift, population_smoke,
                                    population_smoke_data)
    x, y = population_smoke_data()
    x = x.astype(np.float64)
    rounds = 2 * POP_SMOKE_ROUNDS

    def session(device, state=None):
        model = ResNetSplitModel(dataclasses.replace(
            resnet18_cifar.smoke(), dtype=torch.float64), device=device)
        return TrainSession(
            model, SplitEEConfig(profile=HeteroProfile(PAPER_SPLITS),
                                 aggregate_every=1),
            OptimizerConfig(lr=PAPER_LR, total_steps=rounds * PAPER_EPOCHS,
                            state_dtype=torch.float64),
            None, PAPER_BATCH, engine="fused",
            population=population_smoke(x, y),
            state=None if state is None else state.to(model.device))

    cpu = session("cpu")
    start = cpu.state.clone()
    card = session(dev, start)
    for r in range(rounds):
        (a,), (b,) = (card.train(1, PAPER_EPOCHS),
                      cpu.train(1, PAPER_EPOCHS))
        d = paper_drift(card.state, cpu.state, start)
        dl = max(abs(a.client_loss - b.client_loss),
                 abs(a.server_loss - b.server_loss))
        print(f"reading float64 population smoke round {r}, card vs CPU: "
              f"active {a.active_clients}, max|dloss| {dl:.2e}, drift "
              f"clients {d['clients']:.2e} servers {d['servers']:.2e}")
        assert a.active_clients == b.active_clients
        assert dl <= 1e-6 and max(d["clients"], d["servers"]) <= 1e-5

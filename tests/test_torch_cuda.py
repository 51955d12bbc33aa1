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
@pytest.mark.parametrize("V", [97, 2053, 151552])
def test_entropy_exit_kernel_matches_plain(dev, dtype, V):
    from repro_torch.kernels.entropy_exit import entropy_exit
    from repro_torch.kernels.ref import entropy_exit_ref
    g = torch.Generator(device=dev).manual_seed(1)
    x = (3 * torch.randn(8, V, generator=g, device=dev)).to(dtype)
    H0, _ = entropy_exit_ref(x, 0.0)
    tau = H0 + torch.tensor([-0.5, 0.5, -1e-4, 1e-4, -2e-3, 2e-3, -3, 3],
                            device=dev)
    before = entropy_exit.launches
    H, ex = entropy_exit(x, tau)
    H_ref, ex_ref = entropy_exit_ref(x, tau)
    torch.cuda.synchronize()
    assert entropy_exit.launches == before + 1
    torch.testing.assert_close(H, H_ref, atol=1e-4, rtol=0)
    far = (H_ref - tau).abs() > 1e-3
    assert torch.equal(ex[far], ex_ref[far])


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
@pytest.mark.parametrize("D", [32, 128])
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

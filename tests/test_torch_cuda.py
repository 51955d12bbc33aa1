"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips when no CUDA device is present (the check
runs inside the fixture, never at import).  On a machine with a card
(``--noconftest``: tests/conftest.py imports JAX, which that machine need
not have):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 attention 2e-5 and entropy 1e-4 (reassociation only);
bf16 attention outputs compared in fp32 at 2e-2 (the kernel and the plain
version round to bf16 at different points); gate decisions equal wherever
|H - tau| > 1e-3.
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

"""The port's RWKV6 path against the JAX package's, on the CPU.

Weights come from the JAX init through ``repro_torch.convert``; inputs are
seeded numpy.  At init the decay LoRA's ``w_lora_b`` and the bonus ``u``
are zero and ``w_base`` is -6, which would leave the data-dependent decay
and the bonus untested, so ``_live`` overwrites those leaves with seeded
values (w_lora_b ~ N(0, 0.1), u ~ N(0, 1), w_base ~ U(-2, 0)) in the numpy
tree both packages receive.  The JAX side runs its Pallas kernels in
interpret mode, or its ``ref`` backend, as its own tests do; on the CPU the
port's wrappers run their plain versions (the CUDA kernels are held against
those in tests/test_torch_cuda.py and chip_smoke.py).

Tolerances, fp32 throughout:
  * 1e-4 the plain forward (y, S_T, entry states) against the JAX forward
    (docs/ENGINES.md: the wkv kernel-level gate for y and the state);
  * 5e-4 abs + 1e-3 rel the plain backward against the JAX backward and
    against autograd of the token oracle (tests/test_kernels.py's gate);
  * 1e-4 abs + 1e-4 rel the autograd site against autograd of the ref
    backend (inside ENGINES.md's 5e-3 site-level gate: in fp32 the two
    differ by reassociation only);
  * 1e-5 modules, backbone, train-step losses and gradients (reassociation
    between the two frameworks only); tokens and gate decisions exact;
  * params after 2-3 Adam steps: at most 1 element in 10^4 off by more
    than 1e-6 and none by more than lr (see tests/test_torch_train.py).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as jconfig
from repro import configs as jconfigs
from repro.api.serve_session import ServeSession as JaxServeSession
from repro.core import spmd as jspmd
from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.models import backbone as jbackbone
from repro.models import blocks as jblocks
from repro.models import ssm as jssm
from repro.optim import adam as jadam
import repro_torch.config as tconfig
from repro_torch import configs as tconfigs
from repro_torch.api.serve_session import (ServeSession,
                                           sequential_reference,
                                           sequential_sticky_reference)
from repro_torch.convert import (adam_state_from_jax, config_from_jax,
                                 params_from_jax, to_tensor)
from repro_torch.core import spmd as tspmd
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import ref as kref
from repro_torch.kernels.rwkv_wkv import (rwkv_wkv, rwkv_wkv_bwd,
                                          rwkv_wkv_fwd)
from repro_torch.launch import e2e_train
from repro_torch.models import backbone as tbackbone
from repro_torch.models import blocks as tblocks
from repro_torch.models import ssm as tssm
from repro_torch.optim import adam as tadam
from repro_torch.tree import tree_leaves

ATOL = 1e-5
LR = 1e-3
PORT_SRC = Path(__file__).resolve().parents[1] / "src"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, atol=ATOL, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol)


def _live(tree, seed=0):
    """The numpy parameter tree with every rwkv6 mixer's ``w_lora_b``, ``u``
    and ``w_base`` redrawn from ``seed`` (stacked runs included)."""
    rng = np.random.default_rng(seed)
    draw = {"w_lora_b": lambda a: 0.1 * rng.standard_normal(a.shape),
            "u": lambda a: rng.standard_normal(a.shape),
            "w_base": lambda a: rng.uniform(-2.0, 0.0, a.shape)}

    def walk(t):
        if isinstance(t, dict):
            live = "w_lora_b" in t and "u" in t
            return {k: (draw[k](np.asarray(v)).astype(np.asarray(v).dtype)
                        if live and k in draw else walk(v))
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return t

    return walk(tree)


def _port_cache(jcache, cfg):
    """A JAX decode cache (per segment, per stacked run) as the port lays it
    out (per segment, per layer), numpy leaves -> CPU tensors."""
    out = []
    for seg, runs in zip(tbackbone.build_plan(cfg), jcache):
        layers = []
        for run, rc in zip(seg, runs):
            rc = _np(rc)
            layers.extend([_ttree(rc)] if run.length == 1 else
                          [_ttree(jax.tree.map(lambda a, i=i: a[i], rc))
                           for i in range(run.length)])
        out.append(layers)
    return out


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _ttree(tree):
    return jax.tree.map(lambda a: to_tensor(a, "cpu"), tree)


@pytest.fixture(scope="module")
def smoke_cfg():
    return jconfigs.get("rwkv6-3b").smoke()


@pytest.fixture(scope="module")
def smoke_params(smoke_cfg):
    """Live numpy params of rwkv6-3b smoke."""
    return _live(_np(jbackbone.init_backbone(jax.random.PRNGKey(0),
                                             smoke_cfg)))


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["config", "smoke"])
def test_rwkv6_config_matches_jax(which):
    j = getattr(jconfigs.get("rwkv6-3b"), which)()
    t = getattr(tconfigs.get("rwkv6-3b"), which)()
    assert t == config_from_jax(j)
    assert isinstance(t.ssm, tconfig.SSMConfig)
    assert t.segments() == j.segments()
    assert (tconfigs.get("rwkv6_3b").profile().split_layers
            == jconfigs.get("rwkv6_3b").profile().split_layers)


def test_config_from_jax_maps_the_ssm_config(tiny_rwkv):
    cfg = config_from_jax(tiny_rwkv)
    assert type(cfg.ssm) is tconfig.SSMConfig
    assert dataclasses.asdict(cfg.ssm) == dataclasses.asdict(tiny_rwkv.ssm)
    assert config_from_jax(jconfigs.get("glm4-9b").smoke()).ssm is None


# ---------------------------------------------------------------------------
# the wkv plain versions against the JAX kernels
# ---------------------------------------------------------------------------

WKV_CASES = [
    (2, 32, 2, 8, 8),
    (1, 19, 2, 8, 8),               # T not a chunk multiple (padding)
    (2, 48, 1, 16, 16),
    (1, 16, 2, 8, 32),              # chunk > T clamps to one chunk
]


def _wkv_inputs(seed, B, T, H, K):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, K)).astype(np.float32)
               for _ in range(3))
    lw = -rng.uniform(0.05, 1.0, (B, T, H, K)).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32)
    dy = rng.standard_normal((B, T, H, K)).astype(np.float32)
    dsT = rng.standard_normal((B, H, K, K)).astype(np.float32)
    return r, k, v, lw, u, dy, dsT


@pytest.mark.parametrize("B,T,H,K,chunk", WKV_CASES)
def test_wkv_plain_forward_matches_jax(B, T, H, K, chunk):
    r, k, v, lw, u, _, _ = _wkv_inputs(0, B, T, H, K)
    J = [jnp.asarray(a) for a in (r, k, v, lw, u)]
    (jy, jsT), js0 = jops.rwkv_wkv_fwd(*J, chunk=chunk, interpret=True)
    T_ = [torch.from_numpy(a) for a in (r, k, v, lw, u)]
    (y, sT), s0 = rwkv_wkv_fwd(*T_, chunk=chunk)
    assert y.dtype == sT.dtype == s0.dtype == torch.float32
    _close(y, jy, 1e-4)
    _close(sT, jsT, 1e-4)
    _close(s0, js0, 1e-4)
    jy2, jsT2 = jops.rwkv_wkv(*J, chunk=chunk, return_state=True,
                              interpret=True)
    y2, sT2 = rwkv_wkv(*T_, chunk=chunk, return_state=True)
    _close(y2, jy2, 1e-4)
    _close(sT2, jsT2, 1e-4)
    assert torch.equal(rwkv_wkv(*T_, chunk=chunk), y2)
    # the token oracle, both packages
    want_y, want_sT = kref.rwkv_wkv_ref_model(*T_)
    _close(y, want_y, 1e-4)
    _close(sT, want_sT, 1e-4)


@pytest.mark.parametrize("B,T,H,K,chunk", WKV_CASES)
def test_wkv_plain_backward_matches_jax_and_autograd(B, T, H, K, chunk):
    r, k, v, lw, u, dy, dsT = _wkv_inputs(1, B, T, H, K)
    J = [jnp.asarray(a) for a in (r, k, v, lw, u)]
    _, js0 = jops.rwkv_wkv_fwd(*J, chunk=chunk, interpret=True)
    want = jops.rwkv_wkv_bwd(*J, js0, jnp.asarray(dy), jnp.asarray(dsT),
                             chunk=chunk, interpret=True)
    T_ = [torch.from_numpy(a) for a in (r, k, v, lw, u)]
    tdy, tdsT = torch.from_numpy(dy), torch.from_numpy(dsT)
    _, s0 = rwkv_wkv_fwd(*T_, chunk=chunk)
    got = rwkv_wkv_bwd(*T_, s0, tdy, tdsT, chunk=chunk)
    leaves = [t.clone().requires_grad_() for t in T_]
    ry, rsT = kref.rwkv_wkv_ref_model(*leaves)
    auto = torch.autograd.grad((ry * tdy).sum() + (rsT * tdsT).sum(), leaves)
    for g, w, a, p in zip(got, want, auto, T_):
        assert g.dtype == p.dtype and g.shape == p.shape
        _close(g, w, 5e-4, 1e-3)
        _close(g, a, 5e-4, 1e-3)


def test_wkv_wrappers_check_shapes_and_cast_to_primal_dtypes():
    r, k, v, lw, u, dy, dsT = (torch.from_numpy(a)
                               for a in _wkv_inputs(2, 1, 12, 2, 8))
    rb, kb, vb = (t.to(torch.bfloat16) for t in (r, k, v))
    (y, sT), s0 = rwkv_wkv_fwd(rb, kb, vb, lw, u, chunk=4)
    assert y.dtype == torch.float32 and s0.shape == (2, 3, 8, 8)
    grads = rwkv_wkv_bwd(rb, kb, vb, lw, u, s0, dy, dsT, chunk=4)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3 + [
        torch.float32] * 2
    assert grads[4].shape == (2, 8)
    with pytest.raises(ValueError, match="rank-4"):
        rwkv_wkv(r[0], k[0], v[0], lw[0], u)
    with pytest.raises(ValueError, match="shape mismatch"):
        rwkv_wkv(r, k[:, :5], v, lw, u)
    with pytest.raises(ValueError, match="bonus"):
        rwkv_wkv(r, k, v, lw, u[:1])
    with pytest.raises(ValueError, match="residual"):
        rwkv_wkv_bwd(r, k, v, lw, u, s0[:, :2], dy, dsT, chunk=4)
    flat = torch.zeros(2, 12, 8)
    with pytest.raises(ValueError, match="multiple of chunk"):
        kref.rwkv_wkv_chunked_ref(flat, flat, flat, flat, flat[:, 0],
                                  chunk=5)
    meta = [t.to("meta") for t in (r, k, v, lw, u)]
    with pytest.raises(ValueError, match="unsupported device"):
        rwkv_wkv(*meta, chunk=4)


@pytest.mark.parametrize("B,T,H,K,chunk", [(2, 19, 2, 8, 8),
                                           (1, 24, 3, 16, 8)])
def test_wkv_autograd_site_matches_ref_backend(B, T, H, K, chunk):
    """CudaBackend.wkv on CPU tensors runs WkvFn (plain forward and
    backward); the ref backend differentiates models/ssm._wkv_chunked."""
    r, k, v, lw, u, dy, dsT = _wkv_inputs(3, B, T, H, K)
    res = []
    for name in ("auto", "ref"):
        xs = [torch.from_numpy(a).requires_grad_() for a in (r, k, v, lw, u)]
        y, sT = tdispatch.get_backend(name).wkv(*xs, chunk=chunk)
        if name == "auto":
            assert type(y.grad_fn).__name__ == "WkvFnBackward"
        ((y * torch.from_numpy(dy)).sum()
         + (sT * torch.from_numpy(dsT)).sum()).backward()
        res.append([y, sT, *(t.grad for t in xs)])
    for a, b in zip(*res):
        _close(a, b.detach(), 1e-4, 1e-4)
    # S_T unused: autograd hands WkvFn zeros for dsT
    xs = [torch.from_numpy(a).requires_grad_() for a in (r, k, v, lw, u)]
    y, _ = tdispatch.get_backend("auto").wkv(*xs, chunk=chunk)
    (y * torch.from_numpy(dy)).sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in xs)


def test_wkv_site_flops_match_jax(smoke_cfg):
    cfg = config_from_jax(smoke_cfg)
    for kind in ("train", "decode", "bwd"):
        assert (tdispatch.wkv_site_flops(cfg, 3, 20, kind)
                == jdispatch.wkv_site_flops(smoke_cfg, 3, 20, kind))
    assert tdispatch.wkv_site_flops(
        config_from_jax(jconfigs.get("glm4-9b").smoke()), 3, 20) == 0.0


@pytest.mark.parametrize("T, chunk", [(512, 128), (300, 128), (19, 8),
                                      (5, 8)])
def test_wkv_causal_flops_count_the_causal_pairs(T, chunk):
    """The causal count against a token-by-token tally: per token t of a
    chunk, t + 1 pairs (the bonus included) of scores and values over K
    channels and the state terms; the backward per the same tally."""
    B, H, K = 2, 3, 16
    fwd = bwd = 0
    for t in range(T):
        pairs = t % min(chunk, T) + 1
        fwd += 2 * pairs * K * 2 + 4 * K * K
        bwd += 2 * pairs * K * 5 + 8 * K * K
    assert tdispatch.wkv_causal_flops(B, T, H, K, chunk) == B * H * fwd
    assert tdispatch.wkv_causal_flops(B, T, H, K, chunk, "bwd") == B * H * bwd
    # whole chunks: B T H K (2 (Q + 1) + 4 K) forward, below the JAX count
    if T % chunk == 0:
        assert B * H * fwd == B * T * H * K * (2 * (chunk + 1) + 4 * K)
    with pytest.raises(ValueError, match="kind"):
        tdispatch.wkv_causal_flops(B, T, H, K, chunk, "train")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _mixer_params(jcfg, seed=1):
    p = _live(_np(jssm.init_rwkv6(jax.random.PRNGKey(seed), jcfg)), seed)
    return _jtree(p), _ttree(p)


@pytest.mark.parametrize("jkernels", ["ref", "pallas"])
def test_rwkv6_forward_matches_jax(tiny_rwkv, jkernels):
    """Train (no cache), prefill into a cache (T = 7, chunk 4: padded), and
    two decode ticks; the caches leaf by leaf, updated in place."""
    jcfg = tiny_rwkv.with_(kernels=jkernels)
    cfg = config_from_jax(jcfg)
    jp, tp = _mixer_params(jcfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)

    want, _ = jssm.rwkv6_forward(jp, jnp.asarray(x), jcfg)
    got, none = tssm.rwkv6_forward(tp, torch.from_numpy(x), cfg)
    assert none is None
    _close(got, want)

    jc = jssm.init_rwkv6_cache(jcfg, 2, jnp.float32)
    tc = tssm.init_rwkv6_cache(cfg, 2, torch.float32, "cpu")
    leaves = list(tc.values())
    want, jc = jssm.rwkv6_forward(jp, jnp.asarray(x), jcfg, cache=jc)
    got, tc = tssm.rwkv6_forward(tp, torch.from_numpy(x), cfg, cache=tc)
    _close(got, want)
    for _ in range(2):
        xd = rng.standard_normal((2, 1, 64)).astype(np.float32)
        want, jc = jssm.rwkv6_forward(jp, jnp.asarray(xd), jcfg, cache=jc)
        got, tc = tssm.rwkv6_forward(tp, torch.from_numpy(xd), cfg, cache=tc)
        _close(got, want)
        assert sorted(tc) == sorted(jc)
        for name in tc:
            _close(tc[name], jc[name])
    assert all(a is b for a, b in zip(tc.values(), leaves))   # in place


def test_rwkv_channel_mix_matches_jax(tiny_rwkv):
    cfg = config_from_jax(tiny_rwkv)
    p = _np(jssm.init_rwkv_cm(jax.random.PRNGKey(2), tiny_rwkv))
    rng = np.random.default_rng(5)
    p["mix"] = rng.uniform(0, 1, p["mix"].shape).astype(np.float32)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    last = rng.standard_normal((2, 1, 64)).astype(np.float32)
    for lt in (None, last):
        want = jssm.rwkv_cm_forward(_jtree(p), jnp.asarray(x), tiny_rwkv,
                                    last=None if lt is None
                                    else jnp.asarray(lt))
        got = tssm.rwkv_cm_forward(_ttree(p), torch.from_numpy(x), cfg,
                                   last=None if lt is None
                                   else torch.from_numpy(lt))
        _close(got, want)


def test_rwkv_block_matches_jax(tiny_rwkv):
    """block_forward: train, prefill into a cache, then two decode ticks;
    the block-level cm_last and the mixer's leaves match JAX's."""
    cfg = config_from_jax(tiny_rwkv)
    p = _live(_np(jblocks.init_block(jax.random.PRNGKey(3), tiny_rwkv,
                                     "rwkv6", "rwkv_cm")), 3)
    jp, tp = _jtree(p), _ttree(p)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    kw = dict(mixer="rwkv6", ffn="rwkv_cm")
    want, _, _ = jblocks.block_forward(jp, jnp.asarray(x), jnp.asarray(pos),
                                       tiny_rwkv, **kw)
    got, _, _ = tblocks.block_forward(tp, torch.from_numpy(x),
                                      torch.from_numpy(pos), cfg, **kw)
    _close(got, want)
    jc = jblocks.init_block_cache(tiny_rwkv, batch=2, max_len=16,
                                  dtype=jnp.float32, **kw)
    tc = tblocks.init_block_cache(cfg, batch=2, max_len=16,
                                  dtype=torch.float32, device="cpu", **kw)
    want, jc, _ = jblocks.block_forward(jp, jnp.asarray(x), jnp.asarray(pos),
                                        tiny_rwkv, cache=jc,
                                        cache_len=jnp.int32(0), **kw)
    got, tc, _ = tblocks.block_forward(
        tp, torch.from_numpy(x), torch.from_numpy(pos), cfg, cache=tc,
        cache_len=torch.zeros(2, dtype=torch.int32), **kw)
    _close(got, want)
    for t in range(2):
        xd = rng.standard_normal((2, 1, 64)).astype(np.float32)
        pd = np.full((2, 1), 6 + t, np.int32)
        want, jc, _ = jblocks.block_forward(
            jp, jnp.asarray(xd), jnp.asarray(pd), tiny_rwkv, cache=jc,
            cache_len=jnp.int32(6 + t), **kw)
        got, tc, _ = tblocks.block_forward(
            tp, torch.from_numpy(xd), torch.from_numpy(pd), cfg, cache=tc,
            cache_len=torch.full((2,), 6 + t, dtype=torch.int32), **kw)
        _close(got, want)
    got_l, want_l = list(tree_leaves(tc)), jax.tree.leaves(jc)
    assert len(got_l) == len(want_l) == 4
    for g, w in zip(got_l, want_l):
        _close(g, w)


# ---------------------------------------------------------------------------
# backbone and parameter conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fixture", ["tiny_rwkv", "smoke_cfg"])
def test_rwkv_backbone_logits_and_exits_match_jax(fixture, request):
    jcfg = request.getfixturevalue(fixture).with_(kernels="ref")
    cfg = config_from_jax(jcfg)
    p = _live(_np(jbackbone.init_backbone(jax.random.PRNGKey(0), jcfg)))
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 19))
    jo = jbackbone.backbone_forward(_jtree(p), jcfg, tokens=jnp.asarray(toks))
    to = tbackbone.backbone_forward(params_from_jax(p, cfg, device="cpu"),
                                    cfg, tokens=torch.from_numpy(toks))
    _close(to.logits, jo.logits)
    assert len(to.exit_logits) == len(jo.exit_logits) == len(jcfg.exit_layers)
    for got, want in zip(to.exit_logits, jo.exit_logits):
        _close(got, want)


def test_rwkv_backbone_prefill_then_decode_matches_jax(smoke_cfg,
                                                       smoke_params):
    jcfg = smoke_cfg.with_(kernels="pallas")
    cfg = config_from_jax(jcfg)
    jp = _jtree(smoke_params)
    tp = params_from_jax(smoke_params, cfg, device="cpu")
    prompt = np.random.default_rng(8).integers(0, jcfg.vocab_size, (1, 11))
    jc = jbackbone.init_cache(jcfg, 1, 16, jnp.float32)
    tc = tbackbone.init_cache(cfg, 1, 16, torch.float32, "cpu")
    jo = jbackbone.backbone_forward(jp, jcfg, tokens=jnp.asarray(prompt),
                                    cache=jc, cache_len=jnp.int32(0))
    to = tbackbone.backbone_forward(tp, cfg, tokens=torch.from_numpy(prompt),
                                    cache=tc,
                                    cache_len=torch.zeros(1, dtype=torch.int32))
    _close(to.logits, jo.logits)
    tok = np.array([[int(np.argmax(np.asarray(jo.logits)[0, -1]))]])
    jo2 = jbackbone.backbone_forward(jp, jcfg, tokens=jnp.asarray(tok),
                                     cache=jo.cache, cache_len=jnp.int32(11))
    to2 = tbackbone.backbone_forward(
        tp, cfg, tokens=torch.from_numpy(tok), cache=to.cache,
        cache_len=torch.full((1,), 11, dtype=torch.int32))
    _close(to2.logits, jo2.logits)
    _close(to2.exit_logits[0], jo2.exit_logits[0])
    want = _port_cache(jo2.cache, cfg)
    got_l, want_l = list(tree_leaves(to2.cache)), list(tree_leaves(want))
    assert len(got_l) == len(want_l) == 4 * cfg.num_layers
    for g, w in zip(got_l, want_l):
        _close(g, w)


def test_rwkv_port_init_has_the_converted_jax_layout(smoke_cfg):
    cfg = config_from_jax(smoke_cfg)
    conv = params_from_jax(_np(jbackbone.init_backbone(jax.random.PRNGKey(0),
                                                       smoke_cfg)),
                           cfg, device="cpu")
    own = tbackbone.init_backbone(torch.Generator().manual_seed(0), cfg)

    def shapes(tree):
        if isinstance(tree, torch.Tensor):
            return (tuple(tree.shape), tree.dtype)
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return [shapes(v) for v in tree]

    assert shapes(own) == shapes(conv)
    assert [len(s) for s in own["segments"]] == [2, 2]
    assert (shapes(tbackbone.init_cache(cfg, 2, 8, torch.float32, "cpu"))
            == shapes(_port_cache(jbackbone.init_cache(
                smoke_cfg, 2, 8, jnp.float32), cfg)))


def test_params_from_jax_carries_mixed_rwkv_leaves():
    """A bf16 rwkv6 config: fp32 w_base/u beside bf16 matrices, the (5, d)
    and (2, d) lerps unstacked from the (L, 5, d) / (L, 2, d) runs, and the
    Adam moments converted the same way."""
    jcfg = jconfigs.get("rwkv6-3b").smoke().with_(
        dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    cfg = config_from_jax(jcfg)
    jp = jbackbone.init_backbone(jax.random.PRNGKey(0), jcfg)
    stacked = jp["segments"][0][0]["mixer"]
    assert stacked["mix"].shape == (2, 5, 128)
    tp = params_from_jax(_np(jp), cfg, device="cpu")
    for li, layer in enumerate(tp["segments"][0]):
        mixer = layer["mixer"]
        assert mixer["mix"].shape == (5, 128)
        assert mixer["mix"].dtype == mixer["wr"].dtype == torch.bfloat16
        assert mixer["w_base"].dtype == mixer["u"].dtype == torch.float32
        assert mixer["u"].shape == (4, 32)
        assert layer["ffn"]["mix"].shape == (2, 128)
        np.testing.assert_array_equal(
            mixer["wr"].float().numpy(),
            np.asarray(stacked["wr"][li].astype(jnp.float32)))
    opt = jadam.adam_init(jp, jconfig.OptimizerConfig())
    st = adam_state_from_jax(_np(opt), cfg, device="cpu")
    assert st.m["segments"][1][1]["mixer"]["u"].dtype == torch.float32
    assert st.v["segments"][0][1]["ffn"]["mix"].shape == (2, 128)


# ---------------------------------------------------------------------------
# ServeSession against the JAX session
# ---------------------------------------------------------------------------


def _prompts(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 20)))
            for _ in range(n)]


def _serve_both(smoke_cfg, smoke_params, prompts, decodes, *, tau, slots,
                max_len, policy):
    cfg = config_from_jax(smoke_cfg)
    tp = params_from_jax(smoke_params, cfg, device="cpu")
    sess = ServeSession(cfg, tp, tau=tau, slots=slots, max_len=max_len,
                        exit_policy=policy, device="cpu")
    jsess = JaxServeSession(smoke_cfg, _jtree(smoke_params), tau=tau,
                            slots=slots, max_len=max_len, exit_policy=policy)
    for p, d in zip(prompts, decodes):
        sess.submit(p, decode_tokens=d)
        jsess.submit(p, decode_tokens=d)
    got = {r.rid: r for r in sess.run()}
    want = {r.rid: r for r in jsess.run()}
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for rid in got:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].exited == want[rid].exited, rid
        np.testing.assert_allclose(got[rid].entropy, want[rid].entropy,
                                   atol=1e-4)
    return cfg, tp, sess, got


def test_rwkv_serve_stream_matches_jax(smoke_cfg, smoke_params):
    """More requests than slots, prompts of 1-3 chunks (chunk 8), and the
    port's sequential oracle for every request."""
    prompts = _prompts(smoke_cfg, 5, seed=1)
    decodes = [5, 3, 6, 4, 2]
    cfg, tp, sess, got = _serve_both(smoke_cfg, smoke_params, prompts,
                                     decodes, tau=2.0, slots=2, max_len=32,
                                     policy="select")
    assert sess.stats.tokens == sum(decodes)
    for rid, (p, d) in enumerate(zip(prompts, decodes)):
        ref = sequential_reference(cfg, tp, p, d, tau=2.0, max_len=32,
                                   device="cpu")
        assert (ref.tokens, ref.exited) == (got[rid].tokens,
                                            got[rid].exited)


def test_rwkv_sticky_with_mid_stream_admission_matches_jax(smoke_cfg,
                                                           smoke_params):
    """Slots adopt, go client-only (server states left stale), and are
    dragged back into full ticks when a new request joins."""
    prompts = _prompts(smoke_cfg, 4, seed=9)
    decodes = [8, 2, 6, 5]
    cfg = config_from_jax(smoke_cfg)
    tp = params_from_jax(smoke_params, cfg, device="cpu")
    probe = sequential_reference(cfg, tp, prompts[0], 6, tau=0.0,
                                 max_len=32, device="cpu")
    tau = float(np.median(probe.entropy))
    _, _, sess, got = _serve_both(smoke_cfg, smoke_params, prompts, decodes,
                                  tau=tau, slots=2, max_len=32,
                                  policy="sticky")
    flags = [f for r in got.values() for f in r.exited]
    assert any(flags) and not all(flags)
    assert sess.stats.client_only_ticks > 0
    for rid, (p, d) in enumerate(zip(prompts, decodes)):
        ref = sequential_sticky_reference(cfg, tp, p, d, tau=tau,
                                          max_len=32, device="cpu")
        assert (ref.tokens, ref.exited) == (got[rid].tokens,
                                            got[rid].exited)


# ---------------------------------------------------------------------------
# train steps against JAX
# ---------------------------------------------------------------------------

SPLITS = (2, 2, 2, 2)


def _step_configs(jcfg, grad_mode, splits=SPLITS):
    opt_j = jconfig.OptimizerConfig(lr=LR, total_steps=10, warmup_steps=1)
    opt_t = tconfig.OptimizerConfig(lr=LR, total_steps=10, warmup_steps=1)
    jsc = jspmd.StepConfig(
        model=jcfg.with_(kernels="ref"),
        splitee=jconfig.SplitEEConfig(profile=jconfig.HeteroProfile(splits)),
        train=jconfig.TrainConfig(optimizer=opt_j), grad_mode=grad_mode)
    tsc = tspmd.StepConfig(
        model=config_from_jax(jcfg),
        splitee=tconfig.SplitEEConfig(profile=tconfig.HeteroProfile(splits)),
        train=tconfig.TrainConfig(optimizer=opt_t), grad_mode=grad_mode)
    return jsc, tsc


def _batches(jcfg, n, B=4, T=12, seed=7, splits=SPLITS):
    rng = np.random.default_rng(seed)
    sids = np.asarray(jspmd.boundary_ids_for_batch(
        jconfig.HeteroProfile(splits), jcfg, B))
    return [{"tokens": rng.integers(0, jcfg.vocab_size, (B, T)).astype(
                 np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (B, T)).astype(
                 np.int32),
             "split_ids": sids} for _ in range(n)]


def _tbatch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _close_params(got_tree, want_tree, cfg=None):
    want = (want_tree if cfg is None
            else params_from_jax(_np(want_tree), cfg, device="cpu"))
    d = torch.cat([(g.float() - w.float()).abs().flatten() for g, w in
                   zip(tree_leaves(got_tree), tree_leaves(want))])
    assert d.max().item() <= LR
    assert (d > 1e-6).sum().item() <= 1e-4 * d.numel()


@pytest.mark.parametrize("mode", ["eq1", "sum", "sequential"])
def test_rwkv_train_step_matches_jax(smoke_cfg, smoke_params, mode):
    sequential = mode == "sequential"
    jsc, tsc = _step_configs(smoke_cfg, "eq1" if sequential else mode)
    jp = _jtree(smoke_params)
    jo = jadam.adam_init(jp, jsc.train.optimizer)
    tp = params_from_jax(smoke_params, tsc.model, device="cpu")
    to = tadam.adam_init(tp, tsc.train.optimizer)
    jstep = jax.jit((jspmd.make_sequential_train_step if sequential
                     else jspmd.make_train_step)(jsc))
    tstep = (tspmd.make_sequential_train_step if sequential
             else tspmd.make_train_step)(tsc)
    for i, b in enumerate(_batches(smoke_cfg, 3)):
        jp, jo, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, b))
        tp, to, tm = tstep(tp, to, _tbatch(b))
        assert sorted(tm) == sorted(jm)
        for k in tm:
            _close(tm[k] if k != "lr" else np.float32(tm[k]), jm[k])
        if i == 0 and not sequential:
            # gradients: m = (1 - b1) g after the first update
            want = params_from_jax(_np(jo.m), tsc.model, device="cpu")
            for g, w in zip(tree_leaves(to.m), tree_leaves(want)):
                _close(g / 0.1, w / 0.1)
    assert to.step == int(jo.step)
    _close_params(tp, jp, tsc.model)


def test_rwkv_train_step_with_remat_equals_without(smoke_cfg, smoke_params):
    """remat checkpoints blocks that call WkvFn (the "auto" backend on the
    CPU); eq1's two pulls recompute them through two backward passes."""
    _, tsc = _step_configs(smoke_cfg, "eq1")
    rsc = dataclasses.replace(tsc, train=dataclasses.replace(
        tsc.train, remat="full"))
    runs = []
    for sc in (tsc, rsc):
        tp = params_from_jax(smoke_params, sc.model, device="cpu")
        to = tadam.adam_init(tp, sc.train.optimizer)
        step = tspmd.make_train_step(sc)
        for b in _batches(smoke_cfg, 2):
            tp, to, m = step(tp, to, _tbatch(b))
        runs.append((tp, to, m))
    (p0, o0, m0), (p1, o1, m1) = runs
    for k in m0:
        _close(torch.as_tensor(m1[k]), torch.as_tensor(m0[k]), 1e-6)
    for a, b in zip(tree_leaves(o0.m), tree_leaves(o1.m)):
        _close(a, b, 1e-7)
    _close_params(p1, p0)


def test_rwkv_adam_state_from_jax_continues_a_jax_run(smoke_cfg,
                                                      smoke_params):
    jsc, tsc = _step_configs(smoke_cfg, "eq1")
    jp = _jtree(smoke_params)
    jo = jadam.adam_init(jp, jsc.train.optimizer)
    jstep = jax.jit(jspmd.make_train_step(jsc))
    b1, b2, b3 = _batches(smoke_cfg, 3, seed=9)
    for b in (b1, b2):
        jp, jo, _ = jstep(jp, jo, jax.tree.map(jnp.asarray, b))
    tp = params_from_jax(_np(jp), tsc.model, device="cpu")
    to = adam_state_from_jax(_np(jo), tsc.model, device="cpu")
    assert to.step == 2
    jp3, jo3, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, b3))
    tp, to, tm = tspmd.make_train_step(tsc)(tp, to, _tbatch(b3))
    _close(tm["server_loss"], jm["server_loss"])
    want = params_from_jax(_np(jo3.m), tsc.model, device="cpu")
    for g, w in zip(tree_leaves(to.m), tree_leaves(want)):
        _close(g, w, 1e-6)
    _close_params(tp, jp3, tsc.model)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_e2e_train_runs_rwkv6_on_cpu(capsys):
    res = e2e_train.main(["--arch", "rwkv6-3b", "--smoke", "--layers", "4",
                          "--steps", "2", "--batch", "12", "--seq", "10",
                          "--remat", "--device", "cpu", "--log-every", "1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("model: rwkv6-3b-smoke 4L d=128")
    assert "exits=(1, 2, 3)" in out[0] and "remat=True" in out[0]
    assert sum(line.startswith("step ") for line in out) == 2
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    full, _ = e2e_train.cut_depth(tconfigs.get("rwkv6-3b").config(), 32)
    assert full.exit_layers == (8, 16, 24) and full.num_layers == 32


def test_serve_cli_runs_rwkv6_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(PORT_SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "rwkv6-3b", "--device", "cpu", "--requests", "3", "--slots", "2",
         "--prompt-len", "11", "--decode-tokens", "3"],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    lines = out.stdout.splitlines()
    assert lines[0].startswith("arch=rwkv6-3b-smoke tau=2.0 boundary=0")
    assert "served 3 requests / 9 decode tokens" in lines[1]

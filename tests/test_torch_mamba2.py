"""The port's Mamba2 mixer and Zamba2's shared attention block against the
JAX package's, on the CPU.

Weights come from the JAX init through ``repro_torch.convert``; inputs are
seeded numpy.  The Mamba2 init leaves ``dt_bias`` at 0 and ``D`` at 1; the
mixer tests redraw ``A_log``, ``dt_bias``, ``D`` and ``conv_b`` from a seed
(``_live``) in the numpy tree both packages receive, so every term runs
with values of its own.  The JAX side runs its ``ref`` backend (Mamba2 has
no Pallas kernel; the shared block's attention is held against the JAX
attention at ``kernels="ref"`` as tests/test_torch_models.py holds GQA).

Tolerances, fp32 throughout: 1e-5 modules, caches, train-step metrics and
gradients, and backbone logits 1e-5 of their largest magnitude (four
layers and a 128-wide head of reassociation between the two frameworks:
1.7e-5 at logits of ~4 on the smoke);
tokens and gate decisions exact; parameters after Adam steps as
tests/test_torch_train.py holds them; ``TrainSession`` states 1e-5 at lr
1e-5 (tests/test_torch_backbone_split.py says why that lr).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as jconfig
from repro import configs as jconfigs
from repro.api import TrainSession as JaxSession
from repro.api.serve_session import ServeSession as JaxServeSession
from repro.configs import zamba2_1p2b as jzamba
from repro.core import spmd as jspmd
from repro.core.backbone_splitee import BackboneSplitModel as JaxBackbone
from repro.models import backbone as jbackbone
from repro.models import blocks as jblocks
from repro.models import ssm as jssm
from repro.optim import adam as jadam
import repro_torch.config as tconfig
from repro_torch import configs as tconfigs
from repro_torch.api import TrainSession
from repro_torch.api.serve_session import (ServeSession,
                                           sequential_reference,
                                           sequential_sticky_reference)
from repro_torch.convert import (config_from_jax, params_from_jax,
                                 split_state_from_jax, to_tensor)
from repro_torch.core import spmd as tspmd
from repro_torch.core.backbone_splitee import BackboneSplitModel
from repro_torch.data.pipeline import ClientPartitioner
from repro_torch.data.synthetic import SyntheticSeqClsDataset
from repro_torch.launch import e2e_train
from repro_torch.models import backbone as tbackbone
from repro_torch.models import blocks as tblocks
from repro_torch.models import ssm as tssm
from repro_torch.optim import adam as tadam
from repro_torch.tree import tree_leaves

ATOL = 1e-5
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """At most two torch threads while this module runs (the suite's
    workers share the CPU; see tests/test_torch_backbone_split.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _ttree(tree):
    return jax.tree.map(lambda a: to_tensor(a, "cpu"), tree)


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=0)


def _close_logits(got, want):
    """1e-5 of the largest magnitude (at least 1)."""
    _close(got, want, ATOL * max(1.0, float(np.abs(np.asarray(want)).max())))


def _live(tree, seed=0):
    """The numpy tree with every Mamba2 mixer's ``A_log`` ~ log U(1, 16),
    ``dt_bias`` ~ N(0, 1), ``D`` ~ N(0, 1) and ``conv_b`` ~ N(0, 0.1)
    redrawn from ``seed`` (stacked runs included)."""
    rng = np.random.default_rng(seed)
    draw = {"A_log": lambda a: np.log(rng.uniform(1.0, 16.0, a.shape)),
            "dt_bias": lambda a: rng.standard_normal(a.shape),
            "D": lambda a: rng.standard_normal(a.shape),
            "conv_b": lambda a: 0.1 * rng.standard_normal(a.shape)}

    def walk(t):
        if isinstance(t, dict):
            live = "A_log" in t and "dt_bias" in t
            return {k: (draw[k](np.asarray(v)).astype(np.asarray(v).dtype)
                        if live and k in draw else walk(v))
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return t

    return walk(tree)


@pytest.fixture(scope="module")
def zamba():
    return jconfigs.get("zamba2-1.2b").smoke()


@pytest.fixture(scope="module")
def zamba_params(zamba):
    return _live(_np(jbackbone.init_backbone(jax.random.PRNGKey(0), zamba)))


def _both_sides():
    """Zamba2's smoke at 6 layers with the shared block at layers 2 and 5
    (every 3rd) and the exit at 3: one shared layer on each side of the
    cut, as the stock smoke (shared block at layer 2, exit 2) does not
    have."""
    blocks, ffns = jzamba._patterns(6, 3)
    return jzamba.smoke().with_(num_layers=6, block_pattern=blocks,
                                ffn_pattern=ffns, exit_layers=(3,))


# ---------------------------------------------------------------------------
# Mamba2 pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("history", [False, True])
def test_causal_conv_matches_jax(history):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    h = rng.standard_normal((2, 3, 12)).astype(np.float32) if history \
        else None
    want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             history=None if h is None else jnp.asarray(h))
    got = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b),
                            history=None if h is None
                            else torch.from_numpy(h))
    _close(got, want)


def _core_inputs(seed, B=2, T=19, H=3, P=4, S=5, big_decay=False):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, T, H, P)).astype(np.float32)
    Bm = rng.standard_normal((B, T, S)).astype(np.float32)
    Cm = rng.standard_normal((B, T, S)).astype(np.float32)
    dt = rng.uniform(0.1, 1.0, (B, T, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, H).astype(np.float32)
    if big_decay:
        # log decays of -100 and below a step: exp of any non-causal
        # (i > t) segment sum overflows fp32
        dt, A = dt * 20.0, A * 100.0
    D = rng.standard_normal(H).astype(np.float32)
    return xh, Bm, Cm, dt * A, dt, D


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_core_chunked_matches_jax(chunk):
    """T = 19: padded to a chunk multiple at 4 and 8; chunk 32 > T
    clamps to one chunk."""
    args = _core_inputs(1)
    wy, wh = jssm._mamba2_core_chunked(*map(jnp.asarray, args), chunk)
    gy, gh = tssm._mamba2_core_chunked(*map(torch.from_numpy, args), chunk)
    assert gh.dtype == torch.float32 and gy.shape == (2, 19, 3, 4)
    _close(gy, wy)
    _close(gh, wh)


def test_backward_finite_where_segment_sums_overflow():
    """The where-trap: the chunked form masks the segment sums before
    ``exp``; the non-causal entries overflow fp32 here, and the gradients
    stay finite and equal JAX's (the oracle of tests/
    test_backbone_session.py::test_mamba2_backward_stays_finite)."""
    args = _core_inputs(2, big_decay=True)
    # every off-causal segment sum exceeds one step's -log_a > 88
    assert float((-args[3]).min()) > 88.8
    rng = np.random.default_rng(3)
    gy = rng.standard_normal((2, 19, 3, 4)).astype(np.float32)
    gh = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)

    def jloss(xh, Bm, Cm, la, dt, D):
        y, h = jssm._mamba2_core_chunked(xh, Bm, Cm, la, dt, D, 8)
        return (y * gy).sum() + (h * gh).sum()

    want = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, h = tssm._mamba2_core_chunked(*leaves, 8)
    got = torch.autograd.grad((y * torch.from_numpy(gy)).sum()
                              + (h * torch.from_numpy(gh)).sum(), leaves)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g, w, 1e-4 * max(1.0, float(np.abs(w).max())))


# ---------------------------------------------------------------------------
# the mixer and the block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prompt", [7, 2])
def test_mamba2_forward_matches_jax(tiny_mamba, prompt):
    """Train (no cache), a prefill into a cache (7 tokens at chunk 4:
    padded; 2 tokens: shorter than the conv history), then two decode
    ticks; the caches leaf by leaf, updated in place."""
    cfg = config_from_jax(tiny_mamba)
    p = _live(_np(jssm.init_mamba2(jax.random.PRNGKey(1), tiny_mamba)), 1)
    jp, tp = _jtree(p), _ttree(p)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, prompt, 64)).astype(np.float32)

    want, _ = jssm.mamba2_forward(jp, jnp.asarray(x), tiny_mamba)
    got, none = tssm.mamba2_forward(tp, torch.from_numpy(x), cfg)
    assert none is None
    _close(got, want)

    jc = jssm.init_mamba2_cache(tiny_mamba, 2, jnp.float32)
    jc = {"conv": jnp.asarray(rng.standard_normal(jc["conv"].shape),
                              jnp.float32), "state": jc["state"]}
    tc = _ttree(_np(jc))
    leaves = list(tc.values())
    want, jc = jssm.mamba2_forward(jp, jnp.asarray(x), tiny_mamba, cache=jc)
    got, tc = tssm.mamba2_forward(tp, torch.from_numpy(x), cfg, cache=tc)
    _close(got, want)
    for _ in range(2):
        xd = rng.standard_normal((2, 1, 64)).astype(np.float32)
        want, jc = jssm.mamba2_forward(jp, jnp.asarray(xd), tiny_mamba,
                                       cache=jc)
        got, tc = tssm.mamba2_forward(tp, torch.from_numpy(xd), cfg,
                                      cache=tc)
        _close(got, want)
        assert sorted(tc) == sorted(jc)
        for name in tc:
            _close(tc[name], jc[name])
    assert all(a is b for a, b in zip(tc.values(), leaves))   # in place
    assert tc["state"].dtype == torch.float32


def test_mamba2_block_without_ffn_matches_jax(tiny_mamba):
    """``"none"`` FFN: no ``norm2``/``ffn`` leaves; block forward and
    cache as JAX's."""
    cfg = config_from_jax(tiny_mamba)
    p = _live(_np(jblocks.init_block(jax.random.PRNGKey(3), tiny_mamba,
                                     "mamba2", "none")), 3)
    assert sorted(p) == ["mixer", "norm1"]
    own = tblocks.init_block(cfg, "mamba2", "none", torch.Generator(), "cpu")
    assert sorted(own) == sorted(p)
    assert {k: tuple(v.shape) for k, v in own["mixer"].items()
            if k != "out_norm"} == {k: v.shape for k, v in p["mixer"].items()
                                    if k != "out_norm"}
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    kw = dict(mixer="mamba2", ffn="none")
    want, _, _ = jblocks.block_forward(_jtree(p), jnp.asarray(x),
                                       jnp.asarray(pos), tiny_mamba, **kw)
    got, _, aux = tblocks.block_forward(_ttree(p), torch.from_numpy(x),
                                        torch.from_numpy(pos), cfg, **kw)
    assert aux is None
    _close(got, want)
    jc = jblocks.init_block_cache(tiny_mamba, batch=2, max_len=8,
                                  dtype=jnp.float32, **kw)
    tc = tblocks.init_block_cache(cfg, batch=2, max_len=8,
                                  dtype=torch.float32, device="cpu", **kw)
    assert jax.tree.map(np.shape, jc) == jax.tree.map(
        lambda t: tuple(t.shape), tc)


def test_tiny_mamba_prefill_decode_roundtrip(tiny_mamba):
    """The port's own consistency, after tests/test_models.py: the full
    forward equals a prefill and two decode steps on the trailing tokens
    (2e-4, the JAX test's limit), and the prefill equals JAX's at 1e-5."""
    cfg = config_from_jax(tiny_mamba)
    p = _live(_np(jbackbone.init_backbone(jax.random.PRNGKey(0),
                                          tiny_mamba)))
    tp = params_from_jax(p, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 10)))
    full = tbackbone.backbone_forward(tp, cfg, tokens=toks)
    cache = tbackbone.init_cache(cfg, 2, 16, torch.float32, "cpu")
    pre = tbackbone.backbone_forward(tp, cfg, tokens=toks[:, :8],
                                     cache=cache,
                                     cache_len=torch.zeros(2, dtype=torch.int32))
    d1 = tbackbone.backbone_forward(tp, cfg, tokens=toks[:, 8:9], cache=cache,
                                    cache_len=torch.full((2,), 8))
    d2 = tbackbone.backbone_forward(tp, cfg, tokens=toks[:, 9:], cache=cache,
                                    cache_len=torch.full((2,), 9))
    _close(pre.logits, full.logits[:, :8], 2e-4)
    _close(d1.logits[:, 0], full.logits[:, 8], 2e-4)
    _close(d2.logits[:, 0], full.logits[:, 9], 2e-4)
    jo = jbackbone.backbone_forward(
        _jtree(p), tiny_mamba, tokens=jnp.asarray(toks.numpy()[:, :8]),
        cache=jbackbone.init_cache(tiny_mamba, 2, 16, jnp.float32),
        cache_len=jnp.int32(0))
    _close_logits(pre.logits, jo.logits)


# ---------------------------------------------------------------------------
# Zamba2: the shared block, the backbone, conversion
# ---------------------------------------------------------------------------


def test_shared_block_is_one_parameter_set(zamba, zamba_params):
    """One top-level ``shared_attn`` (an attention block with an MLP),
    ``{}`` in each shared layer's place, the same tree as the converted
    JAX init's, and one KV cache per shared layer."""
    cfg = config_from_jax(zamba)
    own = tbackbone.init_backbone(torch.Generator().manual_seed(0), cfg)
    conv = params_from_jax(zamba_params, cfg, device="cpu")

    def shapes(tree):
        if isinstance(tree, torch.Tensor):
            return (tuple(tree.shape), tree.dtype)
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return [shapes(v) for v in tree]

    assert shapes(own) == shapes(conv)
    assert sorted(own["shared_attn"]) == ["ffn", "mixer", "norm1", "norm2"]
    assert own["segments"][1][0] == {} and conv["segments"][1][0] == {}
    assert tbackbone.segment_layers(cfg, 1) == [("shared_attn", "mlp"),
                                               ("mamba2", "none")]
    cache = tbackbone.init_cache(cfg, 2, 8, torch.float32, "cpu")
    assert sorted(cache[1][0]["mixer"]) == ["k", "v"]
    two = tbackbone.init_cache(config_from_jax(_both_sides()), 1, 8,
                               torch.float32, "cpu")
    kv = [c["mixer"]["k"] for seg in two for c in seg if "k" in c["mixer"]]
    assert len(kv) == 2 and kv[0].data_ptr() != kv[1].data_ptr()


def test_zamba2_backbone_matches_jax():
    """The both-sides config (a shared layer in each segment): logits and
    exits; a prefill into the cache and two decode ticks, every cache leaf
    (each shared layer's own KV pages, the Mamba2 conv and state) against
    JAX's, 1e-5 of each leaf's largest magnitude."""
    jcfg = _both_sides()
    p = _live(_np(jbackbone.init_backbone(jax.random.PRNGKey(1), jcfg)))
    cfg = config_from_jax(jcfg)
    jp, tp = _jtree(p), params_from_jax(p, cfg, device="cpu")
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 19))
    jo = jbackbone.backbone_forward(jp, jcfg, tokens=jnp.asarray(toks))
    to = tbackbone.backbone_forward(tp, cfg, tokens=torch.from_numpy(toks))
    _close_logits(to.logits, jo.logits)
    for got, want in zip(to.exit_logits, jo.exit_logits, strict=True):
        _close_logits(got, want)

    prompt = toks[:1, :11]
    jo = jbackbone.backbone_forward(
        jp, jcfg, tokens=jnp.asarray(prompt),
        cache=jbackbone.init_cache(jcfg, 1, 16, jnp.float32),
        cache_len=jnp.int32(0))
    tc = tbackbone.init_cache(cfg, 1, 16, torch.float32, "cpu")
    to = tbackbone.backbone_forward(tp, cfg, tokens=torch.from_numpy(prompt),
                                    cache=tc,
                                    cache_len=torch.zeros(1, dtype=torch.int32))
    _close_logits(to.logits, jo.logits)
    jcache = jo.cache
    for t in range(2):
        tok = np.array([[int(np.argmax(np.asarray(jo.logits)[0, -1]))]])
        jo = jbackbone.backbone_forward(jp, jcfg, tokens=jnp.asarray(tok),
                                        cache=jcache,
                                        cache_len=jnp.int32(11 + t))
        jcache = jo.cache
        to = tbackbone.backbone_forward(
            tp, cfg, tokens=torch.from_numpy(tok), cache=tc,
            cache_len=torch.full((1,), 11 + t, dtype=torch.int32))
        _close_logits(to.logits, jo.logits)
        _close_logits(to.exit_logits[0], jo.exit_logits[0])
    # JAX's cache: per segment, per run (no stacked run holds a shared
    # layer; the Mamba2 runs stack), the port's per layer
    want = []
    for seg, runs in zip(tbackbone.build_plan(cfg), jcache):
        layers = []
        for run, rc in zip(seg, runs):
            rc = _np(rc)
            layers.extend([rc] if run.length == 1 else
                          [jax.tree.map(lambda a, i=i: a[i], rc)
                           for i in range(run.length)])
        want.append(layers)
    got_l, want_l = list(tree_leaves(tc)), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        _close_logits(g, w)


def test_params_from_jax_takes_the_shared_block(zamba, zamba_params):
    cfg = config_from_jax(zamba)
    tp = params_from_jax(zamba_params, cfg, device="cpu")
    for name in ("wq", "wk", "wv", "wo"):
        np.testing.assert_array_equal(
            tp["shared_attn"]["mixer"][name].numpy(),
            zamba_params["shared_attn"]["mixer"][name])
    # a frontend projector beside the shared block is carried leaf for leaf
    w = np.random.default_rng(0).standard_normal(
        (768, cfg.d_model)).astype(np.float32)
    tp = params_from_jax({**zamba_params, "frontend": {"w": w}}, cfg,
                         device="cpu")
    np.testing.assert_array_equal(tp["frontend"]["w"].numpy(), w)
    assert tp["frontend"]["w"].dtype == torch.float32


@pytest.mark.parametrize("splits", [(2, 2, 2, 2), (3, 3, 3, 3)])
def test_participation_scales_match_jax(splits):
    """1/N on both families for the shared block, ``{}`` for its
    placeholders, the per-layer scales elsewhere: the JAX trees', layer
    by layer."""
    jcfg = _both_sides() if splits[0] == 3 else jzamba.smoke()
    cfg = config_from_jax(jcfg)
    jp = jbackbone.init_backbone(jax.random.PRNGKey(0), jcfg)
    jcs, jss = jspmd.participation_scale_trees(
        jp, jcfg, jconfig.HeteroProfile(splits))
    tp = params_from_jax(_np(jp), cfg, device="cpu")
    tcs, tss = tspmd.participation_scale_trees(
        tp, cfg, tconfig.HeteroProfile(splits))
    for got, want in ((tcs, jcs), (tss, jss)):
        want = params_from_jax(jax.tree.map(
            lambda s, a: np.broadcast_to(np.asarray(s), np.shape(a)).copy(),
            want, jp), cfg, device="cpu")
        assert sorted(got) == sorted(want)
        assert got["shared_attn"]["mixer"]["wq"] == 1 / len(splits)
        for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True):
            assert np.all(w.numpy() == g), (g, w)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _prompts(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(2, 20)))
            for _ in range(n)]


@pytest.mark.parametrize("policy", ["select", "sticky"])
def test_zamba2_serve_matches_jax(policy, zamba, zamba_params):
    """5 requests on 2 slots, prompts of 2-19 tokens (1-3 chunks of 8, some
    shorter than the conv history), tokens and gate decisions equal to the
    JAX session's, entropies 1e-4; each stream equals the port's
    sequential reference."""
    cfg = config_from_jax(zamba)
    tp = params_from_jax(zamba_params, cfg, device="cpu")
    prompts = _prompts(zamba, 5, seed=1)
    decodes = [6, 3, 7, 4, 5]
    probe = sequential_reference(cfg, tp, prompts[0], 6, tau=0.0,
                                 max_len=32, device="cpu")
    tau = float(np.median(probe.entropy))
    sess = ServeSession(cfg, tp, tau=tau, slots=2, max_len=32,
                        exit_policy=policy, device="cpu")
    jsess = JaxServeSession(zamba, _jtree(zamba_params), tau=tau, slots=2,
                            max_len=32, exit_policy=policy)
    for p, d in zip(prompts, decodes):
        sess.submit(p, decode_tokens=d)
        jsess.submit(p, decode_tokens=d)
    got = {r.rid: r for r in sess.run()}
    want = {r.rid: r for r in jsess.run()}
    assert sorted(got) == sorted(want) == list(range(5))
    ref_fn = (sequential_sticky_reference if policy == "sticky"
              else sequential_reference)
    flags = []
    for rid, (p, d) in enumerate(zip(prompts, decodes)):
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].exited == want[rid].exited, rid
        np.testing.assert_allclose(got[rid].entropy, want[rid].entropy,
                                   atol=1e-4)
        ref = ref_fn(cfg, tp, p, d, tau=tau, max_len=32, device="cpu")
        assert (ref.tokens, ref.exited) == (got[rid].tokens,
                                            got[rid].exited)
        flags += got[rid].exited
    assert any(flags)
    if policy == "sticky":
        assert sess.stats.client_only_ticks > 0
    else:
        assert not all(flags)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["eq1", "sum"])
def test_zamba2_train_step_matches_jax(mode):
    """eq1 and sum steps on the both-sides config (clients cut at 3, the
    shared block reached by both families): every metric 1e-5, the first
    step's gradients (Adam's first moments / 0.1) 1e-5, parameters after 3
    steps; remat leaves the step unchanged."""
    jcfg = _both_sides()
    splits = (3, 3, 3, 3)
    p = _live(_np(jbackbone.init_backbone(jax.random.PRNGKey(2), jcfg)))
    opt_j = jconfig.OptimizerConfig(lr=LR, total_steps=10, warmup_steps=1)
    opt_t = tconfig.OptimizerConfig(lr=LR, total_steps=10, warmup_steps=1)
    jsc = jspmd.StepConfig(
        model=jcfg.with_(kernels="ref"),
        splitee=jconfig.SplitEEConfig(profile=jconfig.HeteroProfile(splits)),
        train=jconfig.TrainConfig(optimizer=opt_j), grad_mode=mode)
    tsc = tspmd.StepConfig(
        model=config_from_jax(jcfg),
        splitee=tconfig.SplitEEConfig(profile=tconfig.HeteroProfile(splits)),
        train=tconfig.TrainConfig(optimizer=opt_t), grad_mode=mode)
    rsc = dataclasses.replace(tsc, train=dataclasses.replace(
        tsc.train, remat="full"))
    jp = _jtree(p)
    jo = jadam.adam_init(jp, opt_j)
    runs = [params_from_jax(p, tsc.model, device="cpu") for _ in range(2)]
    opts = [tadam.adam_init(t, opt_t) for t in runs]
    jstep = jax.jit(jspmd.make_train_step(jsc))
    steps = [tspmd.make_train_step(tsc), tspmd.make_train_step(rsc)]
    rng = np.random.default_rng(7)
    sids = np.asarray(jspmd.boundary_ids_for_batch(
        jconfig.HeteroProfile(splits), jcfg, 4))
    for i in range(3):
        b = {"tokens": rng.integers(0, jcfg.vocab_size, (4, 12)).astype(
                 np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (4, 12)).astype(
                 np.int32),
             "split_ids": sids}
        jp, jo, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, b))
        tb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
        for r in range(2):
            runs[r], opts[r], tm = steps[r](runs[r], opts[r], tb)
            assert sorted(tm) == sorted(jm)
            for k in tm:
                _close(tm[k] if k != "lr" else np.float32(tm[k]), jm[k])
        if i == 0:
            want = params_from_jax(_np(jo.m), tsc.model, device="cpu")
            for g, w in zip(tree_leaves(opts[0].m), tree_leaves(want),
                            strict=True):
                _close(g / 0.1, w / 0.1)
            assert float(opts[0].m["shared_attn"]["mixer"]["wq"].abs()
                         .max()) > 0
    want = params_from_jax(_np(jp), tsc.model, device="cpu")
    for tp in runs:
        d = torch.cat([(g - w).abs().flatten() for g, w in
                       zip(tree_leaves(tp), tree_leaves(want), strict=True)])
        assert d.max().item() <= LR
        assert (d > 1e-6).sum().item() <= 1e-4 * d.numel()


def _parts(cfg, n):
    ds = SyntheticSeqClsDataset(vocab_size=cfg.vocab_size, seq_len=8,
                                num_classes=8, train_size=96, test_size=16,
                                seed=0)
    return ClientPartitioner(n).split(*ds.train)


def test_split_model_copies_the_shared_block_to_both_sides():
    tm = BackboneSplitModel(config_from_jax(_both_sides()), device="cpu")
    c, s = tm.make_client(3), tm.make_server(3)
    assert set(c["trainable"]) == {"embed", "segments", "out",
                                   "shared_attn"}
    assert set(s["trainable"]) == {"seg1", "head", "shared_attn"}
    assert c["trainable"]["segments"][0][2] == {}
    assert s["trainable"]["seg1"][2] == {}
    ptrs = [t.data_ptr() for n in (c, s) for t in tree_leaves(n)]
    assert len(ptrs) == len(set(ptrs))
    for a, b in zip(tree_leaves(c["trainable"]["shared_attn"]),
                    tree_leaves(s["trainable"]["shared_attn"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("engine", ["reference", "fused"])
def test_zamba2_train_session_matches_jax(engine):
    """``TrainSession`` Averaging on the both-sides config: clients cut at
    3 (two) and the JAX engine of the same name, from one round-0 state;
    every element of the nets and the Adam moments and the per-round
    losses 1e-5 at lr 1e-5.  Each server holds its own copy of the shared
    block, which Eq. (1) averages as any key the servers share."""
    jcfg = _both_sides()
    tm = BackboneSplitModel(config_from_jax(jcfg), device="cpu")
    splits = (3, 3)
    parts = _parts(tm.cfg, len(splits))
    js = JaxSession.from_config(
        JaxBackbone(jcfg, seed=0),
        jconfig.SplitEEConfig(profile=jconfig.HeteroProfile(splits),
                              strategy="averaging", aggregate_every=1),
        jconfig.OptimizerConfig(lr=1e-5, total_steps=64), parts, 16,
        engine=engine)
    start = split_state_from_jax(js.state, tm)
    js.train(2)
    ts = TrainSession(
        tm, tconfig.SplitEEConfig(profile=tconfig.HeteroProfile(splits),
                                  strategy="averaging", aggregate_every=1),
        tconfig.OptimizerConfig(lr=1e-5, total_steps=64), parts, 16,
        engine=engine, state=start)
    ts.train(2)
    want = split_state_from_jax(js.state, tm)

    def flat(s):
        return [s.clients, s.servers,
                [(o.m, o.v) for o in s.client_opts + s.server_opts]]

    gap = max(float((x.double() - y.double()).abs().max())
              for x, y in zip(tree_leaves(flat(ts.state)),
                              tree_leaves(flat(want)), strict=True))
    dl = max(max(abs(a.client_loss - b.client_loss),
                 abs(a.server_loss - b.server_loss))
             for a, b in zip(ts.history, js.history))
    print(f"reading zamba2 both-sides {engine} vs JAX: state {gap:.2e}, "
          f"losses {dl:.2e}")
    assert max(gap, dl) <= ATOL
    s0, s1 = (srv["trainable"]["shared_attn"] for srv in ts.state.servers)
    for a, b in zip(tree_leaves(s0), tree_leaves(s1)):
        assert torch.equal(a, b)                       # averaged by Eq. (1)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_configs_resolve_and_e2e_trains_zamba2_at_full_depth(capsys):
    """``configs.get`` takes the dash id; ``e2e_train --layers 0`` trains
    the config's own depth and exits (4 client groups at each exit), not
    ``cut_depth``'s (which would put zamba2-1.2b's exits at 9, 19, 28)."""
    mod = tconfigs.get("zamba2-1.2b")
    cfg, profile = e2e_train.full_depth(mod.config())
    assert cfg.exit_layers == (10, 20, 29) and cfg.num_layers == 38
    assert profile.split_layers == mod.profile().split_layers
    assert e2e_train.cut_depth(mod.config(), 38)[0].exit_layers == (9, 19,
                                                                      28)
    res = e2e_train.main(["--arch", "zamba2-1.2b", "--smoke", "--layers",
                          "0", "--steps", "2", "--batch", "4", "--seq", "10",
                          "--remat", "--device", "cpu", "--log-every", "1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("model: zamba2-1.2b-smoke 4L d=128")
    assert "exits=(2,)" in out[0]
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()

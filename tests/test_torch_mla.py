"""The port's multi-head latent attention (MLA) and the DeepSeek-V3 config
against the JAX package's, on the CPU.

Weights come from the JAX init through ``repro_torch.convert``; inputs are
seeded numpy; fp32 throughout.  Limits: 1e-5 the mixer's outputs and
caches; its gradients and backbone logits 1e-5 of each tensor's largest
magnitude (reassociation over four layers and the head); tokens and gate decisions
exact; eq1 metrics 1e-5 and parameters after Adam steps as
tests/test_torch_train.py holds them; ``TrainSession`` states 1e-5 at lr
1e-5 (tests/test_torch_backbone_split.py says why that lr).

The JAX ``mla_forward`` takes its weight-absorbed decode branch whenever a
cache is passed, a prefill included, and masks that branch with
``arange(W) < min(cache_len + 1, W)``: every prompt token of a prefill
sees key slot 0 only.  The port computes the causal prefill, equal to the
cache-free forward, and does not mirror that; the JAX session is correct
on 1-token prompts, so the port's session is held to it there and to its
own sequential reference on longer prompts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as jconfig
from repro import configs as jconfigs
from repro.api import TrainSession as JaxSession
from repro.api.serve_session import ServeSession as JaxServeSession
from repro.core import spmd as jspmd
from repro.core.backbone_splitee import BackboneSplitModel as JaxBackbone
from repro.models import attention as jattn
from repro.models import backbone as jbackbone
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
from repro_torch.models import attention as tattn
from repro_torch.models import backbone as tbackbone
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


@pytest.fixture(scope="module")
def deepseek():
    return jconfigs.get("deepseek-v3-671b").smoke()


@pytest.fixture(scope="module")
def weights(deepseek):
    jp = jbackbone.init_backbone(jax.random.PRNGKey(0), deepseek)
    return jp, params_from_jax(_np(jp), config_from_jax(deepseek),
                               device="cpu")


@pytest.fixture(scope="module")
def mixer(deepseek):
    p = _np(jattn.init_mla(jax.random.PRNGKey(1), deepseek))
    # the norms' gains away from 1, so the latent norms are exercised
    rng = np.random.default_rng(1)
    for k in ("q_norm", "kv_norm"):
        p[k] = {"scale": rng.uniform(0.5, 1.5, p[k]["scale"].shape)
                .astype(np.float32)}
    return _jtree(p), _ttree(p)


def _x(T, B=2, seed=0, d=128):
    return np.random.default_rng(seed).standard_normal((B, T, d)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 5])
def test_mla_forward_matches_jax(deepseek, mixer, window):
    jcfg = deepseek.with_(sliding_window=window)
    jp, tp = mixer
    x = _x(11)
    want, _ = jattn.mla_forward(jp, jnp.asarray(x), jnp.arange(11), jcfg)
    got, none = tattn.mla_forward(tp, torch.from_numpy(x),
                                  torch.arange(11)[None],
                                  config_from_jax(jcfg))
    assert none is None
    _close(got, want)


def test_mla_decode_matches_jax_on_the_same_cache(deepseek, mixer):
    """The weight-absorbed step on a cache of random latents: each row at
    its own ``cache_len`` (3 and 9; W = 12) against the JAX step for that
    row alone, the outputs and the rows written, in place."""
    jp, tp = mixer
    cfg = config_from_jax(deepseek)
    rng = np.random.default_rng(2)
    cache = {"ckv": rng.standard_normal((2, 12, 32)).astype(np.float32),
             "k_rope": rng.standard_normal((2, 12, 16)).astype(np.float32)}
    lens = np.array([3, 9], np.int32)
    x = _x(1, seed=3)
    tc = _ttree(cache)
    leaves = list(tc.values())
    got, tc = tattn.mla_forward(tp, torch.from_numpy(x),
                                torch.from_numpy(lens[:, None].copy()), cfg,
                                cache=tc, cache_len=torch.from_numpy(lens))
    assert all(a is b for a, b in zip(tc.values(), leaves))
    for b in range(2):
        want, jc = jattn.mla_forward(
            jp, jnp.asarray(x[b:b + 1]), jnp.asarray(lens[b:b + 1]),
            deepseek, cache={k: jnp.asarray(v[b:b + 1])
                             for k, v in cache.items()},
            cache_len=jnp.int32(lens[b]))
        _close(got[b:b + 1], want)
        for k in cache:
            _close(tc[k][b:b + 1], jc[k])


def test_mla_gradients_match_jax(deepseek, mixer):
    jp, tp = mixer
    cfg = config_from_jax(deepseek)
    x = _x(9, seed=4)
    gy = np.random.default_rng(5).standard_normal((2, 9, 128)).astype(
        np.float32)

    def jloss(p, xx):
        y, _ = jattn.mla_forward(p, xx, jnp.arange(9), deepseek)
        return (y * gy).sum()

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = jax.tree.map(lambda t: t.clone().requires_grad_(), tp)
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = tattn.mla_forward(tp, xt, torch.arange(9)[None], cfg)
    leaves = list(tree_leaves(tp))
    grads = torch.autograd.grad((y * torch.from_numpy(gy)).sum(),
                                leaves + [xt])
    want = list(tree_leaves(_ttree(_np(jg)))) + [jgx]
    for g, w in zip(grads, want, strict=True):
        _close(g, w, ATOL * max(1.0, float(np.abs(np.asarray(w)).max())))


def test_mla_prefill_with_cache_equals_the_cache_free_forward(deepseek,
                                                              mixer):
    """A prefill into a fresh cache (the port's causal prefill) equals the
    JAX cache-free forward at every position, writes the prompt's latents
    at slots 0..T-1, and a decode step after it equals the cache-free
    forward's next position."""
    jp, tp = mixer
    cfg = config_from_jax(deepseek)
    x = _x(10, seed=6)
    want, _ = jattn.mla_forward(jp, jnp.asarray(x), jnp.arange(10), deepseek)
    tc = _ttree(_np(jattn.init_mla_cache(deepseek, 2, 16, jnp.float32)))
    got, tc = tattn.mla_forward(tp, torch.from_numpy(x[:, :9]),
                                torch.arange(9)[None], cfg, cache=tc,
                                cache_len=torch.zeros(2, dtype=torch.int32))
    _close(got, np.asarray(want)[:, :9])
    ckv, k_rope = jattn._mla_project_kv(jp, jnp.asarray(x), jnp.arange(10),
                                        deepseek.mla, deepseek)
    _close(tc["ckv"][:, :9], np.asarray(ckv)[:, :9])
    _close(tc["k_rope"][:, :9], np.asarray(k_rope)[:, :9])
    assert not tc["ckv"][:, 9:].any()
    step, _ = tattn.mla_forward(tp, torch.from_numpy(x[:, 9:]),
                                torch.full((2, 1), 9), cfg, cache=tc,
                                cache_len=torch.full((2,), 9))
    _close(step, np.asarray(want)[:, 9:])


def test_jax_mla_prefill_with_cache_sees_only_slot_0(deepseek, weights):
    """The JAX package's defect, documented: on the deepseek smoke the JAX
    backbone with a fresh cache differs from the JAX backbone without one
    by more than 1 at every position after the first (its prefill attends
    to key slot 0 only); the port's prefill with a cache equals the JAX
    cache-free forward."""
    jp, tp = weights
    cfg = config_from_jax(deepseek)
    prompt = np.random.default_rng(9).integers(0, deepseek.vocab_size,
                                               (1, 9))
    free = jbackbone.backbone_forward(jp, deepseek,
                                      tokens=jnp.asarray(prompt))
    cached = jbackbone.backbone_forward(
        jp, deepseek, tokens=jnp.asarray(prompt),
        cache=jbackbone.init_cache(deepseek, 1, 16, jnp.float32),
        cache_len=jnp.int32(0))
    gap = np.abs(np.asarray(cached.logits) - np.asarray(free.logits)).max(-1)
    print(f"reading deepseek smoke JAX prefill with a cache vs without: "
          f"max |dlogit| per position {np.round(gap[0], 3).tolist()}")
    assert gap[0, 0] < 1e-4 and (gap[0, 1:] > 1.0).all()
    port = tbackbone.backbone_forward(
        tp, cfg, tokens=torch.from_numpy(prompt),
        cache=tbackbone.init_cache(cfg, 1, 16, torch.float32, "cpu"),
        cache_len=torch.zeros(1, dtype=torch.int32))
    _close_logits(port.logits, free.logits)


def test_deepseek_backbone_matches_jax(deepseek, weights):
    """Logits, exits and the router aux loss of the cache-free forward:
    MLA in every layer, a dense MLP layer, then MoE with a shared
    expert."""
    jp, tp = weights
    cfg = config_from_jax(deepseek)
    assert cfg.moe.num_shared_experts == 1
    assert "shared" in tp["segments"][1][0]["ffn"]
    toks = np.random.default_rng(7).integers(0, deepseek.vocab_size, (2, 13))
    jo = jbackbone.backbone_forward(jp, deepseek, tokens=jnp.asarray(toks))
    to = tbackbone.backbone_forward(tp, cfg, tokens=torch.from_numpy(toks))
    _close_logits(to.logits, jo.logits)
    for got, want in zip(to.exit_logits, jo.exit_logits, strict=True):
        _close_logits(got, want)
    _close(to.aux_loss, jo.aux_loss)
    assert float(to.aux_loss) > 0


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["select", "sticky"])
def test_deepseek_serve_matches_jax_on_one_token_prompts(policy, deepseek,
                                                         weights):
    """1-token prompts, where the JAX prefill is correct: 5 requests on 2
    slots, tokens and gate decisions equal to the JAX session's,
    entropies 1e-4."""
    jp, tp = weights
    cfg = config_from_jax(deepseek)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, deepseek.vocab_size, 1) for _ in range(5)]
    decodes = [5, 3, 6, 4, 5]
    probe = sequential_reference(cfg, tp, prompts[0], 6, tau=0.0,
                                 max_len=16, device="cpu")
    tau = float(np.median(probe.entropy))
    sess = ServeSession(cfg, tp, tau=tau, slots=2, max_len=16,
                        exit_policy=policy, device="cpu")
    jsess = JaxServeSession(deepseek, jp, tau=tau, slots=2, max_len=16,
                            exit_policy=policy)
    for p, d in zip(prompts, decodes):
        sess.submit(p, decode_tokens=d)
        jsess.submit(p, decode_tokens=d)
    got = {r.rid: r for r in sess.run()}
    want = {r.rid: r for r in jsess.run()}
    assert sorted(got) == sorted(want) == list(range(5))
    flags = []
    for rid in range(5):
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].exited == want[rid].exited, rid
        np.testing.assert_allclose(got[rid].entropy, want[rid].entropy,
                                   atol=1e-4)
        flags += got[rid].exited
    assert any(flags)
    if policy == "sticky":
        assert sess.stats.client_only_ticks > 0


@pytest.mark.parametrize("policy", ["select", "sticky"])
def test_deepseek_serve_matches_the_sequential_reference(policy, deepseek,
                                                         weights):
    """Prompts of 3-12 tokens (prefill with a cache, the causal one): 5
    requests on 2 slots against each request served alone."""
    _, tp = weights
    cfg = config_from_jax(deepseek)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, deepseek.vocab_size, int(rng.integers(3, 13)))
               for _ in range(5)]
    decodes = [5, 3, 6, 4, 5]
    probe = sequential_reference(cfg, tp, prompts[0], 6, tau=0.0,
                                 max_len=24, device="cpu")
    tau = float(np.median(probe.entropy))
    sess = ServeSession(cfg, tp, tau=tau, slots=2, max_len=24,
                        exit_policy=policy, device="cpu")
    for p, d in zip(prompts, decodes):
        sess.submit(p, decode_tokens=d)
    got = {r.rid: r for r in sess.run()}
    ref_fn = (sequential_sticky_reference if policy == "sticky"
              else sequential_reference)
    for rid, (p, d) in enumerate(zip(prompts, decodes)):
        ref = ref_fn(cfg, tp, p, d, tau=tau, max_len=24, device="cpu")
        assert (ref.tokens, ref.exited) == (got[rid].tokens,
                                            got[rid].exited), rid
        np.testing.assert_allclose(got[rid].entropy, ref.entropy, atol=1e-4)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def test_deepseek_eq1_steps_with_aux_match_jax(deepseek, weights):
    """eq1 steps, the router aux loss in the server loss: every metric
    1e-5, the first step's gradients (Adam's first moments / 0.1) 1e-5,
    parameters after 2 steps."""
    jp, _ = weights
    splits = (2, 2, 2, 2)
    opt_j = jconfig.OptimizerConfig(lr=LR, total_steps=10, warmup_steps=1)
    opt_t = tconfig.OptimizerConfig(lr=LR, total_steps=10, warmup_steps=1)
    jsc = jspmd.StepConfig(
        model=deepseek.with_(kernels="ref"),
        splitee=jconfig.SplitEEConfig(profile=jconfig.HeteroProfile(splits)),
        train=jconfig.TrainConfig(optimizer=opt_j))
    tsc = tspmd.StepConfig(
        model=config_from_jax(deepseek),
        splitee=tconfig.SplitEEConfig(profile=tconfig.HeteroProfile(splits)),
        train=tconfig.TrainConfig(optimizer=opt_t))
    jo = jadam.adam_init(jp, opt_j)
    tp = params_from_jax(_np(jp), tsc.model, device="cpu")
    to = tadam.adam_init(tp, opt_t)
    jstep, tstep = jax.jit(jspmd.make_train_step(jsc)), \
        tspmd.make_train_step(tsc)
    rng = np.random.default_rng(7)
    sids = np.asarray(jspmd.boundary_ids_for_batch(
        jconfig.HeteroProfile(splits), deepseek, 4))
    for i in range(2):
        b = {"tokens": rng.integers(0, deepseek.vocab_size, (4, 8)).astype(
                 np.int32),
             "labels": rng.integers(0, deepseek.vocab_size, (4, 8)).astype(
                 np.int32),
             "split_ids": sids}
        jp, jo, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, b))
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(np.array(v))
                                    for k, v in b.items()})
        assert sorted(tm) == sorted(jm) and float(tm["aux_loss"]) > 0
        for k in tm:
            _close(tm[k] if k != "lr" else np.float32(tm[k]), jm[k])
        if i == 0:
            want = params_from_jax(_np(jo.m), tsc.model, device="cpu")
            for g, w in zip(tree_leaves(to.m), tree_leaves(want),
                            strict=True):
                _close(g / 0.1, w / 0.1)
    want = params_from_jax(_np(jp), tsc.model, device="cpu")
    d = torch.cat([(g - w).abs().flatten() for g, w in
                   zip(tree_leaves(tp), tree_leaves(want), strict=True)])
    assert d.max().item() <= LR
    assert (d > 1e-6).sum().item() <= 1e-4 * d.numel()


@pytest.mark.parametrize("engine", ["reference", "fused"])
def test_deepseek_train_session_matches_jax(engine, deepseek):
    """``BackboneSplitModel`` on the deepseek smoke through ``TrainSession``
    Averaging, two clients cut at 2, against the JAX engine of the same
    name from one round-0 state: every element of the nets and the Adam
    moments and the per-round losses 1e-5 at lr 1e-5."""
    tm = BackboneSplitModel(config_from_jax(deepseek), device="cpu")
    splits = (2, 2)
    ds = SyntheticSeqClsDataset(vocab_size=deepseek.vocab_size, seq_len=8,
                                num_classes=8, train_size=96, test_size=16,
                                seed=0)
    parts = ClientPartitioner(2).split(*ds.train)
    js = JaxSession.from_config(
        JaxBackbone(deepseek, seed=0),
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
    print(f"reading deepseek smoke {engine} vs JAX: state {gap:.2e}, "
          f"losses {dl:.2e}")
    assert max(gap, dl) <= ATOL


def test_deepseek_config_resolves():
    mod = tconfigs.get("deepseek-v3-671b")
    cfg = mod.config()
    assert cfg.mla.kv_lora_rank == 512 and cfg.moe.num_experts == 256
    assert cfg.ffn_pattern[:4] == ("mlp", "mlp", "mlp", "moe")
    b = mod.smoke_bf16()
    assert (b.mla.qk_nope_head_dim, b.mla.qk_rope_head_dim,
            b.mla.v_head_dim) == (128, 64, 128)

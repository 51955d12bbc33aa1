"""The port's stub frontends and cross attention (whisper-small and
paligemma-3b) against the JAX package's, on the CPU.

Weights come from the JAX init through ``repro_torch.convert``; inputs are
seeded numpy; fp32 throughout.  The JAX package's main paths feed the
frontend the documented zeros stub, whose projection is zero, so cross
attention there adds exactly 0 and a comparison on it would pass with
cross attention missing.  These tests therefore hold cross attention and
the projectors on a *random* ``enc`` and random ``embeds`` through the
entry points that take them (``backbone_forward``, ``make_train_step``
through ``batch["enc"]``/``batch["embeds"]``), and check that the result
depends on them; the split model and the serving session run the zeros
stub on both sides, as the JAX package runs them.

Limits: 1e-5 for the projector, cross attention and a block; logits and
gradients 1e-5 of each tensor's largest magnitude (at least 1:
reassociation over four layers and the head); tokens and gate decisions
exact; eq1/sum metrics 1e-5, parameters after Adam steps as
tests/test_torch_train.py holds them; ``TrainSession`` states 1e-5 at lr
1e-5 (tests/test_torch_backbone_split.py says why that lr).
"""
import functools

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
from repro.models import blocks as jblocks
from repro.models import frontend as jfrontend
from repro.optim import adam as jadam
import repro_torch.config as tconfig
from repro_torch import configs as tconfigs
from repro_torch.api import TrainSession
from repro_torch.api.serve_session import (ServeSession,
                                           sequential_reference)
from repro_torch.convert import (config_from_jax, params_from_jax,
                                 split_state_from_jax, to_tensor)
from repro_torch.core import spmd as tspmd
from repro_torch.core.backbone_splitee import BackboneSplitModel
from repro_torch.data.pipeline import ClientPartitioner
from repro_torch.data.synthetic import SyntheticSeqClsDataset
from repro_torch.launch import e2e_train
from repro_torch.models import attention as tattn
from repro_torch.models import backbone as tbackbone
from repro_torch.models import blocks as tblocks
from repro_torch.models import frontend as tfrontend
from repro_torch.optim import adam as tadam
from repro_torch.tree import tree_leaves

ATOL = 1e-5
LR = 1e-3
ARCHS = ("whisper_small", "paligemma_3b")


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


def _ttree(tree):
    return jax.tree.map(lambda a: to_tensor(a, "cpu"), tree)


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=0)


def _close_scaled(got, want):
    """1e-5 of the largest magnitude (at least 1)."""
    _close(got, want, ATOL * max(1.0, float(np.abs(np.asarray(want)).max())))


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def smokes():
    return {a: jconfigs.get(a).smoke() for a in ARCHS}


@pytest.fixture(scope="module")
def weights(smokes):
    out = {}
    for a, cfg in smokes.items():
        jp = jbackbone.init_backbone(jax.random.PRNGKey(0), cfg)
        out[a] = jp, params_from_jax(_np(jp), config_from_jax(cfg),
                                     device="cpu")
    return out


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("feat", [tfrontend.WHISPER_FRAME_DIM,
                                  tfrontend.SIGLIP_PATCH_DIM])
def test_project_matches_jax(smokes, feat):
    cfg = smokes["whisper_small"]
    jp = jfrontend.init_projector(jax.random.PRNGKey(3), feat, cfg)
    x = _normal(1, 2, 7, feat)
    want = jfrontend.project(jp, jnp.asarray(x))
    got = tfrontend.project(_ttree(_np(jp)), torch.from_numpy(x))
    assert got.shape == (2, 7, cfg.d_model)
    _close(got, want)
    assert (tfrontend.WHISPER_FRAME_DIM, tfrontend.SIGLIP_PATCH_DIM,
            tfrontend.NUM_VISION_PATCHES, tfrontend.WHISPER_SOURCE_LEN) == (
                jfrontend.WHISPER_FRAME_DIM, jfrontend.SIGLIP_PATCH_DIM,
                jfrontend.NUM_VISION_PATCHES, jfrontend.WHISPER_SOURCE_LEN)


def test_init_projector_draws_a_fan_in_normal(smokes):
    cfg = config_from_jax(smokes["paligemma_3b"])
    p = tfrontend.init_projector(1152, cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    w = p["w"]
    assert w.shape == (1152, cfg.d_model) and w.dtype == torch.float32
    assert abs(float(w.std()) * 1152 ** 0.5 - 0.88) < 0.05  # 2-sigma trunc


def test_cross_attn_forward_and_gradients_match_jax(smokes):
    """Random x and enc (Tq 5 != Tk 11): the output and the gradients of
    every weight and of both inputs; no biases under use_qkv_bias."""
    jcfg = smokes["whisper_small"]
    assert jcfg.use_qkv_bias
    jp = jattn.init_cross_attn(jax.random.PRNGKey(2), jcfg)
    tp = _ttree(_np(jp))
    assert sorted(tp) == ["wk", "wo", "wq", "wv"]
    x, enc = _normal(0, 2, 5, 128), _normal(1, 2, 11, 128)
    cot = _normal(2, 2, 5, 128)

    def jloss(p, x, e):
        return jnp.sum(jattn.cross_attn_forward(p, x, e, jcfg) * cot)

    want_out = jattn.cross_attn_forward(jp, jnp.asarray(x), jnp.asarray(enc),
                                        jcfg)
    want_g = jax.grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(x),
                                                jnp.asarray(enc))
    tcfg = config_from_jax(jcfg)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    te = torch.from_numpy(enc).requires_grad_()
    out = tattn.cross_attn_forward(leaves, tx, te, tcfg)
    _close(out, want_out)
    (out * torch.from_numpy(cot)).sum().backward()
    for k in leaves:
        _close_scaled(leaves[k].grad, want_g[0][k])
    _close_scaled(tx.grad, want_g[1])
    _close_scaled(te.grad, want_g[2])


def test_block_forward_with_enc_matches_jax(smokes):
    """A whisper block (GQA with biases, cross attention, GeLU MLP with
    biases) on random x and enc; without ``enc`` the cross sub-block is
    skipped, as in the JAX package."""
    jcfg = smokes["whisper_small"]
    jp = jblocks.init_block(jax.random.PRNGKey(4), jcfg, "attn", "mlp")
    tp = _ttree(_np(jp))
    assert {"norm_x", "cross"} <= set(tp)
    tcfg = config_from_jax(jcfg)
    x, enc = _normal(3, 2, 6, 128), _normal(4, 2, 16, 128)
    for e in (enc, None):
        want, _, _ = jblocks.block_forward(
            jp, jnp.asarray(x), jnp.arange(6), jcfg, "attn", "mlp",
            enc=None if e is None else jnp.asarray(e))
        got, _, aux = tblocks.block_forward(
            tp, torch.from_numpy(x), torch.arange(6)[None], tcfg, "attn",
            "mlp", enc=None if e is None else torch.from_numpy(e))
        assert aux is None
        _close(got, want)


def test_block_init_adds_cross_only_where_jax_does(smokes):
    tcfg = config_from_jax(smokes["whisper_small"])
    g = torch.Generator().manual_seed(0)
    for mixer, ffn, has in (("attn", "mlp", True), ("rwkv6", "rwkv_cm", False)):
        cfg = tcfg if mixer == "attn" else tcfg.with_(
            ssm=tconfigs.get("rwkv6_3b").smoke().ssm)
        p = tblocks.init_block(cfg, mixer, ffn, g, "cpu")
        assert ("cross" in p) == ("norm_x" in p) == has
    p = tblocks.init_block(tcfg.with_(cross_attention=False), "attn", "mlp",
                           g, "cpu")
    assert "cross" not in p


# ---------------------------------------------------------------------------
# the backbone
# ---------------------------------------------------------------------------


def test_whisper_backbone_with_enc_matches_jax(smokes, weights):
    """Logits and exit logits on random enc states (projected by the
    frontend), and the zeros stub: there cross attention adds exactly 0,
    so the network equals the one without ``enc``."""
    jcfg = smokes["whisper_small"]
    jp, tp = weights["whisper_small"]
    cfg = config_from_jax(jcfg)
    assert tp["frontend"]["w"].shape == (768, 128)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 9))
    enc = _normal(8, 2, jcfg.cross_source_len, 768)
    outs = {}
    for name, e in (("random", enc), ("zeros", np.zeros_like(enc)),
                    ("none", None)):
        jo = jbackbone.backbone_forward(
            jp, jcfg, tokens=jnp.asarray(toks),
            enc=None if e is None else jnp.asarray(e))
        to = tbackbone.backbone_forward(
            tp, cfg, tokens=torch.from_numpy(toks),
            enc=None if e is None else torch.from_numpy(e))
        _close_scaled(to.logits, jo.logits)
        for got, want in zip(to.exit_logits, jo.exit_logits, strict=True):
            _close_scaled(got, want)
        outs[name] = to.logits
    assert torch.equal(outs["zeros"], outs["none"])
    assert (outs["random"] - outs["none"]).abs().max() > 1e-2


@pytest.mark.parametrize("with_tokens", [True, False])
def test_paligemma_backbone_with_embeds_matches_jax(smokes, weights,
                                                    with_tokens):
    """Random patch embeddings projected before the tokens (or alone): the
    logits over the prefix and the tokens, the exits, and positions that
    count the prefix (the token part differs from a run without it)."""
    jcfg = smokes["paligemma_3b"]
    jp, tp = weights["paligemma_3b"]
    cfg = config_from_jax(jcfg)
    assert tp["frontend"]["w"].shape == (1152, 128)
    toks = np.random.default_rng(9).integers(0, jcfg.vocab_size, (2, 5))
    emb = _normal(10, 2, 6, 1152)
    kw_j = {"embeds": jnp.asarray(emb)}
    kw_t = {"embeds": torch.from_numpy(emb)}
    if with_tokens:
        kw_j["tokens"] = jnp.asarray(toks)
        kw_t["tokens"] = torch.from_numpy(toks)
    jo = jbackbone.backbone_forward(jp, jcfg, **kw_j)
    to = tbackbone.backbone_forward(tp, cfg, **kw_t)
    assert to.logits.shape == (2, 6 + 5 * with_tokens, jcfg.vocab_size)
    _close_scaled(to.logits, jo.logits)
    for got, want in zip(to.exit_logits, jo.exit_logits, strict=True):
        _close_scaled(got, want)
    if with_tokens:
        alone = tbackbone.backbone_forward(tp, cfg,
                                           tokens=torch.from_numpy(toks))
        assert (to.logits[:, 6:] - alone.logits).abs().max() > 1e-2


def test_vlm_prefill_then_decode_equals_the_full_forward(smokes, weights):
    """A cache-filling prefill over patches + tokens, then one decode
    token at position P + T: its logits equal the last row of the
    cache-free forward over all P + T + 1 positions."""
    jcfg = smokes["paligemma_3b"]
    _, tp = weights["paligemma_3b"]
    cfg = config_from_jax(jcfg)
    toks = torch.from_numpy(
        np.random.default_rng(11).integers(0, jcfg.vocab_size, (2, 5)))
    emb = torch.from_numpy(_normal(12, 2, 6, 1152))
    full = tbackbone.backbone_forward(tp, cfg, tokens=toks, embeds=emb)
    cache = tbackbone.init_cache(cfg, 2, 16, cfg.dtype, "cpu")
    tbackbone.backbone_forward(tp, cfg, tokens=toks[:, :4], embeds=emb,
                               cache=cache,
                               cache_len=torch.zeros(2, dtype=torch.int32))
    step = tbackbone.backbone_forward(
        tp, cfg, tokens=toks[:, 4:], cache=cache,
        cache_len=torch.full((2,), 10, dtype=torch.int32))
    _close_scaled(step.logits[:, 0], full.logits[:, -1].detach().numpy())


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _frontend_batch(arch, jcfg, rng, B=4, T=8):
    b = {"tokens": rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)}
    if arch == "whisper_small":
        b["enc"] = rng.standard_normal(
            (B, jcfg.cross_source_len, 768)).astype(np.float32)
        b["labels"] = rng.integers(0, jcfg.vocab_size, (B, T)).astype(
            np.int32)
    else:
        P = 5
        b["embeds"] = rng.standard_normal((B, P, 1152)).astype(np.float32)
        b["labels"] = np.concatenate(
            [np.zeros((B, P), np.int32),
             rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)], 1)
    return b


@pytest.mark.parametrize("grad_mode", ["eq1", "sum"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_with_frontend_inputs_match_jax(smokes, arch, grad_mode):
    """Two steps of ``make_train_step`` on random ``enc`` (whisper) or
    ``embeds`` (paligemma): every metric 1e-5, the first step's Adam first
    moments (the gradients / 0.1) 1e-5 of each leaf's scale, parameters
    after 2 steps; the projector and cross attention's four weights move."""
    jcfg = smokes[arch]
    splits = (2, 2, 2, 2)
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
    jp = jbackbone.init_backbone(jax.random.PRNGKey(0), jcfg)
    jo = jadam.adam_init(jp, opt_j)
    tp = params_from_jax(_np(jp), tsc.model, device="cpu")
    start = {"frontend": tp["frontend"]["w"].clone(),
             "cross": {k: v.clone() for k, v in
                       tp["segments"][0][0].get("cross", {}).items()}}
    to = tadam.adam_init(tp, opt_t)
    jstep = jax.jit(jspmd.make_train_step(jsc))
    tstep = tspmd.make_train_step(tsc)
    rng = np.random.default_rng(7)
    sids = np.asarray(jspmd.boundary_ids_for_batch(
        jconfig.HeteroProfile(splits), jcfg, 4))
    for i in range(2):
        b = {**_frontend_batch(arch, jcfg, rng), "split_ids": sids}
        jp, jo, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, b))
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(np.array(v))
                                    for k, v in b.items()})
        assert sorted(tm) == sorted(jm)
        for k in tm:
            _close(tm[k] if k != "lr" else np.float32(tm[k]), jm[k])
        if i == 0:
            want = params_from_jax(_np(jo.m), tsc.model, device="cpu")
            for g, w in zip(tree_leaves(to.m), tree_leaves(want),
                            strict=True):
                _close_scaled(g / 0.1, w.numpy() / 0.1)
    want = params_from_jax(_np(jp), tsc.model, device="cpu")
    d = torch.cat([(g - w).abs().flatten() for g, w in
                   zip(tree_leaves(tp), tree_leaves(want), strict=True)])
    assert d.max().item() <= LR
    assert (d > 1e-6).sum().item() <= 1e-4 * d.numel()
    assert (tp["frontend"]["w"] - start["frontend"]).abs().max() > 1e-4
    cross = tp["segments"][0][0].get("cross")
    if arch == "whisper_small":
        for k, w0 in start["cross"].items():
            assert (cross[k] - w0).abs().max() > 1e-4, k
    else:
        assert cross is None


def _jax_sequential_step(jsc, params, opt_state, batch):
    """Alg. 1 with the frontend inputs, built from the JAX package's own
    pieces: for each client group in order, ``backbone_forward`` over that
    group's rows (``enc``/``embeds`` included), the summed hetero loss,
    its gradient blended by participation as the JAX sequential step
    blends it, then Adam at the step's one learning rate.  The JAX
    sequential step itself drops ``enc`` and ``embeds`` (ROADMAP.md Queue
    3), so this chain is the oracle."""
    cfg = jsc.model
    nb = len(cfg.exit_layers)
    N = jsc.splitee.profile.num_groups
    div = jsc.splitee.resolved_server_lr_divisor()
    per = batch["split_ids"].shape[0] // N
    lr = jspmd.make_schedule(jsc.train.optimizer)(opt_state.step)
    cs, ss = jspmd.participation_scale_trees(params, cfg, jsc.splitee.profile)
    scale = jax.tree.map(lambda a, b: a * float(N) + b * float(N) / div,
                         cs, ss)
    losses = []
    for g in range(N):
        rows = {k: v[g * per:(g + 1) * per] for k, v in batch.items()}

        def total(p):
            out = jbackbone.backbone_forward(
                p, cfg, tokens=rows.get("tokens"), embeds=rows.get("embeds"),
                enc=rows.get("enc"), split_ids=rows["split_ids"])
            c, srv, m = jspmd.hetero_losses(out, rows["labels"],
                                            rows["split_ids"], nb)
            return c + srv, m

        (_, m), grads = jax.value_and_grad(total, has_aux=True)(params)
        grads = jax.tree.map(lambda gg, sk: gg * sk, grads, scale)
        params, opt_state = jadam.adam_update(params, grads, opt_state,
                                              jsc.train.optimizer, lr)
        losses.append(m["server_loss"])
    return params, opt_state, {"server_loss": jnp.mean(jnp.stack(losses)),
                               "lr": lr}


@pytest.mark.parametrize("arch", ARCHS)
def test_sequential_step_takes_the_frontend_inputs(smokes, arch):
    """Alg. 1's sequential step with a random ``enc`` (whisper) or random
    ``embeds`` (paligemma), four groups of two rows, against the JAX chain
    of :func:`_jax_sequential_step`: the server loss of both steps 1e-5,
    the first step's Adam first moments (the blended gradients summed over
    the groups; lr is warm-up's 0 there) 1e-5 of each leaf's scale,
    parameters after 2 steps as the train-step test holds them.  The
    projector and cross attention's four weights move."""
    jcfg = smokes[arch]
    splits = (2, 2, 2, 2)
    prof_j, prof_t = (jconfig.HeteroProfile(splits),
                      tconfig.HeteroProfile(splits))
    opt_j = jconfig.OptimizerConfig(lr=LR, total_steps=10, warmup_steps=1)
    opt_t = tconfig.OptimizerConfig(lr=LR, total_steps=10, warmup_steps=1)
    jsc = jspmd.StepConfig(
        model=jcfg.with_(kernels="ref"),
        splitee=jconfig.SplitEEConfig(profile=prof_j),
        train=jconfig.TrainConfig(optimizer=opt_j))
    sc = tspmd.StepConfig(
        model=config_from_jax(jcfg),
        splitee=tconfig.SplitEEConfig(profile=prof_t),
        train=tconfig.TrainConfig(optimizer=opt_t))
    jp = jbackbone.init_backbone(jax.random.PRNGKey(0), jcfg)
    jo = jadam.adam_init(jp, opt_j)
    tp = params_from_jax(_np(jp), sc.model, device="cpu")
    f0 = tp["frontend"]["w"].clone()
    c0 = {k: v.clone() for k, v in
          tp["segments"][0][0].get("cross", {}).items()}
    to = tadam.adam_init(tp, opt_t)
    jstep = jax.jit(functools.partial(_jax_sequential_step, jsc))
    tstep = tspmd.make_sequential_train_step(sc)
    sids = np.asarray(jspmd.boundary_ids_for_batch(prof_j, jcfg, 8))
    rng = np.random.default_rng(3)
    for i in range(2):
        b = {**_frontend_batch(arch, jcfg, rng, B=8), "split_ids": sids}
        jp, jo, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, b))
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(np.array(v))
                                    for k, v in b.items()})
        _close(tm["server_loss"], jm["server_loss"])
        _close(np.float32(tm["lr"]), jm["lr"])
        if i == 0:
            want = params_from_jax(_np(jo.m), sc.model, device="cpu")
            for g, w in zip(tree_leaves(to.m), tree_leaves(want),
                            strict=True):
                _close_scaled(g / 0.1, w.numpy() / 0.1)
    want = params_from_jax(_np(jp), sc.model, device="cpu")
    d = torch.cat([(g - w).abs().flatten() for g, w in
                   zip(tree_leaves(tp), tree_leaves(want), strict=True)])
    assert d.max().item() <= LR
    assert (d > 1e-6).sum().item() <= 1e-4 * d.numel()
    assert (tp["frontend"]["w"] - f0).abs().max() > 1e-4
    for k, w0 in c0.items():
        assert (tp["segments"][0][0]["cross"][k] - w0).abs().max() > 1e-4, k
    assert bool(c0) == (arch == "whisper_small")


def test_participation_scales_cover_the_frontend(smokes):
    cfg = config_from_jax(smokes["whisper_small"])
    params = tbackbone.init_backbone(torch.Generator().manual_seed(0), cfg)
    prof = tconfig.HeteroProfile((2, 2, 2))
    cs, ss = tspmd.participation_scale_trees(params, cfg, prof)
    assert cs["frontend"]["w"] == pytest.approx(1 / 3)
    assert ss["frontend"]["w"] == 0.0
    assert len(list(tree_leaves(cs))) == len(list(tree_leaves(params)))


@pytest.mark.parametrize("engine", ["reference", "fused"])
def test_whisper_split_model_matches_jax(smokes, engine):
    """``BackboneSplitModel`` on the whisper smoke through ``TrainSession``
    Averaging, two clients cut at 2, against the JAX engine of the same
    name from one round-0 state (the zeros stub on both sides, as the JAX
    adapter runs it): every element of the nets, the Adam moments and the
    per-round losses 1e-5 at lr 1e-5.  Each side holds its own copy of
    the projector."""
    jcfg = smokes["whisper_small"]
    tm = BackboneSplitModel(config_from_jax(jcfg), device="cpu")
    assert "frontend" in tm.make_client(2)["trainable"]
    assert "frontend" in tm.make_server(2)["trainable"]
    splits = (2, 2)
    ds = SyntheticSeqClsDataset(vocab_size=jcfg.vocab_size, seq_len=8,
                                num_classes=8, train_size=96, test_size=16,
                                seed=0)
    parts = ClientPartitioner(2).split(*ds.train)
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
    print(f"reading whisper smoke {engine} vs JAX: state {gap:.2e}, "
          f"losses {dl:.2e}")
    assert max(gap, dl) <= ATOL


def test_vlm_split_model_trains_token_only(smokes):
    """The VLM adapter keeps the vision projector out of both sides'
    trainables, as the JAX adapter does."""
    tm = BackboneSplitModel(config_from_jax(smokes["paligemma_3b"]),
                            device="cpu")
    jm = JaxBackbone(smokes["paligemma_3b"], seed=0)
    assert "frontend" in tm.full_params
    for li in tm.cut_layers:
        assert sorted(tm.make_client(li)["trainable"]) == sorted(
            jm.make_client(li)["trainable"])
        assert sorted(tm.make_server(li)["trainable"]) == sorted(
            jm.make_server(li)["trainable"])
        assert "frontend" not in tm.make_client(li)["trainable"]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["select", "sticky"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_jax(smokes, weights, arch, policy):
    """5 requests on 2 slots: tokens and gate decisions equal to the JAX
    session's (whisper on the zeros stub, as both packages serve it;
    paligemma token-only), entropies 1e-4."""
    jcfg = smokes[arch]
    jp, tp = weights[arch]
    cfg = config_from_jax(jcfg)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, jcfg.vocab_size, int(rng.integers(2, 9)))
               for _ in range(5)]
    decodes = [5, 3, 6, 4, 5]
    probe = sequential_reference(cfg, tp, prompts[0], 6, tau=0.0,
                                 max_len=24, device="cpu")
    tau = float(np.median(probe.entropy))
    sess = ServeSession(cfg, tp, tau=tau, slots=2, max_len=24,
                        exit_policy=policy, device="cpu")
    jsess = JaxServeSession(jcfg, jp, tau=tau, slots=2, max_len=24,
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
    assert any(flags) and (policy == "sticky" or not all(flags))
    if policy == "sticky":
        assert sess.stats.client_only_ticks > 0


# ---------------------------------------------------------------------------
# configs and entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    mod, jmod = tconfigs.get(arch), jconfigs.get(arch)
    assert mod.config() == config_from_jax(jmod.config())
    assert mod.smoke() == config_from_jax(jmod.smoke())
    assert mod.profile().split_layers == jmod.profile().split_layers
    b = mod.smoke_bf16()
    assert b.dtype == torch.bfloat16 and b.head_dim == mod.config().head_dim
    assert b.num_heads // b.num_kv_heads == (
        mod.config().num_heads // mod.config().num_kv_heads)


def test_every_jax_architecture_resolves():
    assert len(tconfigs.ARCH_IDS) == 10
    for arch in jconfigs.ARCH_IDS:
        assert tconfigs.get(arch).config().name == \
            jconfigs.get(arch).config().name
    with pytest.raises(ValueError, match="not a registered"):
        tconfigs.get("gpt2")


@pytest.mark.parametrize("arch", ["whisper-small", "paligemma-3b"])
def test_e2e_train_cli_on_the_cpu(arch, capsys):
    """``e2e_train --arch ... --smoke --device cpu``: the stub frontend's
    inputs drawn from the seed (whisper: enc over cross_source_len frames;
    paligemma: 256 patches before the tokens), finite losses."""
    seq = 8 if arch == "whisper-small" else 260
    out = e2e_train.main(["--arch", arch, "--smoke", "--layers", "4",
                          "--steps", "2", "--batch", "12", "--seq",
                          str(seq), "--device", "cpu"])
    assert all(np.isfinite(out["losses"]))
    assert "frontend" in out["params"]
    assert "loss: first=" in capsys.readouterr().out


def test_frontend_batch_shapes(smokes):
    rng = np.random.default_rng(0)
    toks = np.ones((3, 300), np.int32)
    cfg = config_from_jax(smokes["paligemma_3b"])
    b = tfrontend.frontend_batch(cfg, toks, toks, rng, "cpu")
    assert b["embeds"].shape == (3, 256, 1152)
    assert b["tokens"].shape == (3, 44) and b["labels"].shape == (3, 300)
    assert int(b["labels"][:, :256].abs().sum()) == 0
    cfg = config_from_jax(smokes["whisper_small"])
    b = tfrontend.frontend_batch(cfg, toks, toks, rng, "cpu")
    assert b["enc"].shape == (3, cfg.cross_source_len, 768)
    assert b["tokens"].shape == b["labels"].shape == (3, 300)

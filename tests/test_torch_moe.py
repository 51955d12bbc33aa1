"""The port's mixture-of-experts layer (``repro_torch/models/moe.py``) and
the MoE paths through the backbone, the train step and ``ServeSession``,
against the JAX package on the CPU.

Both packages get the same weights (the JAX init through
``repro_torch.convert``) and the same seeded numpy inputs.  Routing is
discontinuous, so every comparison first holds the chosen experts equal,
then the values: route weights and aux losses 1e-6, ``moe_forward``'s
output and gradients 1e-5 (fp32), backbone logits 1e-4 (as
tests/test_torch_models.py), train-step metrics 1e-5, ``ServeSession``
tokens and gates exact.

Capacity: the JAX ``moe_forward`` keeps only C-1 tokens of an expert whose
load exceeds C on the CPU (a dropped entry's zero row, scattered last onto
the expert's last slot, wins); the port mirrors that rule on purpose
(``models/moe.py``, ROADMAP.md Queue 3).  The drop cases below assert that
experts overflow, so the rule is what they compare.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as jconfig
from repro import configs as jconfigs
from repro.api.serve_session import ServeSession as JaxServeSession
from repro.core import spmd as jspmd
from repro.models import backbone as jbackbone
from repro.models import moe as jmoe
from repro.optim import adam as jadam
import repro_torch.config as tconfig
from repro_torch.api.serve_session import ServeSession
from repro_torch.convert import config_from_jax, params_from_jax, to_tensor
from repro_torch.core import spmd as tspmd
from repro_torch.models import backbone as tbackbone
from repro_torch.models import moe as tmoe
from repro_torch.optim import adam as tadam
from repro_torch.tree import tree_leaves, tree_map

TOL_ROUTE = 1e-6
TOL = 1e-5
TOL_LOGITS = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tensors(tree):
    return tree_map(lambda a: to_tensor(a, "cpu"), _np(tree))


def _close(got, want, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=0)


def _with_cf(jcfg, cf):
    return jcfg.with_(moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))


@pytest.fixture(scope="module")
def qwen3():
    return jconfigs.get("qwen3_moe_235b_a22b").smoke()


def _layer(jcfg, seed=0):
    """A JAX MoE layer's params and the port's copy of them."""
    p = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return p, _tensors(p)


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# routing and capacity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fixture,N", [("tiny_moe", 37), ("qwen3", 64)])
def test_route_matches_jax(fixture, N, request):
    jcfg = request.getfixturevalue(fixture)
    m = config_from_jax(jcfg).moe
    p, tp = _layer(jcfg)
    x = _tokens((N, jcfg.d_model), seed=1)
    ji, jw, ja = jmoe.route(p, jnp.asarray(x), jcfg.moe)
    ti, tw, ta = tmoe.route(tp, torch.from_numpy(x), m)
    probs = np.asarray(jax.nn.softmax(
        jnp.asarray(x) @ p["router"].astype(jnp.float32), axis=-1))
    ranked = -np.sort(-probs, axis=-1)
    gap = ranked[:, m.top_k - 1] - ranked[:, m.top_k]
    print(f"reading {jcfg.name} route: smallest gap between the k-th and "
          f"(k+1)-th probability over {N} tokens {gap.min():.3e}")
    assert ti.dtype == torch.int64 and tw.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw, TOL_ROUTE)
    _close(ta, ja, TOL_ROUTE)
    assert float(ta) > 0


@pytest.mark.parametrize("num_tokens", [1, 5, 37, 64, 1536])
@pytest.mark.parametrize("cf", [0.25, 1.0, 1.25, 8.0])
def test_expert_capacity_matches_jax(num_tokens, cf, qwen3, tiny_moe):
    for jcfg in (qwen3, tiny_moe, jconfigs.get("qwen3_moe_235b_a22b")
                 .config()):
        jm = dataclasses.replace(jcfg.moe, capacity_factor=cf)
        tm = config_from_jax(jcfg.with_(moe=jm)).moe
        assert tmoe.expert_capacity(num_tokens, tm) == \
            jmoe.expert_capacity(num_tokens, jm)


def _loads(tp, x, cfg, groups=1):
    """Each group's expert loads and the capacity C of ``moe_forward``."""
    B, T, d = x.shape
    N = B * T // groups
    topi, _, _ = tmoe.route(tp, x.reshape(groups, N, d), cfg.moe)
    load = (topi[..., None] == torch.arange(cfg.moe.num_experts)).sum(
        (-3, -2))
    return load, tmoe.expert_capacity(N, cfg.moe)


# capacity factor 8: tiny_moe as the conftest has it (no token dropped)
@pytest.mark.parametrize("cf", [8.0, 1.0, 0.25])
def test_moe_forward_matches_jax(cf, tiny_moe):
    """Forward and gradients (inputs, router, experts, the shared expert)
    at 1e-5; the dense oracle agrees with the JAX oracle, and with the
    dispatch where nothing drops.  At capacity factors 1.0 and 0.25
    experts overflow and the C-1 rule decides what is kept."""
    jcfg = _with_cf(tiny_moe, cf)
    cfg = config_from_jax(jcfg)
    p, tp = _layer(jcfg)
    x = _tokens((2, 9, jcfg.d_model))
    load, C = _loads(tp, torch.from_numpy(x), cfg)
    overflow = bool((load > C).any())
    assert overflow == (cf < 8.0), (load, C)

    jo, ja = jmoe.moe_forward(p, jnp.asarray(x), jcfg)
    to, ta = tmoe.moe_forward(tp, torch.from_numpy(x), cfg)
    _close(to, jo, TOL)
    _close(ta, ja, TOL_ROUTE)
    jd, jda = jmoe.moe_forward_dense(p, jnp.asarray(x), jcfg)
    td, tda = tmoe.moe_forward_dense(tp, torch.from_numpy(x), cfg)
    _close(td, jd, TOL)
    _close(tda, jda, TOL_ROUTE)
    if not overflow:
        _close(to, td.detach().numpy(), TOL)
    else:
        # the drops change the answer: the dense oracle is far off
        assert (to - td).abs().max() > 0.1

    def jloss(p, x):
        o, a = jmoe.moe_forward(p, x, jcfg)
        return jnp.sum(o * jnp.cos(o)) + a

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = list(tree_leaves(tp))
    for t in leaves:
        t.requires_grad_(True)
    o, a = tmoe.moe_forward(tp, xt, cfg)
    (o * torch.cos(o)).sum().add(a).backward()
    _close(xt.grad, jgx, TOL)
    for t, w in zip(leaves, tree_leaves(_tensors(jgp))):
        _close(t.grad, w, TOL)


def _kept_only(tp, x, cfg, kept_of):
    """Every expert on every token (the dense oracle's products), each
    entry's weight kept where its rank in its expert's stable sorted run
    is below ``kept_of(load, C)``: a dispatch-free capacity oracle."""
    m = cfg.moe
    xf = x.reshape(-1, x.shape[-1])
    N = xf.shape[0]
    topi, topw, _ = tmoe.route(tp, xf, m)
    flat = topi.reshape(-1)
    order = torch.argsort(flat, stable=True)
    rank = torch.empty_like(order)
    load = torch.bincount(flat, minlength=m.num_experts)
    starts = torch.cumsum(load, 0) - load
    rank[order] = torch.arange(N * m.top_k) - starts[flat[order]]
    C = tmoe.expert_capacity(N, m)
    keep = rank < kept_of(load, C)[flat]
    combine = torch.zeros(N, m.num_experts).scatter(
        -1, topi, topw * keep.reshape(N, m.top_k))
    act = torch.nn.functional.silu
    h = act(torch.einsum("nd,edf->nef", xf, tp["w_gate"])) * \
        torch.einsum("nd,edf->nef", xf, tp["w_up"])
    out = torch.einsum("ned,ne->nd", torch.einsum(
        "nef,efd->ned", h, tp["w_down"]), combine)
    from repro_torch.models.mlp import mlp_forward
    return out.reshape(x.shape) + mlp_forward(tp["shared"], x, cfg)


@pytest.mark.parametrize("cf", [1.0, 0.25])
def test_c_minus_1_rule_is_what_jax_computes(cf, tiny_moe):
    """Where experts overflow, the JAX output is the one that keeps C-1
    entries of each overflowing expert, and not the one that keeps C
    (the capacity its docstring promises); the port computes the former."""
    jcfg = _with_cf(tiny_moe, cf)
    cfg = config_from_jax(jcfg)
    p, tp = _layer(jcfg)
    x = torch.from_numpy(_tokens((2, 9, jcfg.d_model)))
    jo = np.asarray(jmoe.moe_forward(p, jnp.asarray(x.numpy()), jcfg)[0])
    c_minus_1 = _kept_only(tp, x, cfg, lambda load, C: torch.where(
        load > C, C - 1, load))
    c_kept = _kept_only(tp, x, cfg, lambda load, C: torch.clamp(load, max=C))
    to, _ = tmoe.moe_forward(tp, x, cfg)
    gap_c = float(np.abs(c_kept.numpy() - jo).max())
    print(f"reading capacity factor {cf}: JAX vs C-1 kept "
          f"{np.abs(c_minus_1.numpy() - jo).max():.2e}, vs C kept "
          f"{gap_c:.2e}")
    _close(c_minus_1, jo, TOL)
    _close(to, jo, TOL)
    assert gap_c > 0.1


def test_groups_route_alone(qwen3):
    """``groups=G``: each group is routed, capacity-limited and combined as
    a call on its rows alone would be (bit for bit), drops included."""
    jcfg = _with_cf(qwen3, 0.5)
    cfg = config_from_jax(jcfg)
    _, tp = _layer(jcfg)
    x = torch.from_numpy(_tokens((6, 5, jcfg.d_model), seed=3))
    load, C = _loads(tp, x, cfg, groups=3)
    assert (load > C).any()
    out, aux = tmoe.moe_forward(tp, x, cfg, groups=3)
    alone = [tmoe.moe_forward(tp, x[2 * g:2 * g + 2], cfg) for g in range(3)]
    assert torch.equal(out, torch.cat([o for o, _ in alone]))
    _close(aux, np.mean([float(a) for _, a in alone]), 1e-9)
    # one row per group: each slot of a decode tick routed alone
    rows = tmoe.moe_forward(tp, x[:, :1], cfg, groups=6)[0]
    assert torch.equal(rows, torch.cat(
        [tmoe.moe_forward(tp, x[b:b + 1, :1], cfg)[0] for b in range(6)]))
    with pytest.raises(ValueError, match="routing groups"):
        tmoe.moe_forward(tp, x, cfg, groups=4)


def test_lanes_under_vmap_match_per_lane_calls(qwen3):
    """The fused engine's lanes: ``torch.func.vmap`` over stacked layers
    equals one call per lane, forward bit for bit and gradients to
    rounding."""
    from torch.func import vmap
    jcfg = _with_cf(qwen3, 0.5)
    cfg = config_from_jax(jcfg)
    lanes = [_layer(jcfg, seed=s)[1] for s in (0, 1)]
    P = tree_map(lambda *ts: torch.stack(ts), *lanes)
    X = torch.from_numpy(_tokens((2, 4, 6, jcfg.d_model), seed=4))
    for t in tree_leaves(P):
        t.requires_grad_(True)
    vo, va = vmap(lambda p, x: tmoe.moe_forward(p, x, cfg))(P, X)
    (vo.square().sum() + va.sum()).backward()
    for i, lane in enumerate(lanes):
        for t in tree_leaves(lane):
            t.requires_grad_(True)
        o, a = tmoe.moe_forward(lane, X[i], cfg)
        (o.square().sum() + a).backward()
        assert torch.equal(vo[i], o) and torch.equal(va[i], a)
        for got, want in zip(tree_leaves(P), tree_leaves(lane)):
            torch.testing.assert_close(got.grad[i], want.grad, atol=1e-5,
                                       rtol=1e-5)


# ---------------------------------------------------------------------------
# the backbone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fixture", ["tiny_moe", "qwen3"])
def test_backbone_logits_exits_and_aux_match_jax(fixture, request):
    """Train-shape forward, then prefill into a cache and two decode
    ticks: logits, exit logits and the aux total against JAX."""
    jcfg = request.getfixturevalue(fixture).with_(kernels="ref")
    cfg = config_from_jax(jcfg)
    jp = jbackbone.init_backbone(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(_np(jp), cfg, device="cpu")
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 10))
    jo = jbackbone.backbone_forward(jp, jcfg, tokens=jnp.asarray(toks))
    to = tbackbone.backbone_forward(tp, cfg, tokens=torch.from_numpy(toks))
    _close(to.logits, jo.logits, TOL_LOGITS)
    for got, want in zip(to.exit_logits, jo.exit_logits, strict=True):
        _close(got, want, TOL_LOGITS)
    _close(to.aux_loss, jo.aux_loss, TOL_ROUTE)
    assert float(to.aux_loss) > 0

    prompt = toks[:1, :7]
    jc = jbackbone.init_cache(jcfg, 1, 16, jnp.float32)
    tc = tbackbone.init_cache(cfg, 1, 16, torch.float32, "cpu")
    jo = jbackbone.backbone_forward(jp, jcfg, tokens=jnp.asarray(prompt),
                                    cache=jc, cache_len=jnp.int32(0))
    to = tbackbone.backbone_forward(
        tp, cfg, tokens=torch.from_numpy(prompt), cache=tc,
        cache_len=torch.zeros(1, dtype=torch.int32))
    _close(to.logits, jo.logits, TOL_LOGITS)
    _close(to.aux_loss, jo.aux_loss, TOL_ROUTE)
    jcache = jo.cache
    for t in range(2):
        tok = np.array([[int(np.argmax(np.asarray(jo.logits)[0, -1]))]])
        jo = jbackbone.backbone_forward(jp, jcfg, tokens=jnp.asarray(tok),
                                        cache=jcache,
                                        cache_len=jnp.int32(7 + t))
        jcache = jo.cache
        to = tbackbone.backbone_forward(
            tp, cfg, tokens=torch.from_numpy(tok), cache=to.cache,
            cache_len=torch.full((1,), 7 + t, dtype=torch.int32),
            moe_groups=1)
        _close(to.logits, jo.logits, TOL_LOGITS)
        for got, want in zip(to.exit_logits, jo.exit_logits, strict=True):
            _close(got, want, TOL_LOGITS)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen3_weights(qwen3):
    jp = jbackbone.init_backbone(jax.random.PRNGKey(0), qwen3)
    return jp, params_from_jax(_np(jp), config_from_jax(qwen3), device="cpu")


@pytest.mark.parametrize("policy", ["select", "sticky"])
def test_serve_session_matches_jax(policy, qwen3, qwen3_weights,
                                   monkeypatch):
    """The qwen3 smoke served by both packages: 6 requests on 3 slots,
    tokens and gate decisions equal, entropies 1e-4.  JAX routes each
    slot alone (``vmap`` of a one-row step); the port routes one group
    per slot.  Prefill drops tokens (asserted), so the C-1 rule is on
    the compared path."""
    jp, tp = qwen3_weights
    cfg = config_from_jax(qwen3)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, qwen3.vocab_size, int(rng.integers(5, 9)))
               for _ in range(6)]
    decodes = [5, 7, 3, 6, 4, 6]
    probe = JaxServeSession(qwen3, jp, tau=0.0, slots=1, max_len=24)
    probe.submit(prompts[0], decode_tokens=6)
    tau = float(np.median(probe.run()[0].entropy))

    drops = {"prefill": 0, "decode": 0}
    real = tmoe.moe_forward

    def counting(params, x, c, groups=1):
        load, C = _loads(params, x, c, groups)
        n = int((load - torch.where(load > C, C - 1, load)).sum())
        drops["prefill" if x.shape[1] > 1 else "decode"] += n
        return real(params, x, c, groups)

    monkeypatch.setattr(tmoe, "moe_forward", counting)
    sess = ServeSession(cfg, tp, tau=tau, slots=3, max_len=24,
                        exit_policy=policy, device="cpu")
    jsess = JaxServeSession(qwen3, jp, tau=tau, slots=3, max_len=24,
                            exit_policy=policy)
    for p, d in zip(prompts, decodes):
        sess.submit(p, decode_tokens=d)
        jsess.submit(p, decode_tokens=d)
    got = {r.rid: r for r in sess.run()}
    want = {r.rid: r for r in jsess.run()}
    print(f"reading qwen3 smoke {policy}: entries dropped in prefill "
          f"{drops['prefill']}, in decode {drops['decode']}")
    assert drops["prefill"] > 0 and drops["decode"] == 0
    assert sorted(got) == sorted(want) == list(range(6))
    flags = []
    for rid in range(6):
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].exited == want[rid].exited, rid
        np.testing.assert_allclose(got[rid].entropy, want[rid].entropy,
                                   atol=1e-4)
        flags += got[rid].exited
    assert any(flags) and not all(flags)
    if policy == "sticky":
        assert sess.stats.client_only_ticks > 0


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fixture,splits", [("tiny_moe", (1, 1, 1, 1)),
                                            ("qwen3", (2, 2, 2, 2))])
def test_make_train_step_eq1_with_aux_matches_jax(fixture, splits, request):
    """eq1 steps with the router aux loss in the server loss: every
    metric (``aux_loss`` included) 1e-5, Adam's first moments after the
    first step 1e-6 (the gradients), parameters as
    tests/test_torch_train.py holds them."""
    jcfg = request.getfixturevalue(fixture)
    lr = 1e-3
    opt_j = jconfig.OptimizerConfig(lr=lr, total_steps=10, warmup_steps=1)
    opt_t = tconfig.OptimizerConfig(lr=lr, total_steps=10, warmup_steps=1)
    jsc = jspmd.StepConfig(
        model=jcfg.with_(kernels="ref"),
        splitee=jconfig.SplitEEConfig(profile=jconfig.HeteroProfile(splits)),
        train=jconfig.TrainConfig(optimizer=opt_j))
    tsc = tspmd.StepConfig(
        model=config_from_jax(jcfg),
        splitee=tconfig.SplitEEConfig(profile=tconfig.HeteroProfile(splits)),
        train=tconfig.TrainConfig(optimizer=opt_t))
    jp = jbackbone.init_backbone(jax.random.PRNGKey(0), jcfg)
    jo = jadam.adam_init(jp, jsc.train.optimizer)
    tp = params_from_jax(_np(jp), tsc.model, device="cpu")
    to = tadam.adam_init(tp, tsc.train.optimizer)
    jstep, tstep = jax.jit(jspmd.make_train_step(jsc)), \
        tspmd.make_train_step(tsc)
    rng = np.random.default_rng(7)
    sids = np.asarray(jspmd.boundary_ids_for_batch(
        jconfig.HeteroProfile(splits), jcfg, 4))
    for i in range(2):
        b = {"tokens": rng.integers(0, jcfg.vocab_size, (4, 8)).astype(
                 np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (4, 8)).astype(
                 np.int32),
             "split_ids": sids}
        jp, jo, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, b))
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(np.array(v))
                                    for k, v in b.items()})
        assert sorted(tm) == sorted(jm)
        assert float(tm["aux_loss"]) > 0
        for k in tm:
            _close(tm[k] if k != "lr" else np.float32(tm[k]), jm[k], TOL)
        if i == 0:
            want = params_from_jax(_np(jo.m), tsc.model, device="cpu")
            for g, w in zip(tree_leaves(to.m), tree_leaves(want),
                            strict=True):
                _close(g, w, 1e-6)
    want = params_from_jax(_np(jp), tsc.model, device="cpu")
    d = torch.cat([(g - w).abs().flatten() for g, w in
                   zip(tree_leaves(tp), tree_leaves(want), strict=True)])
    assert d.max().item() <= lr
    assert (d > 1e-6).sum().item() <= 1e-4 * d.numel()

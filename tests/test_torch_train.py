"""The port's training path against the JAX package's, on the CPU.

Weights come from the JAX ``init_backbone`` through ``repro_torch.convert``
and inputs from seeded numpy, so both packages see the same numbers.  The
JAX side runs with ``kernels="ref"``, except at the attention site, where
its Pallas kernels run in interpret mode as its own tests run them.  On
the CPU the port's kernel wrappers run their plain versions; the CUDA
backward kernels are held against them in tests/test_torch_cuda.py and
chip_smoke.py.

Tolerances (fp32 everywhere):
  * 2e-4 backward plain version vs the JAX backward kernels (the JAX
    kernel-level gate), 1e-4 the autograd site (the site-level gate);
  * 1e-6 losses, schedule and one Adam update (reassociation only);
  * 1e-5 train-step losses and gradients (gradients read from the first
    Adam moment, m = (1 - b1) g after one step);
  * params after 2-3 Adam steps (lr 1e-3): at most 1 element in 10^4 off
    by more than 1e-6, and none by more than lr.  Adam's first steps divide
    by sqrt(v) ~ |g|, so a gradient element near zero turns a 1e-9
    difference into an update difference of up to lr (seen: 1-4 elements
    of 2.7M, at most 1.8e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as jconfig
from repro import configs as jconfigs
from repro.core import losses as jlosses
from repro.core import spmd as jspmd
from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.models import backbone as jbackbone
from repro.optim import adam as jadam
from repro.optim import schedule as jschedule
import repro_torch.config as tconfig
from repro_torch.convert import (adam_state_from_jax, config_from_jax,
                                 params_from_jax)
from repro_torch.core import losses as tlosses
from repro_torch.core import spmd as tspmd
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels.flash_attention import flash_attention_bwd
from repro_torch.kernels.ref import flash_attention_bwd_ref
from repro_torch.launch import e2e_train
from repro_torch.models import backbone as tbackbone
from repro_torch.optim import adam as tadam
from repro_torch.optim import schedule as tschedule
from repro_torch.tree import tree_leaves

LR = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=0)


def _close_trees(got_tree, want_tree, cfg, atol):
    """A port tree against a JAX tree (converted to the port's layout)."""
    want = params_from_jax(_np(want_tree), cfg, device="cpu")
    got_l, want_l = list(tree_leaves(got_tree)), list(tree_leaves(want))
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        _close(g.float(), w.float(), atol)


def _close_params(got_tree, want_tree, cfg=None):
    """Parameters after a few Adam steps (see the module docstring)."""
    want = (want_tree if cfg is None
            else params_from_jax(_np(want_tree), cfg, device="cpu"))
    d = torch.cat([(g.float() - w.float()).abs().flatten() for g, w in
                   zip(tree_leaves(got_tree), tree_leaves(want))])
    assert d.max().item() <= LR
    assert (d > 1e-6).sum().item() <= 1e-4 * d.numel()


@pytest.fixture(scope="module")
def smoke_cfg():
    return jconfigs.get("glm4-9b").smoke()


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["OptimizerConfig", "TrainConfig"])
def test_train_config_fields_mirror_jax(name):
    j, t = getattr(jconfig, name)(), getattr(tconfig, name)()
    assert ([f.name for f in dataclasses.fields(t)]
            == [f.name for f in dataclasses.fields(j)])
    for f in dataclasses.fields(t):
        if f.name == "optimizer":
            continue
        jv, tv = getattr(j, f.name), getattr(t, f.name)
        if f.name == "state_dtype":
            assert tv == torch.float32 and jv == jnp.float32
        else:
            assert tv == jv, f.name


def test_step_config_train_is_a_train_config(smoke_cfg):
    sc = tspmd.StepConfig(model=config_from_jax(smoke_cfg),
                          splitee=tconfig.SplitEEConfig(
                              profile=tconfig.HeteroProfile((1, 2))))
    assert isinstance(sc.train, tconfig.TrainConfig)
    with pytest.raises(ValueError, match="grad_mode"):
        tspmd.make_train_step(dataclasses.replace(sc, grad_mode="avg"))


# ---------------------------------------------------------------------------
# flash-attention backward: plain version and autograd site
# ---------------------------------------------------------------------------

# (H, Hkv, Tq, Tk, causal, window)
BWD_CASES = [
    (4, 2, 12, 12, True, None),       # causal, GQA 2
    (8, 2, 12, 12, True, 5),          # sliding window
    (16, 1, 10, 10, True, None),      # GQA 16, as glm4-9b
    (4, 1, 9, 13, False, None),       # non-causal, ragged Tq < Tk
    (8, 4, 11, 11, False, 4),         # non-causal window
]


def _qkv_do(seed, B, H, Hkv, Tq, Tk, D=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Tq, D), np.float32),
            rng.standard_normal((B, Hkv, Tk, D), np.float32),
            rng.standard_normal((B, Hkv, Tk, D), np.float32),
            rng.standard_normal((B, H, Tq, D), np.float32))


@pytest.mark.parametrize("H,Hkv,Tq,Tk,causal,window", BWD_CASES)
def test_flash_attention_bwd_ref_matches_jax_kernels(H, Hkv, Tq, Tk, causal,
                                                     window):
    q, k, v, do = _qkv_do(0, 2, H, Hkv, Tq, Tk)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = jops.flash_attention_fwd(jq, jk, jv, causal=causal,
                                      window=window, interpret=True)
    want = jops.flash_attention_bwd(jq, jk, jv, o, lse, jdo, causal=causal,
                                    window=window, interpret=True)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got = flash_attention_bwd_ref(t(q), t(k), t(v), t(o), t(lse), t(do),
                                  causal=causal, window=window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, 2e-4)
    # the wrapper runs the plain version for CPU tensors
    wrapped = flash_attention_bwd(t(q), t(k), t(v), t(o), t(lse), t(do),
                                  causal=causal, window=window)
    for g, w in zip(wrapped, got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("H,Hkv,Tq,Tk,causal,window", BWD_CASES)
def test_fused_delta_dq_plain_path_matches_jax(H, Hkv, Tq, Tk, causal,
                                               window):
    """The dQ wrapper's fused form (``o=``: delta = rowsum(dO * O) formed
    beside dQ, as the dQ tile route does on the card) runs its plain
    version on the CPU: dQ within the 2e-4 kernel gate of the JAX backward
    kernels (interpret mode), delta within 1e-5 of the same fp32 sum in
    JAX (16 products of magnitude up to ~10 summed in another order:
    reassociation only)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_dq
    q, k, v, do = _qkv_do(3, 2, H, Hkv, Tq, Tk)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = jops.flash_attention_fwd(jq, jk, jv, causal=causal,
                                      window=window, interpret=True)
    want_dq, _, _ = jops.flash_attention_bwd(jq, jk, jv, o, lse, jdo,
                                             causal=causal, window=window,
                                             interpret=True)
    want_delta = jnp.sum(jdo * o, axis=-1)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    dq, delta = flash_attention_bwd_dq(t(q), t(k), t(v), t(do), t(lse),
                                       o=t(o), causal=causal, window=window)
    assert dq.dtype == delta.dtype == torch.float32
    assert delta.shape == (2, H, Tq)
    _close(dq, want_dq, 2e-4)
    _close(delta, want_delta, 1e-5)
    # the given-delta form with that delta gives the same dQ
    assert torch.equal(flash_attention_bwd_dq(
        t(q), t(k), t(v), t(do), t(lse), delta, causal=causal,
        window=window), dq)


def test_dq_wrapper_takes_exactly_one_of_delta_and_o():
    from repro_torch.kernels.flash_attention import flash_attention_bwd_dq
    q, k, v, do = (torch.from_numpy(a) for a in _qkv_do(4, 1, 4, 2, 6, 6))
    lse = torch.zeros(1, 4, 6)
    with pytest.raises(ValueError, match="exactly one"):
        flash_attention_bwd_dq(q, k, v, do, lse)
    with pytest.raises(ValueError, match="exactly one"):
        flash_attention_bwd_dq(q, k, v, do, lse, lse, o=q)
    with pytest.raises(ValueError, match="output shape"):
        flash_attention_bwd_dq(q, k, v, do, lse, o=q[:, :, :5])


def test_flash_attention_bwd_casts_to_primal_dtypes_and_checks():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _qkv_do(1, 1, 4, 2, 6, 6))
    lse = torch.zeros(1, 4, 6)
    dq, dk, dv = flash_attention_bwd(q, k, v, q, lse, do)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    assert dk.shape == k.shape and dq.shape == q.shape
    with pytest.raises(ValueError, match="lse shape"):
        flash_attention_bwd(q, k, v, q, lse[:, :, :5], do)
    meta = [t.to("meta") for t in (q, k, v, q, lse, do)]
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_bwd(*meta)


@pytest.mark.parametrize("H,Hkv,Tq,Tk,causal,window", [
    c for c in BWD_CASES if c[2] == c[3] and c[4]])
def test_autograd_site_matches_jax_pallas_grads(H, Hkv, Tq, Tk, causal,
                                                window):
    """CudaBackend.attention on CPU tensors runs FlashAttentionFn with the
    plain forward and backward; JAX differentiates PallasBackend.attention
    (its custom_vjp over the backward kernels, interpret mode)."""
    q, k, v, do = (np.swapaxes(a, 1, 2) for a in _qkv_do(2, 2, H, Hkv, Tq,
                                                          Tk))
    jb = jdispatch.get_backend("pallas")
    f = lambda a, b, c: jb.attention(a, b, c, causal=causal,  # noqa: E731
                                     window=window)
    jout, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
                  for a in (q, k, v))
    out = tdispatch.get_backend("auto").attention(tq, tk, tv, causal=causal,
                                                  window=window)
    assert (type(out.grad_fn.next_functions[0][0]).__name__
            == "FlashAttentionFnBackward")
    out.backward(torch.from_numpy(np.ascontiguousarray(do)))
    _close(out, jout, 1e-4)
    for g, w in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _close(g, w, 1e-4)

    # and against autograd of the plain forward (the ref backend)
    rq, rk, rv = (t.detach().clone().requires_grad_() for t in (tq, tk, tv))
    ref = tdispatch.get_backend("ref").attention(rq, rk, rv, causal=causal,
                                                 window=window)
    ref.backward(torch.from_numpy(np.ascontiguousarray(do)))
    for g, w in zip((tq.grad, tk.grad, tv.grad), (rq.grad, rk.grad, rv.grad)):
        _close(g, w, 1e-5)


# ---------------------------------------------------------------------------
# losses, schedule, Adam
# ---------------------------------------------------------------------------


def test_cross_entropy_and_accuracy_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 6, 31), np.float32) * 3
    labels = rng.integers(0, 31, (4, 6)).astype(np.int32)
    labels[0, :3] = logits[0, :3].argmax(-1)        # some hits
    mask = (rng.random((4, 6)) > 0.4).astype(np.float32)
    tl, tlab, tm = map(torch.from_numpy, (logits, labels, mask))
    jl, jlab, jm = map(jnp.asarray, (logits, labels, mask))
    for m_t, m_j in ((None, None), (tm, jm), (tm * 0, jm * 0)):
        _close(tlosses.softmax_cross_entropy(tl, tlab, m_t),
               jlosses.softmax_cross_entropy(jl, jlab, m_j), 1e-6)
        _close(tlosses.accuracy(tl, tlab, m_t),
               jlosses.accuracy(jl, jlab, m_j), 1e-6)


@pytest.mark.parametrize("warmup", [0, 5])
def test_cosine_schedule_matches_jax(warmup):
    for step in (0, 1, 3, 5, 6, 17, 40, 41, 100):
        want = float(jschedule.cosine_schedule(step, 1e-3, 1e-6, 40, warmup))
        got = tschedule.cosine_schedule(step, 1e-3, 1e-6, 40, warmup)
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12)
    opt = tconfig.OptimizerConfig(schedule="constant", lr=0.25)
    assert tschedule.make_schedule(opt)(7) == 0.25
    with pytest.raises(ValueError, match="schedule"):
        tschedule.make_schedule(dataclasses.replace(opt, schedule="step"))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip,wd,scaled", [(0.0, 0.0, False),
                                            (0.5, 0.1, True),
                                            (100.0, 0.0, True)])
def test_adam_update_matches_jax(state_dtype, clip, wd, scaled):
    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((5, 3), np.float32),
              "b": [rng.standard_normal((4,), np.float32),
                    rng.standard_normal((2, 2), np.float32)]}
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape, np.float32),
                          params) for _ in range(3)]
    scales = {"a": 0.5, "b": [2.0, 0.0]} if scaled else None
    jopt_cfg = jconfig.OptimizerConfig(grad_clip=clip, weight_decay=wd,
                                       state_dtype=getattr(jnp, state_dtype))
    topt_cfg = tconfig.OptimizerConfig(grad_clip=clip, weight_decay=wd,
                                       state_dtype=getattr(torch, state_dtype))
    jp = jax.tree.map(jnp.asarray, params)
    js = jadam.adam_init(jp, jopt_cfg)
    tt = lambda tree: jax.tree.map(torch.from_numpy, tree)  # noqa: E731
    tp = tt(jax.tree.map(np.copy, params))
    ts = tadam.adam_init(tp, topt_cfg)
    for g in grads:
        jscales = (None if scales is None
                   else jax.tree.map(jnp.float32, scales))
        jp, js = jadam.adam_update(jp, jax.tree.map(jnp.asarray, g), js,
                                   jopt_cfg, 1e-2, jscales)
        tp, ts = tadam.adam_update(tp, tt(g), ts, topt_cfg, 1e-2, scales)
    assert ts.step == int(js.step) == 3
    for want, got in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
        for w, t in zip(jax.tree.leaves(want), tree_leaves(got)):
            assert t.dtype == getattr(torch, str(w.dtype))
            _close(t.float(), np.asarray(w, np.float32), 1e-6)


def test_adam_treats_a_missing_gradient_as_zero():
    opt = tconfig.OptimizerConfig()
    p = {"w": torch.ones(3)}
    s = tadam.adam_init(p, opt)
    p, s = tadam.adam_update(p, {"w": torch.ones(3)}, s, opt, 0.1)
    moved = p["w"].clone()
    p, s = tadam.adam_update(p, {"w": None}, s, opt, 0.1)
    # momentum still moves the parameter, as a zero gradient would
    p0 = {"w": torch.ones(3)}
    s0 = tadam.adam_init(p0, opt)
    p0, s0 = tadam.adam_update(p0, {"w": torch.ones(3)}, s0, opt, 0.1)
    p0, s0 = tadam.adam_update(p0, {"w": torch.zeros(3)}, s0, opt, 0.1)
    assert not torch.equal(p["w"], moved)
    assert torch.equal(p["w"], p0["w"]) and torch.equal(s.v["w"], s0.v["w"])


# ---------------------------------------------------------------------------
# split ids, Eq. (1) scales, split routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("splits,batch", [((1, 1, 2, 2), 8),
                                          ((2, 1, 2), 7),
                                          ((1,) * 4 + (2,) * 4 + (3,) * 4,
                                           12)])
def test_boundary_ids_and_scale_trees_match_jax(tiny_dense, splits, batch):
    jcfg = tiny_dense.with_(exit_layers=tuple(sorted(set(splits))))
    cfg = config_from_jax(jcfg)
    prof_j = jconfig.HeteroProfile(splits)
    prof_t = tconfig.HeteroProfile(splits)
    ids = tspmd.boundary_ids_for_batch(prof_t, cfg, batch, device="cpu")
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(jspmd.boundary_ids_for_batch(prof_j, jcfg,
                                                             batch)))
    jp = jbackbone.init_backbone(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(_np(jp), cfg, device="cpu")
    for want, got in zip(jspmd.participation_scale_trees(jp, jcfg, prof_j),
                         tspmd.participation_scale_trees(tp, cfg, prof_t)):
        # one scalar per port leaf; the JAX leaf broadcasts per layer
        want_t = params_from_jax(
            jax.tree.map(lambda s, p: np.broadcast_to(np.asarray(s), p.shape)
                         if np.ndim(s) else np.asarray(s), want, jp),
            cfg, device="cpu")
        for g, w in zip(tree_leaves(got), tree_leaves(want_t)):
            assert isinstance(g, float)
            assert np.all(w.numpy() == np.float32(g))


@pytest.mark.parametrize("remat", [False, True])
def test_split_routing_gradients_match_jax(tiny_dense, remat):
    jcfg = tiny_dense
    cfg = config_from_jax(jcfg)
    prof = jconfig.HeteroProfile((1, 1, 2, 2))
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, (4, 8)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (4, 8)).astype(np.int32)
    sids = np.array(jspmd.boundary_ids_for_batch(prof, jcfg, 4))
    jp = jbackbone.init_backbone(jax.random.PRNGKey(1), jcfg)

    def jloss(p, which):
        out = jbackbone.backbone_forward(p, jcfg, tokens=jnp.asarray(toks),
                                         split_ids=jnp.asarray(sids))
        c, s, _ = jspmd.hetero_losses(out, jnp.asarray(labels),
                                      jnp.asarray(sids), 2)
        return (c, s)[which]

    jgrad = jax.jit(jax.grad(jloss), static_argnums=1)
    tp = params_from_jax(_np(jp), cfg, device="cpu")
    leaves = list(tree_leaves(tp))
    for p in leaves:
        p.requires_grad_(True)
    out = tbackbone.backbone_forward(tp, cfg, tokens=torch.from_numpy(toks),
                                     split_ids=torch.from_numpy(sids),
                                     remat=remat)
    losses = tspmd.hetero_losses(out, torch.from_numpy(labels),
                                 torch.from_numpy(sids), 2)
    for which in (0, 1):
        _close(losses[which], jloss(jp, which), 1e-5)
        got = torch.autograd.grad(losses[which], leaves, retain_graph=True,
                                  allow_unused=True)
        want = params_from_jax(_np(jgrad(jp, which)), cfg, device="cpu")
        for g, w in zip(got, tree_leaves(want)):
            _close(torch.zeros_like(w) if g is None else g, w, 1e-5)
    # the server loss never reaches the embedding: every example is cut
    g_embed = torch.autograd.grad(losses[1], tp["embed"]["table"],
                                  allow_unused=True)[0]
    assert g_embed is None or not g_embed.any()


# ---------------------------------------------------------------------------
# train steps against JAX
# ---------------------------------------------------------------------------


def _step_configs(jcfg, splits, grad_mode):
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


def _batches(jcfg, splits, n, B=4, T=8, seed=7):
    rng = np.random.default_rng(seed)
    sids = np.asarray(jspmd.boundary_ids_for_batch(
        jconfig.HeteroProfile(splits), jcfg, B))
    return [{"tokens": rng.integers(0, jcfg.vocab_size, (B, T)).astype(
                 np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (B, T)).astype(
                 np.int32),
             "split_ids": sids} for _ in range(n)]


def _jstep(jsc, sequential):
    make = (jspmd.make_sequential_train_step if sequential
            else jspmd.make_train_step)
    return jax.jit(make(jsc))


def _tstep(tsc, sequential):
    make = (tspmd.make_sequential_train_step if sequential
            else tspmd.make_train_step)
    return make(tsc)


def _tbatch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


@pytest.mark.parametrize("fixture", ["tiny_dense", "smoke_cfg"])
@pytest.mark.parametrize("mode", ["eq1", "sum", "sequential"])
def test_train_step_matches_jax(fixture, mode, request):
    jcfg = request.getfixturevalue(fixture)
    splits = (1, 1, 2, 2)
    sequential = mode == "sequential"
    jsc, tsc = _step_configs(jcfg, splits, "eq1" if sequential else mode)
    jp = jbackbone.init_backbone(jax.random.PRNGKey(0), jcfg)
    jo = jadam.adam_init(jp, jsc.train.optimizer)
    tp = params_from_jax(_np(jp), tsc.model, device="cpu")
    to = tadam.adam_init(tp, tsc.train.optimizer)
    jstep, tstep = _jstep(jsc, sequential), _tstep(tsc, sequential)
    for i, b in enumerate(_batches(jcfg, splits, 3)):
        jp, jo, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, b))
        tp, to, tm = tstep(tp, to, _tbatch(b))
        assert sorted(tm) == sorted(jm)
        for k in tm:
            _close(tm[k] if k != "lr" else np.float32(tm[k]), jm[k], 1e-5)
        if i == 0 and not sequential:
            # gradients: m = (1 - b1) g after the first update
            _close_trees(to.m, jo.m, tsc.model, 1e-6)
    assert to.step == int(jo.step)
    _close_params(tp, jp, tsc.model)


def test_train_step_with_remat_equals_without(smoke_cfg):
    splits = (1, 1, 2, 2)
    _, tsc = _step_configs(smoke_cfg, splits, "eq1")
    rsc = dataclasses.replace(tsc, train=dataclasses.replace(
        tsc.train, remat="full"))
    jp = _np(jbackbone.init_backbone(jax.random.PRNGKey(0), smoke_cfg))
    runs = []
    for sc in (tsc, rsc):
        tp = params_from_jax(jp, sc.model, device="cpu")
        to = tadam.adam_init(tp, sc.train.optimizer)
        step = tspmd.make_train_step(sc)
        for b in _batches(smoke_cfg, splits, 2):
            tp, to, m = step(tp, to, _tbatch(b))
        runs.append((tp, to, m))
    (p0, o0, m0), (p1, o1, m1) = runs
    for k in m0:
        _close(torch.as_tensor(m1[k]), torch.as_tensor(m0[k]), 1e-6)
    for a, b in zip(tree_leaves(o0.m), tree_leaves(o1.m)):
        _close(a, b, 1e-7)
    _close_params(p1, p0)


def test_adam_state_from_jax_continues_a_jax_run(tiny_dense):
    """JAX takes two steps; the port takes the third from the converted
    params and Adam state, and lands where JAX's third step does."""
    splits = (1, 1, 2, 2)
    jsc, tsc = _step_configs(tiny_dense, splits, "eq1")
    jp = jbackbone.init_backbone(jax.random.PRNGKey(2), tiny_dense)
    jo = jadam.adam_init(jp, jsc.train.optimizer)
    jstep = _jstep(jsc, False)
    b1, b2, b3 = _batches(tiny_dense, splits, 3, seed=9)
    for b in (b1, b2):
        jp, jo, _ = jstep(jp, jo, jax.tree.map(jnp.asarray, b))
    tp = params_from_jax(_np(jp), tsc.model, device="cpu")
    to = adam_state_from_jax(_np(jo), tsc.model, device="cpu")
    assert to.step == 2
    jp3, jo3, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, b3))
    tp, to, tm = tspmd.make_train_step(tsc)(tp, to, _tbatch(b3))
    _close(tm["server_loss"], jm["server_loss"], 1e-5)
    assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    _close_trees(to.m, jo3.m, tsc.model, 1e-6)
    _close_params(tp, jp3, tsc.model)


# ---------------------------------------------------------------------------
# the end-to-end loop (launch/e2e_train.py)
# ---------------------------------------------------------------------------


def test_e2e_train_runs_on_cpu(capsys):
    res = e2e_train.main(["--smoke", "--layers", "4", "--steps", "3",
                          "--batch", "12", "--seq", "8", "--device", "cpu",
                          "--log-every", "1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("model: glm4-9b-smoke 4L d=256")
    assert "exits=(1, 2, 3)" in out[0] and "device=cpu" in out[0]
    assert out[1] == ("hetero profile (12 clients): "
                      "(1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3)")
    assert sum(line.startswith("step ") for line in out) == 3
    assert out[-1].startswith("loss: first=")
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    assert res["opt"].step == 3


def test_e2e_train_needs_cuda_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        e2e_train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tspmd.boundary_ids_for_batch(tconfig.HeteroProfile((1,)),
                                     config_from_jax(
                                         jconfigs.get("glm4-9b").smoke()), 2)
    with pytest.raises(ValueError, match="at least 4 layers"):
        e2e_train.cut_depth(config_from_jax(jconfigs.get("glm4-9b").smoke()),
                            3)

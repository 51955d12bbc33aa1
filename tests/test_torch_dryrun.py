"""The port's dry run and step analysis against the JAX package's HLO
counts, on the CPU at smoke sizes.

``launch/step_analysis.StepAnalysis`` counts what the port runs eagerly;
``repro.launch.hlo_analysis.analyze`` counts the JAX package's compiled
HLO.  Both count dot and convolution FLOPs at 2 x output x contraction, so
on the same work they agree exactly: the port's ``kernels="ref"`` backend
against the JAX package's ``kernels="ref"`` (``flops + site_op_flops``,
the plain versions' work inside the sites included).  Also here: the
site counters against the JAX functions, the meta input stand-ins against
``repro.launch.inputs``, the fake path of the kernel wrappers (nothing
launched, the card's output layouts), a fake trace against a real CPU run
of the same step, the peak of a hand-built region, and ``dryrun.run_one``
on four architectures at their published widths, depth cut.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

import repro.config as jconfig
from repro import configs as jconfigs
from repro.core import spmd as jspmd
from repro.kernels import dispatch as jdispatch
from repro.launch import inputs as jinputs
from repro.launch.hlo_analysis import analyze
from repro.models import backbone as jbackbone
from repro.optim import adam as jadam
import repro_torch.config as tconfig
from repro_torch import configs as tconfigs
from repro_torch.convert import config_from_jax, params_from_jax
from repro_torch.core import spmd as tspmd
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import sites
from repro_torch.kernels.entropy_exit import entropy_exit
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_dkv,
                                                 flash_attention_bwd_dq)
from repro_torch.kernels.rwkv_wkv import rwkv_wkv, rwkv_wkv_bwd, rwkv_wkv_fwd
from repro_torch.launch import dryrun
from repro_torch.launch import inputs as tinputs
from repro_torch.launch.shardings import jax_layout, tree_paths
from repro_torch.launch.step_analysis import StepAnalysis
from repro_torch.models.backbone import backbone_forward
from repro_torch.optim import adam as tadam
from repro_torch.tree import tree_leaves, tree_map

B, T = 2, 32
COUNT_ARCHS = ["glm4-9b", "rwkv6-3b", "zamba2-1.2b", "qwen3-moe-235b-a22b"]
WRAPPERS = (flash_attention, flash_attention_bwd, flash_attention_bwd_dkv,
            flash_attention_bwd_dq, rwkv_wkv, rwkv_wkv_bwd, entropy_exit)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(cfg, b=B, t=T, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)


def _setup(arch):
    """The JAX smoke config with the ``ref`` backend, its weights, and the
    port's config (``kernels="ref"``) and weights on the CPU."""
    jc = jconfigs.get(arch).smoke().with_(kernels="ref")
    jp = jbackbone.init_backbone(jax.random.PRNGKey(0), jc)
    tc = config_from_jax(jc).with_(kernels="ref")
    return jc, jp, tc, params_from_jax(_np(jp), tc, device="cpu")


def _jax_flops(fn, *args) -> float:
    return analyze(jax.jit(fn).lower(*args).compile().as_text())["flops"]


def _counted(r) -> float:
    return r["flops"] + r["site_op_flops"]


# ---------------------------------------------------------------------------
# the analysis against the JAX package's HLO count
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", COUNT_ARCHS)
def test_forward_counts_equal_jax_hlo(arch):
    """The forward with every output kept (logits and all exit logits; a
    JAX function returning only the logits lets XLA drop the exit heads):
    the port's count equals the HLO's exactly.  The ``auto`` backend on
    the CPU counts the same work outside the sites and the same sites;
    only its plain versions' own FLOPs inside them may differ (the wkv's
    mirror the kernel's factored algebra)."""
    jc, jp, tc, tp = _setup(arch)
    toks = _tokens(jc)

    def fwd(p, t):
        o = jbackbone.backbone_forward(p, jc, tokens=t)
        return o.logits, o.exit_logits

    want = _jax_flops(fwd, jp, toks)
    got = {}
    for kern in ("ref", "auto"):
        with torch.no_grad(), StepAnalysis() as a:
            backbone_forward(tp, tc.with_(kernels=kern),
                             tokens=torch.as_tensor(toks))
        got[kern] = a.result()
    print(f"reading forward FLOPs {arch}: JAX HLO {want:.0f}, port "
          f"{_counted(got['ref']):.0f} (aten {got['ref']['flops']:.0f}, in "
          f"sites {got['ref']['site_op_flops']:.0f}), auto's sites "
          f"{got['auto']['site_op_flops']:.0f}")
    assert _counted(got["ref"]) == want
    for key in ("flops", "site_flops", "site_calls", "site_bytes"):
        assert got["auto"][key] == got["ref"][key], key
    assert got["ref"]["site_calls"]


def _gradient_counts(arch, tp, tc, toks, w):
    """The port's counted FLOPs of the forward and of the gradient of the
    weighted sum of every output against every parameter."""
    leaves = list(tree_leaves(tp))
    tw = torch.as_tensor(w)
    with torch.no_grad(), StepAnalysis() as fwd:
        backbone_forward(tp, tc, tokens=torch.as_tensor(toks))
    for p in leaves:
        p.requires_grad_(True)
    with StepAnalysis() as a:
        o = backbone_forward(tp, tc, tokens=torch.as_tensor(toks))
        outs = (o.logits, *o.exit_logits)
        total = sum((x * tw[i]).sum() for i, x in enumerate(outs))
        torch.autograd.grad(total, leaves, allow_unused=True)
    return _counted(fwd.result()), _counted(a.result())


def _output_weights(jc):
    n = len(jc.exit_layers) + 1
    return np.random.default_rng(1).normal(
        size=(n, B, T, jc.vocab_size)).astype(np.float32)


@pytest.mark.parametrize("arch", COUNT_ARCHS[:3])
def test_gradient_counts_three_forwards(arch):
    """The gradient of a sum over every output (each weighted by a fixed
    random tensor), against every parameter: autograd runs each product of
    the forward once more for dX and once for dW (the embedding is a
    gather, and every product's operands require grad), so the port reads
    exactly 3 x its forward count."""
    jc, _, tc, tp = _setup(arch)
    fwd, grad = _gradient_counts(arch, tp, tc, _tokens(jc), _output_weights(jc))
    assert grad == 3 * fwd


def test_gradient_counts_against_jax_hlo():
    """The same gradient on the glm4-9b smoke against the JAX HLO count:
    the HLO reads 5.13 % lower (981,467,136 against 1,031,798,784; 5.4 %
    and 7.2 % on the rwkv6-3b and zamba2-1.2b smokes): fewer dot FLOPs
    survive XLA:CPU's compilation of the gradient than autograd runs (the
    forward alone agrees exactly, above), so the port is held to its own
    exact count and the HLO as a bound."""
    jc, jp, tc, tp = _setup("glm4-9b")
    toks, w = _tokens(jc), _output_weights(jc)

    def loss(p, t, w):
        o = jbackbone.backbone_forward(p, jc, tokens=t)
        outs = (o.logits, *o.exit_logits)
        return sum((x * w[i]).sum() for i, x in enumerate(outs))

    want = _jax_flops(jax.grad(loss), jp, toks, w)
    _, got = _gradient_counts("glm4-9b", tp, tc, toks, w)
    print(f"reading gradient FLOPs glm4-9b: JAX HLO {want:.0f}, port "
          f"{got:.0f} ({got / want - 1:+.3%})")
    assert want <= got <= 1.08 * want


def _train_setup(mode, kernels, splits=(1, 1, 2, 2), b=4):
    jcfg = jconfigs.get("glm4-9b").smoke()
    opt_j = jconfig.OptimizerConfig(lr=1e-3, total_steps=10)
    jsc = jspmd.StepConfig(
        model=jcfg.with_(kernels="ref"),
        splitee=jconfig.SplitEEConfig(profile=jconfig.HeteroProfile(splits)),
        train=jconfig.TrainConfig(optimizer=opt_j), grad_mode=mode)
    tsc = tspmd.StepConfig(
        model=config_from_jax(jcfg).with_(kernels=kernels),
        splitee=tconfig.SplitEEConfig(profile=tconfig.HeteroProfile(splits)),
        train=tconfig.TrainConfig(optimizer=tconfig.OptimizerConfig(
            lr=1e-3, total_steps=10)), grad_mode=mode)
    rng = np.random.default_rng(0)
    batch = {"tokens": _tokens(jcfg, b),
             "labels": rng.integers(0, jcfg.vocab_size, (b, T)).astype(
                 np.int32),
             "split_ids": np.asarray(jspmd.boundary_ids_for_batch(
                 jconfig.HeteroProfile(splits), jcfg, b))}
    jp = jbackbone.init_backbone(jax.random.PRNGKey(0), jcfg)
    return jcfg, jsc, tsc, jp, batch


def _port_step(tsc, jp, batch, counter=None):
    tp = params_from_jax(_np(jp), tsc.model, device="cpu")
    to = tadam.adam_init(tp, tsc.train.optimizer)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    step = tspmd.make_train_step(tsc)
    with StepAnalysis() as a:
        if counter is None:
            step(tp, to, tb)
        else:
            with counter:
                step(tp, to, tb)
    return a.result()


def _jax_step(jsc, jp, batch) -> float:
    jo = jadam.adam_init(jp, jsc.train.optimizer)
    return _jax_flops(jspmd.make_train_step(jsc), jp, jo, batch)


def test_sum_train_step_matches_jax():
    """The glm4-9b smoke's ``"sum"`` train step (splits (1,1,2,2), B = 4,
    T = 32).  With the ``ref`` backend the count equals the HLO's exactly.
    With the ``auto`` backend on the CPU (the plain versions of the
    kernels) it reads +1.22 %, within 2 %, and the whole gap is inside the
    attention backward sites, term by term: per attention layer and
    backward call, the plain dK/dV and dQ (like the two kernels) each
    recompute S = QK^T and dP = dO V^T and form dV, dK, dQ -- 7 block
    matmuls -- where autograd of the plain forward reuses the forward's P
    and forms dP, dV, dQ, dK -- 4.  The 3 extra block matmuls of 2 B H T^2
    hd FLOPs each (2,097,152 here) over 4 backward calls are 25,165,824 of
    2,063,597,568.  Outside the sites (projections, heads, the loss, Adam)
    nothing differs."""
    jcfg, jsc, tsc, jp, batch = _train_setup("sum", "ref")
    want = _jax_step(jsc, jp, batch)
    ref = _port_step(tsc, jp, batch)
    auto = _port_step(dataclasses.replace(
        tsc, model=tsc.model.with_(kernels="auto")), jp, batch)
    calls = auto["site_calls"]["attention_dq"]
    block = 2 * 4 * jcfg.num_heads * T * T * jcfg.head_dim
    print(f"reading sum step FLOPs: JAX HLO {want:.0f}, port ref "
          f"{_counted(ref):.0f}, port auto {_counted(auto):.0f} "
          f"({_counted(auto) / want - 1:+.3%}), {calls} backward calls")
    assert _counted(ref) == want
    assert abs(_counted(auto) / want - 1) <= 0.02
    assert _counted(auto) - want == 3 * block * calls
    assert calls == auto["site_calls"]["attention_dkv"] == jcfg.num_layers


def test_eq1_train_step_is_held_to_the_ports_own_count():
    """The ``"eq1"`` step.  The JAX package runs two full VJPs through one
    forward (``src/repro/core/spmd.py:209-211``); the port pulls each
    family only against the leaves its scale does not zero
    (``core/spmd._pull``): the same gradients for less work.  So the port
    is held to its own count: the analysis equals
    ``torch.utils.flop_counter`` over the same step exactly, and reads
    0.685 x the HLO's (2,357,198,848 against 3,439,329,280 on the glm4-9b
    smoke)."""
    _, jsc, tsc, jp, batch = _train_setup("eq1", "ref")
    want = _jax_step(jsc, jp, batch)
    fc = FlopCounterMode(display=False)
    got = _port_step(tsc, jp, batch, counter=fc)
    ratio = _counted(got) / want
    print(f"reading eq1 step FLOPs: JAX HLO (two full VJPs) {want:.0f}, "
          f"port {_counted(got):.0f} ({ratio:.4f} x)")
    assert _counted(got) == fc.get_total_flops()
    assert 0.6 < ratio < 0.75


@pytest.mark.parametrize("k", [1, 2, 4])
def test_depth_k_counts_k_layers(k):
    """The counterpart of tests/test_hlo_analysis.py: the gradient of the
    logits' sum through a depth-k cut (no exits) counts k times one
    layer's products above the LM head's, and the attention sites k calls
    of each kernel."""
    cfg = tconfigs.get("glm4-9b").smoke().with_(
        num_layers=k, exit_layers=(), block_pattern=(), ffn_pattern=())
    d, H, Hkv, hd, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    params = tree_map(lambda t: torch.randn(t.shape, dtype=t.dtype) * 0.02,
                      tinputs.abstract_params(cfg))
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    with StepAnalysis() as a:
        out = backbone_forward(params, cfg,
                               tokens=torch.as_tensor(_tokens(cfg)))
        torch.autograd.grad(out.logits.sum(), leaves, allow_unused=True)
    r = a.result()
    layer = d * H * hd + 2 * d * Hkv * hd + H * hd * d + 3 * d * F
    # forward, and dX and dW in the backward: 3 products per weight
    assert r["flops"] == 3 * 2 * B * T * (k * layer + d * cfg.vocab_size)
    assert r["site_calls"] == {"attention_fwd": k, "attention_dq": k,
                               "attention_dkv": k}
    assert r["site_flops"]["attention_fwd"] == k * 4 * B * H * T * T * hd


# ---------------------------------------------------------------------------
# the site counters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(tconfigs.CANONICAL))
def test_site_counters_equal_jax(arch):
    """``attention_site_flops`` and ``wkv_site_flops`` equal the JAX
    functions for every input shape and kind, and the per-kernel shares of
    the attention backward (dK/dV 2.0 x, dQ 1.5 x) sum to JAX's 3.5 x."""
    jc, tc = jconfigs.get(arch).config(), tconfigs.get(arch).config()
    for s in tconfig.INPUT_SHAPES:
        for kind in ("train", "prefill", "decode", "bwd"):
            args = (s.global_batch, s.seq_len, kind)
            assert (tdispatch.attention_site_flops(tc, *args)
                    == jdispatch.attention_site_flops(jc, *args))
            assert (tdispatch.wkv_site_flops(tc, *args)
                    == jdispatch.wkv_site_flops(jc, *args))
        shares = sum(tdispatch.attention_site_flops(
            tc, s.global_batch, s.seq_len, k) for k in ("bwd_dkv", "bwd_dq"))
        assert shares == jdispatch.attention_site_flops(
            jc, s.global_batch, s.seq_len, "bwd")
        assert tdispatch.wkv_site_flops(
            tc, s.global_batch, s.seq_len, "bwd") == 2 * (
            tdispatch.wkv_site_flops(tc, s.global_batch, s.seq_len))


# ---------------------------------------------------------------------------
# the input stand-ins
# ---------------------------------------------------------------------------


def _jax_leaves(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        out[key] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
    return out


def _port_leaves(tree) -> dict:
    return {tuple(p): (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in tree_paths(tree)}


@pytest.mark.parametrize("arch", list(tconfigs.CANONICAL))
def test_inputs_match_jax(arch):
    """Every arch x input shape: the port's stand-ins have the JAX
    package's shapes and dtypes, parameters and caches through
    ``jax_layout`` (runs restacked); ``cache_len`` is one entry per row in
    the port, a scalar in JAX."""
    jc, tc = jconfigs.get(arch).config(), tconfigs.get(arch).config()
    assert (_port_leaves(jax_layout(tinputs.abstract_params(tc), tc))
            == _jax_leaves(jinputs.abstract_params(jc)))
    for s in tconfig.INPUT_SHAPES:
        js = jconfig.SHAPES_BY_NAME[s.name]
        assert (s.seq_len, s.global_batch, s.kind) == (
            js.seq_len, js.global_batch, js.kind)
        assert (_port_leaves(tinputs.train_input_specs(tc, s))
                == _jax_leaves(jinputs.train_input_specs(jc, js)))
        if s.seq_len * s.global_batch > 2 ** 22:
            continue        # one decode cache shape per arch is enough
        want = jinputs.serve_input_specs(jc, js)
        got = tinputs.serve_input_specs(tc, s)
        assert (_port_leaves(jax_layout({"segments": got["cache"]}, tc))
                == _jax_leaves({"segments": want["cache"]}))
        rest = {k: v for k, v in got.items() if k not in ("cache",
                                                          "cache_len")}
        assert _port_leaves(rest) == _jax_leaves(
            {k: v for k, v in want.items() if k not in ("cache",
                                                        "cache_len")})
        assert tuple(got["cache_len"].shape) == (s.global_batch,)


# ---------------------------------------------------------------------------
# the fake path of the wrappers
# ---------------------------------------------------------------------------


def _launch_state():
    return {(w.__name__, attr): getattr(w, attr) for w in WRAPPERS
            for attr in ("launches", "row_launches", "tile_launches",
                         "decode_launches", "torch_delta_passes")
            if hasattr(w, attr)}


def test_fake_operands_launch_nothing_and_get_the_cards_layouts():
    """Fake operands (CPU, bf16 at head dim 64, the model's transposed
    views) take the kernel path: no launch counter moves, and every
    output has the shape, dtype and strides the launching branch gives
    it; real CPU tensors still run the plain versions."""
    before = _launch_state()
    Bq, Tq, H, Hkv, D = 2, 64, 4, 2, 64
    with FakeTensorMode():
        q = torch.empty(Bq, Tq, H, D, dtype=torch.bfloat16).transpose(1, 2)
        k = torch.empty(Bq, Tq, Hkv, D, dtype=torch.bfloat16).transpose(1, 2)
        v = torch.empty_like(k)
        assert sites.is_fake(q)
        out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
        assert out.shape == q.shape and out.dtype == q.dtype
        assert out.stride() == q.stride()
        assert lse.shape == (Bq, H, Tq) and lse.dtype == torch.float32
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         torch.empty_like(out))
        assert [t.dtype for t in (dq, dk, dv)] == [torch.bfloat16] * 3
        assert dq.shape == q.shape and dk.shape == k.shape
        dk32, _ = flash_attention_bwd_dkv(q, k, v, out, lse, lse)
        assert dk32.dtype == torch.float32 and dk32.is_contiguous()
        Tw, Hw, K = 40, 3, 16
        r = torch.empty(1, Tw, Hw, K)
        lw = torch.empty(1, Tw, Hw, K)
        u = torch.empty(Hw, K)
        (y, sT), s0 = rwkv_wkv_fwd(r, r, r, lw, u, chunk=16)
        assert y.shape == r.shape and y.dtype == torch.float32
        assert y.is_contiguous()
        assert sT.shape == (1, Hw, K, K) and s0.shape == (Hw, 3, K, K)
        grads = rwkv_wkv_bwd(r, r, r, lw, u, s0, y, sT, chunk=16)
        assert [g.shape for g in grads] == [r.shape] * 4 + [u.shape]
        assert rwkv_wkv(r, r, r, lw, u, chunk=16).shape == r.shape
        Hg, ex = entropy_exit(torch.empty(5, 1000, dtype=torch.bfloat16), 1.0)
        assert Hg.shape == (5,) and Hg.dtype == torch.float32
        assert ex.dtype == torch.int32
    assert _launch_state() == before
    real = torch.randn(2, 7)
    assert not sites.is_fake(real)
    H_real, _ = entropy_exit(real, 1.0)
    assert torch.isfinite(H_real).all()
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(*(torch.empty(1, 2, 4, 16, device="meta"),) * 3)


def _fake_step(tc, profile, b, t, mode="eq1"):
    """``make_train_step`` of ``tc`` on fake CPU tensors: the analysis'
    result."""
    sc = tspmd.StepConfig(model=tc, splitee=tconfig.SplitEEConfig(
        profile=profile), grad_mode=mode)
    specs = tinputs.train_input_specs(tc, tconfig.ShapeConfig("t", t, b,
                                                              "train"))
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = dryrun._fake_like(tinputs.abstract_params(tc))
        batch = dryrun._fake_like(specs)
        opt = tadam.adam_init(params, sc.train.optimizer)
        with StepAnalysis() as a:
            tspmd.make_train_step(sc)(params, opt, batch)
    return a.result()


@pytest.mark.parametrize("arch", ["glm4-9b", "rwkv6-3b"])
def test_fake_trace_counts_what_a_cpu_step_counts(arch):
    """One eq1 train step of the smoke on real CPU tensors (the plain
    versions run inside the sites) and on fake tensors (the wrappers
    allocate only): the same FLOPs outside the sites, site FLOPs, calls
    and bytes, op-level bytes and collectives.  Only ``site_op_flops``
    (the plain versions' own work: 0 under fake tensors) and the peak
    (the plain versions' temporaries) differ."""
    tc = tconfigs.get(arch).smoke()
    profile = tconfig.HeteroProfile((tc.exit_layers[0],
                                     tc.exit_layers[-1]))
    b = 2
    sc = tspmd.StepConfig(model=tc, splitee=tconfig.SplitEEConfig(
        profile=profile))
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda t: torch.randn(t.shape, generator=gen).to(
        t.dtype) * 0.02, tinputs.abstract_params(tc))
    batch = {"tokens": torch.as_tensor(_tokens(tc, b)),
             "labels": torch.as_tensor(_tokens(tc, b, seed=1)),
             "split_ids": tspmd.boundary_ids_for_batch(profile, tc, b,
                                                       "cpu")}
    opt = tadam.adam_init(params, sc.train.optimizer)
    with StepAnalysis() as a:
        tspmd.make_train_step(sc)(params, opt, batch)
    real = a.result()
    fake = _fake_step(tc, profile, b, T)
    print(f"reading fake vs CPU {arch}: flops {fake['flops']:.0f} / "
          f"{real['flops']:.0f}, sites {fake['site_calls']}, in sites "
          f"{fake['site_op_flops']:.0f} / {real['site_op_flops']:.0f}, "
          f"peak {fake['peak_bytes']} / {real['peak_bytes']}")
    for key in ("flops", "site_flops", "site_calls", "site_bytes",
                "hbm_bytes", "collectives"):
        assert fake[key] == real[key], key
    assert fake["site_op_flops"] == 0 < real["site_op_flops"]
    assert sum(fake["site_calls"].values()) > 0


def test_peak_of_a_hand_built_region_is_exact():
    """Two products, the first freed before a third: the peak is the two
    live 64 x 64 fp32 results, counted to the byte; storage alive before
    the region, and views, count nothing."""
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with StepAnalysis() as an:
        c = a @ b
        d = c @ b
        del c
        e = d @ b
        d.t()
        a.add_(1.0)
    r = an.result()
    assert r["peak_bytes"] == 2 * 64 * 64 * 4
    assert r["flops"] == 3 * 2 * 64 ** 3
    del e


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen3-moe-235b-a22b",
                                  "rwkv6-3b", "whisper-small"])
def test_run_one_records(arch):
    """``run_one`` at published widths (depth cut to 4 layers) on the
    production mesh: train and decode records are ``"ok"`` with the per
    rank fields; whisper's ``long_500k`` is ``"skipped"``."""
    for shape in ("train_4k", "decode_32k"):
        rec = dryrun.run_one(arch, shape, layers=4)
        assert rec["status"] == "ok", rec
        assert rec["rows_per_rank"] == tconfig.SHAPES_BY_NAME[
            shape].global_batch // 16
        assert rec["replicated_over_model"] == 16
        assert rec["total_bytes"] == rec["persistent_bytes"] + rec[
            "peak_bytes"]
        assert rec["flops_per_rank"] > 0 and rec["analysis"]["site_calls"]
        if shape == "train_4k":
            assert rec["gathered_bytes"] > 0
            assert rec["analysis"]["collectives"]["all_gather"]["bytes"] == (
                rec["gathered_bytes"])
        else:
            assert rec["placement"] == "replicated (ROADMAP 9b)"
            assert rec["analysis"]["site_calls"]["gate"] == 1
    if arch == "whisper-small":
        assert dryrun.run_one(arch, "long_500k")["status"] == "skipped"

"""The port's dry run without the JAX HLO counts, on the CPU at smoke
sizes: the site counters against the JAX functions, the meta input
stand-ins against ``repro.launch.inputs``, the fake path of the kernel
wrappers (nothing launched, the card's output layouts), a fake trace
against a real CPU run of the same step, the peak of a hand-built region,
and ``dryrun.run_one`` on four architectures at their published widths,
depth cut, with two of its records' repairs: a MoE train record with a
data split counts its summed expert loads, and a serving record counts
what ``ServeSession``'s ``RankPlacement`` gathers a tick; a MoE train
record keeps each rank's experts and counts their exchange.  The counts against the JAX package's HLO are
tests/test_torch_dryrun.py's.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.config as jconfig
from repro import configs as jconfigs
from repro.kernels import dispatch as jdispatch
from repro.launch import inputs as jinputs
import repro_torch.config as tconfig
from repro_torch import configs as tconfigs
from repro_torch.core import spmd as tspmd
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import sites
from repro_torch.kernels.entropy_exit import entropy_exit
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_dkv,
                                                 flash_attention_bwd_dq)
from repro_torch.kernels.rwkv_wkv import rwkv_wkv, rwkv_wkv_bwd, rwkv_wkv_fwd
from repro_torch.api.serve_session import serve_placement
from repro_torch.launch import dryrun
from repro_torch.launch import inputs as tinputs
from repro_torch.launch import shardings as tsh
from repro_torch.launch.e2e_train import cut_depth
from repro_torch.launch.inputs import abstract_params
from repro_torch.launch.mesh import MeshSpec, axis_sizes
from repro_torch.launch.meshcomm import chunk_shapes, plan_bytes, unshard_plan
from repro_torch.launch.shardings import jax_layout, tree_paths
from repro_torch.models.backbone import init_cache
from repro_torch.launch.step_analysis import StepAnalysis
from repro_torch.optim import adam as tadam
from repro_torch.tree import tree_map

T = 32
WRAPPERS = (flash_attention, flash_attention_bwd, flash_attention_bwd_dkv,
            flash_attention_bwd_dq, rwkv_wkv, rwkv_wkv_bwd, entropy_exit)


def _tokens(cfg, b, t=T, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)


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


@functools.lru_cache(maxsize=None)
def _record(arch: str, shape: str, recipe: str = "greedy") -> dict:
    """``run_one`` at published widths, depth cut to 4 layers, on the
    production mesh (one trace per arguments for the module)."""
    return dryrun.run_one(arch, shape, layers=4,
                          recipe=dryrun.RECIPES[recipe])


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen3-moe-235b-a22b",
                                  "rwkv6-3b", "whisper-small"])
def test_run_one_records(arch):
    """``run_one`` at published widths (depth cut to 4 layers) on the
    production mesh: train and decode records are ``"ok"`` with the per
    rank fields, ``replicated_over_model`` measured between 1 and the
    model axis' 16, and the all_gathers traced are the planned weight
    (and cache) gathers beside the tensor-parallel ones; whisper's
    ``long_500k`` is ``"skipped"``."""
    for shape in ("train_4k", "decode_32k"):
        rec = _record(arch, shape)
        assert rec["status"] == "ok", rec
        assert rec["rows_per_rank"] == tconfig.SHAPES_BY_NAME[
            shape].global_batch // 16
        assert 1 <= rec["replicated_over_model"] <= 16
        assert rec["total_bytes"] == rec["persistent_bytes"] + rec[
            "peak_bytes"]
        assert rec["flops_per_rank"] > 0 and rec["analysis"]["site_calls"]
        gathered = rec["analysis"]["collectives"]["all_gather"]["bytes"]
        assert rec["gathered_bytes"] > 0
        if shape == "train_4k":
            assert gathered == (rec["gathered_bytes"]
                                + rec["tp_collectives"]["all_gather"])
        else:
            assert rec["placement"].startswith("ServeSession over ranks")
            assert gathered >= (rec["gathered_bytes"]
                                + rec["tp_collectives"]["all_gather"])
            assert rec["analysis"]["site_calls"]["gate"] == 1
    if arch == "whisper-small":
        assert dryrun.run_one(arch, "long_500k")["status"] == "skipped"


def test_moe_train_record_counts_the_summed_loads():
    """A MoE train record with a data split carries no refusal note, and
    its all_reduces are the gradients', the tensor-parallel products' and
    the expert loads summed over the batch ranks (a dense record has
    none of the last)."""
    moe = _record("qwen3-moe-235b-a22b", "train_4k")
    dense = _record("glm4-9b", "train_4k")
    for rec, loads in ((moe, True), (dense, False)):
        assert rec["status"] == "ok", rec
        assert "note" not in rec
        reduced = rec["analysis"]["collectives"]["all_reduce"]["bytes"]
        rest = rec["grad_reduce_bytes"] + rec["tp_collectives"]["all_reduce"]
        print(f"reading {rec['arch']}: all_reduce {reduced:.0f} bytes, "
              f"gradients + tensor-parallel {rest:.0f}")
        assert (reduced > rest) if loads else (reduced == rest)


@pytest.mark.parametrize("arch,experts", [("qwen3-moe-235b-a22b", 8),
                                          ("deepseek-v3-671b", 1)])
def test_moe_train_record_keeps_each_ranks_experts(arch, experts):
    """A MoE train record on the production mesh (depth cut to 4 layers;
    deepseek-v3's dense layers first, so 1 MoE layer): each rank computes
    with E / 16 of the experts (qwen3-moe's data layout: 8 of 128;
    deepseek-v3's grid: 1 of 256), no expert weight is gathered (the
    serving placement keeps them too: the decode record's weight gathers
    equal the train record's, none of them the expert chunks' other 15 /
    16, and it exchanges its slots' entries with the same experts a
    rank), their gradients leave the batch all-reduce, and the exchange
    is counted as all_to_all at its bound: each call at most every
    entry's row and slot out and the counts."""
    rec = _record(arch, "train_4k")
    decode = _record(arch, "decode_32k")
    cfg, _ = cut_depth(tconfigs.get(arch).config(), 4)
    params = abstract_params(cfg)
    mesh = MeshSpec((16, 16), ("data", "model"))
    *_, roles = dryrun._placement(cfg, params, mesh,
                                  tsh.resolve_recipe("greedy"),
                                  experts=True)
    compute = dryrun._placement(cfg, params, mesh,
                                tsh.resolve_recipe("greedy"),
                                experts=True)[1]
    expert_chunks = [(t.numel() // 256) * t.element_size() * 15
                     for p, t in tree_paths(params)
                     if tsh.is_expert_stack(cfg, p)]
    rest = sum(t.numel() * t.element_size() for p, t in tree_paths(compute)
               if not tsh.is_expert_stack(cfg, p))
    a2a = rec["analysis"]["collectives"]["all_to_all"]
    S = rec["rows_per_rank"] * 4096 * cfg.moe.top_k
    bound = S * (cfg.d_model * 2 + 8) + 8 * 16
    print(f"reading {arch} train_4k: {rec['experts_per_rank']} experts a "
          f"rank, gathered {rec['gathered_bytes']:.0f} (decode "
          f"{decode['weight_gathered_bytes']:.0f}, expert chunks "
          f"{sum(expert_chunks):.0f}), all_to_all {a2a}, bound a call "
          f"{bound}")
    assert rec["experts_per_rank"] == experts
    assert all(r.experts == ("data",) for p, r in tree_paths(roles)
               if tsh.is_expert_stack(cfg, p))
    assert decode["weight_gathered_bytes"] == rec["gathered_bytes"]
    assert sum(expert_chunks) > 0
    assert decode["experts_per_rank"] == experts
    assert decode["exchange_bytes"] > 0
    assert rec["grad_reduce_bytes"] == rest
    assert a2a["bytes"] == rec["exchange_bytes"] > 0
    assert a2a["bytes"] <= a2a["count"] * bound


@pytest.mark.parametrize("recipe", ["greedy", "megatron"])
def test_serving_records_count_what_a_tick_gathers(recipe):
    """A decode record's persistent bytes are a rank's chunks of the
    weights and the cache, and its gathered bytes are what
    ``RankPlacement`` gathers a tick: the weights that are not
    tensor-parallel, whole (the split leaves over their other axes)."""
    cfg, _ = cut_depth(dryrun.arch_config("glm4-9b", "decode_32k"), 4)
    rc = dryrun.RECIPES[recipe] or tsh.ShardingRecipe()
    rec = _record("glm4-9b", "decode_32k", recipe)
    params = abstract_params(cfg)
    mesh = MeshSpec((16, 16), ("data", "model"))
    sizes = axis_sizes(mesh)
    pspecs, _ = serve_placement(rc, mesh, cfg, params,
                                init_cache(cfg, 8, 16, cfg.dtype, "meta"))
    roles = tsh.tp_roles(params, pspecs, mesh, cfg, rc)
    cspecs = tsh.map_with_path(lambda p, _: tsh.compute_spec(
        tsh._lookup(pspecs, p), tsh._lookup(roles, p)), params)
    chunks = chunk_shapes(params, pspecs, sizes, lead=0)
    want = plan_bytes(unshard_plan(chunks, cspecs, sizes, lead=0))
    print(f"reading glm4-9b decode {recipe}: weights gathered a tick "
          f"{rec['weight_gathered_bytes']:,}, all {rec['gathered_bytes']:,}"
          f", persistent {rec['persistent_bytes']:,}")
    assert rec["weight_gathered_bytes"] == want > 0
    assert rec["gathered_bytes"] >= want
    whole = sum(t.numel() * t.element_size()
                for _, t in tsh.tree_paths(params))
    assert rec["persistent_bytes"] < whole

"""Rank-side legs of the serving-over-ranks tests (imported by the spawned
ranks of ``tests/test_torch_serve_ranks.py``; it imports no JAX).

``run_legs(world, inputs)`` serves every case of :func:`cases` on this
rank through ``ServeSession(mesh=, recipe=)`` and returns ``{case:
result}``, a case that raised holding ``{"error": traceback}``.  A result
holds the served streams ``{rid: (tokens, exited, entropy)}``, the
session's stats and each cache leaf's stored shape beside its spec and
whole shape.  The meshes are ``("data", "model")``: (2, 1) and (1, 2) on
2 ranks, (4, 1) and (2, 2) on 4.
"""
from __future__ import annotations

import contextlib
import copy
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api.serve_session import ServeSession, sequential_reference
from repro_torch.config import ModelConfig
from repro_torch.configs import (deepseek_v3_671b, glm4_9b,
                                 qwen3_moe_235b_a22b, rwkv6_3b)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.shardings import _lookup, tree_paths
from repro_torch.models.backbone import init_cache
from repro_torch.parity import uncombined_parts

DM = ("data", "model")
SLOTS, MAX_LEN, DECODE = 4, 24, 4
MESHES = {2: ((2, 1), (1, 2)), 4: ((4, 1), (2, 2))}
RECIPES = ("greedy", "replicate", "megatron")
POLICIES = ("select", "sticky")


def tiny_swa() -> ModelConfig:
    """tests/conftest.py's ``tiny_swa`` with an exit head at layer 1 (the
    gate sits at one): a 6-slot ring, shorter than every stream."""
    return ModelConfig(name="tiny-swa", arch_type="dense", num_layers=3,
                       d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                       vocab_size=97, sliding_window=6, exit_layers=(1,),
                       dtype=torch.float32, param_dtype=torch.float32)


def rwkv6_one_layer_runs() -> ModelConfig:
    """The rwkv6-3b smoke with exits (1, 2, 3): every run one layer, so
    on a (2, 2) mesh the rules put a state's slots over "data" and its
    heads over "model" (a two-layer run's slots go over "model")."""
    return rwkv6_3b.smoke().with_(exit_layers=(1, 2, 3))


#: the configs served in every case (both policies, every mesh)
CONFIGS = {"glm4": glm4_9b.smoke, "swa": tiny_swa, "rwkv6": rwkv6_3b.smoke,
           "deepseek": deepseek_v3_671b.smoke,
           "qwen3": qwen3_moe_235b_a22b.smoke}
#: served on the meshes with a model split, under select
SPLIT_ONLY = {"rwkv6x": rwkv6_one_layer_runs}


def prompts(name: str, cfg, n: int = 6):
    """``n`` seeded prompts: 1 token for deepseek-v3 (the JAX MLA prefill
    with a cache sees slot 0 only; ROADMAP.md Queue 3), else 4-16 tokens,
    so a 24-slot ring split in two holds keys in both parts."""
    rng = np.random.default_rng(11)
    if name == "deepseek":
        return [rng.integers(0, cfg.vocab_size, 1) for _ in range(n)]
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(4, 17)))
            for _ in range(n)]


def cases(world: int):
    """``(case id, config, mesh, recipe, policy, slots)``: glm4-9b under
    every recipe and policy on each mesh; the other configs under greedy
    (both policies) on each mesh; :data:`SPLIT_ONLY` on the meshes with a
    model split; slots that do not divide over the data ranks."""
    out = []
    for shape in MESHES[world]:
        m = "x".join(map(str, shape))
        for recipe in RECIPES:
            for policy in POLICIES:
                out.append((f"glm4-{m}-{recipe}-{policy}", "glm4", shape,
                            recipe, policy, SLOTS))
        for name in CONFIGS:
            if name == "glm4":
                continue
            for policy in POLICIES:
                out.append((f"{name}-{m}-greedy-{policy}", name, shape,
                            "greedy", policy, SLOTS))
        if shape[1] > 1:
            for name in SPLIT_ONLY:
                out.append((f"{name}-{m}-greedy-select", name, shape,
                            "greedy", "select", SLOTS))
    data = MESHES[world][0]
    out.append((f"glm4-{'x'.join(map(str, data))}-greedy-select-slots3",
                "glm4", data, "greedy", "select", 3))
    return out


def serve(cfg, params, mesh, recipe, policy, tau, slots, name,
          fault=contextlib.nullcontext):
    s = ServeSession(cfg, params, tau=tau, slots=slots, max_len=MAX_LEN,
                     exit_policy=policy, device="cpu", mesh=mesh,
                     recipe=recipe)
    for p in prompts(name, cfg):
        s.submit(p, DECODE)
    with fault():
        done = s.run()
    return s, {r.rid: (list(r.tokens), list(r.exited), list(r.entropy))
               for r in done}


def _shapes(s, cfg, slots):
    """Each cache leaf: (path, stored shape, spec, whole shape)."""
    whole = dict(tree_paths(init_cache(cfg, slots, MAX_LEN, cfg.dtype,
                                       "meta")))
    return [(path, tuple(t.shape), _lookup(s.placement.cache_specs, path),
             tuple(whole[path].shape))
            for path, t in tree_paths(s.placement.pool)]


def run_case(world, inputs, case, mesh, fault=contextlib.nullcontext):
    _, name, _, recipe, policy, slots = case
    cfg = inputs["cfg"][name]
    params = copy.deepcopy(inputs["params"][name])
    s, res = serve(cfg, params, mesh, recipe, policy, inputs["tau"][name],
                   slots, name, fault)
    st = s.stats
    return {"results": res, "shapes": _shapes(s, cfg, slots),
            "slots": (s._lo, s._hi),
            "stats": (st.requests, st.decode_ticks, st.tokens, st.exited,
                      st.client_only_ticks),
            "gathered_per_tick": st.gathered_bytes_per_tick,
            "sizes": dict(s.placement.comm.sizes)}


def leg_fault(world, inputs, meshes):
    """glm4-9b on the mesh with a model split, each rank's part of the
    attention used without the combine (``parity.uncombined_parts``)."""
    shape = MESHES[world][1]
    case = ("fault", "glm4", shape, "greedy", "select", SLOTS)
    return run_case(world, inputs, case, meshes[shape], uncombined_parts)


def leg_restore(world, inputs, meshes):
    """A checkpoint the spmd engine wrote over every rank (the glm4-9b
    smoke trained one round, the batch over the ranks), served by
    ``ServeSession.restore`` over the data and the model meshes, and by
    the one-rank session on this rank."""
    from torch_spmd_legs import backbone_setup

    from repro_torch.api import TrainSession
    make, sc, oc, parts, batch = backbone_setup()
    model = make()
    d = os.path.join(inputs["tmp"], f"restore-w{world}")
    t = TrainSession(model, sc, oc, parts, batch, engine="spmd")
    t.train(1, save_every=1, save_dir=d)
    dist.barrier()
    ckpt = os.path.join(d, "ckpt-00000001")
    out = {"engine": t.engine_name}
    for shape in MESHES[world]:
        s = ServeSession.restore(ckpt, make(), slots=SLOTS, max_len=MAX_LEN,
                                 mesh=meshes[shape], recipe="greedy")
        for p in prompts("glm4", model.cfg):
            s.submit(p, DECODE)
        out["x".join(map(str, shape))] = {
            r.rid: (r.tokens, r.exited, r.entropy) for r in s.run()}
    one = ServeSession.restore(ckpt, make(), slots=SLOTS, max_len=MAX_LEN)
    for p in prompts("glm4", model.cfg):
        one.submit(p, DECODE)
    out["one"] = {r.rid: (r.tokens, r.exited, r.entropy) for r in one.run()}
    out["seq"] = [sequential_reference(model.cfg, one.params, p, DECODE,
                                       tau=one.tau, max_len=MAX_LEN,
                                       device="cpu")
                  for p in prompts("glm4", model.cfg)]
    out["tau"] = one.tau
    return out


def run_legs(world, inputs):
    # one thread a rank: the suite runs beside these ranks in other workers
    torch.set_num_threads(1)
    torch.manual_seed(0)
    meshes = {shape: make_host_mesh(shape, DM) for shape in MESHES[world]}
    out = {}
    t0 = time.perf_counter()
    for case in cases(world):
        try:
            out[case[0]] = run_case(world, inputs, case, meshes[case[2]])
        except Exception:                                 # noqa: BLE001
            out[case[0]] = {"error": traceback.format_exc()}
        dist.barrier()
    print(f"cases: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, fn in (("fault", leg_fault), ("restore", leg_restore)):
        t0 = time.perf_counter()
        try:
            out[name] = fn(world, inputs, meshes)
        except Exception:                                 # noqa: BLE001
            out[name] = {"error": traceback.format_exc()}
        dist.barrier()
        print(f"leg {name}: {time.perf_counter() - t0:.2f} s", flush=True)
    # the tensor-parallel serving legs (tests/torch_tp_legs.py)
    import torch_tp_legs
    t0 = time.perf_counter()
    out["tp"] = torch_tp_legs.serve_legs(world, inputs, meshes, serve)
    print(f"legs tp: {time.perf_counter() - t0:.2f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# the experts kept over the batch ranks (tests/test_torch_serve_experts.py)
# ---------------------------------------------------------------------------

#: the MoE smokes served with their experts over the data ranks
EXPERT_CONFIGS = {"deepseek": deepseek_v3_671b.smoke,
                  "qwen3": qwen3_moe_235b_a22b.smoke}
#: the pooled-slots fault's setting: copies of one prompt on SLOTS_POOLED
#: slots (6 a data rank), whose decode tokens route alike, so a rank's
#: slots pooled as one group load an expert past its capacity of 4
SLOTS_POOLED, DECODE_POOLED = 12, 3


def expert_prompts(name: str, cfg):
    """:func:`prompts`, for qwen3-moe the last replaced by one that
    repeats a token (12 times): its prefill loads its experts past their
    capacity.  Six requests on four slots: the second wave fills slots 0
    and 1, so the data group of slots 2 and 3 holds none."""
    out = prompts(name, cfg)
    if name == "qwen3":
        out[-1] = np.full(12, 7, dtype=np.int64)
    return out


def expert_cases(world: int):
    """``(case id, config, mesh, recipe name, policy)``: both smokes and
    policies with the experts over (2, 1) (data layout, greedy) on 2
    ranks and over the (2, 2) grid (megatron) on 4; qwen3-moe in the
    data layout (E over "data", its hidden dims over "model") on 4."""
    out = []
    shape, recipe = ((2, 1), "greedy") if world == 2 else ((2, 2),
                                                          "megatron")
    m = "x".join(map(str, shape))
    for name in EXPERT_CONFIGS:
        for policy in POLICIES:
            out.append((f"{name}-{m}-{recipe}-{policy}", name, shape,
                        recipe, policy))
    if world == 4:
        out.append((f"qwen3-{m}-data-experts-select", "qwen3", shape,
                    "data-experts", "select"))
    return out


def _serve_experts(cfg, params, mesh, recipe, policy, tau, ps, slots,
                   decode, fault=contextlib.nullcontext):
    """Serve ``ps`` over ``mesh``; returns the session, its streams and the
    ticks on which this rank's data group held no occupied slot."""
    s = ServeSession(cfg, params, tau=tau, slots=slots, max_len=MAX_LEN,
                     exit_policy=policy, device="cpu", mesh=mesh,
                     recipe=recipe)
    idle = []
    for name in ("_full_tick", "_client_tick"):
        def watched(*a, real=getattr(s, name)):
            idle.append(not s._active[s._lo:s._hi].any())
            return real(*a)
        setattr(s, name, watched)
    for p in ps:
        s.submit(p, decode)
    with fault():
        done = s.run()
    return s, {r.rid: (list(r.tokens), list(r.exited), list(r.entropy))
               for r in done}, sum(idle)


def _dryrun_tick(cfg, mesh, recipe, slots):
    """The dry run's decode record of ``cfg`` on a ``MeshSpec`` of
    ``mesh``'s shape, ``slots`` slots of MAX_LEN tokens."""
    import dataclasses

    from repro_torch.config import SHAPES_BY_NAME, HeteroProfile
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshSpec, axis_sizes
    from torch._subclasses.fake_tensor import FakeTensorMode
    sizes = axis_sizes(mesh)
    spec = MeshSpec(tuple(sizes[a] for a in DM), DM)
    shape = dataclasses.replace(SHAPES_BY_NAME["decode_32k"],
                                global_batch=slots, seq_len=MAX_LEN)
    rec = {}
    with FakeTensorMode(allow_non_fake_inputs=True):
        dryrun._decode_step(cfg, HeteroProfile((min(cfg.exit_layers),) * 4),
                            shape, slots // sizes["data"], spec, recipe, rec)
    return rec


def expert_legs(world, inputs):
    """Every case of :func:`expert_cases` on this rank with its readings,
    then the two planted faults on the first case's mesh, each beside its
    control: each entry sent to the owner of the next chunk
    (``parity.misrouted_entries``), and a rank's slots routed as one
    group (``parity.pooled_slots``).  ``{case: result}``, a case that
    raised holding ``{"error": traceback}``."""
    from torch_tp_legs import _run, family_recipe

    from repro_torch.launch.meshcomm import plan_bytes, unshard_plan
    from repro_torch.launch.shardings import (is_expert_stack,
                                              map_with_path)
    from repro_torch.parity import misrouted_entries, pooled_slots
    torch.set_num_threads(1)
    torch.manual_seed(0)
    out = {}
    for cid, name, shape, rname, policy in expert_cases(world):
        def one():
            cfg, recipe = inputs["cfg"][name], family_recipe(rname)
            mesh = make_host_mesh(shape, DM)
            s, res, idle = _serve_experts(
                cfg, copy.deepcopy(inputs["params"][name]), mesh, recipe,
                policy, inputs["tau"][name], expert_prompts(name, cfg),
                SLOTS, DECODE)
            pl, st = s.placement, s.stats
            experts = map_with_path(
                lambda p, t: t if is_expert_stack(cfg, p) else None,
                pl.params)
            rec = _dryrun_tick(cfg, mesh, recipe, SLOTS)
            return {"results": res, "idle_ticks": idle,
                    "client_only": st.client_only_ticks,
                    "experts": pl.ep.experts if pl.ep else 0,
                    "stack_experts": sorted({t.shape[0] for p, t in
                                             tree_paths(experts)}),
                    "expert_gathers": plan_bytes(unshard_plan(
                        experts, pl.compute_specs, pl.comm.sizes,
                        lead=0)),
                    "weights_per_tick": st.weight_gathered_bytes_per_tick,
                    "exchange_per_tick": st.exchange_bytes_per_tick,
                    "exchange_decode": st.exchange_decode_bytes_per_tick,
                    "dryrun": {k: rec.get(k) for k in (
                        "weight_gathered_bytes", "exchange_bytes",
                        "experts_per_rank")}}
        _run(out, cid, one)
    shape = expert_cases(world)[0][2]
    recipe = family_recipe(expert_cases(world)[0][3])
    cfg = inputs["cfg"]["qwen3"]
    same = [expert_prompts("qwen3", cfg)[0]] * SLOTS_POOLED
    for key, fault, ps, slots, decode in (
            ("fault-misrouted", misrouted_entries,
             expert_prompts("qwen3", cfg), SLOTS, DECODE),
            ("pooled-control", contextlib.nullcontext, same, SLOTS_POOLED,
             DECODE_POOLED),
            ("fault-pooled", pooled_slots, same, SLOTS_POOLED,
             DECODE_POOLED)):
        _run(out, key, lambda: _serve_experts(
            cfg, copy.deepcopy(inputs["params"]["qwen3"]),
            make_host_mesh(shape, DM), recipe, "select",
            inputs["tau"]["qwen3"], ps, slots, decode, fault)[1])
    return out

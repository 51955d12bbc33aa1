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

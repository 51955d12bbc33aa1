"""Rank-side legs of the tensor-parallel tests (imported by the spawned
ranks of ``tests/test_torch_spmd_engine.py`` and
``tests/test_torch_serve_ranks.py``, which run them in the worlds they
already spawn; it imports no JAX).

The meshes are ``("data", "model")``: (1, 2) on 2 ranks and (2, 2) on 4,
under the recipes megatron and greedy.  :func:`train_legs` holds the
glm4-9b smoke (fp32) to the port on one rank: the train step's losses and
gradients, two rounds of ``TrainSession``, the two planted faults, and the
step's counts for the dry run.  :func:`serve_legs` serves the glm4-9b
smoke (both policies) and, on 2 ranks, the whisper-small smoke (cross
attention) over the same meshes.  Every leg's result or traceback is
stored under its own key.
"""
from __future__ import annotations

import contextlib
import copy
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config import HeteroProfile, SplitEEConfig
from repro_torch.configs import glm4_9b
from repro_torch.core.losses import accuracy
from repro_torch.core.spmd import StepConfig, make_grad_step
from repro_torch.launch import tensor_parallel as tp
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.meshcomm import MeshComm
from repro_torch.launch.shardings import (_lookup, jax_layout, map_with_path,
                                          param_specs, port_specs,
                                          resolve_recipe, tp_roles,
                                          tree_paths)
from repro_torch.launch.step_analysis import StepAnalysis
from repro_torch.models.backbone import backbone_forward, init_backbone
from repro_torch.optim.adam import lane_norms
from repro_torch.parity import per_rank_sumexp, unreduced_row_products

DM = ("data", "model")
MESH = {2: (1, 2), 4: (2, 2)}
RECIPES = ("megatron", "greedy")
#: a clip norm below the glm4-9b smoke's gradient norms (so it clips)
CLIP = 1e-2
#: the train step's batch: 4 sequences of 8 tokens, two per boundary
STEP_B, STEP_T, STEP_SPLITS = 4, 8, (0, 0, 1, 1)


def step_setup():
    """The glm4-9b smoke's weights (seed 0), a seeded batch and the eq1
    step config."""
    cfg = glm4_9b.smoke()
    params = init_backbone(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
                 rng.integers(0, cfg.vocab_size, (STEP_B, STEP_T))),
             "labels": torch.from_numpy(
                 rng.integers(0, cfg.vocab_size, (STEP_B, STEP_T))),
             "split_ids": torch.tensor(STEP_SPLITS)}
    sc = StepConfig(model=cfg, splitee=SplitEEConfig(
        profile=HeteroProfile((1, 1, 2, 2))))
    return cfg, params, batch, sc


def placement(cfg, params, mesh, recipe):
    """``(roles, model group)`` of ``params`` on ``mesh`` under
    ``recipe``, and this rank's local tree: each split leaf cut to its
    ``"model"`` chunk, every other whole."""
    recipe = resolve_recipe(recipe)
    specs = port_specs(param_specs(jax_layout(params, cfg), cfg, mesh,
                                   recipe), params, cfg)
    roles = tp_roles(params, specs, mesh, cfg, recipe)
    comm = MeshComm(mesh)
    pg, _ = comm.group(("model",))
    g = tp.ModelGroup(pg, comm.size(("model",)), comm.index(("model",)))

    def cut(path, t):
        r = _lookup(roles, path)
        return (tp.own_slice(t, g, r.dim).clone() if r.split
                else t.clone())
    return roles, g, map_with_path(cut, params)


def _gathered(grads, params, roles, g):
    """Each gradient whole: a split leaf's chunks gathered over the
    group."""
    out = []
    for (path, _), gr in zip(tree_paths(params), grads):
        r = _lookup(roles, path)
        if gr is not None and r.split:
            gr = tp.all_gather(gr, g, r.dim)
        out.append(None if gr is None else gr.numpy().copy())
    return out


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def leg_step(world, recipe, mesh, one_rank, fault=None):
    """The TP train step against the one-rank step (``one_rank``: its
    gradients and metrics) on every rank: the metrics, every gradient
    gathered whole, the roles, and (without a planted ``fault``) the
    step's analysis."""
    cfg, params, batch, sc = step_setup()
    want, wm = one_rank
    roles, g, local = placement(cfg, params, mesh, recipe)
    count = StepAnalysis() if fault is None else contextlib.nullcontext()
    with count as a, tp.model_parallel(g), (fault or
                                           contextlib.nullcontext)():
        got, gm = make_grad_step(sc)(local, batch)
    res = a.result() if fault is None else None
    moved = dict(g.bytes)
    # the clip norm of the chunks (split leaves' squares summed over the
    # group) against the whole gradients' norm
    flags = [_lookup(roles, p).split for p, _ in tree_paths(params)]
    norm = lane_norms([None if x is None else x[None] for x in got], flags,
                      lambda ts: [t.copy_(tp.all_reduce(t, g)) for t in ts])
    whole_norm = lane_norms([w[None] for w in want if w is not None])
    norm_gap = float((norm - whole_norm).abs().max() / whole_norm.max())
    # the vocab-parallel accuracy (argmax over the ranks' chunks) of the
    # split logits, against the whole logits' own argmax
    with torch.no_grad():
        whole = backbone_forward(params, cfg, tokens=batch["tokens"]).logits
        with tp.model_parallel(g):
            split = backbone_forward(local, cfg,
                                     tokens=batch["tokens"]).logits
            hits = float(accuracy(split, whole.argmax(-1),
                                  vocab=cfg.vocab_size))
    got = _gathered(got, params, roles, g)
    gaps = [float(np.max(np.abs(x - w.numpy()))) if w is not None else 0.0
            for x, w in zip(got, want)]
    return {"metrics": _metrics(gm), "want_metrics": _metrics(wm),
            "grad_gap": max(gaps), "analysis": res,
            "tp_bytes": moved, "index": g.index, "argmax_hits": hits,
            "norm_gap": norm_gap,
            "logits_split": split.shape[-1] < whole.shape[-1],
            "local_shapes": [tuple(t.shape) for t in
                             (x for _, x in tree_paths(local))],
            "roles": [(p, _lookup(roles, p).kind) for p, _ in
                      tree_paths(params)]}


def leg_session(world, recipe, mesh):
    """Two rounds of ``TrainSession`` on the spmd engine over the model
    mesh (tests/torch_spmd_legs.py's glm4-9b smoke setting)."""
    from torch_spmd_legs import _result, backbone_setup

    from repro_torch.api import TrainSession
    make, sc, oc, parts, batch = backbone_setup()
    model = make()
    s = TrainSession(model, sc, oc, parts, batch, engine="spmd",
                     mesh=mesh, recipe=recipe)
    s.train(2)
    eng = s.engine
    return _result(s, model, gathered=eng.last_gathered_bytes_per_step,
                   planned=eng.planned_gathered_bytes_per_step(),
                   tp_bytes=eng.last_tp_bytes_per_step)


def leg_clip(world, mesh):
    """The glm4-9b smoke's two rounds with a clip norm that clips, on the
    spmd engine over the model mesh (megatron: the norm's squares of the
    split leaves summed over the group) and on the fused engine on one
    rank."""
    import dataclasses

    from torch_spmd_legs import _result, backbone_setup

    from repro_torch.api import TrainSession
    make, sc, oc, parts, batch = backbone_setup()
    oc = dataclasses.replace(oc, grad_clip=CLIP)
    out = {}
    for engine, kw in (("fused", {}),
                       ("spmd", dict(mesh=mesh, recipe="megatron"))):
        model = make()
        s = TrainSession(model, sc, oc, parts, batch, engine=engine, **kw)
        s.train(2)
        out[engine] = _result(s, model)
    return out


def _run(out, name, fn, *args):
    try:
        out[name] = fn(*args)
    except Exception:                                     # noqa: BLE001
        out[name] = {"error": traceback.format_exc()}
    dist.barrier()


def train_legs(world):
    """Every train leg on this rank, ``{name: result}``: the one-rank
    step once, then each tensor-parallel leg on one model mesh."""
    _, params, batch, sc = step_setup()
    one_rank = make_grad_step(sc)(params, batch)
    mesh = make_host_mesh(MESH[world], DM)
    out = {}
    for recipe in RECIPES:
        _run(out, f"step-{recipe}", leg_step, world, recipe, mesh,
             one_rank)
        _run(out, f"session-{recipe}", leg_session, world, recipe, mesh)
    _run(out, "clip", leg_clip, world, mesh)
    _run(out, "fault-row", leg_step, world, "megatron", mesh, one_rank,
         unreduced_row_products)
    _run(out, "fault-sumexp", leg_step, world, "megatron", mesh, one_rank,
         per_rank_sumexp)
    return out


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def serve_cases(world):
    """``(case id, config, mesh, recipe, policy)``: the glm4-9b smoke under
    both recipes and policies, and on 2 ranks the whisper-small smoke
    under megatron (select)."""
    shape = MESH[world]
    m = "x".join(map(str, shape))
    out = [(f"tp-glm4-{m}-{r}-{p}", "glm4", shape, r, p)
           for r in RECIPES for p in ("select", "sticky")]
    if world == 2:
        out.append((f"tp-whisper-{m}-megatron-select", "whisper", shape,
                    "megatron", "select"))
    return out


def serve_legs(world, inputs, meshes, serve):
    """Every serving case of :func:`serve_cases` through ``serve`` (the
    serving world's ``serve(cfg, params, mesh, recipe, policy, tau, slots,
    name)``), with the stats' bytes a tick."""
    out = {}
    for cid, name, shape, recipe, policy in serve_cases(world):
        def one():
            s, res = serve(inputs["cfg"][name],
                           copy.deepcopy(inputs["params"][name]),
                           meshes[shape], recipe, policy,
                           inputs["tau"][name], 4, name)
            st = s.stats
            return {"results": res,
                    "weights_per_tick": st.weight_gathered_bytes_per_tick,
                    "tp_per_tick": st.tp_bytes_per_tick,
                    "kinds": sorted({r.kind for _, r in tree_paths(
                        s.placement.roles)})}
        _run(out, cid, one)
    return out

"""Rank-side legs of the tensor-parallel tests (imported by the spawned
ranks of ``tests/test_torch_spmd_engine.py`` and
``tests/test_torch_serve_ranks.py``, which run them in the worlds they
already spawn; it imports no JAX).

The meshes are ``("data", "model")``: (1, 2) on 2 ranks and (2, 2) on 4.
:func:`train_legs` holds the glm4-9b smoke (fp32, recipes megatron and
greedy) to the port on one rank: the train step's losses and gradients,
two rounds of ``TrainSession``, the two planted faults, and the step's
counts for the dry run; then the MoE, MLA, RWKV6 and Mamba2 smokes
(:data:`FAMILY_STEPS`, :data:`FAMILY_SESSIONS`, at a recipe that lowers
``min_shard_elems`` so that their d = 128 leaves split): deepseek-v3,
qwen3-moe (experts over the grid and in the data layout), rwkv6 and
zamba2, each step and session against one rank, and two more planted
faults (the experts' partial outputs unsummed, RWKV6's output norm with a
per-rank sum of squares).  :func:`serve_legs` serves the glm4-9b smoke
(both policies), on 2 ranks the whisper-small smoke (cross attention),
and the :data:`FAMILY_SERVES` smokes over the same meshes.  Every leg's
result or traceback is stored under its own key.
"""
from __future__ import annotations

import contextlib
import copy
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config import HeteroProfile, SplitEEConfig
from repro_torch.configs import (deepseek_v3_671b, glm4_9b,
                                 qwen3_moe_235b_a22b, rwkv6_3b, zamba2_1p2b)
from repro_torch.core.losses import accuracy
from repro_torch.core.spmd import StepConfig, make_grad_step
from repro_torch.launch import tensor_parallel as tp
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.meshcomm import MeshComm
from repro_torch.launch.shardings import (ShardingRecipe, _lookup,
                                          compute_spec, expert_axes,
                                          expert_blocks, is_expert_stack,
                                          jax_layout, kept_experts,
                                          kept_spec, map_with_path,
                                          param_specs,
                                          port_specs, resolve_recipe,
                                          tp_roles, tree_paths)
from repro_torch.launch.step_analysis import StepAnalysis
from repro_torch.models.backbone import backbone_forward, init_backbone
from repro_torch.models.sync_stats import synced_batch_stats
from repro_torch.optim.adam import lane_norms
from repro_torch.parity import (live_rwkv, per_rank_norm_squares,
                                per_rank_sumexp, unreduced_row_products,
                                unsummed_expert_parts)

DM = ("data", "model")
MESH = {2: (1, 2), 4: (2, 2)}
RECIPES = ("megatron", "greedy")
#: a clip norm below the glm4-9b smoke's gradient norms (so it clips)
CLIP = 1e-2
#: the train step's batch: 4 sequences of 8 tokens, two per boundary
STEP_B, STEP_T = 4, 8

#: the smokes (fp32, d = 128) of the tensor-parallel legs
SMOKES = {"glm4": glm4_9b.smoke, "deepseek": deepseek_v3_671b.smoke,
          "qwen3": qwen3_moe_235b_a22b.smoke, "rwkv6": rwkv6_3b.smoke,
          "zamba2": zamba2_1p2b.smoke}
#: the smokes' leaves fall below the default ``min_shard_elems``: the MoE,
#: MLA, RWKV6 and Mamba2 legs hold them under a recipe that lowers it
#: (on both packages' sides where the JAX rules are read)
LOW_SHARD = 256
FAMILY_RECIPES = {"greedy": {}, "megatron": {"scheme": "megatron"},
                  "hybrid": {"scheme": "hybrid"},
                  "data-experts": {"expert_mode": "data"}}
#: (leg, smoke, recipe): deepseek's MLA over heads (megatron) and over
#: its latent (greedy) with its experts over the grid, qwen3-moe's
#: experts over the grid and in the data layout, RWKV6's wkv on each
#: rank's heads under both schemes, Mamba2's projections (greedy)
FAMILY_STEPS = (("deepseek-megatron", "deepseek", "megatron"),
                ("deepseek-greedy", "deepseek", "greedy"),
                ("qwen3-grid", "qwen3", "megatron"),
                ("qwen3-data", "qwen3", "data-experts"),
                ("rwkv6-megatron", "rwkv6", "megatron"),
                ("rwkv6-greedy", "rwkv6", "greedy"),
                ("zamba2-greedy", "zamba2", "greedy"))
#: the legs also run as two rounds of ``TrainSession``
FAMILY_SESSIONS = ("deepseek-megatron", "qwen3-data", "rwkv6-megatron",
                   "zamba2-greedy")


def family_recipe(name: str, module=None):
    """FAMILY_RECIPES[name] at LOW_SHARD, a ``ShardingRecipe`` of
    ``module`` (the port's ``launch.shardings`` by default)."""
    cls = ShardingRecipe if module is None else module.ShardingRecipe
    return cls(min_shard_elems=LOW_SHARD, **FAMILY_RECIPES[name])


def step_setup(name: str = "glm4"):
    """A smoke's weights (seed 0; rwkv6's decays and bonus made live), a
    seeded batch and the eq1 step config: two sequences at each of its
    first and last exits."""
    cfg = SMOKES[name]()
    params = init_backbone(torch.Generator().manual_seed(0), cfg)
    live_rwkv(params)
    cuts = sorted(cfg.exit_layers)
    splits = (cuts[0], cuts[0], cuts[-1], cuts[-1])
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
                 rng.integers(0, cfg.vocab_size, (STEP_B, STEP_T))),
             "labels": torch.from_numpy(
                 rng.integers(0, cfg.vocab_size, (STEP_B, STEP_T))),
             "split_ids": torch.tensor([sorted(set(splits)).index(c)
                                        for c in splits])}
    sc = StepConfig(model=cfg, splitee=SplitEEConfig(
        profile=HeteroProfile(splits)))
    return cfg, params, batch, sc


def placement(cfg, params, mesh, recipe):
    """``(specs, roles, comm, model group, expert group, local tree)`` of
    ``params`` on ``mesh`` under ``recipe``: this rank's local tree as
    the spmd engine computes with it, each leaf cut to its chunk by its
    spec, then gathered over its compute spec (a split leaf keeps its
    ``"model"`` chunk, an expert stack its experts: over the grid, or
    over the data ranks too -- the expert group, ``None`` where the data
    axis holds one rank; any other whole)."""
    recipe = resolve_recipe(recipe)
    specs = port_specs(param_specs(jax_layout(params, cfg), cfg, mesh,
                                   recipe), params, cfg)
    roles = tp_roles(params, specs, mesh, cfg, recipe)
    comm = MeshComm(mesh)
    pg, _ = comm.group(("model",))
    g = tp.ModelGroup(pg, comm.size(("model",)), comm.index(("model",)),
                      expert_blocks=expert_blocks(roles))
    axes = expert_axes(roles)
    ep = None
    if axes:
        epg, _ = comm.group(axes)
        ep = tp.ExpertGroup(epg, comm.size(axes), comm.index(axes),
                            kept_experts(roles, cfg.moe.num_experts,
                                         comm.sizes))
    chunks = map_with_path(
        lambda p, t: comm.shard(t, _lookup(specs, p), lead=0), params)
    local = comm.unshard(chunks, map_with_path(
        lambda p, _: compute_spec(_lookup(specs, p), _lookup(roles, p)),
        params), lead=0)
    return (specs, roles, comm, g, ep,
            map_with_path(lambda _, t: t.clone(), local))


def _local_want(want, params, specs, roles, comm):
    """The one-rank gradients cut to this rank's compute chunks: a split
    leaf's chunk, an expert stack's experts, any other whole."""
    return [w if w is None else comm.shard(
                w, kept_spec(_lookup(specs, p), _lookup(roles, p)), lead=0)
            for (p, _), w in zip(tree_paths(params), want)]


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def rank_major(batch, D: int):
    """The batch's rows reordered into D contiguous blocks of every D-th
    row: under a data split each rank then holds a row of each exit
    (STEP_B = 4, two per exit), so the means of its masked exit losses
    average to the whole batch's."""
    perm = torch.cat([torch.arange(i, STEP_B, D) for i in range(D)])
    return {k: v[perm] for k, v in batch.items()}


@contextlib.contextmanager
def data_split(comm, ep):
    """The batch group over the data ranks and the expert group ``ep``
    active (nothing without one)."""
    if ep is None:
        yield
        return
    pg, _ = comm.group(("data",))
    with synced_batch_stats(pg, ep.size, ep.index), tp.expert_parallel(ep):
        yield


def leg_step(world, recipe, mesh, one_rank, fault=None, name="glm4"):
    """The TP train step of smoke ``name`` against the one-rank step
    (``one_rank``: its gradients and metrics) on every rank: the metrics,
    every gradient against the one-rank gradient's chunk, the roles, and
    (without a planted ``fault``) the step's analysis.  Where the expert
    stacks keep their chunks over the data ranks, the batch is split
    over them as the spmd engine splits it (each rank its block of
    :func:`rank_major`'s rows, against the one-rank step on those rows
    in that order), the MoE blocks exchange their entries, and the
    gradients and metrics are averaged over the data ranks as the engine
    averages them (an expert stack's divided alone)."""
    cfg, params, batch, sc = step_setup(name)
    want, wm = one_rank
    specs, roles, comm, g, ep, local = placement(cfg, params, mesh, recipe)
    rows = slice(None)
    if ep is not None:
        batch = rank_major(batch, ep.size)
        want, wm = make_grad_step(sc)(params, batch)
        n = STEP_B // ep.size
        rows = slice(ep.index * n, (ep.index + 1) * n)
        dpg, _ = comm.group(("data",))
    mine = {k: v[rows] for k, v in batch.items()}
    count = StepAnalysis() if fault is None else contextlib.nullcontext()
    with count as a, tp.model_parallel(g), data_split(comm, ep), (
            fault or contextlib.nullcontext)():
        got, gm = make_grad_step(sc)(local, mine)
    res = a.result() if fault is None else None
    moved = dict(g.bytes)
    if ep is not None:
        for (p, _), x in zip(tree_paths(params), got):
            if x is not None:
                if not _lookup(roles, p).experts:
                    dist.all_reduce(x, group=dpg)
                x.div_(ep.size)
        for v in gm.values():
            dist.all_reduce(v, group=dpg)
            v.div_(ep.size)
    # the clip norm of the chunks (split leaves' squares summed over the
    # ranks they are split over) against the whole gradients' norm
    axes = [tuple(a for a in _lookup(roles, p).experts + (
                ("model",) if _lookup(roles, p).split else ())
                  if comm.sizes[a] > 1) for p, _ in tree_paths(params)]
    norm = lane_norms([None if x is None else x[None] for x in got], axes,
                      comm.all_reduce)
    whole_norm = lane_norms([w[None] for w in want if w is not None])
    norm_gap = float((norm - whole_norm).abs().max() / whole_norm.max())
    # the vocab-parallel accuracy (argmax over the ranks' chunks) of the
    # split logits, against the whole logits' own argmax
    with torch.no_grad():
        whole = backbone_forward(params, cfg,
                                 tokens=batch["tokens"]).logits[rows]
        with tp.model_parallel(g), data_split(comm, ep):
            split = backbone_forward(local, cfg,
                                     tokens=mine["tokens"]).logits
            hits = float(accuracy(split, whole.argmax(-1),
                                  vocab=cfg.vocab_size))
    wants = _local_want(want, params, specs, roles, comm)
    gaps = [float((x - w).abs().max()) if w is not None else 0.0
            for x, w in zip(got, wants)]
    experts = [tuple(t.shape)[0] for p, t in tree_paths(local)
               if is_expert_stack(cfg, p)]
    return {"metrics": _metrics(gm), "want_metrics": _metrics(wm),
            "grad_gap": max(gaps), "analysis": res,
            "tp_bytes": moved, "index": g.index, "argmax_hits": hits,
            "norm_gap": norm_gap,
            "logits_split": split.shape[-1] < whole.shape[-1],
            "local_shapes": [tuple(t.shape) for t in
                             (x for _, x in tree_paths(local))],
            "experts": experts, "expert_ranks": ep.size if ep else 1,
            "exchanged": ep.bytes["all_to_all"] if ep else 0.0,
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


def leg_family_session(world, name, recipe, mesh):
    """Two rounds of ``TrainSession`` of smoke ``name`` (four clients at
    its first and last exits) on the spmd engine over the model mesh
    under ``recipe``, and on the fused engine on this rank alone."""
    import dataclasses

    from torch_spmd_legs import _result, backbone_setup

    from repro_torch.api import TrainSession
    from repro_torch.core.backbone_splitee import BackboneSplitModel
    cfg = SMOKES[name]()
    _, sc, oc, parts, batch = backbone_setup()
    cuts = sorted(cfg.exit_layers)
    sc = dataclasses.replace(sc, profile=HeteroProfile(
        (cuts[0], cuts[0], cuts[-1], cuts[-1])))
    parts = [(np.minimum(x, cfg.vocab_size - 1), y) for x, y in parts]
    out = {}
    for engine, kw in (("fused", {}),
                       ("spmd", dict(mesh=mesh,
                                     recipe=family_recipe(recipe)))):
        model = BackboneSplitModel(cfg, seed=0, device="cpu")
        live_rwkv(model.full_params)
        s = TrainSession(model, sc, oc, parts, batch, engine=engine, **kw)
        s.train(2)
        eng = s.engine
        out[engine] = _result(s, model, **({} if engine == "fused" else dict(
            tp_bytes=eng.last_tp_bytes_per_step,
            experts=eng.experts_per_rank,
            expert_gathered=eng.planned_gathered_bytes_per_step(
                experts=True),
            exchanged=eng.last_exchange_bytes_per_step)))
    return out


def _run(out, key, fn, *args, **kw):
    try:
        out[key] = fn(*args, **kw)
    except Exception:                                     # noqa: BLE001
        out[key] = {"error": traceback.format_exc()}
    dist.barrier()


def train_legs(world):
    """Every train leg on this rank, ``{name: result}``: the one-rank
    step once per smoke, then each tensor-parallel leg on one model
    mesh."""
    mesh = make_host_mesh(MESH[world], DM)
    one = {}
    for name in ("glm4",) + tuple(n for _, n, _ in FAMILY_STEPS):
        if name not in one:
            _, params, batch, sc = step_setup(name)
            one[name] = make_grad_step(sc)(params, batch)
    out = {}
    for recipe in RECIPES:
        _run(out, f"step-{recipe}", leg_step, world, recipe, mesh,
             one["glm4"])
        _run(out, f"session-{recipe}", leg_session, world, recipe, mesh)
    _run(out, "clip", leg_clip, world, mesh)
    _run(out, "fault-row", leg_step, world, "megatron", mesh, one["glm4"],
         unreduced_row_products)
    _run(out, "fault-sumexp", leg_step, world, "megatron", mesh,
         one["glm4"], per_rank_sumexp)
    for leg, name, recipe in FAMILY_STEPS:
        _run(out, f"step-{leg}", leg_step, world, family_recipe(recipe),
             mesh, one[name], name=name)
        if leg in FAMILY_SESSIONS:
            _run(out, f"session-{leg}", leg_family_session, world, name,
                 recipe, mesh)
    _run(out, "fault-expert-parts", leg_step, world,
         family_recipe("megatron"), mesh, one["deepseek"],
         unsummed_expert_parts, name="deepseek")
    _run(out, "fault-norm-squares", leg_step, world,
         family_recipe("megatron"), mesh, one["rwkv6"],
         per_rank_norm_squares, name="rwkv6")
    return out


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


#: (smoke, recipe) served over the model mesh under select, at LOW_SHARD:
#: deepseek-v3 (MLA's heads and the experts over the grid, 1-token
#: prompts), qwen3-moe (experts over the grid), rwkv6 (the wkv on each
#: rank's heads at prefill, every head at decode) and zamba2 (Mamba2's
#: projections, split only under greedy)
FAMILY_SERVES = (("deepseek", "megatron"), ("qwen3", "megatron"),
                 ("rwkv6", "megatron"), ("zamba2", "greedy"))


def serve_cases(world):
    """``(case id, config, mesh, recipe, policy)``: the glm4-9b smoke under
    both recipes and policies, on 2 ranks the whisper-small smoke under
    megatron (select), and the FAMILY_SERVES smokes."""
    shape = MESH[world]
    m = "x".join(map(str, shape))
    out = [(f"tp-glm4-{m}-{r}-{p}", "glm4", shape, r, p)
           for r in RECIPES for p in ("select", "sticky")]
    if world == 2:
        out.append((f"tp-whisper-{m}-megatron-select", "whisper", shape,
                    "megatron", "select"))
    out += [(f"tp-{name}-{m}-{r}-select", name, shape, family_recipe(r),
             "select") for name, r in FAMILY_SERVES]
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

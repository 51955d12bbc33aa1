"""Dry run: what one rank of the port runs, per arch x input shape x
production mesh, counted without a card (counterpart of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh single --out dryrun.jsonl

The JAX package lowers and compiles each step for a 256/512-device host
mesh and reads XLA's memory and HLO analyses.  The port has no program to
compile: :func:`run_one` traces the step one rank runs, eagerly, under
``FakeTensorMode`` on fake CPU tensors (nothing allocated, nothing
computed; the kernel wrappers take the card's route and allocate their
outputs, ``kernels/sites.py``) inside ``launch/step_analysis.py``'s
:class:`StepAnalysis`.  What one rank runs:

  * train: the rank's chunks of the parameters and bf16 Adam moments
    (``launch/shardings.param_specs`` by the recipe) are gathered by
    ``launch/meshcomm.unshard_plan``'s all_gathers -- a leaf that
    ``shardings.tp_roles`` finds ``column``, ``row`` or ``expert`` over
    its FSDP axes only, keeping its ``"model"`` chunk, an expert stack
    whose E dim is over "data" not at all (it keeps the rank's experts,
    whose dispatch buffers alone it builds), any other whole --
    ``make_grad_step`` runs on the rank's rows (global batch / data ranks)
    inside ``launch.tensor_parallel.model_parallel`` and
    ``expert_parallel`` over counting groups (their collectives recorded,
    nothing sent; the experts' exchange as all_to_all at a bound the real
    one cannot exceed: every entry's row and slot out, every row back,
    ``exchange_bytes``), a MoE block's loads summed over the batch ranks,
    the gradients but the experts' all-reduced over the batch ranks
    (``all_reduce_plan``), and Adam updates the rank's chunks -- the spmd
    engine's step;
  * prefill: ``backbone_forward`` on the rank's rows (``--last-token-heads``
    as JAX's ``prefill_step``) with the weights ``ServeSession``'s
    ``RankPlacement`` gathers a tick;
  * decode: ``make_serve_step`` on the rank's slots, with its chunks of
    the weights and of the slot-paged cache as ``RankPlacement`` holds and
    gathers them (rings split over ``"model"`` combined by a counting
    gather).
  Serving keeps an expert stack whose E dim is over "data" as the rank's
  experts, as a train step does: no expert weight is gathered, and the
  expert group counts the exchange at its bound, each rank's rows (the
  prefill's) or slots (a tick's) routed as groups of their own.

Per rank the record gives persistent bytes (parameter and optimizer
chunks, or the parameter and cache chunks), the bytes gathered per step
or tick (``weight_gathered_bytes``: of them, the weights'), the
tensor-parallel collectives (``tp_collectives``), the traced peak above
the persistent bytes and the total, whether that fits the card
(``--hbm-bytes``, default the H100's 80 GB), the analysis' FLOPs, site
FLOPs, op-level HBM bytes and collectives, ``replicated_over_model`` and
the trace seconds.  ``replicated_over_model`` is measured: one rank's
product FLOPs (:func:`product_flops`) over its model group's whole step's
product FLOPs divided by the model axis' size (a second trace, on whole
weights): 1 where every product splits, the model size where none does.
An arch x shape that raises is a record with ``"status": "error"`` and
its traceback.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch import configs as configs_mod
from repro_torch.api.serve_session import (_RING_KEYS, serve_placement,
                                           tick_gather_spec)
from repro_torch.api.spmd_engine import grad_reduce_axes
from repro_torch.launch.meshcomm import (all_reduce_plan, chunk_shapes,
                                         plan_bytes, unshard_plan)
from repro_torch.config import (INPUT_SHAPES, SHAPES_BY_NAME, ModelConfig,
                                OptimizerConfig, SplitEEConfig, TrainConfig)
from repro_torch.core.losses import softmax_entropy
from repro_torch.core.spmd import StepConfig, make_grad_step, make_serve_step
from repro_torch.kernels import sites
from repro_torch.launch import shardings as sh
from repro_torch.launch.inputs import (abstract_params, serve_input_specs,
                                       train_input_specs)
from repro_torch.launch import tensor_parallel as tp_mod
from repro_torch.launch.mesh import axis_sizes, batch_axes, production_mesh_spec
from repro_torch.launch.meshcomm import _axes
from repro_torch.launch.step_analysis import StepAnalysis
from repro_torch.launch.tensor_parallel import (ModelGroup, expert_parallel,
                                                model_parallel,
                                                routing_groups)
from repro_torch.models.attention import RingPart, ShardedRing
from repro_torch.models.backbone import backbone_forward
from repro_torch.models.heads import whole_logits
from repro_torch.models.sync_stats import synced_batch_stats
from repro_torch.optim import adam_update
from repro_torch.optim.adam import AdamState
from repro_torch.tree import tree_leaves, tree_map

# ---------------------------------------------------------------------------
# long-context policy (docs/DESIGN.md section 4): SSM/hybrid run natively;
# dense archs get a 4096-token sliding-window variant; whisper is skipped.
# ---------------------------------------------------------------------------
LONG_SWA_WINDOW = 4096
LONG_NATIVE = {"zamba2-1.2b", "rwkv6-3b"}
LONG_SKIP = {"whisper-small"}

#: the H100 80GB HBM3's device memory
HBM_BYTES = 80e9

RECIPES = {
    "greedy": None,
    "megatron": sh.ShardingRecipe(scheme="megatron"),
    "megatron-nofsdp": sh.ShardingRecipe(scheme="megatron", fsdp=False),
    "hybrid": sh.ShardingRecipe(scheme="hybrid"),
}


def arch_config(arch: str, shape_name: str) -> Optional[ModelConfig]:
    mod = configs_mod.get(arch)
    if shape_name == "long_500k":
        name = mod.config().name
        if name in LONG_SKIP:
            return None
        if name in LONG_NATIVE:
            return mod.config()
        return mod.config(sliding_window=LONG_SWA_WINDOW)
    return mod.config()


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _fake_like(tree):
    """A fake CPU tensor (uninitialised) for every meta leaf of ``tree``;
    call under the fake mode."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), tree)


def rank_rows(batch: int, dp: int) -> int:
    """A rank's rows of a global batch: split over the data ranks where
    they divide it, else every row (``shardings.batch_specs``)."""
    return batch // dp if batch % dp == 0 else batch


def _chunk_of(t: torch.Tensor, shape) -> torch.Tensor:
    """Rank 0's chunk of ``t`` (``shape``): a copy where a dim is cut, as
    ``SpmdEngine._shard`` makes one."""
    out = t
    for d, n in enumerate(shape):
        if n != t.shape[d]:
            out = out.narrow(d, 0, n)
    return out if out is t else out.clone()


def _placement(cfg, params_abs, mesh, recipe, experts: bool = False):
    """One rank's placement of the parameter tree: ``(stored chunks,
    compute shapes, the weight gathers of a step or tick, model group,
    expert group, its model group's compute shapes)``.  A leaf that
    ``shardings.tp_roles`` finds ``column``, ``row`` or ``expert`` keeps
    its ``"model"`` chunk for compute and is gathered over its other axes
    only; with ``experts`` (a train step) an expert stack keeps its chunk
    over the batch ranks too (``Role.experts``) and the expert group
    counts its exchanges; any other leaf is gathered whole
    (``launch/meshcomm.unshard_plan``).  The model group's compute shapes
    are the whole shapes cut by the expert split alone (its whole step,
    for ``replicated_over_model``).  The groups count their collectives
    and send nothing."""
    sizes = axis_sizes(mesh)
    specs = sh.port_specs(sh.param_specs(sh.jax_layout(params_abs, cfg),
                                         cfg, mesh, recipe), params_abs, cfg)
    roles = sh.tp_roles(params_abs, specs, mesh, cfg, recipe)

    def by_role(fn, **kw):
        return sh.map_with_path(
            lambda p, _: fn(sh._lookup(specs, p), sh._lookup(roles, p),
                            recipe.tp_axis, experts=experts, **kw),
            params_abs)

    cspecs = by_role(sh.compute_spec)
    chunks = chunk_shapes(params_abs, specs, sizes, lead=0)
    compute = chunk_shapes(params_abs, by_role(sh.kept_spec), sizes, lead=0)
    group_compute = chunk_shapes(params_abs, sh.map_with_path(
        lambda p, _: sh.kept_spec(sh._lookup(specs, p), sh.Role(
            "gathered", experts=sh._lookup(roles, p).experts),
            recipe.tp_axis, experts=experts), params_abs), sizes, lead=0)
    gathers = [g for plan in unshard_plan(chunks, cspecs, sizes, lead=0)
               for g in plan]
    P = sizes.get(recipe.tp_axis, 1)
    group = (ModelGroup(None, P, 0, expert_blocks=sh.expert_blocks(roles))
             if P > 1 else None)
    axes = sh.expert_axes(roles) if experts else ()
    ep = (tp_mod.ExpertGroup(None, math.prod(sizes[a] for a in axes), 0,
                             sh.kept_experts(roles, cfg.moe.num_experts,
                                             sizes, recipe.tp_axis))
          if axes else None)
    return chunks, compute, gathers, group, ep, group_compute, roles


def _train_step(cfg, profile, shape, rows, grad_mode, remat, mesh, recipe,
                rec, tp: bool = True):
    """Traces one rank's train step; fills ``rec`` with the persistent,
    gathered and exchanged bytes; returns the analysis.  ``tp=False``
    traces the step its model group computes, on weights whole over the
    model axis and without its collectives (``replicated_over_model``
    reads it)."""
    sizes = axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in batch_axes(mesh))
    params_abs = abstract_params(cfg)
    chunks, compute, gathers, group, ep, group_compute, roles = _placement(
        cfg, params_abs, mesh, recipe, experts=True)
    if not tp:
        compute, gathers, group = group_compute, [], None
        if ep is not None:               # the experts over the batch alone
            ep = tp_mod.ExpertGroup(None, ep.size, 0,
                                    cfg.moe.num_experts // ep.size)
    opt_cfg = OptimizerConfig(state_dtype=torch.bfloat16, total_steps=10_000)
    moments = tree_map(lambda t: torch.empty(t.shape, dtype=torch.bfloat16,
                                             device="meta"), chunks)
    rec["persistent_bytes"] = tree_bytes(chunks) + 2 * tree_bytes(moments)
    # the gradients' all-reduce over the batch ranks; an expert stack kept
    # over them is summed over the others alone (spmd_engine)
    reduces = []
    if tp:
        by_axes: Dict[tuple, list] = {}
        for path, t in sh.tree_paths(compute):
            axes = grad_reduce_axes(batch_axes(mesh),
                                    sh._lookup(roles, path).experts)
            by_axes.setdefault(axes, []).append((t.shape, t.dtype))
        for axes, items in by_axes.items():
            reduces += all_reduce_plan(items, axes, sizes)
    rec["gathered_bytes"] = plan_bytes([gathers])
    rec["grad_reduce_bytes"] = sum(r["bytes"] for r in reduces)
    sc = StepConfig(model=cfg, splitee=SplitEEConfig(profile=profile),
                    train=TrainConfig(seq_len=shape.seq_len,
                                      batch_size=shape.global_batch,
                                      remat=remat, optimizer=opt_cfg),
                    grad_mode=grad_mode)
    grad_step = make_grad_step(sc)
    specs = train_input_specs(cfg, dataclasses.replace(shape,
                                                       global_batch=rows))
    batch = _fake_like(specs)
    p_chunks, opt = _fake_like(chunks), AdamState(
        step=0, m=_fake_like(moments), v=_fake_like(moments))
    # a MoE block's loads summed over the batch ranks (models/moe.py)
    loads = (synced_batch_stats(None, dp, 0)
             if cfg.moe is not None and dp > 1
             else contextlib.nullcontext())
    with StepAnalysis() as a:
        # the all_gathers' outputs: the parameters for this step
        for g in gathers:
            sites.collective("all_gather", g["bytes"])
        params = _fake_like(compute)
        with model_parallel(group), expert_parallel(ep), loads:
            grads, _ = grad_step(params, batch)
        del params
        for r in reduces:
            sites.collective("all_reduce", r["bytes"])
        grads = [None if g is None else _chunk_of(g, c.shape)
                 for g, c in zip(grads, tree_leaves(chunks))]
        adam_update(p_chunks, grads, opt, opt_cfg, 1e-4)
        del grads
    if group is not None:
        rec["tp_collectives"] = dict(group.bytes)
    if ep is not None and tp:
        rec["exchange_bytes"] = ep.bytes["all_to_all"]
        rec["experts_per_rank"] = ep.experts
    return a


def _prefill_step(cfg, shape, rows, last_token_heads, mesh, recipe, rec,
                  tp: bool = True):
    """One rank's prefill over its rows, with its chunks and the weight
    gathers of ``ServeSession``'s ``RankPlacement`` (``tp=False``: the
    whole step of its model group)."""
    params_abs = abstract_params(cfg)
    chunks, compute, gathers, group, ep = _placement(
        cfg, params_abs, mesh, recipe, experts=True)[:5]
    if not tp:
        compute, gathers, group = params_abs, [], None
    rec["persistent_bytes"] = tree_bytes(chunks)
    rec["gathered_bytes"] = plan_bytes([gathers])
    specs = train_input_specs(cfg, dataclasses.replace(shape,
                                                       global_batch=rows))
    specs.pop("labels")
    batch, params = _fake_like(specs), _fake_like(compute)
    # the rank's rows routed as one group, every data rank's beside it
    with torch.no_grad(), StepAnalysis() as a, model_parallel(group), \
            expert_parallel(ep), routing_groups(ep, 0, ep.size if ep
                                                else 1):
        for g in gathers:
            sites.collective("all_gather", g["bytes"])
        out = backbone_forward(params, cfg, tokens=batch.get("tokens"),
                               embeds=batch.get("embeds"),
                               enc=batch.get("enc"),
                               split_ids=batch["split_ids"])
        if last_token_heads:
            # serving prefill needs only the next-token position
            ent = [softmax_entropy(whole_logits(e[:, -1:], cfg))
                   for e in out.exit_logits]
            logits = whole_logits(out.logits[:, -1:], cfg)
        else:
            ent = [softmax_entropy(whole_logits(e, cfg))
                   for e in out.exit_logits]
            logits = whole_logits(out.logits, cfg)
        del out, ent, logits
    if group is not None:
        rec["tp_collectives"] = dict(group.bytes)
    _serve_exchange(rec, ep, tp)
    return a


def _serve_exchange(rec, ep, tp: bool) -> None:
    """A serving record's expert exchange: this rank's experts a stack
    and the exchange at its bound (``ExpertGroup`` counting), as the
    train record gives them."""
    if ep is not None and tp:
        rec["exchange_bytes"] = ep.bytes["all_to_all"]
        rec["experts_per_rank"] = ep.experts


def _tick_cache(cfg, pool, mesh, recipe, params_abs, rows, group):
    """A tick's cache on one rank as ``RankPlacement.working_cache`` holds
    it: fake tensors of this rank's slots, each leaf's split dims gathered
    but the slot dim over the batch axes and a decode ring's sequence,
    the rings split over ``"model"`` wrapped as ``ShardedRing`` with a
    counting gather.  Returns ``(stored chunks, the tick's gathers,
    cache)``."""
    sizes = axis_sizes(mesh)
    batch_all = batch_axes(mesh)
    _, cspecs = serve_placement(recipe, mesh, cfg, params_abs, pool)
    stored = chunk_shapes(pool, cspecs, sizes, lead=0)
    gspecs = sh.map_with_path(
        lambda p, _: tick_gather_spec(p, sh._lookup(cspecs, p), batch_all),
        pool)
    gathers = [g for plan in unshard_plan(stored, gspecs, sizes, lead=0)
               for g in plan]
    kept = sh.map_with_path(
        lambda p, _: tuple(None if e == w else e for e, w in zip(
            sh._lookup(cspecs, p), sh._lookup(gspecs, p))), pool)
    work = chunk_shapes(pool, kept, sizes, lead=0)
    cache = tree_map(lambda t: torch.empty((rows,) + tuple(t.shape[1:]),
                                           dtype=t.dtype), work)
    for si, seg in enumerate(cache):
        for li, layer in enumerate(seg):
            mixer = layer["mixer"]
            key = next((k for k in mixer if k in _RING_KEYS), None)
            axes = () if key is None else _axes(
                sh._lookup(cspecs, (si, li, "mixer", key))[1])
            if axes and group is not None:
                n = math.prod(sizes[a] for a in axes)
                layer["mixer"] = ShardedRing(mixer, RingPart(
                    width=mixer[key].shape[1] * n, parts=n, index=0,
                    gather=lambda x, n=n: tp_mod.all_gather(
                        x[None], ModelGroup(None, n, 0), 0)))
    return stored, gathers, cache


def _decode_step(cfg, profile, shape, rows, mesh, recipe, rec,
                 tp: bool = True):
    """One select tick on one rank's slots: its chunks of the weights and
    of the slot-paged cache, the tick's gathers, the products over its
    model group (``tp=False``: its group's whole tick on a whole
    cache)."""
    params_abs = abstract_params(cfg)
    chunks, compute, gathers, group, ep = _placement(
        cfg, params_abs, mesh, recipe, experts=True)[:5]
    specs = serve_input_specs(cfg, shape)
    if tp:
        stored, cgathers, cache = _tick_cache(cfg, specs["cache"], mesh,
                                              recipe, params_abs, rows,
                                              group)
    else:
        compute, gathers, group = params_abs, [], None
        stored, cgathers = specs["cache"], []
        cache = _fake_like(serve_input_specs(
            cfg, dataclasses.replace(shape, global_batch=rows))["cache"])
    rec["persistent_bytes"] = tree_bytes(chunks) + tree_bytes(stored)
    rec["gathered_bytes"] = plan_bytes([gathers + cgathers])
    rec["weight_gathered_bytes"] = plan_bytes([gathers])
    ins = _fake_like(serve_input_specs(
        cfg, dataclasses.replace(shape, global_batch=rows)))
    serve = make_serve_step(StepConfig(
        model=cfg, splitee=SplitEEConfig(profile=profile)), boundary=0)
    params = _fake_like(compute)
    # one routing group a slot, every data rank's slots beside the rank's
    with torch.no_grad(), StepAnalysis() as a, model_parallel(group), \
            expert_parallel(ep), routing_groups(
                ep, 0, ep.size * rows if ep else rows):
        for g in gathers + cgathers:
            sites.collective("all_gather", g["bytes"])
        out = serve(params, ins["tokens"], cache, ins["cache_len"],
                    enc=ins.get("enc"))
        del out
    if group is not None:
        rec["tp_collectives"] = dict(group.bytes)
    _serve_exchange(rec, ep, tp)
    return a


def session_state_bytes(model, split_layers, opt_cfg, mesh, recipe=None,
                        batch: int = 1) -> int:
    """The persistent bytes of a ``TrainSession``'s state on one rank of
    the spmd engine: its chunks of each cohort's carry (the cohort's
    lanes this rank holds, each leaf cut by the recipe's specs), what
    ``SpmdEngine.state_bytes`` reads after a run.  ``model`` a split
    adapter (a backbone's nets are built on the meta device), ``mesh`` a
    ``MeshSpec`` or a live mesh, ``batch`` each client's effective batch
    size (it decides whether the cohorts' lanes split)."""
    import copy

    from repro_torch.api.spmd_engine import abstract_cohort_carry, carry_specs
    from repro_torch.core.backbone_splitee import BackboneSplitModel
    recipe = sh.resolve_recipe(recipe)
    if isinstance(model, BackboneSplitModel):
        model = copy.copy(model)
        model.full_params = abstract_params(model.cfg)
    carry = abstract_cohort_carry(model, split_layers, opt_cfg)
    specs = carry_specs(recipe, mesh, carry, model)
    sizes = axis_sizes(mesh)
    total = 0
    for li, entry in carry.items():
        k = next(t for _, t in sh.tree_paths(entry)).shape[0]
        lanes = sh.stage_batch_spec(recipe, mesh, k, batch)[2]
        n = math.prod(sizes[a] for a in _axes(lanes))
        local = sh.map_with_path(
            lambda _, t: torch.empty((k // n,) + tuple(t.shape[1:]),
                                     dtype=t.dtype, device="meta"), entry)
        total += sum(t.numel() * t.element_size() for _, t in
                     sh.tree_paths(chunk_shapes(local, specs[li], sizes)))
    return total


def product_flops(res: dict) -> float:
    """The products' FLOPs of an analysis: dots outside the sites and the
    sites' model-level counts."""
    return res["flops"] + sum(res["site_flops"].values())


def run_one(arch: str, shape_name: str, multi_pod: bool = False, *,
            grad_mode: str = "eq1", remat: str = "full",
            recipe: Optional[sh.ShardingRecipe] = None,
            last_token_heads: bool = False, mesh=None,
            hbm_bytes: float = HBM_BYTES,
            layers: Optional[int] = None) -> Dict[str, Any]:
    """The record of one arch x shape x mesh (``mesh`` a ``MeshSpec``,
    default the production mesh); see the module docstring.  ``layers``
    cuts the depth (``e2e_train.cut_depth``: a quick trace at the
    published widths)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    shape = SHAPES_BY_NAME[shape_name]
    cfg = arch_config(arch, shape_name)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": "multi_pod" if multi_pod else "single_pod",
                           "kind": shape.kind, "grad_mode": grad_mode,
                           "remat": remat,
                           "recipe": recipe.scheme if recipe else "greedy"}
    if cfg is None:
        rec["status"] = "skipped"
        rec["reason"] = "long_500k inapplicable (see docs/DESIGN.md §4)"
        return rec
    profile = configs_mod.get(arch).profile()
    if layers:
        from repro_torch.launch.e2e_train import cut_depth
        cfg, profile = cut_depth(cfg, layers)
    rec["layers"] = cfg.num_layers
    mesh = mesh if mesh is not None else production_mesh_spec(
        multi_pod=multi_pod)
    recipe = recipe or sh.default_recipe(cfg, mesh)
    sizes = axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in batch_axes(mesh))
    model = sizes.get(recipe.tp_axis, 1)
    rows = rank_rows(shape.global_batch, dp)
    rec.update(last_token_heads=last_token_heads, ranks=mesh.size,
               rows_per_rank=rows)
    if shape.kind == "train":
        rec["placement"] = ("spmd engine step (tensor-parallel leaves kept "
                            "as model chunks, expert stacks as the rank's "
                            "experts, the rest gathered whole)")
    else:
        rec["placement"] = ("ServeSession over ranks (RankPlacement: "
                            "tensor-parallel leaves read in place, expert "
                            "stacks as the rank's experts, the rest "
                            "gathered each tick)")

    def trace(tp, into):
        if shape.kind == "train":
            return _train_step(cfg, profile, shape, rows, grad_mode,
                               "none" if remat == "none" else "full", mesh,
                               recipe, into, tp)
        if shape.kind == "prefill":
            return _prefill_step(cfg, shape, rows, last_token_heads, mesh,
                                 recipe, into, tp)
        return _decode_step(cfg, profile, shape, rows, mesh, recipe, into,
                            tp)

    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        a = trace(True, rec)
        res = a.result()
        group_flops = product_flops(res) * model
        if model > 1:
            group_flops = product_flops(trace(False, {}).result())
    rec["trace_s"] = round(time.perf_counter() - t0, 2)
    rec["replicated_over_model"] = (product_flops(res)
                                    / (group_flops / model))
    rec["peak_bytes"] = res["peak_bytes"]
    rec["total_bytes"] = rec["persistent_bytes"] + res["peak_bytes"]
    rec["hbm_bytes_card"] = hbm_bytes
    rec["fits"] = rec["total_bytes"] <= hbm_bytes
    rec["analysis"] = res
    rec["flops_per_rank"] = res["flops"] + sum(res["site_flops"].values())
    rec["status"] = "ok"
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description="per-rank dry run of the port")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--grad-mode", default="eq1", choices=["eq1", "sum"])
    ap.add_argument("--remat", default="full", choices=["full", "none"])
    ap.add_argument("--recipe", default="greedy", choices=sorted(RECIPES))
    ap.add_argument("--last-token-heads", action="store_true")
    ap.add_argument("--fsdp-pod", action="store_true",
                    help="3-axis FSDP: shard params/optimizer over "
                         "('pod','data') -- multi-pod mesh only")
    ap.add_argument("--hbm-bytes", type=float, default=HBM_BYTES,
                    help="device memory a rank fits in (default the "
                         "H100 80GB's)")
    ap.add_argument("--out", default="", help="append JSON lines here")
    args = ap.parse_args()

    archs = list(configs_mod.CANONICAL) if args.arch == "all" else [args.arch]
    shapes = ([s.name for s in INPUT_SHAPES] if args.shape == "all"
              else [args.shape])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    recipe = RECIPES[args.recipe]
    if args.fsdp_pod:
        recipe = dataclasses.replace(recipe or sh.ShardingRecipe(),
                                     fsdp_axes=("pod", "data"))
    out_f = open(args.out, "a") if args.out else None
    print(f"# dry run of one rank per arch x shape (recipe={args.recipe}, "
          f"fake tensors, no device)")
    for multi_pod in meshes:
        for arch in archs:
            for shape in shapes:
                tag = f"{arch} x {shape} x {'multi' if multi_pod else 'single'}"
                try:
                    rec = run_one(arch, shape, multi_pod,
                                  grad_mode=args.grad_mode, remat=args.remat,
                                  recipe=recipe,
                                  last_token_heads=args.last_token_heads,
                                  hbm_bytes=args.hbm_bytes)
                except Exception:                             # noqa: BLE001
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi_pod" if multi_pod else "single_pod",
                           "grad_mode": args.grad_mode,
                           "status": "error",
                           "error": traceback.format_exc(limit=25)}
                status = rec["status"]
                extra = ""
                if status == "ok":
                    extra = (f" flops/rank={rec['flops_per_rank']:.3e}"
                             f" total={rec['total_bytes'] / 1e9:.1f}GB"
                             f" fits={rec['fits']}"
                             f" gathered={rec['gathered_bytes']:.3e}"
                             f" trace={rec['trace_s']}s")
                print(f"[{status:7s}] {tag}{extra}", flush=True)
                if out_f:
                    out_f.write(json.dumps(rec) + "\n")
                    out_f.flush()
    if out_f:
        out_f.close()


if __name__ == "__main__":
    main()

"""Rank-side legs of the port's spmd engine tests (imported by the spawned
ranks of ``tests/test_torch_spmd_engine.py``; it imports no JAX).

``run_legs(world, inputs)`` runs every leg on this rank and returns
``{leg: result}``, a leg that raised holding ``{"error": traceback}``: one
broken leg fails its own tests only.  Results are numpy (keyed states in
the JAX package's layout, loss histories) so the test process compares
them with the JAX package's runs.
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

from repro_torch.api import TrainSession
from repro_torch.checkpoint import key_paths
from repro_torch.config import HeteroProfile, OptimizerConfig, SplitEEConfig
from repro_torch.configs import glm4_9b
from repro_torch.convert import state_to_jax
from repro_torch.core import splitee as tsplitee
from repro_torch.core.backbone_splitee import BackboneSplitModel
from repro_torch.data.synthetic import SyntheticSeqClsDataset
from repro_torch.data.pipeline import ClientPartitioner
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.shardings import (ShardingRecipe, spec_leaves,
                                          tree_paths)
from repro_torch.parity import unreduced_lanes, unsynced_batch_stats
from repro_torch.models.resnet import ResNetConfig
from repro_torch.population import ClientPopulation

LDM = ("lanes", "data", "model")

#: the MLP setting: Eq. (1) across an aggregate_every=2 boundary
MLP_SPLITS, MLP_ROUNDS, MLP_BATCH, MLP_LR, MLP_AGG = (1, 1, 2, 2), 4, 32, \
    3e-3, 2
#: the float64 ResNet setting (BatchNorm under a data split)
RES_SPLITS, RES_ROUNDS, RES_BATCH, RES_LR = (3, 3, 3, 3), 2, 8, 3e-5
RES_CFG = dict(num_classes=10, width_mult=0.125, image_size=8)
#: the population setting (tests/test_torch_population.py's MLP pair)
POP_SLOTS, POP_ROUNDS, POP_EPOCHS, POP_BATCH = (1, 1, 2, 2), 6, 2, 32
CHURN = dict(participation_rate=0.7, churn_seed=3, straggler_rate=0.25)
#: FSDP that shards the small MLP's matrices (the default recipe keeps
#: leaves under 65536 elements whole)
SMALL_FSDP = ShardingRecipe(min_shard_elems=64)


def blobs(n, d, classes, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, d)) * 2.0
    y = rng.integers(0, classes, n).astype(np.int32)
    x = (centers[y] + rng.normal(size=(n, d))).astype(np.float32)
    return x, y


def mlp_data():
    return ClientPartitioner(4).split(*blobs(400, 16, 3))


def mlp_model():
    return tsplitee.MLPSplitModel(16, 32, 3, num_layers=4, device="cpu")


def mlp_configs(grad_mode_total_steps=30):
    return (SplitEEConfig(profile=HeteroProfile(MLP_SPLITS),
                          aggregate_every=MLP_AGG),
            OptimizerConfig(lr=MLP_LR, total_steps=grad_mode_total_steps))


def resnet_model():
    return tsplitee.ResNetSplitModel(
        ResNetConfig(dtype=torch.float64, **RES_CFG), device="cpu")


def resnet_configs():
    return (SplitEEConfig(profile=HeteroProfile(RES_SPLITS)),
            OptimizerConfig(lr=RES_LR, total_steps=20,
                            state_dtype=torch.float64))


def pop_data():
    return blobs(1200, 16, 3, seed=4)


def pop_configs():
    return (SplitEEConfig(profile=HeteroProfile(POP_SLOTS)),
            OptimizerConfig(lr=3e-3, total_steps=30))


def population():
    x, y = pop_data()
    return ClientPopulation.dirichlet(x, y, 10, POP_SLOTS, alpha=0.5, seed=0,
                                      min_shard=POP_BATCH, **CHURN)


def keyed(state, model):
    """A port state keyed by its JAX-layout paths, as float64 numpy."""
    return {k: (np.asarray(v, np.float64) if np.asarray(v).dtype.kind == "f"
                else np.asarray(v))
            for k, v in key_paths(state_to_jax(state, model))}


def history(h):
    return [(m.client_loss, m.server_loss, m.active_clients, m.stragglers)
            for m in h]


def _meshes(world):
    """The leg meshes at ``world`` ranks: lanes only (a model axis fills
    4 ranks), lanes and data (4 ranks) or data only (2 ranks)."""
    lanes = make_host_mesh((2, 1, world // 2), LDM)
    data = (make_host_mesh((2, 2, 1), LDM) if world == 4
            else make_host_mesh((1, 2, 1), LDM))
    return lanes, data


def _mlp_run(inputs, mesh, recipe, *, engine="spmd", grad_mode="eq1",
             rounds=MLP_ROUNDS, fault=contextlib.nullcontext):
    sc, oc = mlp_configs()
    model = mlp_model()
    s = TrainSession(model, sc, oc, inputs["mlp_data"], MLP_BATCH,
                     engine=engine, mesh=mesh, recipe=recipe,
                     grad_mode=grad_mode,
                     state=copy.deepcopy(inputs["mlp_start"]))
    with fault():
        s.train(rounds)
    return s, model


def _result(session, model, **extra):
    return {"state": keyed(session.state.whole(), model),
            "history": history(session.history),
            "engine": session.engine_name, **extra}


def _gathered(session):
    """The bytes a cohort step gathered on this rank, measured and as
    ``api/spmd_engine.unshard_plan`` predicts them."""
    eng = session.engine
    return {"gathered": eng.last_gathered_bytes_per_step,
            "planned": eng.planned_gathered_bytes_per_step()}


def leg_lanes(world, inputs, meshes):
    s, m = _mlp_run(inputs, meshes[0], "greedy")
    f, _ = _mlp_run(inputs, None, None, engine="fused")
    return _result(s, m, fused=keyed(f.state.whole(), m),
                   fused_history=history(f.history), **_gathered(s))


def leg_lanes_eq1_fault(world, inputs, meshes):
    s, m = _mlp_run(inputs, meshes[0], "greedy",
                    fault=unreduced_lanes)
    return _result(s, m)


def leg_data_fsdp(world, inputs, meshes):
    s, m = _mlp_run(inputs, meshes[1] if world == 4 else None, SMALL_FSDP)
    return _result(s, m, **_gathered(s))


def leg_data_nofsdp(world, inputs, meshes):
    s, m = _mlp_run(inputs, meshes[1], "fsdp-off")
    return _result(s, m)


def leg_sum(world, inputs, meshes):
    s, m = _mlp_run(inputs, meshes[0], "greedy", grad_mode="sum", rounds=8)
    return _result(s, m)


def leg_shards(world, inputs, meshes):
    """Each stored leaf of the lane+FSDP carry on this rank, with its whole
    (all lanes, unsharded) element count and its spec."""
    sc, oc = mlp_configs()
    s = TrainSession(mlp_model(), sc, oc, inputs["mlp_data"], MLP_BATCH,
                     engine="spmd", mesh=meshes[1], recipe=SMALL_FSDP,
                     state=copy.deepcopy(inputs["mlp_start"]))
    eng = s.engine
    carry = eng._stack_carry(s.state)
    out = []
    for li, parts in carry.items():
        k = eng._counts[li]
        for part, specs in zip(parts, eng._specs[li]):
            for (path, t), spec in zip(tree_paths(part),
                                       spec_leaves(specs, part)):
                whole = k
                for d in range(1, t.ndim):
                    n = eng.comm.size(_axes(spec[d]))
                    whole *= t.shape[d] * n
                out.append((li, path, tuple(t.shape), spec, t.numel(),
                            whole))
    return {"leaves": out, "sizes": dict(eng.comm.sizes)}


def _axes(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def leg_resume(world, inputs, meshes):
    """Save at round 2 under lanes+FSDP, restore under "replicate" and
    under the fused engine; both continuations and the uninterrupted run."""
    d = os.path.join(inputs["tmp"], f"w{world}")
    sc, oc = mlp_configs()
    model = mlp_model()
    first = TrainSession(model, sc, oc, inputs["mlp_data"], MLP_BATCH,
                         engine="spmd", mesh=meshes[1], recipe=SMALL_FSDP,
                         state=copy.deepcopy(inputs["mlp_start"]))
    first.train(2, save_every=2, save_dir=d)
    dist.barrier()
    ckpt = os.path.join(d, "ckpt-00000002")
    out = {"saved": keyed(first.state.whole(), model), "ckpt": ckpt,
           "files": sorted(os.listdir(d)) if os.path.isdir(d) else []}
    for name, kw in (("replicate", dict(mesh=meshes[1],
                                        recipe="replicate")),
                     ("fused", dict(engine="fused"))):
        r = TrainSession.restore(ckpt, mlp_model(), inputs["mlp_data"], **kw)
        out[f"{name}_engine"] = r.engine_name
        out[f"{name}_recipe"] = r.ctx.recipe_name
        r.train(2)
        out[name] = keyed(r.state.whole(), model)
        out[f"{name}_history"] = history(r.history)
    full, _ = _mlp_run(inputs, meshes[1], SMALL_FSDP)
    out["full"] = keyed(full.state.whole(), model)
    out["full_history"] = history(full.history)
    return out


def leg_jax_checkpoint(world, inputs, meshes):
    """A JAX checkpoint (round 0) resumed under the spmd engine."""
    model = mlp_model()
    r = TrainSession.restore(inputs["jax_ckpt"], model, inputs["mlp_data"],
                             engine="spmd", mesh=meshes[0])
    r.train(MLP_ROUNDS - r.round)
    return _result(r, model, recipe=r.ctx.recipe_name)


def leg_resnet(world, inputs, meshes, fault=contextlib.nullcontext):
    sc, oc = resnet_configs()
    model = resnet_model()
    s = TrainSession(model, sc, oc, inputs["res_data"], RES_BATCH,
                     engine="spmd", mesh=meshes[1] if world == 4 else None,
                     state=copy.deepcopy(inputs["res_start"]))
    with fault():
        s.train(RES_ROUNDS)
    return _result(s, model)


def leg_resnet_bn_fault(world, inputs, meshes):
    return leg_resnet(world, inputs, meshes, fault=unsynced_batch_stats)


def leg_population(world, inputs, meshes):
    sc, oc = pop_configs()
    model = mlp_model()
    s = TrainSession(model, sc, oc, None, POP_BATCH, engine="spmd",
                     mesh=meshes[0], population=population(),
                     state=copy.deepcopy(inputs["pop_start"]))
    s.train(POP_ROUNDS, POP_EPOCHS, chunk_rounds=4)
    return _result(s, model)


def backbone_setup():
    """The tiny dense backbone (the glm4-9b smoke, fp32): model factory,
    configs, client shards and batch size."""
    cfg = glm4_9b.smoke()
    cuts = sorted(cfg.exit_layers)
    splits = (cuts[0], cuts[0], cuts[-1], cuts[-1])
    ds = SyntheticSeqClsDataset(vocab_size=cfg.vocab_size, seq_len=8,
                                num_classes=8, train_size=32, test_size=8,
                                seed=0)
    return (lambda: BackboneSplitModel(cfg, seed=0, device="cpu"),
            SplitEEConfig(profile=HeteroProfile(splits)),
            OptimizerConfig(lr=1e-5, total_steps=10),
            ClientPartitioner(4).split(*ds.train), 8)


def backbone_run(engine, mesh=None):
    make, sc, oc, parts, batch = backbone_setup()
    model = make()
    s = TrainSession(model, sc, oc, parts, batch, engine=engine, mesh=mesh)
    s.train(2)
    return _result(s, model)


def leg_backbone(world, inputs, meshes):
    """The tiny dense backbone under lanes (the test process runs the
    port's fused engine on it)."""
    return backbone_run("spmd", meshes[0])


LEGS = {name[4:]: fn for name, fn in globals().items()
        if name.startswith("leg_")}


def run_legs(world, inputs):
    torch.manual_seed(0)
    meshes = _meshes(world)
    out = {}
    for name, fn in LEGS.items():
        t0 = time.perf_counter()
        try:
            out[name] = fn(world, inputs, meshes)
        except Exception:                                 # noqa: BLE001
            out[name] = {"error": traceback.format_exc()}
        dist.barrier()
        print(f"leg {name}: {time.perf_counter() - t0:.2f} s", flush=True)
    # the tensor-parallel legs (tests/torch_tp_legs.py) in this world
    import torch_tp_legs
    t0 = time.perf_counter()
    out["tp"] = torch_tp_legs.train_legs(world)
    print(f"legs tp: {time.perf_counter() - t0:.2f} s", flush=True)
    return out



# ---------------------------------------------------------------------------
# the state kept as each rank's chunks (tests/test_torch_state_chunks.py)
# ---------------------------------------------------------------------------

#: rounds of a run: the chunk legs train K, K again, and 2K at once
CHUNK_K = {"mlp": 2, "backbone": 1}


def chunk_cases(world):
    """``(case, kind, mesh shape, mesh axes, recipe)``: the MLP's lanes
    and FSDP data split, the glm4-9b smoke's tensor parallelism, and the
    qwen3-moe smoke's experts over the data ranks (the data layout, and
    on 4 ranks the grid)."""
    from torch_tp_legs import family_recipe
    DM = ("data", "model")
    out = [("lanes", "mlp", (2, 1, world // 2), LDM, "greedy"),
           ("fsdp", "mlp", (1, 2, 1) if world == 2 else (2, 2, 1), LDM,
            SMALL_FSDP),
           ("tp", "glm4", (world // 2, 2), DM, "megatron"),
           ("qwen3-data", "qwen3", (2, world // 2), DM,
            family_recipe("data-experts"))]
    if world == 4:
        out.append(("qwen3-grid", "qwen3", (2, 2), DM,
                    family_recipe("megatron")))
    return out


def _chunk_setup(kind, inputs):
    """``(model factory, configs, client shards, batch, start state, eval
    set)`` of a chunk leg."""
    if kind == "mlp":
        sc, oc = mlp_configs()
        return (mlp_model, sc, oc, inputs["mlp_data"], MLP_BATCH,
                inputs["mlp_start"], blobs(100, 16, 3, seed=9))
    import dataclasses

    from torch_tp_legs import SMOKES

    from repro_torch.api.state import init_train_state
    make, sc, oc, parts, batch = backbone_setup()
    cfg = SMOKES[kind]()
    if kind != "glm4":
        cuts = sorted(cfg.exit_layers)
        sc = dataclasses.replace(sc, profile=HeteroProfile(
            (cuts[0], cuts[0], cuts[-1], cuts[-1])))
        make = lambda: BackboneSplitModel(cfg, seed=0,  # noqa: E731
                                          device="cpu")
    parts = [(np.minimum(x, cfg.vocab_size - 1), y) for x, y in parts]
    ds = SyntheticSeqClsDataset(vocab_size=cfg.vocab_size, seq_len=8,
                                num_classes=8, train_size=8, test_size=12,
                                seed=1)
    return (make, sc, oc, parts, batch, init_train_state(make(), sc, oc),
            ds.test)


def _held_chunks(sess):
    """Whether every tensor of ``sess.state`` on this rank is its chunk:
    each cohort's local lanes of the whole state, stacked, cut by the
    engine's specs (``MeshComm.shard``), compared shape by shape
    (``chunk_shapes``) and value by value.  Returns ``(mismatches, bytes
    held, bytes reckoned)``."""
    from repro_torch.api.fused_engine import _stack_opts
    from repro_torch.launch.meshcomm import chunk_shapes
    from repro_torch.launch.shardings import _lookup
    eng, st, model = sess.engine, sess.state, sess.model
    whole = st.whole()
    stackers = (model.stack_clients, _stack_opts, model.stack_clients,
                _stack_opts)
    fields = (whole.clients, whole.client_opts, whole.servers,
              whole.server_opts)
    bad, held, reckoned = [], 0, 0
    for li, entry in st.carry.items():
        ids = [eng._lanes[li][j] for j in eng._local[li]]
        for k in range(4):
            stacked = stackers[k]([fields[k][i] for i in ids])
            specs = eng._specs[li][k]
            shapes = chunk_shapes(stacked, specs, eng.comm.sizes)
            for path, t in tree_paths(entry[k]):
                want = _lookup(shapes, path)
                ref = eng.comm.shard(_lookup(stacked, path),
                                     _lookup(specs, path))
                held += t.numel() * t.element_size()
                reckoned += want.numel() * want.element_size()
                if t.shape != want.shape or not torch.equal(t, ref):
                    bad.append((li, k, path))
    return bad, held, reckoned


def _chunk_leg(inputs, kind, mesh, recipe):
    from repro_torch.launch.dryrun import session_state_bytes
    from repro_torch.parity import shifted_chunks
    make, sc, oc, parts, batch, start, (xt, yt) = _chunk_setup(kind, inputs)
    K = CHUNK_K["mlp" if kind == "mlp" else "backbone"]

    def session(engine="spmd"):
        kw = dict(mesh=mesh, recipe=recipe) if engine == "spmd" else {}
        return TrainSession(make(), sc, oc, parts, batch, engine=engine,
                            state=copy.deepcopy(start), **kw)

    out = {}
    split = session()
    split.train(K)
    bad, held, reckoned = _held_chunks(split)
    out["chunks"] = dict(
        bad=bad, held=held, reckoned=reckoned,
        state_bytes=split.engine.state_bytes,
        dryrun=session_state_bytes(make(), sc.profile.split_layers, oc, mesh,
                                   recipe, batch),
        whole=sum(t.numel() * t.element_size() for _, t in tree_paths(
            split.state.whole())
            if isinstance(t, torch.Tensor)))
    split.train(K)
    once = session()
    once.train(2 * K)
    parent = session()
    parent.train(K)
    parent.state = parent.state.whole()        # the gather between runs
    parent.train(K)
    fault = session()
    fault.train(K)
    with shifted_chunks():
        fault.train(K)
    fused = session("fused")
    fused.train(2 * K)
    for name, s in (("split", split), ("once", once), ("parent", parent),
                    ("fault", fault), ("fused", fused)):
        out[name] = keyed(s.state.whole(), s.model)
        out[f"{name}_history"] = history(s.history)
    out["engine"] = split.engine_name
    for name, s in (("split", split), ("fused", fused)):
        out[f"{name}_eval"] = (s.evaluate(xt, yt),
                               s.evaluate_adaptive(xt, yt, tau=0.5))
    return out


def chunk_legs(world, inputs):
    """Every chunk leg on this rank, ``{case: result}``."""
    torch.set_num_threads(1)
    torch.manual_seed(0)
    out = {}
    for case, kind, shape, axes, recipe in chunk_cases(world):
        t0 = time.perf_counter()
        try:
            out[case] = _chunk_leg(inputs, kind, make_host_mesh(shape, axes),
                                   recipe)
        except Exception:                                 # noqa: BLE001
            out[case] = {"error": traceback.format_exc()}
        dist.barrier()
        print(f"chunk leg {case}: {time.perf_counter() - t0:.2f} s",
              flush=True)
    return out

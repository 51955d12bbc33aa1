"""Rank-side legs of the MoE data-split tests (imported by the spawned
ranks of ``tests/test_torch_moe_split.py``; it imports no JAX).

``run_legs(world, inputs)`` runs every leg on this rank and returns
``{leg: result}``, a leg that raised holding ``{"error": traceback}``.
On each MoE smoke (qwen3-moe, deepseek-v3) a leg trains the port's
one-rank fused engine, recording its routing (``parity.pinned_routes``),
then the spmd engine with the batch split over the ranks replaying it:
a data split over 2 ranks, lanes x data over 4.  The gradient leg holds
one cohort step's gradients, the router's included, against the one-rank
step's; the fault leg runs the split with each rank's expert loads left
unsummed (``parity.unsummed_expert_loads``).
"""
from __future__ import annotations

import contextlib
import copy
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api import TrainSession
from repro_torch.config import HeteroProfile, OptimizerConfig, SplitEEConfig
from repro_torch.configs import deepseek_v3_671b, qwen3_moe_235b_a22b
from repro_torch.core.backbone_splitee import BackboneSplitModel
from repro_torch.core.spmd import make_cohort_grad_step
from repro_torch.data.pipeline import ClientPartitioner
from repro_torch.data.synthetic import SyntheticSeqClsDataset
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.sync_stats import synced_batch_stats
from repro_torch.parity import Routes, pinned_routes, unsummed_expert_loads
from repro_torch.tree import tree_leaves

LDM = ("lanes", "data", "model")
#: tests/test_torch_backbone_split.py's setting: two clients at the smokes'
#: one cut, 16 sequences of 8 tokens a step, 3 rounds at lr 1e-5
ROUNDS, BATCH, SEQ, LR, SPLITS = 3, 16, 8, 1e-5, (2, 2)
ARCHS = {"qwen3": qwen3_moe_235b_a22b.smoke,
         "deepseek": deepseek_v3_671b.smoke}


def parts(cfg):
    ds = SyntheticSeqClsDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                num_classes=8, train_size=128, test_size=32,
                                seed=0)
    return ClientPartitioner(len(SPLITS)).split(*ds.train)


def configs():
    return (SplitEEConfig(profile=HeteroProfile(SPLITS),
                          strategy="averaging", aggregate_every=2),
            OptimizerConfig(lr=LR, total_steps=64))


def model(arch):
    return BackboneSplitModel(ARCHS[arch](), device="cpu")


def session(arch, start, engine, mesh=None):
    m = model(arch)
    sc, oc = configs()
    return TrainSession(m, sc, oc, parts(m.cfg), BATCH, engine=engine,
                        mesh=mesh, state=copy.deepcopy(start))


def flat_state(state):
    """Nets and Adam moments of a ``TrainState`` as float64 numpy, in one
    fixed order (``tests/test_torch_backbone_split.py``'s ``_gap``)."""
    leaves = tree_leaves([state.clients, state.servers,
                          [(o.m, o.v) for o in
                           state.client_opts + state.server_opts]])
    return [t.detach().double().numpy() for t in leaves]


def history(h):
    return [(m.client_loss, m.server_loss) for m in h]


def _mesh(world):
    """A data split over 2 ranks; lanes x data over 4."""
    if world == 4:
        return make_host_mesh((2, 2, 1), LDM)
    return make_host_mesh((2, 1), ("data", "model"))


@contextlib.contextmanager
def lane_window(session, routes: Routes):
    """Names each cohort step's local lanes in ``routes`` (the replay
    holds the part of the recorded lanes this rank steps)."""
    eng = session.engine
    real = eng._cohort_step

    def step(li, *a, **kw):
        local = eng._local[li]
        routes.lanes = slice(local[0], local[-1] + 1)
        return real(li, *a, **kw)

    eng._cohort_step = step
    try:
        yield
    finally:
        eng._cohort_step = real


def _split_run(arch, world, start, fault=contextlib.nullcontext):
    routes = Routes()
    with pinned_routes(routes, replay=False):
        fused = session(arch, start, "fused")
        fused.train(ROUNDS)
    spmd = session(arch, start, "spmd", _mesh(world))
    with pinned_routes(routes, replay=True), lane_window(spmd, routes), \
            fault():
        spmd.train(ROUNDS)
    return {"engine": spmd.engine_name, "state": flat_state(spmd.state),
            "history": history(spmd.history),
            "fused": flat_state(fused.state),
            "fused_history": history(fused.history),
            "flipped": routes.flipped, "tokens": routes.tokens,
            "calls": routes.calls, "recorded": len(routes.choices)}


def _grads(arch, start, world):
    """One cohort step's gradients on the whole batch (one rank) and on
    this rank's rows under the batch group, averaged over the ranks as the
    engine averages them; routing pinned from the one-rank step."""
    m = model(arch)
    sc, oc = configs()
    s = TrainSession(m, sc, oc, parts(m.cfg), BATCH, engine="fused",
                     state=copy.deepcopy(start))
    li = SPLITS[0]
    carry = s.engine._stack_carry(s.state)[li]
    client, server = carry[0], carry[2]
    rng = np.random.default_rng(3)
    k = len(SPLITS)
    x = torch.as_tensor(rng.integers(0, m.cfg.vocab_size, (k, BATCH, SEQ)))
    y = torch.as_tensor(rng.integers(0, 8, (k, BATCH)))
    step = make_cohort_grad_step(m, li)
    routes = Routes()
    with pinned_routes(routes, replay=False):
        gc, gs, closs, sloss, _, _ = step(client, server, x, y)
    want = [g.double().numpy() for g in list(gc) + list(gs)
            if g is not None]
    r, n = dist.get_rank(), world
    rows = slice(r * BATCH // n, (r + 1) * BATCH // n)
    group = dist.new_group(list(range(world)))
    with pinned_routes(routes, replay=True), \
            synced_batch_stats(group, n, r):
        gc2, gs2, closs2, sloss2, _, _ = step(client, server, x[:, rows],
                                              y[:, rows])
    got = [g for g in list(gc2) + list(gs2) if g is not None]
    for g in got:
        dist.all_reduce(g, group=group)
        g.div_(n)
    losses = torch.stack([closs2, sloss2])
    dist.all_reduce(losses, group=group)
    names = ["router" in "/".join(map(str, p)) for p in
             _paths([client["trainable"], server["trainable"]])]
    return {"got": [g.double().numpy() for g in got], "want": want,
            "losses": (losses / n).double().numpy(),
            "want_losses": torch.stack([closs, sloss]).double().numpy(),
            "router": [nm for nm, g in zip(names, list(gc) + list(gs))
                       if g is not None],
            "flipped": routes.flipped}


def _paths(tree):
    from repro_torch.launch.shardings import tree_paths
    return [p for p, _ in tree_paths(tree)]


def leg_split(world, inputs):
    return {arch: _split_run(arch, world, inputs[arch]) for arch in ARCHS}


def leg_grads(world, inputs):
    return {arch: _grads(arch, inputs[arch], world) for arch in ARCHS}


def leg_loads_fault(world, inputs):
    return {"qwen3": _split_run("qwen3", world, inputs["qwen3"],
                                fault=unsummed_expert_loads)}


LEGS = {name[4:]: fn for name, fn in globals().items()
        if name.startswith("leg_")}


def run_legs(world, inputs):
    # one thread a rank: the suite runs beside these ranks in other workers
    torch.set_num_threads(1)
    torch.manual_seed(0)
    out = {}
    for name, fn in LEGS.items():
        t0 = time.perf_counter()
        try:
            out[name] = fn(world, inputs)
        except Exception:                                 # noqa: BLE001
            out[name] = {"error": traceback.format_exc()}
        dist.barrier()
        print(f"leg {name}: {time.perf_counter() - t0:.2f} s", flush=True)
    return out

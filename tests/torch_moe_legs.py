"""Rank-side legs of the MoE data-split tests (imported by the spawned
ranks of ``tests/test_torch_moe_split.py``; it imports no JAX).

``run_legs(world, inputs)`` runs every leg on this rank and returns
``{leg: result}``, a leg that raised holding ``{"error": traceback}``.
On each MoE smoke (qwen3-moe, deepseek-v3) a leg trains the port's
one-rank fused engine, recording its routing (``parity.pinned_routes``),
then the spmd engine with the batch split over the ranks replaying it:
a data split over 2 ranks (mesh (2, 1): the experts over the grid, 2 a
rank), lanes x data over 4 (mesh (2, 2, 1): each lane's experts over its
2 data ranks).  Each rank keeps its chunk of the expert stacks, and the
dispatch and combine are an exchange over the data ranks
(``tensor_parallel.dispatch``/``collect``).  The gradient leg holds one
cohort step's gradients, the router's included, against the one-rank
step's, with this rank's experts only and the batch over every rank of
the world; the ``tight`` legs repeat the split and the gradients at
capacity factor TIGHT, where experts drop entries and the boundary of
the kept entries falls past a rank's rows.  The fault legs run the split
with each rank's expert loads left unsummed
(``parity.unsummed_expert_loads``), with the entries written at their
local slots (``parity.local_slots``) and with the experts' gradients
all-reduced over the batch ranks (``parity.reduced_expert_grads``).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api import TrainSession
from repro_torch.launch import tensor_parallel as tp
from repro_torch.launch.shardings import is_expert_stack, map_with_path
from repro_torch.models.moe import expert_capacity
from repro_torch.config import HeteroProfile, OptimizerConfig, SplitEEConfig
from repro_torch.configs import deepseek_v3_671b, qwen3_moe_235b_a22b
from repro_torch.core.backbone_splitee import BackboneSplitModel
from repro_torch.core.spmd import make_cohort_grad_step
from repro_torch.data.pipeline import ClientPartitioner
from repro_torch.data.synthetic import SyntheticSeqClsDataset
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.sync_stats import synced_batch_stats
from repro_torch.parity import (Routes, local_slots, pinned_routes,
                                reduced_expert_grads, unsummed_expert_loads)
from repro_torch.tree import tree_leaves

LDM = ("lanes", "data", "model")
#: tests/test_torch_backbone_split.py's setting: two clients at the smokes'
#: one cut, 16 sequences of 8 tokens a step, 3 rounds at lr 1e-5
ROUNDS, BATCH, SEQ, LR, SPLITS = 3, 16, 8, 1e-5, (2, 2)
ARCHS = {"qwen3": qwen3_moe_235b_a22b.smoke,
         "deepseek": deepseek_v3_671b.smoke}
#: a capacity factor at which the smokes' experts (4, top 2: ~64 entries
#: each over 128 tokens) keep ~47: the first rank's entries are kept and
#: the boundary of the kept ones falls inside a later rank's
TIGHT = 0.75


def parts(cfg):
    ds = SyntheticSeqClsDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                num_classes=8, train_size=128, test_size=32,
                                seed=0)
    return ClientPartitioner(len(SPLITS)).split(*ds.train)


def configs():
    return (SplitEEConfig(profile=HeteroProfile(SPLITS),
                          strategy="averaging", aggregate_every=2),
            OptimizerConfig(lr=LR, total_steps=64))


def model(arch, tight=False):
    cfg = ARCHS[arch]()
    if tight:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                capacity_factor=TIGHT))
    return BackboneSplitModel(cfg, device="cpu")


def session(arch, start, engine, mesh=None, tight=False):
    m = model(arch, tight)
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


def drop_census(routes: Routes, cfg, ranks: int) -> dict:
    """Over the recorded routing of a one-rank run (each call's whole
    batch), with its rows split into ``ranks`` contiguous blocks as the
    data split holds them: the entries capacity drops, and the (call,
    lane, expert) triples that drop entries and keep some of a rank's
    past the first (whose slots start at the earlier ranks' loads)."""
    m = cfg.moe
    dropped = crossing = 0
    for topi in routes.choices:
        N = topi.shape[-2]
        C = expert_capacity(N, m)
        experts = torch.arange(m.num_experts)
        loads = torch.stack([
            (blk[..., None] == experts).sum((-3, -2))
            for blk in topi.chunk(ranks, dim=-2)])           # (ranks, ..., E)
        total = loads.sum(0)
        kept = torch.where(total > C, C - 1, total)
        before = torch.cumsum(loads, 0) - loads
        mine = torch.minimum((kept - before).clamp(min=0), loads)
        dropped += int((total - kept).sum())
        crossing += int(((total > kept) & (mine[1:] > 0).any(0)).sum())
    return {"dropped": dropped, "crossing": crossing}


#: the one-rank fused runs, (arch, tight) -> (routes, state, history):
#: the fault legs replay the split leg's
_FUSED: dict = {}


def _fused_run(arch, start, tight):
    if (arch, tight) not in _FUSED:
        routes = Routes()
        with pinned_routes(routes, replay=False):
            fused = session(arch, start, "fused", tight=tight)
            fused.train(ROUNDS)
        _FUSED[arch, tight] = (routes, flat_state(fused.state.whole()),
                               history(fused.history))
    return _FUSED[arch, tight]


def _split_run(arch, world, start, fault=contextlib.nullcontext,
               tight=False):
    routes, fused_state, fused_history = _fused_run(arch, start, tight)
    spmd = session(arch, start, "spmd", _mesh(world), tight=tight)
    with pinned_routes(routes, replay=True), lane_window(spmd, routes), \
            fault():
        spmd.train(ROUNDS)
    eng = spmd.engine
    return {"engine": spmd.engine_name,
            "state": flat_state(spmd.state.whole()),
            "history": history(spmd.history),
            "fused": fused_state, "fused_history": fused_history,
            "flipped": routes.flipped, "tokens": routes.tokens,
            "calls": routes.calls, "recorded": len(routes.choices),
            "experts": eng.experts_per_rank,
            "num_experts": spmd.model.cfg.moe.num_experts,
            "data_ranks": eng.comm.sizes["data"],
            "expert_gathered": eng.planned_gathered_bytes_per_step(
                experts=True),
            "gathered": eng.last_gathered_bytes_per_step,
            "planned": eng.planned_gathered_bytes_per_step(),
            "exchanged": eng.last_exchange_bytes_per_step,
            "census": drop_census(routes, spmd.model.cfg,
                                  eng.comm.sizes["data"])}


def _grads(arch, start, world, tight=False):
    """One cohort step's gradients on the whole batch (one rank) and on
    this rank's rows under the batch group with this rank's chunk of
    each expert stack (the experts over every rank of the world), the
    others' averaged over the ranks as the engine averages them and the
    experts' divided alone (their owner already sums every rank's
    entries); routing pinned from the one-rank step."""
    m = model(arch, tight)
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
    r, n = dist.get_rank(), world
    rows = slice(r * BATCH // n, (r + 1) * BATCH // n)
    group = dist.new_group(list(range(world)))
    ep = tp.ExpertGroup(group, n, r, m.cfg.moe.num_experts // n)
    trees = [client["trainable"], server["trainable"]]
    experts = [is_expert_stack(m.cfg, p) for p in _paths(trees)]

    def mine(net):
        """This rank's chunk of each expert stack (dim 1: past the
        lanes)."""
        return {"trainable": map_with_path(
                    lambda p, t: tp.own_slice(t, ep, 1)
                    if is_expert_stack(m.cfg, p) else t, net["trainable"]),
                "state": net["state"]}

    with pinned_routes(routes, replay=True), \
            synced_batch_stats(group, n, r), tp.expert_parallel(ep):
        gc2, gs2, closs2, sloss2, _, _ = step(mine(client), mine(server),
                                              x[:, rows], y[:, rows])
    want, got, router = [], [], []
    names = ["router" in "/".join(map(str, p)) for p in _paths(trees)]
    for w, g, e, nm in zip(list(gc) + list(gs), list(gc2) + list(gs2),
                           experts, names):
        if w is None:
            continue
        if e:
            w = tp.own_slice(w, ep, 1)
        else:
            dist.all_reduce(g, group=group)
        g.div_(n)
        want.append(w.double().numpy())
        got.append(g.double().numpy())
        router.append(nm)
    losses = torch.stack([closs2, sloss2])
    dist.all_reduce(losses, group=group)
    return {"got": got, "want": want,
            "losses": (losses / n).double().numpy(),
            "want_losses": torch.stack([closs, sloss]).double().numpy(),
            "router": router, "experts_split": any(experts),
            "exchanged": ep.bytes["all_to_all"],
            "census": drop_census(routes, m.cfg, n),
            "flipped": routes.flipped}


def _paths(tree):
    from repro_torch.launch.shardings import tree_paths
    return [p for p, _ in tree_paths(tree)]


def leg_split(world, inputs):
    return {arch: _split_run(arch, world, inputs[arch]) for arch in ARCHS}


def leg_grads(world, inputs):
    return {arch: _grads(arch, inputs[arch], world) for arch in ARCHS}


def leg_tight(world, inputs):
    return {arch: _split_run(arch, world, inputs[arch], tight=True)
            for arch in ARCHS}


def leg_tight_grads(world, inputs):
    return {arch: _grads(arch, inputs[arch], world, tight=True)
            for arch in ARCHS}


def leg_loads_fault(world, inputs):
    return {"qwen3": _split_run("qwen3", world, inputs["qwen3"],
                                fault=unsummed_expert_loads)}


def leg_slots_fault(world, inputs):
    return {"qwen3": _split_run("qwen3", world, inputs["qwen3"],
                                fault=local_slots)}


def leg_grads_fault(world, inputs):
    return {"qwen3": _split_run("qwen3", world, inputs["qwen3"],
                                fault=reduced_expert_grads)}


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

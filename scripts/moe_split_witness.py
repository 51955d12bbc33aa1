"""What the MoE split's bf16 session comparison reads on the card, over
seeds, and where the split's first step departs from one rank's.

``chip_smoke.py`` (phase spmd, ``spmd_moe_leg``) trains the qwen3-moe
bf16 smoke for ``parity.LANE_ROUNDS`` rounds with its batch and its
experts over two ranks (the spmd engine: each rank's E / 2 experts, the
dispatch and combine an exchange) against the one-rank fused engine with
the routing pinned.  A data split rounds each rank's partial gradient of
every other leaf to bf16 before the ranks' sum, where one rank rounds the
whole batch's once, and Adam's first step moves every weight by about
the learning rate whatever its gradient's size, so a gradient that the
two roundings leave on either side of 0 moves that weight two learning
rates apart.  For each seed of the weights and the batches this script
reads max |dloss| over the rounds against the one-rank fused run, as the
leg reads it, for:

- the split (``split``), and its drift (``parity.paper_drift``);
- a control: the one-rank run on the plain versions against the kernels
  (``control``: two sound bf16 runs of one rank);
- the planted faults ``parity.local_slots`` and
  ``parity.reduced_expert_grads`` (``slots_fault``, ``grads_fault``).

At the first seed it also reads one cohort step's gradients leaf by leaf
(``||g - g_one|| / ||g_one||``) against the one-rank step's, routes
pinned: the split as the engine runs it (each rank's experts, the others'
gradients summed over the ranks), the split with every rank holding every
expert and the expert gradients summed over the ranks too (the data split
before expert parallelism), and the control.

``--split-only`` reads the split alone: what a package without expert
parallelism or its planted faults runs, so the same script reads an
older checkout through ``PYTHONPATH``.  Run from the repo root; it prints
one JSON line per seed and writes them to ``chiprun_out/`` (``--out``):

  PYTHONPATH=src python3 scripts/moe_split_witness.py --seeds 0 1 2 3
  PYTHONPATH=old/src python3 scripts/moe_split_witness.py --split-only \\
      --out moe_split_witness_old.json

Two gloo ranks share the one card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path += [ROOT, os.path.join(ROOT, "src")]   # PYTHONPATH comes first

FAMILY = "qwen3_moe_235b_a22b"
DEVICE = "cuda"


def _session(kernels: str, seed: int, state=None, **kw):
    """``parity.backbone_session``'s session, its weights and its dataset
    drawn from ``seed``."""
    from repro_torch import configs, parity
    from repro_torch.api.session import TrainSession
    from repro_torch.config import (HeteroProfile, OptimizerConfig,
                                    SplitEEConfig)
    from repro_torch.core.backbone_splitee import BackboneSplitModel
    from repro_torch.data.pipeline import ClientPartitioner
    from repro_torch.data.synthetic import SyntheticSeqClsDataset
    cfg = configs.get(FAMILY).smoke_bf16().with_(kernels=kernels)
    splits = parity.LANE_SPLITS[FAMILY]
    model = BackboneSplitModel(cfg, seed=seed, device=DEVICE)
    ds = SyntheticSeqClsDataset(
        vocab_size=cfg.vocab_size, seq_len=parity.LANE_SEQ, num_classes=8,
        train_size=len(splits) * parity.LANE_BATCH * parity.LANE_ROUNDS,
        test_size=64, seed=seed)
    return TrainSession(
        model, SplitEEConfig(profile=HeteroProfile(splits),
                             strategy="averaging"),
        OptimizerConfig(lr=parity.TRAIN_LR,
                        total_steps=2 * parity.LANE_ROUNDS),
        ClientPartitioner(len(splits)).split(*ds.train), parity.LANE_BATCH,
        state=state, **{"engine": "fused", **kw})


def _gap(hist, ref) -> float:
    return max(max(abs(a.client_loss - b.client_loss),
                   abs(a.server_loss - b.server_loss))
               for a, b in zip(hist, ref))


def _sessions(seed: int, split_only: bool) -> dict:
    import torch.distributed as dist

    from repro_torch import parity
    from repro_torch.launch.mesh import make_host_mesh
    routes = parity.Routes()
    fused = _session("auto", seed)
    start = fused.state.clone()
    with parity.pinned_routes(routes, replay=False):
        ref = fused.train(parity.LANE_ROUNDS)
    mesh = make_host_mesh((dist.get_world_size(), 1), ("data", "model"))

    def run(kernels="auto", fault=None, **kw):
        s = _session(kernels, seed, state=start.clone(), **kw)
        with parity.pinned_routes(routes, replay=True):
            if fault is None:
                return s, s.train(parity.LANE_ROUNDS)
            with fault():
                return s, s.train(parity.LANE_ROUNDS)

    split, hist = run(engine="spmd", mesh=mesh)
    d = parity.paper_drift(split.state, fused.state, start)
    row = {"seed": seed, "split": _gap(hist, ref),
           "split_drift": max(d["clients"], d["servers"]),
           "experts_per_rank": getattr(split.engine, "experts_per_rank",
                                       None)}
    if not split_only:
        row["control"] = _gap(run("ref")[1], ref)
        row["slots_fault"] = _gap(run(engine="spmd", mesh=mesh,
                                      fault=parity.local_slots)[1], ref)
        row["grads_fault"] = _gap(run(engine="spmd", mesh=mesh,
                                      fault=parity.reduced_expert_grads)[1],
                                  ref)
    return row


def _leaf_gaps(seed: int) -> dict:
    """One cohort step's gradients, leaf by leaf, against the one-rank
    step's (routes pinned from it)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import parity
    from repro_torch.core.spmd import make_cohort_grad_step
    from repro_torch.launch import tensor_parallel as tp
    from repro_torch.launch.shardings import (is_expert_stack,
                                              map_with_path, tree_paths)
    from repro_torch.models.sync_stats import synced_batch_stats
    s = _session("auto", seed)
    m, cfg = s.model, s.model.cfg
    li = parity.LANE_SPLITS[FAMILY][0]
    carry = s.engine._stack_carry(s.state)[li]
    client, server = carry[0], carry[2]
    k = parity.LANE_SPLITS[FAMILY].count(li)
    rng = np.random.default_rng(seed)
    B, T = parity.LANE_BATCH, parity.LANE_SEQ
    x = torch.as_tensor(rng.integers(0, cfg.vocab_size, (k, B, T)),
                        device=DEVICE)
    y = torch.as_tensor(rng.integers(0, 8, (k, B)), device=DEVICE)
    routes = parity.Routes()
    with parity.pinned_routes(routes, replay=False):
        want = make_cohort_grad_step(m, li)(client, server, x, y)[:2]
    plain = _session("ref", seed).model
    with parity.pinned_routes(routes, replay=True):
        ctrl = make_cohort_grad_step(plain, li)(client, server, x, y)[:2]
    r, n = dist.get_rank(), dist.get_world_size()
    rows = slice(r * B // n, (r + 1) * B // n)
    E = cfg.moe.num_experts
    ep = tp.ExpertGroup(dist.group.WORLD, n, r, E // n)
    paths = [p for p, _ in tree_paths([client["trainable"],
                                       server["trainable"]])]
    experts = [is_expert_stack(cfg, p) for p in paths]

    def mine(net):
        return {"trainable": map_with_path(
                    lambda p, t: tp.own_slice(t, ep, 1)
                    if is_expert_stack(cfg, p) else t, net["trainable"]),
                "state": net["state"]}

    def split(keep: bool):
        c, sv = (mine(client), mine(server)) if keep else (client, server)
        with parity.pinned_routes(routes, replay=True), \
                synced_batch_stats(dist.group.WORLD, n, r), \
                tp.expert_parallel(ep if keep else None):
            got = make_cohort_grad_step(m, li)(c, sv, x[:, rows],
                                               y[:, rows])[:2]
        out = []
        for g, e in zip(list(got[0]) + list(got[1]), experts):
            if g is not None:
                h = g.float().cpu()
                if not (keep and e):          # the engine's all-reduce
                    dist.all_reduce(h)
                g = (h.to(g.dtype).float() / n).to(DEVICE)
            out.append(g)
        return out

    def gaps(got, keep: bool) -> list:
        res = []
        for g, w, e, p in zip(got, list(want[0]) + list(want[1]), experts,
                              paths):
            if g is None or w is None:
                continue
            if keep and e:
                w = tp.own_slice(w, ep, 1)
            w = w.float()
            res.append(("/".join(map(str, p)), e,
                        float((g.float() - w).norm() / w.norm().clamp(
                            min=1e-30))))
        return res

    out = {}
    for name, got, keep in (
            ("split", split(True), True),
            ("experts_gathered", split(False), False),
            ("control", list(ctrl[0]) + list(ctrl[1]), False)):
        per = gaps(got, keep)
        out[name] = {
            "experts_max": max((v for _, e, v in per if e), default=0.0),
            "others_max": max((v for _, e, v in per if not e), default=0.0),
            "largest": sorted(((v, p) for p, _, v in per), reverse=True)[:4]}
    return out


def _rank(seeds, split_only: bool) -> list:
    import torch.distributed as dist
    rows = []
    for i, seed in enumerate(seeds):
        row = _sessions(seed, split_only)
        if i == 0 and not split_only:
            row["leaf_gaps"] = _leaf_gaps(seed)
        if dist.get_rank() == 0:
            print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--split-only", action="store_true",
                    help="the split alone (a package without expert "
                    "parallelism)")
    ap.add_argument("--out", default="moe_split_witness.json")
    args = ap.parse_args()
    from repro_torch.kernels import build
    from repro_torch.launch.hostdevices import HostRanks
    build.build()                        # once, before the ranks load them
    log, rows = HostRanks(2, _rank, (args.seeds, args.split_only),
                          backend="gloo", timeout=3000).wait()[0]
    print(log)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", args.out), "w") as f:
        json.dump({"device": card, "rows": rows}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

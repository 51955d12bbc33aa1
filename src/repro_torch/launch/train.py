"""The training entry point of the port (counterpart of
``repro.launch.train``), built on ``repro_torch.api.TrainSession``.

Runs on the CUDA card (``--device cpu`` runs the plain PyTorch path on the
CPU).  ``--engine auto`` picks the spmd engine when there is more than one
rank or a mesh, else the fused cohort engine for Averaging and distributed
(saying why spmd was skipped) and the reference engine for Sequential.

Every scale runs the same code path:
  * ``--host-devices N`` runs N ranks on this host (``launch.hostdevices``:
    gloo, or NCCL when each rank has a card of its own); rank 0's output is
    printed;
  * ``--distributed --coordinator HOST:PORT --num-processes N --process-id
    I`` (or the ``REPRO_*`` environment fallbacks) runs this process as
    one rank of an N-process world (``launch.distributed``);
  * ``--lanes L`` factors a cohort-lane axis out of the ranks
    (``make_lane_host_mesh``); ``--mesh single|multi`` builds the 256/512
    rank production mesh; ``--recipe`` picks how lanes, parameters and Adam
    moments spread over the mesh (``launch/shardings.py``; default
    ``greedy``, or the checkpoint's recipe on ``--resume``).

Checkpointing is the session's: ``--save-every N`` rotates ``ckpt-<round>``
pairs under ``--checkpoint-dir`` (the newest ``--keep-last``), a
``driver.json`` sidecar records the knobs that shape the data and the
model, and ``--resume`` continues from the newest readable checkpoint,
training only what is left of ``--rounds``.  Only the coordinator rank
writes them.  ``--population P`` trains a pool of P simulated clients (a
Dirichlet partition of the data, seeded churn and stragglers) over the
``--clients`` cohort slots.

Besides the paper-scale ``--model mlp|resnet`` adapters, ``--arch <name>``
trains a ``configs/`` backbone through ``BackboneSplitModel`` on a
synthetic sequence-classification stream (``--smoke``: its reduced
config).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --model mlp --clients 4 --rounds 10 --checkpoint-dir /tmp/run \\
      --save-every 4
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --model mlp --clients 4 --rounds 14 --checkpoint-dir /tmp/run --resume
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --model mlp --clients 4 --splits 1,1,2,2 --host-devices 4 --lanes 2 \\
      --recipe greedy
  PYTHONPATH=src python -m repro_torch.launch.train --model resnet \\
      --clients 12 --population 36 --participation-rate 0.7 \\
      --straggler-rate 0.2 --churn-seed 3 --rounds 8
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

from repro_torch import configs as configs_mod
from repro_torch.api import TrainSession
from repro_torch.config import HeteroProfile, OptimizerConfig, SplitEEConfig
from repro_torch.core.backbone_splitee import BackboneSplitModel
from repro_torch.core.splitee import MLPSplitModel, ResNetSplitModel
from repro_torch.data.pipeline import ClientPartitioner
from repro_torch.data.synthetic import (SyntheticImageDataset,
                                        SyntheticSeqClsDataset)
from repro_torch.device import resolve_device
from repro_torch.launch import distributed as distributed_mod
from repro_torch.launch.hostdevices import RankFailed, run_host_ranks
from repro_torch.launch.mesh import (make_lane_host_mesh,
                                     make_production_mesh, world_size)
from repro_torch.launch.shardings import NAMED_RECIPES
from repro_torch.models.resnet import ResNetConfig

#: default cut layers per model family (clients split shallow, mid, deep)
DEFAULT_SPLITS = {"mlp": (1, 2, 3), "resnet": (3, 4, 5)}

#: the knobs that shape the regenerated data, model and session; a resumed
#: run must match every one (the ``driver.json`` sidecar), or it would
#: replay another data stream or continue into another network
DATA_KNOBS = ("model", "arch", "smoke", "seq_len", "clients", "splits",
              "strategy", "aggregate_every", "batch", "grad_mode", "seed",
              "train_size", "test_size", "population", "dirichlet_alpha",
              "participation_rate", "churn_seed", "straggler_rate")

def driver_knobs(args, splits) -> dict:
    d = {k: getattr(args, k) for k in DATA_KNOBS if k != "splits"}
    d["splits"] = list(splits)
    return d


def check_driver_sidecar(ckpt_dir: str, args, splits) -> None:
    """Stop when a resumed run would rebuild its data or model from other
    knobs than the saved run (the session manifest cannot see knobs like
    ``--train-size``; the sidecar can)."""
    path = os.path.join(ckpt_dir, "driver.json")
    if not os.path.exists(path):
        return                      # checkpoints written by library code
    with open(path) as f:
        saved = json.load(f)
    now = driver_knobs(args, splits)
    for k in DATA_KNOBS:
        if k in saved and saved[k] != now[k]:
            raise SystemExit(
                f"--resume mismatch: checkpoint dir was written with "
                f"--{k.replace('_', '-')}={saved[k]!r} but this run has "
                f"{now[k]!r}")


def resolve_arch_config(args):
    """The ``--arch`` run's ModelConfig, or None for the MLP and ResNet."""
    if not args.arch:
        return None
    try:
        mod = configs_mod.get(args.arch)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(f"--arch: {e}") from None
    cfg = mod.smoke() if args.smoke else mod.config()
    return cfg.with_(kernels=args.kernels)


def build_model_and_data(args, arch_cfg, device):
    """(adapter, train shards, train (x, y), held-out (x, y)), as the JAX
    entry point builds them; the whole train split rides along for
    ``--population``'s Dirichlet partition."""
    if arch_cfg is not None:
        cfg = arch_cfg
        model = BackboneSplitModel(cfg, seed=args.seed, device=device)
        ds = SyntheticSeqClsDataset(
            vocab_size=cfg.vocab_size, seq_len=args.seq_len,
            num_classes=min(8, cfg.vocab_size),
            train_size=args.train_size, test_size=args.test_size,
            seed=args.seed)
        x, y = ds.train
        xt, yt = ds.test
    elif args.model == "mlp":
        rng = np.random.default_rng(args.seed)
        classes, d = 5, 32
        centers = rng.normal(size=(classes, d)) * 2.0
        y = rng.integers(0, classes, args.train_size + args.test_size)
        y = y.astype(np.int32)
        x = (centers[y] + rng.normal(size=(len(y), d))).astype(np.float32)
        xt, yt = x[args.train_size:], y[args.train_size:]
        x, y = x[:args.train_size], y[:args.train_size]
        model = MLPSplitModel(in_dim=d, hidden=64, num_classes=classes,
                              num_layers=6, seed=args.seed, device=device)
    else:
        ds = SyntheticImageDataset(num_classes=10,
                                   train_size=args.train_size,
                                   test_size=args.test_size,
                                   image_size=16, noise=2.0, seed=args.seed)
        x, y = ds.train
        xt, yt = ds.test
        model = ResNetSplitModel(ResNetConfig(num_classes=10,
                                              width_mult=0.125,
                                              image_size=16),
                                 seed=args.seed, device=device)
    parts = ClientPartitioner(args.clients, seed=args.seed).split(x, y)
    return model, parts, (x, y), (xt, yt)


def build_population(args, splits, x, y):
    """The ``--population`` pool: a Dirichlet partition of the train split
    over ``--population`` clients, their cut layers cycling the slot
    layout, with the seeded churn and stragglers of the flags."""
    from repro_torch.population import ClientPopulation
    try:
        return ClientPopulation.dirichlet(
            x, y, num_clients=args.population, slot_splits=splits,
            alpha=args.dirichlet_alpha, seed=args.seed,
            participation_rate=args.participation_rate,
            churn_seed=args.churn_seed,
            straggler_rate=args.straggler_rate,
            min_shard=args.batch)
    except ValueError as e:
        raise SystemExit(f"--population: {e}") from None


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="mlp", choices=["mlp", "resnet"])
    ap.add_argument("--arch", default="",
                    help="train a configs/ backbone (glm4_9b, rwkv6_3b) "
                         "through BackboneSplitModel; overrides --model")
    ap.add_argument("--smoke", action="store_true",
                    help="with --arch: the reduced smoke() config")
    ap.add_argument("--seq-len", type=int, default=16,
                    help="with --arch: synthetic token sequence length")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--splits", default="",
                    help="comma-separated cut layer per client (default: "
                         "cycle the model family's depths)")
    ap.add_argument("--strategy", default="averaging",
                    choices=["averaging", "distributed", "sequential"])
    ap.add_argument("--aggregate-every", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=20,
                    help="total rounds the run should reach (a resumed run "
                         "trains only the remainder)")
    ap.add_argument("--local-epochs", type=int, default=1)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "spmd", "fused", "reference"])
    ap.add_argument("--grad-mode", default="eq1", choices=["eq1", "sum"])
    ap.add_argument("--kernels", default="auto", choices=["auto", "ref"],
                    help="with --arch: auto = the CUDA kernels on the card, "
                         "the plain versions on the CPU; ref = plain "
                         "everywhere (layout only, not a resume knob)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("--mesh", default="auto",
                    choices=["auto", "single", "multi"],
                    help="auto: the engine's default over the ranks; "
                         "single/multi: the 256/512-rank production mesh")
    ap.add_argument("--recipe", default=None, choices=sorted(NAMED_RECIPES),
                    help="spmd sharding recipe (launch/shardings.py): how "
                         "cohort lanes, params and Adam moments spread over "
                         "the mesh; 'replicate' is batch-only sharding.  "
                         "Default: 'greedy' for fresh runs, the "
                         "checkpoint's recipe on --resume")
    ap.add_argument("--lanes", type=int, default=1,
                    help="factor a cohort-lane axis of this size out of the "
                         "ranks (each rank holds and steps its lanes only)")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="run N ranks on this host (gloo, or NCCL with a "
                         "card per rank)")
    ap.add_argument("--distributed", action="store_true",
                    help="run as one rank of a multi-process world (env "
                         "fallbacks REPRO_DISTRIBUTED/REPRO_COORDINATOR/...)")
    ap.add_argument("--coordinator", default=None,
                    help="rendezvous address host:port for --distributed "
                         "(implies it)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="total process count for --distributed")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's rank for --distributed")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--save-every", type=int, default=0)
    ap.add_argument("--keep-last", type=int, default=3)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest readable checkpoint in "
                         "--checkpoint-dir (parameters, Adam moments, the "
                         "round and the data cursors)")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--train-size", type=int, default=4096)
    ap.add_argument("--test-size", type=int, default=1024)
    ap.add_argument("--tau", type=float, default=0.5,
                    help="entropy threshold of the adaptive evaluation")
    ap.add_argument("--population", type=int, default=0,
                    help="simulate a pool of this many clients over the "
                         "--clients cohort slots (0 = fixed cohort): "
                         "Dirichlet shards, seeded churn and stragglers, "
                         "participation masks on the device")
    ap.add_argument("--dirichlet-alpha", type=float, default=0.5,
                    help="label-skew concentration of the population's "
                         "Dirichlet partition (small = heavy skew)")
    ap.add_argument("--participation-rate", type=float, default=1.0,
                    help="per-round probability each cohort slot takes "
                         "part")
    ap.add_argument("--churn-seed", type=int, default=0,
                    help="seed of the availability, assignment and "
                         "straggler schedule")
    ap.add_argument("--straggler-rate", type=float, default=0.0,
                    help="per-round probability an assigned client misses "
                         "its deadline and is masked out")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    opts = distributed_mod.resolve_options(["train", *argv])
    if args.host_devices > 1:
        if opts.enabled:
            raise SystemExit("--host-devices runs every rank on this host; "
                             "it does not combine with --distributed")
        try:
            logs = run_host_ranks(args.host_devices, train, (argv,),
                                  device=args.device)
        except RankFailed as e:
            raise SystemExit(f"--host-devices {args.host_devices}: {e}"
                             ) from None
        print(logs[0][0], end="")
        return
    try:
        distributed_mod.maybe_initialize(opts, device=args.device)
    except ValueError as e:
        raise SystemExit(f"--distributed: {e}") from None
    try:
        train(argv)
    finally:
        import torch.distributed as dist
        if opts.enabled and dist.is_initialized():
            dist.destroy_process_group()


def train(argv) -> None:
    """One rank's run (the whole run without a process group)."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    coordinator = distributed_mod.is_coordinator()

    arch_cfg = resolve_arch_config(args)
    if args.splits:
        splits = tuple(int(s) for s in args.splits.split(","))
    elif arch_cfg is not None:
        cuts = tuple(sorted(arch_cfg.exit_layers))   # the valid cut layers
        splits = tuple(cuts[i % len(cuts)] for i in range(args.clients))
    else:
        splits = tuple(DEFAULT_SPLITS[args.model][i % 3]
                       for i in range(args.clients))
    if len(splits) != args.clients:
        raise SystemExit(f"--splits names {len(splits)} clients but "
                         f"--clients is {args.clients}")
    if arch_cfg is not None:
        bad = sorted(set(splits) - set(arch_cfg.exit_layers))
        if bad:
            raise SystemExit(
                f"--splits {bad} are not exit boundaries of "
                f"{arch_cfg.name}; valid cut layers: "
                f"{sorted(arch_cfg.exit_layers)}")

    resuming = bool(args.resume and args.checkpoint_dir and glob.glob(
        os.path.join(args.checkpoint_dir, "ckpt-*.json")))
    if resuming:
        # before any parameter init: a knob mismatch dies on the strings
        check_driver_sidecar(args.checkpoint_dir, args, splits)

    model, parts, (x, y), (xt, yt) = build_model_and_data(args, arch_cfg,
                                                          device)
    population = (build_population(args, splits, x, y)
                  if args.population > 0 else None)
    try:
        if args.mesh != "auto":
            mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                        lanes=args.lanes)
        elif args.lanes > 1:
            mesh = make_lane_host_mesh(args.lanes)
        else:
            mesh = None
    except ValueError as e:
        raise SystemExit(f"--lanes/--mesh: {e}") from None
    splitee_cfg = SplitEEConfig(profile=HeteroProfile(splits),
                                strategy=args.strategy,
                                aggregate_every=args.aggregate_every,
                                entropy_threshold=args.tau)
    opt_cfg = OptimizerConfig(
        lr=args.lr, warmup_steps=0,
        total_steps=max(args.rounds * args.local_epochs, 1) + 16)
    data = None if population is not None else parts

    resumed = False
    if resuming:
        # checkpoints exist, so --resume resumes or dies: starting afresh
        # here would let the rotation delete the real checkpoints
        try:
            session = TrainSession.restore_latest(
                args.checkpoint_dir, model, data, engine=args.engine,
                mesh=mesh, recipe=args.recipe, population=population)
        except Exception as e:                            # noqa: BLE001
            raise SystemExit(
                f"--resume: cannot restore from {args.checkpoint_dir!r}: "
                f"{e}") from e
        resumed = True
        # the restored session replays its saved config, while the data is
        # rebuilt from the flags: a mismatch would train on other data
        for knob, want, have in (
                ("seed", session.ctx.seed, args.seed),
                ("batch", session.ctx.batch_size, args.batch),
                ("grad-mode", session.ctx.grad_mode, args.grad_mode),
                ("strategy", session.ctx.strategy, args.strategy),
                ("splits", tuple(session.ctx.profile.split_layers), splits)):
            if want != have:
                raise SystemExit(
                    f"--resume mismatch: checkpoint was written with "
                    f"{knob}={want!r} but this run has {knob}={have!r}")
    else:
        try:
            session = TrainSession.from_config(
                model, splitee_cfg, opt_cfg, data, batch_size=args.batch,
                engine=args.engine, seed=args.seed, mesh=mesh,
                grad_mode=args.grad_mode, recipe=args.recipe,
                population=population)
        except ValueError as e:
            raise SystemExit(f"--engine {args.engine}: {e}") from None

    what = (f"arch={args.arch}{' (smoke)' if args.smoke else ''} "
            f"[{model.name}]" if args.arch else f"model={args.model}")
    print(f"{what}  clients={args.clients}  splits={splits}  "
          f"strategy={args.strategy}  grad_mode={args.grad_mode}"
          + (f"  population={args.population} "
             f"(alpha={args.dirichlet_alpha}, "
             f"rate={args.participation_rate}, "
             f"stragglers={args.straggler_rate}, "
             f"churn_seed={args.churn_seed})"
             if population is not None else ""))
    n = world_size()
    print(f"devices={n}"
          + (f" ({n} processes, rank {distributed_mod.process_index()})"
             if n > 1 else "")
          + f"  engine={session.engine_name}"
          + (f"  recipe={session.ctx.recipe_name}"
             if session.engine.name == "spmd" else "")
          + f"  device={device}"
          + (f"  [resumed at round {session.round}]" if resumed else ""))

    # checkpoints and the sidecar are shared-filesystem side effects: only
    # the coordinator writes them (every rank restores, and every rank
    # runs the same save_every segments, so their collectives line up)
    ckpt_dir = args.checkpoint_dir
    if ckpt_dir and coordinator:
        os.makedirs(ckpt_dir, exist_ok=True)
        with open(os.path.join(ckpt_dir, "driver.json"), "w") as f:
            json.dump(driver_knobs(args, splits), f, indent=1)

    remaining = args.rounds - session.round
    if remaining <= 0:
        print(f"checkpoint already at round {session.round} >= "
              f"--rounds {args.rounds}; nothing to train")
    else:
        # a checkpoint dir without --save-every: one save at the end
        save_every = (args.save_every or remaining) if ckpt_dir else 0
        t0 = time.time()
        session.train(remaining, local_epochs=args.local_epochs,
                      log_every=args.log_every, save_every=save_every,
                      save_dir=ckpt_dir or None, keep_last=args.keep_last)
        dt = time.time() - t0
        m = session.history[-1]
        print(f"trained {remaining} rounds in {dt:.1f}s "
              f"({remaining / dt:.2f} rounds/s)  "
              f"client_loss {m.client_loss:.4f}  "
              f"server_loss {m.server_loss:.4f}")
        if population is not None:
            # this invocation's rounds (the engine's own stats cover only
            # the last save_every segment)
            ms = session.history[-remaining:]
            actives = [m.active_clients for m in ms]
            slots = len(splits)
            print(f"participation: active "
                  f"{float(np.mean(actives)):.2f}/{slots} slots per round  "
                  f"stragglers {sum(m.stragglers for m in ms)}  "
                  f"masked {remaining * slots - sum(actives)} "
                  f"(pool of {population.num_clients})")
        if ckpt_dir and coordinator:
            print(f"checkpoints -> {ckpt_dir} "
                  f"(newest: round {session.round})")

    ev = session.evaluate(xt, yt, batch_size=512)
    ad = session.evaluate_adaptive(xt, yt, tau=args.tau, batch_size=512)
    for i, li in enumerate(splits):
        print(f"client {i} (l_i={li}): client_acc {ev['client_acc'][i]:.3f}  "
              f"server_acc {ev['server_acc'][i]:.3f}  "
              f"adaptive_acc {ad['acc'][i]:.3f} "
              f"(client_ratio {ad['client_ratio'][i]:.2f})")


if __name__ == "__main__":
    main()

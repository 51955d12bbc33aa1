"""Quickstart: Hetero-SplitEE on the port (counterpart of
``examples/quickstart.py``).

Three heterogeneous clients (cut layers 1/2/3 of a 4-layer net) train one
shared model collaboratively with the Averaging strategy (paper Alg. 2),
then serve with the entropy-gated early exit (Alg. 3): on the card the
gate is the CUDA kernel of ``kernels/csrc/entropy_exit.cu``.

Training goes through ``repro_torch.api.TrainSession``; ``engine="auto"``
picks the fused engine here (one rank), ``engine="reference"`` the
round-by-round oracle -- both produce the same numbers.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.api import TrainSession
from repro_torch.config import HeteroProfile, OptimizerConfig, SplitEEConfig
from repro_torch.core.splitee import MLPSplitModel
from repro_torch.data.pipeline import ClientPartitioner


def main(rounds: int = 40, engine: str = "auto", log_every: int = 10,
         device=None):
    """``device`` None runs on the CUDA card (raises without one)."""
    rng = np.random.default_rng(0)
    n, d, classes = 3000, 32, 5
    centers = rng.normal(size=(classes, d)) * 1.5
    y = rng.integers(0, classes, n).astype(np.int32)
    x = (centers[y] + rng.normal(size=(n, d))).astype(np.float32)
    train, test = (x[:2400], y[:2400]), (x[2400:], y[2400:])

    model = MLPSplitModel(in_dim=d, hidden=64, num_classes=classes,
                          num_layers=4, seed=0, device=device)
    profile = HeteroProfile(split_layers=(1, 2, 3))   # heterogeneous cuts
    clients = ClientPartitioner(3, seed=0).split(*train)

    session = TrainSession.from_config(
        model,
        SplitEEConfig(profile=profile, strategy="averaging"),
        OptimizerConfig(lr=3e-3, total_steps=60),
        clients, batch_size=64, engine=engine)
    print(f"engine: {session.engine_name}")
    session.train(rounds=rounds, local_epochs=1, log_every=log_every)

    ev = session.evaluate(*test)
    print("\nper-client accuracy (cut layers 1/2/3):")
    print("  client-side exits:", [f"{a:.3f}" for a in ev["client_acc"]])
    print("  server-side      :", [f"{a:.3f}" for a in ev["server_acc"]])

    print("\nadaptive inference (exit iff entropy < tau):")
    for tau in (0.1, 0.5, 1.0):
        ad = session.evaluate_adaptive(*test, tau=tau)
        print(f"  tau={tau:.1f}  acc={np.mean(ad['acc']):.3f}  "
              f"client-ratio={np.mean(ad['client_ratio']):.2f}")
    return session


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    a = ap.parse_args()
    main(rounds=a.rounds, engine=a.engine, device=a.device)

"""Adaptive client/server serving on the port (paper Alg. 3 + section
IV-D; counterpart of ``examples/adaptive_serving.py``) with batched
requests: the host-side router runs client inference, exits the confident
requests locally (the entropy gate: the CUDA kernel on the card) and
ships only the rest to the server model -- realizing the communication
saving the paper trades via the threshold tau.

  PYTHONPATH=src python -m repro_torch.examples.adaptive_serving \\
      [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.api import TrainSession
from repro_torch.config import HeteroProfile, OptimizerConfig, SplitEEConfig
from repro_torch.core.inference import AdaptiveInferenceEngine
from repro_torch.core.splitee import MLPSplitModel
from repro_torch.data.pipeline import ClientPartitioner


def main(rounds: int = 40, device=None) -> dict:
    """``device`` None runs on the CUDA card (raises without one).
    Returns each tau's (accuracy, client ratio, offloaded count)."""
    rng = np.random.default_rng(1)
    n, d, classes = 4000, 32, 10
    centers = rng.normal(size=(classes, d)) * 1.2
    y = rng.integers(0, classes, n).astype(np.int32)
    x = (centers[y] + rng.normal(size=(n, d))).astype(np.float32)
    train, test = (x[:3200], y[:3200]), (x[3200:], y[3200:])

    model = MLPSplitModel(in_dim=d, hidden=64, num_classes=classes,
                          num_layers=4, seed=0, device=device)
    profile = HeteroProfile(split_layers=(2, 2, 2))
    session = TrainSession.from_config(
        model, SplitEEConfig(profile=profile, strategy="averaging"),
        OptimizerConfig(lr=3e-3, total_steps=50),
        ClientPartitioner(3, seed=0).split(*train), batch_size=64)
    session.train(rounds=rounds)

    # wire client 0 + its server replica into the request router: the
    # TrainState holds every trained tensor
    li = profile.split_layers[0]
    client = session.state.clients[0]
    server = session.state.servers[0]

    def client_fn(xb):
        h, logits, _ = model.client_forward(client["trainable"],
                                            client["state"], xb, train=False)
        return h, logits

    def server_fn(h):
        logits, _ = model.server_forward(server["trainable"], server["state"],
                                         h, li, train=False)
        return logits

    xt = torch.as_tensor(test[0], device=model.device)
    out = {}
    print(f"{'tau':>5s} {'acc':>7s} {'client%':>8s} {'offloaded':>10s}")
    for tau in (0.05, 0.2, 0.5, 1.0, 2.0):
        engine = AdaptiveInferenceEngine(client_fn, server_fn, tau=tau)
        preds = []
        for i in range(0, len(xt), 64):
            preds.append(engine(xt[i: i + 64]).cpu().numpy())
        preds = np.concatenate(preds)
        acc = float((preds == test[1][: len(preds)]).mean())
        st = engine.stats
        print(f"{tau:5.2f} {acc:7.3f} {st.client_ratio:8.2%} "
              f"{st.total - st.exited:10d}")
        out[tau] = (acc, st.client_ratio, st.total - st.exited)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    a = ap.parse_args()
    main(rounds=a.rounds, device=a.device)

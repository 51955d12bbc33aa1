"""Adaptive serving CLI of the port: a thin front-end over
``repro_torch.api.ServeSession``, with the flags and report lines of
``repro.launch.serve``.

Serves a stream of synthetic prompts through the continuous-batching
entropy-gated engine (Alg. 3) on the CUDA card (``--device cpu`` runs the
plain PyTorch path on the CPU).  As in the JAX CLI, ``--arch`` selects the
architecture's smoke config.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --tau 2.0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --tau 2.0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4_9b \
      --ckpt /tmp/glm4/ckpt-00000003       # a trained checkpoint
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs as configs_mod
from repro_torch.api.serve_session import ServeSession, resolve_serve_boundary
from repro_torch.device import resolve_device
from repro_torch.models.backbone import init_backbone


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-tokens", type=int, default=32)
    ap.add_argument("--tau", type=float, default=2.0)
    ap.add_argument("--boundary", type=int, default=0,
                    help="exit boundary index used as the client cut "
                         "(indexes sorted(exit_layers))")
    ap.add_argument("--exit-policy", default="select",
                    choices=["select", "sticky"])
    ap.add_argument("--ckpt", default=None,
                    help="TrainSession checkpoint stem to serve (either "
                         "package's); default serves seed-initialized "
                         "weights")
    ap.add_argument("--kernels", default="auto", choices=["auto", "ref"],
                    help="auto = the CUDA kernels on the card, the plain "
                         "versions on the CPU; ref = plain everywhere")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs_mod.get(args.arch).smoke().with_(kernels=args.kernels)
    exits, cut, skip_frac = resolve_serve_boundary(cfg, args.boundary)
    max_len = args.prompt_len + 1 + args.decode_tokens
    if args.ckpt:
        from repro_torch.core.backbone_splitee import BackboneSplitModel
        session = ServeSession.restore(
            args.ckpt, BackboneSplitModel(cfg, seed=args.seed, device=device),
            tau=args.tau, boundary=args.boundary, slots=args.slots,
            max_len=max_len, exit_policy=args.exit_policy)
    else:
        params = init_backbone(
            torch.Generator(device=device).manual_seed(args.seed), cfg)
        session = ServeSession(cfg, params, tau=args.tau,
                               boundary=args.boundary, slots=args.slots,
                               max_len=max_len, exit_policy=args.exit_policy,
                               device=device)

    rng = np.random.default_rng(1)
    for _ in range(args.requests):
        session.submit(rng.integers(0, cfg.vocab_size, args.prompt_len),
                       decode_tokens=args.decode_tokens)
    session.run()

    st = session.stats
    ratio = st.adoption_ratio
    print(f"arch={cfg.name} tau={args.tau} boundary={args.boundary} "
          f"(cut layer {cut}/{cfg.num_layers}) policy={args.exit_policy}")
    print(f"served {st.requests} requests / {st.tokens} decode tokens in "
          f"{st.decode_ticks} ticks ({st.wall_s:.2f}s, "
          f"{st.tokens / max(st.wall_s, 1e-9):.1f} tok/s)  "
          f"client adoption ratio {ratio:.3f}")
    print(f"server compute skipped ~{ratio * skip_frac * 100:.1f}% of layer "
          f"work (exited tokens skip {skip_frac * 100:.0f}% of layers)")
    if args.exit_policy == "sticky":
        print(f"client-only ticks: {st.client_only_ticks}/{st.decode_ticks}")


if __name__ == "__main__":
    main()

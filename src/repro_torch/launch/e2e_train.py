"""End-to-end training loop of the port: the counterpart of the loop in
``examples/e2e_train_100m.py``, on the port's fused Hetero-SplitEE step
(``core/spmd.make_train_step``), Adam with the cosine schedule, and
``SyntheticLMDataset`` batches.

``--arch`` takes the architecture at its published widths, with the depth
cut to ``--layers`` and exit heads after layers N/4, N/2 and 3N/4; the
profile puts 4 client groups at each exit (12 groups, as
``configs/glm4_9b.profile()`` does at 40 layers).  ``--layers 0`` trains
it uncut, at its published exits (zamba2-1.2b: 10, 20, 29, where
``--layers 38`` would put them at 9, 19, 28).  ``--smoke`` takes the
architecture's smoke config instead (fp32, narrow), with the same cut.
Runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path.

Audio and VLM configs take the stub frontend's inputs, drawn from the seed
(``models/frontend.frontend_batch``): whisper-small ``enc`` (B,
``cross_source_len``, 768) random encoder states; paligemma-3b ``embeds``
(B, 256, 1152) random patch embeddings before T - 256 tokens, labels over
all T positions with the patches labelled 0.

  PYTHONPATH=src python -m repro_torch.launch.e2e_train --layers 8 --steps 20
  PYTHONPATH=src python -m repro_torch.launch.e2e_train --arch rwkv6-3b \
      --layers 0 --seq 512 --remat --steps 20
  PYTHONPATH=src python -m repro_torch.launch.e2e_train --smoke --layers 4 \\
      --steps 3 --batch 12 --seq 8 --device cpu --checkpoint /tmp/e2e

``--checkpoint PATH`` writes ``{"params", "opt"}`` through
``repro_torch.checkpoint.save_pytree`` in the JAX package's layout (the
file ``examples/e2e_train_100m.py --checkpoint`` writes), so the JAX
package's ``load_pytree`` reads it.
"""
from __future__ import annotations

import argparse
import time
from typing import Tuple

import numpy as np
import torch

from repro_torch import configs as configs_mod
from repro_torch.checkpoint import save_pytree
from repro_torch.config import (HeteroProfile, ModelConfig, OptimizerConfig,
                                SplitEEConfig, TrainConfig)
from repro_torch.core.spmd import (GRAD_MODES, StepConfig,
                                   boundary_ids_for_batch, make_train_step)
from repro_torch.convert import adam_state_to_jax, params_to_jax
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.models.frontend import frontend_batch
from repro_torch.models.backbone import init_backbone
from repro_torch.optim import adam_init
from repro_torch.tree import tree_leaves


def cut_depth(cfg: ModelConfig, layers: int
              ) -> Tuple[ModelConfig, HeteroProfile]:
    """``cfg`` cut to ``layers`` layers, exits after N/4, N/2 and 3N/4, and
    the 12-group profile with 4 groups at each exit."""
    if layers < 4:
        raise ValueError(f"--layers {layers}: at least 4 layers are needed "
                         f"for three distinct exits")
    exits = (layers // 4, layers // 2, 3 * layers // 4)
    cut = cfg.with_(num_layers=layers, exit_layers=exits,
                    block_pattern=cfg.block_pattern[:layers],
                    ffn_pattern=cfg.ffn_pattern[:layers])
    return cut, HeteroProfile(split_layers=tuple(e for e in exits
                                                 for _ in range(4)))


def full_depth(cfg: ModelConfig) -> Tuple[ModelConfig, HeteroProfile]:
    """``cfg`` uncut, at its own exits, and the profile with 4 client
    groups at each exit (the configs' ``profile()``)."""
    return cfg, HeteroProfile(split_layers=tuple(
        e for e in sorted(cfg.exit_layers) for _ in range(4)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4_9b")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's smoke config (narrow, fp32)")
    ap.add_argument("--layers", type=int, default=8,
                    help="depth cut; exits after layers N/4, N/2, 3N/4; "
                         "0 = the config's own depth and exits")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-mode", default="eq1", choices=GRAD_MODES)
    ap.add_argument("--remat", action="store_true",
                    help="recompute each block in the backward pass")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default="",
                    help="path stem: save {params, opt} after training")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mod = configs_mod.get(args.arch)
    base = mod.smoke() if args.smoke else mod.config()
    cfg, profile = (full_depth(base) if args.layers == 0
                    else cut_depth(base, args.layers))
    sc = StepConfig(
        model=cfg, splitee=SplitEEConfig(profile=profile),
        train=TrainConfig(
            optimizer=OptimizerConfig(lr=args.lr, total_steps=args.steps),
            remat="full" if args.remat else "none"),
        grad_mode=args.grad_mode)

    params = init_backbone(
        torch.Generator(device=device).manual_seed(0), cfg)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"model: {cfg.name} {cfg.num_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab_size} exits={cfg.exit_layers} "
          f"params={n_params / 1e6:.1f}M {str(cfg.dtype).split('.')[-1]} "
          f"grad_mode={args.grad_mode} remat={args.remat} device={device}")
    print(f"hetero profile ({profile.num_groups} clients): "
          f"{profile.split_layers}")

    opt = adam_init(params, sc.train.optimizer)
    step_fn = make_train_step(sc)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=args.seq,
                            structure=0.9, seed=0)
    sids = boundary_ids_for_batch(profile, cfg, args.batch, device)
    feats = np.random.default_rng(0)

    losses = []
    t0 = time.perf_counter()
    for step, (toks, labels) in enumerate(ds.batches(args.batch,
                                                     args.steps)):
        batch = {**frontend_batch(cfg, toks, labels, feats, device),
                 "split_ids": sids}
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["server_loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            cl = " ".join(f"b{i}={float(m[f'client_loss/b{i}']):.3f}"
                          for i in range(len(cfg.exit_layers)))
            tok_s = ((step + 1) * args.batch * args.seq
                     / (time.perf_counter() - t0))
            print(f"step {step:4d}  server={losses[-1]:.4f}  {cl}  "
                  f"lr={m['lr']:.2e}  {tok_s:,.0f} tok/s")
    last = float(np.mean(losses[-10:]))
    print(f"\nloss: first={losses[0]:.4f}  last={last:.4f}")
    if args.checkpoint:
        # the optimizer state and its step ride along, as in the JAX loop
        save_pytree(args.checkpoint,
                    {"params": params_to_jax(params, cfg),
                     "opt": adam_state_to_jax(opt, cfg)},
                    metadata={"steps": args.steps, "final_loss": last})
        print(f"checkpoint -> {args.checkpoint}.npz")
    return {"losses": losses, "params": params, "opt": opt}


if __name__ == "__main__":
    main()

"""What a bf16 smoke's loss limit rests on, read on the card.

``chip_smoke.py`` (phase parity) holds each bf16 smoke's three Adam steps
with the kernels against the same steps on the plain versions, at the
family's ``parity.TOL_LOSS_BF16``.  This script reads, for each family
and each batch seed, what that gap is made of:

- the plain path in bf16 and the kernels in bf16 against the plain path
  in fp32 (the same bf16-rounded weights and inputs, TF32 off): where
  the kernels stand no farther from fp32 than the plain bf16 path, the
  gap between the two bf16 runs is bf16 rounding;
- the kernels twice (run to run, the kernels are deterministic or not);
- a partial fault, ``chip_smoke.WIDE_HEAD_FAULT``: the second half of
  dK's head columns zeroed (at head dim 256, the second column block of
  the tile backward), against the plain bf16 run;
- the first eq1 step's gradients, each leaf's ||g - g_fp32|| / ||g_fp32||
  for the plain bf16 path and the kernels, and ||g - g_plain|| /
  ||g_plain|| for the kernels and the partial fault.

Run on one CUDA card from the repo root; it prints one line per reading
and writes them all to ``chiprun_out/bf16_witness.json``:

  PYTHONPATH=src python3 scripts/bf16_loss_witness.py
  PYTHONPATH=src python3 scripts/bf16_loss_witness.py \\
      --families paligemma_3b glm4_9b --seeds 2 3 4

``--device cpu`` runs every reading on the plain versions (a dry run: the
kernels' readings then equal the plain ones).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from chip_smoke import WIDE_HEAD_FAULT, planted  # noqa: E402
from repro_torch import configs, parity  # noqa: E402
from repro_torch.config import (HeteroProfile, OptimizerConfig,  # noqa: E402
                                SplitEEConfig, TrainConfig)
from repro_torch.core.spmd import (StepConfig, make_grad_step,  # noqa: E402
                                   make_train_step)
from repro_torch.models.backbone import init_backbone  # noqa: E402
from repro_torch.optim import adam_init  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

STEPS = 3          # as chip_smoke.py's train_parity
DEVICE = "cuda"    # --device cpu runs it through, on the plain versions


def as_dtype(tree, dtype):
    """A copy of ``tree`` with its floating leaves in ``dtype`` (the
    steps update their params in place)."""
    return tree_map(lambda t: t.to(dtype, copy=True) if t.is_floating_point()
                    else t.clone(), tree)


def step_config(cfg, train: bool) -> StepConfig:
    opt = OptimizerConfig(lr=parity.TRAIN_LR, total_steps=2 * STEPS)
    return StepConfig(model=cfg, splitee=SplitEEConfig(
        profile=HeteroProfile(parity.TRAIN_PROFILE)),
        train=TrainConfig(optimizer=opt) if train else TrainConfig())


def losses(cfg, params0, batches) -> np.ndarray:
    """eq1 losses (every metric but lr) of STEPS Adam steps."""
    sc = step_config(cfg, True)
    params = as_dtype(params0, cfg.param_dtype)
    opt = adam_init(params, sc.train.optimizer)
    step = make_train_step(sc)
    out = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        out.append([float(v) for k, v in sorted(m.items()) if k != "lr"])
    return np.asarray(out)


def grads(cfg, params0, batch):
    params = as_dtype(params0, cfg.param_dtype)
    return make_grad_step(step_config(cfg, False))(params, batch)[0]


def read(family: str, seed: int) -> dict:
    bf16 = configs.get(family).smoke_bf16().with_(exit_layers=(1, 2))
    fp32 = bf16.with_(dtype=torch.float32, param_dtype=torch.float32,
                      kernels="ref")
    plain, kern = bf16.with_(kernels="ref"), bf16.with_(kernels="auto")
    params0 = init_backbone(torch.Generator(device=DEVICE).manual_seed(0),
                            bf16)
    parity.live_rwkv(params0)
    batches = parity.smoke_batches(bf16, STEPS, seed=seed, device=DEVICE)
    batches32 = [as_dtype(b, torch.float32) for b in batches]
    l32 = losses(fp32, params0, batches32)
    lp = losses(plain, params0, batches)
    lk = losses(kern, params0, batches)
    lk2 = losses(kern, params0, batches)
    with planted(*WIDE_HEAD_FAULT[::2]):
        lf = losses(kern, params0, batches)
    d = lambda a, b: float(np.abs(a - b).max())  # noqa: E731
    r = {"family": family, "seed": seed,
         "plain_bf16_vs_fp32": d(lp, l32), "kernels_vs_fp32": d(lk, l32),
         "kernels_vs_plain_bf16": d(lk, lp), "kernels_twice": d(lk, lk2),
         "dk_half_zeroed_vs_plain_bf16": d(lf, lp),
         "limit": parity.TOL_LOSS_BF16[family]}
    g32 = grads(fp32, params0, batches32[0])
    gp = grads(plain, params0, batches[0])
    gk = grads(kern, params0, batches[0])
    with planted(*WIDE_HEAD_FAULT[::2]):
        gf = grads(kern, params0, batches[0])
    r.update(
        grad_plain_bf16_vs_fp32=max(parity.grad_rel_errors(gp, g32)),
        grad_kernels_vs_fp32=max(parity.grad_rel_errors(gk, g32)),
        grad_kernels_vs_plain_bf16=max(parity.grad_rel_errors(gk, gp)),
        grad_dk_half_zeroed_vs_plain_bf16=max(
            parity.grad_rel_errors(gf, gp)),
        grad_limit=parity.TOL_GRAD_BF16)
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--families", nargs="+", default=["paligemma_3b"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[2, 3, 4])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    global DEVICE
    DEVICE = args.device
    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for family in args.families:
        for seed in args.seeds:
            r = read(family, seed)
            print(" ".join(f"{k}={v:.3e}" if isinstance(v, float)
                           else f"{k}={v}" for k, v in r.items()),
                  flush=True)
            out.append(r)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "bf16_witness.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Learning-rate schedules (counterpart of ``repro/optim/schedule.py``).
Paper Table II: cosine annealing from eta_max = 1e-3 to eta_min = 1e-6
over T_max = 600 epochs, no warm-up.

The step counter is a host integer, so the learning rate is a Python
float: computing it never waits for the card."""
from __future__ import annotations

import math

from repro_torch.config import OptimizerConfig


def cosine_schedule(step: int, base_lr: float, min_lr: float,
                    total_steps: int, warmup_steps: int = 0) -> float:
    """Linear warm-up to ``base_lr`` over ``warmup_steps``, then cosine
    annealing to ``min_lr`` at ``total_steps`` (held there after)."""
    step = float(step)
    if step < warmup_steps:
        return base_lr * step / max(1.0, warmup_steps)
    t = min(max((step - warmup_steps)
                / max(1.0, total_steps - warmup_steps), 0.0), 1.0)
    return min_lr + 0.5 * (base_lr - min_lr) * (1.0 + math.cos(math.pi * t))


def make_schedule(cfg: OptimizerConfig):
    if cfg.schedule == "cosine":
        return lambda step: cosine_schedule(step, cfg.lr, cfg.min_lr,
                                            cfg.total_steps, cfg.warmup_steps)
    if cfg.schedule == "constant":
        return lambda step: float(cfg.lr)
    raise ValueError(f"unknown schedule {cfg.schedule!r}; expected 'cosine' "
                     f"or 'constant'")

"""Architecture registry of the port (counterpart of ``repro/configs``).

Every architecture id of the JAX registry is ported: glm4-9b, rwkv6-3b,
the three dense configs, qwen3-moe, zamba2-1.2b, deepseek-v3-671b,
whisper-small (cross attention over the stubbed encoder states) and
paligemma-3b (the stubbed vision patches before the tokens)."""
from __future__ import annotations

import importlib

ARCH_IDS = (
    "phi3_medium_14b",
    "minitron_8b",
    "zamba2_1p2b",
    "whisper_small",
    "command_r_35b",
    "deepseek_v3_671b",
    "glm4_9b",
    "qwen3_moe_235b_a22b",
    "paligemma_3b",
    "rwkv6_3b",
)
PORTED = ARCH_IDS

# CLI ids use dashes, matching the assignment table.
CANONICAL = {a.replace("_", "-").replace("-1p2b", "-1.2b"): a for a in ARCH_IDS}


def get(arch: str):
    """Resolve an architecture id (dash or underscore form) to its module."""
    name = CANONICAL.get(arch, arch).replace("-", "_").replace("1.2b", "1p2b")
    if name in PORTED:
        return importlib.import_module(f"repro_torch.configs.{name}")
    raise ValueError(f"{arch!r} is not a registered architecture; known: "
                     f"{', '.join(CANONICAL)}")

"""Configuration dataclasses of the port (counterpart of ``repro/config.py``).

The JAX module imports ``jax.numpy`` for its dtype defaults, so the port
keeps its own copy with torch dtypes.  Field names and defaults mirror the
JAX ``MoEConfig``, ``MLAConfig``, ``SSMConfig``, ``ModelConfig``,
``HeteroProfile``, ``SplitEEConfig``, ``OptimizerConfig`` and
``TrainConfig`` one for one (tests/test_torch_models.py
and tests/test_torch_train.py check the field lists), so a config reads the
same in both packages.  ``ShapeConfig`` and ``INPUT_SHAPES``, the dry
run's input shapes, are copied as they are; the TPU constants beside them
in the JAX module are not.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import torch

KERNEL_CHOICES = ("auto", "ref")


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration (``models/moe.py``)."""

    num_experts: int
    top_k: int
    d_expert: int                       # hidden dim of each routed expert
    num_shared_experts: int = 0         # DeepSeek-style always-on shared expert(s)
    d_shared_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001    # load-balance loss weight
    router_dtype: Any = torch.float32


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek Multi-head Latent Attention configuration (the ``"mla"``
    mixer)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """State-space / linear-attention block configuration (Mamba2, RWKV6)."""

    kind: str = "mamba2"               # "mamba2" | "rwkv6"
    d_state: int = 64                  # SSM state dim per head
    d_conv: int = 4                    # depthwise conv width (mamba)
    expand: int = 2                    # inner expansion factor
    head_dim: int = 64                 # SSD head dim
    chunk_size: int = 256              # chunked-scan block length


@dataclass(frozen=True)
class ModelConfig:
    """One architecture.  ``block_pattern`` gives the per-layer mixer kind
    and ``ffn_pattern`` the per-layer FFN kind (see ``repro.config``).  The
    port runs ``"attn"``, ``"mla"``, ``"mamba2"``, ``"rwkv6"`` and
    ``"shared_attn"`` mixers with ``"mlp"``, ``"moe"``, ``"rwkv_cm"`` and
    ``"none"`` FFNs (``moe`` a :class:`MoEConfig`, ``mla`` an
    :class:`MLAConfig`, ``ssm`` an :class:`SSMConfig`).

    ``kernels``: ``"auto"`` launches the CUDA kernels for CUDA tensors and
    their plain PyTorch versions for CPU tensors; ``"ref"`` runs the plain
    versions everywhere (an oracle)."""

    name: str
    arch_type: str                     # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // num_heads
    block_pattern: Tuple[str, ...] = ()    # defaults to all-"attn"
    ffn_pattern: Tuple[str, ...] = ()      # defaults to all-"mlp"
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rope_theta: float = 10000.0
    use_qkv_bias: bool = False
    use_mlp_bias: bool = False
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None   # tokens; None = full attention
    act: str = "silu"                  # mlp activation: silu (SwiGLU) | gelu
    cross_attention: bool = False      # enc-dec decoder (whisper)
    cross_source_len: int = 1500
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    kernels: str = "auto"
    # --- Hetero-SplitEE ---
    exit_layers: Tuple[int, ...] = ()  # layers after which an exit head sits
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if not self.block_pattern:
            object.__setattr__(self, "block_pattern", ("attn",) * self.num_layers)
        if not self.ffn_pattern:
            object.__setattr__(self, "ffn_pattern", ("mlp",) * self.num_layers)
        if (len(self.block_pattern) != self.num_layers
                or len(self.ffn_pattern) != self.num_layers):
            raise ValueError(f"{self.name}: block/ffn patterns must have "
                             f"num_layers={self.num_layers} entries")
        for l in self.exit_layers:
            if not 0 < l < self.num_layers:
                raise ValueError(f"{self.name}: exit layer {l} out of range")
        if self.kernels not in KERNEL_CHOICES:
            raise ValueError(f"{self.name}: kernels={self.kernels!r}; "
                             f"expected one of {KERNEL_CHOICES}")

    @property
    def q_heads_per_kv(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    def segments(self) -> Tuple[Tuple[int, int], ...]:
        """Contiguous [start, end) layer ranges delimited by exit layers."""
        bounds = [0, *sorted(self.exit_layers), self.num_layers]
        return tuple((bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1))

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class HeteroProfile:
    """Assignment of split points to client groups: ``split_layers[g]`` is
    the cut layer l_i of client group ``g``."""

    split_layers: Tuple[int, ...]

    @property
    def num_groups(self) -> int:
        return len(self.split_layers)

    @property
    def distinct_splits(self) -> Tuple[int, ...]:
        return tuple(sorted(set(self.split_layers)))

    def participation(self, layer: int) -> Tuple[int, ...]:
        """Eq. (1) participation set over 0-indexed layers,
        ``C_l = {i : l_i <= l}``."""
        return tuple(i for i, li in enumerate(self.split_layers) if li <= layer)


@dataclass(frozen=True)
class SplitEEConfig:
    """Hetero-SplitEE configuration (paper §III)."""

    profile: HeteroProfile
    strategy: str = "averaging"        # "sequential" | "averaging"
    server_lr_divisor: float = 0.0     # 0 -> auto: N for sequential, 1 for avg
    aggregate_every: int = 1
    entropy_threshold: float = 1.0     # exit iff H < tau_H

    def resolved_server_lr_divisor(self) -> float:
        if self.server_lr_divisor > 0:
            return self.server_lr_divisor
        return float(self.profile.num_groups) if self.strategy == "sequential" else 1.0


# ---------------------------------------------------------------------------
# Training / optimizer config (paper Table II defaults)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adam"
    lr: float = 1e-3                   # eta_max
    min_lr: float = 1e-6               # eta_min
    schedule: str = "cosine"           # cosine annealing | constant
    warmup_steps: int = 0
    total_steps: int = 600
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    state_dtype: Any = torch.float32   # Adam m/v dtype
    grad_clip: float = 0.0             # 0 = off


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 1024
    seq_len: int = 0
    global_rounds: int = 600
    local_epochs: int = 1
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    remat: str = "none"                # none | full | dots_saveable
    seed: int = 0


# ---------------------------------------------------------------------------
# Input shapes (the dry run's; ``repro/config.py``'s, copied)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # "train" | "prefill" | "decode"


INPUT_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in INPUT_SHAPES}

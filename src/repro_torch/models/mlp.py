"""Feed-forward block: SwiGLU (counterpart of ``repro/models/mlp.py``).
The three products are plain large matrix products (``torch.matmul``), as
the JAX package left them to XLA.  Over a ``"model"`` group
(``launch/tensor_parallel.py``) each rank multiplies with its chunk of
each weight: ``w_gate``/``w_up`` column-parallel (``b_up`` follows its
columns), ``w_down`` row-parallel with one all-reduce, ``b_down`` added
once after it; a weight held whole (``shardings.tp_roles``: gathered)
multiplies as one rank does."""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.launch import tensor_parallel as tp
from repro_torch.models.common import activation, fan_in_init


def init_mlp(cfg: ModelConfig, generator, device, d_ff: int = 0) -> dict:
    d, dff = cfg.d_model, d_ff or cfg.d_ff
    p = {
        "w_gate": fan_in_init((d, dff), cfg.param_dtype, generator, device),
        "w_up": fan_in_init((d, dff), cfg.param_dtype, generator, device),
        "w_down": fan_in_init((dff, d), cfg.param_dtype, generator, device),
    }
    if cfg.use_mlp_bias:
        p["b_up"] = torch.zeros((dff,), dtype=cfg.param_dtype, device=device)
        p["b_down"] = torch.zeros((d,), dtype=cfg.param_dtype, device=device)
    return p


def mlp_forward(params: dict, x: torch.Tensor, cfg: ModelConfig,
                d_ff: int = 0) -> torch.Tensor:
    """``d_ff``: the whole hidden width, where the weights may be this
    rank's chunks over an active ``"model"`` group (a block's FFN, a MoE
    block's shared expert, an expert stack's batched product); 0: the
    weights are held whole."""
    act = activation(cfg.act)
    d = x.shape[-1]
    d_ff = d_ff or params["w_gate"].shape[1]
    gate, gs = tp.linear(x, params["w_gate"], d, d_ff)
    up, us = tp.linear(x, params["w_up"], d, d_ff)
    if "b_up" in params:
        up = up + tp.local(params["b_up"], up.shape[-1])
    if gs != us:                       # one split, the other whole
        gate, up = tp.whole(gate, gs), tp.whole(up, us)
        gs = False
    out, split = tp.linear(act(gate) * up, params["w_down"], d_ff, d,
                           split_in=gs)
    out = tp.whole(out, split)
    if "b_down" in params:
        out = out + params["b_down"]
    return out.to(x.dtype)

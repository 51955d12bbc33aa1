"""Shared building blocks: initializers, norms, embeddings (counterpart of
``repro/models/common.py``).

Parameters are plain nested dicts of tensors, in the JAX package's layouts,
so ``repro_torch.convert`` moves JAX weights over by copy.  ``init_*``
functions draw from an explicit ``torch.Generator`` on the target device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.launch import tensor_parallel as tp


#: tensors of more elements are drawn in slices along their first axis
#: (DeepSeek-V3's expert weights, (256, 7168, 2048): whole, their fp32
#: draw would take 15 GB beside the weights already on the card)
SLICED_DRAW = 2 ** 31


def trunc_normal(shape, std: float, dtype, generator: torch.Generator,
                 device) -> torch.Tensor:
    """Truncated-normal init (2 sigma), drawn in fp32 then cast; a tensor
    of more than ``SLICED_DRAW`` elements slice by slice.  On the meta
    device (a tree of shapes, ``launch/inputs.abstract_params``) nothing
    is drawn."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")

    def draw(sub):
        t = torch.empty(sub, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return t.mul_(std).to(dtype)

    if math.prod(shape) <= SLICED_DRAW:
        return draw(shape)
    out = torch.empty(shape, dtype=dtype, device=device)
    for row in out:
        row.copy_(draw(row.shape))
    return out


def fan_in_init(shape, dtype, generator, device,
                fan_in: Optional[int] = None) -> torch.Tensor:
    fi = fan_in if fan_in is not None else shape[0]
    return trunc_normal(shape, 1.0 / math.sqrt(max(1, fi)), dtype, generator,
                        device)


def init_rmsnorm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Computed in fp32, then cast back to ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * params["scale"].float()).to(x.dtype)


def init_embedding(vocab: int, d: int, dtype, generator, device) -> dict:
    return {"table": trunc_normal((vocab, d), 1.0, dtype, generator, device)}


def embed(params: dict, tokens: torch.Tensor, vocab: int = 0
          ) -> torch.Tensor:
    """Rows of ``params["table"]`` (V, d).  A table held as this rank's
    chunk of the vocab (``vocab`` the whole V, over an active ``"model"``
    group) looks up the ids in its range and sums the rows over the group
    (``launch/tensor_parallel.embed_lookup``)."""
    table = params["table"]
    if tp.vocab_split(table.shape[0], vocab):
        return tp.embed_lookup(table, tokens)
    return table[tokens]


def activation(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]

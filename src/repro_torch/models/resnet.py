"""The paper's Table-I ResNet-18 with a selectable cut layer (counterpart
of ``repro/models/resnet.py``).

Layers, named as in the paper:
  layer1 : stem conv (stride 1 for CIFAR, 2 otherwise)
  layer2 : BasicBlock  64, stride 1
  layer3 : BasicBlock  64, stride 1
  layer4 : BasicBlock 128, stride 2
  layer5 : BasicBlock 256, stride 2
  layer6 : BasicBlock 512, stride 2
  head   : average pool + fc (the server output layer)
The client output layer (average pool + fc at the cut) is
``init_client_head`` / ``client_head_forward``.

Activations are NCHW and conv weights OIHW (the JAX package's are NHWC /
HWIO; ``repro_torch.convert`` holds the map).  Two rules of the JAX
package are kept by hand, because PyTorch's defaults differ:

  * padding is TF's ``"SAME"``: at stride 2 on an even size it pads
    (0, 1), where ``padding=1`` would pad (1, 1);
  * BatchNorm normalises with the biased batch variance and updates the
    running statistics with that same variance, as
    ``momentum * old + (1 - momentum) * batch`` (``F.batch_norm`` would
    use the unbiased variance and the other momentum convention).

Parameters are keyed ``layer1..layer6`` plus ``head`` so Eq. (1) finds
common layers across server models by name; the BatchNorm running
statistics travel beside them as ``state``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import fan_in_init
from repro_torch.models.sync_stats import batch_mean_var

BN_EPS = 1e-5


@dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 10
    stem_stride: int = 1              # 1 for CIFAR, 2 for STL-10
    width_mult: float = 1.0           # reduced variants for smoke tests
    num_layers: int = 6               # paper L = 6
    image_size: int = 32
    bn_momentum: float = 0.9
    dtype: torch.dtype = torch.float32

    def channels(self) -> Tuple[int, ...]:
        base = [64, 64, 64, 128, 256, 512]
        return tuple(max(8, int(c * self.width_mult)) for c in base)

    def strides(self) -> Tuple[int, ...]:
        return (self.stem_stride, 1, 1, 2, 2, 2)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def same_padding(n: int, k: int, s: int) -> Tuple[int, int]:
    """TF "SAME" padding of one spatial dim of size ``n``: (before, after)."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(w: torch.Tensor, x: torch.Tensor, stride: int) -> torch.Tensor:
    k = w.shape[-1]
    ph = same_padding(x.shape[2], k, stride)
    pw = same_padding(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:       # symmetric: the conv pads
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (*pw, *ph)), w, stride=stride)


def _init_conv(generator, k: int, cin: int, cout: int, dtype) -> torch.Tensor:
    return fan_in_init((cout, cin, k, k), dtype, generator, generator.device,
                       fan_in=k * k * cin)


def _init_bn(c: int, dtype, device) -> Tuple[dict, dict]:
    return ({"scale": torch.ones(c, dtype=dtype, device=device),
             "bias": torch.zeros(c, dtype=dtype, device=device)},
            {"mean": torch.zeros(c, dtype=torch.float32, device=device),
             "var": torch.ones(c, dtype=torch.float32, device=device)})


def _bn(params: dict, state: dict, x: torch.Tensor, train: bool,
        momentum: float) -> Tuple[torch.Tensor, dict]:
    """BatchNorm over (N, H, W); the new running statistics come out
    detached (they are state, not a function of the parameters)."""
    if train:
        mean, var = batch_mean_var(x, (0, 2, 3))
        new_state = {
            "mean": (momentum * state["mean"]
                     + (1 - momentum) * mean.detach()),
            "var": momentum * state["var"] + (1 - momentum) * var.detach(),
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    inv = torch.rsqrt(var + BN_EPS)
    out = ((x - mean[:, None, None]) * inv[:, None, None]
           * params["scale"][:, None, None] + params["bias"][:, None, None])
    return out, new_state


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _init_basic_block(generator, cin: int, cout: int, dtype
                      ) -> Tuple[dict, dict]:
    dev = generator.device
    p: dict = {"conv1": _init_conv(generator, 3, cin, cout, dtype),
               "conv2": _init_conv(generator, 3, cout, cout, dtype)}
    s: dict = {}
    p["bn1"], s["bn1"] = _init_bn(cout, dtype, dev)
    p["bn2"], s["bn2"] = _init_bn(cout, dtype, dev)
    if cin != cout:
        p["proj"] = _init_conv(generator, 1, cin, cout, dtype)
        p["bn_proj"], s["bn_proj"] = _init_bn(cout, dtype, dev)
    return p, s


def _basic_block(p: dict, s: dict, x: torch.Tensor, stride: int, train: bool,
                 momentum: float) -> Tuple[torch.Tensor, dict]:
    ns = {}
    h = _conv(p["conv1"], x, stride)
    h, ns["bn1"] = _bn(p["bn1"], s["bn1"], h, train, momentum)
    h = torch.relu(h)
    h = _conv(p["conv2"], h, 1)
    h, ns["bn2"] = _bn(p["bn2"], s["bn2"], h, train, momentum)
    if "proj" in p:
        sc = _conv(p["proj"], x, stride)
        sc, ns["bn_proj"] = _bn(p["bn_proj"], s["bn_proj"], sc, train,
                                momentum)
    else:
        sc = x if stride == 1 else x[:, :, ::stride, ::stride]
    return torch.relu(h + sc), ns


# ---------------------------------------------------------------------------
# full network
# ---------------------------------------------------------------------------


def layer_names(cfg: ResNetConfig) -> Tuple[str, ...]:
    return tuple(f"layer{i + 1}" for i in range(cfg.num_layers))


def init_resnet(generator: torch.Generator, cfg: ResNetConfig
                ) -> Tuple[dict, dict]:
    """(params, bn_state) keyed layer1..layerL plus ``head``, drawn from
    ``generator`` in layer order, on the generator's device."""
    chans = cfg.channels()
    dev = generator.device
    params: Dict[str, dict] = {}
    state: Dict[str, dict] = {}
    p1: dict = {"conv": _init_conv(generator, 3, 3, chans[0], cfg.dtype)}
    s1: dict = {}
    p1["bn"], s1["bn"] = _init_bn(chans[0], cfg.dtype, dev)
    params["layer1"], state["layer1"] = p1, s1
    cin = chans[0]
    for i in range(1, cfg.num_layers):
        p, s = _init_basic_block(generator, cin, chans[i], cfg.dtype)
        params[f"layer{i + 1}"], state[f"layer{i + 1}"] = p, s
        cin = chans[i]
    params["head"] = {
        "w": fan_in_init((cin, cfg.num_classes), cfg.dtype, generator, dev),
        "b": torch.zeros(cfg.num_classes, dtype=cfg.dtype, device=dev)}
    return params, state


def resnet_features(params: dict, state: dict, x: torch.Tensor,
                    cfg: ResNetConfig, *, start_layer: int = 0,
                    end_layer: Optional[int] = None, train: bool = False
                    ) -> Tuple[torch.Tensor, dict]:
    """Layers (start_layer, end_layer] on NCHW ``x``, 1-indexed as in the
    paper: ``start_layer=0, end_layer=3`` runs layer1..layer3 (a client
    with l_i = 3), ``start_layer=3`` runs layer4..L (its server).  Returns
    the features and ``state`` with the layers run replaced."""
    end_layer = end_layer or cfg.num_layers
    strides = cfg.strides()
    new_state = dict(state)
    h = x
    for i in range(start_layer, end_layer):
        name = f"layer{i + 1}"
        p, s = params[name], state[name]
        if i == 0:
            h = _conv(p["conv"], h, strides[0])
            h, ns_bn = _bn(p["bn"], s["bn"], h, train, cfg.bn_momentum)
            h = torch.relu(h)
            new_state[name] = {"bn": ns_bn}
        else:
            h, new_state[name] = _basic_block(p, s, h, strides[i], train,
                                              cfg.bn_momentum)
    return h, new_state


def head_forward(params: dict, feats: torch.Tensor) -> torch.Tensor:
    """Average pool over (H, W) + fc."""
    return feats.mean(dim=(2, 3)) @ params["w"] + params["b"]


# ---------------------------------------------------------------------------
# client output layer (paper: average pool + fc after the cut layer)
# ---------------------------------------------------------------------------


def init_client_head(generator: torch.Generator, cfg: ResNetConfig,
                     end_layer: int) -> dict:
    cin = cfg.channels()[end_layer - 1]
    dev = generator.device
    return {"w": fan_in_init((cin, cfg.num_classes), cfg.dtype, generator,
                             dev),
            "b": torch.zeros(cfg.num_classes, dtype=cfg.dtype, device=dev)}


client_head_forward = head_forward

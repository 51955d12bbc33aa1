"""Split-model adapters (counterpart of ``repro/core/splitee.py``): a layered
network cut into a client net (layers 1..l_i + the client output layer)
and a server net (layers l_i+1..L + the server head).

Adapters implement ``repro_torch.api.protocol.SplitModel``:

    make_client(l_i)  -> {"trainable": {"layers": ..., "out": ...}, "state"}
    make_server(l_i)  -> {"trainable": {layerK.., head}, "state"}
    client_forward(trainable, state, x, train) -> (h, client_logits, state)
    server_forward(trainable, state, h, l_i, train) -> (logits, state)

Every net starts from the same random seed (paper §III-B): the full
network is drawn once from ``torch.Generator().manual_seed(seed)`` and
each client's output layer from ``seed + 1000 + l_i``, so clients with the
same cut get the same head.  The generators are CPU generators and the
draws are moved to ``device`` after, so an adapter on the card and one on
the CPU start from the same weights.

Every ``make_client``/``make_server`` call returns tensors of its own: the
port's Adam updates in place, so nets sharing a tensor would move
together.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Sequence

import torch

from repro_torch.convert import images_to_nchw
from repro_torch.device import resolve_device
from repro_torch.models import resnet as rn
from repro_torch.models.common import fan_in_init
from repro_torch.tree import tree_map


def stack_pytrees(trees: Sequence[Any]) -> Any:
    """Same-structure trees stacked along a new leading lane axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def unstack_pytrees(stacked: Any, n: int) -> list:
    """Inverse of :func:`stack_pytrees`: ``n`` trees, each a view of one
    lane."""
    return [tree_map(lambda x: x[i], stacked) for i in range(n)]


def own_copy(tree: Any) -> Any:
    """``tree`` with every tensor cloned."""
    return tree_map(torch.clone, tree)


class _StackMixin:
    """Cohort helpers every adapter shares."""

    def stack_clients(self, trees: Sequence[Any]) -> Any:
        return stack_pytrees(trees)

    def unstack(self, stacked: Any, n: int) -> list:
        return unstack_pytrees(stacked, n)


def _seeded(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# ResNet adapter (the paper's experimental model)
# ---------------------------------------------------------------------------


@dataclass
class ResNetSplitModel(_StackMixin):
    """Images enter NHWC, as the datasets give them; features ``h`` at the
    cut are NCHW."""

    cfg: rn.ResNetConfig
    seed: int = 0
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        params, state = rn.init_resnet(_seeded(self.seed), self.cfg)
        to = lambda t: t.to(self.device)  # noqa: E731
        self.full_params = tree_map(to, params)
        self.full_state = tree_map(to, state)

    @property
    def num_layers(self) -> int:
        return self.cfg.num_layers

    def make_client(self, li: int) -> Dict[str, Any]:
        keys = [f"layer{k}" for k in range(1, li + 1)]
        head = rn.init_client_head(_seeded(self.seed + 1000 + li), self.cfg,
                                   li)
        return own_copy({
            "trainable": {"layers": {k: self.full_params[k] for k in keys},
                          "out": tree_map(lambda t: t.to(self.device), head)},
            "state": {k: self.full_state[k] for k in keys}})

    def make_server(self, li: int) -> Dict[str, Any]:
        keys = [f"layer{k}" for k in range(li + 1, self.num_layers + 1)]
        params = {k: self.full_params[k] for k in keys}
        params["head"] = self.full_params["head"]
        return own_copy({"trainable": params,
                         "state": {k: self.full_state[k] for k in keys}})

    def client_forward(self, trainable, state, x, train: bool):
        h, new_state = rn.resnet_features(
            trainable["layers"], state, images_to_nchw(x), self.cfg,
            end_layer=len(trainable["layers"]), train=train)
        return h, rn.client_head_forward(trainable["out"], h), new_state

    def server_forward(self, trainable, state, h, li: int, train: bool):
        feats, new_state = rn.resnet_features(trainable, state, h, self.cfg,
                                              start_layer=li, train=train)
        return rn.head_forward(trainable["head"], feats), new_state


# ---------------------------------------------------------------------------
# MLP adapter (fast tests)
# ---------------------------------------------------------------------------


@dataclass
class MLPSplitModel(_StackMixin):
    """L-layer ReLU MLP on flat inputs; layer l is keyed ``layer{l}`` so
    the same strategy and aggregation code applies."""

    in_dim: int
    hidden: int
    num_classes: int
    num_layers: int = 6
    seed: int = 0
    dtype: Any = torch.float32
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        gen = _seeded(self.seed)
        self.full_params = {}
        d_in = self.in_dim
        for l in range(1, self.num_layers + 1):
            self.full_params[f"layer{l}"] = self._dense(gen, d_in, self.hidden)
            d_in = self.hidden
        self.full_params["head"] = self._dense(gen, self.hidden,
                                               self.num_classes)

    def _dense(self, gen, d_in: int, d_out: int) -> dict:
        return {"w": fan_in_init((d_in, d_out), self.dtype, gen,
                                 "cpu").to(self.device),
                "b": torch.zeros(d_out, dtype=self.dtype, device=self.device)}

    def make_client(self, li: int) -> Dict[str, Any]:
        layers = {f"layer{k}": self.full_params[f"layer{k}"]
                  for k in range(1, li + 1)}
        out = self._dense(_seeded(self.seed + 1000 + li), self.hidden,
                          self.num_classes)
        return own_copy({"trainable": {"layers": layers, "out": out},
                         "state": {}})

    def make_server(self, li: int) -> Dict[str, Any]:
        params = {f"layer{k}": self.full_params[f"layer{k}"]
                  for k in range(li + 1, self.num_layers + 1)}
        params["head"] = self.full_params["head"]
        return own_copy({"trainable": params, "state": {}})

    @staticmethod
    def _apply_layers(layers: Dict[str, dict], h, keys):
        for k in keys:
            h = torch.relu(h @ layers[k]["w"] + layers[k]["b"])
        return h

    def client_forward(self, trainable, state, x, train: bool):
        keys = sorted(trainable["layers"], key=lambda s: int(s[5:]))
        h = self._apply_layers(trainable["layers"],
                               x.reshape(x.shape[0], -1), keys)
        logits = h @ trainable["out"]["w"] + trainable["out"]["b"]
        return h, logits, state

    def server_forward(self, trainable, state, h, li: int, train: bool):
        keys = [f"layer{k}" for k in range(li + 1, self.num_layers + 1)]
        h = self._apply_layers(trainable, h, keys)
        return h @ trainable["head"]["w"] + trainable["head"]["b"], state

"""JAX parameters, Adam states and configs -> the port's, and the port's
training state -> the JAX package's layout.

The caller converts the JAX parameter pytree to numpy first (for example
``jax.tree.map(np.asarray, params)``), so this module needs no JAX.  Stacked
runs (``lax.scan`` layers) are unstacked along their leading layer axis into
one dict per layer; every layout (``wq (d, H, hd)``, ``wo (H, hd, d)``, ...)
is kept, so the conversion is a copy.  This is how the tests give both
packages the same weights.

:func:`state_to_jax` is the inverse of :func:`split_state_from_jax`: the
port's ``TrainState`` as numpy arrays in the JAX package's layout, in
records (:class:`JaxTrainState`, :class:`JaxAdamState`) whose paths
``repro_torch.checkpoint`` spells as JAX does.  A checkpoint is that tree,
so a checkpoint written by either package restores in the other.

The one layout that changes is the ResNet's: the JAX package runs convs
NHWC with HWIO weights, the port NCHW with OIHW weights.  The two maps
below are the only place that says so.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import to_numpy
from repro_torch.config import MLAConfig, ModelConfig, MoEConfig, SSMConfig
from repro_torch.device import resolve_device
from repro_torch.models.backbone import build_plan
from repro_torch.optim import AdamState
from repro_torch.tree import tree_map


# axis orders: a JAX conv weight (kh, kw, cin, cout) -> the port's (cout,
# cin, kh, kw); a batch of images (N, H, W, C), as the datasets give them
# to both packages, -> the port's (N, C, H, W)
CONV_HWIO_TO_OIHW = (3, 2, 0, 1)
CONV_OIHW_TO_HWIO = (2, 3, 1, 0)
IMAGES_NHWC_TO_NCHW = (0, 3, 1, 2)


def images_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC images -> an NCHW view of them (no copy)."""
    return x.permute(*IMAGES_NHWC_TO_NCHW)


def to_tensor(a, device) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16) -> a tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def torch_dtype(dtype) -> torch.dtype:
    """A numpy-compatible dtype (``jnp.float32``, ``np.dtype``...) -> torch's."""
    return getattr(torch, np.dtype(dtype).name)


#: the sub-configs a ``ModelConfig`` holds, by field
_SUB_CONFIGS = {"moe": MoEConfig, "mla": MLAConfig, "ssm": SSMConfig}


def _mapped(cls, jval):
    """A JAX config dataclass -> the port's ``cls``, field by field, its
    dtype fields mapped to torch's."""
    kw = {}
    for f in dataclasses.fields(cls):
        val = getattr(jval, f.name)
        kw[f.name] = torch_dtype(val) if f.name.endswith("dtype") else val
    return cls(**kw)


def config_from_jax(jcfg, **overrides) -> ModelConfig:
    """The port's ``ModelConfig`` with every field of a JAX ``ModelConfig``
    (dtypes mapped; the JAX ``MoEConfig``, ``MLAConfig`` and ``SSMConfig``
    mapped field by field to the port's; ``kernels`` keeps the port's
    default unless given)."""
    kw = {}
    for f in dataclasses.fields(ModelConfig):
        if f.name == "kernels":
            continue
        val = getattr(jcfg, f.name)
        if f.name.endswith("dtype"):
            val = torch_dtype(val)
        elif f.name in _SUB_CONFIGS and val is not None:
            val = _mapped(_SUB_CONFIGS[f.name], val)
        kw[f.name] = val
    kw.update(overrides)
    return ModelConfig(**kw)


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """A JAX ``init_backbone`` parameter tree with numpy leaves -> the
    port's parameters on ``device`` (default the CUDA card).  Zamba2's
    ``shared_attn`` block and the audio or VLM ``frontend`` projector are
    copied as they are, and the ``{}`` placeholders of Zamba2's shared
    layers carried through; a cross-attending block's ``norm_x`` and
    ``cross`` ride in its layer's dict."""
    device = resolve_device(device)
    conv = lambda t: tree_map(lambda a: to_tensor(a, device), t)  # noqa: E731
    out = {"embed": conv(tree["embed"]),
           "segments": [segment_from_jax(seg, cfg, si, device)
                        for si, seg in enumerate(tree["segments"])],
           "head": conv(tree["head"])}
    for key in ("exit_heads", "shared_attn", "frontend"):
        if key in tree:
            out[key] = conv(tree[key])
    return out


def segment_from_jax(runs, cfg: ModelConfig, si: int, device) -> list:
    """Segment ``si`` of a JAX backbone (one tree per run of identical
    layers, stacked along a leading layer axis) -> the port's list of one
    dict per layer (a shared-block layer's ``{}`` stays ``{}``)."""
    conv = lambda t: tree_map(lambda a: to_tensor(a, device), t)  # noqa: E731
    layers = []
    for run, rp in zip(build_plan(cfg)[si], runs):
        if run.length == 1:
            layers.append(conv(rp))
        else:
            layers.extend(conv(tree_map(lambda a, i=i: np.asarray(a)[i], rp))
                          for i in range(run.length))
    return layers


def adam_state_from_jax(state, cfg: ModelConfig, device=None):
    """A JAX ``AdamState`` with numpy leaves (``jax.tree.map(np.asarray,
    opt_state)``) -> the port's :class:`repro_torch.optim.AdamState` on
    ``device`` (default the CUDA card): the moments unstacked as
    :func:`params_from_jax` unstacks the parameters, the step a host
    integer.  A JAX run can then be continued in the port."""
    return AdamState(step=int(np.asarray(state.step)),
                     m=params_from_jax(state.m, cfg, device),
                     v=params_from_jax(state.v, cfg, device))


def split_net_from_jax(tree, device) -> dict:
    """A JAX split-model net, or a tree of its Adam moments (numpy or JAX
    array leaves) -> tensors on ``device``; 4-d leaves are conv weights
    and go from HWIO to OIHW."""
    def conv(a):
        t = to_tensor(a, device)
        return (t.permute(*CONV_HWIO_TO_OIHW).contiguous() if t.ndim == 4
                else t)
    return tree_map(conv, tree)


def backbone_net_from_jax(tree, cfg: ModelConfig, device) -> dict:
    """A JAX ``BackboneSplitModel`` net or a tree of its Adam moments: a
    client's ``{"embed", "segments", "out"}`` or a server's ``{"seg{si}",
    "head"}`` trainables (``{"trainable", "state"}`` around them, or not)
    -> the port's, every segment unstacked by :func:`segment_from_jax`."""
    if "trainable" in tree:
        return {"trainable": backbone_net_from_jax(tree["trainable"], cfg,
                                                   device),
                "state": {}}
    conv = lambda t: tree_map(lambda a: to_tensor(a, device), t)  # noqa: E731
    out = {}
    for key, val in tree.items():
        if key == "segments":
            out[key] = [segment_from_jax(seg, cfg, si, device)
                        for si, seg in enumerate(val)]
        elif key.startswith("seg"):
            out[key] = segment_from_jax(val, cfg, int(key[3:]), device)
        else:
            out[key] = conv(val)
    return out


#: the dtypes a checkpoint widens to fp32 and a restore narrows again
_NARROW = (torch.bfloat16, torch.float16)


def split_state_from_jax(jax_state, model, like=None):
    """A JAX ``repro.api.state.TrainState`` of a split model (leaves numpy
    or JAX arrays) -> the port's :class:`repro_torch.api.state.TrainState`
    on ``model.device``: every client and server net, its BatchNorm state,
    its Adam moments and step, the round and the per-client draw counts.
    A ``BackboneSplitModel`` takes its nets through
    :func:`backbone_net_from_jax`, the ResNet and MLP adapters through
    :func:`split_net_from_jax`.  Tests start both packages' sessions from
    one state this way, since ``jax.random`` cannot be reproduced in
    torch.  ``like`` (a port ``TrainState`` of the same structure) narrows
    the tensors it holds in bf16 or fp16 back to that dtype (a checkpoint
    holds them widened to fp32); every other tensor keeps the dtype it was
    saved in (a float64 ResNet's BatchNorm statistics start in fp32 and
    train in float64)."""
    from repro_torch.api.state import TrainState
    from repro_torch.core.backbone_splitee import BackboneSplitModel
    dev = model.device
    if isinstance(model, BackboneSplitModel):
        net = lambda t: backbone_net_from_jax(t, model.cfg, dev)  # noqa: E731
    else:
        net = lambda t: split_net_from_jax(t, dev)  # noqa: E731

    def opt(s):
        return AdamState(step=int(np.asarray(s.step)), m=net(s.m),
                         v=net(s.v))

    state = TrainState(
        clients=tuple(net(c) for c in jax_state.clients),
        client_opts=tuple(opt(s) for s in jax_state.client_opts),
        servers=tuple(net(c) for c in jax_state.servers),
        server_opts=tuple(opt(s) for s in jax_state.server_opts),
        round=int(np.asarray(jax_state.round)),
        batches_drawn=tuple(int(c) for c in np.asarray(
            jax_state.batches_drawn)))
    if like is None:
        return state
    cast = lambda ts, refs: tuple(  # noqa: E731
        tree_map(lambda t, r: t.to(r.dtype) if r.dtype in _NARROW else t,
                 a, b) for a, b in zip(ts, refs))
    cast_opts = lambda ts, refs: tuple(  # noqa: E731
        AdamState(step=a.step, m=cast([a.m], [b.m])[0],
                  v=cast([a.v], [b.v])[0]) for a, b in zip(ts, refs))
    return state.replace(
        clients=cast(state.clients, like.clients),
        client_opts=cast_opts(state.client_opts, like.client_opts),
        servers=cast(state.servers, like.servers),
        server_opts=cast_opts(state.server_opts, like.server_opts))


# ---------------------------------------------------------------------------
# the port's state -> the JAX package's layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class JaxAdamState:
    """``repro.optim.AdamState``'s fields, in its flattening order."""
    step: Any
    m: Any
    v: Any


@dataclasses.dataclass
class JaxTrainState:
    """``repro.api.state.TrainState``'s fields, in its flattening order."""
    clients: Any
    client_opts: Any
    servers: Any
    server_opts: Any
    round: Any
    batches_drawn: Any


def split_net_to_jax(tree) -> dict:
    """Inverse of :func:`split_net_from_jax`: 4-d leaves (conv weights) go
    from OIHW to HWIO."""
    def conv(t):
        a = to_numpy(t)
        return (np.ascontiguousarray(a.transpose(*CONV_OIHW_TO_HWIO))
                if a.ndim == 4 else a)
    return tree_map(conv, tree)


def segment_to_jax(layers, cfg: ModelConfig, si: int) -> list:
    """Inverse of :func:`segment_from_jax`: the port's per-layer dicts of
    segment ``si`` restacked into one tree per run of identical layers."""
    runs, i = [], 0
    for run in build_plan(cfg)[si]:
        group = [tree_map(to_numpy, layer)
                 for layer in layers[i:i + run.length]]
        runs.append(group[0] if run.length == 1
                    else tree_map(lambda *xs: np.stack(xs), *group))
        i += run.length
    return runs


def params_to_jax(params: dict, cfg: ModelConfig) -> dict:
    """Inverse of :func:`params_from_jax`: the port's backbone parameters
    as host numpy arrays in a JAX ``init_backbone`` tree's layout."""
    return {key: ([segment_to_jax(seg, cfg, si)
                   for si, seg in enumerate(val)] if key == "segments"
                  else tree_map(to_numpy, val))
            for key, val in params.items()}


def adam_state_to_jax(state: AdamState, cfg: ModelConfig) -> "JaxAdamState":
    """Inverse of :func:`adam_state_from_jax`."""
    return JaxAdamState(step=np.asarray(state.step, np.int32),
                        m=params_to_jax(state.m, cfg),
                        v=params_to_jax(state.v, cfg))


def backbone_net_to_jax(tree, cfg: ModelConfig) -> dict:
    """Inverse of :func:`backbone_net_from_jax`."""
    if "trainable" in tree:
        return {"trainable": backbone_net_to_jax(tree["trainable"], cfg),
                "state": tree_map(to_numpy, tree["state"])}
    out = {}
    for key, val in tree.items():
        if key == "segments":
            out[key] = [segment_to_jax(seg, cfg, si)
                        for si, seg in enumerate(val)]
        elif key.startswith("seg"):
            out[key] = segment_to_jax(val, cfg, int(key[3:]))
        else:
            out[key] = tree_map(to_numpy, val)
    return out


def state_to_jax(state, model) -> JaxTrainState:
    """Inverse of :func:`split_state_from_jax`: the port's ``TrainState`` as
    host numpy arrays in the JAX package's layout (conv weights HWIO,
    backbone segments restacked per run, bf16 widened to fp32), the Adam
    steps, the round and the draw counts as int32.  A state kept as each
    rank's chunks is gathered whole first (``state.whole()``: collective
    over the spmd engine's ranks)."""
    from repro_torch.core.backbone_splitee import BackboneSplitModel
    state = state.whole()
    if isinstance(model, BackboneSplitModel):
        net = lambda t: backbone_net_to_jax(t, model.cfg)  # noqa: E731
    else:
        net = split_net_to_jax

    def opt(s):
        return JaxAdamState(step=np.asarray(s.step, np.int32), m=net(s.m),
                            v=net(s.v))

    return JaxTrainState(
        clients=tuple(net(c) for c in state.clients),
        client_opts=tuple(opt(s) for s in state.client_opts),
        servers=tuple(net(c) for c in state.servers),
        server_opts=tuple(opt(s) for s in state.server_opts),
        round=np.asarray(state.round, np.int32),
        batches_drawn=np.asarray(state.batches_drawn, np.int32))


def load_split_state(path: str, model, like):
    """The training state of checkpoint ``path`` (either package's), as
    the port's ``TrainState`` on ``model.device``: the JAX-layout tree is
    rebuilt from the keyed ``.npz`` in the structure of ``like`` (a port
    ``TrainState`` of the same session) and converted by
    :func:`split_state_from_jax`, whose ``like`` narrows the widened bf16
    tensors again."""
    from repro_torch.checkpoint import load_pytree
    tree = load_pytree(path, state_to_jax(like, model))
    return split_state_from_jax(tree, model, like=like)

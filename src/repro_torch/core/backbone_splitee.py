"""``BackboneSplitModel``: the production backbones behind the ``SplitModel``
protocol (counterpart of ``repro/core/backbone_splitee.py``).

The adapter partitions an ``init_backbone`` parameter tree into the paper's
split-learning shape, so the engines train the backbones through
:class:`repro_torch.api.TrainSession`:

  * cut layers are the config's ``exit_layers``, the segment boundaries: a
    client cut at ``l_i = exit_layers[b]`` holds the embedding, segments
    ``0..b`` (layers 1..l_i) and exit head ``b`` (the paper's client output
    layer); its server holds segments ``b+1..`` and the LM head;
  * server trainables are keyed ``seg{si}`` and ``head``: at the cut points
    a segment is a layer group, so Eq. (1) matches common trunks by key as
    the ``layer{l}`` keys of the ResNet and MLP adapters do;
  * clients that share a cut have nets of one structure and the same
    seeded values (paper §III-B), so the fused engine stacks them into
    lanes (``_StackMixin``) unchanged.

The task is sequence classification (``data.synthetic.
SyntheticSeqClsDataset``): ``x`` is ``(B, T)`` int32 tokens, labels are
class ids below the vocab size, and the exit head and the LM head are
scored at the last position, giving ``(B, V)`` logits.

MoE router load-balance aux losses ride the optional ``client_loss`` /
``server_loss`` hooks (``core.strategies``): each side's training loss is
its cross-entropy plus the aux total of its own segments (weighted by the
config's ``router_aux_weight`` inside ``models.moe.route``), so routers on
both sides of the cut stay balanced, while evaluation logits stay
aux-free.

Zamba2's globally shared attention block and, for cross-attending
configs (Whisper), the frontend projector are copied to each side: the
client family and the server family train their own copy (they start
equal), as the JAX adapter's ``_side_extras`` does.  Every server net then
holds those keys, so Eq. (1) averages the servers' copies as it averages
any key two server nets hold (``core.aggregation``), as in the JAX
package.  Each side projects the documented zeros stub of the encoder
states (``models/frontend.stub_enc``) through its own copy, so cross
attention adds exactly 0 on this path, as in the JAX package (ROADMAP.md
Queue 3).  VLM configs train token-only: the vision projector stays out of
the trainables.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.losses import softmax_cross_entropy
from repro_torch.core.splitee import _seeded, _StackMixin, own_copy
from repro_torch.device import resolve_device
from repro_torch.models import frontend as frontend_mod
from repro_torch.models import heads as heads_mod
from repro_torch.models.backbone import (add_aux, build_plan,
                                         init_backbone, segment_forward)
from repro_torch.models.common import embed
from repro_torch.tree import tree_map

def _shared(params) -> Dict[str, Any]:
    """Zamba2's shared block of ``params`` (the full tree or one side's
    trainables) under its key, or nothing: what ``segment_forward``
    reads."""
    return ({"shared_attn": params["shared_attn"]}
            if "shared_attn" in params else {})


@dataclass
class BackboneSplitModel(_StackMixin):
    """Split a ``configs/`` backbone at any of its ``exit_layers``.  The
    weights are drawn from a CPU generator seeded with ``seed`` and moved
    to ``device`` (default the CUDA card)."""

    cfg: ModelConfig
    seed: int = 0
    device: Any = None

    def __post_init__(self):
        if not self.cfg.exit_layers:
            raise ValueError(
                f"{self.cfg.name}: BackboneSplitModel needs exit_layers: "
                f"cut layers must sit at exit-head boundaries")
        self.device = resolve_device(self.device)
        self.plan = build_plan(self.cfg)
        self.full_params = tree_map(lambda t: t.to(self.device),
                                    init_backbone(_seeded(self.seed),
                                                  self.cfg))
        self._exits = tuple(sorted(self.cfg.exit_layers))
        self._boundary = {li: b for b, li in enumerate(self._exits)}

    @property
    def name(self) -> str:
        return self.cfg.name

    @property
    def num_layers(self) -> int:
        return self.cfg.num_layers

    @property
    def cut_layers(self) -> Tuple[int, ...]:
        """The valid cut layers (the sorted exit layers)."""
        return self._exits

    def _boundary_of(self, li: int) -> int:
        try:
            return self._boundary[li]
        except KeyError:
            raise ValueError(
                f"{self.cfg.name}: cut layer {li} is not an exit boundary; "
                f"valid cut layers are {self._exits}") from None

    # ------------------------------------------------------------ partitions
    def _side_extras(self) -> Dict[str, Any]:
        """What both sides hold a copy of: Zamba2's shared attention block
        and, for cross-attending configs, the encoder-state projector."""
        p = self.full_params
        extras = _shared(p)
        if self.cfg.cross_attention and "frontend" in p:
            extras["frontend"] = p["frontend"]
        return extras

    def make_client(self, li: int) -> Dict[str, Any]:
        b = self._boundary_of(li)
        p = self.full_params
        return own_copy({"trainable": {
            "embed": p["embed"],
            "segments": [p["segments"][si] for si in range(b + 1)],
            "out": p["exit_heads"][b], **self._side_extras()},
            "state": {}})

    def make_server(self, li: int) -> Dict[str, Any]:
        b = self._boundary_of(li)
        p = self.full_params
        trainable = {f"seg{si}": p["segments"][si]
                     for si in range(b + 1, len(self.plan))}
        trainable["head"] = p["head"]
        trainable.update(self._side_extras())
        return own_copy({"trainable": trainable, "state": {}})

    # --------------------------------------------------------------- forward
    def _positions(self, x: torch.Tensor) -> torch.Tensor:
        return torch.arange(x.shape[1], device=x.device)[None]

    def _enc_for(self, trainable, batch: int):
        """The stubbed encoder states (zeros, the documented frontend
        carve-out) projected through this side's own projector, for
        cross-attending configs; else None."""
        return frontend_mod.project_enc(
            trainable, frontend_mod.stub_enc(self.cfg, batch, self.device),
            self.cfg)

    def _client_run(self, trainable, x):
        """(h, last-position exit logits, aux total over the client's
        segments, ``None`` without a router)."""
        h = embed(trainable["embed"], x, self.cfg.vocab_size).to(self.cfg.dtype)
        positions = self._positions(h)
        enc = self._enc_for(trainable, h.shape[0])
        params = {"segments": trainable["segments"],
                  **_shared(trainable)}
        aux = None
        for si in range(len(trainable["segments"])):
            h, a = segment_forward(params, self.cfg, si, h, positions,
                                   enc=enc)
            aux = add_aux(aux, a)
        logits = heads_mod.exit_head(trainable["out"], h[:, -1], self.cfg)
        return h, logits, aux

    def _server_run(self, trainable, h, li: int):
        """(last-position head logits, aux total over the server's
        segments, ``None`` without a router)."""
        b = self._boundary_of(li)
        h = h.to(self.cfg.dtype)
        positions = self._positions(h)
        enc = self._enc_for(trainable, h.shape[0])
        aux = None
        for si in range(b + 1, len(self.plan)):
            h, a = segment_forward({"segments": {si: trainable[f"seg{si}"]},
                                    **_shared(trainable)},
                                   self.cfg, si, h, positions, enc=enc)
            aux = add_aux(aux, a)
        return heads_mod.lm_head(trainable["head"], h[:, -1], self.cfg), aux

    def client_forward(self, trainable, state, x, train: bool):
        h, logits, _ = self._client_run(trainable, x)
        return h, logits, state

    def server_forward(self, trainable, state, h, li: int, train: bool):
        logits, _ = self._server_run(trainable, h, li)
        return logits, state

    # ------------------------------------------------------- training losses
    def client_loss(self, trainable, state, x, y):
        """The ``core.strategies`` client-loss hook: the exit head's
        cross-entropy plus the client segments' router aux total."""
        h, logits, aux = self._client_run(trainable, x)
        return add_aux(softmax_cross_entropy(logits, y,
                                             vocab=self.cfg.vocab_size),
                       aux), (h, state)

    def server_loss(self, trainable, state, h, li: int, y):
        """The server-loss hook: the final head's cross-entropy plus the
        server segments' router aux total (as ``core.spmd.hetero_losses``
        adds ``aux_loss`` to the monolithic server loss)."""
        logits, aux = self._server_run(trainable, h, li)
        return add_aux(softmax_cross_entropy(logits, y,
                                             vocab=self.cfg.vocab_size),
                       aux), state

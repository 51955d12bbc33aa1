"""The client and server training steps every engine shares (counterpart
of ``repro/core/strategies.py``).

  * :func:`make_client_step` / :func:`make_server_step` — functions of
    ``(nets, batch, lr)`` closed over the model and optimizer config.  The
    reference engine (``repro_torch.api.reference_engine``) runs them one
    client at a time, as Alg. 1/2 do.
  * :class:`RoundMetrics` — the per-round metric record.
  * :func:`masked_update` — the participation gate of client populations.

Gradients never flow from server to client: ``h`` enters the server step
as data.  Gradients are ``torch.autograd.grad`` over the trainable leaves
with ``allow_unused=True``: a leaf the forward does not reach (the lower
layers of the Sequential strategy's shared server, for clients cut deeper)
gets ``None``, which Adam treats as a zero gradient, as JAX's zeros are:
its moments still decay and the leaf still moves.  The BatchNorm state of
the training forward comes out detached.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.config import OptimizerConfig
from repro_torch.core.losses import softmax_cross_entropy
from repro_torch.core.spmd import _Trainable
from repro_torch.optim import adam_update
from repro_torch.tree import tree_map


@dataclass
class RoundMetrics:
    round: int
    client_loss: float
    server_loss: float
    #: slots that contributed to this round's aggregation under a client
    #: population (-1 = fixed cohort, every client always participates)
    active_clients: int = -1
    #: assigned clients masked out of this round for exceeding their step
    #: budget or deadline (population sessions only)
    stragglers: int = 0


def lane_view(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A ``[k]`` lane mask shaped to broadcast over a leaf whose leading
    axis is the lane axis."""
    return mask.view(-1, *(1,) * (leaf.ndim - 1))


def masked_update(mask: torch.Tensor, new_tree, old_tree):
    """Participation-gated state update over cohort-stacked trees: lane j of
    each leaf takes the stepped value where ``mask[j] > 0`` (``mask`` a
    ``[k]`` device tensor of 0/1), else keeps the old one.  Out of place,
    fixed shapes, no host read.  Gating the update and not only the loss
    matters: a zeroed loss still decays Adam's moments and advances its
    step, which would move an inactive client's parameters."""
    return tree_map(lambda n, o: torch.where(lane_view(mask, n) > 0, n, o),
                    new_tree, old_tree)


def client_loss_fn(model) -> Callable:
    """``(trainable, state, x, y) -> (loss, (h, new_state))``: the
    adapter's ``client_loss`` hook where it has one (``BackboneSplitModel``
    adds its client segments' MoE router aux loss there), else the exit
    head's cross-entropy.  Evaluation never calls the hook: the aux loss
    regularises training only."""
    custom = getattr(model, "client_loss", None)
    if custom is not None:
        return custom

    def loss_fn(trainable, state, x, y):
        h, logits, new_state = model.client_forward(trainable, state, x,
                                                    train=True)
        return softmax_cross_entropy(logits, y), (h, new_state)

    return loss_fn


def server_loss_fn(model, li: int) -> Callable:
    """``(trainable, state, h, y) -> (loss, new_state)`` for a server cut
    at ``li``: the adapter's ``server_loss(trainable, state, h, li, y)``
    hook where it has one, else the final head's cross-entropy."""
    custom = getattr(model, "server_loss", None)
    if custom is not None:
        def hooked(trainable, state, h, y):
            return custom(trainable, state, h, li, y)
        return hooked

    def loss_fn(trainable, state, h, y):
        logits, new_state = model.server_forward(trainable, state, h, li,
                                                 train=True)
        return softmax_cross_entropy(logits, y), new_state

    return loss_fn


def _grads(loss: torch.Tensor, leaves):
    return torch.autograd.grad(loss, leaves, allow_unused=True)


def make_client_step(model, opt_cfg: OptimizerConfig) -> Callable:
    """(trainable, state, opt, x, y, lr) ->
    (trainable, state, opt, h, loss), Alg. 1/2 lines 6-11.  ``trainable``
    and the moments of ``opt`` are updated in place."""
    loss_fn = client_loss_fn(model)

    def step(trainable, state, opt, x, y, lr):
        with torch.enable_grad(), _Trainable(trainable) as leaves:
            loss, (h, new_state) = loss_fn(trainable, state, x, y)
            grads = _grads(loss, leaves)
        trainable, opt = adam_update(trainable, grads, opt, opt_cfg, lr)
        return trainable, new_state, opt, h.detach(), loss.detach()

    return step


def make_server_step(model, opt_cfg: OptimizerConfig, li: int) -> Callable:
    """(trainable, state, opt, h, y, lr) -> (trainable, state, opt, loss),
    Alg. 1/2 lines 12-16; ``h`` enters as data, so no gradient reaches the
    client."""
    loss_fn = server_loss_fn(model, li)

    def step(trainable, state, opt, h, y, lr):
        with torch.enable_grad(), _Trainable(trainable) as leaves:
            loss, new_state = loss_fn(trainable, state, h, y)
            grads = _grads(loss, leaves)
        trainable, opt = adam_update(trainable, grads, opt, opt_cfg, lr)
        return trainable, new_state, opt, loss.detach()

    return step

"""Adam (paper Table II), written by hand over parameter trees
(counterpart of ``repro/optim/adam.py``; no ``torch.optim``).

The arithmetic is the JAX package's: an optional global-norm clip with
``+1e-9``, bias-corrected ``(m/bc1)/(sqrt(v/bc2)+eps)``, weight decay added
to the *update* (AdamW-style), a per-leaf learning-rate scale, moments kept
in ``state_dtype`` (the update uses their fp32 values before that cast) and
parameters cast back to their own dtype.

Unlike the JAX function, :func:`adam_update` works in place: the
parameter and moment tensors it is given are updated and returned.  At the
published glm4-9b widths the fp32 moments alone are 38 GB, so a second copy
of parameters and moments would not fit on one card.

The update is elementwise, so one call on cohort-stacked leaves (a leading
lane axis, the fused engine's layout) steps every lane at once; only the
clip looks across elements, and ``lanes=True`` takes its norm per lane, as
JAX's ``vmap`` of the update does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.config import OptimizerConfig
from repro_torch.tree import tree_leaves, tree_map


@dataclass
class AdamState:
    step: int               # updates taken so far (a host integer)
    m: Any                  # tree like params
    v: Any


def adam_init(params: Any, cfg: OptimizerConfig) -> AdamState:
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype,  # noqa: E731
                                  device=p.device)
    return AdamState(step=0, m=tree_map(zeros, params),
                     v=tree_map(zeros, params))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32; ``None`` leaves
    (gradients that did not reach a parameter) count as zero."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
             for g in tree_leaves(tree) if g is not None]
    if not norms:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(norms))


def lane_norms(tree: Any) -> torch.Tensor:
    """:func:`global_norm` of each lane of a tree of stacked leaves
    (leading lane axis): shape (lanes,), fp32.  ``None`` leaves count as
    zero."""
    norms = [torch.linalg.vector_norm(g.reshape(g.shape[0], -1), dim=1,
                                      dtype=torch.float32)
             for g in tree_leaves(tree) if g is not None]
    return torch.linalg.vector_norm(torch.stack(norms), dim=0)


def _expand_prefix(prefix, tree):
    """``prefix`` (a tree whose leaves are scalars, or one scalar) spread
    over the leaves of ``tree``."""
    if isinstance(prefix, dict):
        return {k: _expand_prefix(prefix[k], v) for k, v in tree.items()}
    if isinstance(prefix, (list, tuple)):
        return [_expand_prefix(s, t) for s, t in zip(prefix, tree)]
    return tree_map(lambda _: prefix, tree)


@torch.no_grad()
def _update_leaf(p, g, m, v, *, lr, cfg: OptimizerConfig, bc1: float,
                 bc2: float, clip) -> None:
    b1, b2 = cfg.b1, cfg.b2
    m32 = m if m.dtype == torch.float32 else m.float()
    v32 = v if v.dtype == torch.float32 else v.float()
    m32.mul_(b1)
    v32.mul_(b2)
    gf = None
    if g is not None:               # an unreached leaf has a zero gradient
        gf = g.to(torch.float32, copy=True)
        if clip is not None:
            gf.mul_(clip if clip.ndim == 0
                    else clip.view(-1, *(1,) * (gf.ndim - 1)))
        m32.add_(gf, alpha=1 - b1)
        v32.addcmul_(gf, gf, value=1 - b2)
    denom = torch.div(v32, bc2, out=gf) if gf is not None else v32 / bc2
    denom.sqrt_().add_(cfg.eps)
    update = torch.div(m32, bc1).div_(denom)
    del denom, gf
    if cfg.weight_decay > 0:
        update.add_(p, alpha=cfg.weight_decay)
    p.copy_(update.mul_(-lr).add_(p))
    if m32 is not m:
        m.copy_(m32)
    if v32 is not v:
        v.copy_(v32)


def adam_update(params: Any, grads: Any, state: AdamState,
                cfg: OptimizerConfig, lr,
                lr_scale_tree: Optional[Any] = None, *, lanes: bool = False):
    """One Adam step, in place.  ``grads`` has params' structure (``None``
    leaves count as zero gradients); ``lr`` is a float or a 0-d tensor;
    ``lr_scale_tree`` (optional, params' structure or a prefix of it, with
    scalar leaves) multiplies the per-leaf learning rate.  ``lanes``: the
    leaves are cohort-stacked, and the clip norm is each lane's own
    (:func:`lane_norms`).  Returns ``(params, new_state)``: the same
    parameter and moment tensors, updated."""
    step = state.step + 1
    clip = None
    if cfg.grad_clip > 0:
        norm = lane_norms(grads) if lanes else global_norm(grads)
        clip = torch.clamp(cfg.grad_clip / (norm + 1e-9), max=1.0)
    bc1 = 1.0 - cfg.b1 ** step
    bc2 = 1.0 - cfg.b2 ** step
    scales = (tree_map(lambda _: None, params) if lr_scale_tree is None
              else _expand_prefix(lr_scale_tree, params))
    for p, g, m, v, s in zip(tree_leaves(params), tree_leaves(grads),
                             tree_leaves(state.m), tree_leaves(state.v),
                             tree_leaves(scales)):
        _update_leaf(p, g, m, v, lr=lr if s is None else lr * s, cfg=cfg,
                     bc1=bc1, bc2=bc2, clip=clip)
    return params, AdamState(step=step, m=state.m, v=state.v)

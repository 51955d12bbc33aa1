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
JAX's ``vmap`` of the update does.  Stacked lanes keep one step each, an
int32 ``[k]`` tensor on the device, since the lanes of a client population
step only when they take part.  Both paths read their bias corrections
from one fp32 table on the device (:func:`_correction_table`), the one-net
path at its host step and stacked lanes at each lane's step, and divide by
them as tensors, so a lane's update is bit for bit the one-net update of
its client on either device.  A ``mask`` leaves the parameters, moments
and step of a masked lane exactly as they were.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.config import OptimizerConfig
from repro_torch.kernels.sites import is_fake
from repro_torch.tree import tree_leaves, tree_map


@dataclass
class AdamState:
    step: Any               # updates taken so far: a host integer for one
    m: Any                  # net, an int32 [k] device tensor for stacked
    v: Any                  # lanes; m and v are trees like params


#: (beta, device) -> fp32 bias corrections indexed by step
_TABLES: dict = {}
#: longest bias-correction table (a beta whose correction never reaches
#: 1.0 in fp32 reads this step's for later ones)
_TABLE_CAP = 1 << 21


def _correction_table(beta: float, device) -> torch.Tensor:
    """``fp32(1 - beta ** t)`` for t = 0, 1, ... up to the first t > 0 at
    which it rounds to 1.0 (every later step's value), on ``device``."""
    dev = torch.device(device)
    key = (float(beta), dev.type, dev.index)
    if key not in _TABLES:
        bc = (1.0 - beta ** np.arange(_TABLE_CAP, dtype=np.float64)
              ).astype(np.float32)
        done = np.flatnonzero(bc[1:] == 1.0)
        table = torch.from_numpy(bc[:done[0] + 2] if done.size else bc)
        if dev.type == "cuda":      # pinned and non-blocking: no host sync
            table = table.pin_memory()
        table = table.to(dev, non_blocking=True)
        if is_fake(table):          # under a dry run's fake mode: not kept
            return table
        _TABLES[key] = table
    return _TABLES[key]


def _corrections(cfg: OptimizerConfig, step, device):
    """The bias corrections (b1's, b2's) of the update numbered ``step``: a
    host integer (0-d tensors) or an int tensor of lanes (``[k]``)."""
    out = []
    for beta in (cfg.b1, cfg.b2):
        table = _correction_table(beta, device)
        last = len(table) - 1
        out.append(table[step.clamp(max=last).long()]
                   if isinstance(step, torch.Tensor)
                   else table[min(int(step), last)])
    return out


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


def lane_norms(tree: Any, split=None, reduce=None) -> torch.Tensor:
    """:func:`global_norm` of each lane of a tree of stacked leaves
    (leading lane axis): shape (lanes,), fp32.  ``None`` leaves count as
    zero.  ``split`` (one entry per leaf) marks leaves held as this rank's
    chunk of a tensor split over ranks: a true entry (the axes it is
    split over) has the squares of its leaves summed over those ranks by
    ``reduce(tensors, entry)`` (an in-place all-reduce of a list of
    tensors), one call per distinct entry in order of first appearance;
    the other leaves, whole and equal on every rank, are counted once."""
    leaves = list(tree_leaves(tree))
    flags = [False] * len(leaves) if split is None else list(split)

    def squares(want):
        sq = [torch.linalg.vector_norm(g.reshape(g.shape[0], -1), dim=1,
                                       dtype=torch.float32).square()
              for g, f in zip(leaves, flags)
              if g is not None and (f == want if want else not f)]
        return torch.stack(sq).sum(0) if sq else None

    if not any(flags):
        norms = [torch.linalg.vector_norm(g.reshape(g.shape[0], -1), dim=1,
                                          dtype=torch.float32)
                 for g in leaves if g is not None]
        return torch.linalg.vector_norm(torch.stack(norms), dim=0)
    total = squares(False)
    for key in dict.fromkeys(f for f in flags if f):
        parts = squares(key)
        if parts is None:                   # None on every rank alike
            continue
        reduce([parts], key)
        total = parts if total is None else parts + total
    return total.sqrt()


def _expand_prefix(prefix, tree):
    """``prefix`` (a tree whose leaves are scalars, or one scalar) spread
    over the leaves of ``tree``."""
    if isinstance(prefix, dict):
        return {k: _expand_prefix(prefix[k], v) for k, v in tree.items()}
    if isinstance(prefix, (list, tuple)):
        return [_expand_prefix(s, t) for s, t in zip(prefix, tree)]
    return tree_map(lambda _: prefix, tree)


def _per_lane(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A 0-d or ``[k]`` lane tensor shaped to broadcast over ``x``."""
    return t if t.ndim == 0 else t.view(-1, *(1,) * (x.ndim - 1))


@torch.no_grad()
def _update_leaf(p, g, m, v, *, lr, cfg: OptimizerConfig, bc1, bc2, clip,
                 keep=None) -> None:
    """One leaf's update in place; ``keep`` (a ``[k]`` bool lane tensor):
    lanes where it is False keep p, m and v.  Under ``keep`` the moments
    are formed out of place and each of p, m, v is written once, by a
    ``where`` over its old values."""
    b1, b2 = cfg.b1, cfg.b2

    def scaled(t, beta):            # t * beta in fp32, fresh when masked
        if t.dtype != torch.float32:
            return t.float().mul_(beta)
        return t.mul_(beta) if keep is None else t.mul(beta)

    m32, v32 = scaled(m, b1), scaled(v, b2)
    gf = None
    if g is not None:               # an unreached leaf has a zero gradient
        gf = g.to(torch.float32, copy=True)
        if clip is not None:
            gf.mul_(_per_lane(clip, gf))
        m32.add_(gf, alpha=1 - b1)
        v32.addcmul_(gf, gf, value=1 - b2)
    denom = torch.div(v32, _per_lane(bc2, v32), out=gf)
    denom.sqrt_().add_(cfg.eps)
    update = torch.div(m32, _per_lane(bc1, m32)).div_(denom)
    del denom, gf
    if cfg.weight_decay > 0:
        update.add_(p, alpha=cfg.weight_decay)
    new_p = update.mul_(-lr).add_(p)
    if keep is None:
        p.copy_(new_p)
        for t, t32 in ((m, m32), (v, v32)):
            if t32 is not t:
                t.copy_(t32)
        return
    for t, new in ((p, new_p), (m, m32), (v, v32)):
        torch.where(_per_lane(keep, t), new.to(t.dtype), t, out=t)


def adam_update(params: Any, grads: Any, state: AdamState,
                cfg: OptimizerConfig, lr,
                lr_scale_tree: Optional[Any] = None, *, lanes: bool = False,
                mask: Optional[torch.Tensor] = None,
                norms: Optional[torch.Tensor] = None):
    """One Adam step, in place.  ``grads`` has params' structure (``None``
    leaves count as zero gradients); ``lr`` is a float or a 0-d tensor;
    ``lr_scale_tree`` (optional, params' structure or a prefix of it, with
    scalar leaves) multiplies the per-leaf learning rate.  ``lanes``: the
    leaves are cohort-stacked, the step is one per lane (an int32 ``[k]``
    tensor; a host integer is taken for every lane) and the clip norm is
    each lane's own (:func:`lane_norms`).  ``mask`` (with ``lanes``, a
    ``[k]`` 0/1 device tensor): lanes where it is 0 keep their parameters,
    moments and step unchanged.  ``norms``: the clip's gradient norms
    (per lane with ``lanes``), given when ``params``, ``grads`` and the
    moments are shards of the whole tensors (the spmd engine's sharded
    update), whose own norms would be partial.  Returns ``(params,
    new_state)``: the same parameter and moment tensors, updated."""
    if mask is not None and not lanes:
        raise ValueError("adam_update: mask= needs lanes=True")
    clip = None
    if cfg.grad_clip > 0:
        norm = norms
        if norm is None:
            norm = lane_norms(grads) if lanes else global_norm(grads)
        clip = torch.clamp(cfg.grad_clip / (norm + 1e-9), max=1.0)
    first = next(iter(tree_leaves(params)))
    keep = None
    if lanes:
        steps = state.step
        if not isinstance(steps, torch.Tensor):
            steps = torch.full((first.shape[0],), steps, dtype=torch.int32,
                               device=first.device)
        step = steps + 1
        bc1, bc2 = _corrections(cfg, step, first.device)
        if mask is not None:
            keep = mask > 0
            step = torch.where(keep, step, steps)
    else:
        step = state.step + 1
        bc1, bc2 = _corrections(cfg, step, first.device)
    scales = (tree_map(lambda _: None, params) if lr_scale_tree is None
              else _expand_prefix(lr_scale_tree, params))
    for p, g, m, v, s in zip(tree_leaves(params), tree_leaves(grads),
                             tree_leaves(state.m), tree_leaves(state.v),
                             tree_leaves(scales)):
        _update_leaf(p, g, m, v, lr=lr if s is None else lr * s, cfg=cfg,
                     bc1=bc1, bc2=bc2, clip=clip, keep=keep)
    return params, AdamState(step=step, m=state.m, v=state.v)

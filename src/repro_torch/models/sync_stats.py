"""Batch statistics over a batch split across ranks.

Under the spmd engine's data split each rank holds a slice of every
lane's batch.  BatchNorm's batch statistics are means over the whole
batch, so :func:`batch_mean_var` sums each lane's partial sums over the
ranks of the batch group (``synced_batch_stats``) before dividing, and
the forward, its gradient and the running statistics all equal the
one-rank, whole-batch values.  Outside the context it is
``x.mean`` / ``x.var(unbiased=False)``, as before.  The MoE router reads
the same group (:func:`batch_group`): its expert loads and aux-loss
statistics are taken over the whole batch (``models/moe.py``).

The sum is :class:`GroupSumFn`, an autograd Function whose backward sums
the cotangents over the same group (each rank's partial sum reaches every
rank's loss) and whose ``vmap`` rule folds the lanes into one collective,
so it runs inside the fused engine's ``torch.func.vmap`` over lanes.
Each sum is recorded as an all_reduce (``kernels/sites.collective``); a
context with no process group (the dry run's, on fake tensors) records
and sends nothing.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Sequence

import torch

from repro_torch.kernels import sites

_state = threading.local()


@contextlib.contextmanager
def synced_batch_stats(group, size: int, index: int):
    """Sum batch statistics over process group ``group`` (``size`` ranks,
    each holding an equal slice of the batch, this rank the ``index``-th
    slice) in this thread."""
    prev = getattr(_state, "group", None)
    _state.group = (group, size, index)
    try:
        yield
    finally:
        _state.group = prev


def batch_group():
    """``(group, size, index)`` of the active :func:`synced_batch_stats`
    context, else ``None``."""
    return getattr(_state, "group", None)


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    out = x.contiguous().clone()
    sites.collective("all_reduce", out.numel() * out.element_size())
    if group is not None and not sites.is_fake(out):
        dist.all_reduce(out, group=group)
    return out


class GroupSumFn(torch.autograd.Function):
    """``x`` summed over a process group; the backward sums the cotangent
    over the same group."""

    @staticmethod
    def forward(x, group):
        return _summed(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _summed(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        if in_dims[0] is None:
            return GroupSumFn.apply(x, group), None
        return GroupSumFn.apply(x.movedim(in_dims[0], 0), group), 0


def batch_mean_var(x: torch.Tensor, dims: Sequence[int]):
    """Mean and biased variance of ``x`` over ``dims`` (two passes), over
    the whole batch of the active :func:`synced_batch_stats` group."""
    synced = batch_group()
    if synced is None:
        return x.mean(dim=tuple(dims)), x.var(dim=tuple(dims), unbiased=False)
    group, size, _ = synced
    n = math.prod(x.shape[d] for d in dims) * size
    mean = GroupSumFn.apply(x.sum(dim=tuple(dims)), group) / n
    shape = [1 if d in dims else s for d, s in enumerate(x.shape)]
    dev = x - mean.reshape(shape)
    var = GroupSumFn.apply((dev * dev).sum(dim=tuple(dims)), group) / n
    return mean, var


def gather_over_batch(x: torch.Tensor) -> torch.Tensor:
    """``x`` of every rank of the active batch group, stacked in slice
    order: ``(size, *x.shape)``.  Each rank places its ``x`` at its index
    of a zero stack and the stacks are summed (:class:`GroupSumFn`), so
    it runs under ``vmap`` as the sums do."""
    group, size, index = batch_group()
    at = (torch.arange(size, device=x.device) == index).to(x.dtype)
    return GroupSumFn.apply(at.reshape((size,) + (1,) * x.ndim) * x, group)

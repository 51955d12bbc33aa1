"""Cross-layer aggregation, paper Eq. (1) (counterpart of
``repro/core/aggregation.py``).

For every layer ``l`` the participation set ``C_l = {i | l_i < l}`` (the
clients whose server net holds layer l) averages that layer's parameters,
and each member takes the mean.  Nets are dicts keyed by layer name
(``layer4``, ``head``, ...), so common layers are found by key across
heterogeneous server nets.

``cross_layer_aggregate`` is the literal loop the reference engine runs;
``stacked_cross_layer_aggregate`` is the same mean over cohort-stacked
server nets, the fused engine's form, and
``masked_stacked_cross_layer_aggregate`` its form under a client
population's participation masks.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


def _mean_trees(trees: Sequence[Any]) -> Any:
    """Leaf-wise mean, summed in fp32 in the order given."""
    n = float(len(trees))

    def mean(*xs):
        total = xs[0].float()
        for x in xs[1:]:
            total = total + x.float()
        return total.to(xs[0].dtype) / n

    return tree_map(mean, *trees)


def cross_layer_aggregate(server_models: Sequence[Dict[str, Any]],
                          split_layers: Sequence[int],
                          extra_shared_keys: Sequence[str] = ("head",),
                          ) -> List[Dict[str, Any]]:
    """Aggregate the client-specific server nets (Alg. 2 lines 20-30).

    ``server_models[i]`` holds the keys of client i's server net:
    ``layer{l}`` for l in (l_i, L] plus ``extra_shared_keys``, which
    every server net has.  Returns new dicts in which every key held by
    two or more nets is replaced by their mean; each member gets tensors
    of its own (the port's Adam updates in place), and the inputs are not
    changed."""
    assert len(server_models) == len(split_layers)
    out = [dict(m) for m in server_models]
    all_keys = set()
    for m in server_models:
        all_keys |= set(m.keys())
    for key in sorted(all_keys):
        members = [i for i, m in enumerate(server_models) if key in m]
        if len(members) <= 1:
            continue
        mean = _mean_trees([server_models[i][key] for i in members])
        for j, i in enumerate(members):
            out[i][key] = mean if j == 0 else tree_map(torch.clone, mean)
    return out


def stacked_cross_layer_aggregate(stacked: Dict[int, Dict[str, Any]],
                                  lanes: Dict[int, Sequence[int]]
                                  ) -> Dict[int, Dict[str, Any]]:
    """Eq. (1) over cohort-stacked server nets, in place.

    ``stacked[li]`` is the server net of the cohort cut at ``li``, keyed by
    layer name, every leaf with a leading lane axis; ``lanes[li]`` names
    the client behind each lane.  For each key the mean is taken over
    every lane of every cohort holding it (the participation set C_l of
    :func:`cross_layer_aggregate`), summed in fp32 lane by lane in client
    order as ``_mean_trees`` sums, and copied into every member lane.  Keys
    held by one client are left alone.  Nothing is allocated per member:
    the mean is broadcast into the stacked leaves with ``copy_``.  Returns
    ``stacked``."""
    keys = set()
    for m in stacked.values():
        keys |= set(m)
    for key in sorted(keys):
        members = [li for li in sorted(stacked) if key in stacked[li]]
        order = sorted((i, li, j) for li in members
                       for j, i in enumerate(lanes[li]))
        if len(order) <= 1:
            continue
        trees = {li: list(tree_leaves(stacked[li][key])) for li in members}
        _, li0, j0 = order[0]
        total = [x[j0].to(torch.float32, copy=True) for x in trees[li0]]
        for _, li, j in order[1:]:
            torch._foreach_add_(total, [x[j].float() for x in trees[li]])
        n = float(len(order))
        mean = [t.to(x.dtype) / n for t, x in zip(total, trees[li0])]
        for li in members:
            for x, m in zip(trees[li], mean):
                x.copy_(m.expand_as(x))
    return stacked


def _mean_over(total: torch.Tensor, dtype, den: torch.Tensor
               ) -> torch.Tensor:
    """``total`` (fp32) cast to ``dtype`` and divided by the device count
    ``den``, rounded as :func:`stacked_cross_layer_aggregate` divides by a
    host count: in ``dtype``'s compute type (fp32 for bf16 and fp16), on
    the CPU as a division, on the card as a multiplication by the count's
    reciprocal taken in double (how CUDA divides by a host number), cast
    to ``dtype`` after."""
    t = total.to(dtype)
    if dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    if t.is_cuda:
        q = t * den.double().reciprocal().to(t.dtype)
    else:
        q = t / den.to(t.dtype)
    return q.to(dtype)


def masked_stacked_cross_layer_aggregate(stacked: Dict[int, Dict[str, Any]],
                                         masks: Dict[int, torch.Tensor],
                                         lanes: Dict[int, Sequence[int]]
                                         ) -> Dict[int, Dict[str, Any]]:
    """:func:`stacked_cross_layer_aggregate` restricted to a participation
    set, in place (client populations).

    ``masks[li]`` is the cohort's ``[k]`` 0/1 lane mask for the
    aggregation boundary's round, a device tensor.  For each key the mean
    runs over the active lanes only (masked lanes are left out of the sum
    and of the count) and is copied into every member lane, active or
    not: a client that rejoins after churn resumes from the aggregate.  A
    key with no active member keeps its values.  With every mask 1 the
    result is bit for bit :func:`stacked_cross_layer_aggregate`'s
    (``x * 1.0`` is exact, the lanes are summed in the same order and the
    count divides as the host count does).  No host read: the count stays
    on the device."""
    keys = set()
    for m in stacked.values():
        keys |= set(m)
    for key in sorted(keys):
        members = [li for li in sorted(stacked) if key in stacked[li]]
        order = sorted((i, li, j) for li in members
                       for j, i in enumerate(lanes[li]))
        if len(order) <= 1:
            continue
        trees = {li: list(tree_leaves(stacked[li][key])) for li in members}
        _, li0, j0 = order[0]
        w0 = masks[li0][j0]
        total = [x[j0].float() * w0 for x in trees[li0]]
        for _, li, j in order[1:]:
            w = masks[li][j]
            torch._foreach_add_(total, [x[j].float() * w for x in trees[li]])
        den = sum(masks[li].float().sum() for li in members)
        active = den > 0
        den = den.clamp(min=1.0)
        mean = [_mean_over(t, x.dtype, den) for t, x in zip(total, trees[li0])]
        for li in members:
            for x, m in zip(trees[li], mean):
                x.copy_(torch.where(active, m.expand_as(x), x))
    return stacked


def participation_counts(split_layers: Sequence[int], num_layers: int
                         ) -> Tuple[List[int], List[int]]:
    """For each 0-indexed layer l: (#clients with l client-side,
    #clients with l server-side).  Client i holds layers [0, l_i)."""
    n_client = [sum(1 for s in split_layers if l < s)
                for l in range(num_layers)]
    n_server = [len(split_layers) - c for c in n_client]
    return n_client, n_server


def partial_cross_layer_aggregate(stacked: Dict[int, Dict[str, Any]],
                                  lanes: Dict[int, Sequence[int]],
                                  counts: Dict[int, int],
                                  owned: Dict[int, bool], reduce,
                                  masks: Optional[Dict[int, torch.Tensor]]
                                  = None) -> Dict[int, Dict[str, Any]]:
    """Eq. (1) over cohort-stacked server nets whose lanes are spread over
    ranks (the spmd engine), in place.

    ``stacked[li]`` holds this rank's lanes of cohort ``li`` (leaves
    ``[k_local, ...]``, or their shards: every rank that shares the lanes
    group holds the same slice), ``lanes[li]`` the client behind each local
    lane and ``counts[li]`` the cohort's whole lane count.  Each rank sums
    its ``owned`` cohorts' lanes per key in fp32, in client order (a cohort
    replicated over the lanes axis is owned by one rank of it), and
    ``reduce(tensors)`` sums the partial sums over the lanes group in place,
    all keys in one call.  The mean is then copied into every local member
    lane.  ``masks`` (population runs): each local lane's 0/1 weight, the
    masked counts reduced beside the sums, as in
    :func:`masked_stacked_cross_layer_aggregate`.  Returns ``stacked``."""
    keys = set()
    for m in stacked.values():
        keys |= set(m)
    plans = []
    partial: List[torch.Tensor] = []
    for key in sorted(keys):
        members = [li for li in sorted(stacked) if key in stacked[li]]
        if sum(counts[li] for li in members) <= 1:
            continue
        trees = {li: list(tree_leaves(stacked[li][key])) for li in members}
        ref = trees[members[0]]
        total = [torch.zeros(x.shape[1:], dtype=torch.float32,
                             device=x.device) for x in ref]
        order = sorted((i, li, j) for li in members if owned[li]
                       for j, i in enumerate(lanes[li]))
        for _, li, j in order:
            xs = [x[j].float() for x in trees[li]]
            if masks is not None:
                xs = [x * masks[li][j] for x in xs]
            torch._foreach_add_(total, xs)
        den = None
        if masks is not None:
            den = sum((masks[li].float().sum() if owned[li]
                       else masks[li].new_zeros((), dtype=torch.float32))
                      for li in members).reshape(1)
            partial.append(den)
        partial.extend(total)
        plans.append((members, trees, total, den,
                      float(sum(counts[li] for li in members))))
    if partial:
        reduce(partial)
    for members, trees, total, den, n in plans:
        ref = trees[members[0]]
        if den is None:
            mean = [t.to(x.dtype) / n for t, x in zip(total, ref)]
            for li in members:
                for x, m in zip(trees[li], mean):
                    x.copy_(m.expand_as(x))
            continue
        active = den[0] > 0
        d = den[0].clamp(min=1.0)
        mean = [_mean_over(t, x.dtype, d) for t, x in zip(total, ref)]
        for li in members:
            for x, m in zip(trees[li], mean):
                x.copy_(torch.where(active, m.expand_as(x), x))
    return stacked

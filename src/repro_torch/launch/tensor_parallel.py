"""Tensor-parallel compute over a mesh's ``"model"`` axis: the Megatron
operators, the products that use them, and the vocab-parallel heads,
embedding and cross entropy.

The JAX package gives XLA's partitioner parameters placed by
``launch/shardings.py`` and lets it split each product's FLOPs over
``"model"``.  The port does it explicitly.  A rank holds its chunk of a
covered weight (``shardings.tp_roles``: ``column`` splits an output dim,
``row`` the contracting dim) and multiplies with it; activations are
whole on every rank of the model group, or split along their last dim
into the ranks' contiguous chunks.  Four autograd Functions move between
the two (each the identity on a group of one rank):

  * :class:`CopyIn`: whole -> whole, identity forward, all-reduce backward
    (a whole tensor entering rank-specific work);
  * :class:`ReduceOut`: partial -> whole, all-reduce forward, identity
    backward (a row-parallel product's output);
  * :class:`GatherOut`: split -> whole along a dim, all-gather forward,
    keep-own-slice backward;
  * :class:`ScatterIn`: whole -> split along a dim, keep-own-slice
    forward, all-gather backward.

With these, every whole tensor is the same on every rank of the group
and so is its gradient: the gradient of a replicated or gathered leaf is
the whole gradient, and that of a covered leaf is its chunk of it.  Each
Function has a ``torch.func.vmap`` rule (the fused and spmd engines run
the forward under ``vmap`` over lanes, ``models/sync_stats.GroupSumFn``'s
pattern).

Expert parallelism over the batch ranks: an :class:`ExpertGroup` of the
ranks along ``"data"`` keeps each expert stack split over them, rank i
the i-th contiguous chunk of the experts.  Each rank routes its own
rows; :func:`dispatch` sends each kept entry's row to the rank that owns
its expert, which writes it at the entry's slot of its (E/D, C, d)
buffer -- a train step's global slot of its one group, or, serving, the
slot of the sender's own group among every rank's
(:attr:`ExpertGroup.groups`) -- and :func:`collect` brings the expert
outputs back: one ``all_to_all`` each way, its transpose the backward
(:class:`Dispatch`, :class:`Collect`, both with ``vmap`` rules that fold
the lanes into one exchange).

The group is a :class:`ModelGroup` made active by :func:`model_parallel`
in the calling thread; model code asks :func:`active`.  Outside the
context (one rank, or a model axis of size 1) the model code runs exactly
as before.  A group with no process group (``ModelGroup(None, P, i)``)
only counts: on the dry run's fake tensors each collective is recorded
(``kernels/sites.collective``, with the bytes of ``launch/meshcomm``'s
plans: an all_gather the bytes this rank receives, an all_reduce its
buffer's) and nothing is sent.  Real groups record the same bytes, and
:attr:`ModelGroup.bytes` keeps them by kind.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import sites

_state = threading.local()


@dataclass
class ModelGroup:
    """The ranks of one ``"model"`` group: ``group`` the process group
    (``None``: count only), ``size`` ranks, this rank the ``index``-th
    (its chunk of every split dim).  ``bytes`` sums the collectives run
    on it by kind.  ``expert_blocks``: how many blocks of experts a
    grid-placed expert stack holds on this rank after its gather over
    the data axes (``shardings.Role``, :func:`expert_ids`)."""
    group: object
    size: int
    index: int
    bytes: Dict[str, float] = field(default_factory=lambda: {
        "all_gather": 0.0, "all_reduce": 0.0})
    expert_blocks: int = 1

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes.values())


@dataclass
class ExpertGroup:
    """The ranks over which the expert stacks are split (the mesh's
    ``"data"`` axis, the ranks sharing this rank's other coordinates):
    ``group`` the process group (``None``: count only), ``size`` ranks,
    this rank the ``index``-th, holding the ``index``-th chunk of each
    stack's experts (in the grid, model rank m holds chunk ``index * P +
    m``), ``experts`` of them a stack (``shardings.kept_experts``: the
    roles decide).  ``bytes`` sums the exchanges run on it: the rows of
    this rank's own entries that cross to another rank, out in a dispatch
    and back in a collect, with the slot indices and counts that travel
    along.

    ``groups``: ``None`` in a train step, whose batch is one routing group
    spread over the ranks; serving, ``(first, total)`` -- each rank routes
    its own groups whole (its slots, or the request it prefills), and its
    j-th group is group ``first + j`` of ``total`` in every owner's
    dispatch buffer (:func:`routing_groups` sets it)."""
    group: object
    size: int
    index: int
    experts: int
    bytes: Dict[str, float] = field(default_factory=lambda: {
        "all_to_all": 0.0})
    groups: Optional[Tuple[int, int]] = None

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes.values())


@contextlib.contextmanager
def model_parallel(group: Optional[ModelGroup]):
    """Run the products of this thread's model code over ``group`` (no
    change for ``None`` or a group of one rank)."""
    prev = getattr(_state, "group", None)
    _state.group = group
    try:
        yield group
    finally:
        _state.group = prev


def active() -> Optional[ModelGroup]:
    """The active :class:`ModelGroup` of more than one rank, else None."""
    g = getattr(_state, "group", None)
    return g if g is not None and g.size > 1 else None


@contextlib.contextmanager
def expert_parallel(group: Optional[ExpertGroup]):
    """Run this thread's MoE blocks with their experts split over
    ``group`` (no change for ``None``)."""
    prev = getattr(_state, "experts", None)
    _state.experts = group
    try:
        yield group
    finally:
        _state.experts = prev


@contextlib.contextmanager
def routing_groups(group: Optional[ExpertGroup], first: int, total: int):
    """Serving: this rank's routing groups are groups ``first`` .. of
    ``total`` over ``group``'s ranks while the block runs (no change for
    ``None``)."""
    if group is None:
        yield group
        return
    prev = group.groups
    group.groups = (first, total)
    try:
        yield group
    finally:
        group.groups = prev


def active_experts() -> Optional[ExpertGroup]:
    """The active :class:`ExpertGroup` of more than one rank, else
    None."""
    g = getattr(_state, "experts", None)
    return g if g is not None and g.size > 1 else None


# ---------------------------------------------------------------------------
# the collectives (module functions: the planted faults of ``parity.py``
# replace them)
# ---------------------------------------------------------------------------


def _record(g: ModelGroup, kind: str, nbytes: float) -> None:
    g.bytes[kind] += nbytes
    sites.collective(kind, nbytes)


def _sends(g: ModelGroup, t: torch.Tensor) -> bool:
    return g.group is not None and not sites.is_fake(t)


def all_reduce(x: torch.Tensor, g: ModelGroup) -> torch.Tensor:
    """``x`` summed over the group, a new tensor."""
    import torch.distributed as dist
    out = x.contiguous().clone()
    _record(g, "all_reduce", out.numel() * out.element_size())
    if _sends(g, out):
        dist.all_reduce(out, group=g.group)
    return out


def all_gather(x: torch.Tensor, g: ModelGroup, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    import torch.distributed as dist
    flat = x.contiguous()
    _record(g, "all_gather",
            flat.numel() * flat.element_size() * (g.size - 1))
    if not _sends(g, flat):
        return torch.cat([flat] * g.size, dim=dim)
    parts = [torch.empty_like(flat) for _ in range(g.size)]
    dist.all_gather(parts, flat, group=g.group)
    return torch.cat(parts, dim=dim)


def own_slice(x: torch.Tensor, g: ModelGroup, dim: int) -> torch.Tensor:
    """This rank's contiguous chunk of ``x`` along ``dim``."""
    n = x.shape[dim] // g.size
    return x.narrow(dim, g.index * n, n)


# ---------------------------------------------------------------------------
# the four operators
# ---------------------------------------------------------------------------


def _lanes_first(x, in_dim):
    return x if in_dim is None else x.movedim(in_dim, 0)


class CopyIn(torch.autograd.Function):
    """Identity forward; the cotangent summed over the group."""

    @staticmethod
    def forward(x, g):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.g = inputs[1]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        return all_reduce(dy, ctx.g), None

    @staticmethod
    def vmap(info, in_dims, x, g):
        if in_dims[0] is None:
            return CopyIn.apply(x, g), None
        return CopyIn.apply(x.movedim(in_dims[0], 0), g), 0


class ReduceOut(torch.autograd.Function):
    """The sum over the group forward; identity backward."""

    @staticmethod
    def forward(x, g):
        return all_reduce(x, g)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        return dy, None

    @staticmethod
    def vmap(info, in_dims, x, g):
        if in_dims[0] is None:
            return ReduceOut.apply(x, g), None
        return ReduceOut.apply(x.movedim(in_dims[0], 0), g), 0


class GatherOut(torch.autograd.Function):
    """The ranks' chunks along ``dim`` (negative) concatenated forward;
    this rank's slice of the cotangent backward."""

    @staticmethod
    def forward(x, g, dim):
        return all_gather(x, g, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.g, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        return own_slice(dy, ctx.g, ctx.dim).contiguous(), None, None

    @staticmethod
    def vmap(info, in_dims, x, g, dim):
        if in_dims[0] is None:
            return GatherOut.apply(x, g, dim), None
        return GatherOut.apply(x.movedim(in_dims[0], 0), g, dim), 0


class ScatterIn(torch.autograd.Function):
    """This rank's chunk along ``dim`` (negative) forward; the ranks'
    cotangents concatenated backward."""

    @staticmethod
    def forward(x, g, dim):
        return own_slice(x, g, dim).contiguous()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.g, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        return all_gather(dy, ctx.g, ctx.dim), None, None

    @staticmethod
    def vmap(info, in_dims, x, g, dim):
        if in_dims[0] is None:
            return ScatterIn.apply(x, g, dim), None
        return ScatterIn.apply(x.movedim(in_dims[0], 0), g, dim), 0


def _neg(dim: int, x: torch.Tensor) -> int:
    return dim - x.dim() if dim >= 0 else dim


def copy_in(x, g):
    return CopyIn.apply(x, g)


def reduce_out(x, g):
    return ReduceOut.apply(x, g)


def gather_out(x, g, dim: int = -1):
    return GatherOut.apply(x, g, _neg(dim, x))


def scatter_in(x, g, dim: int = -1):
    return ScatterIn.apply(x, g, _neg(dim, x))


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, w: torch.Tensor, k: int, n: int,
           split_in: bool = False) -> Tuple[torch.Tensor, bool]:
    """``x @ w`` for a weight of whole shape (..., k, n) (leading dims
    batched: an expert stack) held as this rank's chunk -- rows
    (``row``), columns (``column``) or whole -- with ``x`` (..., k)
    whole, or (..., k / P) this rank's chunk when ``split_in``.  Returns
    ``(y, split)``: ``y`` whole, or this rank's chunk of its n columns
    when ``split``.  A row-parallel product ends in one all-reduce; a
    column-parallel one leaves its output split.  Without an active group
    this is ``x @ w``."""
    g = active()
    if g is None:
        return x @ w, False
    if w.shape[-2] != k:                                  # row
        if not split_in:
            x = scatter_in(x, g)
        return reduce_out(x @ w, g), False
    if split_in:
        x = gather_out(x, g)
    if w.shape[-1] != n:                                  # column
        return copy_in(x, g) @ w, True
    return x @ w, False


def whole(x: torch.Tensor, split: bool, dim: int = -1) -> torch.Tensor:
    """``x`` whole along ``dim``: gathered where it is split."""
    return gather_out(x, active(), dim) if split else x


def local(b: torch.Tensor, n_local: int, dim: int = -1) -> torch.Tensor:
    """A leaf ``b`` held whole or as this rank's chunk along ``dim``, as
    this rank's chunk of ``n_local`` entries (a bias beside a
    column-parallel product)."""
    if b.shape[dim] == n_local:
        return b
    return scatter_in(b, active(), dim)


def sum_over_group(x: torch.Tensor, g: ModelGroup) -> torch.Tensor:
    """``x`` (each rank's partial sum, e.g. of a norm's squares over its
    chunk of a split dim) summed over the group, where every rank goes on
    with the sum for its own chunk: one all-reduce forward and one
    backward (:class:`ReduceOut` then :class:`CopyIn`)."""
    return copy_in(reduce_out(x, g), g)


def expert_ids(num_experts: int, n_local: int) -> List[int]:
    """The expert ids of this rank's ``n_local`` experts of a stack placed
    over the grid (``shardings.Role`` ``"expert"``): chunk ``b * P + i``
    of each of the ``expert_blocks`` blocks, in the order the gather over
    the data axes lays them out."""
    g = active()
    D, P = g.expert_blocks, g.size
    n = num_experts // (D * P)
    if n * D * P != num_experts or n * D != n_local:
        raise ValueError(f"{n_local} experts a rank do not split "
                         f"{num_experts} over {D} x {P} chunks")
    return [(b * P + g.index) * n + j for b in range(D) for j in range(n)]


# ---------------------------------------------------------------------------
# expert parallelism: the dispatch and combine as an exchange
# ---------------------------------------------------------------------------


class ExchangePlan:
    """What a :func:`dispatch` learnt for its :func:`collect`: ``order``
    (the flat entries this rank sent, in sending order), ``sent`` (rows
    sent to each rank), ``slots`` (the flat buffer slots of the rows
    received, in receiving order) and ``received`` (rows from each
    rank)."""

    __slots__ = ("order", "sent", "slots", "received")


def _a2a(rows: torch.Tensor, received: List[int], sent: List[int],
         g: ExpertGroup) -> torch.Tensor:
    import torch.distributed as dist
    out = rows.new_empty((sum(received),) + tuple(rows.shape[1:]))
    dist.all_to_all_single(out, rows.contiguous(), received, sent,
                           group=g.group)
    return out


def _crossing(counts: List[int], g: ExpertGroup) -> int:
    return sum(counts) - counts[g.index]


def _counting(x: torch.Tensor, g: ExpertGroup) -> bool:
    return g.group is None or sites.is_fake(x)


def _record_exchange(g: ExpertGroup, nbytes: float) -> None:
    g.bytes["all_to_all"] += nbytes
    sites.collective("all_to_all", nbytes)


def _dispatch(x: torch.Tensor, dest: torch.Tensor, slot: torch.Tensor,
              n_slots: int, g: ExpertGroup, plan: ExchangePlan
              ) -> torch.Tensor:
    """Entries (G, S, d) -> the owners' buffers (G, n_slots, d): each
    entry with ``dest`` >= 0 goes to that rank's slot ``slot`` of its
    group; the counts go first, the slots with the rows (their int64
    bytes appended to each row)."""
    G, S, d = x.shape
    row = d * x.element_size()
    if _counting(x, g):
        # a bound: every entry's row and slot out, and the counts
        _record_exchange(g, G * S * (row + 8) + 8 * g.size)
        return x.new_zeros((G, n_slots, d))
    import torch.distributed as dist
    dest, slot = dest.reshape(-1), slot.reshape(-1)
    flat = (torch.arange(G, device=x.device)[:, None] * n_slots
            + slot.reshape(G, S)).reshape(-1)
    sent = dest >= 0
    key = torch.where(sent, dest * (G * n_slots) + flat, g.size * G * n_slots)
    order = torch.argsort(key)[:int(sent.sum())]
    counts = torch.bincount(dest[sent], minlength=g.size)
    got = torch.empty_like(counts)
    dist.all_to_all_single(got, counts, group=g.group)
    plan.sent, plan.received = counts.tolist(), got.tolist()
    plan.order = order
    tag = flat[order].unsqueeze(1).view(x.dtype)
    rows = _a2a(torch.cat([x.reshape(G * S, d)[order], tag], 1),
                plan.received, plan.sent, g)
    plan.slots = rows[:, d:].contiguous().view(torch.int64).squeeze(1)
    _record_exchange(g, _crossing(plan.sent, g) * (row + 8)
                     + 8 * (g.size - 1))
    out = x.new_zeros((G * n_slots, d))
    out[plan.slots] = rows[:, :d]
    return out.reshape(G, n_slots, d)


def _to_owners(x: torch.Tensor, n_slots: int, g: ExpertGroup,
               plan: ExchangePlan) -> torch.Tensor:
    """Entries (G, S, d) -> buffers (G, n_slots, d) along a known plan
    (a collect's backward)."""
    G, S, d = x.shape
    if _counting(x, g):
        _record_exchange(g, G * S * d * x.element_size())
        return x.new_zeros((G, n_slots, d))
    rows = _a2a(x.reshape(G * S, d)[plan.order], plan.received, plan.sent,
                g)
    _record_exchange(g, _crossing(plan.sent, g) * d * x.element_size())
    out = x.new_zeros((G * n_slots, d))
    out[plan.slots] = rows
    return out.reshape(G, n_slots, d)


def _from_owners(y: torch.Tensor, S: int, g: ExpertGroup,
                 plan: ExchangePlan) -> torch.Tensor:
    """Buffers (G, n_slots, d) -> each sent entry's row back at the
    sender (G, S, d), zeros for the entries it did not send."""
    G, _, d = y.shape
    if _counting(y, g):
        _record_exchange(g, G * S * d * y.element_size())
        return y.new_zeros((G, S, d))
    rows = _a2a(y.reshape(-1, d)[plan.slots], plan.sent, plan.received, g)
    _record_exchange(g, _crossing(plan.sent, g) * d * y.element_size())
    out = y.new_zeros((G * S, d))
    out[plan.order] = rows
    return out.reshape(G, S, d)


def _fold(t, in_dim, n: int):
    """A vmap argument with its lanes first (expanded where unbatched),
    the lanes folded into its leading dim."""
    t = t.expand(n, *t.shape) if in_dim is None else t.movedim(in_dim, 0)
    return t.flatten(0, 1)


class Dispatch(torch.autograd.Function):
    """:func:`_dispatch` forward; the cotangents of the owners' slots
    brought back to the entries backward."""

    @staticmethod
    def forward(x, dest, slot, n_slots, g, plan):
        return _dispatch(x, dest, slot, n_slots, g, plan)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.S, ctx.g, ctx.plan = inputs[0].shape[1], inputs[4], inputs[5]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        return (_from_owners(dy, ctx.S, ctx.g, ctx.plan), None, None, None,
                None, None)

    @staticmethod
    def vmap(info, in_dims, x, dest, slot, n_slots, g, plan):
        n = info.batch_size
        out = Dispatch.apply(_fold(x, in_dims[0], n),
                             _fold(dest, in_dims[1], n),
                             _fold(slot, in_dims[2], n), n_slots, g, plan)
        return out.unflatten(0, (n, -1)), 0


class Collect(torch.autograd.Function):
    """:func:`_from_owners` forward along a dispatch's plan; the entries'
    cotangents sent to the owners' slots backward."""

    @staticmethod
    def forward(y, S, g, plan):
        return _from_owners(y, S, g, plan)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n_slots, ctx.g, ctx.plan = inputs[0].shape[1], inputs[2], \
            inputs[3]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dx):
        return _to_owners(dx, ctx.n_slots, ctx.g, ctx.plan), None, None, None

    @staticmethod
    def vmap(info, in_dims, y, S, g, plan):
        n = info.batch_size
        out = Collect.apply(_fold(y, in_dims[0], n), S, g, plan)
        return out.unflatten(0, (n, -1)), 0


def dispatch(x: torch.Tensor, dest: torch.Tensor, slot: torch.Tensor,
             n_slots: int, g: ExpertGroup, plan: ExchangePlan
             ) -> torch.Tensor:
    """Entries ``x`` (G, S, d) to their owners: entry (j, s) with
    ``dest[j, s]`` >= 0 lands at slot ``slot[j, s]`` of group j of rank
    ``dest[j, s]``'s buffer (G, ``n_slots``, d), zeros elsewhere.  The
    slots a rank receives must be distinct.  Fills ``plan`` for the
    :func:`collect` of the same entries."""
    return Dispatch.apply(x, dest, slot, n_slots, g, plan)


def collect(y: torch.Tensor, S: int, g: ExpertGroup, plan: ExchangePlan
            ) -> torch.Tensor:
    """The owners' buffers ``y`` (G, n_slots, d) back to the entries that
    :func:`dispatch` sent (G, ``S``, d), zeros for the entries it did
    not."""
    return Collect.apply(y, S, g, plan)


def head_range(heads: int, kv_heads: int, g: ModelGroup) -> Tuple[int, int]:
    """``(first, count)`` of the KV heads that this rank's query heads
    (its chunk of ``heads``) read."""
    group = heads // kv_heads
    per = heads // g.size
    lo = g.index * per
    first = lo // group
    return first, (lo + per - 1) // group - first + 1


# ---------------------------------------------------------------------------
# vocab-parallel heads: the logits stay split over the vocab
# ---------------------------------------------------------------------------


def _sumexp_and_gold(both: torch.Tensor, g: ModelGroup) -> torch.Tensor:
    """The sums of exponentials and the gold logits, summed over the
    group (one all-reduce)."""
    return all_reduce(both, g)


class VocabParallelCE(torch.autograd.Function):
    """Per-row cross entropy in fp32 of logits split over the vocab (this
    rank's ``(..., V/P)`` chunk, its first id ``lo``): the row max and
    the sum of exponentials are taken over the group, and the gold logit
    comes from the rank whose range holds the label.  The backward is
    softmax minus one-hot on the local chunk (no collective)."""

    @staticmethod
    def forward(logits, labels, g, lo):
        lf = logits.float()
        m = all_gather(lf.amax(-1, keepdim=True).detach(), g, -1).amax(-1)
        e = torch.exp(lf - m[..., None])
        local = labels.long() - lo
        inr = (local >= 0) & (local < lf.shape[-1])
        at = torch.where(inr, local, 0)[..., None]
        gold = torch.where(inr, torch.gather(lf, -1, at)[..., 0], 0.0)
        both = _sumexp_and_gold(torch.stack([e.sum(-1), gold]), g)
        return torch.log(both[0]) + m - both[1], e / both[0][..., None]

    @staticmethod
    def setup_context(ctx, inputs, output):
        logits, labels, g, lo = inputs
        ctx.save_for_backward(output[1], labels)
        ctx.lo, ctx.dtype = lo, logits.dtype
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dce, _dp):
        p, labels = ctx.saved_tensors
        local = labels.long() - ctx.lo
        inr = (local >= 0) & (local < p.shape[-1])
        d = p.clone()
        d.scatter_add_(-1, torch.where(inr, local, 0)[..., None],
                       -inr[..., None].to(d.dtype))
        return (d * dce[..., None]).to(ctx.dtype), None, None, None

    @staticmethod
    def vmap(info, in_dims, logits, labels, g, lo):
        n = info.batch_size
        logits = _lanes_first(logits, in_dims[0])
        labels = _lanes_first(labels, in_dims[1])
        if in_dims[0] is None:
            logits = logits.expand(n, *logits.shape)
        if in_dims[1] is None:
            labels = labels.expand(n, *labels.shape)
        return VocabParallelCE.apply(logits, labels, g, lo), (0, 0)


def vocab_split(n: int, vocab: int) -> bool:
    """Whether logits or a table of ``n`` vocab entries are this rank's
    chunk of the whole ``vocab``: never without an active group, and
    under one the whole V must be named (a head whose V does not divide
    over the group is held whole)."""
    if active() is None:
        return False
    if not vocab:
        raise ValueError("under a model group the whole vocab size must be "
                         "given with vocab-sized logits or tables")
    return n != vocab


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                        ) -> torch.Tensor:
    """Per-row fp32 cross entropy of vocab-split ``logits``."""
    g = active()
    return VocabParallelCE.apply(logits, labels, g,
                                 g.index * logits.shape[-1])[0]


def vocab_argmax(logits: torch.Tensor) -> torch.Tensor:
    """The global argmax of vocab-split ``logits``: each rank's (max,
    index) pair gathered and the first largest taken, as ``argmax`` of
    the whole row takes the first (ids < 2**24 are exact in fp32)."""
    g = active()
    mx, idx = logits.float().max(-1)
    idx = idx + g.index * logits.shape[-1]
    pairs = all_gather(torch.stack([mx, idx.float()], -1)[..., None, :],
                       g, -2)                                 # (..., P, 2)
    best = pairs[..., 0].argmax(-1, keepdim=True)
    return torch.gather(pairs[..., 1], -1, best)[..., 0].long()


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of a table split over the vocab: each rank looks up the ids
    in its range, writes zeros elsewhere, and the rows are summed over
    the group."""
    g = active()
    n = table.shape[0]
    local = tokens.long() - g.index * n
    inr = (local >= 0) & (local < n)
    rows = table[torch.where(inr, local, 0)]
    return reduce_out(torch.where(inr[..., None], rows,
                                  torch.zeros((), dtype=rows.dtype,
                                              device=rows.device)), g)

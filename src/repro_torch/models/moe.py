"""Mixture-of-experts FFN: top-k routing and capacity-based dispatch
(counterpart of ``repro/models/moe.py``).

``moe_forward`` takes the tokens as ``groups`` routing groups: each group
is routed, capacity-limited and combined on its own, as one call of the
JAX ``moe_forward`` on that group's tokens would be.  Training routes its
whole batch as one group (the JAX step's one call); under
``torch.func.vmap`` (the fused engine's lanes) each lane is a call of its
own; a serve decode tick routes each slot alone (one group per row), as
the JAX ``ServeSession``'s ``vmap`` over slots does.

Dispatch, per group of N tokens, capacity ``C = expert_capacity(N)``:
the N x k (token, expert) entries are sorted by expert (stable), each
entry's rank within its expert's run decides whether it keeps a slot,
and each expert's C slots gather their rows.  The groups are then folded
into each expert's capacity axis, so the expert FFNs stay one batched
product over E for the whole batch: each expert's weights are read once.
The combine gathers each entry's expert output back to (N, k) and adds a
token's k contributions in ascending expert order in ``x.dtype``, the
order the JAX ``.at[sorted_tok].add`` adds them in on the CPU.  No
atomics and no in-place writes: the same input gives the same bits, and
every op has a batching rule under ``vmap``.

Under the spmd engine's data split (``models.sync_stats``'s batch group
is active) a routing group is the one-rank engine's whole group, its rows
spread over the batch ranks, as the JAX package routes the global batch
that XLA's partitioner splits: the capacity comes from the global N, each
expert's load is the sum over the batch ranks (:func:`summed_loads`), and
an entry's rank within its expert is the earlier ranks' load plus its
local rank (:func:`global_positions`) -- the order the one-rank stable
sort gives contiguous row blocks.  Routing stays local to each rank.

Expert parallelism (a ``tensor_parallel.ExpertGroup`` of D data ranks is
active and the stack holds E/D experts): batch rank i keeps the i-th
chunk of the experts.  Each rank sends each kept entry's
row to the rank that owns its expert (``tensor_parallel.dispatch``, one
``all_to_all``), which writes it at the entry's global slot of its (E/D,
C, d) buffer -- the one-rank buffer's rows of those experts -- runs its
experts and sends the outputs back (``tensor_parallel.collect``); the
sender weights and adds its entries' contributions in ascending expert
order.  The backward is the reverse exchange, so an owner's expert
gradient sums every batch rank's entries.  The group names how many
experts its roles keep a rank (``ExpertGroup.experts``); a stack its role
keeps whole (too small to split) runs as without the group, and a stack
of any other size raises.

Serving over the batch ranks (``api/serve_session.py``) keeps the same
chunks, but each data rank routes its own groups whole -- one a slot, or
the one request it prefills -- so there are no summed loads:
``ExpertGroup.groups`` gives this rank's groups' place among every
rank's, and an entry lands at its rank within its expert in its own
group of the owner's (groups, E/D, C, d) buffer.  A data rank whose
group does not prefill a request still runs the owner's side of each
block's exchange (:func:`serve_exchange`).

Over a ``"model"`` group (``launch/tensor_parallel.py``) the routing is
computed whole and alike on every rank of the group (its tokens are the
same there).  An expert stack placed over the grid (``shardings.Role``
``"expert"``: E over ("data", "model"), data-major) holds this rank's
experts: chunk i * P + m under expert parallelism (the exchange runs over
the data ranks of model rank m, which sends only the entries of model
rank m's experts), or, with one data rank, the strided chunks of
``tensor_parallel.expert_ids``, whose dispatch buffer the rank builds
alone.  Either way the rank combines its own experts'
contributions and the partial outputs are summed over the group in one
all-reduce (:func:`sum_expert_parts`), which reorders the one-rank
ascending-expert addition.  An expert stack in the data layout (E over
"data", a hidden dim over "model") multiplies with its chunks through
``tensor_parallel.linear`` over the batched product.  The shared expert
is a SwiGLU with the MLP's rules; the router stays whole.

``moe_forward_dense`` is the O(N * E) oracle (no capacity), for the tests.

The aux load-balance loss follows Switch: E * sum_e f_e * P_e * weight,
with f and P over the whole batch (:func:`aux_loss`).
"""
from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch

from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.launch import tensor_parallel as tp
from repro_torch.models import sharding_ctx, sync_stats
from repro_torch.models.common import activation, fan_in_init
from repro_torch.models.mlp import init_mlp, mlp_forward


def init_moe(cfg: ModelConfig, generator, device) -> dict:
    m: MoEConfig = cfg.moe
    d, E, f = cfg.d_model, m.num_experts, m.d_expert
    p = {
        "router": fan_in_init((d, E), torch.float32, generator, device),
        # stacked expert weights: (E, d, d_expert) / (E, d_expert, d)
        "w_gate": fan_in_init((E, d, f), cfg.param_dtype, generator, device,
                              fan_in=d),
        "w_up": fan_in_init((E, d, f), cfg.param_dtype, generator, device,
                            fan_in=d),
        "w_down": fan_in_init((E, f, d), cfg.param_dtype, generator, device,
                              fan_in=f),
    }
    if m.num_shared_experts > 0:
        p["shared"] = init_mlp(cfg, generator, device,
                               d_ff=m.d_shared_expert * m.num_shared_experts)
    return p


@contextlib.contextmanager
def _fp32_products():
    """fp32 matrix products at full precision (no TF32) while the block
    runs: the top-k choice is discontinuous in the router logits."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def router_probs(params: dict, x: torch.Tensor, m: MoEConfig
                 ) -> torch.Tensor:
    """x (..., N, d) -> the router's softmax probabilities (..., N, E)."""
    with _fp32_products():
        logits = x.to(m.router_dtype) @ params["router"].to(m.router_dtype)
    return torch.softmax(logits, dim=-1)


def summed_loads(load: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(before, total)`` of this rank's per-expert counts ``load`` (...,
    E): the counts of the batch ranks before this one and the sum over
    all of them (0 and ``load`` itself outside a data split)."""
    if sync_stats.batch_group() is None:
        return torch.zeros_like(load), load
    _, _, index = sync_stats.batch_group()
    every = sync_stats.gather_over_batch(load)
    return every[:index].sum(0), every.sum(0)


def aux_loss(probs: torch.Tensor, topi: torch.Tensor, m: MoEConfig
             ) -> torch.Tensor:
    """Switch's load-balance loss (...,) fp32 of one routing group per
    leading index: f (each expert's share of the N * k choices) carries no
    gradient, P (the mean probability) does.  Under a data split both are
    whole-batch values: the counts summed over the batch ranks, P's sum
    through ``GroupSumFn``, whose backward sums P's cotangent over the
    ranks, so each rank's probabilities carry ``dp`` times their share and
    the engine's gradient average gives the one-rank gradient."""
    N = probs.shape[-2]
    experts = torch.arange(m.num_experts, device=probs.device)
    counts = (topi[..., None] == experts).to(torch.float32).sum((-3, -2))
    batch = sync_stats.batch_group()
    if batch is None:
        P = probs.mean(dim=-2)
    else:
        group, size, _ = batch
        N = N * size
        P = sync_stats.GroupSumFn.apply(probs.sum(dim=-2), group) / N
    _, counts = summed_loads(counts)
    f = counts * (1.0 / (N * m.top_k))
    return m.num_experts * (f * P).sum(-1) * m.router_aux_weight


def route(params: dict, x: torch.Tensor, m: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (..., N, d) -> (top_idx (..., N, k), top_w (..., N, k) in
    ``x.dtype``, aux (...,) fp32), one routing group per leading index."""
    probs = router_probs(params, x, m)
    topv, topi = probs.topk(m.top_k, dim=-1)
    topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)  # renormalize
    return topi, topv.to(x.dtype), aux_loss(probs, topi, m)


def expert_capacity(num_tokens: int, m: MoEConfig) -> int:
    c = math.ceil(num_tokens * m.top_k / m.num_experts * m.capacity_factor)
    return max(4, int(c))


def moe_forward(params: dict, x: torch.Tensor, cfg: ModelConfig,
                groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, d) -> (out (B, T, d), aux fp32 scalar: the mean of the
    groups' aux losses).  The B rows form ``groups`` routing groups of
    B / groups rows each; under a data split they are this rank's rows of
    one group spread over the batch ranks."""
    m: MoEConfig = cfg.moe
    B, T, d = x.shape
    if groups < 1 or B % groups:
        raise ValueError(f"{cfg.name}: {B} rows do not split into "
                         f"{groups} routing groups")
    batch = sync_stats.batch_group()
    if batch is not None and groups != 1:
        raise ValueError(f"{cfg.name}: a data split routes one group over "
                         f"the batch ranks, not {groups}")
    k, E = m.top_k, m.num_experts
    # which experts this rank runs: all E, or this rank's chunk of them
    # over the batch ranks (expert parallelism) and/or over the model
    # group (the grid: then only this model rank's experts' entries, and
    # the routing is whole and the same on every rank of the group: the
    # group's tokens are the same)
    g, ep = tp.active(), tp.active_experts()
    n_loc = params["w_gate"].shape[0]
    if ep is not None and n_loc == E:
        ep = None                       # its role keeps this stack whole
    serving = ep is not None and ep.groups is not None
    if serving:
        # serving over the batch ranks: this rank's groups are whole here
        groups, first, n_groups = slot_groups(groups, *ep.groups)
        if first < 0 or first + groups > n_groups:
            raise ValueError(f"{cfg.name}: routing groups {first}.."
                             f"{first + groups - 1} lie outside the "
                             f"{n_groups} over the expert group")
    G, N = groups, B * T // groups
    C = expert_capacity(N * (batch[1] if batch else 1), m)
    xg = x.reshape(G, N, d)
    topi, topw, aux = route(params, xg, m)

    # ---- dispatch: sort the N*k entries by expert, rank them ---------------
    flat_e = topi.reshape(G, N * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)       # sorted -> entry
    experts = torch.arange(E, device=x.device)
    load = (flat_e[..., None] == experts).sum(-2)            # (G, E)
    starts = torch.cumsum(load, -1) - load                   # first sorted pos
    # Capacity, as the JAX package computes it on the CPU
    # (src/repro/models/moe.py:94-100): a dropped entry's slot is clipped to
    # the expert's last one, e*C + C-1, and scattered as a zero row with
    # unique_indices=False; XLA:CPU applies the writes in order, so the last
    # (a zero row) wins.  An expert whose load exceeds C therefore keeps
    # only its first C-1 entries in the stable sorted order.  Mirrored here
    # without the racing scatter; ROADMAP.md Queue 3 records it.  The rule
    # reads the whole batch's load; this rank keeps the entries whose
    # global rank (the earlier ranks' load plus the local rank) it admits.
    before, total = summed_loads(load)
    kept = torch.where(total > C, C - 1, total)              # (G, E)
    kept = torch.minimum((kept - before).clamp(min=0), load)

    pos = torch.argsort(order, dim=-1)                       # entry -> sorted
    rank = pos - starts.gather(-1, flat_e)
    keep = rank < kept.gather(-1, flat_e)

    P = g.size if g else 1
    if ep is not None and n_loc != ep.experts:
        raise ValueError(f"{cfg.name}: a stack of {n_loc} experts under an "
                         f"expert group that keeps {ep.experts} of {E}")
    D = ep.size if ep else 1
    part = None
    if n_loc * D != E:
        if g is None or n_loc * D * P != E:
            raise ValueError(f"{cfg.name}: {n_loc} experts a rank do not "
                             f"split {E} over {D} x {P} ranks")
        part = g.index
        xg, topw = tp.copy_in(xg, g), tp.copy_in(topw, g)
    # rows by entry, not by token: each entry is gathered at most once, so
    # the backward scatters to unique rows (a token's k copies are summed
    # by the expand's backward, a plain reduction)
    xe = xg[:, :, None, :].expand(G, N, k, d).reshape(G, N * k, d)
    Gb = G                      # the routing groups of the dispatch buffer
    if ep is None:
        buf, local = _gathered_rows(xe, order, starts, kept, C, n_loc, E,
                                    part)
    else:
        # expert chunk c = e // n_loc lives on batch rank c (c // P in the
        # grid, whose model rank c % P runs it)
        plan = tp.ExchangePlan()
        chunk = flat_e // n_loc
        owner = expert_owner(chunk, E // n_loc,
                             1 if part is None else P)
        if part is not None:
            keep = keep & (chunk % P == part)
        at = (flat_e - chunk * n_loc) * C
        dest = torch.where(keep, owner, -1)
        if not serving:
            # a train step: an entry lands at its expert's slot of the
            # whole batch on that rank
            slot = at + global_positions(before.gather(-1, flat_e), rank)
            buf = tp.dispatch(xe, dest, torch.where(keep, slot, 0),
                              n_loc * C, ep, plan)
        else:
            # serving: this rank's group j is group first + j of the
            # owner's buffer, the entry at its rank within its expert
            Gb = n_groups
            grp = first + torch.arange(G, device=x.device)[:, None]
            slot = grp * (n_loc * C) + at + rank
            buf = tp.dispatch(xe.reshape(1, G * N * k, d),
                              dest.reshape(1, -1),
                              torch.where(keep, slot, 0).reshape(1, -1),
                              Gb * n_loc * C, ep, plan)
    buf = sharding_ctx.constrain(buf, None, "data", "model")
    # the groups folded into each expert's capacity axis: (n_loc, Gb*C, d)
    buf = buf.reshape(Gb, n_loc, C, d).transpose(0, 1).reshape(
        n_loc, Gb * C, d)
    # expert-parallel placement of the dispatch buffer: the full grid, then
    # data-only expert parallelism (the JAX package's candidates)
    buf = sharding_ctx.constrain(buf, [("data", "model"), "data"], None,
                                 [None, "model"])

    # ---- expert FFNs, one batched product over the experts (the data
    # layout's chunks of the hidden dims through tensor_parallel.linear)
    eout = mlp_forward({w: params[w] for w in ("w_gate", "w_up", "w_down")},
                       buf, cfg, d_ff=m.d_expert)            # (n_loc, Gb*C, d)
    eout = sharding_ctx.constrain(eout, [("data", "model"), "data"], None,
                                  [None, "model"])
    eout = eout.reshape(n_loc, Gb, C, d).transpose(0, 1).reshape(
        Gb, n_loc * C, d)

    # ---- combine: each entry's output, added in ascending expert order -----
    if ep is None:
        at = flat_e if local is None else local[flat_e]
        keep = keep & (at >= 0)
        contrib = eout.gather(1, torch.where(keep, at * C + rank, 0)[
            ..., None].expand(G, N * k, d))
    elif not serving:
        contrib = tp.collect(eout, N * k, ep, plan)
    else:
        contrib = tp.collect(eout.reshape(1, Gb * n_loc * C, d),
                             G * N * k, ep, plan).reshape(G, N * k, d)
    w = topw.reshape(G, N * k) * keep.to(x.dtype)
    contrib = (contrib * w[..., None]).reshape(G, N, k, d)
    by_expert = torch.argsort(topi, dim=-1)                  # (G, N, k)
    contrib = contrib.gather(2, by_expert[..., None].expand(G, N, k, d))
    out = contrib[:, :, 0]
    for j in range(1, k):
        out = out + contrib[:, :, j]
    if part is not None:
        out = sum_expert_parts(out, g)
    out = out.reshape(B, T, d)
    if "shared" in params:
        out = out + mlp_forward(params["shared"], x, cfg,
                                d_ff=m.d_shared_expert * m.num_shared_experts)
    return out.to(x.dtype), aux.mean()


def _gathered_rows(xe, order, starts, kept, C: int, n_loc: int, E: int,
                   part):
    """Each expert's C slots gather their rows from the sorted entries:
    every expert, or (``part``, over the grid) this model rank's
    ``n_loc`` experts of the stacks gathered over the data axes
    (``tensor_parallel.expert_ids``).  Returns ``(rows (G, n_loc * C,
    d), local)``: ``local`` (E,) each expert's index among them (-1:
    another rank's), ``None`` where they are all E."""
    G, _, d = xe.shape
    c_idx = torch.arange(C, device=xe.device)
    valid = c_idx < kept[..., None]                          # (G, E, C)
    src = torch.where(valid, starts[..., None] + c_idx, 0)
    local = None
    if part is not None:
        mine = torch.tensor(tp.expert_ids(E, n_loc), device=xe.device)
        valid, src = valid[:, mine], src[:, mine]            # (G, n_loc, C)
        local = torch.full((E,), -1, dtype=torch.long, device=xe.device)
        local[mine] = torch.arange(n_loc, device=xe.device)
    entry = order.gather(-1, src.reshape(G, n_loc * C))      # (G, n_loc*C)
    rows = xe.gather(1, entry[..., None].expand(G, n_loc * C, d))
    return torch.where(valid.reshape(G, n_loc * C, 1), rows, 0), local


def serve_exchange(params: dict, cfg: ModelConfig, n_tokens: int) -> None:
    """A data rank's part in a MoE block of a prefill that another data
    group runs (serving over the batch ranks, the request's routing
    groups those of :attr:`ExpertGroup.groups`, ``n_tokens`` tokens
    each): it sends no entries, receives those routed to its experts,
    runs them and sends the outputs back -- the exchanges of
    :func:`moe_forward`, in its order, so that no rank waits on
    another.  Nothing where the stack is kept whole."""
    m: MoEConfig = cfg.moe
    ep = tp.active_experts()
    n_loc = params["w_gate"].shape[0]
    if ep is None or n_loc == m.num_experts:
        return
    _, total = ep.groups
    C, d = expert_capacity(n_tokens, m), cfg.d_model
    dev = params["w_gate"].device
    none = torch.zeros((1, 0), dtype=torch.long, device=dev)
    plan = tp.ExchangePlan()
    buf = tp.dispatch(torch.zeros((1, 0, d), dtype=cfg.dtype, device=dev),
                      none, none, total * n_loc * C, ep, plan)
    buf = buf.reshape(total, n_loc, C, d).transpose(0, 1).reshape(
        n_loc, total * C, d)
    eout = mlp_forward({w: params[w] for w in ("w_gate", "w_up", "w_down")},
                       buf, cfg, d_ff=m.d_expert)
    eout = eout.reshape(n_loc, total, C, d).transpose(0, 1).reshape(
        1, total * n_loc * C, d)
    tp.collect(eout, 0, ep, plan)


def slot_groups(groups: int, first: int, total: int
                ) -> Tuple[int, int, int]:
    """Serving over the batch ranks: ``(groups, first, total)`` of this
    rank's rows, one routing group a slot (a module function:
    ``parity.pooled_slots`` replaces it)."""
    return groups, first, total


def expert_owner(chunk: torch.Tensor, chunks: int, P: int) -> torch.Tensor:
    """The batch rank that holds expert chunk ``chunk`` of ``chunks`` (P
    chunks a batch rank over the grid; a module function:
    ``parity.misrouted_entries`` replaces it)."""
    return chunk // P


def global_positions(before: torch.Tensor, rank: torch.Tensor
                     ) -> torch.Tensor:
    """Each entry's position among its expert's entries of the whole
    batch: the earlier batch ranks' load of its expert (``before``) plus
    its rank here, the one-rank stable sort's order (a module function:
    ``parity.local_slots`` replaces it)."""
    return before + rank


def sum_expert_parts(out: torch.Tensor, g) -> torch.Tensor:
    """The combined outputs of each rank's experts summed over the model
    group (a module function: ``parity.unsummed_expert_parts`` replaces
    it)."""
    return tp.reduce_out(out, g)


def moe_forward_dense(params: dict, x: torch.Tensor, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(N*E) oracle (no capacity drops), for the tests: every expert on
    every token, weighted by the routing's combine matrix."""
    m: MoEConfig = cfg.moe
    B, T, d = x.shape
    act = activation(cfg.act)
    xf = x.reshape(B * T, d)
    topi, topw, aux = route(params, xf, m)
    combine = torch.zeros((B * T, m.num_experts), dtype=x.dtype,
                          device=x.device).scatter(-1, topi, topw)
    h = act(torch.einsum("nd,edf->nef", xf, params["w_gate"])) * \
        torch.einsum("nd,edf->nef", xf, params["w_up"])
    eout = torch.einsum("nef,efd->ned", h, params["w_down"])
    out = torch.einsum("ned,ne->nd", eout, combine).reshape(B, T, d)
    if "shared" in params:
        out = out + mlp_forward(params["shared"], x, cfg)
    return out.to(x.dtype), aux

"""Fused Hetero-SplitEE train and serve steps for the production backbone,
and the cohort steps of the fused engine, plain and masked by a client
population's participation (counterpart of ``repro/core/spmd.py``).

Client groups tile the batch; every example runs the full network; the
paper's gradient routing is a per-example stop-gradient at the example's
split boundary (``backbone_forward(split_ids=)``), and Eq. (1) cross-layer
aggregation becomes a per-layer gradient scale over participation counts.

Two gradient modes:
  * ``eq1`` (paper-faithful): the client-family and the server-family
    gradients are pulled separately through one shared forward (two
    ``torch.autograd.grad`` passes) and each layer's gradient is scaled by
    its participation count: 1/|{g : l_g > l}| for the client family,
    1/|C_l| for the server family.
  * ``sum``: one backward pass of the summed loss, no per-layer scaling.

The train steps update the parameters and the Adam moments in place
(``optim/adam.py`` says why) and return them with the metrics.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.config import (HeteroProfile, ModelConfig, SplitEEConfig,
                                TrainConfig)
from repro_torch.core.aggregation import participation_counts
from repro_torch.core.losses import softmax_cross_entropy, softmax_entropy
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.launch import tensor_parallel as tp
from repro_torch.models.backbone import BackboneOutput, backbone_forward
from repro_torch.models.heads import whole_logits
from repro_torch.optim import adam_update, make_schedule
from repro_torch.tree import tree_leaves, tree_map

GRAD_MODES = ("eq1", "sum")


# ---------------------------------------------------------------------------
# split-id assignment
# ---------------------------------------------------------------------------


def boundary_ids_for_batch(profile: HeteroProfile, cfg: ModelConfig,
                           batch: int, device=None) -> torch.Tensor:
    """Per-example boundary index, (batch,) int32 on ``device`` (default
    the CUDA card): group g (the g-th contiguous slice of the batch) gets
    the boundary index of its split layer.  Split layers must be members
    of ``cfg.exit_layers``."""
    bounds = {l: b for b, l in enumerate(sorted(cfg.exit_layers))}
    ids: List[int] = []
    per = batch // profile.num_groups
    rem = batch - per * profile.num_groups
    for g, li in enumerate(profile.split_layers):
        ids.extend([bounds[li]] * (per + (1 if g < rem else 0)))
    return torch.tensor(ids, dtype=torch.int32, device=resolve_device(device))


# ---------------------------------------------------------------------------
# per-layer participation scales (the Eq. 1 normalization)
# ---------------------------------------------------------------------------


def participation_scale_trees(params: Any, cfg: ModelConfig,
                              profile: HeteroProfile) -> Tuple[Any, Any]:
    """(client_scale, server_scale), trees shaped like ``params`` with one
    float per leaf: 1/#participants for the family that trains the leaf,
    0 when the family never reaches it.  The port keeps one dict per
    layer, so a layer's scale is one scalar (the JAX package broadcasts a
    per-layer vector over its stacked runs)."""
    N = profile.num_groups
    n_client, n_server = participation_counts(profile.split_layers,
                                              cfg.num_layers)
    inv = lambda n: (1.0 / n) if n > 0 else 0.0  # noqa: E731
    fill = lambda tree, val: tree_map(lambda _: val, tree)  # noqa: E731

    # the embedding and the frontend projector are reached by every
    # group's exit loss and never by the server family (a stop-gradient
    # sits above them on every example's path)
    cs: Dict[str, Any] = {}
    ss: Dict[str, Any] = {}
    for key in ("embed", "frontend"):
        if key in params:
            cs[key] = fill(params[key], inv(N))
            ss[key] = fill(params[key], 0.0)
    if "shared_attn" in params:
        # Zamba2's shared block runs on both sides of every cut and both
        # families reach it: 1/N for each, the JAX package's documented
        # approximation (its layers' {} placeholders fill to {} below)
        cs["shared_attn"] = fill(params["shared_attn"], inv(N))
        ss["shared_attn"] = fill(params["shared_attn"], inv(N))
    cs["segments"], ss["segments"] = [], []
    for (lo, _), seg in zip(cfg.segments(), params["segments"]):
        cs["segments"].append([fill(p, inv(n_client[lo + li]))
                               for li, p in enumerate(seg)])
        ss["segments"].append([fill(p, inv(n_server[lo + li]))
                               for li, p in enumerate(seg)])
    if "exit_heads" in params:
        cs["exit_heads"], ss["exit_heads"] = [], []
        for p, l in zip(params["exit_heads"], sorted(cfg.exit_layers)):
            cnt = sum(1 for s in profile.split_layers if s == l)
            cs["exit_heads"].append(fill(p, inv(cnt)))
            ss["exit_heads"].append(fill(p, 0.0))
    cs["head"] = fill(params["head"], 0.0)
    ss["head"] = fill(params["head"], inv(N))
    return cs, ss


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def hetero_losses(out: BackboneOutput, labels: torch.Tensor,
                  split_ids: torch.Tensor, num_boundaries: int,
                  vocab: int = 0) -> Tuple[torch.Tensor, torch.Tensor,
                             Dict[str, torch.Tensor]]:
    """(client_total, server_total, metrics).  ``client_total`` sums each
    boundary's masked-mean exit CE (one term per client group family);
    ``server_total`` is the final-head CE over all examples plus the MoE
    router aux loss (reported as ``metrics["aux_loss"]``).  ``vocab``: the
    whole V, where vocab-parallel heads left the logits split (required
    under an active model group: ``tp.vocab_split`` raises without it)."""
    client_total = torch.zeros((), device=labels.device)
    metrics: Dict[str, torch.Tensor] = {}
    for b in range(num_boundaries):
        mask = (split_ids == b).float()
        m = mask[:, None].expand(labels.shape) if labels.ndim == 2 else mask
        ce = softmax_cross_entropy(out.exit_logits[b], labels, m, vocab)
        ce = torch.where(mask.sum() > 0, ce, torch.zeros_like(ce))
        client_total = client_total + ce
        metrics[f"client_loss/b{b}"] = ce
    server_loss = softmax_cross_entropy(out.logits, labels, vocab=vocab)
    metrics["server_loss"] = server_loss
    metrics["aux_loss"] = out.aux_loss
    return client_total, server_loss + out.aux_loss, metrics


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StepConfig:
    model: ModelConfig
    splitee: SplitEEConfig
    train: TrainConfig = field(default_factory=TrainConfig)
    grad_mode: str = "eq1"            # "eq1" | "sum"


class _Trainable:
    """The parameter leaves, made to require grad for the duration of a
    ``with`` block (their flags are restored after)."""

    def __init__(self, params):
        self.leaves = list(tree_leaves(params))

    def __enter__(self):
        self._flags = [p.requires_grad for p in self.leaves]
        for p in self.leaves:
            p.requires_grad_(True)
        return self.leaves

    def __exit__(self, *exc):
        for p, flag in zip(self.leaves, self._flags):
            p.requires_grad_(flag)


def _scaled_sum(gc: Optional[torch.Tensor], gs: Optional[torch.Tensor],
                a: float, b: float) -> Optional[torch.Tensor]:
    """gc * a + gs * b in place in one of the two buffers; a gradient that
    was not pulled (``None``) counts as zero."""
    if gc is None:
        return None if gs is None else gs.mul_(b)
    return gc.mul_(a) if gs is None else gc.mul_(a).add_(gs, alpha=b)


def _pull(loss: torch.Tensor, leaves: List[torch.Tensor],
          scales: List[float], retain_graph: bool
          ) -> List[Optional[torch.Tensor]]:
    """d loss / d leaf for the leaves whose scale is not 0 (``None`` for
    the others).  Asking only for those keeps autograd off paths whose
    gradient the scale zeroes: the server loss reaches the layers below
    the lowest cut and the embedding only through all-zero cotangents (the
    per-example stop-gradient is a ``where``)."""
    want = [i for i, s in enumerate(scales) if s != 0]
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    if want:
        got = torch.autograd.grad(loss, [leaves[i] for i in want],
                                  retain_graph=retain_graph,
                                  allow_unused=True)
        for i, g in zip(want, got):
            out[i] = g
    return out


def _check_grad_mode(grad_mode: str) -> None:
    if grad_mode not in GRAD_MODES:
        raise ValueError(f"unknown grad_mode {grad_mode!r}; expected one of "
                         f"{GRAD_MODES}")


def make_grad_step(sc: StepConfig) -> Callable:
    """Builds ``grad_step(params, batch) -> (grads, metrics)``: the
    gradients :func:`make_train_step` hands to Adam, one per leaf of
    ``tree_leaves(params)`` (``None`` for a leaf that gets none), and the
    metrics ``client_loss/b{i}``, ``server_loss`` and ``aux_loss`` (0-d
    tensors on the device).  ``batch`` as for :func:`make_train_step`."""
    _check_grad_mode(sc.grad_mode)
    cfg = sc.model
    nb = len(cfg.exit_layers)
    remat = sc.train.remat != "none"

    def grad_step(params, batch):
        with _Trainable(params) as leaves:
            out = backbone_forward(params, cfg, tokens=batch.get("tokens"),
                                   embeds=batch.get("embeds"),
                                   enc=batch.get("enc"),
                                   split_ids=batch["split_ids"], remat=remat)
            client, server, metrics = hetero_losses(
                out, batch["labels"], batch["split_ids"], nb,
                cfg.vocab_size)
            del out
            if sc.grad_mode == "eq1":
                cs, ss = participation_scale_trees(params, cfg,
                                                   sc.splitee.profile)
                cs, ss = list(tree_leaves(cs)), list(tree_leaves(ss))
                g_client = _pull(client, leaves, cs, retain_graph=True)
                g_server = _pull(server, leaves, ss, retain_graph=False)
                grads = [_scaled_sum(gc, gs, a, b) for gc, gs, a, b in zip(
                    g_client, g_server, cs, ss)]
                del g_client, g_server
            else:
                grads = list(torch.autograd.grad(client + server, leaves,
                                                 allow_unused=True))
        return grads, {k: v.detach() for k, v in metrics.items()}

    return grad_step


def _refuse_clip_over_group(sc: StepConfig) -> None:
    if sc.train.optimizer.grad_clip > 0 and tp.active() is not None:
        raise ValueError("a clip norm over a model group's chunks needs the "
                         "spmd engine (its norm sums the split leaves over "
                         "the group)")


def make_train_step(sc: StepConfig) -> Callable:
    """Builds ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: :func:`make_grad_step`'s gradients, then Adam.  ``batch`` =
    {"tokens": (B, T), "labels": (B, T), "split_ids": (B,)} on the
    parameters' device, and for audio and VLM configs ``"enc"`` (B, S,
    768) or ``"embeds"`` (B, 256, 1152), the stub frontend's inputs (a VLM
    batch's labels then cover the patches and the tokens).  Metrics:
    ``client_loss/b{i}``, ``server_loss`` and ``aux_loss`` (0-d tensors on
    the device) and ``lr`` (a float)."""
    grad_step = make_grad_step(sc)
    schedule = make_schedule(sc.train.optimizer)

    def train_step(params, opt_state, batch):
        _refuse_clip_over_group(sc)
        grads, metrics = grad_step(params, batch)
        lr = schedule(opt_state.step)
        params, opt_state = adam_update(params, grads, opt_state,
                                        sc.train.optimizer, lr)
        metrics["lr"] = lr
        return params, opt_state, metrics

    return train_step


def make_sequential_train_step(sc: StepConfig) -> Callable:
    """Alg. 1 over the production backbone: one update per client group,
    in group order.

    Each group's slice of the batch updates the client family (embedding,
    layers below its cut, its exit head) from its exit loss, and the shared
    server side from the final loss with the paper's LR divisor (eta/N).
    One backward pass cannot scale the two families separately on layers
    both reach, so the gradient is blended by participation (exact on
    pure-client leaves like the embedding, scale 1, and on pure-server
    leaves like the head, 1/div).  The learning rate is read once per step,
    before the group updates, as the JAX step does.

    Batch layout: group-contiguous (see :func:`boundary_ids_for_batch`);
    the batch must divide evenly by ``num_groups``."""
    cfg = sc.model
    nb = len(cfg.exit_layers)
    schedule = make_schedule(sc.train.optimizer)
    remat = sc.train.remat != "none"
    N = sc.splitee.profile.num_groups
    div = sc.splitee.resolved_server_lr_divisor()

    def train_step(params, opt_state, batch):
        _refuse_clip_over_group(sc)
        B = batch["split_ids"].shape[0]
        if B % N:
            raise ValueError(f"batch {B} does not divide into {N} groups")
        per = B // N
        lr = schedule(opt_state.step)
        cs, ss = participation_scale_trees(params, cfg, sc.splitee.profile)
        scale = [a * N + b * N / div
                 for a, b in zip(tree_leaves(cs), tree_leaves(ss))]
        losses = []
        for g in range(N):
            rows = slice(g * per, (g + 1) * per)
            with _Trainable(params) as leaves:
                out = backbone_forward(params, cfg,
                                       split_ids=batch["split_ids"][rows],
                                       remat=remat,
                                       **{key: batch[key][rows]
                                          for key in ("tokens", "embeds",
                                                      "enc")
                                          if batch.get(key) is not None})
                client, server, m = hetero_losses(
                    out, batch["labels"][rows], batch["split_ids"][rows], nb,
                    cfg.vocab_size)
                del out
                grads = torch.autograd.grad(client + server, leaves,
                                            allow_unused=True)
            grads = [None if gr is None else gr.mul_(sk)
                     for gr, sk in zip(grads, scale)]
            params, opt_state = adam_update(params, grads, opt_state,
                                            sc.train.optimizer, lr)
            losses.append(m["server_loss"].detach())
        return params, opt_state, {"server_loss": torch.stack(losses).mean(),
                                   "lr": lr}

    return train_step


# ---------------------------------------------------------------------------
# cohort step (the fused engine's TrainState boundary)
# ---------------------------------------------------------------------------


def make_cohort_grad_step(model, li: int,
                          grad_mode: str = "eq1") -> Callable:
    """The gradients of one cohort step, for a cohort of clients cut at
    ``li`` with every leaf stacked along a leading lane axis:

        (client, server, x, y) -> (g_client, g_server, client_loss,
                                   server_loss, client_state, server_state)

    ``client``/``server`` are ``{"trainable", "state"}`` dicts of stacked
    leaves and ``x``/``y`` ``[k, B, ...]``; the gradients come one per leaf
    of ``tree_leaves`` of each trainable (``None`` where none reaches it),
    the losses as ``(k,)`` tensors on the device, never read on the host,
    with the BatchNorm states of the training forward.

    ``torch.func.vmap`` runs only the forward over the lanes: the adapter's
    own forwards through ``strategies.client_loss_fn`` / ``server_loss_fn``.
    Plain autograd then takes gradients of the sum of the lanes' losses
    with respect to the stacked leaves.  Lanes hold disjoint parameters, so
    d(sum_j L_j)/d theta_j = dL_j/d theta_j exactly, and the kernels'
    backward sees plain folded tensors (``kernels/dispatch.py``'s ``vmap``
    rules), never batched ones.

      * ``"eq1"``: the client losses are pulled against the client leaves,
        then ``h`` (detached) enters the server forward and the server
        losses are pulled against the server leaves, the composition the
        reference engine runs client by client;
      * ``"sum"``: one pull of the summed client and server losses against
        both families.  ``h`` is detached in both modes, so the gradients
        are the same as eq1's."""
    from torch.func import vmap

    from repro_torch.core.strategies import client_loss_fn, server_loss_fn
    _check_grad_mode(grad_mode)
    closs_fn = vmap(client_loss_fn(model))
    sloss_fn = vmap(server_loss_fn(model, li))

    def grads(loss, leaves):
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    def grad_step(client, server, x, y):
        ctr, strv = client["trainable"], server["trainable"]
        with torch.enable_grad(), _Trainable(ctr) as cl, \
                _Trainable(strv) as sl:
            closs, (h, cst) = closs_fn(ctr, client["state"], x, y)
            if grad_mode == "eq1":
                gc = grads(closs.sum(), cl)
                sloss, sst = sloss_fn(strv, server["state"], h.detach(), y)
                gs = grads(sloss.sum(), sl)
            else:
                sloss, sst = sloss_fn(strv, server["state"], h.detach(), y)
                g = grads(closs.sum() + sloss.sum(), cl + sl)
                gc, gs = g[:len(cl)], g[len(cl):]
        return gc, gs, closs.detach(), sloss.detach(), cst, sst

    return grad_step


def make_cohort_train_step(model, opt_cfg, li: int,
                           grad_mode: str = "eq1") -> Callable:
    """One combined client + server step over a cohort of clients cut at
    ``li`` (the fused engine's step):

        (client, copt, server, sopt, x, y, lr, lr_s)
            -> (client, copt, server, sopt, client_loss, server_loss)

    :func:`make_cohort_grad_step`'s gradients, then one Adam update per
    stacked leaf for all lanes, its clip norm taken per lane.  ``copt`` and
    ``sopt`` hold stacked moments and an int32 ``[k]`` step tensor.
    Parameters and moments are updated in place."""
    grad_step = make_cohort_grad_step(model, li, grad_mode)

    def step(client, copt, server, sopt, x, y, lr, lr_s):
        gc, gs, closs, sloss, cst, sst = grad_step(client, server, x, y)
        ctr, copt = adam_update(client["trainable"], gc, copt, opt_cfg, lr,
                                lanes=True)
        strv, sopt = adam_update(server["trainable"], gs, sopt, opt_cfg,
                                 lr_s, lanes=True)
        return ({"trainable": ctr, "state": cst}, copt,
                {"trainable": strv, "state": sst}, sopt, closs, sloss)

    return step


def make_masked_cohort_step(model, opt_cfg, li: int,
                            grad_mode: str = "eq1") -> Callable:
    """:func:`make_cohort_train_step` gated by a per-lane participation
    mask:

        (client, copt, server, sopt, x, y, lr, lr_s, m)
            -> (client, copt, server, sopt, client_loss * m,
                server_loss * m)

    ``m`` is a ``[k]`` 0/1 device tensor.  Every lane's step is computed
    (fixed shapes and launches whatever the active set; the kernel sites
    fold all lanes into one launch as in the unmasked step), then a lane
    whose mask is 0 keeps its parameters, Adam moments and step (the
    masked update acts inside Adam, which works in place) and its
    BatchNorm statistics (``strategies.masked_update``).  With ``m`` all
    1 every output is bit for bit the unmasked step's: ``x * 1.0 == x``
    and the gates take the stepped values."""
    from repro_torch.core.strategies import masked_update
    grad_step = make_cohort_grad_step(model, li, grad_mode)

    def step(client, copt, server, sopt, x, y, lr, lr_s, m):
        gc, gs, closs, sloss, cst, sst = grad_step(client, server, x, y)
        ctr, copt = adam_update(client["trainable"], gc, copt, opt_cfg, lr,
                                lanes=True, mask=m)
        strv, sopt = adam_update(server["trainable"], gs, sopt, opt_cfg,
                                 lr_s, lanes=True, mask=m)
        cst = masked_update(m, cst, client["state"])
        sst = masked_update(m, sst, server["state"])
        return ({"trainable": ctr, "state": cst}, copt,
                {"trainable": strv, "state": sst}, sopt,
                closs * m.to(closs.dtype), sloss * m.to(sloss.dtype))

    return step


# ---------------------------------------------------------------------------
# serve step (decode shapes; Alg. 3 gate fused in)
# ---------------------------------------------------------------------------


def make_serve_step(sc: StepConfig, boundary: int = 0) -> Callable:
    """One decode step with the Alg. 3 entropy gate at the client boundary:
    both the exit and the full path are computed and each row selects.

    ``boundary`` indexes ``sorted(cfg.exit_layers)``, the order
    ``backbone_forward`` emits ``exit_logits`` in.  The returned
    ``serve_step(params, tokens, cache, cache_len, embeds=None, enc=None,
    tau=None)`` takes ``embeds``/``enc`` as ``backbone_forward`` does and
    ``tau`` as a float or one threshold per row on the device (defaults to
    ``sc.splitee.entropy_threshold``); ``cache`` is updated in place.
    MoE blocks route each row alone (one routing group per slot), as the
    JAX ``ServeSession``'s ``vmap`` of a one-row step does: a slot's
    capacity and drops never depend on which requests share its tick."""
    cfg = sc.model
    tau_default = sc.splitee.entropy_threshold
    backend = dispatch.backend_for(cfg)

    def serve_step(params, tokens, cache, cache_len, embeds=None, enc=None,
                   tau=None):
        tau_ = tau_default if tau is None else tau
        out = backbone_forward(params, cfg, tokens=tokens, embeds=embeds,
                               enc=enc, cache=cache, cache_len=cache_len,
                               exit_heads=(boundary,),
                               moe_groups=tokens.shape[0])
        out.logits = whole_logits(out.logits, cfg)
        if cfg.exit_layers:
            e_logits = whole_logits(out.exit_logits[boundary], cfg)
            H, exit_now = backend.entropy_gate(e_logits, tau_)   # (B, T)
            final = torch.where(exit_now[..., None], e_logits, out.logits)
        else:
            H = softmax_entropy(out.logits)
            exit_now = torch.zeros_like(H, dtype=torch.bool)
            final = out.logits
        return {"logits": final, "exited": exit_now, "entropy": H,
                "cache": out.cache}

    return serve_step

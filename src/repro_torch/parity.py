"""Kernels against the plain versions: the comparisons, limits and inputs
that ``chip_smoke.py`` (phases kernels and parity) and the card tests
share.

In bf16 the kernels and the plain versions round at other points (the
attention tile routes round P and the output to bf16, the wkv writes its
gradients in bf16), so two served streams may part at a near tie and two
gradients differ by rounding.  Each limit below sits between the reading
of sound runs and that of a planted fault (``chip_smoke.py``'s controls:
the newest key dropped from the decode attention, the wkv bonus u dropped,
dK or the wkv's dk zeroed in the backward), read on an H100 in the setup
of ``chip_smoke.py``'s phase parity (seeded, so a rerun reads the same);
PERF.md lists both readings beside each limit.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.api.serve_session import ServeResult
from repro_torch.kernels.entropy_exit import MIN_SLICE

# a served stream may part from the plain one only where the plain logits'
# top-2 gap is below TIE_GAP_BF16, or at a gate with |H - tau| <= TOL_H_BF16;
# gate entropies within TOL_H_BF16 up to there.  Sound runs: max|dH| 1.3e-3
# (glm4-9b), 1.9e-6 (rwkv6), no stream parts; the faults: 8.1e-3 and
# 1.4e-2, and streams part at gaps up to 0.52.  TIE_GAP_BF16 is just above
# one bf16 step of logits in [2, 4) (2^-6 = 0.0156): where the plain top-2
# logits are one step apart a sound run may take the other token
TIE_GAP_BF16 = 2e-2
TOL_H_BF16 = 3e-3
# the same comparison in fp32, where the served streams and the plain
# references differ only by the order of fp32 sums (a decode ring split
# over ranks combines its parts' softmax sums, log-sum-exp weighted): the
# limits tests/test_torch_serve.py holds the port's session to against the
# JAX package's, a top-2 gap of 1e-5 and entropies within 1e-4
TIE_GAP_F32 = 1e-5
TOL_H_F32 = 1e-4
# the first step's gradients, each leaf's ||g - g_plain|| / ||g_plain||:
# sound 1.6e-2 (glm4-9b), 4.8e-3 (rwkv6); the faults 1.0 in both
TOL_GRAD_BF16 = 5e-2
# eq1 losses (averages over the batch's tokens) over three Adam steps, by
# config family: sound 8.4e-4 (glm4-9b) and 3.5e-3 (rwkv6), the faults
# 2.7e-3 and 1.5e-2.  The three dense configs' smokes are glm4-9b's smoke
# with other GQA groups (the same kernels, products and widths): they hold
# its limit.  qwen3-moe's smoke routes each token to 2 of 4 experts from
# fp32 router logits of bf16 hidden states, where the kernels and the
# plain versions round differently; it holds glm4-9b's limit as well
# zamba2-1.2b's smoke runs one shared attention layer among three Mamba2
# layers (plain torch products in both runs) and deepseek-v3-671b's MLA
# runs no kernel at all (its training is the plain versions' on both
# sides; its serving gate is the one kernel); both hold glm4-9b's limit
# whisper-small's smoke (self and cross attention over a random enc)
# read 8.7e-4 sound against 2.9e-2 with the cross output zeroed: glm4-9b's
# limit.  paligemma-3b's smoke (head dim 256, GQA 8, 16 random patches
# before 16 tokens, the patches labelled 0) read 5.3e-3 sound against
# 1.04e-2 with dK zeroed on an H100, while its first-step gradients read
# 1.5e-2 (glm4-9b's 1.6e-2).  That gap is bf16 rounding: on an H100 the
# plain versions in bf16 stand 3.2e-3 to 1.1e-2 from the plain versions in
# fp32 over batch seeds 2-4, the kernels 4.9e-3 to 1.2e-2, and the kernels
# 2.7e-3 to 5.3e-3 from the plain bf16 run
# (scripts/bf16_loss_witness.py).  It holds rwkv6's limit.  The losses
# cannot tell a partial fault from that rounding (dK's second 128-column
# half zeroed read 6.6e-3 at seed 2); the first-step gradients reject it
# leaf by leaf (0.71 against 1.5e-2), and phase parity holds them so
TOL_LOSS_BF16 = {"glm4_9b": 1.5e-3, "rwkv6_3b": 7e-3,
                 "phi3_medium_14b": 1.5e-3, "minitron_8b": 1.5e-3,
                 "command_r_35b": 1.5e-3, "qwen3_moe_235b_a22b": 1.5e-3,
                 "zamba2_1p2b": 1.5e-3, "deepseek_v3_671b": 1.5e-3,
                 "whisper_small": 1.5e-3, "paligemma_3b": 7e-3}
# the training comparisons' setup: exits (1, 2) over client groups
# (1, 1, 2, 2), Adam at lr 1e-3 over a 6-step schedule, 3 steps of 8 x 32
# tokens from ``smoke_batches``
TRAIN_PROFILE = (1, 1, 2, 2)
TRAIN_LR, TRAIN_STEPS, TRAIN_SEQ = 1e-3, 3, 32


# the entropy gate's inputs beyond plain random rows: "misaligned" is a
# view at storage offset 1 with row stride V + 3 (no row on 16 bytes); "max
# last" puts each row's max (8 above the rest) in its last split; "-inf"
# sets a tenth of the entries and the first half of row 0 (whole slices of
# -inf only) and all of row 1 to -inf (see ``gate_logits``)
GATE_LAYOUTS = ("misaligned", "max last", "-inf")
# rows of the cases that reach every cluster size (gate_cluster_vocab)
GATE_CLUSTER_ROWS = 3


def gate_logits(gen, dtype, B: int, V: int, layout: Optional[str] = None):
    """(B, V) logits ~ 3 N(0, 1) in ``dtype`` on ``gen``'s device, laid
    out as ``layout`` (one of ``GATE_LAYOUTS``, or None) says."""
    dev = gen.device
    if layout == "misaligned":
        x = (3 * torch.randn(B, V + 3, generator=gen, device=dev)).to(dtype)
        return x.as_strided((B, V), (V + 3, 1), 1)
    x = (3 * torch.randn(B, V, generator=gen, device=dev)).to(dtype)
    if layout == "max last":
        rows = torch.arange(B, device=dev)
        x[rows, V - 1 - rows % min(V, 8)] = (x.float().amax() + 8).to(dtype)
    elif layout == "-inf":
        # row 0: a tenth of its entries and its first half (whole slices)
        # -inf; row 1 (when there are 3 rows or more): -inf only; the rest
        # finite.  Both kinds of row have H = NaN and never exit
        off = torch.zeros(B, V, dtype=torch.bool, device=dev)
        off[0] = torch.rand(V, generator=gen, device=dev) < 0.1
        off[0, :V // 2] = True
        if B >= 3:
            off[1] = True
        x = x.masked_fill(off, -torch.inf)
    return x


def gate_thresholds(H: torch.Tensor) -> torch.Tensor:
    """Per-row thresholds around the entropies ``H``, some within the
    decision margin of 1e-3."""
    off = torch.tensor([-0.5, 0.5, -1e-4, 1e-4, -2e-3, 2e-3, -3.0, 3.0],
                       device=H.device)
    return H + off.repeat(-(-len(H) // 8))[:len(H)]


def gate_cluster_vocab(splits: int) -> int:
    """A row width at which ``gate_splits`` gives each of
    ``GATE_CLUSTER_ROWS`` rows a cluster of ``splits`` blocks (1..16) on a
    card of 46 SMs or more: ``splits`` x ``MIN_SLICE`` and a 5-element
    tail."""
    return splits * MIN_SLICE + 5


def live_rwkv(params, seed: int = 0) -> None:
    """Redraw every rwkv6 mixer's ``w_lora_b`` ~ N(0, 0.1), ``u`` ~ N(0, 1)
    and ``w_base`` ~ U(-2, 0) in place from ``seed``: the init leaves them
    at 0, 0 and -6, one decay e^-0.0025 everywhere and no bonus, so a
    parity run at init would not exercise the data-dependent decay or u.
    Other families' params are left as they are."""
    gen = {}

    def draw(name, t):
        g = gen.setdefault(t.device, torch.Generator(
            device=t.device).manual_seed(seed))
        if name == "w_lora_b":
            return 0.1 * torch.randn(t.shape, generator=g, device=t.device)
        if name == "u":
            return torch.randn(t.shape, generator=g, device=t.device)
        return -2.0 * torch.rand(t.shape, generator=g, device=t.device)

    def walk(t):
        if isinstance(t, dict):
            live = "w_lora_b" in t and "u" in t
            for k, v in t.items():
                if live and k in ("w_lora_b", "u", "w_base"):
                    v.copy_(draw(k, v))
                else:
                    walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    with torch.no_grad():
        walk(params)


def smoke_batches(cfg, steps: int = TRAIN_STEPS, seq: int = TRAIN_SEQ,
                  seed: int = 2, device="cuda") -> List[dict]:
    """``steps`` batches of 8 x ``seq`` random tokens and labels from numpy
    ``seed``, routed over ``TRAIN_PROFILE``'s client groups.  Audio and
    VLM configs also get the stub frontend's inputs from the same seed
    (``models/frontend.frontend_batch``): random encoder states, or
    ``seq // 2`` random patches before ``seq - seq // 2`` tokens; random,
    not the zeros stub, so cross attention and the projector carry
    gradients."""
    from repro_torch.config import HeteroProfile
    from repro_torch.core.spmd import boundary_ids_for_batch
    from repro_torch.models.frontend import frontend_batch
    rng = np.random.default_rng(seed)
    sids = boundary_ids_for_batch(HeteroProfile(TRAIN_PROFILE), cfg, 8,
                                  device)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (8, seq))
        labels = rng.integers(0, cfg.vocab_size, (8, seq))
        if cfg.arch_type in ("audio", "vlm"):
            b = frontend_batch(cfg, toks, labels, rng, device,
                               patches=seq // 2)
        else:
            b = {"tokens": torch.as_tensor(toks, device=device),
                 "labels": torch.as_tensor(labels, device=device)}
        out.append({**b, "split_ids": sids})
    return out


@dataclass
class StreamParity:
    """Served streams against the plain sequential references."""
    ok: bool = True              # every parting at a near tie
    compared: int = 0            # tokens equal before any parting
    max_dh: float = 0.0          # largest |H - H_plain| over those ticks
    parted: List[str] = field(default_factory=list)


def stream_parity(got: Dict[int, ServeResult], wants: Sequence[ServeResult],
                  tau: float, *, tie_gap: float = TIE_GAP_BF16,
                  tol_h: float = TOL_H_BF16) -> StreamParity:
    """``got[rid]`` (served with the kernels) against ``wants[rid]``
    (``sequential_reference`` or ``sequential_sticky_reference`` on the
    plain versions, which keep each token's top-2 gap), token by token: a
    stream may part only at a token whose plain logits have a top-2 gap
    below ``tie_gap`` or at a gate with |H_plain - tau| <= ``tol_h``, and
    is compared no further.  The caller holds ``max_dh`` against
    ``tol_h``."""
    out = StreamParity()
    for rid, w in enumerate(wants):
        g = got[rid]
        out.ok &= len(g.tokens) == len(w.tokens)
        for i, (a, b) in enumerate(zip(g.tokens, w.tokens)):
            if i:
                out.max_dh = max(out.max_dh,
                                 abs(g.entropy[i - 1] - w.entropy[i - 1]))
                if g.exited[i - 1] != w.exited[i - 1]:
                    near = abs(w.entropy[i - 1] - tau)
                    out.ok &= near <= tol_h
                    out.parted.append(f"gate at |H - tau| = {near:.3g}")
                    break
            if a != b:
                out.ok &= w.top2_gap[i] < tie_gap
                out.parted.append(f"token at top-2 gap {w.top2_gap[i]:.3g}")
                break
            out.compared += 1
    return out


def bf16_step(x: float) -> float:
    """The spacing of bf16 values at ``x``'s magnitude (8 significand
    bits): 2^-6 in [2, 4), 2^-5 in [4, 8)."""
    import math
    if x == 0 or not math.isfinite(x):
        return 0.0
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def session_parity(got: Dict[int, ServeResult], one: Dict[int, ServeResult],
                   alone: Sequence[ServeResult], tau: float, *,
                   tie_gap: float = TIE_GAP_BF16,
                   tol_h: float = TOL_H_BF16,
                   tie_steps: int = 1) -> StreamParity:
    """``got[rid]`` (served over ranks) against ``one[rid]`` (the same
    requests in the one-rank session on the same weights and kernels),
    token by token.  A stream may part from the one-rank session only at
    a near tie: where the request served alone (``alone[rid]``,
    ``sequential_reference``) has a top-2 gap below ``tie_gap`` or of at
    most ``tie_steps`` bf16 steps at its largest logit's magnitude (one:
    the rule TIE_GAP_BF16 encodes for logits in [2, 4), at any magnitude,
    where the two logits' order is one rounding's), where that alone run and
    the one-rank session -- two sound runs -- choose different tokens, or
    at a gate with |H_alone - tau| <= ``tol_h``.
    Where the one-rank session parts from the alone run, the contexts
    differ and the stream is compared no further.  The caller holds
    ``max_dh`` (against the one-rank session) against ``tol_h``."""
    out = StreamParity()
    for rid, w in enumerate(alone):
        g, o = got[rid], one[rid]
        out.ok &= len(g.tokens) == len(o.tokens)
        for i, (a, b) in enumerate(zip(g.tokens, o.tokens)):
            if i:
                out.max_dh = max(out.max_dh,
                                 abs(g.entropy[i - 1] - o.entropy[i - 1]))
                if g.exited[i - 1] != o.exited[i - 1]:
                    near = abs(w.entropy[i - 1] - tau)
                    out.ok &= near <= tol_h
                    out.parted.append(f"gate at |H - tau| = {near:.3g}")
                    break
            sound_tie = b != w.tokens[i]
            if a != b:
                step = (bf16_step(w.top_logit[i]) if w.top_logit
                        else 0.0)
                out.ok &= (sound_tie or w.top2_gap[i] < tie_gap
                           or w.top2_gap[i] <= tie_steps * step)
                out.parted.append(
                    f"token at top-2 gap {w.top2_gap[i]:.3g}"
                    + (f" ({w.top2_gap[i] / step:.3g} bf16 steps at "
                       f"{w.top_logit[i]:.3g})" if step else "")
                    + (" (the one-rank session parts from the request "
                       "alone there)" if sound_tie else ""))
                break
            if sound_tie:
                out.parted.append(f"the one-rank session parts from the "
                                  f"request alone at top-2 gap "
                                  f"{w.top2_gap[i]:.3g}")
                break
            out.compared += 1
    return out


@dataclass
class Routes:
    """The MoE routing of one run, recorded for another (``pinned_routes``):
    each ``models.moe.route`` call's top-k choice in call order (under
    ``vmap``, every lane's), and, for a replaying run, how many of its
    token choices its own top-k would have made otherwise.  A replaying
    run that holds a part of the recorded run's lanes names them in
    ``lanes`` (a slice, set by the caller before each step); under a data
    split each rank replays its own rows of the batch."""
    choices: List[torch.Tensor] = field(default_factory=list)
    calls: int = 0
    flipped: int = 0
    tokens: int = 0
    lanes: Optional[slice] = None


def _pin(own: torch.Tensor, routes: Routes, replay: bool,
         lanes: bool) -> torch.Tensor:
    if not replay:
        routes.choices.append(own.clone())
        return own
    from repro_torch.models import sync_stats
    topi = routes.choices[routes.calls]
    routes.calls += 1
    if lanes and routes.lanes is not None:
        topi = topi[routes.lanes]
    if topi.shape[-2] != own.shape[-2]:
        # a data split: this rank's token rows of the recorded group
        _, _, index = sync_stats.batch_group()
        n = own.shape[-2]
        topi = topi.narrow(-2, index * n, n)
    same = (own.sort(-1).values == topi.sort(-1).values).all(-1)
    routes.flipped += int((~same).sum())
    routes.tokens += same.numel()
    return topi.to(own.device)


class _PinFn(torch.autograd.Function):
    """One ``route`` call's choice recorded or replayed; the ``vmap`` rule
    records and replays the lanes stacked."""

    @staticmethod
    def forward(own, routes, replay):
        return _pin(own, routes, replay, lanes=False)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def vmap(info, in_dims, own, routes, replay):
        if in_dims[0] is None:
            return _pin(own, routes, replay, lanes=False), None
        return _pin(own.movedim(in_dims[0], 0), routes, replay,
                    lanes=True), 0


@contextmanager
def pinned_routes(routes: Routes, replay: bool):
    """MoE routing held fixed across two runs that must differ in their
    kernels, or in their ranks, only.  Top-k routing is discontinuous:
    where two runs' hidden states straddle a router near-tie, a token
    takes other experts and its output moves by O(1), whatever the
    kernels' accuracy.  ``replay=False`` records each ``route`` call's
    choice; ``replay=True`` makes the i-th call choose the i-th recorded
    experts, its weights (renormalised) and aux loss from its own
    probabilities (``models.moe.aux_loss``, whole-batch under a data
    split), and counts the tokens whose own top-k differs.  Every run
    between the two must call ``route`` in the same order (the same
    model, batches and steps); under ``vmap`` the lanes are recorded
    together (``Routes.lanes``).  The router's own arithmetic is
    ``models.moe``'s."""
    from repro_torch.models import moe
    real = moe.route

    def recording(params, x, m):
        topi, topw, aux = real(params, x, m)
        return _PinFn.apply(topi, routes, False), topw, aux

    def replaying(params, x, m):
        probs = moe.router_probs(params, x, m)
        own = probs.topk(m.top_k, dim=-1).indices
        topi = _PinFn.apply(own, routes, True)
        topv = probs.gather(-1, topi)
        topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
        return topi, topv.to(x.dtype), moe.aux_loss(probs, topi, m)

    if replay:
        routes.calls = routes.flipped = routes.tokens = 0
    moe.route = replaying if replay else recording
    try:
        yield routes
    finally:
        moe.route = real


def grad_rel_errors(got: Sequence[Optional[torch.Tensor]],
                    want: Sequence[Optional[torch.Tensor]]) -> List[float]:
    """Each leaf's ||got - want|| / ||want|| in fp32 (0 where neither side
    has a gradient, inf where only one has, or where ``want`` is 0 and
    ``got`` is not)."""
    out = []
    for g, w in zip(got, want):
        if g is None or w is None:
            out.append(0.0 if g is None and w is None else float("inf"))
            continue
        d = (g.float() - w.float()).norm().item()
        n = w.float().norm().item()
        out.append(d / n if n > 0 else (0.0 if d == 0 else float("inf")))
    return out


# the paper's loop on the card against the CPU (chip_smoke.py phase paper,
# the card tests): the ResNet smoke with clients cut at (3, 3, 4, 5), 2
# rounds of 2 local epochs at batch 32, Adam at the paper's eta_max 1e-3,
# both devices from one round-0 state, fp32 (TF32 off).  cuDNN's and the
# CPU's convolutions round differently; Adam's first steps move each
# element by ~lr whatever its gradient's size and BatchNorm at batch 32
# carries a change on, so the two runs drift apart, more than a kernel
# would at one step.  The limits sit between the sound readings and those
# of a planted fault (client 0's server left out of Eq. (1)), read on an
# H100 (PERF.md, section 6)
PAPER_SPLITS = (3, 3, 4, 5)
PAPER_ROUNDS, PAPER_EPOCHS, PAPER_BATCH, PAPER_LR = 2, 2, 32, 1e-3
# per-round client and server losses, largest |card - CPU|: sound 2.7e-7
# (averaging), 7.2e-7 (sequential)
TOL_PAPER_LOSS = 1e-5
# trainables, ||card - CPU|| / ||CPU - round 0|| over all clients and over
# all servers, the drift against how far training moved them: sound
# 1.6e-4 / 9.7e-5 (averaging clients / servers), 2.0e-3 (sequential's
# shared server); the fault 0.73
TOL_PAPER_PARAMS = 2e-2


def paper_data(seed: int = 0):
    """The parity run's client shards and its test set (1012 images: one
    batch of 512 and a tail batch of 500 at evaluation batch 512)."""
    from repro_torch.data.pipeline import ClientPartitioner
    from repro_torch.data.synthetic import SyntheticImageDataset
    n = len(PAPER_SPLITS)
    ds = SyntheticImageDataset(
        num_classes=10, image_size=32,
        train_size=n * PAPER_ROUNDS * PAPER_EPOCHS * PAPER_BATCH,
        test_size=1012, seed=seed)
    return ClientPartitioner(n, seed=seed).split(*ds.train), ds.test, \
        ds.augment


def paper_session(device, strategy: str, data, augment, state=None, *,
                  engine: str = "reference", grad_mode: str = "eq1"):
    """A ``TrainSession`` of the parity run on ``device``."""
    from repro_torch.api.session import TrainSession
    from repro_torch.config import (HeteroProfile, OptimizerConfig,
                                    SplitEEConfig)
    from repro_torch.configs import resnet18_cifar
    from repro_torch.core.splitee import ResNetSplitModel
    model = ResNetSplitModel(resnet18_cifar.smoke(), device=device)
    return TrainSession(
        model, SplitEEConfig(profile=HeteroProfile(PAPER_SPLITS),
                             strategy=strategy, aggregate_every=2),
        OptimizerConfig(lr=PAPER_LR,
                        total_steps=PAPER_ROUNDS * PAPER_EPOCHS),
        data, PAPER_BATCH, engine=engine, grad_mode=grad_mode,
        augment=augment,
        state=None if state is None else state.to(model.device))


def paper_drift(got, want, start) -> Dict[str, float]:
    """``||got - want|| / ||want - start||`` over every client's trainables
    and over every server's, and the largest |got - want| of the BatchNorm
    running statistics (TrainStates; ``want`` and ``start`` on the same
    device)."""
    from repro_torch.tree import tree_leaves

    def flat(trees, device):
        leaves = [t.detach().to(device, torch.float64).flatten()
                  for t in tree_leaves(trees)]
        return torch.cat(leaves) if leaves else torch.zeros(0, device=device)

    out = {}
    dev = next(tree_leaves(want.clients)).device
    for side in ("clients", "servers"):
        g = flat([n["trainable"] for n in getattr(got, side)], dev)
        w = flat([n["trainable"] for n in getattr(want, side)], dev)
        s = flat([n["trainable"] for n in getattr(start, side)], dev)
        out[side] = float((g - w).norm() / (w - s).norm())
        bn = (flat([n["state"] for n in getattr(got, side)], dev)
              - flat([n["state"] for n in getattr(want, side)], dev))
        out[f"{side}_bn"] = float(bn.abs().max()) if bn.numel() else 0.0
    return out


@contextmanager
def dropped_aggregation():
    """A control: Eq. (1) of the reference engine leaves client 0's server
    as it was, while the block runs."""
    from repro_torch.api import reference_engine
    real = reference_engine.cross_layer_aggregate

    def fault(models, splits, **kw):
        out = real(models, splits, **kw)
        out[0] = models[0]
        return out

    reference_engine.cross_layer_aggregate = fault
    try:
        yield
    finally:
        reference_engine.cross_layer_aggregate = real


@contextmanager
def dropped_lane():
    """A control: the fused engine's stacked Eq. (1) leaves the first lane
    of its shallowest cohort (client 0 under ``PAPER_SPLITS``) out of the
    mean and as it was, while the block runs."""
    from repro_torch.api import fused_engine
    from repro_torch.tree import tree_map
    real = fused_engine.stacked_cross_layer_aggregate

    def fault(stacked, lanes):
        li = min(stacked)
        real({**stacked, li: tree_map(lambda x: x[1:], stacked[li])},
             {**lanes, li: list(lanes[li])[1:]})
        return stacked

    fused_engine.stacked_cross_layer_aggregate = fault
    try:
        yield
    finally:
        fused_engine.stacked_cross_layer_aggregate = real


@contextmanager
def unreduced_lanes():
    """A control: the spmd engine's Eq. (1) divides each rank's partial
    sums over its own lanes, without summing them over the lanes group,
    while the block runs."""
    from repro_torch.api import spmd_engine
    real = spmd_engine.partial_cross_layer_aggregate

    def fault(stacked, lanes, counts, owned, reduce, masks=None):
        return real(stacked, lanes, counts, owned, lambda ts: None, masks)

    spmd_engine.partial_cross_layer_aggregate = fault
    try:
        yield
    finally:
        spmd_engine.partial_cross_layer_aggregate = real


@contextmanager
def unsynced_batch_stats():
    """A control: under a data split the spmd engine's BatchNorm takes
    each rank's batch statistics of its own rows, while the block runs."""
    import contextlib

    from repro_torch.api import spmd_engine
    real = spmd_engine.synced_batch_stats
    spmd_engine.synced_batch_stats = (
        lambda *a, **kw: contextlib.nullcontext())
    try:
        yield
    finally:
        spmd_engine.synced_batch_stats = real


@contextmanager
def unsummed_expert_loads():
    """A control: under a data split each rank's MoE blocks take their
    expert loads (capacity and the aux loss's f) from their own rows
    alone, not summed over the batch ranks, while the block runs."""
    from repro_torch.models import moe
    real = moe.summed_loads
    moe.summed_loads = lambda load: (torch.zeros_like(load), load)
    try:
        yield
    finally:
        moe.summed_loads = real


@contextmanager
def uncombined_parts():
    """A control: each rank of a decode ring split over ranks takes the
    attention over its own part of the ring as the whole
    (``models.attention.combine_parts`` skipped), while the block runs."""
    from repro_torch.models import attention
    real = attention.combine_parts
    attention.combine_parts = lambda out, lse, has_keys, part: out
    try:
        yield
    finally:
        attention.combine_parts = real


@contextmanager
def unreduced_row_products():
    """A control: over a ``"model"`` group each rank takes its partial
    sum of a row-parallel product (and of the vocab-split embedding) as
    the whole (``launch.tensor_parallel.reduce_out`` skipped), while the
    block runs."""
    from repro_torch.launch import tensor_parallel as tp
    real = tp.reduce_out
    tp.reduce_out = lambda x, g: x
    try:
        yield
    finally:
        tp.reduce_out = real


@contextmanager
def per_rank_sumexp():
    """A control: the vocab-parallel cross entropy takes each rank's sum
    of exponentials over its own chunk of the vocab as the whole row's
    (the gold logit still summed), while the block runs."""
    from repro_torch.launch import tensor_parallel as tp
    real = tp._sumexp_and_gold

    def per_rank(both, g):
        return torch.stack([both[0], real(both, g)[1]])
    tp._sumexp_and_gold = per_rank
    try:
        yield
    finally:
        tp._sumexp_and_gold = real


@contextmanager
def unsummed_expert_parts():
    """A control: over a ``"model"`` group whose expert stacks are split
    over the grid, each rank takes the combined output of its own experts
    as the whole MoE output (``models.moe.sum_expert_parts`` skipped),
    while the block runs."""
    from repro_torch.models import moe
    real = moe.sum_expert_parts
    moe.sum_expert_parts = lambda out, g: out
    try:
        yield
    finally:
        moe.sum_expert_parts = real


@contextmanager
def local_slots():
    """A control: under expert parallelism each rank writes its entries
    at their rank among its own rows' entries of their expert, not at
    their position in the whole batch (``models.moe.global_positions``
    skipped), while the block runs."""
    from repro_torch.models import moe
    real = moe.global_positions
    moe.global_positions = lambda before, rank: rank
    try:
        yield
    finally:
        moe.global_positions = real


@contextmanager
def reduced_expert_grads():
    """A control: the spmd engine all-reduces an expert stack's gradient
    over every batch axis, also those it keeps its chunk over, where the
    owner's gradient already sums every rank's entries
    (``api.spmd_engine.grad_reduce_axes`` without its exception)."""
    from repro_torch.api import spmd_engine
    real = spmd_engine.grad_reduce_axes
    spmd_engine.grad_reduce_axes = lambda batch_axes, experts: tuple(
        batch_axes)
    try:
        yield
    finally:
        spmd_engine.grad_reduce_axes = real


@contextmanager
def misrouted_entries():
    """A control: under expert parallelism each entry is sent to the
    rank that holds the next chunk of the experts
    (``models.moe.expert_owner`` off by one chunk), while the block
    runs."""
    from repro_torch.models import moe
    real = moe.expert_owner
    moe.expert_owner = lambda chunk, chunks, P: real(
        (chunk + 1) % chunks, chunks, P)
    try:
        yield
    finally:
        moe.expert_owner = real


@contextmanager
def pooled_slots():
    """A control: serving over the batch ranks, each rank routes its
    slots as one group, so the capacity and the drops are taken over
    them together (``models.moe.slot_groups`` pooled), while the block
    runs."""
    from repro_torch.models import moe
    real = moe.slot_groups
    moe.slot_groups = lambda groups, first, total: (
        1, first // groups, total // groups)
    try:
        yield
    finally:
        moe.slot_groups = real


@contextmanager
def shifted_chunks():
    """A control: a run of the spmd engine that starts from the engine's
    own chunks re-cuts its carry from the whole state with this rank's
    chunk index off by one (every split dim of every leaf takes the next
    rank's chunk, and a cohort whose lanes are spread the next rank's
    lanes), where ``api.spmd_engine.resume_carry`` takes the chunks as
    they are."""
    from repro_torch.api import spmd_engine
    from repro_torch.launch.meshcomm import _gather_dims
    real = spmd_engine.resume_carry

    def shifted(engine, state):
        whole = state.whole()
        state.take()
        comm = engine.comm

        def shard(t, spec):
            out = t
            for d, axes in _gather_dims(spec):
                n = comm.size(axes)
                c = t.shape[d] // n
                out = out.narrow(d, (comm.index(axes) + 1) % n * c, c)
            return out if out is t else out.clone()
        local = dict(engine._local)
        for li, lanes in local.items():
            axes = engine._lane_axes_of(li)
            if axes:
                n, k = comm.size(axes), engine._counts[li]
                j = (comm.index(axes) + 1) % n
                engine._local[li] = list(range(j * k // n, (j + 1) * k // n))
        engine._shard = shard
        try:
            return engine._cut(whole)
        finally:
            del engine._shard
            engine._local = local
    spmd_engine.resume_carry = shifted
    try:
        yield
    finally:
        spmd_engine.resume_carry = real


@contextmanager
def per_rank_norm_squares():
    """A control: RWKV6's output norm over a row split over the model
    group takes each rank's sum of squares over its own chunk as the whole
    row's (``models.ssm._norm_squares`` skipped), while the block runs."""
    from repro_torch.models import ssm
    real = ssm._norm_squares
    ssm._norm_squares = lambda s: s
    try:
        yield
    finally:
        ssm._norm_squares = real


# the fused engine's lanes on the card (chip_smoke.py phase fused, the card
# tests): BackboneSplitModel on the bf16 smokes at full head width, two
# lanes at each of glm4-9b's cuts 1 and 2, three at rwkv6-3b's one cut 2,
# two at qwen3-moe's one cut 2 and two at zamba2-1.2b's one cut 2 (its
# shared attention block on the server lanes; phase lifecycle's
# populations take
# POP_LANE_FAMILIES), LANE_BATCH sequences of LANE_SEQ tokens a client (T * G = 64 query
# rows: the attention forward's tile route), LANE_ROUNDS rounds of fused
# eq1 at TRAIN_LR, Eq. (1) every round.  The limits are those of the
# backbones' bf16 train comparisons above (TOL_LOSS_BF16, TOL_GRAD_BF16),
# read on losses averaged over 8 x 32 = 256 tokens; a round's loss here
# averages each client's LANE_BATCH last positions, and 64 of them give
# glm4-9b's four clients the same 256 (at 8 a client, 32 rows, an H100
# read 1.6e-3 at round 0, before any update: the forward's bf16 rounding)
LANE_SPLITS = {"glm4_9b": (1, 1, 2, 2), "rwkv6_3b": (2, 2, 2),
               "qwen3_moe_235b_a22b": (2, 2), "zamba2_1p2b": (2, 2)}
POP_LANE_FAMILIES = ("glm4_9b", "rwkv6_3b")
LANE_SEQ, LANE_BATCH, LANE_ROUNDS = 32, 64, 2
# sequences a lane at lane_sites' cross-attention site (whisper-small's
# training batch is 12)
LANE_CROSS_BATCH = 4


def backbone_session(family: str, kernels: str, device, state=None, *,
                     engine: str = "fused", population: bool = False,
                     mesh=None):
    """A ``TrainSession`` of ``BackboneSplitModel`` on ``family``'s bf16
    smoke with ``kernels`` ("auto": the kernels; "ref": the plain
    versions), rwkv6 decays and bonus made live (:func:`live_rwkv`).
    ``population``: the lanes draw from a churning population of twice as
    many clients (:data:`POP_CHURN`) over a dataset twice the size.
    ``mesh``: the spmd engine's (with ``engine="spmd"``)."""
    from repro_torch import configs
    from repro_torch.api.session import TrainSession
    from repro_torch.config import (HeteroProfile, OptimizerConfig,
                                    SplitEEConfig)
    from repro_torch.core.backbone_splitee import BackboneSplitModel
    from repro_torch.data.pipeline import ClientPartitioner
    from repro_torch.data.synthetic import SyntheticSeqClsDataset
    cfg = configs.get(family).smoke_bf16().with_(kernels=kernels)
    splits = LANE_SPLITS[family]
    model = BackboneSplitModel(cfg, device=device)
    live_rwkv(model.full_params)
    ds = SyntheticSeqClsDataset(vocab_size=cfg.vocab_size, seq_len=LANE_SEQ,
                                num_classes=8, train_size=len(splits)
                                * LANE_BATCH * LANE_ROUNDS
                                * (2 if population else 1), test_size=64,
                                seed=0)
    data = pop = None
    if population:
        from repro_torch.population import ClientPopulation
        pop = ClientPopulation.dirichlet(*ds.train, 2 * len(splits), splits,
                                         min_shard=LANE_BATCH, **POP_CHURN)
    else:
        data = ClientPartitioner(len(splits)).split(*ds.train)
    return TrainSession(
        model, SplitEEConfig(profile=HeteroProfile(splits),
                             strategy="averaging"),
        OptimizerConfig(lr=TRAIN_LR, total_steps=2 * LANE_ROUNDS),
        data, LANE_BATCH, engine=engine, state=state, population=pop,
        mesh=mesh)


def cohort_first_grads(sess) -> List[Optional[torch.Tensor]]:
    """The gradients of the first fused step of ``sess`` from its state:
    every cohort's client then server leaves, in ``tree_leaves`` order
    (``core.spmd.make_cohort_grad_step`` on each client's first batch)."""
    from repro_torch.api.engines import DataCursor, cohort_layout
    from repro_torch.core.spmd import make_cohort_grad_step
    ctx, st, model = sess.ctx, sess.state, sess.model
    cursor = DataCursor(ctx.client_data, ctx.batch_size, ctx.seed)
    cursor.align(st.batches_drawn)
    lis, lanes = cohort_layout(ctx.profile.split_layers)
    out: List[Optional[torch.Tensor]] = []
    for li in lis:
        batches = [cursor.draw(i) for i in lanes[li]]
        x, y = (torch.from_numpy(np.stack(b)).to(model.device)
                for b in zip(*batches))
        gc, gs = make_cohort_grad_step(model, li)(
            model.stack_clients([st.clients[i] for i in lanes[li]]),
            model.stack_clients([st.servers[i] for i in lanes[li]]),
            x, y)[:2]
        out += list(gc) + list(gs)
    return out


def lane_loop_gaps(site, inputs: Sequence[torch.Tensor], seed: int = 1
                   ) -> Dict[str, float]:
    """``site`` under ``torch.func.vmap`` over the lanes (dim 0 of every
    input) against a per-lane loop of the same site, both differentiated
    with one random cotangent per output: the largest gap of the outputs
    and of the inputs' gradients, and the largest magnitude of each (the
    loop's), all in fp32."""
    from torch.func import vmap
    xs = [t.clone().requires_grad_(True) for t in inputs]
    outs = vmap(site)(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gen = torch.Generator(device=inputs[0].device).manual_seed(seed)
    cots = [torch.randn(o.shape, generator=gen, device=o.device).to(o.dtype)
            for o in outs]
    grads = torch.autograd.grad(outs, xs, cots)
    r = dict(out=0.0, grad=0.0, out_scale=0.0, grad_scale=0.0)
    for j in range(len(inputs[0])):
        lane = [t.detach()[j].clone().requires_grad_(True) for t in inputs]
        want = site(*lane)
        want = want if isinstance(want, tuple) else (want,)
        wgrads = torch.autograd.grad(want, lane, [c[j] for c in cots])
        for kind, got_w in (("out", zip([o[j] for o in outs], want)),
                            ("grad", zip([g[j] for g in grads], wgrads))):
            for a, b in got_w:
                a, b = a.detach().float(), b.detach().float()
                r[kind] = max(r[kind], float((a - b).abs().max()))
                r[f"{kind}_scale"] = max(r[f"{kind}_scale"],
                                         float(b.abs().max()))
    return r


def lane_sites(device, seed: int = 0) -> Dict[str, tuple]:
    """The training sites of the cuda backend, each with lane-stacked
    inputs (bf16, head dim 64): attention at the backbone legs' shapes
    (2 lanes, (8, LANE_SEQ, 4, 64) queries, 2 KV heads, causal); cross
    attention at whisper-small's training shape with the batch cut to
    LANE_CROSS_BATCH (2 lanes, (LANE_CROSS_BATCH, 448, 12, 64) queries
    against 1500 keys, ragged at 64, non-causal); and the wkv (3 lanes,
    (8, LANE_SEQ, 2, 64), chunk 16, decays in [-2, 0), a bonus u of each
    lane's own)."""
    from repro_torch.kernels.dispatch import get_backend
    be = get_backend("auto")
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    B, T = LANE_BATCH, LANE_SEQ
    attn = [randn(2, B, T, 4, 64), randn(2, B, T, 2, 64),
            randn(2, B, T, 2, 64)]
    Bc = LANE_CROSS_BATCH
    cross = [randn(2, Bc, 448, 12, 64), randn(2, Bc, 1500, 12, 64),
             randn(2, Bc, 1500, 12, 64)]
    log_w = -2 * torch.rand(3, B, T, 2, 64, generator=gen, device=device)
    wkv = [randn(3, B, T, 2, 64), randn(3, B, T, 2, 64),
           randn(3, B, T, 2, 64), log_w, randn(3, 2, 64, dtype=torch.float32)]
    return {"attention": (lambda q, k, v: be.attention(q, k, v, causal=True),
                          attn),
            "cross": (lambda q, k, v: be.attention(q, k, v, causal=False),
                      cross),
            "wkv": (lambda r, k, v, lw, u: be.wkv(r, k, v, lw, u, chunk=16),
                    wkv)}


# client populations (chip_smoke.py phase lifecycle, the population tests):
# the churn settings of benchmarks/population_bench.py's churn leg
POP_CHURN = dict(alpha=0.5, participation_rate=0.7, churn_seed=3,
                 straggler_rate=0.2)
# the ResNet smoke under a churning population of POP_SMOKE_CLIENTS over
# PAPER_SPLITS' four slots, Eq. (1) every round, POP_SMOKE_ROUNDS rounds of
# PAPER_EPOCHS at PAPER_BATCH, the card against the CPU at the limits of
# the paper's loop (TOL_PAPER_LOSS, TOL_PAPER_PARAMS), over as many rounds
# as they were read on.  Further on the fp32 runs part: at the round where
# a slot takes its first Adam step late, that step moves each element by
# ~lr whatever its gradient's size, so the devices' differing rounding of
# small gradients becomes +-lr, and Eq. (1) spreads it over the servers
# (an H100 read the servers' drift 1.8e-3 after round 1, 2.2e-2 after
# round 2, when slot 0 first stepped, 2.8e-2 after round 3; the fixed
# cohort 5.6e-3 after round 3; PERF.md section 6).  In float64 the runs
# stay together (tests/test_torch_cuda.py)
POP_SMOKE_CLIENTS, POP_SMOKE_ROUNDS = 8, 2


def population_smoke_data(seed: int = 0, rounds: int = POP_SMOKE_ROUNDS):
    """The population smoke's images: POP_SMOKE_CLIENTS shards' worth of
    PAPER_BATCH x ``rounds`` x PAPER_EPOCHS images."""
    from repro_torch.data.synthetic import SyntheticImageDataset
    ds = SyntheticImageDataset(
        num_classes=10, image_size=32,
        train_size=(POP_SMOKE_CLIENTS * PAPER_BATCH * rounds
                    * PAPER_EPOCHS), test_size=8, seed=seed)
    return ds.train


def population_smoke(x, y):
    """The smoke's churning population of POP_SMOKE_CLIENTS over
    PAPER_SPLITS' slots."""
    from repro_torch.population import ClientPopulation
    return ClientPopulation.dirichlet(x, y, POP_SMOKE_CLIENTS, PAPER_SPLITS,
                                      min_shard=PAPER_BATCH, **POP_CHURN)


def population_session(device, x, y, state=None, *,
                       rounds: int = POP_SMOKE_ROUNDS,
                       population: Optional[str] = "churn"):
    """A ``TrainSession`` of the ResNet smoke on ``device`` under the
    churning population (fused engine, Eq. (1) every round, the schedule
    over ``rounds``).  ``population=None``: the fixed cohort of
    PAPER_SPLITS on the same images, one shard a slot; ``"full"``: those
    shards as a population in which every slot always takes part."""
    from repro_torch.api.session import TrainSession
    from repro_torch.config import (HeteroProfile, OptimizerConfig,
                                    SplitEEConfig)
    from repro_torch.configs import resnet18_cifar
    from repro_torch.core.splitee import ResNetSplitModel
    from repro_torch.data.pipeline import ClientPartitioner
    model = ResNetSplitModel(resnet18_cifar.smoke(), device=device)
    from repro_torch.population import ClientPopulation
    shards = ClientPartitioner(len(PAPER_SPLITS)).split(x, y)
    pop = {"churn": lambda: population_smoke(x, y),
           "full": lambda: ClientPopulation.from_shards(shards,
                                                        PAPER_SPLITS),
           None: lambda: None}[population]()
    data = shards if pop is None else None
    return TrainSession(
        model, SplitEEConfig(profile=HeteroProfile(PAPER_SPLITS),
                             strategy="averaging", aggregate_every=1),
        OptimizerConfig(lr=PAPER_LR, total_steps=rounds * PAPER_EPOCHS),
        data, PAPER_BATCH, engine="fused", population=pop,
        state=None if state is None else state.to(model.device))


def slot_gaps(got, want) -> Dict[str, List[float]]:
    """||got - want|| of each slot's client and server trainables
    (TrainStates; ``want``'s device)."""
    from repro_torch.tree import tree_leaves
    dev = next(tree_leaves(want.clients)).device

    def gap(a, b):
        return float(sum(((x.detach().to(dev, torch.float64)
                           - y.detach().to(torch.float64)) ** 2).sum()
                         for x, y in zip(tree_leaves(a), tree_leaves(b)))
                     ** 0.5)

    return {side: [gap(a["trainable"], b["trainable"])
                   for a, b in zip(getattr(got, side), getattr(want, side))]
            for side in ("clients", "servers")}


@contextmanager
def inactive_lanes_counted():
    """A control: the masked Eq. (1) counts every lane, active or not,
    while the block runs."""
    from repro_torch.api import fused_engine
    real = fused_engine.masked_stacked_cross_layer_aggregate

    def fault(stacked, masks, lanes):
        return real(stacked, {li: torch.ones_like(m)
                              for li, m in masks.items()}, lanes)

    fused_engine.masked_stacked_cross_layer_aggregate = fault
    try:
        yield
    finally:
        fused_engine.masked_stacked_cross_layer_aggregate = real


@contextmanager
def masked_lane_left_out():
    """A control: the masked Eq. (1) leaves the first lane of its
    shallowest cohort out of the mean (the lane still takes the mean),
    while the block runs."""
    from repro_torch.api import fused_engine
    real = fused_engine.masked_stacked_cross_layer_aggregate

    def fault(stacked, masks, lanes):
        li = min(masks)
        m = masks[li].clone()
        m[0] = 0.0
        return real(stacked, {**masks, li: m}, lanes)

    fused_engine.masked_stacked_cross_layer_aggregate = fault
    try:
        yield
    finally:
        fused_engine.masked_stacked_cross_layer_aggregate = real


@contextmanager
def unaligned_cursor():
    """A control: a population cursor rebuilt for a restored session
    starts at round 0 instead of replaying up to the session's round."""
    from repro_torch.population import PopulationCursor
    real = PopulationCursor.align

    def fault(self, t, local_epochs):
        if self._iters is None or self._round != int(t):
            self._rebuild()

    PopulationCursor.align = fault
    try:
        yield
    finally:
        PopulationCursor.align = real


@contextmanager
def advancing_masked_step():
    """A control: the masked cohort step's Adam advances the step of every
    lane, masked or not, while the block runs."""
    from repro_torch.core import spmd
    from repro_torch.optim import AdamState
    real = spmd.adam_update

    def fault(params, grads, state, cfg, lr, lr_scale_tree=None, *,
              lanes=False, mask=None):
        params, new = real(params, grads, state, cfg, lr, lr_scale_tree,
                           lanes=lanes, mask=mask)
        if mask is not None:
            new = AdamState(step=state.step + 1, m=new.m, v=new.v)
        return params, new

    spmd.adam_update = fault
    try:
        yield
    finally:
        spmd.adam_update = real


def masked_lane_gaps(sess, mask: Sequence[float]) -> Dict[str, float]:
    """One masked cohort step of ``sess``'s first cohort from its state on
    its first client's batch repeated over the lanes, ``mask`` over the
    lanes: the largest |change| of the masked lanes' parameters, moments,
    BatchNorm statistics and Adam steps (all must read 0), and the largest
    |change| of the active lanes' parameters (must not)."""
    from repro_torch.api.engines import cohort_layout
    from repro_torch.api.fused_engine import _stack_opts
    from repro_torch.core.spmd import make_masked_cohort_step
    from repro_torch.tree import tree_leaves
    ctx, st, model = sess.ctx, sess.state, sess.model
    lis, lanes = cohort_layout(ctx.profile.split_layers)
    li = lis[0]
    ids = lanes[li]
    k = len(ids)
    x, y = (torch.from_numpy(np.stack([a] * k)).to(model.device)
            for a in ctx.client_data[ids[0]])
    x, y = x[:, :ctx.batch_size], y[:, :ctx.batch_size]
    carry = (model.stack_clients([st.clients[i] for i in ids]),
             _stack_opts([st.client_opts[i] for i in ids]),
             model.stack_clients([st.servers[i] for i in ids]),
             _stack_opts([st.server_opts[i] for i in ids]))

    def flat(c):
        nets = [c[0]["trainable"], c[2]["trainable"]]
        rest = [c[0]["state"], c[2]["state"], c[1].m, c[1].v, c[3].m,
                c[3].v]
        return (list(tree_leaves(nets)), list(tree_leaves(rest)),
                [c[1].step, c[3].step])

    before = [[t.clone() for t in part] for part in flat(carry)]
    m = torch.tensor(mask, dtype=torch.float32, device=model.device)
    out = make_masked_cohort_step(model, ctx.opt_cfg, li, ctx.grad_mode)(
        *carry, x, y, 1e-3, 1e-3, m)
    off = [j for j in range(k) if mask[j] == 0]
    on = [j for j in range(k) if mask[j] != 0]
    gaps = {"masked": 0.0, "masked_steps": 0.0, "active": 0.0}
    for part, (was, now) in enumerate(zip(before, flat(out[:4]))):
        for a, b in zip(was, now):
            d = (a.double() - b.double()).abs()
            d = d.reshape(k, -1) if d.ndim else d.reshape(1, 1)
            key = "masked_steps" if part == 2 else "masked"
            gaps[key] = max(gaps[key], float(d[off].max()) if off else 0.0)
            if part == 0 and on:
                gaps["active"] = max(gaps["active"], float(d[on].max()))
    return gaps

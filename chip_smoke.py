"""Drives the PyTorch/CUDA port on one CUDA card and checks it.

    python3 chip_smoke.py                    # every phase, one card
    python3 chip_smoke.py --phases build,kernels

Phases:
  build    builds every CUDA kernel from the sources in the checkout
           (one nvcc per source, all started together) and prints the card's
           name and power limit;
  kernels  holds each kernel against its plain PyTorch version on the card:
           the gate (each row's vocab split over a cluster) at glm4-9b's,
           rwkv6-3b's, phi3's (100352), qwen3-moe's (151936) and
           minitron's and command-r's (256000), zamba2-1.2b's (32000) and
           deepseek-v3's (129280) serve shapes, fp32, 1 and
           300 rows, vocab tails, rows not on 16 bytes, each row's max in
           its last split, -inf entries (H = NaN where the plain version's
           is, compared with equal_nan, and no exit) and every cluster
           size 1-16 (row widths at which the wrapper picks each), each
           launched twice (the same bits), and a dropped slice it must
           reject;
           attention at the serve and train shapes of
           full-width glm4-9b plus sliding-window, non-causal, head-dim 32
           and fp32 cases; the attention forward's three routes (decode:
           mma.sync, keys split across a cluster; tile: wgmma; row) and
           the dK/dV and dQ routes (tile: wgmma; row), bf16 at head dims 64
           and 128, GQA 1, 4 and 16, causal and not, windows, per-row
           kv_valid of 1, ragged and full, ragged Tq and Tk, shapes just
           below and above the forward's 64-row threshold, prefill (tile)
           and decode (decode route) at command-r's GQA 8 (H 64, Hkv 8),
           phi3's H 40 / Hkv 10 and qwen3-moe's H 64 / Hkv 4, zamba2-1.2b's
           shared block at GQA 1 (H = Hkv = 32, D 64: prefill on the tile
           route, decode on the decode route, the train shape
           (12,32,512,64) forward with LSE, dK/dV and dQ), head dim 256
           on all three forward routes and both backward tile routes (GQA
           8: paligemma-3b's prefill, ragged prefill, window, decode tick,
           train shape (4,8,512,256) with LSE, dK/dV and dQ; fp32 on the
           row routes), whisper-small's cross attention at Tq != Tk,
           non-causal over 1500 source frames (decode (8,12,1,64), train
           (12,12,448,64) with LSE, dK/dV and dQ), a 4096-key cache
           at every split count the decode rule picks, dQ with delta given
           and fused (the delta it writes against the plain one), the
           decode, dK/dV and dQ kernels also bit for bit across two
           launches, and the row routes forced at the main shapes; the wkv
           forward and backward at chunks 8-128, fp32 and bf16, ragged T,
           head dims 16-64, the rwkv6-3b train and prefill shapes, bit for
           bit across two launches, and decays that overflow the plain
           chunked form (against the token oracle); the decode route
           (bf16) and the row route (fp32) with the LSE on one part of a
           decode ring split over ranks, rows with kv_valid 0 among them
           (their LSE must read "no key" on both sides, which the parts'
           combine weights 0); and
           both autograd sites of training against autograd of the plain
           forward;
  parity   smoke configs in fp32: the glm4-9b, zamba2-1.2b,
           deepseek-v3-671b, whisper-small and paligemma-3b ServeSessions
           against the port's sequential references, token and gate
           exact; the rwkv6
           ServeSession with the kernels against the plain versions; train
           steps with the kernels against the plain versions (glm4-9b: eq1,
           sum, eq1 with remat; rwkv6: eq1, eq1 with remat); then the bf16
           smokes at full head width (glm4-9b head dim 64: the attention
           tile and decode routes; rwkv6 head dim 64, chunk 16: the wkv
           kernels; and since the MoE slice every ported config's bf16
           smoke: phi3-medium-14b and minitron-8b at GQA 4, command-r-35b at
           GQA 8, qwen3-moe with fp32 routers; since the Mamba2/MLA slice
           zamba2-1.2b's shared block at GQA 1, head dim 64, and
           deepseek-v3's MLA, which runs no kernel: its gate is the one
           kernel, and its planted fault drops the MLA rope half; since
           the cross-attention slice whisper-small (self and cross
           attention, GQA 1, head dim 64; its gradients and losses on a
           random enc, their planted fault the cross-attention output
           zeroed: serving runs the zeros stub, where cross attention
           adds exactly 0) and paligemma-3b (GQA 8, head dim 256, its
           gradients and losses on random patch embeddings)),
           ServeSession under both
           policies against each request served alone on the plain
           versions, the first step's gradients leaf by leaf and eq1
           steps' losses (qwen3-moe: the kernels' run replays the plain
           run's routing, parity.pinned_routes, and its losses are held
           against the whole attention backward zeroed), at the limits of
           repro_torch/parity.py, each comparison also under a planted
           fault that it must reject; rwkv6 decay
           LoRA, bonus u and base decays redrawn from a seed (the init
           leaves them at 0, 0 and -6);
  main     the serving path: ServeSession on full-width glm4-9b (40 layers)
           and full-width rwkv6-3b (32 layers), and qwen3-moe-235b-a22b
           (~46 GB) and command-r-35b (~32 GB) at their published widths
           with the depth cut to 8 layers (exits 2, 4, 6), zamba2-1.2b at
           full width and depth (38 layers, its shared attention block at 6
           of them; prompts of 64-600 tokens, 1-3 chunks of 256) and
           deepseek-v3-671b at its published widths cut to 5 layers (3 dense,
           2 MoE; ~58.8 GB), whisper-small at full width and depth (12
           layers, self and cross attention in each, the cross K/V
           recomputed from the zeros stub every tick as in the JAX
           package) and paligemma-3b at full width and depth (18 layers,
           GQA 8, head dim 256, ~9.2 GB), in bf16, random
           weights from a seeded torch.Generator on the card, 8 slots, 16
           requests (rwkv6 prompts of 64-512 tokens), under the select and
           the sticky policy; each run starts with every launch count at 0
           and must launch the mixer's kernel and the gate (attention:
           prefill on the forward's tile route, decode on its decode
           route; zamba2-1.2b launches attention at its shared layers only,
           deepseek-v3 the gate only); for qwen3-moe and deepseek-v3 a
           separate, untimed run prints the routed
           entries dropped by capacity per prefill and per decode tick
           (none on a tick: each slot is routed alone);
  train    the training path: make_train_step on glm4-9b at its published
           widths with the depth cut to 8 layers (exits 2, 4, 6), batch
           12 x 128, and on rwkv6-3b at its published widths and full depth
           (exits 8, 16, 24), batch 12 x 512, remat, and on zamba2-1.2b at
           its published widths and full depth (exits 10, 20, 29), batch
           12 x 512, remat, and on whisper-small at full width and depth
           (exits 3, 6, 9), 12 x 448 decoder tokens over 1500 random
           source frames, and paligemma-3b at its published widths cut to
           8 layers (exits 2, 4, 6), 4 x (256 random patches + 256
           tokens), its bytes worked out and printed first; 12 client
           groups (paligemma: 4), bf16
           weights, fp32 Adam, SyntheticLMDataset(seed=0); with every launch
           count set to 0 first, warm-up and one sum step (one step of each
           mode under FlopCounterMode, for the share of the bf16 peak), timed
           eq1 and sum steps (glm4-9b: every attention forward, dK/dV and
           dQ launch on the tile route, and no delta pass in torch;
           rwkv6-3b: both wkv kernels every step), a loss check on the
           first batch, a
           traced window of 2 steps (rwkv6-3b: then eq1 steps on the plain
           versions, the end-to-end baseline);
  dryrun   the dry run's step analysis (launch/step_analysis.py) of one
           real step on the card after warm-up against a fake trace of the
           same step (FakeTensorMode on fake CPU tensors, as
           launch/dryrun.py traces one rank): phase train's glm4-9b eq1
           step (attention forward, dK/dV, dQ), rwkv6-3b whole at 12 x 512
           with remat (wkv forward and backward) and one select tick of
           phase main's glm4-9b ServeSession (decode attention, the gate);
           FLOPs, site FLOPs and site calls equal exactly, site calls equal
           the wrappers' launch counts, the fake peak within 5 % of the
           card's allocated peak above the bytes allocated before the
           step; then the two MLP examples (repro_torch/examples) on the
           card, the gate kernel launched by both (not main-path counts);
  paper    the paper's loop, fp32 with TF32 off: TrainSession (reference
           engine) on the ResNet smoke, clients cut at (3, 3, 4, 5), on the
           card against the same run on the CPU from one round-0 state,
           averaging and sequential (losses, the trainables' drift, BN
           statistics, at repro_torch/parity.py's limits; averaging also
           under a planted fault, client 0's server left out of Eq. (1),
           which it must reject); the CPU's final state evaluated on both
           devices (evaluate and evaluate_adaptive equal; the gate kernel
           against the plain version row by row at (512,10) and the
           500-row tail, exits equal where |H - tau| > 1e-4, at tau 0.5,
           1, 2 and client 0's mean entropy); the gate at
           (512,10), (512,100) and their 500-row tails; then full-width
           ResNet-18 (resnet18_cifar.config("cifar10")) with the paper's 12
           clients at cuts 3/4/5, batch 64, lr 3e-3, the paper's
           augmentation: with every launch count at 0 first, averaging (1
           warm-up round, 5 timed, 1 traced) and sequential (1 warm-up, 3
           timed), ms per round, rounds/s, images/s, each evaluated
           (evaluate and evaluate_adaptive at tau 0.5, 1.0, 2.0, per-depth
           accuracies and client ratios), peak memory; the gate must launch
           in the evaluations; then the averaging run's first client at
           each cut: its eval-mode logits on the card against the CPU, the
           gate kernel against the plain version on them, and its accuracy
           and mean entropy with BatchNorm on running vs batch statistics;
  fused    the fused cohort engine (clients that share a cut stepped as
           lanes under torch.func.vmap, Eq. (1) on the stacked servers,
           staged chunks, one host sync a chunk), fp32 with TF32 off: the
           ResNet smoke (cuts (3, 3, 4, 5): two lanes at cut 3) on the card
           against the CPU in eq1 and sum, under a planted fault (client
           0's lane left out of the stacked Eq. (1)) it must reject, and
           against the reference engine on the card; then, with every
           launch count at 0, phase paper's full-width config on the fused
           engine (eq1 and sum under averaging, eq1 under distributed): ms
           per round timed as phase paper times it, beside the reference
           engine's, rounds/s, images/s, host syncs per chunk (the sync
           debug mode), kernels per round and idle share of 2 traced
           rounds, peak memory, the staging overlap_fraction, and
           evaluate_adaptive (the gate); a probe of both engines with
           cuDNN's algorithm search on (cudnn.benchmark); and
           BackboneSplitModel on the
           bf16 smokes at full head width (glm4-9b: 2 lanes at each of cuts
           1 and 2; rwkv6-3b: 3 lanes at cut 2; qwen3-moe: 2 lanes at cut 2,
           MoE under lanes; zamba2-1.2b: 2 lanes at cut 2, Mamba2 and the
           shared attention block under lanes), 2 rounds of fused eq1 on
           the kernels, which must launch rows 2-6 under lanes; the launch
           counts are read there.  Then the legs on the plain versions from
           the same start (losses and first-step gradients leaf by leaf at
           repro_torch/parity.py's bf16 limits), and each kernel site's
           vmap rule against a per-lane loop of plain launches (attention
           bit for bit, the wkv within 1e-4 of each output's scale);
  lifecycle the training entry point's lifecycle, fp32 with TF32 off:
           the churning population smoke (the ResNet smoke's four slots
           drawn from 8 Dirichlet clients, participation 0.7, stragglers
           0.2) on the card against the CPU, then resumed from a mid-run
           checkpoint against the uninterrupted run, under two planted
           faults it must reject (inactive lanes counted in the masked
           Eq. (1); a restored cursor left at round 0), and readings over
           4 rounds, round by round, of it and of the fixed cohort, card
           vs CPU, with each slot's Adam steps; then, with every
           launch count at 0, phase fused's full-width config (12 slots at
           cuts 3/4/5, batch 64, lr 3e-3, fused eq1) drawn from a
           Dirichlet population of 36 clients (alpha 0.5, participation
           0.7, churn seed 3, stragglers 0.2, min shard 64): 8 rounds
           with save_every=4 and keep_last=2, the run cut after its
           round-4 save and resumed by restore_latest for 4 more against
           the uninterrupted 8 (losses and drift at phase fused's limits;
           these comparisons with cuDNN's deterministic algorithms), save
           and restore ms and MB on disk, host syncs per chunk, kernels
           per traced round and operations per round at different active
           counts (the operations equal, name by name),
           full participation against the fixed cohort for 3 rounds (at
           the same limits; ms per round of both), evaluate_adaptive at
           tau 0.5/1/2, peak memory; the bf16 backbone smokes under a
           churning population over their lanes, kernels against the plain
           versions from one start (rows 2-6 launched under masked lanes),
           and one masked cohort step on each whose masked lane must not
           move (under a planted fault advancing its Adam step, rejected);
           ServeSession.restore of the glm4-9b population checkpoint
           against a session on assemble_serve_params of the live state
           (tokens and gates equal; the launch counts are read between
           the two); last, under cuDNN's default algorithms, the fixed
           cohort against itself, full participation against it and the
           same under a planted fault (the first lane left out of the
           masked Eq. (1)), 3 rounds each;
  spmd     the spmd engine over ranks (launch.hostdevices): 2 ranks share
           the card over gloo with CUDA tensors (and, with 2 cards or more,
           one rank a card over NCCL); the full-width ResNet-18 loop with
           its cohort lanes over the ranks and with each lane's batch over
           them (FSDP, BatchNorm statistics summed over the batch ranks),
           a float64 data leg, the glm4-9b bf16 smoke under lanes with its
           attention kernels counted on each rank, each against the fused
           engine on the same card, and two planted faults (Eq. (1)'s lanes
           reduce skipped, per-rank BatchNorm statistics) that must be
           rejected; ms per round and bytes gathered per step are a record,
           and the gather plan (launch/meshcomm.unshard_plan, which the dry
           run reads) must predict the bytes gathered to the byte; then
           serving over the ranks: ServeSession(mesh=, recipe="greedy") on
           glm4-9b at its published widths cut to 4 layers, bf16, on a
           data mesh (the slots over the ranks) and a model mesh (the
           decode ring's sequence split over "model", the parts' attention
           combined by their LSEs), select and sticky, the decode route and
           the gate counted on every rank, ms a tick, bytes gathered a tick
           and peak memory per rank, against the one-rank session on the
           same card and each request served alone at the bf16 stream
           limits, and a planted fault (the parts not combined) that must
           be rejected; last, the qwen3-moe bf16 smoke with its batch and
           its experts over the ranks (expert loads summed over them, E / 2
           experts a rank, none of their weights gathered, the dispatch
           and combine an exchange) against the one-rank fused engine with
           the routing pinned, and one forward of it (capacity factor 0.5:
           experts drop entries) with its rows and experts over the ranks
           against one rank, where a planted fault (the loads left per
           rank) must be rejected; one qwen3-moe-235b-a22b MoE block at its
           published widths, forward and backward on 2 x 4 x 512 tokens,
           64 of its 128 experts a rank, against the block whole on one
           rank (output and gradients, routes pinned), its ms against one
           rank, peak and bytes exchanged printed; then tensor parallelism over
           "model" (mesh (1, 2), bf16): glm4-9b at published widths cut to
           4 layers served and trained under megatron, and on two fresh
           ranks deepseek-v3-671b cut to 4 layers (MLA over heads, 128
           experts a rank over the grid) and zamba2-1.2b cut to 6 layers
           (Mamba2's projections, greedy) served against the one-rank
           session, rwkv6-3b cut to 4 layers trained under megatron (the
           wkv kernels on 20 heads a rank) against the fused engine on one
           rank and a plain-version control, each with its planted
           faults; phase spmd prints its seconds;
  timing   each kernel, its plain version and PyTorch's one-call equivalent
           where there is one (SDPA forward, SDPA backward) timed at the
           main path's shapes, beside the bound for the work (the wkv's
           over the causal pairs it needs, at the fp32-accurate tensor-core
           rate); the attention forward with LSE,
           dK/dV and dQ also at one long causal shape, q (1,32,2048,128), k/v
           (1,2,2048,128) bf16, where operations set the bound; decode also
           over a 4096-key cache, q (8,32,1,128), k/v (8,2,4096,128); the
           row routes of the forward and of dQ beside their redesigned
           routes at the main shapes; the wkv also at a prefill shape
           (1,300,40,64) and at a tensor-parallel rank's (12,512,20,64); the gate also at (8,65536) bf16, (8,151552)
           fp32, zamba2-1.2b's (8,32000) and deepseek-v3's (8,129280) bf16
           and the paper evaluator's (512,10) and (512,100) fp32; attention
           at zamba2-1.2b's GQA-1 shapes (decode over a 633-slot ring,
           prefill of 600 tokens, the train shape forward, dK/dV and dQ),
           at paligemma-3b's head dim 256 (decode, prefill, the train
           shape forward, dK/dV and dQ) and at whisper-small's cross
           shapes (decode over 1500 frames, the train shape's forward,
           dK/dV and dQ over the whole rectangle), beside SDPA,
           beside the launch floor (a one-element torch op timed the
           same way).  Times are device times: a spin kernel ahead of each
           timed call keeps the host's enqueue (~50-100 us for a wrapper,
           more for SDPA's backward) off the clock.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Any failed check exits non-zero
and prints no result.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

# before torch initialises CUDA: the train phase holds ~70 GB in tensors of
# very different sizes, and the serve phase's freed weights must not
# fragment the pool it allocates from
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

SRC = Path(__file__).resolve().parent / "src"
PHASES = ("build", "kernels", "parity", "main", "train", "dryrun", "paper",
          "fused", "lifecycle", "spmd", "timing")
KERNELS = ("entropy_exit", "flash_attention", "flash_attention_tile",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq", "rwkv_wkv",
           "rwkv_wkv_bwd")

# NVIDIA H100 SXM data sheet (dense): HBM rate and peak rates by type;
# "3xtf32" is an fp32-accurate product on the tensor cores (each operand
# split into TF32 high and low parts, three TF32 products: 495 / 3 TF/s),
# the least time fp32 products need on this card
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12,
                  "3xtf32": 495e12 / 3}

# tolerances: fp32 kernels against fp32 plain versions (reassociation only);
# bf16 outputs compared in fp32 (the two sides round to bf16 at other points)
TOL_ATTN_F32 = 2e-5
TOL_ATTN_BF16 = 2e-2
# the LSE is fp32 on both sides, computed in fp32 from the same operand
# values, bf16 or fp32: reassociation only, so one tolerance holds for both
TOL_LSE = 1e-4
TOL_H = 1e-4
GATE_MARGIN = 1e-3      # exits must agree wherever |H - tau| exceeds this
# phase paper: card against CPU exits compared where |H - tau| exceeds this
GATE_TAU_MARGIN = 1e-4
# attention backward: each kernel's fp32 output against its plain version,
# fp32 and bf16 operands alike (both sides compute in fp32 from the same
# values: reassociation only; 2e-4 is the JAX kernel-level gate); the
# wrapper's bf16 gradients compared in fp32 at atol 1e-2 + rtol 1e-2 (one
# bf16 rounding of the result); the autograd site against autograd of the
# plain forward at 1e-4 (fp32) and, in bf16, 1e-2 of each tensor's largest
# magnitude (the kernels form delta = rowsum(dO * O) from the bf16 output,
# where autograd of the plain forward differentiates through fp32
# probabilities: 3.4e-3 of the scale with the plain versions on the CPU)
TOL_BWD = 2e-4
TOL_BWD_BF16 = 1e-2
# the dQ tile route's fused delta = rowsum(dO * O) against the same sum in
# torch, both fp32 from the same bf16 values (reassociation only), over the
# largest |delta|
TOL_DELTA = 1e-4
TOL_SITE_F32 = 1e-4
TOL_SITE_BF16 = 1e-2
# train-step parity, fp32 smoke: losses 1e-5; params after 3 Adam steps at
# most 1 element in 10^3 beyond 1e-6 and none beyond lr (Adam's first steps
# divide by sqrt(v) ~ |g|, which turns a 1e-9 gradient difference near
# g = 0 into an update difference of up to lr; measured 4.4e-5 of the
# elements on an H100)
TOL_TRAIN_LOSS = 1e-5
TRAIN_PARAM_FRACTION = 1e-3
# the bf16 smokes at full head width (phase parity) hold the limits of
# repro_torch/parity.py, set from sound and planted-fault readings
# wkv: the kernels against their plain versions, each output's largest
# difference over its largest magnitude (at least 1).  Both sides read the
# same r/k/v values in fp32; the kernels weight each intra-chunk pair by
# exp(L_{t-1} - L_i), the plain versions by e^{L_{t-1}} * e^{-L_i}, so the
# two differ by reassociation and exponential rounding only: 1e-4 forward
# (the JAX gate for y and the state), 5e-4 backward (the JAX kernel-level
# gate); bf16 gradients carry one more bf16 rounding (2^-8 of the scale)
TOL_WKV = 1e-4
TOL_WKV_BWD = 5e-4
TOL_WKV_BWD_BF16 = 1e-2

# the serving path's shapes (glm4-9b, 8 slots, max_len 161)
SLOTS, REQUESTS, DECODE, MAX_LEN = 8, 16, 32, 161
# the serving path's depth cut for qwen3-moe and command-r-35b
SERVE_CUT_LAYERS = 8
# the training path: glm4-9b cut to 8 layers, batch 12 x 128 tokens
TRAIN_LAYERS, TRAIN_B, TRAIN_T = 8, 12, 128
TRAIN_WARM, TRAIN_EQ1, TRAIN_SUM = 2, 10, 3
# rwkv6-3b: prompts 64-512 tokens (1-4 chunks of 128), training 12 x 512
# at full depth
RWKV_PROMPT_MIN, RWKV_PROMPT_MAX, RWKV_T = 64, 512, 512
RWKV_WARM, RWKV_EQ1, RWKV_SUM, RWKV_REF = 2, 4, 2, 2
# the long causal attention shape of phase timing: (1, 32, 2048, 128)
LONG_T = 2048
# the long decode cache of phases kernels and timing: (8, 2, 4096, 128)
LONG_CACHE = 4096
# zamba2-1.2b: prompts of 64-600 tokens (1-3 chunks of 256), each slot's
# page 633 tokens; training 12 x 512 at full depth
ZAMBA_PROMPT_MIN, ZAMBA_PROMPT_MAX = 64, 600
ZAMBA_MAX_LEN = ZAMBA_PROMPT_MAX + 1 + DECODE
ZAMBA_T = 512
ZAMBA_WARM, ZAMBA_EQ1, ZAMBA_SUM = 2, 3, 2
# deepseek-v3-671b's serving depth: 3 dense and 2 MoE layers, ~58.8 GB of
# bf16 weights (8 layers would be ~128 GB)
DEEPSEEK_CUT_LAYERS = 5
# whisper-small: the decoder trains on 12 x 448 tokens over 1500 random
# source frames (its cross attention's keys), at full depth
WHISPER_T, WHISPER_SRC = 448, 1500
WHISPER_WARM, WHISPER_EQ1, WHISPER_SUM = 2, 4, 2
# paligemma-3b trains at its published widths with the depth cut to 8
# layers (exits 2, 4, 6) on 4 x (256 random patches + 256 tokens): its
# five 257216 x 2048 vocab matrices (the embedding, three exit heads, the
# LM head) and their Adam moments hold most of the card
PALI_LAYERS, PALI_B, PALI_T = 8, 4, 512
PALI_WARM, PALI_EQ1, PALI_SUM = 2, 3, 2


class Failed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    print(("  ok    " if cond else "  FAIL  ") + msg, flush=True)
    if not cond:
        raise Failed(msg)


COUNT_ATTRS = ("launches", "row_launches", "tile_launches",
               "decode_launches", "torch_delta_passes")


def zero_counts(*wrappers) -> None:
    """Sets every launch count of the kernel wrappers to 0, by route too
    (and the backward's count of delta passes in torch)."""
    for w in wrappers:
        for attr in COUNT_ATTRS:
            if hasattr(w, attr):
                setattr(w, attr, 0)


@contextlib.contextmanager
def uncounted(wrappers, fault):
    """``fault``'s context with the wrappers' launch counts left as they
    were before it: a planted fault's run is off the main path."""
    saved = [(w, a, getattr(w, a)) for w in wrappers for a in COUNT_ATTRS
             if hasattr(w, a)]
    try:
        with fault():
            yield
    finally:
        for w, a, n in saved:
            setattr(w, a, n)


def launch_counts(wrapper) -> dict:
    """A wrapper's launches by kernel, as the result line names them, each
    name on the main path's kernel: the attention forward's routes are
    three kernels (decode: flash_attention, tile: flash_attention_tile,
    row: flash_attention_row); the dK/dV and dQ tile routes are
    flash_attention_bwd_dkv and flash_attention_bwd_dq, their row routes
    (fp32, small head dims) flash_attention_bwd_dkv_row and
    flash_attention_bwd_dq_row."""
    name = wrapper.__name__
    if name == "flash_attention":
        return {name: wrapper.decode_launches,
                "flash_attention_tile": wrapper.tile_launches,
                "flash_attention_row": wrapper.row_launches}
    if name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        return {name: wrapper.tile_launches,
                f"{name}_row": wrapper.row_launches}
    return {name: wrapper.launches}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def flush_l2(buf: torch.Tensor) -> None:
    buf.zero_()         # 128 MB > the 50 MB L2: the next launch starts cold


# a spin of ~0.5 ms on the card before each timed call: the host enqueues
# the call while the card spins, so the events time the device's work and
# not the Python wrapper's launch path
HEAD_START_CYCLES = 1_000_000


def time_ms(fn, buf, reps: int = 50) -> float:
    """Median device time of one call, L2 flushed before each."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        flush_l2(buf)
        torch.cuda._sleep(HEAD_START_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


# ---------------------------------------------------------------------------
# inputs at the main path's shapes
# ---------------------------------------------------------------------------


def attn_inputs(gen, dtype, *, B, Tq, H=32, Hkv=2, Tk=MAX_LEN, D=128):
    """q, k, v in the model's (B, T, H, D) layout, handed to the kernel as
    the transposed views the model passes."""
    dev = "cuda"
    q = torch.randn(B, Tq, H, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Tk, Hkv, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Tk, Hkv, D, generator=gen, device=dev).to(dtype)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def kv_prefix(B, Tk=MAX_LEN, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(1, Tk + 1, B), dtype=torch.int32,
                           device="cuda")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build(state):
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build()
    state["build_s"] = time.perf_counter() - t0
    print(f"built {len(libs)} kernel libraries in {state['build_s']:.1f} s")
    for src, path in libs.items():
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if ("registers" in line or "spill" in line
                        or "Compiling entry function" in line):
                    print(f"  {src}: {line.strip()}")
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_kernels(state):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = state.setdefault("max_abs_err", {})

    kernel_of = {"decode": "flash_attention", "tile": "flash_attention_tile",
                 "row": "flash_attention_row"}

    def attn_case(name, dtype, tol, *, B, Tq, causal, route, Tk=MAX_LEN,
                  window=None, kv_valid=None, lse=False, main=False, H=32,
                  Hkv=2, D=128, force=None):
        """One forward call against the plain version: ``route`` is the
        route the call must take (``force``: the wrapper's route
        argument); the decode route is also launched twice and must give
        the same bits."""
        q, k, v = attn_inputs(gen, dtype, B=B, Tq=Tq, Tk=Tk, H=H, Hkv=Hkv,
                              D=D)
        kw = dict(causal=causal, window=window, kv_valid=kv_valid,
                  return_lse=True)
        counts = launch_counts(flash_attention)
        got, got_lse = flash_attention(q, k, v, route=force, **kw)
        want, want_lse = flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        kernel = kernel_of[route]
        launched = {n: c - counts[n]
                    for n, c in launch_counts(flash_attention).items()}
        check(launched[kernel] == 1 and sum(launched.values()) == 1,
              f"attention {name} {dtype}: one launch, {route} route")
        if route == "decode":
            again = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            check(torch.equal(got, again[0]) and torch.equal(got_lse,
                                                            again[1]),
                  f"attention {name} {dtype}: out and lse bit for bit "
                  f"equal across two launches")
        if lse:
            d_lse = (got_lse - want_lse).abs().max().item()
            check(d_lse <= TOL_LSE, f"attention {name} {dtype} lse max|d|="
                                    f"{d_lse:.3e} <= {TOL_LSE:g}")
        d = (got.float() - want.float()).abs().max().item()
        check(got.shape == want.shape and d <= tol,
              f"attention {name} {dtype} max|d|={d:.3e} <= {tol:g}")
        if main:
            errs[kernel] = max(errs.get(kernel, 0.0), d)

    bf16 = torch.bfloat16
    attn_case("decode (8,32,1,128)/(8,2,161,128) kv_valid", bf16,
              TOL_ATTN_BF16, B=8, Tq=1, causal=False, kv_valid=kv_prefix(8),
              lse=True, main=True, route="decode")
    attn_case("decode (8,32,1,128)/(8,2,161,128) kv_valid, row route "
              "forced", bf16, TOL_ATTN_BF16, B=8, Tq=1, causal=False,
              kv_valid=kv_prefix(8), lse=True, main=True, route="row",
              force="row")
    attn_case("prefill (1,32,128,128)/(1,2,161,128) causal", bf16,
              TOL_ATTN_BF16, B=1, Tq=128, causal=True, main=True,
              route="tile")
    attn_case("prefill (1,32,37,128)/(1,2,161,128) causal", bf16,
              TOL_ATTN_BF16, B=1, Tq=37, causal=True, main=True, route="tile")
    attn_case("train (12,32,128,128)/(12,2,128,128) causal, with lse",
              bf16, TOL_ATTN_BF16, B=TRAIN_B, Tq=TRAIN_T, Tk=TRAIN_T,
              causal=True, lse=True, main=True, route="tile")
    attn_case("decode fp32 kv_valid", torch.float32, TOL_ATTN_F32, B=8, Tq=1,
              causal=False, kv_valid=kv_prefix(8, seed=1), lse=True,
              route="row")
    attn_case("prefill fp32 causal", torch.float32, TOL_ATTN_F32, B=2, Tq=100,
              causal=True, lse=True, route="row")
    attn_case("sliding window 48, fp32", torch.float32, TOL_ATTN_F32, B=2,
              Tq=MAX_LEN, causal=True, window=48, lse=True, route="row")
    attn_case("sliding window 48, bf16", bf16, TOL_ATTN_BF16, B=2,
              Tq=MAX_LEN, causal=True, window=48, route="tile")
    # the tile and decode routes at the three head dims, GQA 1, 4 and 16,
    # and the rule's threshold: Tq * G = 48 and 63 rows (decode route) and
    # 64 rows (tile route)
    for D in (64, 128, 256):
        for name, kw in (
                ("GQA 4 window 16 (2,8,100)/(2,2,100)", dict(
                    B=2, H=8, Hkv=2, Tq=100, Tk=100, causal=True,
                    window=16, route="tile")),
                ("GQA 1 non-causal (3,4,70)/(3,4,70)", dict(
                    B=3, H=4, Hkv=4, Tq=70, Tk=70, causal=False,
                    route="tile")),
                ("GQA 1, 63 rows (3,4,63)/(3,4,70)", dict(
                    B=3, H=4, Hkv=4, Tq=63, Tk=70, causal=False,
                    route="decode")),
                ("GQA 1, 64 rows causal (3,4,64)/(3,4,70)", dict(
                    B=3, H=4, Hkv=4, Tq=64, Tk=70, causal=True,
                    route="tile")),
                ("GQA 16, 48 rows, kv_valid (3,32,3)/(3,2,161)", dict(
                    B=3, H=32, Hkv=2, Tq=3, Tk=MAX_LEN, causal=False,
                    kv_valid=kv_prefix(3, seed=3), route="decode")),
                ("GQA 16, 64 rows, kv_valid (3,32,4)/(3,2,161)", dict(
                    B=3, H=32, Hkv=2, Tq=4, Tk=MAX_LEN, causal=False,
                    kv_valid=kv_prefix(3, seed=4), route="tile")),
                ("GQA 4 window 33 + kv_valid (2,8,90)/(2,2,130)", dict(
                    B=2, H=8, Hkv=2, Tq=90, Tk=130, causal=False, window=33,
                    kv_valid=kv_prefix(2, 130, seed=5), route="tile"))):
            attn_case(f"{name} D={D}", bf16, TOL_ATTN_BF16, lse=True, D=D,
                      **kw)
    decode_cases(attn_case)
    ring_part_cases(gen)
    # the dense and MoE configs' head layouts: command-r-35b's GQA 8 (H 64,
    # Hkv 8), phi3-medium-14b's H 40 / Hkv 10, qwen3-moe's H 64 / Hkv 4;
    # prefill on the tile route, a decode tick of 8 slots on the decode
    # route
    for H, Hkv, what in ((64, 8, "command-r-35b GQA 8"),
                         (40, 10, "phi3-medium-14b GQA 4"),
                         (64, 4, "qwen3-moe GQA 16")):
        attn_case(f"{what} prefill (1,{H},128,128)/(1,{Hkv},161,128) "
                  f"causal", bf16, TOL_ATTN_BF16, B=1, Tq=128, causal=True,
                  H=H, Hkv=Hkv, lse=True, main=True, route="tile")
        attn_case(f"{what} decode (8,{H},1,128)/(8,{Hkv},161,128) "
                  f"kv_valid", bf16, TOL_ATTN_BF16, B=8, Tq=1, causal=False,
                  H=H, Hkv=Hkv, kv_valid=kv_prefix(8, seed=H + Hkv),
                  lse=True, main=True, route="decode")
    # zamba2-1.2b's shared block, GQA 1 (H = Hkv = 32, D 64): the longest
    # prefill over the 633-slot page (tile route), a decode tick of 8 slots
    # (decode route: each (slot, head) fills 1 row of a 16-row mma tile)
    # and the train shape's forward with LSE (tile route)
    z = dict(H=32, Hkv=32, D=64, Tk=ZAMBA_MAX_LEN)
    attn_case(f"zamba2-1.2b GQA 1 prefill (1,32,{ZAMBA_PROMPT_MAX},64)/"
              f"(1,32,{ZAMBA_MAX_LEN},64) causal", bf16, TOL_ATTN_BF16, B=1,
              Tq=ZAMBA_PROMPT_MAX, causal=True, lse=True, main=True,
              route="tile", **z)
    attn_case(f"zamba2-1.2b GQA 1 decode (8,32,1,64)/(8,32,{ZAMBA_MAX_LEN},"
              f"64) kv_valid", bf16, TOL_ATTN_BF16, B=8, Tq=1, causal=False,
              kv_valid=kv_prefix(8, ZAMBA_MAX_LEN, seed=64), lse=True,
              main=True, route="decode", **z)
    attn_case(f"zamba2-1.2b GQA 1 train (12,32,{ZAMBA_T},64) causal, with "
              f"lse", bf16, TOL_ATTN_BF16, B=TRAIN_B, Tq=ZAMBA_T,
              causal=True, lse=True, main=True, route="tile",
              **{**z, "Tk": ZAMBA_T})
    # paligemma-3b's attention, GQA 8 (H 8, Hkv 1), head dim 256: prefill
    # and a ragged prefill over the ring and a window (tile route), a
    # decode tick of 8 slots (decode route: 8 rows of a 16-row mma tile),
    # the row route forced there, the train shape's forward with LSE (tile
    # route), and fp32 (row route)
    pg = dict(H=8, Hkv=1, D=256)
    attn_case("paligemma-3b GQA 8 prefill (1,8,128,256)/(1,1,161,256) "
              "causal", bf16, TOL_ATTN_BF16, B=1, Tq=128, causal=True,
              lse=True, main=True, route="tile", **pg)
    attn_case("paligemma-3b GQA 8 ragged prefill (2,8,37,256)/(2,1,161,256)"
              " causal", bf16, TOL_ATTN_BF16, B=2, Tq=37, causal=True,
              lse=True, main=True, route="tile", **pg)
    attn_case("head dim 256 GQA 8 window 48 (2,8,161)/(2,1,161)", bf16,
              TOL_ATTN_BF16, B=2, Tq=MAX_LEN, causal=True, window=48,
              lse=True, route="tile", **pg)
    attn_case("paligemma-3b GQA 8 decode (8,8,1,256)/(8,1,161,256) "
              "kv_valid", bf16, TOL_ATTN_BF16, B=8, Tq=1, causal=False,
              kv_valid=kv_prefix(8, seed=256), lse=True, main=True,
              route="decode", **pg)
    attn_case("paligemma-3b GQA 8 decode (8,8,1,256)/(8,1,161,256) "
              "kv_valid, row route forced", bf16, TOL_ATTN_BF16, B=8, Tq=1,
              causal=False, kv_valid=kv_prefix(8, seed=257), lse=True,
              main=True, route="row", force="row", **pg)
    attn_case(f"paligemma-3b train ({PALI_B},8,{PALI_T},256) causal, with "
              f"lse", bf16, TOL_ATTN_BF16, B=PALI_B, Tq=PALI_T, Tk=PALI_T,
              causal=True, lse=True, main=True, route="tile", **pg)
    attn_case("head dim 256 fp32 ragged prefill (2,8,37)/(2,1,161) causal",
              torch.float32, TOL_ATTN_F32, B=2, Tq=37, causal=True, lse=True,
              route="row", **pg)
    attn_case("head dim 256 fp32 decode (8,8,1)/(8,1,161) kv_valid",
              torch.float32, TOL_ATTN_F32, B=8, Tq=1, causal=False,
              kv_valid=kv_prefix(8, seed=258), lse=True, route="row", **pg)
    # whisper-small's cross attention, GQA 1 (H = Hkv = 12, D 64),
    # non-causal over 1500 source frames (ragged at 64 keys): the decode
    # tick (decode route) and the train shape with LSE (tile route)
    wx = dict(H=12, Hkv=12, D=64, Tk=WHISPER_SRC)
    attn_case(f"whisper-small cross decode (8,12,1,64)/(8,12,{WHISPER_SRC},"
              f"64) non-causal", bf16, TOL_ATTN_BF16, B=8, Tq=1,
              causal=False, lse=True, main=True, route="decode", **wx)
    attn_case(f"whisper-small cross train (12,12,{WHISPER_T},64)/(12,12,"
              f"{WHISPER_SRC},64) non-causal, with lse", bf16, TOL_ATTN_BF16,
              B=TRAIN_B, Tq=WHISPER_T, causal=False, lse=True, main=True,
              route="tile", **wx)

    gate_cases(gen, errs)
    bwd_kernel_cases(gen, errs)
    autograd_site_cases(gen)
    wkv_kernel_cases(gen, errs)
    wkv_site_cases(gen)


def gate_cases(gen, errs):
    """The gate against its plain version: glm4-9b's and rwkv6-3b's serve
    shapes, fp32, one row, 300 rows (one block a row), vocab tails, rows
    not on 16 bytes, each row's max in its last split, -inf entries, and
    every cluster size 1-16 (row widths at which ``gate_splits`` picks
    each); each call also launched a second time, which must give the
    same bits."""
    from repro_torch.kernels.entropy_exit import (MAX_SPLITS, entropy_exit,
                                                  gate_splits, sm_count)
    from repro_torch.kernels.ref import entropy_exit_ref, gate_slice_bounds
    from repro_torch.parity import (GATE_CLUSTER_ROWS, GATE_LAYOUTS,
                                    gate_cluster_vocab, gate_logits,
                                    gate_thresholds)
    sizes = set()

    def gate_case(name, dtype, V, *, B=SLOTS, layout=None, main=False):
        """One gate call against the plain version, and a second launch
        that must give the same bits.  A row holding a -inf logit has H =
        NaN on both sides and does not exit (compared with equal_nan)."""
        x = gate_logits(gen, dtype, B, V, layout)
        tau = gate_thresholds(entropy_exit_ref(x, 0.0)[0])
        n = entropy_exit.launches
        H, ex = entropy_exit(x, tau)
        again = entropy_exit(x, tau)
        H_ref, ex_ref = entropy_exit_ref(x, tau)
        torch.cuda.synchronize()
        cs = gate_splits(B, V, sm_count(0))
        sizes.add(cs)
        name = f"entropy {name} {dtype}, {cs} splits"
        # the same bits, compared as integers: a NaN equals itself
        check(entropy_exit.launches == n + 2
              and torch.equal(H.view(torch.int32), again[0].view(torch.int32))
              and torch.equal(ex, again[1]),
              f"{name}: H and exit bit for bit equal across two launches")
        nan = torch.isnan(H_ref)
        check(torch.equal(torch.isnan(H), nan) and not ex[nan].any()
              and bool(nan.any()) == (layout == "-inf"),
              f"{name}: H is NaN exactly where the plain version's is "
              f"({int(nan.sum())} rows, equal_nan), and none of them exits")
        d = (H - H_ref)[~nan].abs().max().item() if (~nan).any() else 0.0
        check(d <= TOL_H, f"{name} max|dH|={d:.3e} <= {TOL_H:g}")
        far = (H_ref - tau).abs() > GATE_MARGIN
        check(bool((ex[far] == ex_ref[far]).all()),
              f"{name} exits equal where |H-tau| > {GATE_MARGIN:g}")
        if main:
            errs["entropy_exit"] = max(errs.get("entropy_exit", 0.0), d)

    bf16, f32 = torch.bfloat16, torch.float32
    gate_case("(8,151552)", bf16, 151552, main=True)
    gate_case("(8,151552)", f32, 151552)
    gate_case("(8,65536)", bf16, 65536, main=True)
    # phi3-medium-14b's vocab; minitron-8b's and command-r-35b's
    gate_case("(8,100352)", bf16, 100352, main=True)
    gate_case("(8,256000)", bf16, 256000, main=True)
    gate_case("(8,151936)", bf16, 151936, main=True)   # qwen3-moe
    gate_case("(8,32000)", bf16, 32000, main=True)     # zamba2-1.2b
    gate_case("(8,129280)", bf16, 129280, main=True)   # deepseek-v3
    gate_case("(1,151552)", bf16, 151552, B=1)
    gate_case("(300,151552)", bf16, 151552, B=300)
    gate_case("(8,2053) vocab tail", f32, 2048 + 5)
    gate_case("(8,97) vocab tail", bf16, 97)
    # more rows than grid.y holds: two grid.z slices, padding in the last
    gate_case("(65537,97) rows beyond grid.y", bf16, 97, B=65537)
    for dtype in (bf16, f32):
        for layout in GATE_LAYOUTS:
            gate_case(f"(8,151552) {layout}", dtype, 151552, layout=layout)
    for cs in range(1, MAX_SPLITS + 1):
        V = gate_cluster_vocab(cs)
        gate_case(f"({GATE_CLUSTER_ROWS},{V})", bf16, V, B=GATE_CLUSTER_ROWS)
        for dtype, layout in ((f32, "misaligned"), (bf16, "max last"),
                              (bf16, "-inf")):
            gate_case(f"({GATE_CLUSTER_ROWS},{V}) {layout}", dtype, V,
                      B=GATE_CLUSTER_ROWS, layout=layout)
    check(sizes == set(range(1, MAX_SPLITS + 1)),
          f"entropy: every cluster size 1-{MAX_SPLITS} launched "
          f"(got {sorted(sizes)})")
    # planted fault: the kernel on rows whose last slice reads -1e4 (p = 0:
    # that slice's triple dropped) must miss the plain version beyond TOL_H
    x = gate_logits(gen, bf16, SLOTS, 151552)
    lo = gate_slice_bounds(x.shape[1], gate_splits(*x.shape, sm_count(0)))
    dropped = x.clone()
    dropped[:, lo[-1][0]:] = -1e4
    d = (entropy_exit(dropped, 0.0)[0]
         - entropy_exit_ref(x, 0.0)[0]).abs().max().item()
    check(d > TOL_H, f"entropy (8,151552) planted fault, the last of "
                     f"{len(lo)} slices dropped: max|dH|={d:.3e} > {TOL_H:g}")


def decode_cases(attn_case):
    """The decode route (bf16, D 64, 128 and 256, Tq * G < 64 rows) at GQA 1, 4
    and 16, 1 to 63 rows, kv_valid of 1, ragged and full, ragged Tk, Tq > 1
    causal with and without a window, and a 4096-key cache at every split
    count the rule picks (B * Hkv from 16 to 132)."""
    from repro_torch.kernels.flash_attention import TILE_KEYS, decode_splits
    bf16 = torch.bfloat16

    def ones(B):
        return torch.ones(B, dtype=torch.int32, device="cuda")

    for D in (64, 128, 256):
        for name, kw in (
                ("GQA 1, 1 row, kv_valid 1 (4,4,1)/(4,4,161)", dict(
                    B=4, H=4, Hkv=4, Tq=1, causal=False, kv_valid=ones(4))),
                ("GQA 4, 4 rows, ragged kv_valid (4,8,1)/(4,2,100)", dict(
                    B=4, H=8, Hkv=2, Tq=1, Tk=100, causal=False,
                    kv_valid=kv_prefix(4, 100, seed=6))),
                ("GQA 16, 16 rows, full (3,32,1)/(3,2,65)", dict(
                    B=3, H=32, Hkv=2, Tq=1, Tk=65, causal=False)),
                ("GQA 1, 17 rows causal, kv_valid (2,4,17)/(2,4,40)", dict(
                    B=2, H=4, Hkv=4, Tq=17, Tk=40, causal=True,
                    kv_valid=kv_prefix(2, 40, seed=7))),
                ("GQA 4, 32 rows causal, kv_valid 1 (2,8,8)/(2,2,130)", dict(
                    B=2, H=8, Hkv=2, Tq=8, Tk=130, causal=True,
                    kv_valid=ones(2))),
                ("GQA 16, 32 rows causal window 1 (2,32,2)/(2,2,161)", dict(
                    B=2, H=32, Hkv=2, Tq=2, causal=True, window=1)),
                ("GQA 4, 60 rows causal window 5 (2,8,15)/(2,2,161)", dict(
                    B=2, H=8, Hkv=2, Tq=15, causal=True, window=5)),
                ("GQA 1, 63 rows window 9 (2,4,63)/(2,4,200)", dict(
                    B=2, H=4, Hkv=4, Tq=63, Tk=200, causal=False,
                    window=9))):
            attn_case(f"decode route {name} D={D}", bf16, TOL_ATTN_BF16,
                      lse=True, D=D, route="decode", **kw)
    seen = set()
    for B in (8, 10, 12, 16, 20, 24, 40, 66):
        splits = decode_splits(2 * B, -(-LONG_CACHE // TILE_KEYS))
        seen.add(splits)
        attn_case(f"decode route (B={B},32,1,128)/(B,2,{LONG_CACHE},128), "
                  f"{splits} splits", bf16, TOL_ATTN_BF16, B=B, Tq=1,
                  Tk=LONG_CACHE, causal=False, lse=True, route="decode")
    check(seen == set(range(1, 9)),
          f"decode route: the {LONG_CACHE}-key cases ran every split count "
          f"1-8 ({sorted(seen)})")


def ring_part_cases(gen):
    """The decode route (bf16) and the row route (fp32) on one part of a
    decode ring split over ranks (``models.attention.ShardedRing``):
    glm4-9b's heads (8 slots, H 32, Hkv 2, D 128) over half of phase
    spmd's 160-slot ring, with the LSE, at per-row ``kv_valid`` of 0 (the
    row's valid prefix lies wholly in the other part), 1, ragged and
    full.  Rows with keys: out and LSE against the plain version.  Rows
    without: both sides' LSE reads "no key" (at most NEG_INF / 2, which
    the combine weights 0) and the kernel's output is finite."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import NEG_INF, flash_attention_ref
    part = SPMD_SERVE_MAX_LEN // 2
    valid = torch.tensor([0, 1, 37, part, 0, 5, part - 1, 0],
                         dtype=torch.int32, device="cuda")
    has = valid > 0
    for dtype, route, tol in ((torch.bfloat16, "decode", TOL_ATTN_BF16),
                              (torch.float32, "row", TOL_ATTN_F32)):
        q, k, v = attn_inputs(gen, dtype, B=8, Tq=1, Tk=part)
        before = launch_counts(flash_attention)
        got, got_lse = flash_attention(q, k, v, causal=False,
                                       kv_valid=valid, return_lse=True)
        want, want_lse = flash_attention_ref(q, k, v, causal=False,
                                             kv_valid=valid, return_lse=True)
        torch.cuda.synchronize()
        kernel = {"decode": "flash_attention", "row": "flash_attention_row"}[
            route]
        launched = {n: c - before[n]
                    for n, c in launch_counts(flash_attention).items()}
        name = f"ring part (8,32,1,128)/(8,2,{part},128) kv_valid with 0 rows"
        check(launched[kernel] == 1 and sum(launched.values()) == 1,
              f"attention {name} {dtype}: one launch, {route} route")
        d = (got[has].float() - want[has].float()).abs().max().item()
        d_lse = (got_lse[has] - want_lse[has]).abs().max().item()
        check(d <= tol and d_lse <= TOL_LSE,
              f"attention {name} {dtype}: rows with keys max|d| {d:.3e} <= "
              f"{tol:g}, lse {d_lse:.3e} <= {TOL_LSE:g}")
        empty_k = got_lse[~has].max().item()
        empty_p = want_lse[~has].max().item()
        check(bool(torch.isfinite(got).all()) and max(empty_k, empty_p)
              <= NEG_INF / 2,
              f"attention {name} {dtype}: rows without keys read no key "
              f"(lse {empty_k:.3g} kernel, {empty_p:.3g} plain), output "
              f"finite")


def bwd_inputs(gen, dtype, *, B, H, Hkv, T, D, Tk=None):
    """q, k, v, dO in the model's (B, T, H, D) layout, as transposed views;
    k and v over ``Tk`` keys (default T)."""
    return tuple(torch.randn(B, t, h, D, generator=gen, device="cuda")
                 .to(dtype).transpose(1, 2)
                 for t, h in ((T, H), (Tk or T, Hkv), (Tk or T, Hkv), (T, H)))


def bwd_kernel_cases(gen, errs):
    from repro_torch.kernels.flash_attention import (dkv_route, dq_route,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from repro_torch.kernels.ref import (flash_attention_bwd_dkv_ref,
                                         flash_attention_bwd_dq_ref,
                                         flash_attention_bwd_ref,
                                         flash_attention_ref)

    def launched_by(wrapper, fn):
        counts = launch_counts(wrapper)
        out = fn()
        return out, {n: c - counts[n]
                     for n, c in launch_counts(wrapper).items()}

    def case(name, dtype, *, B, H, Hkv, T, D=128, causal=True, window=None,
             main=False, dq_force=None, Tk=None):
        """dK/dV and dQ (delta given; on the dQ tile route also fused)
        against the plain versions, each on the route its rule picks
        (``dq_force``: the dQ wrapper's route argument), the tile routes
        twice for the same bits; the wrapper's gradients in the primal
        dtypes."""
        q, k, v, do = bwd_inputs(gen, dtype, B=B, H=H, Hkv=Hkv, T=T, D=D,
                                 Tk=Tk)
        o, lse = flash_attention_ref(q, k, v, causal=causal, window=window,
                                     return_lse=True)
        delta = (do.float() * o.float()).sum(-1)
        kw = dict(causal=causal, window=window)
        tile = dkv_route(dtype, D) == "tile"
        dq_tile = dq_route(dtype, D) == "tile" and dq_force is None
        (dk, dv), launched = launched_by(
            flash_attention_bwd_dkv,
            lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))
        dq, dq_launched = launched_by(
            flash_attention_bwd_dq,
            lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                           route=dq_force, **kw))
        want_dk, want_dv = flash_attention_bwd_dkv_ref(q, k, v, do, lse,
                                                       delta, **kw)
        want_dq = flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
        grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        wants = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        for what, got, on_tile in (("dK/dV", launched, tile),
                                   ("dQ", dq_launched, dq_tile)):
            check(list(got.values()) == ([1, 0] if on_tile else [0, 1]),
                  f"attention bwd {name} {dtype}: {what} on the "
                  f"{'tile' if on_tile else 'row'} route")
        if tile:
            dk2, dv2 = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
            torch.cuda.synchronize()
            check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
                  f"attention bwd {name} {dtype}: dK/dV bit for bit equal "
                  f"across two launches")
        d_dkv = max((dk - want_dk).abs().max().item(),
                    (dv - want_dv).abs().max().item())
        d_dq = (dq - want_dq).abs().max().item()
        if dq_tile:
            dq_f, delta_f = flash_attention_bwd_dq(q, k, v, do, lse, o=o, **kw)
            dq_f2, delta_f2 = flash_attention_bwd_dq(q, k, v, do, lse, o=o,
                                                     **kw)
            dq2 = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
            torch.cuda.synchronize()
            check(torch.equal(dq, dq2) and torch.equal(dq_f, dq_f2)
                  and torch.equal(delta_f, delta_f2),
                  f"attention bwd {name} {dtype}: dQ (delta given and "
                  f"fused) and the fused delta bit for bit equal across two "
                  f"launches")
            d_delta = ((delta_f - delta).abs().max()
                       / delta.abs().max()).item()
            check(d_delta <= TOL_DELTA,
                  f"attention bwd {name} {dtype}: the dQ kernel's delta "
                  f"max|d| / max|delta| = {d_delta:.3e} <= {TOL_DELTA:g}")
            d_dq = max(d_dq, (dq_f - want_dq).abs().max().item())
        check(d_dkv <= TOL_BWD and d_dq <= TOL_BWD,
              f"attention bwd {name} {dtype}: kernel fp32 outputs max|d| "
              f"dK/dV {d_dkv:.3e}, dQ {d_dq:.3e}"
              + (" (delta given and fused)" if dq_tile else "")
              + f" <= {TOL_BWD:g}")
        tol = TOL_BWD if dtype == torch.float32 else TOL_BWD_BF16
        ok = all(g.dtype == p.dtype and bool(
            ((g.float() - w).abs() <= tol + (0 if dtype == torch.float32
                                             else tol) * w.abs()).all())
            for g, w, p in zip(grads, wants, (q, k, v)))
        check(ok, f"attention bwd {name} {dtype}: wrapper grads in the "
                  f"primal dtype within {tol:g}"
                  + ("" if dtype == torch.float32 else f" + {tol:g}|g|"))
        if main:
            errs["flash_attention_bwd_dkv"] = max(
                errs.get("flash_attention_bwd_dkv", 0.0), d_dkv)
            dq_name = ("flash_attention_bwd_dq" if dq_tile
                       else "flash_attention_bwd_dq_row")
            errs[dq_name] = max(errs.get(dq_name, 0.0), d_dq)

    bf16 = torch.bfloat16
    train = dict(B=TRAIN_B, H=32, Hkv=2, T=TRAIN_T)
    case("train (12,32,128,128)/(12,2,128,128) causal GQA16", bf16,
         main=True, **train)
    case("train shape, dQ row route forced", bf16, main=True,
         dq_force="row", **train)
    case("train shape causal GQA16", torch.float32, **train)
    case("sliding window 16, T=100", torch.float32, B=2, H=8, Hkv=2, T=100,
         window=16)
    case("sliding window 16, T=100", bf16, B=2, H=8, Hkv=2, T=100,
         window=16)
    case("non-causal T=70", torch.float32, B=2, H=4, Hkv=4, T=70,
         causal=False)
    case("head_dim 32 causal T=64", torch.float32, B=2, H=8, Hkv=2, T=64,
         D=32)
    case("head_dim 32 causal T=64", bf16, B=2, H=8, Hkv=2, T=64, D=32)
    # the tile routes at the three head dims (at 256 each block owns 128
    # output columns) and GQA 1, 4, 8, 12 (dK/dV clusters of 6) and 16,
    # and long bands (T = 1000 ragged, T = 2048)
    for D in (64, 128, 256):
        case(f"non-causal GQA1 T=70 D={D}", bf16, B=2, H=4, Hkv=4, T=70,
             D=D, causal=False)
        case(f"non-causal window 8 GQA8 T=45 D={D}", bf16, B=1, H=8, Hkv=1,
             T=45, D=D, causal=False, window=8)
        case(f"causal GQA12 T=77 D={D}", bf16, B=2, H=12, Hkv=1, T=77, D=D)
        case(f"causal window 24 GQA4 T=150 D={D}", bf16, B=2, H=8, Hkv=2,
             T=150, D=D, window=24)
        case(f"causal GQA16 T=77 D={D}", bf16, B=2, H=32, Hkv=2, T=77, D=D)
    case("causal GQA16 T=1000 D=128", bf16, B=1, H=32, Hkv=2, T=1000)
    # zamba2-1.2b's shared block at its train shape: GQA 1, D 64
    case(f"zamba2-1.2b train (12,32,{ZAMBA_T},64) causal GQA1", bf16,
         main=True, B=TRAIN_B, H=32, Hkv=32, T=ZAMBA_T, D=64)
    case(f"causal GQA16 T={LONG_T} D=128", bf16, B=1, H=32, Hkv=2, T=LONG_T)
    # paligemma-3b's train shape, GQA 8 at head dim 256 (tile routes), and
    # head dim 256 in fp32 (row routes)
    case(f"paligemma-3b train ({PALI_B},8,{PALI_T},256) causal GQA8", bf16,
         main=True, B=PALI_B, H=8, Hkv=1, T=PALI_T, D=256)
    case("head dim 256 causal window 24 GQA8 T=100", torch.float32, B=2,
         H=8, Hkv=1, T=100, D=256, window=24)
    # whisper-small's cross attention at its train shape: Tq 448 != Tk
    # 1500, non-causal, GQA 1, D 64 (tile routes), and in fp32 (row routes)
    case(f"whisper-small cross train (12,12,{WHISPER_T},64)/(12,12,"
         f"{WHISPER_SRC},64) non-causal", bf16, main=True, B=TRAIN_B, H=12,
         Hkv=12, T=WHISPER_T, Tk=WHISPER_SRC, D=64, causal=False)
    case("cross (2,4,45)/(2,4,150) non-causal D=64", torch.float32, B=2,
         H=4, Hkv=4, T=45, Tk=150, D=64, causal=False)


def autograd_site_cases(gen):
    """The training site (kernels="auto": FlashAttentionFn over the forward
    and both backward kernels) against autograd of the plain forward; in
    bf16 every kernel on its tile route and no delta pass in torch."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    wrappers = (flash_attention, flash_attention_bwd_dkv,
                flash_attention_bwd_dq)
    tile_names = ("flash_attention_tile", "flash_attention_bwd_dkv",
                  "flash_attention_bwd_dq")
    for dtype, tol in ((torch.float32, TOL_SITE_F32),
                       (torch.bfloat16, TOL_SITE_BF16)):
        leaves = [torch.randn(4, TRAIN_T, h, 128, generator=gen,
                              device="cuda").to(dtype) for h in (32, 2, 2)]
        cot = torch.randn(4, TRAIN_T, 32, 128, generator=gen,
                          device="cuda").to(dtype)
        res = []
        for name in ("auto", "ref"):
            q, k, v = (t.clone().requires_grad_() for t in leaves)
            counts = {k_: n for w in wrappers
                      for k_, n in launch_counts(w).items()}
            passes = flash_attention_bwd.torch_delta_passes
            out = dispatch.get_backend(name).attention(q, k, v, causal=True)
            out.backward(cot)
            res.append([t.float() for t in (out, q.grad, k.grad, v.grad)])
            if name == "auto":
                now = {k_: n for w in wrappers
                       for k_, n in launch_counts(w).items()}
                tiles = tuple(now[n] - counts[n] for n in tile_names)
                torch_passes = flash_attention_bwd.torch_delta_passes - passes
                want = ((1, 1, 1), 0) if dtype == torch.bfloat16 else (
                    (0, 0, 0), 1)
                check((tiles, torch_passes) == want,
                      f"autograd site {dtype}: forward, dK/dV and dQ "
                      f"tile-route launches {tiles} and delta passes in "
                      f"torch {torch_passes} == {want}")
        torch.cuda.synchronize()
        scale = ([1.0] * 4 if dtype == torch.float32
                 else [b.abs().max().item() for b in res[1]])
        d = [(a - b).abs().max().item() / s
             for a, b, s in zip(*res, scale)]
        check(max(d) <= tol,
              f"autograd site (4,128,32,128)/(4,128,2,128) causal {dtype}: "
              f"out, dq, dk, dv vs autograd of the plain forward, max|d|"
              f"{'' if dtype == torch.float32 else ' / max|ref|'} "
              f"{', '.join(f'{x:.2e}' for x in d)} <= {tol:g}")


def wkv_inputs(gen, dtype, B, T, H=40, K=64, decays="model"):
    """r, k, v in ``dtype``, log_w and u float32, model layout.  ``decays``:
    "model" draws log_w = -exp(w), w ~ U(-6, -1) (per-token decay factors
    e^-0.0025 .. e^-0.37, the range of the model's w_dd around its w_base
    of -6; at chunk 128 the in-chunk log-decay reaches ~-47, inside fp32
    for the TPU algebra of the plain version); "strong" draws
    log_w ~ -U(0.05, 1), the JAX tests' range; "overflow" -U(0.7, 1), where
    e^{-L} of a 128-token chunk passes fp32's range."""
    dev = "cuda"
    r, k, v = (torch.randn(B, T, H, K, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    uni = torch.rand(B, T, H, K, generator=gen, device=dev)
    log_w = {"model": lambda: -torch.exp(-6.0 + 5.0 * uni),
             "strong": lambda: -(0.05 + 0.95 * uni),
             "overflow": lambda: -(0.7 + 0.3 * uni)}[decays]()
    u = torch.randn(H, K, generator=gen, device=dev)
    return r, k, v, log_w, u


def scaled_err(got, want) -> float:
    """max |got - want| over max(1, max |want|), in float32."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp(min=1.0)).item()


def wkv_kernel_cases(gen, errs):
    """The wkv forward (y, S_T, the per-chunk entry states) and backward
    (dr, dk, dv, dlog_w, du) kernels against their plain versions, one
    launch of each, and the same bits on a second launch."""
    from repro_torch.kernels.ref import rwkv_wkv_ref_model
    from repro_torch.kernels.rwkv_wkv import (rwkv_wkv, rwkv_wkv_bwd,
                                              rwkv_wkv_bwd_plain,
                                              rwkv_wkv_fwd, rwkv_wkv_plain)

    def counted(what, want, counts):
        """Runs ``want()`` and checks that it launched the forward and the
        backward ``counts`` times."""
        before = (rwkv_wkv.launches, rwkv_wkv_bwd.launches)
        out = want()
        n = (rwkv_wkv.launches - before[0], rwkv_wkv_bwd.launches - before[1])
        check(n == counts, f"wkv {what}: {counts[0]} forward and "
                           f"{counts[1]} backward launches")
        return out

    def case(name, dtype, *, B, T, H=40, K=64, chunk=128, decays="model",
             main=False):
        r, k, v, lw, u = wkv_inputs(gen, dtype, B, T, H, K, decays)
        ch = min(chunk, T)
        dy = torch.randn(B, T, H, K, generator=gen, device="cuda")
        dsT = torch.randn(B, H, K, K, generator=gen, device="cuda")
        want_y, want_sT, want_s0 = rwkv_wkv_plain(r, k, v, lw, u, chunk=ch,
                                                  emit_chunk_states=True)
        wants = rwkv_wkv_bwd_plain(r, k, v, lw, u, want_s0, dy, dsT,
                                   chunk=ch)
        wants = (*wants[:4], wants[4].reshape(B, H, K).sum(0))

        def run():
            (y, sT), s0 = rwkv_wkv_fwd(r, k, v, lw, u, chunk=chunk)
            y2, sT2 = rwkv_wkv(r, k, v, lw, u, chunk=chunk,
                               return_state=True)
            grads = rwkv_wkv_bwd(r, k, v, lw, u, s0, dy, dsT, chunk=chunk)
            return y, sT, s0, y2, sT2, grads
        y, sT, s0, y2, sT2, grads = counted(f"{name} {dtype}", run, (2, 1))
        torch.cuda.synchronize()
        d_fwd = max(scaled_err(y, want_y), scaled_err(sT, want_sT),
                    scaled_err(s0, want_s0))
        check(d_fwd <= TOL_WKV and torch.equal(y, y2)
              and torch.equal(sT, sT2),
              f"wkv fwd {name} {dtype}: y, S_T, S0 vs plain, max|d|/scale "
              f"{d_fwd:.2e} <= {TOL_WKV:g}; return_state path identical")
        tol = TOL_WKV_BWD if dtype == torch.float32 else TOL_WKV_BWD_BF16
        d_bwd = [scaled_err(g, w) for g, w in zip(grads, wants)]
        check(max(d_bwd) <= tol and all(
            g.dtype == t.dtype for g, t in zip(grads, (r, k, v, lw, u))),
              f"wkv bwd {name} {dtype}: dr, dk, dv, dlog_w, du vs plain, "
              f"max|d|/scale {', '.join(f'{x:.2e}' for x in d_bwd)} <= "
              f"{tol:g}, in the primal dtypes")
        (y3, sT3), s03 = rwkv_wkv_fwd(r, k, v, lw, u, chunk=chunk)
        grads3 = rwkv_wkv_bwd(r, k, v, lw, u, s0, dy, dsT, chunk=chunk)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in
                  zip((y, sT, s0, *grads), (y3, sT3, s03, *grads3))),
              f"wkv {name} {dtype}: a second launch of the forward and "
              f"backward gives the same bits")
        if main:
            errs["rwkv_wkv"] = max(errs.get("rwkv_wkv", 0.0), d_fwd)
            errs["rwkv_wkv_bwd"] = max(errs.get("rwkv_wkv_bwd", 0.0),
                                       max(d_bwd))

    for chunk in (8, 16, 32, 64):
        case(f"(2,128,4,64) chunk {chunk}, decays -U(0.05,1)",
             torch.float32, B=2, T=128, H=4, chunk=chunk, decays="strong")
    case("(2,128,4,64) chunk 64, decays -U(0.05,1)", torch.bfloat16, B=2,
         T=128, H=4, chunk=64, decays="strong")
    case("(2,100,4,64) chunk 32, T not a chunk multiple", torch.float32,
         B=2, T=100, H=4, chunk=32, decays="strong")
    case("(2,100,3,32) chunk 20, not a multiple of the 16-token sub-tile",
         torch.float32, B=2, T=100, H=3, K=32, chunk=20, decays="strong")
    case("(3,19,2,32) chunk 8, head_dim 32, ragged", torch.float32, B=3,
         T=19, H=2, K=32, chunk=8, decays="strong")
    case("(2,16,2,16) chunk 32 > T, head_dim 16", torch.float32, B=2, T=16,
         H=2, K=16, chunk=32, decays="strong")
    case("(12,70,12,32) chunk 32, B*H >= SMs at head_dim 32", torch.bfloat16,
         B=12, T=70, H=12, K=32, chunk=32, decays="strong")
    case("prefill (1,300,40,64) chunk 128", torch.bfloat16, B=1, T=300,
         main=True)
    case("prefill (1,300,40,64) chunk 128", torch.float32, B=1, T=300)
    case("train (12,512,40,64) chunk 128", torch.bfloat16, B=TRAIN_B,
         T=RWKV_T, main=True)
    case("train (12,512,40,64) chunk 128", torch.float32, B=TRAIN_B,
         T=RWKV_T)

    # decays at chunk 128 where the TPU algebra's e^{-L} passes fp32's
    # range and the kernels' exponents (all <= 0) do not; held
    # against the token-by-token oracle and autograd through it
    r, k, v, lw, u = wkv_inputs(gen, torch.float32, 1, 256, 4, 64,
                                "overflow")
    dy = torch.randn(1, 256, 4, 64, generator=gen, device="cuda")
    dsT = torch.randn(1, 4, 64, 64, generator=gen, device="cuda")

    def both():
        (y, sT), s0 = rwkv_wkv_fwd(r, k, v, lw, u, chunk=128)
        return y, sT, rwkv_wkv_bwd(r, k, v, lw, u, s0, dy, dsT, chunk=128)
    y, sT, grads = counted("(1,256,4,64) decays -U(0.7,1)", both, (1, 1))
    leaves = [t.clone().requires_grad_() for t in (r, k, v, lw, u)]
    want_y, want_sT = rwkv_wkv_ref_model(*leaves)
    wants = torch.autograd.grad((want_y * dy).sum() + (want_sT * dsT).sum(),
                                leaves)
    plain_y, _ = rwkv_wkv_plain(r, k, v, lw, u, chunk=128)
    torch.cuda.synchronize()
    d = [scaled_err(y, want_y.detach()), scaled_err(sT, want_sT.detach()),
         *(scaled_err(g, w) for g, w in zip(grads, wants))]
    check(max(d) <= TOL_WKV_BWD,
          f"wkv (1,256,4,64) chunk 128, decays -U(0.7,1): kernels vs the "
          f"token oracle and its autograd, max|d|/scale "
          f"{', '.join(f'{x:.2e}' for x in d)} <= {TOL_WKV_BWD:g} (the "
          f"plain chunked version is "
          f"{'finite' if torch.isfinite(plain_y).all() else 'not finite'} "
          f"here)")


def wkv_site_cases(gen):
    """WkvFn (kernels="auto": both kernels) against
    autograd of the plain forward (kernels="ref", models/ssm._wkv_chunked),
    cotangents on y and S_T."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.rwkv_wkv import rwkv_wkv, rwkv_wkv_bwd
    leaves = wkv_inputs(gen, torch.float32, 2, 256, 8, 64)
    dy = torch.randn(2, 256, 8, 64, generator=gen, device="cuda")
    dsT = torch.randn(2, 8, 64, 64, generator=gen, device="cuda")
    res, launched = [], []
    for name in ("auto", "ref"):
        xs = [t.clone().requires_grad_() for t in leaves]
        n = (rwkv_wkv.launches, rwkv_wkv_bwd.launches)
        y, sT = dispatch.get_backend(name).wkv(*xs, chunk=128)
        ((y * dy).sum() + (sT * dsT).sum()).backward()
        launched.append((rwkv_wkv.launches - n[0],
                         rwkv_wkv_bwd.launches - n[1]))
        res.append([y.detach(), sT.detach(), *(t.grad for t in xs)])
    torch.cuda.synchronize()
    d = [scaled_err(a, b) for a, b in zip(*res)]
    check(max(d) <= TOL_WKV_BWD and launched == [(1, 1), (0, 0)],
          f"wkv autograd site (2,256,8,64) chunk 128 fp32: y, S_T, dr, dk, "
          f"dv, dlog_w, du vs autograd of the plain forward, max|d|/scale "
          f"{', '.join(f'{x:.2e}' for x in d)} <= {TOL_WKV_BWD:g}; one "
          f"forward and one backward launch")


def phase_parity(state):
    from repro_torch import configs
    from repro_torch.configs import (deepseek_v3_671b, glm4_9b, paligemma_3b,
                                     rwkv6_3b, whisper_small, zamba2_1p2b)
    smoke_serve_parity(glm4_9b.smoke(), 4, 10)
    # whisper (cross attention over the zeros stub) and paligemma (token
    # only), as the JAX package serves them
    smoke_serve_parity(whisper_small.smoke(), 2, 20)
    smoke_serve_parity(paligemma_3b.smoke(), 2, 20)
    # zamba2: prompts of 2-19 tokens (1-3 chunks of 8; shorter than the
    # conv history too); deepseek: 1-12 (MLA's decode step and its causal
    # prefill)
    smoke_serve_parity(zamba2_1p2b.smoke(), 2, 20)
    smoke_serve_parity(deepseek_v3_671b.smoke(), 1, 13)
    train_parity(glm4_9b.smoke(), (("eq1", "none"), ("sum", "none"),
                                   ("eq1", "full")))
    rwkv_serve_parity(rwkv6_3b.smoke())
    train_parity(rwkv6_3b.smoke().with_(exit_layers=(1, 2)),
                 (("eq1", "none"), ("eq1", "full")), seq=20)
    bf16_parity({f: configs.get(f).smoke_bf16() for f in BF16_FAMILIES})


def smoke_serve_parity(cfg, lo: int, hi: int) -> None:
    """``cfg`` (an fp32 smoke) served by ServeSession, 6 requests of
    ``lo``..``hi - 1`` prompt tokens on 3 slots, against each request
    served alone (the port's sequential references), token and exit
    exact: select at tau 2.0, sticky at the median entropy of a probe and
    above ln V (client-only ticks)."""
    from repro_torch.api.serve_session import (ServeSession,
                                               sequential_reference,
                                               sequential_sticky_reference)
    from repro_torch.models.backbone import init_backbone
    params = init_backbone(torch.Generator(device="cuda").manual_seed(0), cfg)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi)))
               for _ in range(6)]
    decodes = [5, 8, 3, 6, 4, 7]
    probe = sequential_reference(cfg, params, prompts[0], 6, tau=0.0,
                                 max_len=32)
    for policy, tau, ref_fn in (
            ("select", 2.0, sequential_reference),
            ("sticky", float(np.median(probe.entropy)),
             sequential_sticky_reference),
            ("sticky", 1.1 * math.log(cfg.vocab_size),
             sequential_sticky_reference)):
        sess = ServeSession(cfg, params, tau=tau, slots=3, max_len=32,
                            exit_policy=policy)
        for p, d in zip(prompts, decodes):
            sess.submit(p, decode_tokens=d)
        got = {r.rid: r for r in sess.run()}
        worst, same = 0.0, True
        for rid, (p, d) in enumerate(zip(prompts, decodes)):
            ref = ref_fn(cfg, params, p, d, tau=tau, max_len=32)
            same &= (got[rid].tokens == ref.tokens
                     and got[rid].exited == ref.exited)
            worst = max(worst, float(np.abs(np.subtract(
                got[rid].entropy, ref.entropy)).max()))
        flags = [f for r in got.values() for f in r.exited]
        check(same and worst <= TOL_H,
              f"{cfg.name} fp32 {policy} tau={tau:.4f}: 6 requests on 3 "
              f"slots token- and exit-exact vs the sequential reference, "
              f"max|dH|={worst:.2e} (exits {sum(flags)}/{len(flags)}, "
              f"client-only ticks {sess.stats.client_only_ticks})")
        if tau > math.log(cfg.vocab_size):
            check(sess.stats.client_only_ticks > 0,
                  f"{cfg.name} sticky above ln V: client-only ticks ran")


@contextlib.contextmanager
def planted(name, fault):
    """A control: ``name`` replaced by ``fault(original)`` while the block
    runs, so a check can show that it rejects a wrong kernel or module:
    a kernel wrapper of ``kernels.dispatch`` the model calls, or a dotted
    ``module.function`` of the port."""
    import importlib
    module, _, attr = name.rpartition(".")
    mod = importlib.import_module(module or "repro_torch.kernels.dispatch")
    real = getattr(mod, attr)
    setattr(mod, attr, fault(real))
    try:
        yield
    finally:
        setattr(mod, attr, real)


def dk_zeroed(bwd):
    """A backward (attention: dq, dk, dv; wkv: dr, dk, dv, dlog_w, du)
    whose dk is zero."""
    def wrapped(*a, **kw):
        out = list(bwd(*a, **kw))
        out[1] = torch.zeros_like(out[1])
        return tuple(out)
    return wrapped


def dk_half_zeroed(bwd):
    """An attention backward whose dk is zero in its second half of head
    columns (at head dim 256, the second column block of the tile
    routes)."""
    def wrapped(*a, **kw):
        dq, dk, dv = bwd(*a, **kw)
        dk = dk.clone()
        dk[..., dk.shape[-1] // 2:] = 0
        return dq, dk, dv
    return wrapped


def bwd_zeroed(bwd):
    """An attention backward whose dq, dk and dv are all zero."""
    def wrapped(*a, **kw):
        return tuple(torch.zeros_like(g) for g in bwd(*a, **kw))
    return wrapped


def rope_dropped(project_q):
    """MLA's query projection with its rope half zeroed: the positional
    term of every score dropped."""
    def wrapped(*a, **kw):
        q_nope, q_rope, split = project_q(*a, **kw)
        return q_nope, torch.zeros_like(q_rope), split
    return wrapped


# the planted faults of the bf16 parity controls, by mixer: a forward
# fault that serving runs and a backward fault that training runs
ATTENTION_FAULTS = (
    ("flash_attention", "the newest key dropped at decode",
     lambda f: lambda q, k, v, *, kv_valid=None, **kw: f(
         q, k, v, kv_valid=None if kv_valid is None
         else (kv_valid - 1).clamp(min=1), **kw)),
    ("flash_attention_bwd", "dK zeroed", dk_zeroed))
FAULTS = {
    "attn": ATTENTION_FAULTS,
    "rwkv6": (("rwkv_wkv", "the bonus u dropped",
               lambda f: lambda r, k, v, lw, u, **kw: f(
                   r, k, v, lw, torch.zeros_like(u), **kw)),
              ("rwkv_wkv_bwd", "dk zeroed", dk_zeroed)),
    # zamba2's one shared attention layer among three Mamba2 layers, with
    # the gate below it: the newest key dropped at decode moved no stream
    # beyond a tie (one part at top-2 gap 0 in 45 tokens, H-1 of the
    # page's keys still read), so its serving control reads key slot 0
    # only, as a stale ring would
    "shared_attn": (
        ("flash_attention", "decode reading key slot 0 only",
         lambda f: lambda q, k, v, *, kv_valid=None, **kw: f(
             q, k, v, kv_valid=None if kv_valid is None
             else torch.ones_like(kv_valid), **kw)),
        ("flash_attention_bwd", "dK zeroed", dk_zeroed)),
    # MLA runs no kernel: its control is a fault in the mixer itself, in
    # the kernels' run only (serving and training alike)
    "mla": (("repro_torch.models.attention._mla_project_q",
             "the MLA rope half dropped", rope_dropped),) * 2,
}
# the MoE smoke's loss comparison: its 4 attention layers carry a small
# share of the loss beside the MoE FFNs, and on an H100 dK zeroed moved
# qwen3-moe's smoke losses by 1.0e-3 over 3 steps, within 2x of the sound
# reading (6.0e-4, routing pinned); the losses are held against the whole
# attention backward zeroed instead (2.0e-3), and the first-step
# gradients still reject dK zeroed leaf by leaf (1.0 against 1.6e-2)
MOE_LOSS_FAULT = ("flash_attention_bwd", "dQ, dK and dV zeroed", bwd_zeroed)
# zamba2's smoke: its one shared attention layer sits above both exits of
# the training setup, so only the server loss reads it, and over 3 steps
# its backward moves that loss little: on an H100 dK zeroed read 1.12e-3
# and the whole backward zeroed 1.41e-3 against a sound 9.13e-4; the
# losses are held against the training forward's causal mask dropped
# instead, and the first-step gradients reject dK zeroed leaf by leaf
# (1.0 against 2.6e-2)
CAUSAL_LOSS_FAULT = ("flash_attention", "the causal mask dropped in "
                     "training", lambda f: lambda q, k, v, *, causal=False,
                     **kw: f(q, k, v, causal=False, **kw))
# whisper's smoke: its serving runs the zeros stub, where cross attention
# adds exactly 0, so its serving control is decode attention's; its
# gradients and losses run a random enc, and their control zeroes the
# cross-attention output (a missing cross attention)
CROSS_FAULT = ("repro_torch.models.attention.cross_attn_forward",
               "the cross-attention output zeroed",
               lambda f: lambda params, x, enc, cfg: torch.zeros_like(x))
FAULTS["cross"] = (ATTENTION_FAULTS[0], CROSS_FAULT)
# head dim 256 (paligemma's smoke): the tile backward splits dK's columns
# between two blocks, so a fault in one block's half is held too.  Its
# losses cannot tell it from bf16 rounding (6.6e-3 against a sound 5.3e-3
# on an H100, scripts/bf16_loss_witness.py); its first-step gradients can
# (0.71 against 1.5e-2)
WIDE_HEAD_FAULT = ("flash_attention_bwd", "dK's second half of head "
                   "columns zeroed", dk_half_zeroed)
# the bf16 smokes phase parity holds against the plain versions: every
# ported config's (the three dense ones, qwen3-moe, zamba2's shared
# block, whisper's self and cross attention and paligemma's head dim 256
# on the attention kernels, rwkv6 on the wkv kernels, deepseek-v3's MLA on
# none but the gate)
BF16_FAMILIES = ("glm4_9b", "phi3_medium_14b", "minitron_8b",
                 "command_r_35b", "qwen3_moe_235b_a22b", "rwkv6_3b",
                 "zamba2_1p2b", "deepseek_v3_671b", "whisper_small",
                 "paligemma_3b")


def kernel_mixer(cfg) -> str:
    """The mixer whose kernels a config's layers run: ``"shared_attn"``
    for Zamba2's shared attention block among its Mamba2 layers,
    ``"cross"`` for attention with cross attention (Whisper), else the
    first layer's mixer."""
    if "shared_attn" in cfg.block_pattern:
        return "shared_attn"
    if cfg.cross_attention:
        return "cross"
    return cfg.block_pattern[0]


def bf16_parity(cfgs: dict) -> None:
    """The bf16 smokes at full head width against the plain versions,
    ``cfgs`` by family: the attention families (head dim 64: the attention
    forward's tile and decode routes, the backward's tile routes; glm4-9b
    GQA 2, phi3 and minitron 4, command-r 8, qwen3-moe 2 with its routers
    in fp32, zamba2's shared block 1), rwkv6 (head dim 64, chunk 16: the
    wkv kernels) and deepseek-v3 (MLA: the gate only); ServeSession under
    both policies, the first step's gradients leaf by
    leaf, then eq1 steps' losses (rwkv6 also with remat).  Every
    comparison also runs under its mixer's planted fault (``FAULTS``) and
    must reject it.  Each prints its readings, and failures are raised
    together at the end."""
    from repro_torch.kernels.entropy_exit import entropy_exit
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from repro_torch.kernels.rwkv_wkv import rwkv_wkv, rwkv_wkv_bwd
    from repro_torch.parity import TOL_LOSS_BF16
    rng = np.random.default_rng(5)
    # prompts of 12-48 tokens: attention prefill at G = 2 takes the tile
    # route from 32 tokens up and the decode route below; rwkv6 1-3 chunks
    # of 16.  At GQA 1 (zamba2) the tile route starts at 64 tokens: its
    # prompts run to 96
    vocab = min(cfg.vocab_size for cfg in cfgs.values())
    prompts = [rng.integers(0, vocab, int(rng.integers(12, 49)))
               for _ in range(6)]
    long_prompts = [rng.integers(0, vocab, int(rng.integers(12, 97)))
                    for _ in range(6)]
    decodes = [6, 9, 4, 7, 5, 8]
    # per mixer: (read, ok, what) of the serving launches and of the
    # training launches, and the training modes
    mixers = {
        "attn": (
            (lambda: (flash_attention.tile_launches,
                      flash_attention.decode_launches,
                      flash_attention.row_launches),
             lambda n: n[0] > 0 and n[1] > 0 and n[2] == 0,
             "tile and decode routes"),
            (lambda: (flash_attention_bwd_dkv.tile_launches,
                      flash_attention_bwd_dq.tile_launches,
                      flash_attention_bwd_dkv.row_launches,
                      flash_attention_bwd_dq.row_launches),
             lambda n: n[0] > 0 and n[1] > 0 and n[2] == n[3] == 0,
             "dK/dV and dQ tile routes"),
            (("eq1", "none"),)),
        "rwkv6": (
            (lambda: (rwkv_wkv.launches,), lambda n: n[0] > 0, "wkv kernel"),
            (lambda: (rwkv_wkv_bwd.launches,), lambda n: n[0] > 0,
             "wkv backward kernel"),
            (("eq1", "none"), ("eq1", "full"))),
        # MLA: the gate is the one kernel; training runs none
        "mla": (
            (lambda: (entropy_exit.launches,), lambda n: n[0] > 0,
             "entropy gate"),
            None, (("eq1", "none"),))}
    mixers["shared_attn"] = mixers["cross"] = mixers["attn"]
    failed = []
    for family, cfg in cfgs.items():
        mixer = kernel_mixer(cfg)
        serve_counts, train_counts, modes = mixers[mixer]
        fwd_fault, bwd_fault = FAULTS[mixer]
        ps = long_prompts if cfg.q_heads_per_kv == 1 else prompts
        runs = [lambda p=p, ps=ps: bf16_serve_parity(
                    cfg, ps, decodes, p, serve_counts, fwd_fault)
                for p in ("select", "sticky")]
        runs.append(lambda: bf16_grad_parity(cfg, bwd_fault))
        if cfg.head_dim > 128:
            runs.append(lambda: bf16_grad_parity(cfg, WIDE_HEAD_FAULT))
        runs.append(lambda: train_parity(
            cfg.with_(exit_layers=(1, 2)), modes,
            tol_loss=TOL_LOSS_BF16[family], counts=train_counts,
            fault=(CAUSAL_LOSS_FAULT if mixer == "shared_attn"
                   else MOE_LOSS_FAULT if cfg.moe and mixer == "attn"
                   else bwd_fault)))
        for run in runs:
            try:
                run()
            except Failed as e:
                failed.append(str(e))
    if failed:
        raise Failed("; ".join(failed))


def bf16_serve_parity(cfg, prompts, decodes, policy, counts, fault) -> None:
    """``cfg`` (a bf16 smoke): ServeSession with the kernels, 6 requests on
    3 slots, against each request served alone on the plain versions
    (``parity.stream_parity``: a stream may part only at a near tie;
    entropies within TOL_H_BF16), then the same under the planted forward
    fault, which the comparison must reject.  ``counts`` = (read, ok,
    what): the kernels' run must satisfy ``ok(launches)``."""
    from repro_torch.api.serve_session import (ServeSession,
                                               sequential_reference,
                                               sequential_sticky_reference)
    from repro_torch.models.backbone import init_backbone
    from repro_torch.parity import (TIE_GAP_BF16, TOL_H_BF16, live_rwkv,
                                    stream_parity)
    params = init_backbone(torch.Generator(device="cuda").manual_seed(0), cfg)
    live_rwkv(params)
    # 64-token pages, longer where the prompts need (GQA 1's)
    max_len = max(64, 16 * -(-(max(len(p) for p in prompts) + 1
                               + max(decodes)) // 16))
    probe = ServeSession(cfg, params, tau=0.0, slots=1, max_len=max_len)
    probe.submit(prompts[0], decode_tokens=6)
    tau = float(np.median(probe.run()[0].entropy))
    ref_fn = (sequential_sticky_reference if policy == "sticky"
              else sequential_reference)
    ref_cfg = cfg.with_(kernels="ref")
    wants = [ref_fn(ref_cfg, params, p, d, tau=tau, max_len=max_len)
             for p, d in zip(prompts, decodes)]

    def served():
        sess = ServeSession(cfg, params, tau=tau, slots=3, max_len=max_len,
                            exit_policy=policy)
        for p, d in zip(prompts, decodes):
            sess.submit(p, decode_tokens=d)
        before = counts[0]()
        got = {r.rid: r for r in sess.run()}
        return got, [a - b for a, b in zip(counts[0](), before)]

    got, n = served()
    sound = stream_parity(got, wants, tau)
    name, what, fault_fn = fault
    with planted(name, fault_fn):
        control = stream_parity(served()[0], wants, tau)
    gaps = [g for w in wants for g in w.top2_gap]
    print(f"  reading {cfg.name} {policy}: sound max|dH| {sound.max_dh:.3e}, "
          f"{sound.compared} tokens equal, parted {sound.parted or 'none'}; "
          f"control ({what}): max|dH| {control.max_dh:.3e}, "
          f"{control.compared} tokens equal, parted "
          f"{control.parted or 'none'}, within limits {control.ok}; "
          f"smallest plain top-2 gap {min(gaps):.3e}")
    check(sound.ok and sound.max_dh <= TOL_H_BF16 and counts[1](n),
          f"{cfg.name} {policy} tau={tau:.4f}: 6 requests on 3 slots, "
          f"kernels vs plain in bf16: {sound.compared} tokens equal, "
          f"{len(sound.parted)} streams part at a near tie (top-2 gap < "
          f"{TIE_GAP_BF16:g}, |H - tau| <= {TOL_H_BF16:g}), max|dH| "
          f"{sound.max_dh:.2e} <= {TOL_H_BF16:g}; the kernels ran on the "
          f"{counts[2]} (launches {n})")
    check(not control.ok or control.max_dh > TOL_H_BF16,
          f"{cfg.name} {policy}: the same comparison rejects a planted "
          f"fault ({what})")


def bf16_grad_parity(cfg, fault) -> None:
    """The first eq1 step's gradients of ``cfg`` (a bf16 smoke, exits 1
    and 2) with the kernels against the plain versions, each leaf's
    ||g - g_plain|| / ||g_plain|| within TOL_GRAD_BF16; under the planted
    backward fault the largest must exceed it."""
    from repro_torch.config import HeteroProfile, SplitEEConfig
    from repro_torch.core.spmd import StepConfig, make_grad_step
    from repro_torch.models.backbone import init_backbone
    from repro_torch.parity import (TOL_GRAD_BF16, TRAIN_PROFILE, Routes,
                                    grad_rel_errors, live_rwkv, pinned_routes,
                                    smoke_batches)
    base = cfg.with_(exit_layers=(1, 2))
    profile = HeteroProfile(TRAIN_PROFILE)
    batch = smoke_batches(base)[0]
    routes = Routes()

    def grads(kernels, replay=True):
        c = base.with_(kernels=kernels)
        params = init_backbone(torch.Generator(device="cuda").manual_seed(0),
                               c)
        live_rwkv(params)
        step = make_grad_step(StepConfig(
            model=c, splitee=SplitEEConfig(profile=profile)))
        with pinned_routes(routes, replay) if c.moe else \
                contextlib.nullcontext():
            return step(params, batch)[0], leaf_paths(params)

    want, paths = grads("ref", replay=False)
    sound = grad_rel_errors(grads("auto")[0], want)
    flips = f"{routes.flipped} of {routes.tokens}"
    name, what, fault_fn = fault
    with planted(name, fault_fn):
        control = grad_rel_errors(grads("auto")[0], want)
    worst = int(np.argmax(sound))
    print(f"  reading {cfg.name} first-step gradients, max over "
          f"{len(sound)} leaves of ||g - g_plain|| / ||g_plain||: sound "
          f"{sound[worst]:.3e} ({paths[worst]}); control ({what}) "
          f"{max(control):.3e} ({paths[int(np.argmax(control))]})"
          + (f"; routing pinned to the plain run's, the kernels' own "
             f"top-k differs for {flips} token choices" if base.moe else ""))
    check(max(sound) <= TOL_GRAD_BF16 < max(control),
          f"{cfg.name} bf16 first-step gradients, kernels vs plain: every "
          f"leaf within {TOL_GRAD_BF16:g} (max {max(sound):.2e}); the "
          f"planted fault ({what}) exceeds it ({max(control):.2e})")


def leaf_paths(tree, prefix: str = "") -> list:
    """The paths of ``tree``'s leaves, in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in leaf_paths(t, f"{prefix}/{i}")]
    return [prefix]


def rwkv_serve_parity(cfg) -> None:
    """rwkv6 smoke, fp32: the batched ServeSession with the kernels
    (kernels="auto": the wkv forward at prefill, the gate every tick)
    against the same session on the plain versions (kernels="ref"),
    prompts of 1-4 chunks of 8 tokens, decay LoRA and bonus live."""
    from repro_torch.api.serve_session import (ServeSession,
                                               sequential_reference)
    from repro_torch.kernels.rwkv_wkv import rwkv_wkv
    from repro_torch.models.backbone import init_backbone
    from repro_torch.parity import live_rwkv
    params = init_backbone(torch.Generator(device="cuda").manual_seed(0), cfg)
    live_rwkv(params)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 33)))
               for _ in range(6)]
    decodes = [5, 8, 3, 6, 4, 7]
    probe = sequential_reference(cfg, params, prompts[0], 6, tau=0.0,
                                 max_len=48)
    for policy, tau in (("select", 2.0),
                        ("sticky", float(np.median(probe.entropy)))):
        runs = []
        for kernels in ("auto", "ref"):
            sess = ServeSession(cfg, params, tau=tau, slots=3, max_len=48,
                                exit_policy=policy, kernels=kernels)
            for p, d in zip(prompts, decodes):
                sess.submit(p, decode_tokens=d)
            n = rwkv_wkv.launches
            runs.append(({r.rid: r for r in sess.run()},
                         rwkv_wkv.launches - n, sess.stats))
        (got, n_auto, st), (want, n_ref, _) = runs
        same = all(got[i].tokens == want[i].tokens
                   and got[i].exited == want[i].exited for i in want)
        worst = max(float(np.abs(np.subtract(got[i].entropy,
                                             want[i].entropy)).max())
                    for i in want)
        flags = [f for r in got.values() for f in r.exited]
        check(same and worst <= TOL_H and n_auto > 0 and n_ref == 0,
              f"rwkv6 smoke fp32 {policy} tau={tau:.4f}: 6 requests on 3 slots, "
              f"kernels token- and exit-exact vs plain, max|dH|="
              f"{worst:.2e} (exits {sum(flags)}/{len(flags)}, client-only "
              f"ticks {st.client_only_ticks}, {n_auto} wkv launches)")


def train_parity(base, modes, steps: int = 3, seq: int = 32,
                 tol_loss: float = TOL_TRAIN_LOSS, counts=None,
                 fault=None) -> None:
    """Smoke config ``base`` (TF32 off): make_train_step with the kernels
    (kernels="auto") against the plain versions (kernels="ref"), one run
    per (grad_mode, remat) of ``modes``; rwkv6 mixers live
    (``parity.live_rwkv``).
    fp32: losses within ``tol_loss`` and the params as stated at
    TRAIN_PARAM_FRACTION; bf16 (``base.dtype``): the losses only (the
    first step's gradients are held leaf by leaf in ``bf16_grad_parity``),
    and under the planted ``fault`` too, whose reading is printed.
    ``counts`` = (read, ok, what): the kernels' run must satisfy
    ``ok(launches by route)``."""
    from repro_torch.config import (HeteroProfile, OptimizerConfig,
                                    SplitEEConfig, TrainConfig)
    from repro_torch import parity
    from repro_torch.core.spmd import StepConfig, make_train_step
    from repro_torch.models.backbone import init_backbone
    from repro_torch.optim import adam_init
    from repro_torch.tree import tree_leaves
    profile = HeteroProfile(parity.TRAIN_PROFILE)
    lr = parity.TRAIN_LR
    batches = parity.smoke_batches(base, steps, seq)
    bf16 = base.dtype == torch.bfloat16
    for grad_mode, remat in modes:
        routes = parity.Routes()

        def run(kernels, replay=True):
            cfg = base.with_(kernels=kernels)
            before = counts[0]() if counts else ()
            sc = StepConfig(model=cfg, splitee=SplitEEConfig(profile=profile),
                            train=TrainConfig(optimizer=OptimizerConfig(
                                lr=lr, total_steps=2 * steps), remat=remat),
                            grad_mode=grad_mode)
            params = init_backbone(
                torch.Generator(device="cuda").manual_seed(0), cfg)
            parity.live_rwkv(params)
            opt = adam_init(params, sc.train.optimizer)
            step = make_train_step(sc)
            losses = []
            with parity.pinned_routes(routes, replay) if cfg.moe else \
                    contextlib.nullcontext():
                for b in batches:
                    params, opt, m = step(params, opt, b)
                    losses.append([float(v) for k, v in sorted(m.items())
                                   if k != "lr"])
            if counts and kernels == "auto":
                n = [a - b for a, b in zip(counts[0](), before)]
                check(counts[1](n), f"{base.name} train {grad_mode} "
                      f"remat={remat}: the kernels ran on the {counts[2]} "
                      f"(launches {n})")
            return params, np.asarray(losses)

        # MoE: the plain run's routing, recorded first, is replayed by the
        # kernels' runs (parity.pinned_routes)
        (p1, l1), (p0, l0) = run("ref", replay=False), run("auto")
        flips = f"{routes.flipped} of {routes.tokens}"
        d_loss = float(np.abs(l0 - l1).max())
        if bf16:
            d_fault = 0.0
            if fault:
                with planted(fault[0], fault[2]):
                    d_fault = float(np.abs(run("auto")[1] - l1).max())
                print(f"  reading {base.name} train {grad_mode} "
                      f"remat={remat}: losses max|d| sound {d_loss:.3e}, "
                      f"control ({fault[1]}) {d_fault:.3e}"
                      + (f"; routing pinned to the plain run's, the "
                         f"kernels' own top-k differs for {flips} token "
                         f"choices" if base.moe else ""))
            check(d_loss <= tol_loss and (not fault or d_fault > tol_loss),
                  f"{base.name} bf16 train {grad_mode} remat={remat}: "
                  f"{steps} steps kernels vs plain, losses max|d|="
                  f"{d_loss:.2e} <= {tol_loss:g} (losses "
                  f"{l0.min():.3f}..{l0.max():.3f})"
                  + (f"; the planted fault ({fault[1]}) exceeds it "
                     f"({d_fault:.2e})" if fault else ""))
            continue
        d = torch.cat([(a - b).abs().flatten()
                       for a, b in zip(tree_leaves(p0), tree_leaves(p1))])
        n_off = int((d > 1e-6).sum())
        check(d_loss <= tol_loss and d.max().item() <= lr
              and n_off <= TRAIN_PARAM_FRACTION * d.numel(),
              f"{base.name} fp32 train {grad_mode} remat={remat}: {steps} "
              f"steps kernels vs plain, losses max|d|={d_loss:.2e} <= "
              f"{tol_loss:g}; params max|d|={d.max().item():.2e} <= lr,"
              f" {n_off} of {d.numel()} beyond 1e-6 (<= "
              f"{TRAIN_PARAM_FRACTION:g} of them)")


def weight_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    items = tree.values() if isinstance(tree, dict) else tree
    return sum(weight_bytes(t) for t in items)


def phase_main(state):
    from repro_torch import configs
    from repro_torch.configs import glm4_9b, rwkv6_3b
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.e2e_train import cut_depth
    from repro_torch.kernels.rwkv_wkv import rwkv_wkv

    # glm4-9b: prompts of 16-128 tokens, 40 layers of KV pages
    cfg = glm4_9b.config()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(16, 129)))
               for _ in range(REQUESTS)]
    kv_bytes = 2 * cfg.num_layers * SLOTS * MAX_LEN * cfg.num_kv_heads \
        * cfg.head_dim * 2
    serve_main(state, cfg, prompts, MAX_LEN, flash_attention,
               cache_read=kv_bytes, cache_note="KV pages",
               counts_per_tick=True)

    # rwkv6-3b: prompts of 64-512 tokens (1-4 chunks); each slot's state,
    # 40 heads x 64 x 64 fp32 per layer, is read and written every tick
    cfg = rwkv6_3b.config()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size,
                            int(rng.integers(RWKV_PROMPT_MIN,
                                             RWKV_PROMPT_MAX + 1)))
               for _ in range(REQUESTS)]
    H, K = cfg.d_model // cfg.ssm.head_dim, cfg.ssm.head_dim
    state_bytes = 2 * cfg.num_layers * SLOTS * H * K * K * 4
    serve_main(state, cfg, prompts, RWKV_PROMPT_MAX + 1 + DECODE, rwkv_wkv,
               cache_read=state_bytes, cache_note="recurrent states read "
               "and written", counts_per_tick=False)

    # qwen3-moe-235b-a22b and command-r-35b at their published widths, the
    # depth cut to 8 layers (exits 2, 4, 6): ~46 GB and ~32 GB of weights
    for arch in ("qwen3_moe_235b_a22b", "command_r_35b"):
        cfg, _ = cut_depth(configs.get(arch).config(), SERVE_CUT_LAYERS)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(16, 129)))
                   for _ in range(REQUESTS)]
        kv_bytes = 2 * cfg.num_layers * SLOTS * MAX_LEN * \
            cfg.num_kv_heads * cfg.head_dim * 2
        serve_main(state, cfg, prompts, MAX_LEN, flash_attention,
                   cache_read=kv_bytes, cache_note="KV pages",
                   counts_per_tick=True,
                   probe=moe_drops if cfg.moe is not None else None)

    # zamba2-1.2b at full width and depth: prompts of 64-600 tokens (1-3
    # chunks of 256); per tick each slot's Mamba2 states (64 heads x 64 x
    # 64 fp32 and the conv tail, read and written) in 32 layers and the
    # shared block's KV pages in 6
    from repro_torch.configs import zamba2_1p2b
    cfg = zamba2_1p2b.config()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size,
                            int(rng.integers(ZAMBA_PROMPT_MIN,
                                             ZAMBA_PROMPT_MAX + 1)))
               for _ in range(REQUESTS)]
    attn_layers = [l for l, b in enumerate(cfg.block_pattern)
                   if b == "shared_attn"]
    n_mamba = cfg.num_layers - len(attn_layers)
    d_inner = cfg.ssm.expand * cfg.d_model
    conv_ch = d_inner + 2 * cfg.ssm.d_state
    state_bytes = n_mamba * SLOTS * 2 * (
        d_inner * cfg.ssm.d_state * 4 + (cfg.ssm.d_conv - 1) * conv_ch * 2)
    kv_bytes = 2 * len(attn_layers) * SLOTS * ZAMBA_MAX_LEN * \
        cfg.num_kv_heads * cfg.head_dim * 2
    serve_main(state, cfg, prompts, ZAMBA_MAX_LEN, flash_attention,
               cache_read=state_bytes + kv_bytes,
               cache_note="Mamba2 states read and written, shared-block KV "
               "pages", counts_per_tick=True, kernel_layers=attn_layers)

    # deepseek-v3-671b at its published widths cut to 5 layers (3 dense,
    # 2 MoE; exits 1, 2, 3): ~58.8 GB; MLA caches one 512-wide latent and
    # one 64-wide rope key a token; no attention kernel (the gate only)
    cfg, _ = cut_depth(configs.get("deepseek_v3_671b").config(),
                       DEEPSEEK_CUT_LAYERS)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(16, 129)))
               for _ in range(REQUESTS)]
    latent_bytes = cfg.num_layers * SLOTS * MAX_LEN * (
        cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * 2
    serve_main(state, cfg, prompts, MAX_LEN, None, cache_read=latent_bytes,
               cache_note="MLA latent pages", counts_per_tick=True,
               probe=moe_drops)

    # whisper-small at full width and depth (12 layers): prompts of 64-128
    # tokens, so every prefill's self and cross attention (GQA 1) is on
    # the tile route; each layer launches both, at prefill and every tick.
    # As in the JAX package every tick projects the zeros stub of the 1500
    # encoder frames and recomputes each layer's cross K/V from it: per
    # tick the stub read, its projection written, and per layer the
    # projection read twice, K and V written and read by the kernel
    from repro_torch.configs import paligemma_3b, whisper_small
    cfg = whisper_small.config()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(64, 129)))
               for _ in range(REQUESTS)]
    S, d = cfg.cross_source_len, cfg.d_model
    kv_bytes = 2 * cfg.num_layers * SLOTS * MAX_LEN * cfg.num_kv_heads \
        * cfg.head_dim * 2
    cross_bytes = SLOTS * S * (768 + d) * 2 \
        + cfg.num_layers * 6 * SLOTS * S * d * 2
    serve_main(state, cfg, prompts, MAX_LEN, flash_attention,
               cache_read=kv_bytes + cross_bytes,
               cache_note="KV pages, the cross K/V recomputed from the "
               "zeros stub", counts_per_tick=True,
               kernel_layers=list(range(cfg.num_layers)) * 2)

    # paligemma-3b at full width and depth (18 layers, GQA 8, head dim
    # 256): token-only, as the JAX package serves it; prompts of 16-128
    # tokens (prefill on the tile route), decode ticks on the decode route
    cfg = paligemma_3b.config()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(16, 129)))
               for _ in range(REQUESTS)]
    kv_bytes = 2 * cfg.num_layers * SLOTS * MAX_LEN * cfg.num_kv_heads \
        * cfg.head_dim * 2
    serve_main(state, cfg, prompts, MAX_LEN, flash_attention,
               cache_read=kv_bytes, cache_note="KV pages",
               counts_per_tick=True)


def moe_drops(cfg, params, prompts, max_len) -> None:
    """A separate serve run of the first SLOTS prompts and 4 decode ticks
    with every MoE call's expert loads read (a host sync each, so not
    timed): routed entries dropped by capacity per prefill and per decode
    tick.  A decode tick routes each slot alone (N = 1, C = 4 >= top_k
    distinct experts), so it drops none."""
    from repro_torch.api.serve_session import ServeSession
    from repro_torch.models import moe
    real, drops = moe.moe_forward, {"prefill": [], "decode": []}

    def counting(p, x, c, groups=1):
        B, T, d = x.shape
        N = B * T // groups
        topi, _, _ = moe.route(p, x.reshape(groups, N, d), c.moe)
        load = (topi[..., None] == torch.arange(
            c.moe.num_experts, device=x.device)).sum((-3, -2))
        C = moe.expert_capacity(N, c.moe)
        n = int((load - torch.where(load > C, C - 1, load)).sum())
        drops["prefill" if T > 1 else "decode"].append(n)
        return real(p, x, c, groups)

    moe.moe_forward = counting
    try:
        sess = ServeSession(cfg, params, tau=2.0, slots=SLOTS,
                            max_len=max_len)
        for p in prompts[:SLOTS]:
            sess.submit(p, decode_tokens=4)
        sess.run()
    finally:
        moe.moe_forward = real
    L = cfg.ffn_pattern.count("moe")
    pre = [sum(drops["prefill"][i:i + L])
           for i in range(0, len(drops["prefill"]), L)]
    dec = [sum(drops["decode"][i:i + L])
           for i in range(0, len(drops["decode"]), L)]
    cap = [moe.expert_capacity(len(p), cfg.moe) for p in prompts[:SLOTS]]
    print(f"{cfg.name} routed entries dropped by capacity (top-{cfg.moe.top_k}"
          f" of {cfg.moe.num_experts}, capacity factor "
          f"{cfg.moe.capacity_factor}): per prefill over {L} MoE layers "
          f"{pre} "
          f"(prompts {[len(p) for p in prompts[:SLOTS]]} tokens, C {cap}); "
          f"per decode tick {dec}")
    check(len(dec) > 0 and not any(dec),
          f"{cfg.name}: no entry dropped on a decode tick (each slot routed "
          f"alone)")


def serve_main(state, cfg, prompts, max_len, kernel, *, cache_read: int,
               cache_note: str, counts_per_tick: bool, probe=None,
               kernel_layers=None) -> None:
    """ServeSession on ``cfg`` at full width, bf16, random weights from a
    seeded torch.Generator on the card: 8 slots, the given prompts, 32
    decode tokens each, the select policy at tau 2.0 and the sticky policy
    at tau 12.5 (above ln V for every vocabulary).  ``kernel`` is the
    mixer's kernel wrapper (None: a mixer without one): it must launch
    once per layer of ``kernel_layers`` (default every layer) per prefill
    and, if ``counts_per_tick``, once per such layer per tick (each of
    them on a full tick, the client's on a client-only tick); the gate
    once per tick."""
    from repro_torch.api.serve_session import ServeSession
    from repro_torch.kernels.entropy_exit import entropy_exit
    from repro_torch.models.backbone import init_backbone
    name = kernel.__name__ if kernel is not None else "no mixer kernel"
    if kernel_layers is None:
        kernel_layers = range(cfg.num_layers)
    t0 = time.perf_counter()
    params = init_backbone(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    total = weight_bytes(params)
    print(f"{cfg.name} bf16 weights: {total / 1e9:.2f} GB, initialised on "
          f"the card in {time.perf_counter() - t0:.1f} s")

    # warm-up (cuBLAS handles, first launches); not counted
    warm = ServeSession(cfg, params, tau=2.0, slots=SLOTS, max_len=max_len)
    warm.submit(prompts[0][:16], decode_tokens=2)
    warm.run()
    del warm

    # Zamba2's shared block is read at each of its layers
    layers = (sum(weight_bytes(seg) for seg in params["segments"])
              + weight_bytes(params.get("shared_attn", {}))
              * cfg.block_pattern.count("shared_attn"))
    head = weight_bytes(params["head"])
    cut = sorted(cfg.exit_layers)[0]
    per_layer = layers / cfg.num_layers
    full_tick = layers + 2 * head + cache_read
    client_tick = cut * per_layer + head + cache_read * cut / cfg.num_layers
    bound_ms = full_tick / HBM_BYTES_PER_S * 1e3
    print(f"{cfg.name} tick bound: full tick reads {full_tick / 1e9:.2f} GB "
          f"({cfg.num_layers} layers, exit + LM head, {cache_note}) -> "
          f"{bound_ms:.3f} ms; client-only tick {client_tick / 1e9:.2f} GB "
          f"-> {client_tick / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s")

    launches = state.setdefault("launches", {})
    for policy, tau in (("select", 2.0), ("sticky", 12.5)):
        sess = ServeSession(cfg, params, tau=tau, slots=SLOTS,
                            max_len=max_len, exit_policy=policy)
        for p in prompts:
            sess.submit(p, decode_tokens=DECODE)
        torch.cuda.reset_peak_memory_stats()
        zero_counts(*(w for w in (kernel, entropy_exit) if w is not None))
        results = sess.run()
        n_mix = kernel.launches if kernel is not None else 0
        n_gate = entropy_exit.launches
        by_kernel = launch_counts(kernel) if kernel is not None else {}
        peak = torch.cuda.max_memory_allocated()
        st = sess.stats
        for k, n in {**by_kernel, "entropy_exit": n_gate}.items():
            launches[k] = launches.get(k, 0) + n
        decode_s = st.wall_s - st.prefill_s
        tok_s = st.tokens / st.wall_s
        ms_tick = decode_s / st.decode_ticks * 1e3
        ms_prefill = st.prefill_s / st.requests * 1e3
        print(f"main {cfg.name} {policy} tau={tau}: {st.requests} requests, "
              f"{st.tokens} tokens, {st.decode_ticks} ticks "
              f"({st.client_only_ticks} client-only), adoption "
              f"{st.adoption_ratio:.3f}")
        print(f"  {tok_s:.1f} tok/s overall, {ms_tick:.3f} ms per decode "
              f"tick (bound {bound_ms:.3f} ms), {ms_prefill:.3f} ms per "
              f"prefill, peak memory {peak / 2**30:.2f} GiB, launches: "
              f"{name} {n_mix} ("
              + ", ".join(f"{k} {n}" for k, n in by_kernel.items())
              + f"), entropy_exit {n_gate}")
        state.setdefault("main", {})[f"{cfg.name}/{policy}"] = dict(
            tok_s=tok_s, ms_per_tick=ms_tick, ms_per_prefill=ms_prefill,
            peak_gib=peak / 2**30, ticks=st.decode_ticks,
            client_only_ticks=st.client_only_ticks,
            adoption=st.adoption_ratio, launches=n_mix, gate_launches=n_gate,
            tick_bound_ms=bound_ms)
        full_ticks = st.decode_ticks - st.client_only_ticks
        check((n_mix > 0 or kernel is None) and n_gate > 0,
              f"{cfg.name} {policy}: "
              + ("both kernels" if kernel is not None else "the gate")
              + " launched on the main path")
        n_layers = len(kernel_layers)
        n_client = sum(1 for l in kernel_layers if l < cut)
        want = (0 if kernel is None else n_layers * st.requests + (
            n_layers * full_ticks + n_client * st.client_only_ticks
            if counts_per_tick else 0))
        check(n_mix == want and n_gate == st.decode_ticks,
              f"{cfg.name} {policy}: {name} launched {n_mix} times = "
              f"{n_layers} per prefill"
              + (f" and one per such layer per tick ({n_client} below the "
                 f"cut)" if counts_per_tick and kernel is not None else "")
              + ", one gate launch per tick")
        if name == "flash_attention":
            prefill = n_layers * st.requests
            check(by_kernel == {"flash_attention": n_mix - prefill,
                                "flash_attention_tile": prefill,
                                "flash_attention_row": 0},
                  f"{cfg.name} {policy}: every prefill launch on the tile "
                  f"route ({prefill}), every decode launch on the decode "
                  f"route ({n_mix - prefill}), none on the row route")
        state.setdefault("main", {})[f"{cfg.name}/{policy}"][
            "launches_by_kernel"] = by_kernel
        ok = len(results) == len(prompts)
        for r in results:
            ok &= len(r.tokens) == DECODE + 1 and len(r.exited) == DECODE
            ok &= all(0 <= t < cfg.vocab_size for t in r.tokens)
            H = np.asarray(r.entropy)
            ok &= bool(np.isfinite(H).all() and (H >= -1e-3).all()
                       and (H <= math.log(cfg.vocab_size) + 1e-2).all())
            if policy == "select":
                ok &= all(e == (h < tau) for e, h in zip(r.exited, r.entropy)
                          if abs(h - tau) > GATE_MARGIN)
        check(ok, f"{cfg.name} {policy}: every request served {DECODE} "
                  f"finite gated tokens in range, gate consistent with "
                  f"H < tau")
        if policy == "sticky":
            check(st.adoption_ratio == 1.0 and st.client_only_ticks > 0,
                  f"{cfg.name} sticky tau=12.5 > ln({cfg.vocab_size}): every "
                  f"token exits and client-only ticks run")
    profile_ticks(cfg, params, prompts, max_len)
    if probe is not None:
        probe(cfg, params, prompts, max_len)
    del params
    torch.cuda.empty_cache()


def traced(run, n: int, what: str, top: int = 6) -> dict:
    """``run()`` n times under torch.profiler: wall time, device busy time
    (the time some device event ran) and idle share per run, the device
    events per run, the largest device kernels by time, and the entropy
    gate's time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    # busy = the union of the device events' intervals: copies on a stream
    # of their own (the fused engine's staging) overlap the kernels
    busy_us, end = 0.0, -math.inf
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        start = max(e.time_range.start, end)
        busy_us += max(0.0, e.time_range.end - start)
        end = max(end, e.time_range.end)
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    print(f"profile {what}, {n} traced: {wall_us / n / 1e3:.3f} ms each, "
          f"device busy {busy_us / n / 1e3:.3f} ms each (idle share "
          f"{1 - busy_us / wall_us:.3f}), {len(kernels) / n:.0f} device "
          f"kernels each")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {us / n / 1e3:8.3f} ms each  {name[:90]}")
    gate_us = sum(us for name, us in by_name.items() if "entropy_exit" in name)
    if gate_us:
        print(f"  {gate_us / n / 1e3:8.4f} ms each  the entropy gate")
    return dict(wall_ms=wall_us / n / 1e3, busy_ms=busy_us / n / 1e3,
                idle_share=1 - busy_us / wall_us, kernels=len(kernels) / n)


def profile_ticks(cfg, params, prompts, max_len, ticks: int = 5) -> None:
    """Device busy share over a few select decode ticks (a separate, traced
    run: the tick times above are measured untraced)."""
    from repro_torch.api.serve_session import ServeSession
    sess = ServeSession(cfg, params, tau=2.0, slots=SLOTS, max_len=max_len)
    for p in prompts[:SLOTS]:
        sess.submit(p, decode_tokens=DECODE)
    sess.step()                     # the admission tick, not traced
    traced(sess.step, ticks, f"{cfg.name} select decode tick")


def phase_train(state):
    from repro_torch.configs import glm4_9b, rwkv6_3b
    from repro_torch.kernels.dispatch import wkv_causal_flops
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from repro_torch.kernels.rwkv_wkv import rwkv_wkv, rwkv_wkv_bwd
    from repro_torch.config import HeteroProfile
    from repro_torch.configs import zamba2_1p2b
    from repro_torch.launch.e2e_train import cut_depth, full_depth

    # glm4-9b at its published widths, depth cut to 8 layers, 12 x 128
    cfg, profile = cut_depth(glm4_9b.config(), TRAIN_LAYERS)
    # one block matmul of an attention kernel over the causal band
    band_mm = (2 * TRAIN_B * cfg.num_heads * TRAIN_T * (TRAIN_T + 1) // 2
               * cfg.head_dim)
    state["train"] = train_main(
        state, cfg, profile, TRAIN_T, "none",
        (flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq),
        (2 * band_mm, 4 * band_mm, 3 * band_mm),
        dict(warm=TRAIN_WARM, eq1=TRAIN_EQ1, sum=TRAIN_SUM))

    # rwkv6-3b at its published widths and full depth (exits 8, 16, 24),
    # 12 x 512 tokens (4 chunks of 128), every block recomputed (remat);
    # then eq1 steps on the plain versions, the end-to-end baseline
    cfg, profile = full_depth(rwkv6_3b.config())
    H, K = cfg.d_model // cfg.ssm.head_dim, cfg.ssm.head_dim
    wkv = (TRAIN_B, RWKV_T, H, K, cfg.ssm.chunk_size)
    state["train_rwkv"] = train_main(
        state, cfg, profile, RWKV_T, "full", (rwkv_wkv, rwkv_wkv_bwd),
        (wkv_causal_flops(*wkv), wkv_causal_flops(*wkv, "bwd")),
        dict(warm=RWKV_WARM, eq1=RWKV_EQ1, sum=RWKV_SUM, ref=RWKV_REF))

    # zamba2-1.2b at its published widths and full depth (38 layers, exits
    # 10, 20, 29), 12 x 512 tokens (2 chunks of 256), remat: the shared
    # block's attention at its 6 layers on the tile routes, GQA 1, D 64
    cfg, profile = full_depth(zamba2_1p2b.config())
    band_mm = (2 * TRAIN_B * cfg.num_heads * ZAMBA_T * (ZAMBA_T + 1) // 2
               * cfg.head_dim)
    state["train_zamba"] = train_main(
        state, cfg, profile, ZAMBA_T, "full",
        (flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq),
        (2 * band_mm, 4 * band_mm, 3 * band_mm),
        dict(warm=ZAMBA_WARM, eq1=ZAMBA_EQ1, sum=ZAMBA_SUM),
        kernel_layers=cfg.block_pattern.count("shared_attn"))

    # whisper-small at full width and depth (exits 3, 6, 9), 12 x 448
    # decoder tokens over 1500 random source frames: per layer a causal
    # self-attention launch and a cross launch over the full 448 x 1500
    # rectangle, one of each per step, so a launch's FLOPs average the two
    from repro_torch.configs import paligemma_3b, whisper_small
    cfg, profile = full_depth(whisper_small.config())
    H, D = cfg.num_heads, cfg.head_dim
    band_mm = 2 * TRAIN_B * H * WHISPER_T * (WHISPER_T + 1) // 2 * D
    rect_mm = 2 * TRAIN_B * H * WHISPER_T * cfg.cross_source_len * D
    mm = (band_mm + rect_mm) / 2
    state["train_whisper"] = train_main(
        state, cfg, profile, WHISPER_T, "none",
        (flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq),
        (2 * mm, 4 * mm, 3 * mm),
        dict(warm=WHISPER_WARM, eq1=WHISPER_EQ1, sum=WHISPER_SUM),
        kernel_layers=2 * cfg.num_layers)

    # paligemma-3b at its published widths, depth cut to PALI_LAYERS, on
    # PALI_B x (256 random patches + 256 tokens), one client group at each
    # exit and one more at the deepest
    cfg, _ = cut_depth(paligemma_3b.config(), PALI_LAYERS)
    exits = tuple(sorted(cfg.exit_layers))
    profile = HeteroProfile(split_layers=exits + exits[-1:])
    band_mm = (2 * PALI_B * cfg.num_heads * PALI_T * (PALI_T + 1) // 2
               * cfg.head_dim)
    state["train_paligemma"] = train_main(
        state, cfg, profile, PALI_T, "none",
        (flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq),
        (2 * band_mm, 4 * band_mm, 3 * band_mm),
        dict(warm=PALI_WARM, eq1=PALI_EQ1, sum=PALI_SUM), batch=PALI_B)


def print_train_bytes(cfg, n: int, B: int, T: int) -> None:
    """The device bytes of an eq1 step of ``cfg`` (``n`` parameters) on
    B x T positions, worked out before its first step: bf16 weights, fp32
    Adam moments, the two pulls' bf16 gradients and their sum, and the
    four vocab heads' logits (bf16) with their fp32 log-softmax and its
    gradient, summed as if all were live at once (they are not: glm4-9b's
    leg sums past the card's memory and runs) and without the other
    activations."""
    heads = (len(cfg.exit_layers) + 1) * B * T * cfg.vocab_size
    parts = {"weights (bf16)": 2 * n, "Adam m and v (fp32)": 8 * n,
             "gradients of both pulls and their sum (bf16)": 6 * n,
             "vocab heads' logits, log-softmax and its gradient":
                 heads * (2 + 4 + 4)}
    print(f"train bytes {cfg.name} {cfg.num_layers} layers, batch {B} x "
          f"{T}: " + ", ".join(f"{k} {v / 1e9:.1f} GB"
                               for k, v in parts.items())
          + f"; {sum(parts.values()) / 1e9:.1f} GB if all were live at "
          f"once, the card's "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f}")


def train_main(state, cfg, profile, T, remat, counters, flops_per_launch,
               n, kernel_layers=None, batch=TRAIN_B) -> dict:
    """make_train_step on ``cfg`` (bf16 weights, fp32 Adam, lr 3e-4 cosine),
    batch ``batch`` x ``T`` tokens of SyntheticLMDataset(seed=0) (audio:
    with random encoder states; VLM: 256 random patches and T - 256
    tokens; ``models/frontend.frontend_batch``), the Eq. (1) profile
    ``profile``.  With every launch count of ``counters`` (the
    mixer's kernel wrappers) set to 0 first: warm-up (its first step under
    FlopCounterMode), one sum step under FlopCounterMode, the timed eq1 and
    sum steps, a loss check on the first batch, then a traced window of 2
    eq1 steps; with ``n["ref"]``, then one warm-up and ``n["ref"]`` timed
    eq1 steps on the plain versions (kernels="ref"), launching none of the
    counted kernels.  A counted step's FLOPs are the matmuls
    FlopCounterMode saw plus ``flops_per_launch[i]`` for each launch of
    ``counters[i]``.  The first counter is the forward kernel: one launch
    per layer that runs it (``kernel_layers`` of them, default every
    layer), plus, under remat, one per launch of the last counter (a
    block's backward runs after its forward is recomputed)."""
    from repro_torch.config import OptimizerConfig, SplitEEConfig, TrainConfig
    from repro_torch.core.losses import softmax_cross_entropy
    from repro_torch.core.spmd import (StepConfig, boundary_ids_for_batch,
                                       make_train_step)
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.models.frontend import frontend_batch
    from repro_torch.models.backbone import backbone_forward, init_backbone
    from repro_torch.optim import adam_init
    from repro_torch.tree import tree_leaves

    # warm-up (its first step counted), one counted sum step, the timed
    # steps, the traced window
    n_ref = n.get("ref", 0)
    n_steps = n["warm"] + 1 + n["eq1"] + n["sum"] + 2 + (n_ref and n_ref + 1)
    opt_cfg = OptimizerConfig(lr=3e-4, total_steps=n_steps)
    t0 = time.perf_counter()
    params = init_backbone(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt = adam_init(params, opt_cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"train: {cfg.name} at its published widths, {cfg.num_layers} "
          f"layers, exits {cfg.exit_layers}, {profile.num_groups} client "
          f"groups {profile.split_layers}; {n_params / 1e9:.3f} B params "
          f"({weight_bytes(params) / 1e9:.2f} GB bf16) + fp32 Adam m/v "
          f"({weight_bytes(opt.m) * 2 / 1e9:.2f} GB); batch {batch} x {T}, "
          f"remat={remat}; set up in {time.perf_counter() - t0:.1f} s")
    print_train_bytes(cfg, n_params, batch, T)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=T, seed=0)
    sids = boundary_ids_for_batch(profile, cfg, batch, "cuda")
    feats = np.random.default_rng(0)
    batches = [{**frontend_batch(cfg, t, lab, feats, "cuda"),
                "split_ids": sids}
               for t, lab in ds.batches(batch, n_steps)]
    tokens = batch * T

    def first_batch_loss() -> float:
        b = batches[0]
        with torch.no_grad():
            out = backbone_forward(params, cfg, tokens=b["tokens"],
                                   embeds=b.get("embeds"), enc=b.get("enc"),
                                   exit_heads=())
            return float(softmax_cross_entropy(out.logits, b["labels"]))

    steps = {mode: make_train_step(StepConfig(
        model=cfg, splitee=SplitEEConfig(profile=profile),
        train=TrainConfig(optimizer=opt_cfg, remat=remat), grad_mode=mode))
        for mode in ("eq1", "sum")}
    if n_ref:
        steps["ref"] = make_train_step(StepConfig(
            model=cfg.with_(kernels="ref"),
            splitee=SplitEEConfig(profile=profile),
            train=TrainConfig(optimizer=opt_cfg, remat=remat),
            grad_mode="eq1"))
    loss0 = first_batch_loss()
    it = iter(batches)
    metrics = []

    def one_step(mode):
        nonlocal params, opt
        params, opt, m = steps[mode](params, opt, next(it))
        metrics.append(m)

    def run(mode, k):
        before = [c.launches for c in counters]
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(k):
            one_step(mode)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) / k * 1e3
        return ms, [(c.launches - b) / k for c, b in zip(counters, before)]

    def counted_step(mode) -> float:
        """One step under FlopCounterMode: the FLOPs of the matmuls the
        step ran (the forward, remat's recomputations and the backward
        pulls as autograd pruned them), plus the kernels' FLOPs from their
        launches."""
        from torch.utils.flop_counter import FlopCounterMode
        before = [c.launches for c in counters]
        with FlopCounterMode(display=False) as fc:
            one_step(mode)
        torch.cuda.synchronize()
        return fc.get_total_flops() + sum(
            (c.launches - b) * f
            for c, b, f in zip(counters, before, flops_per_launch))

    # the forward's weight matmuls: every parameter but the embedding
    # table (a gather) and the norm gains, lerps and biases multiplies
    # each token once
    mm_params = sum(p.numel() for p in tree_leaves(params) if p.ndim >= 2)
    mm_params -= params["embed"]["table"].numel()
    fwd_flops = 2 * mm_params * tokens

    from repro_torch.kernels.flash_attention import flash_attention_bwd
    torch.cuda.reset_peak_memory_stats()
    zero_counts(*counters, flash_attention_bwd)
    flops = {"eq1": counted_step("eq1")}
    run("eq1", n["warm"] - 1)
    flops["sum"] = counted_step("sum")
    timed = {"eq1": run("eq1", n["eq1"]), "sum": run("sum", n["sum"])}
    launches = {k: v for c in counters for k, v in launch_counts(c).items()}
    print(f"train {cfg.name} launches by kernel: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    if "flash_attention_tile" in launches:
        passes = flash_attention_bwd.torch_delta_passes
        print(f"train {cfg.name} delta passes in torch: {passes}")
        check(launches["flash_attention"] == 0
              and launches["flash_attention_row"] == 0
              and launches["flash_attention_bwd_dkv_row"] == 0
              and launches["flash_attention_bwd_dq_row"] == 0
              and launches["flash_attention_tile"] > 0
              and launches["flash_attention_bwd_dkv"] > 0
              and launches["flash_attention_bwd_dq"] > 0 and passes == 0,
              f"train {cfg.name}: every attention forward, dK/dV and dQ "
              f"launch on the tile route, delta formed in the dQ kernel "
              f"(no delta pass in torch)")
    peak = torch.cuda.max_memory_allocated()
    loss1 = first_batch_loss()
    train = dict(model=cfg.name, layers=cfg.num_layers, seq=T, params=n_params,
                 peak_gib=peak / 2**30, loss0=loss0, loss1=loss1,
                 launches=launches)
    peak_s = PEAK_OPS_PER_S[torch.bfloat16] / 1e3
    names = ", ".join(c.__name__ for c in counters)
    for mode, (ms, per_step) in timed.items():
        nominal = 6 * n_params * tokens * (1.5 if mode == "eq1" else 1.0)
        share, share_nominal = flops[mode] / (ms * peak_s), nominal / (
            ms * peak_s)
        print(f"train {cfg.name} {mode}: {ms:.1f} ms per step, "
              f"{tokens / ms * 1e3:,.0f} tokens/s; launches per step ({names})"
              f": {', '.join(f'{x:g}' for x in per_step)}")
        print(f"  share of the bf16 peak {share:.4f}: {flops[mode] / 1e12:.3f}"
              f" TFLOP counted in the step ({flops[mode] / fwd_flops:.3f} x "
              f"the forward's {fwd_flops / 1e12:.3f}) over step time x 989 "
              f"TF/s; nominal 6 x params x tokens"
              f"{' x 1.5' if mode == 'eq1' else ''} = {nominal / 1e12:.3f} "
              f"TFLOP gives {share_nominal:.4f}")
        train[mode] = dict(ms=ms, tok_s=tokens / ms * 1e3, peak_share=share,
                           peak_share_nominal=share_nominal,
                           tflop=flops[mode] / 1e12,
                           launches_per_step=per_step)
        recomputed = per_step[-1] if remat == "full" else 0
        check(min(per_step) > 0
              and per_step[0] == (kernel_layers or cfg.num_layers)
              + recomputed,
              f"train {cfg.name} {mode}: every kernel of the mixer launched "
              f"every step, one forward launch per layer"
              + (" and one per backward launch (remat)" if recomputed
                 else ""))
        # forward + a backward of at least dW and dX for every weight
        check(flops[mode] >= 2.9 * fwd_flops,
              f"train {cfg.name} {mode}: the counted FLOPs include the "
              f"backward pulls")
    print(f"train {cfg.name}: peak memory {peak / 2**30:.2f} GiB; first batch "
          f"server loss {loss0:.4f} before, {loss1:.4f} after "
          f"{n['warm'] + 1 + n['eq1'] + n['sum']} steps")
    finite = all(math.isfinite(float(v)) for m in metrics
                 for v in m.values())
    check(finite, f"train {cfg.name}: every step's losses finite")
    check(loss1 < loss0, f"train {cfg.name}: the first batch's server loss "
                         f"fell")
    train["profile"] = traced(lambda: one_step("eq1"), 2,
                              f"{cfg.name} eq1 train step")
    if n_ref:
        before = [c.launches for c in counters]
        one_step("ref")
        ms_p = run("ref", n_ref)[0]
        ms_k = timed["eq1"][0]
        print(f"train {cfg.name} eq1 on the plain versions (kernels=ref): "
              f"{ms_p:.1f} ms per step, {tokens / ms_p * 1e3:,.0f} tokens/s "
              f"({n_ref} timed); with the kernels {ms_k:.1f} ms "
              f"({ms_p / ms_k:.3f} x)")
        check(all(c.launches == b for c, b in zip(counters, before)),
              f"train {cfg.name} eq1 on the plain versions: no kernel of "
              f"the mixer launched")
        train["eq1_plain"] = dict(ms=ms_p, tok_s=tokens / ms_p * 1e3)
    launches_all = state.setdefault("launches", {})
    for name, k in launches.items():
        launches_all[name] = launches_all.get(name, 0) + k
    del params, opt, metrics
    torch.cuda.empty_cache()
    return train


# phase dryrun: the dry run's step analysis (launch/step_analysis.py) of
# one real step on the card against a fake trace of the same step
# (launch/dryrun.py's way: FakeTensorMode on fake CPU tensors, nothing
# launched).  FLOPs, site FLOPs and site calls must agree exactly, the
# site calls must equal the wrappers' launch counts, and the fake peak must
# sit within TOL_DRYRUN_PEAK of the card's allocated peak above the bytes
# allocated before the step (peaks reset after warm-up; the caching
# allocator rounds each block up to 512 bytes, and cuBLAS's workspace was
# allocated in the warm-up)
TOL_DRYRUN_PEAK = 0.05
DRYRUN_SERVE_TAU = 2.0


def fake_copy(tree):
    """A fake CPU tensor of each real leaf's shape and dtype (call under the
    fake mode)."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype)
                    if isinstance(t, torch.Tensor) else t, tree)


def dryrun_compare(leg: str, real_step, fake_step, counters) -> dict:
    """``real_step()`` once on the card under the step analysis, the peak
    reset first, and ``fake_step()`` (which builds its fake inputs under
    the fake mode and returns the analysis of the same step); checks the
    readings agree.  ``counters``: site name -> the wrapper whose launches
    it counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.step_analysis import StepAnalysis
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    launched = {s: w.launches for s, w in counters.items()}
    t0 = time.perf_counter()
    with StepAnalysis() as a:
        real_step()
    torch.cuda.synchronize()
    real_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    launched = {s: w.launches - launched[s] for s, w in counters.items()}
    real = a.result()
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = fake_step()
    fake_s = time.perf_counter() - t0
    gap = abs(fake["peak_bytes"] - peak) / peak
    print(f"dryrun {leg}: flops card {real['flops']:.6e} fake "
          f"{fake['flops']:.6e}; site FLOPs card "
          f"{sum(real['site_flops'].values()):.6e} fake "
          f"{sum(fake['site_flops'].values()):.6e}; site calls card "
          f"{real['site_calls']} fake {fake['site_calls']}; launches "
          f"{launched}; peak card {peak:,} fake {fake['peak_bytes']:,} "
          f"bytes ({gap:.4%}); in sites card {real['site_op_flops']:.0f}; "
          f"hbm bytes card {real['hbm_bytes']:.6e} fake "
          f"{fake['hbm_bytes']:.6e}; step {real_s:.2f} s under the "
          f"analysis, fake trace {fake_s:.2f} s")
    check(real["flops"] == fake["flops"]
          and real["site_flops"] == fake["site_flops"]
          and real["site_calls"] == fake["site_calls"],
          f"dryrun {leg}: the fake trace's flops, site FLOPs and site calls "
          f"equal the card step's")
    check(all(real["site_calls"].get(s, 0) == n for s, n in launched.items())
          and set(real["site_calls"]) <= set(counters)
          and min(launched.values()) > 0,
          f"dryrun {leg}: site calls equal the launch counts {launched}")
    check(real["site_op_flops"] == 0 and fake["site_op_flops"] == 0,
          f"dryrun {leg}: no aten FLOPs inside the sites on the card or "
          f"the fake trace")
    check(gap <= TOL_DRYRUN_PEAK,
          f"dryrun {leg}: fake peak within {TOL_DRYRUN_PEAK:.0%} of the "
          f"card's ({gap:.4%})")
    return dict(flops=real["flops"], site_flops=real["site_flops"],
                site_calls=real["site_calls"], launches=launched,
                peak_card=peak, peak_fake=fake["peak_bytes"], peak_gap=gap,
                hbm_bytes=real["hbm_bytes"], step_s=real_s, fake_s=fake_s)


def dryrun_train_leg(leg, cfg, profile, T, remat, counters, warm=2) -> dict:
    """``make_train_step`` (eq1) of ``cfg`` at 12 x ``T`` on the card after
    ``warm`` steps, against its fake trace."""
    from repro_torch.config import OptimizerConfig, SplitEEConfig, TrainConfig
    from repro_torch.core.spmd import (StepConfig, boundary_ids_for_batch,
                                       make_train_step)
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.launch.inputs import abstract_params
    from repro_torch.launch.step_analysis import StepAnalysis
    from repro_torch.models.backbone import init_backbone
    from repro_torch.models.frontend import frontend_batch
    from repro_torch.optim import adam_init

    opt_cfg = OptimizerConfig(lr=3e-4, total_steps=warm + 2)
    sc = StepConfig(model=cfg, splitee=SplitEEConfig(profile=profile),
                    train=TrainConfig(optimizer=opt_cfg, remat=remat),
                    grad_mode="eq1")
    params = init_backbone(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt = adam_init(params, opt_cfg)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=T, seed=0)
    sids = boundary_ids_for_batch(profile, cfg, TRAIN_B, "cuda")
    feats = np.random.default_rng(0)
    batches = [{**frontend_batch(cfg, t, lab, feats, "cuda"),
                "split_ids": sids}
               for t, lab in ds.batches(TRAIN_B, warm + 1)]
    step = make_train_step(sc)
    for b in batches[:warm]:
        params, opt, _ = step(params, opt, b)
    del b
    last = batches[-1]

    def real_step():
        step(params, opt, last)

    def fake_step():
        fp = fake_copy(abstract_params(cfg))
        fo = adam_init(fp, opt_cfg)
        fb = fake_copy(last)
        with StepAnalysis() as a:
            make_train_step(sc)(fp, fo, fb)
        return a.result()

    out = dryrun_compare(leg, real_step, fake_step, counters)
    del params, opt, batches, last
    torch.cuda.empty_cache()
    return out


def dryrun_serve_leg(leg, cfg) -> dict:
    """One select tick of a ``ServeSession`` of ``cfg`` (phase main's 8
    slots over ``MAX_LEN`` pages) on the card after 4 requests were
    served, against the same tick of a session on fake tensors: the
    session's full tick (``make_serve_step``: every layer's decode
    attention, the gate at the first exit)."""
    from repro_torch.api.serve_session import ServeSession
    from repro_torch.kernels.entropy_exit import entropy_exit
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.inputs import abstract_params
    from repro_torch.launch.step_analysis import StepAnalysis
    from repro_torch.models.backbone import init_backbone

    params = init_backbone(torch.Generator(device="cuda").manual_seed(0), cfg)
    sess = ServeSession(cfg, params, tau=DRYRUN_SERVE_TAU, slots=SLOTS,
                        max_len=MAX_LEN)
    rng = np.random.default_rng(0)
    for _ in range(4):
        sess.submit(rng.integers(0, cfg.vocab_size, 16), decode_tokens=2)
    sess.run()
    tau = torch.full((SLOTS,), DRYRUN_SERVE_TAU, dtype=torch.float32,
                     device="cuda")

    def real_step():
        sess._full_tick(sess.params, sess._pool, tau)

    def fake_step():
        fs = ServeSession(cfg, fake_copy(abstract_params(cfg)),
                          tau=DRYRUN_SERVE_TAU, slots=SLOTS, max_len=MAX_LEN,
                          device="cpu")
        ftau = torch.full((SLOTS,), DRYRUN_SERVE_TAU, dtype=torch.float32)
        with StepAnalysis() as a:
            fs._full_tick(fs.params, fs._pool, ftau)
        return a.result()

    out = dryrun_compare(leg, real_step, fake_step,
                         {"attention_fwd": flash_attention,
                          "gate": entropy_exit})
    del sess, params
    torch.cuda.empty_cache()
    return out


def dryrun_examples(state) -> None:
    """The two MLP examples on the card (``repro_torch/examples``): finite
    losses, and the gate kernel launched by quickstart's
    ``evaluate_adaptive`` and by the adaptive router."""
    from repro_torch.examples import adaptive_serving, quickstart
    from repro_torch.kernels.entropy_exit import entropy_exit
    n0 = entropy_exit.launches
    t0 = time.perf_counter()
    sess = quickstart.main(log_every=0)
    n1 = entropy_exit.launches
    losses = [(m.client_loss, m.server_loss) for m in sess.history]
    print(f"dryrun example quickstart on the card: {sess.engine_name}, "
          f"{len(losses)} rounds, last losses {losses[-1][0]:.4f}/"
          f"{losses[-1][1]:.4f}, {n1 - n0} gate launches, "
          f"{time.perf_counter() - t0:.1f} s")
    check(all(math.isfinite(x) for pair in losses for x in pair)
          and n1 - n0 > 0 and losses[-1][1] < losses[0][1],
          "dryrun example quickstart: finite falling losses, the gate "
          "kernel launched by evaluate_adaptive")
    t0 = time.perf_counter()
    table = adaptive_serving.main()
    n2 = entropy_exit.launches
    print(f"dryrun example adaptive_serving on the card: {n2 - n1} gate "
          f"launches, {time.perf_counter() - t0:.1f} s")
    check(n2 - n1 > 0 and all(0.0 <= acc <= 1.0 for acc, _, _ in
                              table.values()),
          "dryrun example adaptive_serving: the gate kernel routed the "
          "requests")
    state["dryrun_examples"] = dict(quickstart_gate_launches=n1 - n0,
                                    adaptive_gate_launches=n2 - n1)


def phase_dryrun(state):
    from repro_torch.configs import glm4_9b, rwkv6_3b
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from repro_torch.kernels.rwkv_wkv import rwkv_wkv, rwkv_wkv_bwd
    from repro_torch.launch.e2e_train import cut_depth, full_depth

    out = state.setdefault("dryrun", {})
    # phase train's glm4-9b leg: published widths, 8 layers, 12 x 128, eq1
    cfg, profile = cut_depth(glm4_9b.config(), TRAIN_LAYERS)
    out["glm4-9b train"] = dryrun_train_leg(
        "glm4-9b train", cfg, profile, TRAIN_T, "none",
        {"attention_fwd": flash_attention,
         "attention_dkv": flash_attention_bwd_dkv,
         "attention_dq": flash_attention_bwd_dq})
    # rwkv6-3b whole, 12 x 512, remat
    cfg, profile = full_depth(rwkv6_3b.config())
    out["rwkv6-3b train"] = dryrun_train_leg(
        "rwkv6-3b train", cfg, profile, RWKV_T, "full",
        {"wkv_fwd": rwkv_wkv, "wkv_bwd": rwkv_wkv_bwd})
    # one select tick of phase main's glm4-9b ServeSession
    out["glm4-9b serve tick"] = dryrun_serve_leg("glm4-9b serve tick",
                                                 glm4_9b.config())
    dryrun_examples(state)


# phase paper: the full-width leg (resnet18_cifar.config("cifar10"), the
# paper's 12 clients at cuts 3/4/5, batch 64, lr 3e-3 as the JAX package's
# benchmarks train it)
FULL_TRAIN, FULL_TEST, FULL_BATCH, FULL_LR = 12 * 64 * 8, 2048, 64, 3e-3
FULL_WARM, FULL_AVG, FULL_SEQ, FULL_PROBE = 1, 5, 3, 3
PAPER_TAUS = (0.5, 1.0, 2.0)
# the full-width probe: the averaging run's first client at each cut, its
# eval-mode logits on the card against the same net on the CPU (first
# WIDE_CPU_ROWS test images), within TOL_WIDE_LOGITS of max(1, max|CPU|)
WIDE_ROWS, WIDE_CPU_ROWS, TOL_WIDE_LOGITS = 512, 128, 1e-3


def phase_paper(state):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"paper: fp32 with TF32 off (torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}, torch.backends.cuda.matmul."
          f"allow_tf32={torch.backends.cuda.matmul.allow_tf32})")
    paper_parity()
    paper_gate_cases()
    paper_main(state)


def paper_parity() -> None:
    """The ResNet smoke's TrainSession on the card against the same run on
    the CPU (repro_torch/parity.py's setup and limits), under averaging and
    sequential: per-round losses, the drift of the trainables, BatchNorm
    statistics; averaging also under a planted fault (client 0's server
    left out of Eq. (1)) that it must reject.  Then the CPU run's final
    state evaluated on both devices: evaluate and evaluate_adaptive equal,
    and row by row the gate on the card (the kernel) against the CPU's
    plain version, batches of 512 and the 500-row tail, exits equal where
    |H - tau| > GATE_TAU_MARGIN, at PAPER_TAUS and at client 0's mean
    entropy (where exits are mixed)."""
    from repro_torch.kernels.dispatch import get_backend
    from repro_torch.parity import (PAPER_EPOCHS, PAPER_ROUNDS,
                                    TOL_PAPER_LOSS, TOL_PAPER_PARAMS,
                                    dropped_aggregation, paper_data,
                                    paper_drift, paper_session)
    data, (x_test, y_test), augment = paper_data()
    gate = get_backend("auto").entropy_gate
    for strategy in ("averaging", "sequential"):
        cpu = paper_session("cpu", strategy, data, augment)
        start = cpu.state.clone()
        card = paper_session("cuda", strategy, data, augment, state=start)
        h_cpu = cpu.run(PAPER_ROUNDS, PAPER_EPOCHS)
        h_card = card.run(PAPER_ROUNDS, PAPER_EPOCHS)
        dl = max(max(abs(a.client_loss - b.client_loss),
                     abs(a.server_loss - b.server_loss))
                 for a, b in zip(h_card, h_cpu))
        drift = paper_drift(card.state, cpu.state, start)
        print(f"  reading paper smoke {strategy}: losses "
              + ", ".join(f"{m.client_loss:.5f}/{m.server_loss:.5f}"
                          for m in h_card)
              + f"; max|dloss| {dl:.3e}; drift clients "
              f"{drift['clients']:.3e} servers {drift['servers']:.3e}; "
              f"BN max|d| clients {drift['clients_bn']:.3e} servers "
              f"{drift['servers_bn']:.3e}")
        check(dl <= TOL_PAPER_LOSS,
              f"paper smoke {strategy}, {PAPER_ROUNDS} rounds x "
              f"{PAPER_EPOCHS} epochs, card vs CPU: per-round losses within "
              f"{TOL_PAPER_LOSS:g} ({dl:.3e})")
        check(max(drift["clients"], drift["servers"]) <= TOL_PAPER_PARAMS,
              f"paper smoke {strategy}: trainables drift (||card - CPU|| / "
              f"||CPU - round 0||) clients {drift['clients']:.3e}, servers "
              f"{drift['servers']:.3e} <= {TOL_PAPER_PARAMS:g}")
        if strategy == "averaging":
            with dropped_aggregation():
                faulty = paper_session("cuda", strategy, data, augment,
                                       state=start)
                faulty.run(PAPER_ROUNDS, PAPER_EPOCHS)
            fd = paper_drift(faulty.state, cpu.state, start)
            print(f"  reading paper smoke planted fault (client 0's server "
                  f"left out of Eq. (1)): drift servers {fd['servers']:.3e}")
            check(fd["servers"] > TOL_PAPER_PARAMS,
                  f"paper smoke planted fault rejected: servers drift "
                  f"{fd['servers']:.3e} > {TOL_PAPER_PARAMS:g}")
        # the CPU's final state, evaluated on both devices
        same = paper_session("cuda", strategy, data, augment,
                             state=cpu.state)
        ev_cpu, ev_card = cpu.evaluate(x_test, y_test), \
            same.evaluate(x_test, y_test)
        check(ev_cpu == ev_card,
              f"paper smoke {strategy}: evaluate on the card equals the CPU "
              f"(client {ev_card['client_acc']}, server "
              f"{ev_card['server_acc']})")
        xc = torch.from_numpy(x_test)
        xg = xc.cuda()
        # and a tau at client 0's mean entropy, where exits are mixed
        mid = cpu.evaluate_adaptive(x_test, y_test, 0.0)["mean_entropy"][0]
        for tau in (*PAPER_TAUS, round(mid, 4)):
            a_cpu = cpu.evaluate_adaptive(x_test, y_test, tau)
            a_card = same.evaluate_adaptive(x_test, y_test, tau)
            rows = far = agree = 0
            worst = 0.0
            for i, (c, g) in enumerate(zip(cpu.state.clients,
                                           same.state.clients)):
                with torch.no_grad():
                    lc = cpu.model.client_forward(c["trainable"], c["state"],
                                                  xc, train=False)[1]
                    lg = same.model.client_forward(g["trainable"],
                                                   g["state"], xg,
                                                   train=False)[1]
                for lo in (0, 512):          # a batch of 512, the tail of 500
                    Hc, ec = gate(lc[lo:lo + 512], tau)
                    Hg, eg = gate(lg[lo:lo + 512], tau)
                    Hg, eg = Hg.cpu(), eg.cpu()
                    keep = (Hc - tau).abs() > GATE_TAU_MARGIN
                    rows += len(Hc)
                    far += int(keep.sum())
                    agree += int((ec[keep] == eg[keep]).sum())
                    worst = max(worst, float((Hc - Hg).abs().max()))
            check(agree == far and worst <= TOL_H
                  and a_cpu["acc"] == a_card["acc"],
                  f"paper smoke {strategy} tau={tau}: accuracies equal "
                  f"({a_card['acc']}), client ratios {a_card['client_ratio']}"
                  f" (CPU {a_cpu['client_ratio']}); gate kernel vs plain "
                  f"over {rows} rows (512 + 500 a client): max|dH| "
                  f"{worst:.2e}, exits equal on the {far} rows with "
                  f"|H - tau| > {GATE_TAU_MARGIN:g}")


def paper_gate_cases() -> None:
    """The gate at the evaluator's shapes, fp32: (512, 10) and (512, 100)
    and the 500-row tails, random rows against the plain version."""
    from repro_torch.kernels.entropy_exit import entropy_exit
    from repro_torch.kernels.ref import entropy_exit_ref
    from repro_torch.parity import gate_logits
    gen = torch.Generator(device="cuda").manual_seed(7)
    for B, V in ((512, 10), (500, 10), (512, 100), (500, 100)):
        x = gate_logits(gen, torch.float32, B, V)
        tau = 0.5 * math.log(V)
        H, ex = entropy_exit(x, tau)
        H_ref, ex_ref = entropy_exit_ref(x, tau)
        d = float((H - H_ref).abs().max())
        far = (H_ref - tau).abs() > GATE_TAU_MARGIN
        check(d <= TOL_H and bool((ex[far] == ex_ref[far]).all()),
              f"entropy ({B},{V}) fp32 (the evaluator's shape): max|dH| "
              f"{d:.2e} <= {TOL_H:g}, exits equal where |H-tau| > "
              f"{GATE_TAU_MARGIN:g} ({int(ex.sum())} exits)")


def paper_main(state) -> None:
    """TrainSession on full-width ResNet-18 (resnet18_cifar.config(
    "cifar10"): width 1.0, 32x32, 10 classes) with the paper's 12 clients
    at cuts HETERO_SPLITS, batch 64 a client, the paper's augmentation,
    on the card: averaging (1 warm-up round, FULL_AVG timed, one traced)
    then sequential (1 warm-up, FULL_SEQ timed), each evaluated (evaluate
    and evaluate_adaptive at PAPER_TAUS).  Every launch count is set to 0
    first; the gate must launch in the evaluations."""
    from repro_torch.api import TrainSession
    from repro_torch.config import HeteroProfile, OptimizerConfig, SplitEEConfig
    from repro_torch.configs import resnet18_cifar
    from repro_torch.core.splitee import ResNetSplitModel
    from repro_torch.data.pipeline import ClientPartitioner
    from repro_torch.data.synthetic import SyntheticImageDataset
    from repro_torch.kernels.entropy_exit import entropy_exit
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from repro_torch.kernels.rwkv_wkv import rwkv_wkv, rwkv_wkv_bwd
    from repro_torch.tree import tree_leaves
    cfg = resnet18_cifar.config("cifar10")
    splits = resnet18_cifar.HETERO_SPLITS
    t0 = time.perf_counter()
    ds = SyntheticImageDataset(num_classes=10, image_size=32,
                               train_size=FULL_TRAIN, test_size=FULL_TEST,
                               seed=0)
    data = ClientPartitioner(len(splits)).split(*ds.train)
    x_test, y_test = ds.test
    print(f"paper: full-width ResNet-18 {cfg}, clients {splits}, batch "
          f"{FULL_BATCH} a client, lr {FULL_LR}; synthetic "
          f"CIFAR-10 stand-in {FULL_TRAIN} train / {FULL_TEST} test, made "
          f"in {time.perf_counter() - t0:.1f} s")
    images = len(splits) * FULL_BATCH          # one round, one epoch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counted = (entropy_exit, flash_attention, flash_attention_bwd_dkv,
               flash_attention_bwd_dq, rwkv_wkv, rwkv_wkv_bwd)
    zero_counts(*counted)
    out = {}
    for strategy, n in (("averaging", FULL_AVG), ("sequential", FULL_SEQ)):
        model = ResNetSplitModel(cfg, device="cuda")
        sess = TrainSession.from_config(
            model, SplitEEConfig(profile=HeteroProfile(splits),
                                 strategy=strategy),
            OptimizerConfig(lr=FULL_LR,
                            total_steps=FULL_WARM + n + 1),
            data, FULL_BATCH, engine="reference", augment=ds.augment)
        if strategy == "averaging":
            n_params = sum(t.numel() for t in tree_leaves(model.full_params))
            print(f"paper: {n_params / 1e6:.3f} M parameters in the full "
                  f"net; engine {sess.engine_name}")
        sess.train(FULL_WARM)
        torch.cuda.synchronize()
        t = time.perf_counter()
        hist = sess.train(n)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) / n * 1e3
        losses = [(m.client_loss, m.server_loss) for m in hist]
        check(all(math.isfinite(a) and math.isfinite(b) for a, b in losses),
              f"paper full width {strategy}: {n} rounds, finite losses "
              + ", ".join(f"{a:.4f}/{b:.4f}" for a, b in losses))
        print(f"paper full width {strategy}: {ms:.1f} ms per round "
              f"({len(splits)} client + {len(splits)} server steps), "
              f"{1e3 / ms:.2f} rounds/s, {images / ms * 1e3:,.0f} images/s "
              f"({n} timed after {FULL_WARM} warm-up)")
        r = dict(ms_round=ms, rounds_s=1e3 / ms,
                 images_s=images / ms * 1e3, losses=losses)
        if strategy == "averaging":
            r["trace"] = traced(lambda: sess.train(1), 1,
                                f"full-width ResNet-18 {strategy} round")
        ev = sess.evaluate(x_test, y_test)
        depth = {li: [i for i, l in enumerate(splits) if l == li]
                 for li in sorted(set(splits))}
        mean = lambda accs, li: float(np.mean([accs[i] for i in depth[li]]))  # noqa: E731
        print(f"paper full width {strategy} evaluate ({FULL_TEST} test "
              f"images): " + "; ".join(
                  f"cut {li}: client {mean(ev['client_acc'], li):.4f}, "
                  f"server {mean(ev['server_acc'], li):.4f}"
                  for li in depth))
        r["evaluate"] = ev
        if strategy == "averaging":
            wide = (model, {li: sess.state.clients[depth[li][0]]
                            for li in depth}, ev, depth)
        for tau in PAPER_TAUS:
            ad = sess.evaluate_adaptive(x_test, y_test, tau)
            ok = all(0.0 <= v <= 1.0 for v in ad["acc"] + ad["client_ratio"])
            check(ok and all(math.isfinite(v) for v in ad["mean_entropy"]),
                  f"paper full width {strategy} tau={tau}: " + "; ".join(
                      f"cut {li}: acc {mean(ad['acc'], li):.4f}, client "
                      f"ratio {mean(ad['client_ratio'], li):.4f}"
                      for li in depth))
            r[f"adaptive_{tau}"] = ad
        out[strategy] = r
        del sess, model
    peak = torch.cuda.max_memory_allocated()
    n_gate = entropy_exit.launches
    others = {k: n for w in counted[1:] for k, n in launch_counts(w).items()}
    check(n_gate > 0 and not any(others.values()),
          f"paper full width: the gate kernel launched {n_gate} times in "
          f"the evaluations, no other kernel ({others})")
    print(f"paper full width: peak device memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    launches = state.setdefault("launches", {})
    launches["entropy_exit"] = launches.get("entropy_exit", 0) + n_gate
    out.update(peak_gib=peak / 2**30, gate_launches=n_gate)
    # after the counts were read: the probe's gate launches are comparisons
    out["probe"] = paper_wide_probe(*wide, x_test, y_test)
    state["paper"] = out
    torch.cuda.empty_cache()


def paper_wide_probe(model, clients, ev, depth, x_test, y_test) -> dict:
    """The averaging run's first client at each cut, at full width: its
    eval-mode logits on the card against the same net on the CPU, and
    the gate kernel against the plain version row by row on those logits
    at PAPER_TAUS; then, per cut, the head's accuracy and mean entropy
    with BatchNorm on its running statistics (what evaluation uses)
    beside the same with the batch's own statistics, and the share of
    the most predicted class: where the first is chance and the second is
    not, the running statistics, not the weights, make the head fail."""
    from repro_torch.kernels.dispatch import get_backend
    from repro_torch.kernels.ref import entropy_exit_ref
    from repro_torch.tree import tree_map
    gate = get_backend("auto").entropy_gate
    xg = torch.from_numpy(x_test[:WIDE_ROWS]).cuda()
    xc = torch.from_numpy(x_test[:WIDE_CPU_ROWS])
    yg = torch.from_numpy(y_test[:WIDE_ROWS]).cuda()
    out = {}
    for li, net in clients.items():
        with torch.no_grad():
            lg = model.client_forward(net["trainable"], net["state"], xg,
                                      train=False)[1]
            cpu = tree_map(lambda t: t.cpu(), net)
            lc = model.client_forward(cpu["trainable"], cpu["state"], xc,
                                      train=False)[1]
            lt = model.client_forward(net["trainable"], net["state"], xg,
                                      train=True)[1]
        scale = max(1.0, float(lc.abs().max()))
        dl = float((lg[:WIDE_CPU_ROWS].cpu() - lc).abs().max()) / scale
        check(dl <= TOL_WIDE_LOGITS,
              f"paper full width cut {li}: eval-mode client logits on the "
              f"card vs CPU over {WIDE_CPU_ROWS} test images, max|d| "
              f"{dl:.2e} of max(1, max|logits|) {scale:.3g} <= "
              f"{TOL_WIDE_LOGITS:g}")
        rows = far = agree = 0
        worst = 0.0
        for tau in PAPER_TAUS:
            H, ex = gate(lg, tau)
            H_ref, ex_ref = entropy_exit_ref(lg, tau)
            keep = (H_ref - tau).abs() > GATE_TAU_MARGIN
            rows, far = rows + len(H), far + int(keep.sum())
            agree += int((ex[keep] == ex_ref[keep]).sum())
            worst = max(worst, float((H - H_ref).abs().max()))
        check(agree == far and worst <= TOL_H,
              f"paper full width cut {li}: the gate kernel vs plain on the "
              f"client's ({len(lg)}, {lg.shape[1]}) fp32 logits at tau "
              f"{PAPER_TAUS}: max|dH| {worst:.2e}, exits equal on the "
              f"{far} of {rows} rows with |H - tau| > {GATE_TAU_MARGIN:g}")
        read = {}
        for mode, logits in (("running", lg), ("batch", lt)):
            H = entropy_exit_ref(logits, 0.0)[0]
            pred = logits.argmax(-1)
            read[mode] = dict(
                acc=float((pred == yg).float().mean()),
                mean_H=float(H.mean()),
                top_share=float(torch.bincount(pred, minlength=logits.shape[
                    1]).max()) / len(pred),
                max_abs=float(logits.abs().max()))
        accs = [ev["client_acc"][i] for i in depth[li]]
        print(f"  reading paper full width cut {li} (client "
              f"{depth[li][0]}; the cut's clients' accuracies {accs}): "
              + "; ".join(f"BN on {m} statistics: acc {v['acc']:.4f}, "
                          f"mean H {v['mean_H']:.4f}, most predicted class "
                          f"{v['top_share']:.3f} of rows, max|logit| "
                          f"{v['max_abs']:.3g}" for m, v in read.items()))
        out[li] = dict(d_logits=dl, max_dH=worst, **read)
    return out


# phase fused: the full-width runs (paper_main's config and timing), each
# (strategy, grad mode)
FUSED_RUNS = (("averaging", "eq1"), ("averaging", "sum"),
              ("distributed", "eq1"))
# the lane rules against a per-lane loop of plain launches: wkv outputs and
# gradients within TOL_WKV of each one's largest magnitude.  Folding lanes
# into the heads changes B*H, and the kernels pick their value-column
# split (scan_split) from B*H against the SM count, which may reorder the
# state passes' sums; attention folds lanes into the batch, which only
# renumbers blocks, so it must come out bit for bit
TOL_LANE_WKV = TOL_WKV


def phase_fused(state):
    """The fused cohort engine: the ResNet smoke card vs CPU and vs the
    reference engine (fused_parity), then with every launch count at 0 the
    full-width runs (fused_main) and the backbone legs' kernel runs, whose
    launches are read; then the backbone legs against the plain versions
    and the lane rules against per-lane launches (comparisons: their
    launches are not counted)."""
    from repro_torch.kernels.entropy_exit import entropy_exit
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from repro_torch.kernels.rwkv_wkv import rwkv_wkv, rwkv_wkv_bwd
    from repro_torch.parity import LANE_SPLITS, backbone_session
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    fused_parity()
    counted = (entropy_exit, flash_attention, flash_attention_bwd_dkv,
               flash_attention_bwd_dq, rwkv_wkv, rwkv_wkv_bwd)
    zero_counts(*counted)
    fused_main(state)
    legs = {}
    for family in LANE_SPLITS:
        sess = backbone_session(family, "auto", "cuda")
        start = sess.state.clone()
        legs[family] = (sess, start, backbone_leg_run(sess, family))
    counts = {k: n for w in counted for k, n in launch_counts(w).items()}
    print("fused: launches on the fused paths (full-width runs and their "
          "evaluations, backbone legs): " + ", ".join(
              f"{k} {n}" for k, n in counts.items() if n))
    rows = ("flash_attention_tile", "flash_attention_bwd_dkv",
            "flash_attention_bwd_dq", "rwkv_wkv", "rwkv_wkv_bwd")
    check(all(counts[k] > 0 for k in rows + ("entropy_exit",)),
          f"fused: rows 2-6 launched under lanes ("
          + ", ".join(f"{k} {counts[k]}" for k in rows)
          + f") and the gate in the evaluations ({counts['entropy_exit']})")
    state["fused_launches"] = counts
    launches = state.setdefault("launches", {})
    for k in KERNELS:
        launches[k] = launches.get(k, 0) + counts.get(k, 0)
    for family, (sess, start, hist) in legs.items():
        backbone_leg_checks(family, sess, start, hist)
    lane_rule_checks()


def fused_parity() -> None:
    """The ResNet smoke (repro_torch/parity.py's setup and limits) on the
    fused engine: the card against the CPU in eq1 and sum, under a planted
    fault (client 0's lane left out of the stacked Eq. (1)) that must be
    rejected, and against the reference engine on the card."""
    from repro_torch.parity import (PAPER_EPOCHS, PAPER_ROUNDS,
                                    TOL_PAPER_LOSS, TOL_PAPER_PARAMS,
                                    dropped_lane, paper_data, paper_drift,
                                    paper_session)
    data, _, augment = paper_data()

    def run(device, start, **kw):
        sess = paper_session(device, "averaging", data, augment, state=start,
                             **kw)
        return sess, sess.run(PAPER_ROUNDS, PAPER_EPOCHS)

    def compare(what, a, ha, b, hb, start):
        dl = max(max(abs(x.client_loss - y.client_loss),
                     abs(x.server_loss - y.server_loss))
                 for x, y in zip(ha, hb))
        d = paper_drift(a.state, b.state, start)
        print(f"  reading fused smoke {what}: max|dloss| {dl:.3e}; drift "
              f"clients {d['clients']:.3e} servers {d['servers']:.3e}; BN "
              f"max|d| clients {d['clients_bn']:.3e} servers "
              f"{d['servers_bn']:.3e}")
        return dl, d

    for grad_mode in ("eq1", "sum"):
        cpu = paper_session("cpu", "averaging", data, augment,
                            engine="fused", grad_mode=grad_mode)
        start = cpu.state.clone()
        h_cpu = cpu.run(PAPER_ROUNDS, PAPER_EPOCHS)
        card, h_card = run("cuda", start, engine="fused", grad_mode=grad_mode)
        check(card.engine.name == "fused" and cpu.engine.name == "fused",
              f"fused smoke {grad_mode}: both sessions on the fused engine")
        dl, d = compare(f"{grad_mode} card vs CPU", card, h_card,
                        cpu, h_cpu, start)
        check(dl <= TOL_PAPER_LOSS
              and max(d["clients"], d["servers"]) <= TOL_PAPER_PARAMS,
              f"fused smoke {grad_mode}, card vs CPU: losses within "
              f"{TOL_PAPER_LOSS:g} ({dl:.3e}), drift clients "
              f"{d['clients']:.3e}, servers {d['servers']:.3e} <= "
              f"{TOL_PAPER_PARAMS:g}")
        if grad_mode == "eq1":
            with dropped_lane():
                faulty, h_f = run("cuda", start, engine="fused")
            _, fd = compare("planted fault (client 0's lane left out of the "
                            "stacked Eq. (1)) vs CPU", faulty, h_f, cpu,
                            h_cpu, start)
            check(fd["servers"] > TOL_PAPER_PARAMS,
                  f"fused smoke planted fault rejected: servers drift "
                  f"{fd['servers']:.3e} > {TOL_PAPER_PARAMS:g}")
            ref, h_ref = run("cuda", start, engine="reference")
            dl, d = compare("eq1 fused vs reference, both on the card", card,
                            h_card, ref, h_ref, start)
            check(dl <= TOL_PAPER_LOSS
                  and max(d["clients"], d["servers"]) <= TOL_PAPER_PARAMS,
                  f"fused smoke, fused vs reference on the card: losses "
                  f"within {TOL_PAPER_LOSS:g} ({dl:.3e}), drift clients "
                  f"{d['clients']:.3e}, servers {d['servers']:.3e} <= "
                  f"{TOL_PAPER_PARAMS:g}")


def count_syncs(run):
    """``run()`` with CUDA's sync debug mode on: the number of synchronizing
    calls it made (torch warns once a call)."""
    import warnings
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in seen)


def fused_main(state) -> None:
    """The fused engine on paper_main's config (full-width ResNet-18, the
    paper's 12 clients at cuts HETERO_SPLITS, batch 64, fp32, TF32 off),
    timed as paper_main times the reference engine: eq1 and sum under
    averaging, eq1 under distributed; each 1 warm-up round, FULL_AVG timed
    (host clock, ending in a synchronize; auto chunking), FULL_AVG more
    under the sync debug mode (host syncs per chunk), 2 traced (kernels
    per round, busy and idle share), then evaluate_adaptive at
    PAPER_TAUS (the gate).  Then a probe: both engines with cuDNN's
    algorithm search on (torch.backends.cudnn.benchmark)."""
    from repro_torch.api import TrainSession
    from repro_torch.config import HeteroProfile, OptimizerConfig, SplitEEConfig
    from repro_torch.configs import resnet18_cifar
    from repro_torch.core.splitee import ResNetSplitModel
    from repro_torch.data.pipeline import ClientPartitioner
    from repro_torch.data.synthetic import SyntheticImageDataset
    cfg = resnet18_cifar.config("cifar10")
    splits = resnet18_cifar.HETERO_SPLITS
    ds = SyntheticImageDataset(num_classes=10, image_size=32,
                               train_size=FULL_TRAIN, test_size=FULL_TEST,
                               seed=0)
    data = ClientPartitioner(len(splits)).split(*ds.train)
    x_test, y_test = ds.test
    images = len(splits) * FULL_BATCH
    ref = state.get("paper", {}).get("averaging")

    def session(engine, strategy="averaging", grad_mode="eq1"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return TrainSession.from_config(
            ResNetSplitModel(cfg, device="cuda"),
            SplitEEConfig(profile=HeteroProfile(splits), strategy=strategy),
            OptimizerConfig(lr=FULL_LR,
                            total_steps=FULL_WARM + 2 * FULL_AVG + 3),
            data, FULL_BATCH, engine=engine, grad_mode=grad_mode,
            augment=ds.augment)

    out = {}
    for strategy, grad_mode in FUSED_RUNS:
        what = f"fused full width {strategy} {grad_mode}"
        sess = session("fused", strategy, grad_mode)
        sess.train(FULL_WARM)
        torch.cuda.synchronize()
        t = time.perf_counter()
        hist = sess.train(FULL_AVG)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) / FULL_AVG * 1e3
        stage = dict(sess.engine.last_stage_stats)
        losses = [(m.client_loss, m.server_loss) for m in hist]
        check(all(math.isfinite(a) and math.isfinite(b) for a, b in losses),
              f"{what}: {FULL_AVG} rounds, finite losses "
              + ", ".join(f"{a:.4f}/{b:.4f}" for a, b in losses))
        syncs = count_syncs(lambda: sess.train(FULL_AVG))
        chunks = sess.engine.last_stage_stats["chunks"]
        torch.cuda.synchronize()
        tr = traced(lambda: sess.train(2), 1, f"{what}, 2 rounds")
        peak = torch.cuda.max_memory_allocated()
        beside = (f"; the reference engine {ref['ms_round']:.1f} ms per "
                  f"round ({ref['images_s']:,.0f} images/s, phase paper)"
                  if ref else "")
        print(f"{what}: {ms:.1f} ms per round, {1e3 / ms:.2f} rounds/s, "
              f"{images / ms * 1e3:,.0f} images/s ({FULL_AVG} timed after "
              f"{FULL_WARM} warm-up; chunks {stage['chunks']}, staging "
              f"overlap_fraction {stage['overlap_fraction']:.3f}){beside}")
        print(f"{what}: {syncs} synchronizing calls over {chunks} chunks "
              f"({syncs / chunks:.2f} per chunk; the engine read the losses "
              f"{sess.engine.last_host_syncs} times); traced "
              f"{tr['wall_ms'] / 2:.1f} ms per round, busy "
              f"{tr['busy_ms'] / 2:.1f} ms, idle share "
              f"{tr['idle_share']:.3f}, {tr['kernels'] / 2:.0f} kernels per "
              f"round; peak {peak / 2**30:.2f} GiB")
        check(syncs == chunks,
              f"{what}: one host sync per chunk ({syncs} over {chunks})")
        r = dict(ms_round=ms, rounds_s=1e3 / ms, images_s=images / ms * 1e3,
                 losses=losses, syncs=syncs, chunks=chunks,
                 overlap_fraction=stage["overlap_fraction"],
                 traced_ms_round=tr["wall_ms"] / 2,
                 busy_ms_round=tr["busy_ms"] / 2,
                 idle_share=tr["idle_share"],
                 kernels_round=tr["kernels"] / 2, peak_gib=peak / 2**30)
        for tau in PAPER_TAUS:
            ad = sess.evaluate_adaptive(x_test, y_test, tau)
            check(all(0.0 <= v <= 1.0 for v in ad["acc"] + ad["client_ratio"])
                  and all(math.isfinite(v) for v in ad["mean_entropy"]),
                  f"{what} tau={tau}: mean acc {np.mean(ad['acc']):.4f}, "
                  f"mean client ratio {np.mean(ad['client_ratio']):.4f}")
        out[f"{strategy}_{grad_mode}"] = r
        del sess
    # a probe beside the main path: cuDNN's algorithm search
    # (torch.backends.cudnn.benchmark, off everywhere else) for both
    # engines under averaging, FULL_PROBE rounds timed after the warm-up
    # round that searches, and 2 traced
    torch.backends.cudnn.benchmark = True
    try:
        for engine in ("reference", "fused"):
            what = f"{engine} full width averaging eq1, cudnn.benchmark on"
            sess = session(engine)
            sess.train(FULL_WARM)
            torch.cuda.synchronize()
            t = time.perf_counter()
            sess.train(FULL_PROBE)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) / FULL_PROBE * 1e3
            tr = traced(lambda: sess.train(2), 1, f"{what}, 2 rounds")
            print(f"{what}: {ms:.1f} ms per round ({FULL_PROBE} timed); "
                  f"traced busy {tr['busy_ms'] / 2:.1f} ms per round, idle "
                  f"share {tr['idle_share']:.3f}")
            out[f"benchmark_{engine}"] = dict(
                ms_round=ms, busy_ms_round=tr["busy_ms"] / 2,
                idle_share=tr["idle_share"])
            del sess
    finally:
        torch.backends.cudnn.benchmark = False
    state["fused"] = out
    torch.cuda.empty_cache()


def backbone_leg_run(sess, family: str) -> list:
    """LANE_ROUNDS rounds of fused eq1 on the kernels."""
    from repro_torch.parity import LANE_ROUNDS
    hist = sess.train(LANE_ROUNDS)
    print(f"  fused {family} bf16 smoke, lanes {sess.ctx.profile.split_layers}"
          f", kernels: losses " + ", ".join(
              f"{m.client_loss:.4f}/{m.server_loss:.4f}" for m in hist))
    return hist


def backbone_leg_checks(family: str, sess, start, hist) -> None:
    """The backbone leg on the plain versions from the same start: losses
    within TOL_LOSS_BF16 of the family, and the first fused step's
    gradients leaf by leaf within TOL_GRAD_BF16."""
    from repro_torch.parity import (LANE_ROUNDS, TOL_GRAD_BF16,
                                    TOL_LOSS_BF16, backbone_session,
                                    cohort_first_grads, grad_rel_errors)
    plain = backbone_session(family, "ref", "cuda", state=start.clone())
    want = cohort_first_grads(plain)
    plain_hist = plain.train(LANE_ROUNDS)
    got = cohort_first_grads(
        backbone_session(family, "auto", "cuda", state=start.clone()))
    errs = grad_rel_errors(got, want)
    dl = max(max(abs(a.client_loss - b.client_loss),
                 abs(a.server_loss - b.server_loss))
             for a, b in zip(hist, plain_hist))
    print(f"  reading fused {family} bf16 smoke, kernels vs plain: max|dloss| "
          f"{dl:.3e} over {LANE_ROUNDS} rounds; first-step gradients, max "
          f"over {len(errs)} leaves of ||g - g_plain|| / ||g_plain|| "
          f"{max(errs):.3e}")
    check(dl <= TOL_LOSS_BF16[family] and max(errs) <= TOL_GRAD_BF16,
          f"fused {family} bf16 smoke under lanes, kernels vs plain: losses "
          f"within {TOL_LOSS_BF16[family]:g} ({dl:.2e}), every gradient leaf "
          f"within {TOL_GRAD_BF16:g} ({max(errs):.2e})")


def lane_rule_checks() -> None:
    """Each kernel site's vmap rule (lanes folded into one launch) against
    a per-lane loop of plain launches (``parity.lane_sites``): the
    attention and cross-attention forward and backward bit for bit, the
    wkv within TOL_LANE_WKV of each one's largest magnitude; the folded
    run launches each kernel once."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from repro_torch.kernels.rwkv_wkv import rwkv_wkv, rwkv_wkv_bwd
    from repro_torch.parity import lane_loop_gaps, lane_sites
    sites = lane_sites("cuda")
    for name, (site, inputs) in sites.items():
        wrappers = ((flash_attention, flash_attention_bwd_dkv,
                     flash_attention_bwd_dq) if name != "wkv"
                    else (rwkv_wkv, rwkv_wkv_bwd))
        before = [w.launches for w in wrappers]
        r = lane_loop_gaps(site, inputs)
        torch.cuda.synchronize()
        lanes = len(inputs[0])
        made = [w.launches - b for w, b in zip(wrappers, before)]
        print(f"  reading {name} vmap rule vs {lanes} per-lane launches "
              f"{tuple(inputs[0].shape[1:])} x {lanes} lanes: outputs "
              f"max|d| {r['out']:.3e} (scale {r['out_scale']:.3g}), "
              f"gradients {r['grad']:.3e} (scale {r['grad_scale']:.3g}); "
              f"launches {made}")
        ok_launch = all(m == 1 + lanes for m in made)
        if name != "wkv":
            check(ok_launch and r["out"] == 0.0 and r["grad"] == 0.0,
                  f"{name} vmap rule (lanes into the batch): one launch "
                  f"of each kernel for all lanes, outputs and gradients bit "
                  f"for bit equal to per-lane launches")
        else:
            worst = max(r["out"] / max(1.0, r["out_scale"]),
                        r["grad"] / max(1.0, r["grad_scale"]))
            check(ok_launch and worst <= TOL_LANE_WKV,
                  f"wkv vmap rule (lanes into the heads, u per lane): one "
                  f"launch of each kernel for all lanes, outputs and "
                  f"gradients within {TOL_LANE_WKV:g} of per-lane launches "
                  f"({worst:.2e})")


# phase lifecycle: the full-width population (phase fused's config drawn
# from POP_CLIENTS Dirichlet clients, the churn leg of
# benchmarks/population_bench.py), its rounds and checkpoints
POP_CLIENTS, POP_ROUNDS, POP_SAVE_EVERY, POP_KEEP = 36, 8, 4, 2
POP_FIXED_ROUNDS, POP_TIMED, POP_TRACED = 3, 3, 3
# the population smoke's card-vs-CPU readings round by round (drift_by_round)
POP_DRIFT_ROUNDS = 4
# full participation against the fixed cohort under cuDNN's default
# algorithms (run to run they differ: the conv gradients' atomics), losses
# and drift, near the geometric mean of two H100 readings over 3 rounds:
# the fixed cohort against itself, 2.2e-5 and 6.0e-3, and a planted fault
# (the first lane left out of the masked Eq. (1)), 8.3e-3 and 0.21
TOL_DEFAULT_LOSS, TOL_DEFAULT_PARAMS = 5e-4, 4e-2


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms while the block runs."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def phase_lifecycle(state):
    """The training entry point's lifecycle (see the module docstring):
    population_parity (the smoke, card vs CPU, resume, two planted
    faults), then with every launch count at 0 the full-width population
    (population_main), the backbone smokes under populations and the
    restored ServeSession, whose launches are read before the live
    ServeSession it is held against serves; then the backbone legs on the
    plain versions, the masked-step checks and the full-width comparison
    under cuDNN's default algorithms (comparisons)."""
    from repro_torch.kernels.entropy_exit import entropy_exit
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from repro_torch.kernels.rwkv_wkv import rwkv_wkv, rwkv_wkv_bwd
    from repro_torch.parity import POP_LANE_FAMILIES, backbone_session
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    population_parity()
    counted = (entropy_exit, flash_attention, flash_attention_bwd_dkv,
               flash_attention_bwd_dq, rwkv_wkv, rwkv_wkv_bwd)
    zero_counts(*counted)
    default_algorithms = population_main(state)
    legs = {}
    for family in POP_LANE_FAMILIES:
        sess = backbone_session(family, "auto", "cuda", population=True)
        start = sess.state.clone()
        legs[family] = (sess, start, backbone_leg_run(sess, family))
    counts = serve_restored(legs["glm4_9b"][0], lambda: {
        k: n for w in counted for k, n in launch_counts(w).items()})
    print("lifecycle: launches on the lifecycle paths (full-width "
          "population and its evaluations, backbone population legs, the "
          "restored ServeSession): " + ", ".join(
              f"{k} {n}" for k, n in counts.items() if n))
    rows = ("flash_attention_tile", "flash_attention_bwd_dkv",
            "flash_attention_bwd_dq", "rwkv_wkv", "rwkv_wkv_bwd")
    check(all(counts[k] > 0 for k in rows + ("entropy_exit",
                                              "flash_attention")),
          "lifecycle: rows 2-6 launched under masked lanes ("
          + ", ".join(f"{k} {counts[k]}" for k in rows)
          + f"), the gate ({counts['entropy_exit']}) and decode attention "
          f"({counts['flash_attention']}) in evaluation and serving")
    state["lifecycle_launches"] = counts
    launches = state.setdefault("launches", {})
    for k in KERNELS:
        launches[k] = launches.get(k, 0) + counts.get(k, 0)
    for family, (sess, start, hist) in legs.items():
        population_leg_checks(family, sess, start, hist)
    default_algorithms()


def population_parity() -> None:
    """The churning population smoke (repro_torch/parity.py): the card
    against the CPU from one start, then a run resumed from a mid-run
    checkpoint against the uninterrupted one on the card; each also under
    a planted fault that it must reject."""
    import tempfile
    from repro_torch.api import TrainSession
    from repro_torch.parity import (PAPER_EPOCHS, POP_SMOKE_ROUNDS,
                                    TOL_PAPER_LOSS, TOL_PAPER_PARAMS,
                                    inactive_lanes_counted, paper_drift,
                                    population_session, population_smoke,
                                    population_smoke_data, unaligned_cursor)
    x, y = population_smoke_data()
    n, half = POP_SMOKE_ROUNDS, POP_SMOKE_ROUNDS // 2

    def compare(what, a, ha, b, hb, start):
        dl = max(max(abs(p.client_loss - q.client_loss),
                     abs(p.server_loss - q.server_loss))
                 for p, q in zip(ha, hb))
        d = paper_drift(a.state, b.state, start)
        same = ([(m.active_clients, m.stragglers) for m in ha]
                == [(m.active_clients, m.stragglers) for m in hb])
        print(f"  reading population smoke {what}: max|dloss| {dl:.3e}; "
              f"drift clients {d['clients']:.3e} servers {d['servers']:.3e};"
              f" active per round {[m.active_clients for m in ha]} vs "
              f"{[m.active_clients for m in hb]}")
        return (dl <= TOL_PAPER_LOSS and same
                and max(d["clients"], d["servers"]) <= TOL_PAPER_PARAMS)

    cpu = population_session("cpu", x, y)
    start = cpu.state.clone()
    h_cpu = cpu.train(n, PAPER_EPOCHS)
    plans = [cpu.ctx.population.schedule.plan(t, PAPER_EPOCHS)
             for t in range(n)]
    check(all(0 < p.num_active < len(p.slot_mask) for p in plans),
          f"population smoke: every round aggregates with a lane masked "
          f"(active per round {[p.num_active for p in plans]}), so the "
          f"faults below can show")
    card = population_session("cuda", x, y, state=start)
    h_card = card.train(n, PAPER_EPOCHS)
    check(compare("card vs CPU", card, h_card, cpu, h_cpu, start),
          f"population smoke, card vs CPU: losses within "
          f"{TOL_PAPER_LOSS:g}, drift within {TOL_PAPER_PARAMS:g}, the "
          f"same active and straggler counts")
    with inactive_lanes_counted():
        bad = population_session("cuda", x, y, state=start)
        h_bad = bad.train(n, PAPER_EPOCHS)
    check(not compare("planted fault (inactive lanes counted in the "
                      "masked Eq. (1)) vs CPU", bad, h_bad, cpu, h_cpu,
                      start),
          "population smoke: the planted fault (inactive lanes counted in "
          "the masked Eq. (1)) rejected")
    drift_by_round()
    with tempfile.TemporaryDirectory() as tmp:
        first = population_session("cuda", x, y, state=start)
        first.train(half, PAPER_EPOCHS)
        first.save(os.path.join(tmp, "ckpt"))
        for planted in (False, True):
            with (unaligned_cursor() if planted
                  else contextlib.nullcontext()):
                back = TrainSession.restore(
                    os.path.join(tmp, "ckpt"), card.model, None,
                    population=population_smoke(x, y))
                back.train(n - half, PAPER_EPOCHS)
            ok = compare(("planted fault (the restored cursor left at "
                          "round 0), " if planted else "")
                         + f"{half} + {n - half} resumed vs {n} on the card",
                         back, back.history, card, h_card, start)
            if planted:
                check(not ok, "population smoke: the planted fault (a "
                      "restored cursor left at round 0) rejected")
            else:
                check(ok, f"population smoke: {half} rounds, save, "
                      f"restore, {n - half} rounds equal {n} uninterrupted "
                      f"on the card at the same limits")


def drift_by_round() -> None:
    """Readings, not checks: why the fp32 smoke's card and CPU runs part
    under churn.  Over POP_DRIFT_ROUNDS rounds (images and schedule sized
    for them), round by round, the churning population and the fixed
    cohort on the same images, each card against CPU from one start: the
    losses' gap, the drift, each slot's Adam steps so far and each slot's
    ||card - CPU|| (clients, servers)."""
    from repro_torch.parity import (PAPER_EPOCHS, paper_drift,
                                    population_session,
                                    population_smoke_data, slot_gaps)
    x, y = population_smoke_data(rounds=POP_DRIFT_ROUNDS)
    for pop in ("churn", None):
        what = "population" if pop else "fixed cohort"
        cpu = population_session("cpu", x, y, rounds=POP_DRIFT_ROUNDS,
                                 population=pop)
        start = cpu.state.clone()
        card = population_session("cuda", x, y, state=start,
                                  rounds=POP_DRIFT_ROUNDS, population=pop)
        for r in range(POP_DRIFT_ROUNDS):
            (a,), (b,) = (card.train(1, PAPER_EPOCHS),
                          cpu.train(1, PAPER_EPOCHS))
            d = paper_drift(card.state, cpu.state, start)
            g = slot_gaps(card.state, cpu.state)
            dl = max(abs(a.client_loss - b.client_loss),
                     abs(a.server_loss - b.server_loss))
            print(f"  reading {what} smoke round {r}, card vs CPU: active "
                  f"{a.active_clients}, Adam steps "
                  f"{[o.step for o in cpu.state.client_opts]}, max|dloss| "
                  f"{dl:.3e}, drift clients {d['clients']:.3e} servers "
                  f"{d['servers']:.3e}; ||card - CPU|| per slot clients "
                  f"{[f'{v:.2e}' for v in g['clients']]} servers "
                  f"{[f'{v:.2e}' for v in g['servers']]}")


def population_main(state):
    """Phase fused's full-width config drawn from a Dirichlet population of
    POP_CLIENTS clients with churn (the module docstring lists the
    settings): POP_ROUNDS rounds saved every POP_SAVE_EVERY, the run cut
    after the first save and resumed by restore_latest against the
    uninterrupted run, checkpoint sizes and times, host syncs per chunk,
    traced rounds at different active counts, full participation against
    the fixed cohort, evaluate_adaptive, peak memory.  Returns the
    comparison under cuDNN's default algorithms, for the caller to run
    once the launch counts are read."""
    import shutil
    import tempfile
    from repro_torch.api import TrainSession
    from repro_torch.config import HeteroProfile, OptimizerConfig, SplitEEConfig
    from repro_torch.configs import resnet18_cifar
    from repro_torch.core.splitee import ResNetSplitModel
    from repro_torch.data.pipeline import ClientPartitioner
    from repro_torch.data.synthetic import SyntheticImageDataset
    from repro_torch.parity import (POP_CHURN, TOL_PAPER_LOSS,
                                    TOL_PAPER_PARAMS, masked_lane_left_out,
                                    paper_drift)
    from repro_torch.population import ClientPopulation
    cfg = resnet18_cifar.config("cifar10")
    splits = resnet18_cifar.HETERO_SPLITS
    ds = SyntheticImageDataset(num_classes=10, image_size=32,
                               train_size=FULL_TRAIN, test_size=FULL_TEST,
                               seed=0)
    x_test, y_test = ds.test
    card = card_line()
    total = POP_ROUNDS + POP_FIXED_ROUNDS + POP_TIMED + 2 * POP_TRACED + 4

    def population(**kw):
        return ClientPopulation.dirichlet(
            *ds.train, POP_CLIENTS, splits, min_shard=FULL_BATCH,
            **{**POP_CHURN, **kw})

    def session(pop=None, data=None, state=None):
        torch.cuda.synchronize()
        return TrainSession.from_config(
            ResNetSplitModel(cfg, device="cuda"),
            SplitEEConfig(profile=HeteroProfile(splits)),
            OptimizerConfig(lr=FULL_LR, total_steps=total), data,
            FULL_BATCH, engine="fused", population=pop)

    def timed(run, n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        hist = run()
        torch.cuda.synchronize()
        return hist, (time.perf_counter() - t) / n * 1e3

    def drift(what, a, ha, b, hb, start, tol=(TOL_PAPER_LOSS,
                                              TOL_PAPER_PARAMS),
              reject=False):
        dl = max(max(abs(p.client_loss - q.client_loss),
                     abs(p.server_loss - q.server_loss))
                 for p, q in zip(ha, hb))
        d = paper_drift(a.state, b.state, start)
        print(f"  reading {what}: max|dloss| {dl:.3e}; drift clients "
              f"{d['clients']:.3e} servers {d['servers']:.3e}; BN max|d| "
              f"clients {d['clients_bn']:.3e} servers {d['servers_bn']:.3e}")
        if tol is None:
            return
        within = (dl <= tol[0]
                  and max(d["clients"], d["servers"]) <= tol[1])
        check(within != reject,
              f"{what}: {'rejected, ' if reject else ''}losses within "
              f"{tol[0]:g} ({dl:.3e}), drift clients {d['clients']:.3e}, "
              f"servers {d['servers']:.3e} <= {tol[1]:g}")

    out = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="lifecycle-")
    try:
        pop = population()
        sess = session(pop)
        start = sess.state.clone()
        print(f"lifecycle: full-width ResNet-18, {len(splits)} slots "
              f"{splits}, population of {POP_CLIENTS} (Dirichlet alpha "
              f"{POP_CHURN['alpha']}, participation "
              f"{POP_CHURN['participation_rate']}, churn seed "
              f"{POP_CHURN['churn_seed']}, stragglers "
              f"{POP_CHURN['straggler_rate']}, min shard {FULL_BATCH}), "
              f"shard sizes {min(pop.shard_sizes())}-"
              f"{max(pop.shard_sizes())}; engine {sess.engine_name}")
        run_dir = os.path.join(tmp, "run")
        # the comparisons with cuDNN's deterministic algorithms: with the
        # default ones two runs of one round on one card differ by a few
        # ulps (the conv gradients' atomics), which 3-4 rounds amplify
        with cudnn_deterministic():
            hist, ms_saving = timed(lambda: sess.train(
                POP_ROUNDS, save_every=POP_SAVE_EVERY, save_dir=run_dir,
                keep_last=POP_KEEP), POP_ROUNDS)
            kept = sorted(f for f in os.listdir(run_dir)
                          if f.endswith(".npz"))
            check(kept == [f"ckpt-{r:08d}.npz" for r in
                           range(POP_ROUNDS - (POP_KEEP - 1) * POP_SAVE_EVERY,
                                 POP_ROUNDS + 1, POP_SAVE_EVERY)],
                  f"lifecycle: {POP_ROUNDS} rounds saved every "
                  f"{POP_SAVE_EVERY}, the newest {POP_KEEP} kept ({kept})")
            active = [m.active_clients for m in hist]
            print(f"lifecycle active_per_round {active}, stragglers per "
                  f"round {[m.stragglers for m in hist]} [{card}]")
            # the run is cut after its round-POP_SAVE_EVERY save
            for ext in (".npz", ".json"):
                os.remove(os.path.join(run_dir,
                                       f"ckpt-{POP_ROUNDS:08d}{ext}"))
            torch.cuda.synchronize()
            t = time.perf_counter()
            back = TrainSession.restore_latest(run_dir, ResNetSplitModel(
                cfg, device="cuda"), None, population=population())
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t) * 1e3
            check(back.round == POP_SAVE_EVERY
                  and back.engine.name == "fused",
                  f"lifecycle: restore_latest resumed at round {back.round}")
            rest = POP_ROUNDS - POP_SAVE_EVERY
            back.train(rest)
            drift(f"full-width population, {POP_SAVE_EVERY} + {rest} "
                  f"resumed vs {POP_ROUNDS} uninterrupted", back,
                  back.history, sess, hist, start)
            del sess
            path = os.path.join(tmp, "one", "ckpt")
            torch.cuda.synchronize()
            t = time.perf_counter()
            back.save(path)
            save_ms = (time.perf_counter() - t) * 1e3
            mb = sum(os.path.getsize(path + ext)
                     for ext in (".npz", ".json")) / 1e6
            print(f"lifecycle checkpoint: save {save_ms:.1f} ms, restore "
                  f"(restore_latest, state to the card) {restore_ms:.1f} "
                  f"ms, {mb:.1f} MB on disk (npz + json) [{card}]")
            # full participation (the 12 shards as a slot-shaped
            # population) against the fixed cohort on them, one start
            shards = ClientPartitioner(len(splits)).split(*ds.train)
            fixed = session(data=shards)
            start = fixed.state.clone()
            full = session(ClientPopulation.from_shards(shards, splits))
            full.state = start.clone()
            h_fix = fixed.train(POP_FIXED_ROUNDS)
            h_full = full.train(POP_FIXED_ROUNDS)
            check(all(m.active_clients == len(splits) for m in h_full),
                  "lifecycle: full participation, every slot active")
            drift(f"full participation vs the fixed cohort, "
                  f"{POP_FIXED_ROUNDS} rounds", full, h_full, fixed, h_fix,
                  start)
        # ms per round with cuDNN's default algorithms, the three sessions
        # in turn
        _, ms_pop = timed(lambda: back.train(POP_TIMED), POP_TIMED)
        _, ms_full = timed(lambda: full.train(POP_TIMED), POP_TIMED)
        _, ms_fix = timed(lambda: fixed.train(POP_TIMED), POP_TIMED)
        del fixed, full
        syncs = count_syncs(lambda: back.train(4, chunk_rounds=2))
        chunks = back.engine.last_stage_stats["chunks"]
        print(f"lifecycle population: {syncs} synchronizing calls over "
              f"{chunks} chunks ({syncs / chunks:.2f} per chunk) [{card}]")
        check(syncs == chunks, f"lifecycle population: one host sync per "
              f"chunk ({syncs} over {chunks})")
        # each round once under torch.profiler (kernels, busy, idle), then
        # once with its operations counted by name as they are dispatched:
        # the check reads the operations (an H100 once traced 56 cat kernels
        # fewer in one of three rounds, PERF.md section 6)
        by_active: dict = {}
        ops = []
        for _ in range(POP_TRACED):
            t0 = back.round
            tr = traced(lambda: back.train(1), 1,
                        f"full-width population round {t0}", top=0)
            kernels_round = tr["kernels"]
            a = back.history[-1].active_clients
            counted = round_ops(lambda: back.train(1))
            a2 = back.history[-1].active_clients
            by_active.setdefault(a, []).append(("kernels", kernels_round))
            by_active.setdefault(a2, []).append(("ops",
                                                 sum(counted.values())))
            ops.append(counted)
        print(f"lifecycle kernels (traced) and operations (dispatched) per "
              f"round by active count "
              f"{ {a: k for a, k in sorted(by_active.items())} } [{card}]")
        diff = [dict((ops[0] - c) + (c - ops[0])) for c in ops[1:]]
        seen = {a for a, ks in by_active.items()
                if any(kind == "ops" for kind, _ in ks)}
        check(len(seen) > 1 and not any(diff),
              f"lifecycle: the same operations, name by name, in rounds of "
              f"different active counts ({sorted(seen)}; differing: {diff})")
        for tau in PAPER_TAUS:
            ad = back.evaluate_adaptive(x_test, y_test, tau)
            check(all(0.0 <= v <= 1.0 for v in ad["acc"] + ad["client_ratio"])
                  and all(math.isfinite(v) for v in ad["mean_entropy"]),
                  f"lifecycle population tau={tau}: mean acc "
                  f"{np.mean(ad['acc']):.4f}, mean client ratio "
                  f"{np.mean(ad['client_ratio']):.4f}")
        del back
        peak = torch.cuda.max_memory_allocated()
        print(f"lifecycle ms per round: churning population {ms_pop:.1f}, "
              f"full-participation population {ms_full:.1f}, fixed cohort "
              f"{ms_fix:.1f} ({POP_TIMED} rounds each, in turn; "
              f"{ms_saving:.1f} a round over the first {POP_ROUNDS} with "
              f"their saves and deterministic convs); peak "
              f"{peak / 2**30:.2f} GiB [{card}]")
        out.update(ms_pop=ms_pop, ms_saving=ms_saving, ms_full=ms_full,
                   ms_fixed=ms_fix, save_ms=save_ms, restore_ms=restore_ms,
                   mb=mb, syncs=syncs, chunks=chunks, active=active,
                   kernels_by_active=by_active, peak_gib=peak / 2**30)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    state["lifecycle"] = out
    torch.cuda.empty_cache()

    def default_algorithms() -> None:
        """Full participation against the fixed cohort again, under
        cuDNN's default algorithms (those of the timed rounds): the fixed
        cohort against itself, the witness of their run-to-run spread,
        full participation against it at TOL_DEFAULT_*, and the same under
        a planted fault it must reject, each from the fixed cohort's
        start."""
        def default_run(name):
            pop = (ClientPopulation.from_shards(shards, splits)
                   if name in ("full", "fault") else None)
            run = session(pop, data=None if pop else shards)
            run.state = start.clone()
            with (masked_lane_left_out() if name == "fault"
                  else contextlib.nullcontext()):
                return run, run.train(POP_FIXED_ROUNDS)

        base = default_run("fixed")
        tol = (TOL_DEFAULT_LOSS, TOL_DEFAULT_PARAMS)
        for name, what, limits, reject in (
                ("again", "the fixed cohort against itself", None, False),
                ("full", "full participation vs the fixed cohort", tol,
                 False),
                ("fault", "planted fault (the first lane left out of the "
                 "masked Eq. (1)) vs the fixed cohort", tol, True)):
            drift(f"default algorithms, {what}, {POP_FIXED_ROUNDS} rounds",
                  *default_run(name), *base, start, tol=limits,
                  reject=reject)
        del base

    return default_algorithms


def round_ops(run):
    """A Counter, by name, of the operations ``run()`` dispatches on this
    thread (below autograd and vmap, each one launch or a few)."""
    import collections
    from torch.utils._python_dispatch import TorchDispatchMode
    counted: collections.Counter = collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counted[str(func)] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        run()
    torch.cuda.synchronize()
    return counted


def serve_restored(sess, read_counts):
    """``ServeSession.restore`` of ``sess``'s checkpoint (the glm4-9b bf16
    smoke trained under a population) against a ServeSession on
    ``assemble_serve_params`` of the live state: 4 requests, tokens and
    gate decisions equal.  Returns ``read_counts()`` as read after the
    restored session served and before the live one (a comparison) did."""
    import tempfile
    from repro_torch.api import ServeSession
    from repro_torch.api.serve_session import assemble_serve_params
    model = sess.model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, model.cfg.vocab_size, int(rng.integers(8, 40)))
               for _ in range(4)]
    with tempfile.TemporaryDirectory() as tmp:
        sess.save(os.path.join(tmp, "ckpt"))
        restored = ServeSession.restore(os.path.join(tmp, "ckpt"), model,
                                        slots=2, max_len=64)
    live = ServeSession(model.cfg, assemble_serve_params(
        model, sess.state, restored.boundary), tau=restored.tau,
        boundary=restored.boundary, slots=2, max_len=64,
        device=model.device)
    for s in (restored, live):
        for p in prompts:
            s.submit(p, decode_tokens=6)
    got = {r.rid: r for r in restored.run()}
    counts = read_counts()
    want = {r.rid: r for r in live.run()}
    same = all(got[i].tokens == want[i].tokens
               and got[i].exited == want[i].exited for i in want)
    print(f"  reading restored ServeSession: tokens "
          f"{[got[i].tokens for i in sorted(got)]}, exits "
          f"{sum(sum(r.exited) for r in got.values())} of "
          f"{sum(len(r.exited) for r in got.values())}")
    check(same and len(got) == len(prompts),
          f"ServeSession.restore of the {model.name} population checkpoint "
          f"serves the live state's tokens and gates ({len(prompts)} "
          f"requests, tau {restored.tau})")
    return counts


def population_leg_checks(family: str, sess, start, hist) -> None:
    """The backbone population leg on the plain versions from the same
    start (losses within TOL_LOSS_BF16, the same active counts); then one
    masked cohort step with the kernels whose masked lane must not move,
    also under a planted fault (its Adam step advances) it must reject."""
    from repro_torch.parity import (LANE_ROUNDS, TOL_LOSS_BF16,
                                    advancing_masked_step, backbone_session,
                                    masked_lane_gaps)
    plain = backbone_session(family, "ref", "cuda", state=start.clone(),
                             population=True)
    plain_hist = plain.train(LANE_ROUNDS)
    dl = max(max(abs(a.client_loss - b.client_loss),
                 abs(a.server_loss - b.server_loss))
             for a, b in zip(hist, plain_hist))
    active = [m.active_clients for m in hist]
    print(f"  reading {family} bf16 smoke population leg, kernels vs plain: "
          f"max|dloss| {dl:.3e} over {LANE_ROUNDS} rounds, active per round "
          f"{active}")
    check(dl <= TOL_LOSS_BF16[family]
          and active == [m.active_clients for m in plain_hist],
          f"{family} bf16 smoke under a population, kernels vs plain: "
          f"losses within {TOL_LOSS_BF16[family]:g} ({dl:.2e})")
    k = sum(1 for s in sess.ctx.profile.split_layers
            if s == min(sess.ctx.profile.split_layers))
    mask = [1.0] * (k - 1) + [0.0]
    gaps = masked_lane_gaps(sess, mask)
    print(f"  reading {family} masked cohort step, mask {mask}: masked lane "
          f"max|d| {gaps['masked']:.3e}, its Adam steps {gaps['masked_steps']}"
          f", active lanes moved {gaps['active']:.3e}")
    check(gaps["masked"] == 0.0 and gaps["masked_steps"] == 0.0
          and gaps["active"] > 0.0,
          f"{family} masked cohort step with the kernels: the masked lane's "
          f"parameters, moments, statistics and Adam steps unchanged, the "
          f"active lanes moved")
    with advancing_masked_step():
        bad = masked_lane_gaps(sess, mask)
    check(bad["masked_steps"] != 0.0, f"{family}: the planted fault (a "
          f"masked lane's Adam step advances) rejected "
          f"(steps moved by {bad['masked_steps']})")


# the spmd engine (phase spmd): ranks spawned by launch.hostdevices, two
# sharing the one card over gloo (CUDA tensors), and with two cards or more
# also one rank per card over NCCL.  Each leg runs SPMD_ROUNDS rounds from
# one round-0 state, round by round (host clock, ending in a synchronize)
SPMD_ROUNDS = 2
SPMD_LDM = ("lanes", "data", "model")
# a leg with a data split against the fused engine in fp32: each rank's
# convs see its share of the batch (other cuDNN algorithms), BatchNorm sums
# the shares and the gradients are averaged over the ranks, and Adam's
# first steps at lr 3e-3 carry that rounding on.  Read on 2 ranks of one
# H100 (PERF.md section 5): losses 6.50e-5, drift clients 3.25e-2 /
# servers 3.02e-2, over phase fused's 1e-5 / 2e-2.  The same comparison in float64 must
# read TOL_SPMD_F64_RATIO of the fp32 gaps or less, which shows that the
# gap is rounding
TOL_SPMD_DATA_LOSS = 5e-4
TOL_SPMD_DATA_PARAMS = 1e-1
TOL_SPMD_F64_RATIO = 1e-2
# serving over the ranks (phase spmd): glm4-9b at its published widths cut
# to SPMD_SERVE_LAYERS layers by phase main's rule, bf16, 8 slots, 8
# requests of 16-128 tokens, 2 decode tokens each (a tick gathers ~3.9 GB
# of weights a rank through gloo, which stages them in pinned host memory
# that the allocator keeps: legs at 8 and at 4 layers in one run took the
# machine's 96 GiB), a 160-slot ring (even: split in two over "model").  At 4 layers every run is one layer, so the rules
# split every layer's ring along its sequence; at phase main's 8 (runs of
# two) they put the cache's slot dim over "model" instead
# (launch/shardings.cache_specs)
SPMD_SERVE_LAYERS = 4
# the MoE split's block check: a capacity factor at which every expert of
# the qwen3-moe smoke (4 experts, top 2) drops entries, so capacity reads
# the whole batch's loads
SPMD_MOE_TIGHT = 0.5
# the loss limit of the qwen3-moe bf16 smoke's batch and experts over the
# ranks against the one-rank fused run comes from its own readings
# (scripts/moe_split_witness.py, PERF.md section 5, NVIDIA H100 80GB
# HBM3, 700 W), as TOL_SPMD_TP_LOSS does: over seeds 0-7 the split read
# 8.2e-5 to 1.586e-3, the bf16 control (the one-rank run on the plain
# versions against the kernels) 3.83e-4 to 1.455e-3, the planted faults
# 1.408e-2 to 2.742e-2 (expert gradients all-reduced) and 6.621e-2 to
# 1.158e-1 (local slots).  One step's expert gradients equal one rank's;
# every other leaf's carries the data split's rounding of each rank's
# partial sum, which Adam's first step turns into whole learning-rate
# steps, so parity.TOL_LOSS_BF16 (1.5e-3) lies inside the sound spread.
# The limit sits 3 x above the largest sound reading and 2.8 x below the
# smallest fault's
TOL_SPMD_MOE_LOSS = 5e-3
# expert parallelism at published widths (spmd_moe_block_leg): one
# qwen3-moe-235b-a22b MoE block, its rows over the ranks, each rank
# SPMD_MOE_BLOCK_ROWS sequences of SPMD_MOE_BLOCK_SEQ tokens, timed over
# SPMD_MOE_BLOCK_ITERS forward and backward passes after one warm one
SPMD_MOE_BLOCK_ROWS, SPMD_MOE_BLOCK_SEQ, SPMD_MOE_BLOCK_ITERS = 4, 512, 3
SPMD_SERVE_SLOTS, SPMD_SERVE_REQUESTS, SPMD_SERVE_DECODE = 8, 8, 2
SPMD_SERVE_MAX_LEN = 160
# tensor parallelism over "model" (phase spmd, spmd_tp_legs): the same
# glm4-9b, 4 decode tokens a request; SPMD_TP_STEPS rounds of one client
# cut at SPMD_TP_CUT, SPMD_TP_BATCH sequences of parity.TRAIN_SEQ tokens.
# The loss limit of the tensor-parallel session against the fused engine
# on one rank comes from its own readings (PERF.md section 5, NVIDIA H100
# 80GB HBM3, 700 W): the sound session read 8.204e-3 and the bf16 control
# (the one-rank session on the plain versions against the kernels)
# 1.641e-2 over 3 rounds (a loss of ~12.5 at the published vocab, each
# round's mean over 8 rows, Adam carrying the rounding on); the planted
# faults read 8.328e-1 (row) and 7.268e-1 (sum exp) over 3 rounds and
# 1.100e-1 and 6.933e-1 in the one round they now run.  The limit sits
# 3 x above the control and 2 x below the smallest fault
SPMD_TP_DECODE, SPMD_TP_STEPS, SPMD_TP_BATCH, SPMD_TP_CUT = 4, 3, 8, 2
# serving with the experts kept over the batch ranks
# (spmd_serve_experts_leg): qwen3-moe-235b-a22b cut to 8 layers (weights
# of 46.0 GB whole, 38.65 GB of them the expert stacks, reckoned from
# their shapes), its experts over "data", the other weights whole on each
# rank (fsdp-off: a rank holds 26.7 GB and a tick gathers nothing; the
# data-parallel attention beside split experts of serving deployments)
SPMD_EXPERT_LAYERS, SPMD_EXPERT_RECIPE = 8, "fsdp-off"
TOL_SPMD_TP_LOSS = 5e-2
# the MoE, MLA, RWKV6 and Mamba2 legs over "model" (spmd_family_legs, on
# phase spmd's ranks after the others, mesh (1, 2), bf16, published widths):
# deepseek-v3-671b cut to 4 layers (3 dense-MLP layers and 1 MoE layer of
# 256 experts top 8, ~32 GB whole, ~16 GB a rank) served under megatron
# (MLA's 128 heads and the experts over the grid: 64 heads and 128
# experts a rank); zamba2-1.2b cut to 6 layers (5 Mamba2 layers and the
# shared attention block at layer 6) served under greedy (Mamba2's
# projections split only there); rwkv6-3b cut to 4 layers trained under
# megatron (the wkv on 20 of its 40 heads a rank), one client cut at
# SPMD_TP_CUT, SPMD_TP_STEPS rounds of TRAIN_B x RWKV_T tokens
SPMD_DEEPSEEK_LAYERS, SPMD_ZAMBA_LAYERS, SPMD_RWKV_LAYERS = 4, 6, 4
# the rwkv6 train leg's loss limit against the fused engine on one rank,
# from its own readings (PERF.md section 5, NVIDIA H100 80GB HBM3, 700 W):
# the sound session 5.845e-3 and the bf16 control (the one-rank session on
# the plain versions against the kernels) 1.044e-2 over 3 rounds (losses
# ~11.4-11.9 at the published vocab, each round's mean over 12 rows); the
# planted fault (the output norm's sum of squares left per rank) 1.660e-1
# over 3 rounds and 1.139e-1 in the one round it now runs.  The limit
# sits ~5 x above the control and ~2 x below the fault
TOL_SPMD_RWKV_TP_LOSS = 5e-2
# the family serving legs against the one-rank session
# (``parity.session_parity``): a row-parallel product in bf16 rounds each
# rank's partial sum to bf16 and then their sum, where one rank rounds the
# whole sum once, so a logit may move by up to two bf16 steps; a stream may
# part where the request alone has its top-2 logits at most that far apart
# (TIE_GAP_BF16 and the default of one step encode a single rounding)
SPMD_TP_TIE_STEPS = 2


def phase_spmd(state):
    """The spmd engine over ranks (``spmd_rank`` on each): the full-width
    ResNet-18 paper loop of phase fused (12 clients, the Table-I splits,
    fp32, TF32 off, cuDNN's deterministic algorithms) with (a) the cohort
    lanes over 2 ranks and (b) each lane's batch over the ranks under
    recipe greedy (FSDP over "data", the BatchNorm statistics summed over
    the batch ranks), then the glm4-9b bf16 smoke through
    BackboneSplitModel with its lanes over 2 ranks; the launch counts are
    zeroed before these runs and read after, on each rank.  Then, on rank
    0, the fused engine on the same card from the same states, and the
    comparisons: losses per round and final trainables at phase fused's
    limits (TOL_PAPER_LOSS, TOL_PAPER_PARAMS) for a leg without a data
    split, at TOL_SPMD_DATA_* for one with, after the same data leg in
    float64 has read 1 % of the fp32 gaps or less; the bf16 lane limits for
    the backbone (TOL_LOSS_BF16 on the losses, TOL_GRAD_BF16 on the
    trainables' drift); and two planted faults the ResNet comparison must
    reject: Eq. (1)'s partial sums left unsummed over the lanes group, and
    BatchNorm statistics left per rank.  Then serving over the ranks
    (``spmd_serve_legs``), a MoE model's data split (``spmd_moe_leg``)
    and tensor parallelism over "model" in serving and in the spmd
    engine (``spmd_tp_legs``; the MoE, MLA, RWKV6 and Mamba2 families in
    ``spmd_family_legs``).  A rank that fails fails the phase."""
    from repro_torch.launch.hostdevices import HostRanks
    print(f"spmd card: {card_line()}; this process holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"({torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved)")
    runs = [("gloo", 2)]
    cards = torch.cuda.device_count()
    if cards >= 2:
        runs.append(("nccl", cards))
    else:
        print("spmd: one card: NCCL with more than one rank is not run")
    out = {}
    for backend, n in runs:
        t0 = time.perf_counter()
        got = HostRanks(n, spmd_rank, (backend,), backend=backend,
                        timeout=900).wait()
        for line in got[0][0].splitlines():
            print(f"  [rank 0] {line}")
        for r, (log, res) in enumerate(got[1:], start=1):
            print(f"  [rank {r}] launches "
                  + ", ".join(f"{k} {v}" for k, v in res["launches"].items()
                              if v))
        res = got[0][1]
        res["wall_s"] = time.perf_counter() - t0
        res["ranks"] = [r for _, r in got]
        out[backend] = res
        launches = state.setdefault("launches", {})
        for _, r in got:
            for k, v in r["launches"].items():
                if k in KERNELS:
                    launches[k] = launches.get(k, 0) + v
        print(f"spmd {backend}: {n} ranks in {res['wall_s']:.1f} s")
    state["spmd"] = out


def spmd_rank(backend: str) -> dict:
    """One rank of phase spmd (run by ``launch.hostdevices``).  Every
    reading is printed before any comparison is checked."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.api import TrainSession
    from repro_torch.config import (HeteroProfile, OptimizerConfig,
                                    SplitEEConfig)
    from repro_torch.configs import resnet18_cifar
    from repro_torch.core.splitee import ResNetSplitModel
    from repro_torch.data.pipeline import ClientPartitioner
    from repro_torch.data.synthetic import SyntheticImageDataset
    from repro_torch.kernels.entropy_exit import entropy_exit
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parity import (LANE_ROUNDS, TOL_GRAD_BF16,
                                    TOL_LOSS_BF16, TOL_PAPER_LOSS,
                                    TOL_PAPER_PARAMS, backbone_session,
                                    paper_drift, unreduced_lanes,
                                    unsynced_batch_stats)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # cuDNN's deterministic algorithms: a comparison then reads the same
    # gap on every run (under the default ones the fused engine against
    # itself drifts at ~2e-5, PERF.md section 6)
    torch.backends.cudnn.deterministic = True
    rank, world = dist.get_rank(), dist.get_world_size()
    cards = world if backend == "nccl" else 1
    print(f"spmd: backend={backend} ranks={world} cards={cards} "
          f"(rank {rank} on {torch.cuda.get_device_name()})")
    probe = {}
    for name, op in (
            ("all_reduce", lambda t: dist.all_reduce(t)),
            ("all_gather", lambda t: dist.all_gather(
                [torch.empty_like(t) for _ in range(world)], t)),
            ("broadcast", lambda t: dist.broadcast(t, 0)),
            ("all_to_all_single", lambda t: dist.all_to_all_single(
                torch.empty_like(t), t))):
        try:
            op(torch.ones(4, device="cuda"))
            torch.cuda.synchronize()
            probe[name] = "ok"
        except RuntimeError as e:
            probe[name] = f"refused ({str(e).splitlines()[0][:100]})"
    print(f"spmd: {backend} collectives on CUDA tensors: " + ", ".join(
        f"{k} {v}" for k, v in probe.items()))
    cfg = resnet18_cifar.config("cifar10")
    splits = resnet18_cifar.HETERO_SPLITS
    ds = SyntheticImageDataset(num_classes=10, image_size=32,
                               train_size=FULL_TRAIN, test_size=FULL_TEST,
                               seed=0)
    data = ClientPartitioner(len(splits)).split(*ds.train)
    images = len(splits) * FULL_BATCH

    def session(engine, state=None, dtype=torch.float32, **kw):
        wide = dtype == torch.float64
        return TrainSession(
            ResNetSplitModel(dataclasses.replace(cfg, dtype=dtype),
                             device="cuda"),
            SplitEEConfig(profile=HeteroProfile(splits)),
            OptimizerConfig(lr=FULL_LR, total_steps=SPMD_ROUNDS + 1,
                            state_dtype=dtype),
            [(x.astype(np.float64), y) for x, y in data] if wide else data,
            FULL_BATCH, engine=engine, augment=ds.augment,
            state=None if state is None else state.clone(), **kw)

    def rounds(sess):
        """SPMD_ROUNDS rounds one at a time: (history, ms per round)."""
        hist, ms = [], []
        for _ in range(SPMD_ROUNDS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            hist += sess.train(1)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return hist, ms

    # lanes over 2 ranks (a "model" axis takes the rest), the batch over all
    legs = {"lanes": lambda: make_host_mesh((2, 1, world // 2), SPMD_LDM),
            "data": lambda: make_host_mesh((1, world, 1), SPMD_LDM)}
    counted = (entropy_exit, flash_attention, flash_attention_bwd_dkv,
               flash_attention_bwd_dq)
    start = session("fused").state.clone()
    # ---- the main path: every count at 0, read after
    zero_counts(*counted)
    res = {}
    for leg, mesh in legs.items():
        sess = session("spmd", start, mesh=mesh(), recipe="greedy")
        hist, ms = rounds(sess)
        ad = sess.evaluate_adaptive(*ds.test, 1.0)
        # the whole state on every rank (collective): rank 0 compares it
        res[leg] = dict(state=sess.state.whole(), hist=hist, ms=ms,
                        engine=sess.engine_name, dp=sess.engine._dp,
                        gathered=sess.engine.last_gathered_bytes_per_step,
                        planned=sess.engine.planned_gathered_bytes_per_step(),
                        acc=float(np.mean(ad["acc"])))
        print(f"spmd ResNet {leg} ({sess.engine_name}, {sess.engine._dp} "
              f"batch ranks): losses " + ", ".join(
                  f"{m.client_loss:.4f}/{m.server_loss:.4f}" for m in hist)
              + f"; ms per round " + ", ".join(f"{m:.1f}" for m in ms)
              + f" ({images / ms[-1] * 1e3:,.0f} images/s in the last); "
              f"bytes gathered per cohort step on this rank "
              f"{res[leg]['gathered']:,.0f} (the gather plan predicts "
              f"{res[leg]['planned']:,.0f}); mean adaptive acc "
              f"{res[leg]['acc']:.4f} at tau 1")
        del sess
    bb = backbone_session("glm4_9b", "auto", "cuda", engine="spmd",
                          mesh=legs["lanes"]())
    bb_start = bb.state.clone()
    bb_hist = bb.train(LANE_ROUNDS)
    bb_state = bb.state.whole()
    counts = {k: n for w in counted for k, n in launch_counts(w).items()}
    print("spmd: launches on this rank's main path: " + ", ".join(
        f"{k} {n}" for k, n in counts.items() if n))
    # ---- comparisons (every rank runs the spmd sides; not counted)
    faults = {}
    for leg, fault, what in (
            ("lanes", unreduced_lanes,
             "Eq. (1)'s partial sums not summed over the lanes group"),
            ("data", unsynced_batch_stats, "BatchNorm statistics per rank")):
        sess = session("spmd", start, mesh=legs[leg](), recipe="greedy")
        with fault():
            hist, _ = rounds(sess)
        faults[leg] = (what, sess.state.whole(), hist, sess.engine._dp)
        del sess
    start64 = session("fused", dtype=torch.float64).state.clone()
    s64 = session("spmd", start64, dtype=torch.float64, mesh=legs["data"](),
                  recipe="greedy")
    h64, ms64 = rounds(s64)
    s64_state = s64.state.whole()
    out = {"launches": counts, "rank": rank, "probe": probe}
    dist.barrier()
    if rank == 0:
        checks = []
        fused = session("fused", start)
        f_hist, f_ms = rounds(fused)
        print(f"fused ResNet on the same card: ms per round "
              + ", ".join(f"{m:.1f}" for m in f_ms))
        out["fused_ms"] = f_ms

        def compare(what, st, hist, ref, ref_hist, ref_start):
            dl = max(max(abs(a.client_loss - b.client_loss),
                         abs(a.server_loss - b.server_loss))
                     for a, b in zip(hist, ref_hist))
            d = paper_drift(st, ref.state, ref_start)
            print(f"  reading spmd {what} vs fused: max|dloss| {dl:.3e}; "
                  f"drift clients {d['clients']:.3e} servers "
                  f"{d['servers']:.3e}; BN max|d| clients "
                  f"{d['clients_bn']:.3e} servers {d['servers_bn']:.3e}")
            return dl, max(d["clients"], d["servers"]), d

        def limits(dp):
            return ((TOL_SPMD_DATA_LOSS, TOL_SPMD_DATA_PARAMS) if dp > 1
                    else (TOL_PAPER_LOSS, TOL_PAPER_PARAMS))

        for leg, r in res.items():
            dl, dd, d = compare(f"ResNet {leg}", r["state"], r["hist"], fused,
                                f_hist, start)
            tl, tp = limits(r["dp"])
            checks.append((r["engine"] == "spmd" and dl <= tl and dd <= tp,
                           f"spmd ResNet {leg} ({r['engine']}) = fused: "
                           f"losses {dl:.2e} <= {tl:g}, drift {dd:.2e} <= "
                           f"{tp:g}"))
            checks.append((r["planned"] == r["gathered"],
                           f"spmd ResNet {leg}: the gather plan "
                           f"(launch/meshcomm.unshard_plan) predicts the "
                           f"bytes gathered per step, {r['planned']:,.0f} "
                           f"= {r['gathered']:,.0f}"))
            out[leg] = dict(ms=r["ms"], gathered=r["gathered"],
                            planned=r["planned"], dloss=dl, drift=d,
                            dp=r["dp"])
        # the same data leg in float64: two orders of magnitude closer shows
        # the fp32 gap is rounding
        dl32, dd32 = out["data"]["dloss"], max(out["data"]["drift"]["clients"],
                                               out["data"]["drift"]["servers"])
        fused64 = session("fused", start64, dtype=torch.float64)
        f64_hist, _ = rounds(fused64)
        dl, dd, d = compare("float64 ResNet data", s64_state, h64, fused64,
                            f64_hist, start64)
        print(f"spmd float64 ResNet data: ms per round "
              + ", ".join(f"{m:.1f}" for m in ms64))
        checks.append((dl <= dl32 * TOL_SPMD_F64_RATIO
                       and dd <= dd32 * TOL_SPMD_F64_RATIO,
                       f"spmd float64 ResNet data = fused, the fp32 gap is "
                       f"rounding: losses {dl:.2e}, drift {dd:.2e}, each <= "
                       f"{TOL_SPMD_F64_RATIO:g} x fp32's ({dl32:.2e}, "
                       f"{dd32:.2e})"))
        out["f64"] = dict(dloss=dl, drift=d, ms=ms64)
        del fused64
        for leg, (what, st, hist, dp) in faults.items():
            dl, dd, d = compare(f"planted fault ({what})", st, hist, fused,
                                f_hist, start)
            tl, tp = limits(dp)
            checks.append((dl > tl or dd > tp,
                           f"spmd planted fault rejected: {what} (losses "
                           f"{dl:.2e}, drift {dd:.2e})"))
            out[f"fault_{leg}"] = dict(dloss=dl, drift=d)
        plain = backbone_session("glm4_9b", "auto", "cuda",
                                 state=bb_start.clone())
        p_hist = plain.train(LANE_ROUNDS)
        dl = max(max(abs(a.client_loss - b.client_loss),
                     abs(a.server_loss - b.server_loss))
                 for a, b in zip(bb_hist, p_hist))
        d = paper_drift(bb_state, plain.state, bb_start)
        print(f"  reading spmd glm4-9b bf16 smoke lanes vs fused: max|dloss| "
              f"{dl:.3e}; drift clients {d['clients']:.3e} servers "
              f"{d['servers']:.3e}")
        checks.append((dl <= TOL_LOSS_BF16["glm4_9b"]
                       and max(d["clients"], d["servers"]) <= TOL_GRAD_BF16,
                       f"spmd glm4-9b bf16 smoke under lanes = fused: losses "
                       f"{dl:.2e} <= {TOL_LOSS_BF16['glm4_9b']:g}, drift <= "
                       f"{TOL_GRAD_BF16:g}"))
        out["backbone"] = dict(dloss=dl, drift=d)
        for ok, msg in checks:
            print(("  ok    " if ok else "  FAIL  ") + msg, flush=True)
        bad = [msg for ok, msg in checks if not ok]
    dist.barrier()
    check(all(counts[k] > 0 for k in ("flash_attention_tile",
                                      "flash_attention_bwd_dkv",
                                      "flash_attention_bwd_dq",
                                      "entropy_exit")),
          f"spmd rank {rank}: the attention forward, dK/dV and dQ kernels "
          f"and the gate launched")
    if rank == 0:
        check(not bad, f"spmd comparisons: {len(bad)} failed")
        del fused, plain
    # the legs below run at published widths: this leg's states go first
    del res, faults, s64, s64_state, start64, start, bb, bb_state, bb_start
    gc.collect()
    torch.cuda.empty_cache()
    out["serve"] = spmd_serve_legs(rank, world, counts)
    out["moe"] = spmd_moe_leg(rank, world, counts)
    out["moe_block"] = spmd_moe_block_leg(rank, world)
    out["moe_serve"] = spmd_serve_experts_leg(rank, world, counts)
    out["tp"] = spmd_tp_legs(rank, world, counts)
    t0 = time.perf_counter()
    out["family"] = spmd_family_legs(rank, world, counts)
    print(f"spmd family legs: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def spmd_serve_legs(rank: int, world: int, counts: dict) -> dict:
    """Serving over the ranks: ``ServeSession(mesh=, recipe="greedy")`` on
    glm4-9b at its published widths cut to SPMD_SERVE_LAYERS layers by
    phase main's rule (exits after N/4, N/2, 3N/4), bf16, on the kernels,
    over a data mesh (the slots over the ranks, the weights FSDP over
    "data") and a model mesh (the weights over "model", their products
    tensor-parallel under greedy's placement, every layer's decode ring
    split along its sequence: each rank attends over its part and the
    parts are combined by their LSEs), each under the select (tau
    2.0) and the sticky policy (tau 12.5 > ln V: every token exits,
    client-only ticks run).  The launch counts are zeroed before the four
    runs and read after: on every rank the decode route launches once a
    layer a full tick (the client's layers on a client-only tick) and the
    gate once a tick.  Each rank prints ms a tick, bytes gathered a tick,
    its peak device memory and its pinned host memory (gloo stages each
    CUDA tensor through it).  Then, on rank 0, the one-rank ServeSession
    on the same card (timed the same way) and each request served alone
    (``sequential_reference`` on the kernels): every rank's streams equal,
    and the streams of the one-rank and of the multi-rank sessions each
    held to the references at the bf16 limits of repro_torch/parity.py;
    the planted fault, each rank's part of the ring taken as the whole
    (``parity.uncombined_parts``), must part from them."""
    import torch.distributed as dist

    from repro_torch.api.serve_session import (ServeResult, ServeSession,
                                               sequential_reference,
                                               sequential_sticky_reference)
    from repro_torch.configs import glm4_9b
    from repro_torch.kernels.entropy_exit import entropy_exit
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.e2e_train import cut_depth
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.attention import ShardedRing
    from repro_torch.models.backbone import init_backbone
    from repro_torch.parity import (TIE_GAP_BF16, TOL_H_BF16, stream_parity,
                                    uncombined_parts)
    cfg, _ = cut_depth(glm4_9b.config(), SPMD_SERVE_LAYERS)
    cut = sorted(cfg.exit_layers)[0]

    def weights():
        # drawn anew for each session (the same seed), so that a rank
        # holds only its shards while the sessions over the ranks run
        return init_backbone(torch.Generator(device="cuda").manual_seed(0),
                             cfg)

    def pinned_gib():
        stats = getattr(torch.cuda.memory, "host_memory_stats", None)
        if stats is None:
            return float("nan")
        return stats().get("allocated_bytes.current", float("nan")) / 2**30

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(16, 129)))
               for _ in range(SPMD_SERVE_REQUESTS)]
    meshes = {"data": (world, 1), "model": (world // 2, 2)}
    taus = {"select": 2.0, "sticky": 12.5}
    warm = ServeSession(cfg, weights(), tau=2.0, slots=SPMD_SERVE_SLOTS,
                        max_len=SPMD_SERVE_MAX_LEN)
    warm.submit(prompts[0][:16], decode_tokens=2)
    warm.run()
    del warm

    def serve(policy, mesh=None, fault=contextlib.nullcontext):
        sess = ServeSession(
            cfg, weights(), tau=taus[policy], slots=SPMD_SERVE_SLOTS,
            max_len=SPMD_SERVE_MAX_LEN, exit_policy=policy, recipe="greedy",
            mesh=None if mesh is None else make_host_mesh(
                meshes[mesh], ("data", "model")))
        for p in prompts:
            sess.submit(p, decode_tokens=SPMD_SERVE_DECODE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = (flash_attention.decode_launches, entropy_exit.launches)
        with fault():
            done = sess.run()
        torch.cuda.synchronize()
        st = sess.stats
        rings = 0
        if sess.placement is not None:
            cache, _ = sess.placement.working_cache()
            rings = sum(isinstance(layer["mixer"], ShardedRing)
                        for seg in cache for layer in seg)
            del cache
        reading = dict(
            ms_per_tick=(st.wall_s - st.prefill_s) / st.decode_ticks * 1e3,
            gathered_per_tick=st.gathered_bytes_per_tick,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            pinned_gib=pinned_gib(), ticks=st.decode_ticks,
            client_only=st.client_only_ticks,
            decode=flash_attention.decode_launches - before[0],
            gate=entropy_exit.launches - before[1], split_rings=rings)
        streams = {r.rid: (r.tokens, r.exited, r.entropy) for r in done}
        del sess
        return streams, reading

    # ---- the main path: every count at 0, read after
    zero_counts(flash_attention, entropy_exit)
    runs, readings = {}, {}
    for mesh in meshes:
        for policy in taus:
            runs[mesh, policy], r = serve(policy, mesh)
            readings[f"{mesh}/{policy}"] = r
            want = (cfg.num_layers * (r["ticks"] - r["client_only"])
                    + cut * r["client_only"])
            print(f"spmd serve glm4-9b {cfg.num_layers} layers {mesh} mesh "
                  f"{meshes[mesh]} {policy} (rank {rank}): "
                  f"{r['ms_per_tick']:.3f} ms a tick over {r['ticks']} ticks"
                  f" ({r['client_only']} client-only), "
                  f"{r['gathered_per_tick']:,.0f} bytes gathered a tick, "
                  f"peak {r['peak_gib']:.2f} GiB, pinned host "
                  f"{r['pinned_gib']:.2f} GiB, rings split on "
                  f"{r['split_rings']} of {cfg.num_layers} layers, launches: "
                  f"decode route {r['decode']}, gate {r['gate']}", flush=True)
            check(r["decode"] == want and r["gate"] == r["ticks"] > 0,
                  f"spmd serve {mesh} {policy} rank {rank}: the decode route "
                  f"launched {r['decode']} = {want} times (a layer a full "
                  f"tick, the client's a client-only tick), the gate once a "
                  f"tick")
            if mesh == "model":
                check(r["split_rings"] == cfg.num_layers,
                      f"spmd serve model {policy}: every layer's ring split "
                      f"along its sequence")
    main = {k: c for w in (flash_attention, entropy_exit)
            for k, c in launch_counts(w).items()}
    for k, c in main.items():
        counts[k] = counts.get(k, 0) + c
    fault, _ = serve("select", "model", uncombined_parts)
    every = [None] * world
    dist.all_gather_object(every, {"runs": runs, "fault": fault})
    if rank == 0:
        checks = []

        def as_res(st):
            return {i: ServeResult(i, None, tokens=t, exited=e, entropy=h)
                    for i, (t, e, h) in st.items()}

        params = weights()
        alone = {policy: [
            (sequential_sticky_reference if policy == "sticky"
             else sequential_reference)(
                cfg, params, p, SPMD_SERVE_DECODE, tau=taus[policy],
                max_len=SPMD_SERVE_MAX_LEN) for p in prompts]
            for policy in taus}
        del params
        one = {}
        for policy in taus:
            one[policy], r = serve(policy)
            readings[f"one rank/{policy}"] = r
            print(f"spmd serve glm4-9b {cfg.num_layers} layers one-rank "
                  f"{policy} on the same card: {r['ms_per_tick']:.3f} ms a "
                  f"tick over {r['ticks']} ticks, peak {r['peak_gib']:.2f} "
                  f"GiB", flush=True)
            sp = stream_parity(as_res(one[policy]), alone[policy],
                               taus[policy])
            print(f"  reading spmd serve one-rank {policy} vs each request "
                  f"alone: compared {sp.compared}, max|dH| {sp.max_dh:.3e},"
                  f" parted {sp.parted}")
            checks.append((sp.ok and sp.max_dh <= TOL_H_BF16,
                           f"spmd serve one-rank {policy}: streams within "
                           f"the bf16 limits"))
        for mesh in meshes:
            for policy in taus:
                got = every[0]["runs"][mesh, policy]
                same = all(e["runs"][mesh, policy] == got for e in every)
                sp = stream_parity(as_res(got), alone[policy], taus[policy])
                agree = sum(a == b for rid in got
                            for a, b in zip(got[rid][0], one[policy][rid][0]))
                print(f"  reading spmd serve {mesh} {policy} vs each request"
                      f" alone: compared {sp.compared}, max|dH| "
                      f"{sp.max_dh:.3e}, parted {sp.parted}; {agree} tokens "
                      f"equal to the one-rank session's")
                checks.append((same and sp.ok and sp.max_dh <= TOL_H_BF16,
                               f"spmd serve {mesh} {policy}: every rank "
                               f"holds the same streams, within the bf16 "
                               f"limits (tie gap {TIE_GAP_BF16:g}, |dH| "
                               f"{TOL_H_BF16:g})"))
        verdicts = []
        for r, e in enumerate(every):
            sp = stream_parity(as_res(e["fault"]), alone["select"], 2.0)
            verdicts.append(sp.ok and sp.max_dh <= TOL_H_BF16)
            print(f"  reading spmd serve planted fault (each rank's part of "
                  f"the ring as the whole) rank {r}: max|dH| "
                  f"{sp.max_dh:.3e}, parted {sp.parted}")
        checks.append((not all(verdicts),
                       "spmd serve planted fault rejected: the parts of the "
                       "ring not combined"))
        for ok, msg in checks:
            print(("  ok    " if ok else "  FAIL  ") + msg, flush=True)
        check(all(ok for ok, _ in checks), "spmd serve comparisons")
    dist.barrier()
    torch.cuda.empty_cache()
    return {"readings": readings}


def spmd_moe_leg(rank: int, world: int, counts: dict) -> dict:
    """A data split of a MoE model: the qwen3-moe bf16 smoke through
    BackboneSplitModel (two lanes at cut 2) on the kernels, its batch over
    the ranks (``models/moe.py`` routes the whole batch: capacity from the
    global N, expert loads summed over the batch ranks) and its experts
    too (E / ranks a rank, none of their weights gathered, the dispatch
    and combine an exchange over the ranks), LANE_ROUNDS rounds
    replaying the routing of the one-rank fused engine's run on the same
    card (``parity.pinned_routes``), against that run: the losses within
    TOL_SPMD_MOE_LOSS, as the bf16 control's (the one-rank run on the
    plain versions) must be, and each planted fault's beyond it (entries
    at their local slots, ``parity.local_slots``; the expert gradients
    all-reduced over the ranks, ``parity.reduced_expert_grads``), the
    drift within TOL_GRAD_BF16; the launch counts are zeroed before the
    split run and read after (the attention forward, dK/dV and dQ on
    every rank).  The aux
    loss's weight (1e-3) leaves the loads' effect on a round's loss inside
    bf16 rounding, so the split's routing is also held at the block: one
    forward of the smoke with capacity factor SPMD_MOE_TIGHT (experts drop
    entries) on this rank's rows and experts under the batch group and
    the expert group against the whole batch on one rank, routes pinned:
    logits and aux loss within
    TOL_GRAD_BF16 of their norms.  The planted fault, each rank's expert
    loads left unsummed (``parity.unsummed_expert_loads``), must miss
    there."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import qwen3_moe_235b_a22b
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from repro_torch.launch import tensor_parallel as tp
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import is_expert_stack, map_with_path
    from repro_torch.models.backbone import backbone_forward, init_backbone
    from repro_torch.models.sync_stats import synced_batch_stats
    from repro_torch.parity import (LANE_ROUNDS, LANE_SEQ, TOL_GRAD_BF16,
                                    Routes, backbone_session, local_slots,
                                    paper_drift, pinned_routes,
                                    reduced_expert_grads,
                                    unsummed_expert_loads)
    fam = "qwen3_moe_235b_a22b"
    routes = Routes()
    fused = backbone_session(fam, "auto", "cuda")
    start = fused.state.clone()
    with pinned_routes(routes, replay=False):
        f_hist = fused.train(LANE_ROUNDS)
    mesh = make_host_mesh((world, 1), ("data", "model"))

    def run(kernels="auto", fault=contextlib.nullcontext, **kw):
        """The session from the same start, routes replayed: (session,
        max |dloss| against the one-rank fused run)."""
        s = backbone_session(fam, kernels, "cuda", state=start.clone(), **kw)
        with pinned_routes(routes, replay=True), fault():
            hist = s.train(LANE_ROUNDS)
        return s, max(max(abs(a.client_loss - b.client_loss),
                          abs(a.server_loss - b.server_loss))
                      for a, b in zip(hist, f_hist))

    attn = (flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq)
    zero_counts(*attn)
    sess, dl = run(engine="spmd", mesh=mesh)
    main = {k: n for w in attn for k, n in launch_counts(w).items()}
    for k, n in main.items():
        counts[k] = counts.get(k, 0) + n
    d = paper_drift(sess.state.whole(), fused.state, start)
    dd = max(d["clients"], d["servers"])
    eng = sess.engine
    E = sess.model.cfg.moe.num_experts
    experts = eng.experts_per_rank
    expert_gathered = eng.planned_gathered_bytes_per_step(experts=True)
    gathered, planned = (eng.last_gathered_bytes_per_step,
                         eng.planned_gathered_bytes_per_step())
    exchanged = eng.last_exchange_bytes_per_step
    print(f"spmd moe qwen3 bf16 smoke, batch over {world} ranks (rank "
          f"{rank}, {sess.engine_name}): vs the one-rank fused run (pinned, "
          f"{routes.flipped} of {routes.tokens} choices replayed against "
          f"their own) max|dloss| {dl:.3e}, drift {dd:.3e}; {experts} of {E} "
          f"experts a rank, expert weights gathered {expert_gathered:,.0f} "
          f"B a step (all weights {gathered:,.0f}, planned {planned:,.0f}), "
          f"exchanged {exchanged:,.0f} B a step; launches "
          + ", ".join(f"{k} {n}" for k, n in main.items() if n), flush=True)
    check(experts == E // world and expert_gathered == 0 and exchanged > 0
          and gathered == planned,
          f"spmd moe rank {rank}: {experts} = {E} / {world} experts a rank, "
          f"0 bytes of expert weights gathered ({expert_gathered:,.0f} of "
          f"the plan, which the step gathered: {gathered:,.0f} B), "
          f"{exchanged:,.0f} bytes exchanged a step")
    check(all(main[k] > 0 for k in ("flash_attention_tile",
                                    "flash_attention_bwd_dkv",
                                    "flash_attention_bwd_dq")),
          f"spmd moe rank {rank}: the attention forward, dK/dV and dQ "
          f"kernels launched")
    spmd = sess.engine_name == "spmd"
    del sess
    dc = run("ref")[1]
    faults = {"local slots": run(engine="spmd", mesh=mesh,
                                 fault=local_slots)[1],
              "expert gradients all-reduced": run(
                  engine="spmd", mesh=mesh, fault=reduced_expert_grads)[1]}
    lim = TOL_SPMD_MOE_LOSS
    print(f"  reading spmd moe qwen3 bf16 session vs the one-rank fused run "
          f"(rank {rank}): max|dloss| split {dl:.3e}, bf16 control (plain "
          f"versions) {dc:.3e}, planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items()),
          flush=True)
    check(spmd and dl <= lim and dc <= lim and dd <= TOL_GRAD_BF16,
          f"spmd moe qwen3 bf16 data split = one-rank fused: losses "
          f"{dl:.2e} <= {lim:g} (the bf16 control {dc:.2e}), drift "
          f"{dd:.2e} <= {TOL_GRAD_BF16:g}")
    check(min(faults.values()) > lim,
          f"spmd moe planted faults rejected: "
          + ", ".join(f"{k} {v:.2e}" for k, v in faults.items())
          + f" > {lim:g}")
    del fused

    # the block: one forward, the batch over the ranks against one rank
    smoke = qwen3_moe_235b_a22b.smoke_bf16()
    cfg = smoke.with_(moe=dataclasses.replace(
        smoke.moe, capacity_factor=SPMD_MOE_TIGHT))
    params = init_backbone(torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2 * world * 4, LANE_SEQ)), device="cuda")
    n = tokens.shape[0] // world
    mine = slice(rank * n, (rank + 1) * n)
    block = Routes()
    with torch.no_grad(), pinned_routes(block, replay=False):
        whole = backbone_forward(params, cfg, tokens=tokens)
    ep = tp.ExpertGroup(dist.group.WORLD, world, rank,
                        cfg.moe.num_experts // world)
    own = map_with_path(lambda p, t: tp.own_slice(t, ep, 0)
                        if is_expert_stack(cfg, p) else t, params)

    def split(fault=contextlib.nullcontext):
        with torch.no_grad(), pinned_routes(block, replay=True), \
                synced_batch_stats(dist.group.WORLD, world, rank), \
                tp.expert_parallel(ep), fault():
            part = backbone_forward(own, cfg, tokens=tokens[mine])
        want = whole.logits[mine].float()
        return (float((part.logits.float() - want).norm() / want.norm()),
                float((part.aux_loss - whole.aux_loss).abs()
                      / whole.aux_loss.abs()))

    gl, ga = split()
    sent = ep.bytes["all_to_all"]
    fl, fa = split(unsummed_expert_loads)
    print(f"  reading spmd moe block, capacity factor {SPMD_MOE_TIGHT}, "
          f"rows and experts over {world} ranks ({sent:,.0f} B exchanged) "
          f"vs one rank (rank {rank}): logits "
          f"{gl:.3e}, aux loss {ga:.3e} (relative); planted fault (expert "
          f"loads per rank): logits {fl:.3e}, aux loss {fa:.3e}", flush=True)
    check(gl <= TOL_GRAD_BF16 and ga <= TOL_GRAD_BF16,
          f"spmd moe block split = one rank: logits {gl:.2e}, aux loss "
          f"{ga:.2e} <= {TOL_GRAD_BF16:g}")
    check(fl > TOL_GRAD_BF16 or fa > TOL_GRAD_BF16,
          f"spmd moe planted fault rejected: expert loads per rank "
          f"(logits {fl:.2e}, aux loss {fa:.2e})")
    del params, own, whole
    torch.cuda.empty_cache()
    return {"dloss": dl, "drift": d, "block": (gl, ga),
            "block_fault": (fl, fa), "flipped": routes.flipped,
            "tokens": routes.tokens, "experts": experts,
            "expert_gathered": expert_gathered, "exchanged": exchanged,
            "control": dc, "faults": faults}


def spmd_moe_block_leg(rank: int, world: int) -> dict:
    """Expert parallelism at published widths: one qwen3-moe-235b-a22b MoE
    block (d 4096, 128 experts top 8, d_expert 1536, capacity factor
    1.25; bf16 experts, fp32 router), forward and backward on world x
    SPMD_MOE_BLOCK_ROWS x SPMD_MOE_BLOCK_SEQ tokens, the rows over the
    ranks and each rank's E / world experts alone (the dispatch and
    combine an exchange over the ranks, ``models/moe.py``), against the
    same block whole on one rank with routes pinned: the output, the
    router's gradient (averaged over the ranks, as the spmd engine
    averages it) and each rank's expert-weight gradients (its chunk of
    the whole block's) within TOL_GRAD_BF16 of their norms.  The loss is
    each rank's mean of its rows' outputs against a seeded cotangent plus
    the aux loss, the engine's convention.  Prints the ms of a forward
    and backward split and on one rank (the other rank idle; its first
    pass, which loads cuBLAS's kernels and grows the allocator, apart),
    the peak a rank and the bytes exchanged."""
    import torch.distributed as dist

    from repro_torch.configs import qwen3_moe_235b_a22b
    from repro_torch.launch import tensor_parallel as tp
    from repro_torch.models.moe import init_moe, moe_forward
    from repro_torch.models.sync_stats import synced_batch_stats
    from repro_torch.parity import TOL_GRAD_BF16, Routes, pinned_routes
    cfg = qwen3_moe_235b_a22b.config()
    m = cfg.moe
    B, T, d = world * SPMD_MOE_BLOCK_ROWS, SPMD_MOE_BLOCK_SEQ, cfg.d_model
    params = init_moe(cfg, torch.Generator(device="cuda").manual_seed(0),
                      "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(B, T, d, generator=gen, device="cuda").to(cfg.dtype)
    cot = torch.randn(B, T, d, generator=gen, device="cuda")
    names = ("router", "w_gate", "w_up", "w_down")

    def step(p, xs, cs):
        """Forward and backward: (output, gradients of ``names``)."""
        p = {k: v.detach().requires_grad_() for k, v in p.items()}
        out, aux = moe_forward(p, xs, cfg)
        loss = (out.float() * cs).sum() / (xs.shape[0] * T) + aux
        return out.detach(), torch.autograd.grad(loss, [p[k] for k in names])

    def timed(fn, n):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3 / n

    # the whole block on one rank at a time (the other waits), its routes
    # recorded for the split run
    routes = Routes()
    one_ms = cold_ms = None
    for r in range(world):
        torch.cuda.synchronize()         # nothing of this rank's left queued
        dist.barrier()
        if r == rank:
            t0 = time.perf_counter()
            with pinned_routes(routes, replay=False):
                whole, wgrads = step(params, x, cot)
            torch.cuda.synchronize()
            cold_ms = (time.perf_counter() - t0) * 1e3
            step(params, x, cot)                         # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SPMD_MOE_BLOCK_ITERS):
                step(params, x, cot)
            torch.cuda.synchronize()
            one_ms = (time.perf_counter() - t0) * 1e3 / SPMD_MOE_BLOCK_ITERS
    n = B // world
    rows = slice(rank * n, (rank + 1) * n)
    E_loc = m.num_experts // world
    ep = tp.ExpertGroup(dist.group.WORLD, world, rank, E_loc)
    own = {k: (tp.own_slice(v, ep, 0) if k != "router" else v)
           for k, v in params.items()}

    def split():
        with pinned_routes(routes, replay=True), \
                synced_batch_stats(dist.group.WORLD, world, rank), \
                tp.expert_parallel(ep):
            return step(own, x[rows], cot[rows])

    split()                                              # warm
    ep.bytes["all_to_all"] = 0.0
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (out, grads), split_ms = timed(split, SPMD_MOE_BLOCK_ITERS)
    peak = torch.cuda.max_memory_allocated()
    exchanged = ep.bytes["all_to_all"] / SPMD_MOE_BLOCK_ITERS
    router = grads[0].clone()
    dist.all_reduce(router)
    router /= world
    got = {"router": router, **{k: g / world
                                for k, g in zip(names[1:], grads[1:])}}
    want = {"router": wgrads[0], **{k: tp.own_slice(g, ep, 0) for k, g in
                                    zip(names[1:], wgrads[1:])}}

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    gaps = {"output": rel(out, whole[rows]),
            **{k: rel(got[k], want[k]) for k in names}}
    print(f"  reading spmd moe block qwen3-moe-235b-a22b at published "
          f"widths ({B} x {T} tokens, {E_loc} of {m.num_experts} experts a "
          f"rank, rank {rank}; {routes.flipped} of {routes.tokens} choices "
          f"replayed against their own): relative "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + f"; forward and backward {split_ms:.1f} ms over {world} ranks "
          f"against {one_ms:.1f} ms on one rank (its first pass "
          f"{cold_ms:.1f} ms); peak "
          f"{peak / 2**30:.2f} GiB a rank ({held / 2**30:.2f} GiB held "
          f"before the pass, the whole block's reference included); "
          f"exchanged {exchanged:,.0f} B a pass on {card_line()}",
          flush=True)
    check(own["w_gate"].shape[0] == E_loc == m.num_experts // world,
          f"spmd moe block rank {rank}: {E_loc} experts a rank")
    check(max(gaps.values()) <= TOL_GRAD_BF16,
          f"spmd moe block split = one rank: output and gradients within "
          f"{TOL_GRAD_BF16:g} ({max(gaps.values()):.2e})")
    del params, own, x, cot, whole, wgrads, out, grads, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return {"gaps": gaps, "split_ms": split_ms, "one_ms": one_ms,
            "one_cold_ms": cold_ms,
            "peak": peak, "held": held, "exchanged": exchanged,
            "experts": E_loc}


def spmd_serve_experts_leg(rank: int, world: int, counts: dict) -> dict:
    """Serving with the experts kept over the batch ranks
    (``RankPlacement.ep``): qwen3-moe-235b-a22b at its published widths
    cut to SPMD_EXPERT_LAYERS layers by phase main's rule (exits 2, 4, 6),
    bf16, on the kernels, over the data mesh (world, 1) under
    SPMD_EXPERT_RECIPE (the expert stacks E over "data", 64 of 128 a
    rank; the other weights whole on each rank: nothing is gathered a
    tick), 8 slots, 8 requests of 16-128 tokens, SPMD_TP_DECODE decode
    tokens, select (tau 2.0) and sticky (tau 12.5).  The weights are
    ``lazy_weights``: each leaf drawn on the card where it is placed (two
    ranks' whole trees, 46.0 GB each by their shapes, do not fit it).
    The launch counts are zeroed before the two runs and read after.
    Each rank prints ms a
    tick, the experts it holds and their bytes, the expert bytes a tick
    gathers (0), the exchange's bytes a decode tick and of the
    admissions, and its peak.  Then the select requests again, each entry
    sent to the owner of the next chunk (``parity.misrouted_entries``).
    Then, on rank 0, after every rank has let go of its chunks:
    ``tp_serve_checks`` (the one-rank session and each request served
    alone, the bf16 limits; the fault must part)."""
    import torch.distributed as dist

    from repro_torch.configs import qwen3_moe_235b_a22b
    from repro_torch.kernels.entropy_exit import entropy_exit
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.e2e_train import cut_depth
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parity import misrouted_entries
    cfg, _ = cut_depth(qwen3_moe_235b_a22b.config(), SPMD_EXPERT_LAYERS)
    mesh = make_host_mesh((world, 1), ("data", "model"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(16, 129)))
               for _ in range(SPMD_SERVE_REQUESTS)]
    taus = {"select": 2.0, "sticky": 12.5}
    faults = {"misrouted entries": misrouted_entries}
    t0 = time.perf_counter()
    # ---- the main path: every count at 0, read after
    zero_counts(flash_attention, entropy_exit)
    runs, readings = {}, {}
    for policy, tau in taus.items():
        runs[policy], r, _ = tp_serve_run(
            cfg, lazy_weights(cfg), prompts, policy, tau, mesh=mesh,
            recipe=SPMD_EXPERT_RECIPE)
        readings[policy] = r
        print(f"spmd serve experts {cfg.name} {cfg.num_layers} layers "
              f"data mesh ({world}, 1) {SPMD_EXPERT_RECIPE} {policy} (rank "
              f"{rank}): {r['ms_per_tick']:.3f} ms a tick over "
              f"{r['ticks']} ticks ({r['client_only']} client-only), "
              f"{r['experts']} of {cfg.moe.num_experts} experts a stack "
              f"({r['expert_bytes']:,} B of expert weights, "
              f"{r['held_bytes']:,} B in all), expert bytes gathered a "
              f"tick {r['expert_gathers']:,}, weights gathered a tick "
              f"{r['weights_per_tick']:,.0f}, exchange a decode tick "
              f"{r['exchange_decode_per_tick']:,.0f} B, admissions "
              f"{r['exchange_prefill']:,.0f} B, peak {r['peak_gib']:.2f} "
              f"GiB", flush=True)
        check(r["experts"] == r["stack_experts"][0]
              == cfg.moe.num_experts // world and r["expert_gathers"] == 0
              and r["exchange_decode_per_tick"] > 0,
              f"spmd serve experts {policy} rank {rank}: "
              f"{cfg.moe.num_experts // world} experts a rank kept, none "
              f"gathered, the entries exchanged")
    main = {k: c for w in (flash_attention, entropy_exit)
            for k, c in launch_counts(w).items()}
    for k, c in main.items():
        counts[k] = counts.get(k, 0) + c
    check(main.get("entropy_exit", 0) > 0
          and main.get("flash_attention", 0) > 0,
          f"spmd serve experts rank {rank}: the gate and the decode route "
          f"launched ({main})")
    # the select requests served again under the planted fault (untimed)
    faulted = tp_serve_run(cfg, lazy_weights(cfg), prompts, "select",
                           taus["select"], mesh=mesh,
                           recipe=SPMD_EXPERT_RECIPE, faults=faults)[2]
    every = [None] * world
    dist.all_gather_object(every, {"runs": runs, "faults": faulted})
    dist.barrier()
    out = {"readings": readings, "launches": main}
    if rank == 0:
        checks = []
        tp_serve_checks(cfg, lazy_weights(cfg), prompts, taus, every,
                        readings, checks, faults=tuple(faults))
        for ok, msg in checks:
            print(("  ok    " if ok else "  FAIL  ") + msg, flush=True)
        check(all(ok for ok, _ in checks), "spmd serve experts comparisons")
    dist.barrier()
    torch.cuda.empty_cache()
    print(f"spmd serve experts leg: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def spmd_tp_legs(rank: int, world: int, counts: dict) -> dict:
    """Tensor parallelism over "model" (``launch/tensor_parallel.py``):
    glm4-9b at its published widths cut to SPMD_SERVE_LAYERS layers, bf16,
    on the kernels, recipe megatron, on the model mesh (world / 2, 2):
    every rank multiplies with its chunk of attention's and the SwiGLU's
    weights, of the embedding and of the heads split over the vocab.  The
    launch counts are zeroed before the sessions below and read after.
    Serving (``ServeSession(mesh=, recipe=)``): 8 slots, 8 requests
    (16-128 tokens), SPMD_TP_DECODE decode tokens, select (tau 2.0) and
    sticky (tau 12.5); each rank prints ms a tick, the bytes of weights
    gathered a tick, the tensor-parallel bytes of a decode tick and of the
    admissions, and its peak memory.  Training (``TrainSession`` on the
    spmd engine over the same mesh): one client cut at SPMD_TP_CUT (the
    model's one exit there), SPMD_TP_STEPS rounds of SPMD_TP_BATCH x
    ``parity.TRAIN_SEQ`` tokens with labels over the whole vocab (so
    every rank owns some), Adam with bf16 moments, in two ``train``
    calls, the second from the first's chunks; each rank prints the
    bytes of the state it holds, the dry run's reckoning of them and its
    peak memory against the 38.25 GiB a rank that kept the whole state
    beside its chunks (PERF.md section 5, run R2, NVIDIA H100 80GB HBM3,
    700 W).  Then the same session for one
    round under each planted fault (a row-parallel product's partial sum
    taken as the whole; the cross entropy's sum of exponentials left per
    rank), and for two rounds whose second run's carry is re-cut with
    this rank's chunk index off by one (``parity.shifted_chunks``).
    Then, on rank 0: the one-rank serving session (timed the same way)
    and each request served alone on the kernels, the streams within the
    bf16 limits of repro_torch/parity.py; the same training session on
    the fused engine on one rank from the same seed, and on the plain
    versions (the bf16 control: two sound one-rank runs).  The losses of
    the tensor-parallel session and of the control must lie within
    TOL_SPMD_TP_LOSS of the fused engine's, each planted fault beyond
    it."""
    import torch.distributed as dist

    from repro_torch import parity
    from repro_torch.api.serve_session import (ServeResult,
                                               sequential_reference,
                                               sequential_sticky_reference)
    from repro_torch.configs import glm4_9b
    from repro_torch.data.pipeline import ClientPartitioner
    from repro_torch.data.synthetic import SyntheticSeqClsDataset
    from repro_torch.kernels.entropy_exit import entropy_exit
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from repro_torch.launch.e2e_train import cut_depth
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.backbone import init_backbone
    from repro_torch.parity import (TIE_GAP_BF16, TOL_H_BF16,
                                    per_rank_sumexp, shifted_chunks,
                                    stream_parity, unreduced_row_products)
    cfg, _ = cut_depth(glm4_9b.config(), SPMD_SERVE_LAYERS)
    shape = (world // 2, 2)
    mesh = make_host_mesh(shape, ("data", "model"))

    def weights():
        return init_backbone(torch.Generator(device="cuda").manual_seed(0),
                             cfg)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(16, 129)))
               for _ in range(SPMD_SERVE_REQUESTS)]
    taus = {"select": 2.0, "sticky": 12.5}
    wrappers = (flash_attention, flash_attention_bwd_dkv,
                flash_attention_bwd_dq, entropy_exit)

    def serve(policy, over_ranks=True):
        return tp_serve_run(cfg, weights(), prompts, policy, taus[policy],
                            mesh=mesh if over_ranks else None,
                            recipe="megatron")[:2]

    tcfg = cfg.with_(exit_layers=(SPMD_TP_CUT,))
    ds = SyntheticSeqClsDataset(
        vocab_size=cfg.vocab_size, seq_len=parity.TRAIN_SEQ,
        num_classes=cfg.vocab_size,
        train_size=SPMD_TP_BATCH * SPMD_TP_STEPS, test_size=8, seed=0)
    data = ClientPartitioner(1).split(*ds.train)

    def train(engine="spmd", kernels="auto", fault=contextlib.nullcontext,
              steps=SPMD_TP_STEPS, **kw):
        """``steps`` rounds: (client and server losses a round, the
        engine's readings)."""
        return tp_train_run(tcfg, data, engine=engine, kernels=kernels,
                            mesh=mesh, recipe="megatron",
                            batch=SPMD_TP_BATCH, steps=steps, fault=fault,
                            **kw)

    # ---- the main path: every count at 0, read after
    zero_counts(*wrappers)
    runs, readings = {}, {}
    for policy in taus:
        runs[policy], r = serve(policy)
        readings[policy] = r
        print(f"spmd tp serve glm4-9b {cfg.num_layers} layers megatron mesh "
              f"{shape} {policy} (rank {rank}): {r['ms_per_tick']:.3f} ms a "
              f"tick over {r['ticks']} ticks ({r['client_only']} "
              f"client-only), weights gathered a tick "
              f"{r['weights_per_tick']:,.0f} bytes, tensor-parallel bytes "
              f"a decode tick {r['tp_decode_per_tick']:,.0f}, admissions "
              f"{r['tp_prefill']:,.0f}, peak {r['peak_gib']:.2f} GiB; "
              f"roles {r['roles']}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    # two train calls: the second starts from the first's chunks
    losses, tr = train(runs=(1, SPMD_TP_STEPS - 1))
    main = {k: n for w in wrappers for k, n in launch_counts(w).items()}
    for k, n in main.items():
        counts[k] = counts.get(k, 0) + n
    print(f"spmd tp train glm4-9b {cfg.num_layers} layers megatron mesh "
          f"{shape} ({tr['engine']} engine, rank {rank}): "
          f"{tr['ms_per_round']:.1f} ms a round, tensor-parallel bytes a "
          f"step {tr['tp_per_step']:,.0f}, weights gathered a step "
          f"{tr['gathered_per_step']:,.0f}, peak {tr['peak_gib']:.2f} GiB; "
          f"launches " + ", ".join(f"{k} {n}" for k, n in main.items() if n),
          flush=True)
    print(f"spmd tp train state (rank {rank}): state_bytes "
          f"{tr['state_bytes']:,} after {SPMD_TP_STEPS} rounds in two "
          f"runs; chunk_shapes and the dry run reckon "
          f"{tr['reckoned_bytes']:,} (the whole state {tr['whole_bytes']:,}"
          f"); peak {tr['peak_gib']:.2f} GiB against 38.25 GiB a rank with "
          f"the whole state kept beside the chunks (PERF.md section 5, run "
          f"R2, NVIDIA H100 80GB HBM3, 700 W)", flush=True)
    check(tr["state_bytes"] == tr["reckoned_bytes"] < tr["whole_bytes"],
          f"spmd tp rank {rank}: the rank holds its chunks of the state, "
          f"{tr['state_bytes']:,} B as reckoned")
    check(tr["engine"] == "spmd" and all(
              main[k] > 0 for k in ("flash_attention", "flash_attention_tile",
                                    "flash_attention_bwd_dkv",
                                    "flash_attention_bwd_dq",
                                    "entropy_exit")),
          f"spmd tp rank {rank}: the spmd engine trained; the decode and "
          f"tile routes, dK/dV, dQ and the gate launched")
    # a fault moves the forward, so its first round shows it; the
    # shifted chunks, the second run's
    faults = {name: train(fault=f, steps=1)[0] for name, f in (
        ("row", unreduced_row_products), ("sumexp", per_rank_sumexp))}
    faults["shifted chunks"] = train(fault=shifted_chunks, steps=2,
                                     runs=(1, 1), fault_from=1)[0]
    every = [None] * world
    dist.all_gather_object(every, {"runs": runs, "losses": losses,
                                   "faults": faults})
    out = {"readings": readings, "train": tr, "launches": main}
    dist.barrier()
    if rank == 0:
        checks = []

        def as_res(st):
            return {i: ServeResult(i, None, tokens=t, exited=e, entropy=h)
                    for i, (t, e, h) in st.items()}

        params = weights()
        alone = {policy: [
            (sequential_sticky_reference if policy == "sticky"
             else sequential_reference)(
                cfg, params, p, SPMD_TP_DECODE, tau=taus[policy],
                max_len=SPMD_SERVE_MAX_LEN) for p in prompts]
            for policy in taus}
        del params
        for policy in taus:
            one, r = serve(policy, over_ranks=False)
            readings[f"one rank/{policy}"] = r
            got = every[0]["runs"][policy]
            same = all(e["runs"][policy] == got for e in every)
            sp = stream_parity(as_res(got), alone[policy], taus[policy])
            agree = sum(a == b for rid in got
                        for a, b in zip(got[rid][0], one[rid][0]))
            print(f"  reading spmd tp serve {policy}: one-rank session "
                  f"{r['ms_per_tick']:.3f} ms a tick (tensor-parallel "
                  f"{readings[policy]['ms_per_tick']:.3f}); vs each request "
                  f"alone: compared {sp.compared}, max|dH| {sp.max_dh:.3e}, "
                  f"parted {sp.parted}; {agree} tokens equal to the "
                  f"one-rank session's", flush=True)
            checks.append((same and sp.ok and sp.max_dh <= TOL_H_BF16,
                           f"spmd tp serve {policy}: every rank holds the "
                           f"same streams, within the bf16 limits (tie gap "
                           f"{TIE_GAP_BF16:g}, |dH| {TOL_H_BF16:g})"))
        checks.append((all(readings[p]["weights_per_tick"] == 0
                           for p in taus) and all(
                           readings[p]["tp_decode_per_tick"] < 10e6
                           for p in taus),
                       "spmd tp serve: no weight gathered a tick, under "
                       "10 MB of tensor-parallel collectives a decode tick"))
        gc.collect()
        torch.cuda.empty_cache()
        want, one_tr = train("fused")
        ctl, _ = train("fused", kernels="ref")
        lim = TOL_SPMD_TP_LOSS

        def gap(a):
            return np.abs(a - want[:len(a)]).max(1)

        gaps = np.max([gap(e["losses"]) for e in every], 0)
        dl, dc = float(gaps.max()), float(gap(ctl).max())
        print(f"  reading spmd tp train: fused engine on one rank "
              f"{one_tr['ms_per_round']:.1f} ms a round, peak "
              f"{one_tr['peak_gib']:.2f} GiB (tensor-parallel "
              f"{tr['ms_per_round']:.1f}); losses max|d| {dl:.3e}, by "
              f"round " + ", ".join(f"{g:.3e}" for g in gaps)
              + f" (losses {want.min():.3f}..{want.max():.3f}); bf16 "
              f"control (one rank, plain versions) max|d| {dc:.3e}, by "
              f"round " + ", ".join(f"{g:.3e}" for g in gap(ctl)),
              flush=True)
        checks.append((dl <= lim, f"spmd tp train {SPMD_TP_STEPS} rounds "
                       f"= the fused engine on one rank: losses {dl:.2e} "
                       f"<= {lim:g}"))
        checks.append((dc <= lim, f"spmd tp train: the bf16 control lies "
                       f"within the limit ({dc:.2e} <= {lim:g})"))
        for name in faults:
            df = max(float(gap(e["faults"][name]).max()) for e in every)
            print(f"  reading spmd tp planted fault ({name}): losses max|d| "
                  f"{df:.3e}", flush=True)
            checks.append((df > lim, f"spmd tp planted fault rejected: "
                           f"{name} ({df:.2e} > {lim:g})"))
        out["train_one"] = one_tr
        out["dloss"], out["dloss_control"] = dl, dc
        for ok, msg in checks:
            print(("  ok    " if ok else "  FAIL  ") + msg, flush=True)
        check(all(ok for ok, _ in checks), "spmd tp comparisons")
    dist.barrier()
    torch.cuda.empty_cache()
    return out


class LazyLeaf:
    """A weight of ``shape`` drawn where it is moved to (``.to(device)``)
    from a generator of its own seeded with ``seed``: truncated normal of
    ``std`` as ``models.common.trunc_normal`` draws it, or ones (a norm
    scale).  A tree of them stands for a model whose whole tree two ranks
    sharing the card cannot each hold: ``ServeSession(mesh=)`` cuts each
    leaf to this rank's chunk as it draws it (one whole leaf at a time),
    and every draw of a leaf gives the same values."""

    def __init__(self, shape, dtype, std, seed: int):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.std, self.seed = std, seed

    def to(self, device):
        from repro_torch.models.common import trunc_normal
        if self.std is None:
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        gen = torch.Generator(device=device).manual_seed(self.seed)
        return trunc_normal(tuple(self.shape), self.std, self.dtype, gen,
                            device)


def lazy_weights(cfg, seed: int = 0) -> dict:
    """``cfg``'s weight tree as :class:`LazyLeaf` s: the shapes, dtypes and
    standard deviations ``init_backbone`` gives (read on the meta device),
    each leaf seeded by ``seed`` and its place in the tree.  For families
    whose every leaf is drawn or a norm scale (not RWKV6's or Mamba2's
    constant leaves)."""
    from repro_torch.launch.inputs import abstract_params
    from repro_torch.launch.shardings import map_with_path
    from repro_torch.models import common
    stds, real = {}, common.trunc_normal

    def record(shape, std, dtype, generator, device):
        t = real(shape, std, dtype, generator, device)
        stds[id(t)] = std
        return t
    common.trunc_normal = record
    try:
        meta = abstract_params(cfg)
    finally:
        common.trunc_normal = real
    count = iter(range(1 << 30))

    def lazy(path, t):
        std = stds.get(id(t))
        if std is None and path[-1] != "scale":
            raise ValueError(f"{path}: neither drawn nor a norm scale")
        return LazyLeaf(t.shape, t.dtype, std, seed * 1_000_003 + next(count))
    return map_with_path(lazy, meta)


def tp_serve_run(cfg, params, prompts, policy, tau, *, mesh, recipe,
                 faults=None):
    """``ServeSession`` of ``cfg`` over ``mesh`` under ``recipe`` (or one
    rank: ``mesh`` None), 8 slots, SPMD_TP_DECODE decode tokens a request:
    ``(streams, readings, fault streams)``, readings of ms a tick, weights
    gathered a tick, tensor-parallel bytes a decode tick and of the
    admissions, peak GiB and roles; then the same requests served again
    by the same session under each planted fault of ``faults`` (``{name:
    context}``), untimed."""
    from repro_torch.api.serve_session import ServeSession
    from repro_torch.launch.shardings import tree_paths
    sess = ServeSession(cfg, params, tau=tau, slots=SPMD_SERVE_SLOTS,
                        max_len=SPMD_SERVE_MAX_LEN, exit_policy=policy,
                        recipe=recipe, mesh=mesh)
    kinds = {}
    if mesh is not None:
        for _, r in tree_paths(sess.placement.roles):
            kinds[r.kind] = kinds.get(r.kind, 0) + 1
    rids = [sess.submit(p, decode_tokens=SPMD_TP_DECODE) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    done = sess.run()
    torch.cuda.synchronize()
    st = sess.stats
    pl = sess.placement
    tp_kinds = dict(pl.tp.bytes) if (
        mesh is not None and pl.tp is not None) else {}
    reading = dict(
        ms_per_tick=(st.wall_s - st.prefill_s) / st.decode_ticks * 1e3,
        weights_per_tick=st.weight_gathered_bytes_per_tick,
        tp_decode_per_tick=st.tp_decode_bytes_per_tick,
        tp_prefill=st.tp_prefill_bytes, tp_by_kind=tp_kinds,
        exchange_decode_per_tick=st.exchange_decode_bytes_per_tick,
        exchange_prefill=st.exchange_prefill_bytes,
        ticks=st.decode_ticks, client_only=st.client_only_ticks,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30, roles=kinds)
    if mesh is not None and pl.ep is not None:
        # the expert stacks this rank holds, and what a tick gathers of them
        from repro_torch.launch.meshcomm import plan_bytes, unshard_plan
        from repro_torch.launch.shardings import (is_expert_stack,
                                                  map_with_path)
        experts = map_with_path(
            lambda p, t: t if is_expert_stack(cfg, p) else None, pl.params)
        reading.update(
            experts=pl.ep.experts,
            stack_experts=sorted({t.shape[0] for _, t in
                                  tree_paths(experts)}),
            expert_bytes=sum(t.numel() * t.element_size()
                             for _, t in tree_paths(experts)),
            expert_gathers=plan_bytes(unshard_plan(
                experts, pl.compute_specs, pl.comm.sizes, lead=0)),
            held_bytes=sum(t.numel() * t.element_size()
                           for _, t in tree_paths(pl.params)))
        del experts
    del pl

    def streams(results, rids):
        """The requests ``rids`` (``run`` returns every finished one) by
        their submission order."""
        by_rid = {r.rid: r for r in results}
        return {i: (by_rid[rid].tokens, by_rid[rid].exited,
                    by_rid[rid].entropy) for i, rid in enumerate(rids)}
    faulted = {}
    for name, fault in (faults or {}).items():
        again = [sess.submit(p, decode_tokens=SPMD_TP_DECODE)
                 for p in prompts]
        with fault():
            faulted[name] = streams(sess.run(), again)
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    return streams(done, rids), reading, faulted


def tp_serve_checks(cfg, host, prompts, taus, every, readings, checks,
                    faults=()) -> None:
    """Rank 0, after the ranks let go of their sessions: the one-rank
    session on the same weights (timed the same way) and each request
    served alone, both on the kernels.  Every rank's streams must equal
    the one-rank session's within the bf16 limits of
    ``repro_torch/parity.py`` (``parity.session_parity``: a token parts
    only at a near tie, where the request alone has a top-2 gap below
    TIE_GAP_BF16 or of SPMD_TP_TIE_STEPS bf16 steps, or where it and the
    one-rank session already choose differently; entropies within
    TOL_H_BF16); each planted fault's streams (served under select) must
    part beyond them."""
    from repro_torch.api.serve_session import (ServeResult,
                                               sequential_reference,
                                               sequential_sticky_reference)
    from repro_torch.parity import (TIE_GAP_BF16, TOL_H_BF16,
                                    session_parity, stream_parity)
    from repro_torch.tree import tree_map
    params = tree_map(lambda t: t.to("cuda"), host)

    def as_res(st):
        return {i: ServeResult(i, None, tokens=t, exited=e, entropy=h)
                for i, (t, e, h) in st.items()}

    for policy, tau in taus.items():
        alone = [(sequential_sticky_reference if policy == "sticky"
                  else sequential_reference)(
                      cfg, params, p, SPMD_TP_DECODE, tau=tau,
                      max_len=SPMD_SERVE_MAX_LEN) for p in prompts]
        one, r, _ = tp_serve_run(cfg, params, prompts, policy, tau,
                                 mesh=None, recipe=None)
        readings[f"one rank/{policy}"] = r
        got = every[0]["runs"][policy]
        same = all(e["runs"][policy] == got for e in every)
        sp = session_parity(as_res(got), as_res(one), alone, tau,
                            tie_steps=SPMD_TP_TIE_STEPS)
        sp1 = stream_parity(as_res(one), alone, tau)
        agree = sum(a == b for rid in got
                    for a, b in zip(got[rid][0], one[rid][0]))
        print(f"  reading spmd tp serve {cfg.name} {policy}: one-rank "
              f"session {r['ms_per_tick']:.3f} ms a tick (tensor-parallel "
              f"{readings[policy]['ms_per_tick']:.3f}), peak "
              f"{r['peak_gib']:.2f} GiB; vs the one-rank session: compared "
              f"{sp.compared}, max|dH| {sp.max_dh:.3e}, parted {sp.parted}; "
              f"{agree} tokens equal to the one-rank session's; the "
              f"one-rank session vs each request alone: compared "
              f"{sp1.compared}, max|dH| {sp1.max_dh:.3e}, parted "
              f"{sp1.parted}", flush=True)
        checks.append((same and sp.ok and sp.max_dh <= TOL_H_BF16,
                       f"spmd tp serve {cfg.name} {policy}: every rank "
                       f"holds the same streams, the one-rank session's "
                       f"within the bf16 limits (tie gap {TIE_GAP_BF16:g} "
                       f"or {SPMD_TP_TIE_STEPS} bf16 steps, |dH| "
                       f"{TOL_H_BF16:g})"))
        for name in faults if policy == "select" else ():
            fp = session_parity(as_res(every[0]["faults"][name]),
                                as_res(one), alone, tau,
                                tie_steps=SPMD_TP_TIE_STEPS)
            print(f"  reading spmd tp serve {cfg.name} planted fault "
                  f"({name}): compared {fp.compared}, max|dH| "
                  f"{fp.max_dh:.3e}, parted {fp.parted}", flush=True)
            checks.append((not (fp.ok and fp.max_dh <= TOL_H_BF16),
                           f"spmd tp serve {cfg.name} planted fault "
                           f"rejected: {name}"))
    del params
    gc.collect()
    torch.cuda.empty_cache()


def tp_train_run(cfg, data, *, engine="spmd", kernels="auto", mesh=None,
                 recipe=None, batch, steps, fault=contextlib.nullcontext,
                 runs=None, fault_from: int = 0):
    """``TrainSession`` of ``BackboneSplitModel`` on ``cfg`` (one client
    at its one exit), ``steps`` rounds in ``train`` calls of ``runs``
    rounds each (default one call), Adam with bf16 moments: ``(client and
    server losses a round, readings)``; ``fault`` is active from call
    ``fault_from`` on.  The spmd engine's readings add the bytes of the
    state a rank holds after the rounds (``state_bytes``) beside the dry
    run's reckoning of its chunks and of the whole state
    (``launch.dryrun.session_state_bytes``).  RWKV6's decays and bonus
    stay at their init (``parity.live_rwkv``'s draws at published widths
    take the plain chunked wkv, the control, past fp32's range)."""
    from repro_torch import parity
    from repro_torch.api import TrainSession
    from repro_torch.config import (HeteroProfile, OptimizerConfig,
                                    SplitEEConfig)
    from repro_torch.core.backbone_splitee import BackboneSplitModel
    from repro_torch.launch.dryrun import session_state_bytes
    from repro_torch.launch.mesh import MeshSpec
    model = BackboneSplitModel(cfg.with_(kernels=kernels), device="cuda")
    kw = dict(mesh=mesh, recipe=recipe) if engine == "spmd" else {}
    sc = SplitEEConfig(profile=HeteroProfile(cfg.exit_layers),
                       strategy="averaging")
    oc = OptimizerConfig(lr=parity.TRAIN_LR, total_steps=2 * steps,
                         state_dtype=torch.bfloat16)
    sess = TrainSession(model, sc, oc, data, batch, engine=engine, **kw)
    model.full_params = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = []
    for i, n in enumerate(runs or (steps,)):
        with fault() if i >= fault_from else contextlib.nullcontext():
            hist += sess.train(n)
    torch.cuda.synchronize()
    eng = sess.engine
    reading = dict(
        engine=sess.engine_name,
        ms_per_round=(time.perf_counter() - t0) / steps * 1e3,
        tp_per_step=getattr(eng, "last_tp_bytes_per_step", 0.0),
        gathered_per_step=getattr(eng, "last_gathered_bytes_per_step",
                                  0.0),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if engine == "spmd":
        splits = sc.profile.split_layers
        reading.update(
            state_bytes=eng.state_bytes,
            reckoned_bytes=session_state_bytes(model, splits, oc, mesh,
                                               recipe, batch),
            whole_bytes=session_state_bytes(
                model, splits, oc, MeshSpec((1, 1), ("data", "model")),
                recipe, batch))
    losses = np.asarray([[m.client_loss, m.server_loss] for m in hist])
    del sess, model, eng
    gc.collect()
    torch.cuda.empty_cache()
    return losses, reading


def spmd_family_legs(rank: int, world: int, counts: dict) -> dict:
    """Phase spmd's MoE, MLA, RWKV6 and Mamba2 legs over "model" on this
    rank, on the mesh (world / 2, 2), bf16, on the kernels, at published
    widths.  The launch counts are zeroed before the three runs below and
    read after (and added to ``counts``).  deepseek-v3-671b cut to
    SPMD_DEEPSEEK_LAYERS layers served under megatron (select at tau 2.0,
    sticky at 12.5; 8 slots, 8 requests of 16-128 tokens); zamba2-1.2b cut
    to SPMD_ZAMBA_LAYERS layers served under greedy (select); rwkv6-3b cut
    to SPMD_RWKV_LAYERS layers trained under megatron through
    ``TrainSession(engine="spmd")``.  Each rank prints per leg ms a tick
    or a round, the weights gathered, the tensor-parallel bytes by kind,
    its peak and its launches (the wkv's heads a launch).  Then each
    planted fault's run: deepseek's select requests served again by the
    same session with each rank's experts taken as the whole MoE
    (``parity.unsummed_expert_parts``), rwkv6 trained one round with the
    output norm's sum of squares left per rank
    (``parity.per_rank_norm_squares``).  Then, on rank 0, after the ranks
    let go of their sessions: the one-rank serving sessions and each
    request alone (``tp_serve_checks``), and the rwkv6 session on the
    fused engine on one rank from the same seed, on the kernels and on the
    plain versions (the bf16 control); the train losses must lie within
    TOL_SPMD_RWKV_TP_LOSS of the fused engine's, the control within it
    and the fault beyond it."""
    import torch.distributed as dist

    from repro_torch.configs import deepseek_v3_671b, rwkv6_3b, zamba2_1p2b
    from repro_torch.data.pipeline import ClientPartitioner
    from repro_torch.data.synthetic import SyntheticSeqClsDataset
    from repro_torch.kernels import rwkv_wkv as wkv_mod
    from repro_torch.kernels.entropy_exit import entropy_exit
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from repro_torch.kernels.rwkv_wkv import rwkv_wkv, rwkv_wkv_bwd
    from repro_torch.launch.e2e_train import cut_depth
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.backbone import init_backbone
    from repro_torch.parity import (per_rank_norm_squares,
                                    unsummed_expert_parts)
    from repro_torch.tree import tree_leaves
    shape = (world // 2, 2)
    mesh = make_host_mesh(shape, ("data", "model"))
    wrappers = (flash_attention, flash_attention_bwd_dkv,
                flash_attention_bwd_dq, entropy_exit, rwkv_wkv, rwkv_wkv_bwd)
    taus = {"select": 2.0, "sticky": 12.5}
    # the wkv's heads a launch, read off its kernel calls (a monitor, not
    # a count)
    heads = {}

    real_kernels = {name: getattr(wkv_mod, name)
                    for name in ("_kernel_fwd", "_kernel_bwd")}

    def watch(name, real):
        def seen(r, *a, **kw):
            heads.setdefault(name, set()).add(r.shape[2])
            return real(r, *a, **kw)
        setattr(wkv_mod, name, seen)
    for name, real in real_kernels.items():
        watch(name, real)

    def report(what, r):
        print(f"spmd tp {what} (rank {rank}): "
              + (f"{r['ms_per_tick']:.3f} ms a tick over {r['ticks']} "
                 f"ticks, weights gathered a tick "
                 f"{r['weights_per_tick']:,.0f} bytes, tensor-parallel "
                 f"bytes a decode tick {r['tp_decode_per_tick']:,.0f}, "
                 f"admissions {r['tp_prefill']:,.0f}, by kind "
                 f"{r['tp_by_kind']}, roles {r['roles']}"
                 if "ms_per_tick" in r else
                 f"{r['ms_per_round']:.1f} ms a round, tensor-parallel "
                 f"bytes a step {r['tp_per_step']:,.0f}, weights gathered "
                 f"a step {r['gathered_per_step']:,.0f}")
              + f", peak {r['peak_gib']:.2f} GiB", flush=True)

    rng = np.random.default_rng(0)
    ds_cfg, _ = cut_depth(deepseek_v3_671b.config(), SPMD_DEEPSEEK_LAYERS)
    ds_prompts = [rng.integers(0, ds_cfg.vocab_size,
                               int(rng.integers(16, 129)))
                  for _ in range(SPMD_SERVE_REQUESTS)]
    zb_cfg, _ = cut_depth(zamba2_1p2b.config(), SPMD_ZAMBA_LAYERS)
    zb_prompts = [rng.integers(0, zb_cfg.vocab_size,
                               int(rng.integers(16, 129)))
                  for _ in range(SPMD_SERVE_REQUESTS)]
    rw_cfg = cut_depth(rwkv6_3b.config(), SPMD_RWKV_LAYERS)[0].with_(
        exit_layers=(SPMD_TP_CUT,))
    ds = SyntheticSeqClsDataset(
        vocab_size=rw_cfg.vocab_size, seq_len=RWKV_T,
        num_classes=rw_cfg.vocab_size, train_size=TRAIN_B * SPMD_TP_STEPS,
        test_size=8, seed=0)
    rw_data = ClientPartitioner(1).split(*ds.train)
    # deepseek-v3's weights are drawn leaf by leaf as each session places
    # them (two whole trees do not fit beside the ranks' chunks); zamba2's
    # are drawn whole on each rank
    ds_host = lazy_weights(ds_cfg)
    zb_host = init_backbone(torch.Generator(device="cuda").manual_seed(0),
                            zb_cfg)
    ds_bytes = sum(t.shape.numel() * t.dtype.itemsize
                   for t in tree_leaves(ds_host))
    print(f"spmd tp weights (rank {rank}): {ds_cfg.name} "
          f"{ds_bytes / 1e9:.2f} GB (drawn leaf by leaf), {zb_cfg.name} "
          f"{weight_bytes(zb_host) / 1e9:.2f} GB", flush=True)

    # ---- the main path: every count at 0, read after
    zero_counts(*wrappers)
    runs, readings = {"deepseek": {}, "zamba2": {}}, {}
    fault_name, ds_faults = "experts' outputs unsummed", {}
    for policy, tau in taus.items():
        runs["deepseek"][policy], r, faulted = tp_serve_run(
            ds_cfg, ds_host, ds_prompts, policy, tau, mesh=mesh,
            recipe="megatron", faults={fault_name: lambda: uncounted(
                wrappers, unsummed_expert_parts)}
            if policy == "select" else None)
        ds_faults.update(faulted)
        readings[f"deepseek/{policy}"] = r
        report(f"serve {ds_cfg.name} megatron {policy}", r)
    runs["zamba2"]["select"], r, _ = tp_serve_run(
        zb_cfg, zb_host, zb_prompts, "select", taus["select"], mesh=mesh,
        recipe="greedy")
    readings["zamba2/select"] = r
    report(f"serve {zb_cfg.name} greedy select", r)
    losses, tr = tp_train_run(rw_cfg, rw_data, mesh=mesh, recipe="megatron",
                              batch=TRAIN_B, steps=SPMD_TP_STEPS)
    readings["rwkv6/train"] = tr
    report(f"train {rw_cfg.name} megatron", tr)
    main = {k: n for w in wrappers for k, n in launch_counts(w).items()}
    for k, n in main.items():
        counts[k] = counts.get(k, 0) + n
    print(f"spmd tp family legs (rank {rank}): launches " + ", ".join(
        f"{k} {n}" for k, n in main.items() if n) + f"; wkv heads a launch "
        f"{ {k: sorted(v) for k, v in heads.items()} }", flush=True)
    check(tr["engine"] == "spmd" and all(
              main[k] > 0 for k in ("rwkv_wkv", "rwkv_wkv_bwd",
                                    "flash_attention", "entropy_exit"))
          and heads.get("_kernel_fwd") == {20}
          and heads.get("_kernel_bwd") == {20},
          f"spmd tp family legs rank {rank}: the spmd engine trained; the "
          f"wkv forward and backward launched on 20 heads a rank, the "
          f"decode route and the gate launched")
    # the fault moves the forward, so its first round shows it
    rw_fault, _ = tp_train_run(rw_cfg, rw_data, mesh=mesh,
                               recipe="megatron", batch=TRAIN_B, steps=1,
                               fault=per_rank_norm_squares)
    for name, real in real_kernels.items():
        setattr(wkv_mod, name, real)
    every = [None] * world
    dist.all_gather_object(every, {"runs": runs, "losses": losses,
                                   "fault": rw_fault,
                                   "ds_fault": ds_faults})
    out = {"readings": readings, "launches": main}
    if rank != 0:
        del ds_host, zb_host
    dist.barrier()
    if rank == 0:
        checks = []
        tp_serve_checks(ds_cfg, ds_host, ds_prompts, taus,
                        [dict(runs=e["runs"]["deepseek"],
                              faults=e["ds_fault"]) for e in every],
                        {p: readings[f"deepseek/{p}"] for p in taus},
                        checks, faults=(fault_name,))
        del ds_host
        tp_serve_checks(zb_cfg, zb_host, zb_prompts,
                        {"select": taus["select"]},
                        [dict(runs=e["runs"]["zamba2"]) for e in every],
                        {"select": readings["zamba2/select"]}, checks)
        del zb_host
        want, one_tr = tp_train_run(rw_cfg, rw_data, engine="fused",
                                    batch=TRAIN_B, steps=SPMD_TP_STEPS)
        ctl, _ = tp_train_run(rw_cfg, rw_data, engine="fused",
                              kernels="ref", batch=TRAIN_B,
                              steps=SPMD_TP_STEPS)
        lim = TOL_SPMD_RWKV_TP_LOSS

        def gap(a):
            return np.abs(a - want[:len(a)]).max(1)

        gaps = np.max([gap(e["losses"]) for e in every], 0)
        dl, dc = float(gaps.max()), float(gap(ctl).max())
        df = max(float(gap(e["fault"]).max()) for e in every)
        print(f"  reading spmd tp train {rw_cfg.name}: fused engine on one "
              f"rank {one_tr['ms_per_round']:.1f} ms a round, peak "
              f"{one_tr['peak_gib']:.2f} GiB (tensor-parallel "
              f"{tr['ms_per_round']:.1f}); losses max|d| {dl:.3e}, by round "
              + ", ".join(f"{g:.3e}" for g in gaps)
              + f" (losses {want.min():.3f}..{want.max():.3f}); bf16 control "
              f"(one rank, plain versions) max|d| {dc:.3e}, by round "
              + ", ".join(f"{g:.3e}" for g in gap(ctl))
              + f"; planted fault (out_norm's sum of squares per rank) "
              f"max|d| {df:.3e}", flush=True)
        checks.append((dl <= lim, f"spmd tp train {rw_cfg.name} "
                       f"{SPMD_TP_STEPS} rounds = the fused engine on one "
                       f"rank: losses {dl:.2e} <= {lim:g}"))
        checks.append((dc <= lim, f"spmd tp train {rw_cfg.name}: the bf16 "
                       f"control lies within the limit ({dc:.2e} <= "
                       f"{lim:g})"))
        checks.append((df > lim, f"spmd tp planted fault rejected: the "
                       f"out_norm's sum of squares per rank ({df:.2e} > "
                       f"{lim:g})"))
        if shape[0] == 1:
            checks.append((all(
                readings[f"deepseek/{p}"]["weights_per_tick"] == 0
                for p in taus), f"spmd tp serve {ds_cfg.name}: no weight "
                "gathered a tick"))
        out["train_one"] = one_tr
        out["dloss"], out["dloss_control"], out["dloss_fault"] = dl, dc, df
        for ok, msg in checks:
            print(("  ok    " if ok else "  FAIL  ") + msg, flush=True)
        check(all(ok for ok, _ in checks), "spmd tp family comparisons")
    dist.barrier()
    torch.cuda.empty_cache()
    return out


def phase_timing(state):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    gen = torch.Generator(device="cuda").manual_seed(1)
    buf = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    rows = []

    # attention at the decode shape: 8 slots, 161-slot ring, per-row
    # prefix; the row route beside it
    q, k, v = attn_inputs(gen, torch.bfloat16, B=8, Tq=1)
    B, H, _, D = q.shape
    Hkv = k.shape[1]
    dec = time_decode(buf, q, k, v, kv_prefix(8, seed=2))
    state["decode_row_ms"] = dec.pop("row_ms")
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:141",
        shape="decode q (8,32,1,128) bf16, kv (8,2,161,128), per-row "
              "kv_valid (decode route)", dtype=torch.bfloat16, **dec))
    # and over a 4096-key cache, every key valid
    q, k, v = attn_inputs(gen, torch.bfloat16, B=8, Tq=1, Tk=LONG_CACHE)
    r = time_decode(buf, q, k, v, torch.full(
        (8,), LONG_CACHE, dtype=torch.int32, device="cuda"))
    r["bound_ms"] = max(r["bytes"] / HBM_BYTES_PER_S,
                        r["ops"] / PEAK_OPS_PER_S[torch.bfloat16]) * 1e3
    state["decode_long_timing"] = r

    # attention at the largest prefill: causal 128 queries over the ring
    q, k, v = attn_inputs(gen, torch.bfloat16, B=1, Tq=128)
    P = q.shape[2]
    n_pairs = P * (P + 1) // 2
    bytes_p = 2 * q.numel() * 2 + 2 * P * Hkv * D * 2
    causal = torch.ones(P, k.shape[2], dtype=torch.bool,
                        device="cuda").tril()
    state["prefill_timing"] = dict(
        ms=time_ms(lambda: flash_attention(q, k, v, causal=True), buf),
        plain_ms=time_ms(lambda: flash_attention_ref(q, k, v, causal=True),
                         buf),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=causal, enable_gqa=True), buf),
        bound_ms=max(bytes_p / HBM_BYTES_PER_S,
                     4 * H * D * n_pairs / PEAK_OPS_PER_S[torch.bfloat16]) * 1e3)

    rows.append(time_gate(gen, buf, state))
    rows.extend(time_backward(gen, buf, state))
    rows.extend(time_wkv(gen, buf, state))
    state["timing"] = rows
    time_zamba(gen, buf, state)
    time_wide_and_cross(gen, buf, state)


def time_wide_and_cross(gen, buf, state) -> None:
    """Attention at paligemma-3b's head dim 256 (GQA 8: H 8, Hkv 1) and at
    whisper-small's cross attention (GQA 1: H = Hkv = 12, D 64,
    non-causal over 1500 source frames), bf16, each beside its plain
    version, SDPA and its bound: paligemma's decode tick of 8 slots over
    the 161-slot ring (decode route), a 128-token prefill (tile route) and
    its train shape's forward with LSE, dK/dV and dQ (tile routes);
    whisper's cross decode tick (decode route) and its train shape
    (tile routes), the operations over the whole 448 x 1500 rectangle."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    out = {}
    pg = dict(H=8, Hkv=1, D=256)
    q, k, v = attn_inputs(gen, torch.bfloat16, B=SLOTS, Tq=1, **pg)
    dec = time_decode(buf, q, k, v, kv_prefix(SLOTS, seed=259))
    dec.pop("row_ms")
    out["flash_attention paligemma"] = dict(
        shape="decode q (8,8,1,256) bf16, kv (8,1,161,256), per-row "
              "kv_valid (decode route)", **dec)
    q, k, v = attn_inputs(gen, torch.bfloat16, B=1, Tq=128, **pg)
    causal = torch.ones(128, MAX_LEN, dtype=torch.bool, device="cuda").tril()
    out["flash_attention_tile paligemma prefill"] = dict(
        shape="prefill q (1,8,128,256) bf16, kv (1,1,161,256), causal "
              "(tile route)",
        ms=time_ms(lambda: flash_attention(q, k, v, causal=True), buf),
        plain_ms=time_ms(lambda: flash_attention_ref(q, k, v, causal=True),
                         buf),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=causal, enable_gqa=True), buf),
        bytes=2 * q.numel() * 2 + 2 * 128 * 256 * 2,
        ops=4 * 8 * 256 * (128 * 129 // 2))
    for name, r in time_causal(gen, buf, PALI_B, PALI_T, 20, with_row=False,
                               **pg).items():
        out[f"{name} paligemma train"] = dict(
            shape=f"train q/dO ({PALI_B},8,{PALI_T},256) bf16, k/v "
                  f"({PALI_B},1,{PALI_T},256), causal (tile route)", **r)
    wx = dict(H=12, Hkv=12, D=64)
    q, k, v = attn_inputs(gen, torch.bfloat16, B=SLOTS, Tq=1,
                          Tk=WHISPER_SRC, **wx)
    out["flash_attention whisper cross"] = dict(
        shape=f"cross decode q (8,12,1,64) bf16, kv (8,12,{WHISPER_SRC},64),"
              f" non-causal (decode route)",
        ms=time_ms(lambda: flash_attention(q, k, v, causal=False), buf),
        plain_ms=time_ms(lambda: flash_attention_ref(q, k, v, causal=False),
                         buf),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                           buf),
        bytes=2 * q.numel() * 2 + 2 * k.numel() * 2,
        ops=4 * SLOTS * 12 * 64 * WHISPER_SRC)
    for name, r in time_causal(gen, buf, TRAIN_B, WHISPER_T, 20,
                               with_row=False, Tk=WHISPER_SRC, causal=False,
                               **wx).items():
        out[f"{name} whisper cross train"] = dict(
            shape=f"cross train q/dO (12,12,{WHISPER_T},64) bf16, k/v "
                  f"(12,12,{WHISPER_SRC},64), non-causal (tile route)", **r)
    for name, r in out.items():
        by_bytes = r["bytes"] / HBM_BYTES_PER_S
        by_ops = r["ops"] / PEAK_OPS_PER_S[torch.bfloat16]
        r["bound_ms"] = max(by_bytes, by_ops) * 1e3
        r["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
        print(f"{name} [{r['shape']}]: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, SDPA"
              f"{' backward' if 'bwd' in name else ''} "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']})")
    state["wide_cross_timing"] = out


def time_zamba(gen, buf, state) -> None:
    """Attention at zamba2-1.2b's shared block, GQA 1 (H = Hkv = 32, D 64,
    bf16), each beside its plain version, SDPA and its bound: a decode
    tick of 8 slots over the 633-slot page (decode route, 1 row of a
    16-row mma tile per (slot, head)), a 600-token prefill over the page
    (tile route), and the train shape (12,32,512,64) forward with LSE,
    dK/dV and dQ (tile routes)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    z = dict(H=32, Hkv=32, D=64)
    out = {}
    q, k, v = attn_inputs(gen, torch.bfloat16, B=SLOTS, Tq=1,
                          Tk=ZAMBA_MAX_LEN, **z)
    dec = time_decode(buf, q, k, v, kv_prefix(SLOTS, ZAMBA_MAX_LEN, seed=65))
    out["flash_attention"] = dict(
        shape=f"decode q (8,32,1,64) bf16, kv (8,32,{ZAMBA_MAX_LEN},64), "
              f"per-row kv_valid (decode route)", **dec)
    P = ZAMBA_PROMPT_MAX
    q, k, v = attn_inputs(gen, torch.bfloat16, B=1, Tq=P, Tk=ZAMBA_MAX_LEN,
                          **z)
    causal = torch.ones(P, ZAMBA_MAX_LEN, dtype=torch.bool,
                        device="cuda").tril()
    n_pairs = P * (P + 1) // 2
    out["flash_attention_tile prefill"] = dict(
        shape=f"prefill q (1,32,{P},64) bf16, kv (1,32,{ZAMBA_MAX_LEN},64), "
              f"causal (tile route)",
        ms=time_ms(lambda: flash_attention(q, k, v, causal=True), buf),
        plain_ms=time_ms(lambda: flash_attention_ref(q, k, v, causal=True),
                         buf),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=causal), buf),
        bytes=2 * q.numel() * 2 + 2 * P * 32 * 64 * 2,
        ops=4 * 32 * 64 * n_pairs)
    train = time_causal(gen, buf, TRAIN_B, ZAMBA_T, 20, with_row=False, **z)
    for name, r in train.items():
        out[name] = dict(shape=f"train q/dO/k/v (12,32,{ZAMBA_T},64) bf16, "
                               f"causal (tile route)", **r)
    for name, r in out.items():
        by_bytes = r["bytes"] / HBM_BYTES_PER_S
        by_ops = r["ops"] / PEAK_OPS_PER_S[torch.bfloat16]
        r["bound_ms"] = max(by_bytes, by_ops) * 1e3
        r["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
        r.pop("row_ms", None)
        print(f"zamba2-1.2b {name} [{r['shape']}]: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, SDPA{' backward' if 'bwd' in name else ''}"
              f" {r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']})")
    state["zamba_timing"] = out


def time_gate(gen, buf, state) -> dict:
    """The gate at glm4-9b's serve shape (8,151552) bf16, the result
    line's row, and beside it rwkv6-3b's (8,65536), zamba2-1.2b's
    (8,32000) and deepseek-v3's (8,129280) bf16, (8,151552) fp32 and the
    paper evaluator's (512,10) and (512,100) fp32; each with the
    plain version, the bound (bytes: the logits and tau read, H and exit
    written; 4 operations a logit) and the launch floor, a one-element
    torch op timed the same way."""
    from repro_torch.kernels.entropy_exit import (entropy_exit, gate_splits,
                                                  sm_count)
    from repro_torch.kernels.ref import entropy_exit_ref
    from repro_torch.parity import gate_logits
    one = torch.zeros(1, device="cuda")
    floor_ms = time_ms(lambda: one.add_(1.0), buf)

    def timed(dtype, V, B=SLOTS):
        x = gate_logits(gen, dtype, B, V)
        tau = torch.full((x.shape[0],), 2.0, device="cuda")
        cs = gate_splits(x.shape[0], V, sm_count(0))
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        return dict(
            shape=f"logits ({B},{V}) {name}, per-row tau, {cs} splits (one "
                  f"cluster of {cs} blocks per row)",
            ms=time_ms(lambda: entropy_exit(x, tau), buf),
            plain_ms=time_ms(lambda: entropy_exit_ref(x, tau), buf),
            bytes=x.numel() * x.element_size() + 3 * 4 * x.shape[0],
            ops=4 * x.numel(), launch_floor_ms=floor_ms)

    main = timed(torch.bfloat16, 151552)
    more = {"rwkv6-3b serve shape": timed(torch.bfloat16, 65536),
            "zamba2-1.2b serve shape": timed(torch.bfloat16, 32000),
            "deepseek-v3 serve shape": timed(torch.bfloat16, 129280),
            "fp32": timed(torch.float32, 151552),
            "evaluator, 10 classes": timed(torch.float32, 10, 512),
            "evaluator, 100 classes": timed(torch.float32, 100, 512)}
    for what, r in {"glm4-9b serve shape": main, **more}.items():
        r["bound_ms"] = max(r["bytes"] / HBM_BYTES_PER_S, r["ops"]
                            / PEAK_OPS_PER_S[torch.float32]) * 1e3
        print(f"entropy_exit {what} [{r['shape']}]: {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"(bytes), launch floor {r['launch_floor_ms']:.4f} ms")
    state["gate_timing"] = more
    return dict(name="entropy_exit", route="cuda",
                source="src/repro_torch/kernels/csrc/entropy_exit.cu",
                replaces="src/repro/kernels/entropy_exit.py:57",
                library_ms=None, dtype=torch.float32, **main)


def time_decode(buf, q, k, v, kv_valid) -> dict:
    """The forward at a decode shape (Tq = 1, per-row kv_valid): the
    decode route, the row route forced, the plain version and SDPA with
    the same key mask, and the work the bound counts: q read and out
    written, the valid K/V prefix read once, 4 D operations per valid key
    and head."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    B, H, _, D = q.shape
    Hkv = k.shape[1]
    n_keys = int(kv_valid.sum())
    mask = (torch.arange(k.shape[2], device="cuda")[None]
            < kv_valid[:, None])[:, None, None, :]
    kw = dict(causal=False, kv_valid=kv_valid)
    return dict(
        ms=time_ms(lambda: flash_attention(q, k, v, **kw), buf),
        row_ms=time_ms(lambda: flash_attention(q, k, v, route="row", **kw),
                       buf),
        plain_ms=time_ms(lambda: flash_attention_ref(q, k, v, **kw), buf),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), buf),
        bytes=2 * q.numel() * 2 + 2 * n_keys * Hkv * D * 2 + B * 4,
        ops=4 * H * D * n_keys)


def time_causal(gen, buf, B, T, reps, with_row, H=32, Hkv=2, D=128,
                Tk=None, causal=True):
    """The tile-route forward with LSE, dK/dV and dQ (delta fused, as the
    training site runs it) at a causal shape (default GQA 16: H=32,
    Hkv=2, D=128; bf16), each beside its plain version, PyTorch's SDPA
    (forward; backward computing dQ, dK and dV in one call) and its bytes
    and band operations; with ``with_row``, dQ's row route too
    (``row_ms``).  ``Tk`` keys (default T) and ``causal`` False time a
    cross-attention shape, whose operations cover the whole T x Tk
    rectangle."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from repro_torch.kernels.ref import (flash_attention_bwd_dkv_ref,
                                         flash_attention_bwd_dq_ref,
                                         flash_attention_ref)
    q, k, v, do = bwd_inputs(gen, torch.bfloat16, B=B, H=H, Hkv=Hkv, T=T,
                             D=D, Tk=Tk)
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    n_pairs = T * (T + 1) // 2 if causal else T * (Tk or T)
    mm = 2 * B * H * n_pairs * D            # one block matmul over the band
    qkv = 2 * (2 * q.numel() + 2 * k.numel())   # q, o or dO, k, v in bf16
    rows_b = 4 * B * H * T                      # one fp32 value per row
    sq, sk, sv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(sq, sk, sv, is_causal=causal,
                                              enable_gqa=True)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
        sdpa_out, (sq, sk, sv), do, retain_graph=True), buf, reps)
    out = {
        "flash_attention_tile": dict(
            ms=time_ms(lambda: flash_attention(q, k, v, causal=causal,
                                               return_lse=True), buf, reps),
            plain_ms=time_ms(lambda: flash_attention_ref(
                q, k, v, causal=causal, return_lse=True), buf, reps),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), buf, reps),
            bytes=qkv + rows_b, ops=2 * mm),
        "flash_attention_bwd_dkv": dict(
            ms=time_ms(lambda: flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, causal=causal), buf, reps),
            plain_ms=time_ms(lambda: flash_attention_bwd_dkv_ref(
                q, k, v, do, lse, delta, causal=causal), buf, reps),
            library_ms=sdpa_bwd_ms,
            bytes=qkv + 2 * rows_b + 2 * 4 * k.numel(), ops=4 * mm)}
    # dQ fused: q, dO, O, k, v and lse read, dq and delta written
    out["flash_attention_bwd_dq"] = dict(
        ms=time_ms(lambda: flash_attention_bwd_dq(
            q, k, v, do, lse, o=o, causal=causal), buf, reps),
        plain_ms=time_ms(lambda: flash_attention_bwd_dq_ref(
            q, k, v, do, lse, (do.float() * o.float()).sum(-1),
            causal=causal), buf, reps),
        library_ms=sdpa_bwd_ms,
        bytes=qkv + 2 * q.numel() + 2 * rows_b + 4 * q.numel(), ops=3 * mm)
    if with_row:
        out["flash_attention_bwd_dq"]["row_ms"] = time_ms(
            lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                           causal=causal, route="row"),
            buf, reps)
    for r in out.values():
        by_bytes = r["bytes"] / HBM_BYTES_PER_S
        by_ops = r["ops"] / PEAK_OPS_PER_S[torch.bfloat16]
        r["bound_ms"] = max(by_bytes, by_ops) * 1e3
        r["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    return out


def time_backward(gen, buf, state):
    """The tile-route forward, dK/dV and dQ at the train shape (B=12,
    H=32, Hkv=2, T=128, D=128, bf16, causal) as result-line rows (dQ's row
    route beside it), and all three at the long shape (B=1, T=2048) for
    their own lines, 10 launches each there."""
    src = "src/repro_torch/kernels/csrc/"
    meta = {
        "flash_attention_tile": ("flash_attention.cu", 141,
                                 ", with lse (tile route)"),
        "flash_attention_bwd_dkv": ("flash_attention_bwd.cu", 313,
                                    " (tile route)"),
        "flash_attention_bwd_dq": ("flash_attention_bwd.cu", 357,
                                   ", delta fused (tile route)")}
    train = time_causal(gen, buf, TRAIN_B, TRAIN_T, 50, with_row=True)
    state["dq_row_ms"] = train["flash_attention_bwd_dq"].pop("row_ms")
    state["long_timing"] = time_causal(gen, buf, 1, LONG_T, 10,
                                       with_row=False)
    shape = "train q/dO (12,32,128,128) bf16, k/v (12,2,128,128), causal"
    return [dict(name=name, route="cuda", source=src + meta[name][0],
                 replaces=f"src/repro/kernels/flash_attention.py:"
                          f"{meta[name][1]}",
                 shape=shape + meta[name][2], dtype=torch.bfloat16, **r)
            for name, r in train.items()]


def time_wkv(gen, buf, state):
    """The wkv forward and backward kernels at the rwkv6-3b train shape
    (B=12, T=512, H=40, K=64, chunk 128, bf16 r/k/v) and at a prefill
    shape (1, 300, 40, 64), each beside its plain version and its bound
    over the causal pairs it needs (``wkv_causal_flops``, at the
    fp32-accurate tensor-core rate, "3xtf32"; the kernels run their fp32
    products on the CUDA cores, whose bound is kept beside it); no one
    PyTorch call computes the wkv, so no library time."""
    from repro_torch.configs import rwkv6_3b
    from repro_torch.kernels.dispatch import wkv_causal_flops
    from repro_torch.kernels.rwkv_wkv import (rwkv_wkv, rwkv_wkv_bwd,
                                              rwkv_wkv_bwd_plain,
                                              rwkv_wkv_fwd, rwkv_wkv_plain)
    ch = rwkv6_3b.config().ssm.chunk_size
    K = 64

    def io_bytes(B, T, bwd=False, emit=False, H=40):
        """r/k/v bf16, log_w fp32 and u in; y and S_T out (forward, plus
        the entry states when saved); the backward reads those inputs, the
        entry states, dy and dS_T and writes dr/dk/dv bf16, dlog_w fp32
        and du."""
        seq, states = B * T * H * K, B * H * -(-T // ch) * K * K * 4
        ins = (3 * 2 + 4) * seq + 4 * H * K
        if not bwd:
            return ins + 4 * seq + B * H * K * K * 4 + (states if emit else 0)
        return (ins + states + 4 * seq + B * H * K * K * 4
                + (3 * 2 + 4) * seq + 4 * H * K)

    def timed(B, T, emit_fwd, H=40):
        r, k, v, lw, u = wkv_inputs(gen, torch.bfloat16, B, T, H=H)
        dy = torch.randn(B, T, H, K, generator=gen, device="cuda")
        dsT = torch.zeros(B, H, K, K, device="cuda")
        (_, _), s0 = rwkv_wkv_fwd(r, k, v, lw, u, chunk=ch)

        def fwd():
            if emit_fwd:
                return rwkv_wkv_fwd(r, k, v, lw, u, chunk=ch)
            return rwkv_wkv(r, k, v, lw, u, chunk=ch, return_state=True)

        out = {"forward": dict(
            ms=time_ms(fwd, buf),
            plain_ms=time_ms(lambda: rwkv_wkv_plain(
                r, k, v, lw, u, chunk=ch, emit_chunk_states=emit_fwd), buf),
            bytes=io_bytes(B, T, emit=emit_fwd, H=H),
            ops=wkv_causal_flops(B, T, H, K, ch)),
            "backward": dict(
            ms=time_ms(lambda: rwkv_wkv_bwd(r, k, v, lw, u, s0, dy, dsT,
                                            chunk=ch), buf),
            plain_ms=time_ms(lambda: rwkv_wkv_bwd_plain(
                r, k, v, lw, u, s0, dy, dsT, chunk=ch), buf),
            bytes=io_bytes(B, T, bwd=True, H=H),
            ops=wkv_causal_flops(B, T, H, K, ch, "bwd"))}
        for x in out.values():
            x["bound_ms"], x["bound_cuda_cores_ms"] = (
                max(x["bytes"] / HBM_BYTES_PER_S,
                    x["ops"] / PEAK_OPS_PER_S[peak]) * 1e3
                for peak in ("3xtf32", torch.float32))
        return out

    train = timed(TRAIN_B, RWKV_T, True)
    # the prefill shape: the forward as prefill runs it (no entry states),
    # and the backward there too
    prefill = timed(1, 300, False)
    state["wkv_prefill_timing"] = prefill
    # one rank's heads of phase spmd's rwkv6-3b train leg (megatron over
    # two ranks: 20 of the 40 heads)
    tp = timed(TRAIN_B, RWKV_T, True, H=20)
    tp_shape = "tensor-parallel rank (12,512,20,64) bf16, chunk 128"
    state["wkv_tp_timing"] = {
        f"{name} {tp_shape}": dict(
            shape=tp_shape + extra, ms=x["ms"], plain_ms=x["plain_ms"],
            library_ms=None, bound_ms=x["bound_ms"],
            bound_cuda_cores_ms=x["bound_cuda_cores_ms"])
        for name, extra, x in (
            ("rwkv_wkv", ", with the entry states", tp["forward"]),
            ("rwkv_wkv_bwd", ", dy fp32", tp["backward"]))}
    shape = "train r/k/v (12,512,40,64) bf16, chunk 128"
    src = "src/repro_torch/kernels/csrc/rwkv_wkv.cu"
    return [
        dict(name="rwkv_wkv", route="cuda", source=src,
             replaces="src/repro/kernels/rwkv_wkv.py:142",
             shape=shape + ", with the entry states",
             library_ms=None, dtype="3xtf32",
             **{k: train["forward"][k]
                for k in ("ms", "plain_ms", "bytes", "ops")}),
        dict(name="rwkv_wkv_bwd", route="cuda", source=src,
             replaces="src/repro/kernels/rwkv_wkv.py:265",
             shape=shape + ", dy fp32", library_ms=None, dtype="3xtf32",
             **{k: train["backward"][k]
                for k in ("ms", "plain_ms", "bytes", "ops")}),
    ]


def kernels_line(state) -> dict:
    out = []
    for r in state["timing"]:
        bound_b = r["bytes"] / HBM_BYTES_PER_S * 1e3
        bound_o = r["ops"] / PEAK_OPS_PER_S[r["dtype"]] * 1e3
        extra = ({"launch_floor_ms": r["launch_floor_ms"]}
                 if "launch_floor_ms" in r else {})
        if r["dtype"] == "3xtf32":      # and on the CUDA cores, as they run
            extra["bound_cuda_cores_ms"] = max(
                bound_b, r["ops"] / PEAK_OPS_PER_S[torch.float32] * 1e3)
        if r["name"] == "entropy_exit" and "paper" in state:
            # the paper path's share of the launches, and its shapes
            extra["launches_paper"] = state["paper"]["gate_launches"]
            extra["paper_shapes"] = [
                {k: g[k] for k in ("shape", "ms", "plain_ms", "bound_ms")}
                for what, g in state["gate_timing"].items()
                if what.startswith("evaluator")]
        if "fused_launches" in state:   # phase fused's share of them
            extra["launches_fused"] = state["fused_launches"].get(r["name"],
                                                                  0)
        if "lifecycle_launches" in state:   # phase lifecycle's share
            extra["launches_lifecycle"] = state["lifecycle_launches"].get(
                r["name"], 0)
        # the same kernel at the shapes of the configs ported since
        more = [dict(shape=g["shape"], ms=g["ms"], plain_ms=g["plain_ms"],
                     library_ms=g.get("library_ms"), bound_ms=g["bound_ms"])
                for key in ("zamba_timing", "wide_cross_timing",
                            "wkv_tp_timing")
                for what, g in state.get(key, {}).items()
                if what.split()[0] == r["name"]]
        if r["name"] == "entropy_exit":
            more += [{k: g[k] for k in ("shape", "ms", "plain_ms",
                                        "bound_ms")}
                     for what, g in state.get("gate_timing", {}).items()
                     if what.startswith(("zamba2", "deepseek"))]
        if more:
            extra["more_shapes"] = more
        out.append(dict(
            name=r["name"], route=r["route"], source=r["source"],
            replaces=r["replaces"], shape=r["shape"],
            launches=state["launches"][r["name"]],
            max_abs_err=state["max_abs_err"][r["name"]],
            ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=max(bound_b, bound_o),
            bound_by="bytes" if bound_b >= bound_o else "operations",
            library_ms=r["library_ms"], **extra))
    return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    phases = ap.parse_args().phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    state: dict = {}
    failed = []
    t_all = time.perf_counter()
    for name in PHASES:
        if name not in phases:
            continue
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            globals()[f"phase_{name}"](state)
        except Exception:       # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
        # a phase's tensors go with its frames: hand their cached blocks
        # back before the next phase (phase spmd's ranks are processes of
        # their own and share the card with this one)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"== {name} took {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"total {time.perf_counter() - t_all:.1f} s")
    unlaunched = [k for k in KERNELS
                  if state.get("launches", {}).get(k, 0) == 0]
    if set(phases) == set(PHASES) and unlaunched:
        print(f"chip_smoke: kernels never launched on the main path: "
              f"{unlaunched}", file=sys.stderr)
        failed.append("launches")
    if "timing" in state and "max_abs_err" in state and not unlaunched:
        line = kernels_line(state)
        if "prefill_timing" in state:
            pt = state["prefill_timing"]
            print("flash_attention_tile prefill (1,32,128,128)/(1,2,161,128)"
                  f" causal bf16: {pt['ms']:.4f} ms, plain "
                  f"{pt['plain_ms']:.4f} ms, SDPA {pt['library_ms']:.4f} ms, "
                  f"bound {pt['bound_ms']:.5f} ms")
        if "decode_row_ms" in state:
            print(f"flash_attention_row (the forward's row route) at the "
                  f"decode shape (8,32,1,128)/(8,2,161,128) bf16: "
                  f"{state['decode_row_ms']:.4f} ms")
        if "decode_long_timing" in state:
            pt = state["decode_long_timing"]
            print(f"flash_attention decode route, q (8,32,1,128), k/v "
                  f"(8,2,{LONG_CACHE},128) bf16, every key valid: "
                  f"{pt['ms']:.4f} ms, row route {pt['row_ms']:.4f} ms, "
                  f"plain {pt['plain_ms']:.4f} ms, SDPA "
                  f"{pt['library_ms']:.4f} ms, bound {pt['bound_ms']:.5f} ms "
                  f"(bytes)")
        if "dq_row_ms" in state:
            print(f"flash_attention_bwd_dq_row (dQ's row route, delta "
                  f"given) at the train shape: {state['dq_row_ms']:.4f} ms")
        for name, pt in state.get("long_timing", {}).items():
            print(f"{name} long causal q (1,32,{LONG_T},128), k/v "
                  f"(1,2,{LONG_T},128) bf16: {pt['ms']:.4f} ms, plain "
                  f"{pt['plain_ms']:.4f} ms, SDPA "
                  f"{'backward ' if 'bwd' in name else ''}"
                  f"{pt['library_ms']:.4f} ms, bound {pt['bound_ms']:.5f} ms "
                  f"({pt['bound_by']})")
        for what, pt in state.get("wkv_tp_timing", {}).items():
            print(f"{what}: {pt['ms']:.4f} ms, plain {pt['plain_ms']:.4f} "
                  f"ms, bound {pt['bound_ms']:.5f} ms (3xtf32; on the CUDA "
                  f"cores {pt['bound_cuda_cores_ms']:.5f} ms)")
        for what, pt in state.get("wkv_prefill_timing", {}).items():
            print(f"rwkv_wkv {what} at the prefill shape (1,300,40,64) bf16 "
                  f"chunk 128: {pt['ms']:.4f} ms, plain "
                  f"{pt['plain_ms']:.4f} ms, bound {pt['bound_ms']:.5f} ms "
                  f"(3xtf32; on the CUDA cores "
                  f"{pt['bound_cuda_cores_ms']:.5f} ms)")
        if "paper" in state:
            p = state["paper"]
            print(f"paper full-width ResNet-18, 12 clients: averaging "
                  f"{p['averaging']['ms_round']:.1f} ms per round "
                  f"({p['averaging']['images_s']:,.0f} images/s), "
                  f"sequential {p['sequential']['ms_round']:.1f} ms; peak "
                  f"{p['peak_gib']:.2f} GiB; entropy_exit launches "
                  f"{p['gate_launches']} in its evaluations")
        for key, f in state.get("fused", {}).items():
            if key.startswith("benchmark"):
                continue
            print(f"fused full-width ResNet-18, 12 clients, {key}: "
                  f"{f['ms_round']:.1f} ms per round ({f['images_s']:,.0f} "
                  f"images/s), idle share {f['idle_share']:.3f}, "
                  f"{f['kernels_round']:.0f} kernels per round, peak "
                  f"{f['peak_gib']:.2f} GiB, {f['syncs']} host syncs over "
                  f"{f['chunks']} chunks")
        if "lifecycle" in state:
            lc = state["lifecycle"]
            print(f"lifecycle full-width ResNet-18, population of "
                  f"{POP_CLIENTS} over 12 slots: {lc['ms_pop']:.1f} ms per "
                  f"churning round, {lc['ms_full']:.1f} full participation, "
                  f"{lc['ms_fixed']:.1f} fixed cohort; checkpoint "
                  f"{lc['mb']:.1f} MB, save {lc['save_ms']:.1f} ms, restore "
                  f"{lc['restore_ms']:.1f} ms; {lc['syncs']} host syncs over "
                  f"{lc['chunks']} chunks; peak {lc['peak_gib']:.2f} GiB")
        for backend, sp in state.get("spmd", {}).items():
            print(f"spmd full-width ResNet-18 over {len(sp['ranks'])} ranks "
                  f"({backend}): lanes {sp['lanes']['ms'][-1]:.1f}, data "
                  f"{sp['data']['ms'][-1]:.1f} ms per round against fused "
                  f"{sp['fused_ms'][-1]:.1f} on the same card (last of "
                  f"{SPMD_ROUNDS}); {sp['data']['gathered']:,.0f} bytes "
                  f"gathered per cohort step a rank under FSDP")
        for key in ("train", "train_rwkv", "train_zamba", "train_whisper",
                    "train_paligemma"):
            if key in state:
                tr = state[key]
                print(f"{tr['model']} launches per step: eq1 "
                      f"{tr['eq1']['launches_per_step']}, sum "
                      f"{tr['sum']['launches_per_step']}")
        print("library time of both attention backward rows: one SDPA "
              "backward computing dQ, dK and dV together")
        print("flash_attention: the forward's decode route (mma.sync, keys "
              "split across a cluster), flash_attention_tile: its tile "
              "route (wgmma); both replace flash_attention_pallas")
        for k in line["kernels"]:
            lib = ("none" if k["library_ms"] is None
                   else f"{k['library_ms']:.4f} ms")
            cores = ("" if "bound_cuda_cores_ms" not in k else
                     f"; on the CUDA cores {k['bound_cuda_cores_ms']:.5f} ms")
            if "launch_floor_ms" in k:
                cores += f"; launch floor {k['launch_floor_ms']:.4f} ms"
            print(f"{k['name']} [{k['shape']}]: {k['ms']:.4f} ms, bound "
                  f"{k['bound_ms']:.5f} ms ({k['bound_by']}{cores}), plain "
                  f"{k['plain_ms']:.4f} ms, library {lib}, "
                  f"{k['launches']} launches on the main path")
        print("ported kernels: " + ", ".join(
            f"{k['name']} ({k['route']}, {k['source']}, replaces "
            f"{k['replaces']})" for k in line["kernels"]))
    print(card_line())
    if failed or set(phases) != set(PHASES):
        print(f"chip_smoke: failed phases {failed}; phases run {phases}",
              file=sys.stderr)
        return 1
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

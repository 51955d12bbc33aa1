"""Drives the PyTorch/CUDA port on one CUDA card and checks it.

    python3 chip_smoke.py                    # every phase, one card
    python3 chip_smoke.py --phases build,kernels

Phases:
  build    builds every CUDA kernel from the sources in the checkout
           (one nvcc per source, all started together) and prints the card's
           name and power limit;
  kernels  holds each kernel against its plain PyTorch version on the card,
           at the serve and train shapes of full-width glm4-9b plus
           sliding-window, non-causal, head-dim 32 and fp32 cases, and the
           autograd site of training against autograd of the plain forward;
  parity   glm4-9b smoke in fp32: the batched ServeSession against the
           port's sequential references, token and gate exact; three train
           steps (eq1, sum, eq1 with remat) with the kernels against the
           plain versions;
  main     the serving path: ServeSession on full-width glm4-9b in bf16 (40
           layers, random weights from a seeded torch.Generator on the card),
           8 slots, 16 requests, under the select and the sticky policy; each
           run starts with every launch count at 0 and must launch both
           kernels;
  train    the training path: make_train_step on glm4-9b at its published
           widths with the depth cut to 8 layers (exits 2, 4, 6; 12 client
           groups), bf16 weights, fp32 Adam, batch 12 x 128 tokens of
           SyntheticLMDataset(seed=0); with every launch count set to 0
           first, warm-up and one sum step (one step of each mode under
           FlopCounterMode, for the share of the bf16 peak), timed eq1 and
           sum steps, a loss check on the first batch, then a traced
           window of 2 steps;
  timing   each kernel, its plain version and PyTorch's one-call equivalent
           (SDPA forward, SDPA backward) timed at the main path's shapes,
           beside the bound for the work.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Any failed check exits non-zero
and prints no result.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
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
PHASES = ("build", "kernels", "parity", "main", "train", "timing")
KERNELS = ("entropy_exit", "flash_attention", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq")

# NVIDIA H100 SXM data sheet (dense): HBM rate and peak rates by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# tolerances: fp32 kernels against fp32 plain versions (reassociation only);
# bf16 outputs compared in fp32 (the two sides round to bf16 at other points)
TOL_ATTN_F32 = 2e-5
TOL_ATTN_BF16 = 2e-2
# the LSE is fp32 on both sides, computed in fp32 from the same operand
# values, bf16 or fp32: reassociation only, so one tolerance holds for both
TOL_LSE = 1e-4
TOL_H = 1e-4
GATE_MARGIN = 1e-3      # exits must agree wherever |H - tau| exceeds this
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
TOL_SITE_F32 = 1e-4
TOL_SITE_BF16 = 1e-2
# train-step parity, fp32 smoke: losses 1e-5; params after 3 Adam steps at
# most 1 element in 10^3 beyond 1e-6 and none beyond lr (Adam's first steps
# divide by sqrt(v) ~ |g|, which turns a 1e-9 gradient difference near
# g = 0 into an update difference of up to lr; measured 4.4e-5 of the
# elements on an H100)
TOL_TRAIN_LOSS = 1e-5
TRAIN_PARAM_FRACTION = 1e-3

# the serving path's shapes (glm4-9b, 8 slots, max_len 161)
SLOTS, REQUESTS, DECODE, MAX_LEN = 8, 16, 32, 161
# the training path: glm4-9b cut to 8 layers, batch 12 x 128 tokens
TRAIN_LAYERS, TRAIN_B, TRAIN_T = 8, 12, 128
TRAIN_WARM, TRAIN_EQ1, TRAIN_SUM = 2, 10, 3


class Failed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    print(("  ok    " if cond else "  FAIL  ") + msg, flush=True)
    if not cond:
        raise Failed(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def flush_l2(buf: torch.Tensor) -> None:
    buf.zero_()         # 128 MB > the 50 MB L2: the next launch starts cold


def time_ms(fn, buf, reps: int = 50) -> float:
    """Median device time of one call, L2 flushed before each."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        flush_l2(buf)
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


def logits_inputs(gen, dtype, B=SLOTS, V=151552):
    x = (3.0 * torch.randn(B, V, generator=gen, device="cuda")).to(dtype)
    return x


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
                if "registers" in line or "spill" in line:
                    print(f"  {src}: {line.strip()}")
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_kernels(state):
    from repro_torch.kernels.entropy_exit import entropy_exit
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import entropy_exit_ref, flash_attention_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = state.setdefault("max_abs_err", {})

    def attn_case(name, dtype, tol, *, B, Tq, causal, Tk=MAX_LEN,
                  window=None, kv_valid=None, lse=False, main=False):
        q, k, v = attn_inputs(gen, dtype, B=B, Tq=Tq, Tk=Tk)
        got = flash_attention(q, k, v, causal=causal, window=window,
                              kv_valid=kv_valid, return_lse=lse)
        want = flash_attention_ref(q, k, v, causal=causal, window=window,
                                   kv_valid=kv_valid, return_lse=lse)
        torch.cuda.synchronize()
        if lse:
            (got, got_lse), (want, want_lse) = got, want
            d_lse = (got_lse - want_lse).abs().max().item()
            check(d_lse <= TOL_LSE, f"attention {name} {dtype} lse max|d|="
                                    f"{d_lse:.3e} <= {TOL_LSE:g}")
        d = (got.float() - want.float()).abs().max().item()
        check(got.shape == want.shape and d <= tol,
              f"attention {name} {dtype} max|d|={d:.3e} <= {tol:g}")
        if main:
            errs["flash_attention"] = max(errs.get("flash_attention", 0.0), d)

    attn_case("decode (8,32,1,128)/(8,2,161,128) kv_valid", torch.bfloat16,
              TOL_ATTN_BF16, B=8, Tq=1, causal=False, kv_valid=kv_prefix(8),
              main=True)
    attn_case("prefill (1,32,128,128)/(1,2,161,128) causal", torch.bfloat16,
              TOL_ATTN_BF16, B=1, Tq=128, causal=True, main=True)
    attn_case("prefill (1,32,37,128)/(1,2,161,128) causal", torch.bfloat16,
              TOL_ATTN_BF16, B=1, Tq=37, causal=True, main=True)
    attn_case("train (12,32,128,128)/(12,2,128,128) causal, with lse",
              torch.bfloat16, TOL_ATTN_BF16, B=TRAIN_B, Tq=TRAIN_T,
              Tk=TRAIN_T, causal=True, lse=True, main=True)
    attn_case("decode fp32 kv_valid", torch.float32, TOL_ATTN_F32, B=8, Tq=1,
              causal=False, kv_valid=kv_prefix(8, seed=1), lse=True)
    attn_case("prefill fp32 causal", torch.float32, TOL_ATTN_F32, B=2, Tq=100,
              causal=True, lse=True)
    attn_case("sliding window 48, fp32", torch.float32, TOL_ATTN_F32, B=2,
              Tq=MAX_LEN, causal=True, window=48, lse=True)
    attn_case("sliding window 48, bf16", torch.bfloat16, TOL_ATTN_BF16, B=2,
              Tq=MAX_LEN, causal=True, window=48)

    def gate_case(name, dtype, V, main=False):
        x = logits_inputs(gen, dtype, V=V)
        H_ref, _ = entropy_exit_ref(x, 0.0)
        # thresholds around each row's entropy, some within the margin
        tau = H_ref + torch.tensor([-0.5, 0.5, -1e-4, 1e-4, -2e-3, 2e-3,
                                    -3.0, 3.0], device="cuda")
        H, ex = entropy_exit(x, tau)
        H_ref, ex_ref = entropy_exit_ref(x, tau)
        torch.cuda.synchronize()
        d = (H - H_ref).abs().max().item()
        check(d <= TOL_H, f"entropy {name} {dtype} max|dH|={d:.3e} <= {TOL_H:g}")
        far = (H_ref - tau).abs() > GATE_MARGIN
        check(bool((ex[far] == ex_ref[far]).all()),
              f"entropy {name} exits equal where |H-tau| > {GATE_MARGIN:g}")
        if main:
            errs["entropy_exit"] = max(errs.get("entropy_exit", 0.0), d)

    gate_case("(8,151552)", torch.bfloat16, 151552, main=True)
    gate_case("(8,151552)", torch.float32, 151552)
    gate_case("(8,2053) vocab tail", torch.float32, 2048 + 5)
    gate_case("(8,97) vocab tail", torch.bfloat16, 97)

    bwd_kernel_cases(gen, errs)
    autograd_site_cases(gen)


def bwd_inputs(gen, dtype, *, B, H, Hkv, T, D):
    """q, k, v, dO in the model's (B, T, H, D) layout, as transposed views."""
    return tuple(torch.randn(B, T, h, D, generator=gen, device="cuda")
                 .to(dtype).transpose(1, 2) for h in (H, Hkv, Hkv, H))


def bwd_kernel_cases(gen, errs):
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from repro_torch.kernels.ref import (flash_attention_bwd_dkv_ref,
                                         flash_attention_bwd_dq_ref,
                                         flash_attention_bwd_ref,
                                         flash_attention_ref)

    def case(name, dtype, *, B, H, Hkv, T, D=128, causal=True, window=None,
             main=False):
        q, k, v, do = bwd_inputs(gen, dtype, B=B, H=H, Hkv=Hkv, T=T, D=D)
        o, lse = flash_attention_ref(q, k, v, causal=causal, window=window,
                                     return_lse=True)
        delta = (do.float() * o.float()).sum(-1)
        kw = dict(causal=causal, window=window)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        want_dk, want_dv = flash_attention_bwd_dkv_ref(q, k, v, do, lse,
                                                       delta, **kw)
        want_dq = flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
        grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        wants = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        d_dkv = max((dk - want_dk).abs().max().item(),
                    (dv - want_dv).abs().max().item())
        d_dq = (dq - want_dq).abs().max().item()
        check(d_dkv <= TOL_BWD and d_dq <= TOL_BWD,
              f"attention bwd {name} {dtype}: kernel fp32 outputs max|d| "
              f"dK/dV {d_dkv:.3e}, dQ {d_dq:.3e} <= {TOL_BWD:g}")
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
            errs["flash_attention_bwd_dq"] = max(
                errs.get("flash_attention_bwd_dq", 0.0), d_dq)

    train = dict(B=TRAIN_B, H=32, Hkv=2, T=TRAIN_T)
    case("train (12,32,128,128)/(12,2,128,128) causal GQA16", torch.bfloat16,
         main=True, **train)
    case("train shape causal GQA16", torch.float32, **train)
    case("sliding window 16, T=100", torch.float32, B=2, H=8, Hkv=2, T=100,
         window=16)
    case("sliding window 16, T=100", torch.bfloat16, B=2, H=8, Hkv=2, T=100,
         window=16)
    case("non-causal T=70", torch.float32, B=2, H=4, Hkv=4, T=70,
         causal=False)
    case("head_dim 32 causal T=64", torch.float32, B=2, H=8, Hkv=2, T=64,
         D=32)
    case("head_dim 32 causal T=64", torch.bfloat16, B=2, H=8, Hkv=2, T=64,
         D=32)


def autograd_site_cases(gen):
    """The training site (kernels="auto": FlashAttentionFn over the forward
    and both backward kernels) against autograd of the plain forward."""
    from repro_torch.kernels import dispatch
    for dtype, tol in ((torch.float32, TOL_SITE_F32),
                       (torch.bfloat16, TOL_SITE_BF16)):
        leaves = [torch.randn(4, TRAIN_T, h, 128, generator=gen,
                              device="cuda").to(dtype) for h in (32, 2, 2)]
        cot = torch.randn(4, TRAIN_T, 32, 128, generator=gen,
                          device="cuda").to(dtype)
        res = []
        for name in ("auto", "ref"):
            q, k, v = (t.clone().requires_grad_() for t in leaves)
            out = dispatch.get_backend(name).attention(q, k, v, causal=True)
            out.backward(cot)
            res.append([t.float() for t in (out, q.grad, k.grad, v.grad)])
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


def phase_parity(state):
    from repro_torch.api.serve_session import (ServeSession,
                                               sequential_reference,
                                               sequential_sticky_reference)
    from repro_torch.configs import glm4_9b
    from repro_torch.models.backbone import init_backbone
    cfg = glm4_9b.smoke()
    params = init_backbone(torch.Generator(device="cuda").manual_seed(0), cfg)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(4, 10)))
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
              f"smoke fp32 {policy} tau={tau:.4f}: 6 requests on 3 slots "
              f"token- and exit-exact vs the sequential reference, "
              f"max|dH|={worst:.2e} (exits {sum(flags)}/{len(flags)}, "
              f"client-only ticks {sess.stats.client_only_ticks})")
        if tau > math.log(cfg.vocab_size):
            check(sess.stats.client_only_ticks > 0,
                  "smoke sticky above ln V: client-only ticks ran")
    train_parity()


def train_parity(steps: int = 3) -> None:
    """glm4-9b smoke, fp32, TF32 off: make_train_step with the kernels
    (kernels="auto") against the plain versions (kernels="ref")."""
    from repro_torch.config import (HeteroProfile, OptimizerConfig,
                                    SplitEEConfig, TrainConfig)
    from repro_torch.configs import glm4_9b
    from repro_torch.core.spmd import (StepConfig, boundary_ids_for_batch,
                                       make_train_step)
    from repro_torch.models.backbone import init_backbone
    from repro_torch.optim import adam_init
    from repro_torch.tree import tree_leaves
    base = glm4_9b.smoke()
    profile = HeteroProfile((1, 1, 2, 2))
    lr = 1e-3
    rng = np.random.default_rng(2)
    sids = boundary_ids_for_batch(profile, base, 8, "cuda")
    batches = [{"tokens": torch.as_tensor(rng.integers(0, base.vocab_size,
                                                       (8, 32)), device="cuda"),
                "labels": torch.as_tensor(rng.integers(0, base.vocab_size,
                                                       (8, 32)), device="cuda"),
                "split_ids": sids} for _ in range(steps)]
    for grad_mode, remat in (("eq1", "none"), ("sum", "none"),
                             ("eq1", "full")):
        runs = []
        for kernels in ("auto", "ref"):
            cfg = base.with_(kernels=kernels)
            sc = StepConfig(model=cfg, splitee=SplitEEConfig(profile=profile),
                            train=TrainConfig(optimizer=OptimizerConfig(
                                lr=lr, total_steps=2 * steps), remat=remat),
                            grad_mode=grad_mode)
            params = init_backbone(
                torch.Generator(device="cuda").manual_seed(0), cfg)
            opt = adam_init(params, sc.train.optimizer)
            step = make_train_step(sc)
            losses = []
            for b in batches:
                params, opt, m = step(params, opt, b)
                losses.append([float(v) for k, v in sorted(m.items())
                               if k != "lr"])
            runs.append((params, np.asarray(losses)))
        (p0, l0), (p1, l1) = runs
        d_loss = float(np.abs(l0 - l1).max())
        d = torch.cat([(a - b).abs().flatten()
                       for a, b in zip(tree_leaves(p0), tree_leaves(p1))])
        n_off = int((d > 1e-6).sum())
        check(d_loss <= TOL_TRAIN_LOSS and d.max().item() <= lr
              and n_off <= TRAIN_PARAM_FRACTION * d.numel(),
              f"smoke fp32 train {grad_mode} remat={remat}: {steps} steps "
              f"kernels vs plain, losses max|d|={d_loss:.2e} <= "
              f"{TOL_TRAIN_LOSS:g}; params max|d|={d.max().item():.2e} <= lr,"
              f" {n_off} of {d.numel()} beyond 1e-6 (<= "
              f"{TRAIN_PARAM_FRACTION:g} of them)")


def weight_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    items = tree.values() if isinstance(tree, dict) else tree
    return sum(weight_bytes(t) for t in items)


def phase_main(state):
    from repro_torch.api.serve_session import ServeSession
    from repro_torch.configs import glm4_9b
    from repro_torch.kernels.entropy_exit import entropy_exit
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.backbone import init_backbone
    cfg = glm4_9b.config()
    t0 = time.perf_counter()
    params = init_backbone(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    total = weight_bytes(params)
    print(f"glm4-9b bf16 weights: {total / 1e9:.2f} GB, initialised on the "
          f"card in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(16, 129)))
               for _ in range(REQUESTS)]

    # warm-up (cuBLAS handles, first launches); not counted
    warm = ServeSession(cfg, params, tau=2.0, slots=SLOTS, max_len=MAX_LEN)
    warm.submit(prompts[0][:16], decode_tokens=2)
    warm.run()
    del warm

    layers = sum(weight_bytes(seg) for seg in params["segments"])
    head = weight_bytes(params["head"])
    cut = sorted(cfg.exit_layers)[0]
    per_layer = layers / cfg.num_layers
    kv_bytes = 2 * cfg.num_layers * SLOTS * MAX_LEN * cfg.num_kv_heads \
        * cfg.head_dim * 2
    full_tick = layers + 2 * head + kv_bytes
    client_tick = cut * per_layer + head + kv_bytes * cut / cfg.num_layers
    state["tick_bound_ms"] = full_tick / HBM_BYTES_PER_S * 1e3
    print(f"tick bound: full tick reads {full_tick / 1e9:.2f} GB "
          f"({cfg.num_layers} layers, exit + LM head, KV pages) -> {state['tick_bound_ms']:.3f} ms; "
          f"client-only tick {client_tick / 1e9:.2f} GB -> "
          f"{client_tick / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s")

    launches = {"flash_attention": 0, "entropy_exit": 0}
    for policy, tau in (("select", 2.0), ("sticky", 12.5)):
        sess = ServeSession(cfg, params, tau=tau, slots=SLOTS,
                            max_len=MAX_LEN, exit_policy=policy)
        for p in prompts:
            sess.submit(p, decode_tokens=DECODE)
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        entropy_exit.launches = 0
        results = sess.run()
        n_attn, n_gate = flash_attention.launches, entropy_exit.launches
        peak = torch.cuda.max_memory_allocated()
        st = sess.stats
        launches["flash_attention"] += n_attn
        launches["entropy_exit"] += n_gate
        decode_s = st.wall_s - st.prefill_s
        print(f"main {policy} tau={tau}: {st.requests} requests, {st.tokens} "
              f"tokens, {st.decode_ticks} ticks ({st.client_only_ticks} "
              f"client-only), adoption {st.adoption_ratio:.3f}")
        print(f"  {st.tokens / st.wall_s:.1f} tok/s overall, "
              f"{decode_s / st.decode_ticks * 1e3:.3f} ms per decode tick, "
              f"{st.prefill_s / st.requests * 1e3:.3f} ms per prefill, "
              f"peak memory {peak / 2**30:.2f} GiB, "
              f"launches: flash_attention {n_attn}, entropy_exit {n_gate}")
        state[f"main_{policy}"] = dict(
            tok_s=st.tokens / st.wall_s,
            ms_per_tick=decode_s / st.decode_ticks * 1e3,
            ms_per_prefill=st.prefill_s / st.requests * 1e3,
            peak_gib=peak / 2**30, ticks=st.decode_ticks,
            client_only_ticks=st.client_only_ticks,
            adoption=st.adoption_ratio, flash_launches=n_attn,
            gate_launches=n_gate)
        full_ticks = st.decode_ticks - st.client_only_ticks
        check(n_attn > 0 and n_gate > 0,
              f"{policy}: both kernels launched on the main path")
        check(n_attn == cfg.num_layers * (full_ticks + st.requests)
              + cut * st.client_only_ticks and n_gate == st.decode_ticks,
              f"{policy}: one attention launch per layer per tick and "
              f"prefill, one gate launch per tick")
        ok = len(results) == REQUESTS
        for r in results:
            ok &= len(r.tokens) == DECODE + 1 and len(r.exited) == DECODE
            ok &= all(0 <= t < cfg.vocab_size for t in r.tokens)
            H = np.asarray(r.entropy)
            ok &= bool(np.isfinite(H).all() and (H >= -1e-3).all()
                       and (H <= math.log(cfg.vocab_size) + 1e-2).all())
            if policy == "select":
                ok &= all(e == (h < tau) for e, h in zip(r.exited, r.entropy)
                          if abs(h - tau) > GATE_MARGIN)
        check(ok, f"{policy}: every request served {DECODE} finite gated "
                  f"tokens in range, gate consistent with H < tau")
        if policy == "sticky":
            check(st.adoption_ratio == 1.0 and st.client_only_ticks > 0,
                  "sticky tau=12.5 > ln(151552): every token exits and "
                  "client-only ticks run")
    state["launches"] = launches
    profile_ticks(cfg, params, prompts)
    del params
    torch.cuda.empty_cache()


def traced(run, n: int, what: str, top: int = 6) -> dict:
    """``run()`` n times under torch.profiler: wall time, device busy time
    (the sum of device kernel times) and idle share per run, and the
    largest device kernels by time."""
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
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    print(f"profile {what}, {n} traced: {wall_us / n / 1e3:.3f} ms each, "
          f"device busy {busy_us / n / 1e3:.3f} ms each (idle share "
          f"{1 - busy_us / wall_us:.3f}), {len(kernels) / n:.0f} device "
          f"kernels each")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {us / n / 1e3:8.3f} ms each  {name[:90]}")
    return dict(wall_ms=wall_us / n / 1e3, busy_ms=busy_us / n / 1e3,
                idle_share=1 - busy_us / wall_us)


def profile_ticks(cfg, params, prompts, ticks: int = 5) -> None:
    """Device busy share over a few select decode ticks (a separate, traced
    run: the tick times above are measured untraced)."""
    from repro_torch.api.serve_session import ServeSession
    sess = ServeSession(cfg, params, tau=2.0, slots=SLOTS, max_len=MAX_LEN)
    for p in prompts[:SLOTS]:
        sess.submit(p, decode_tokens=DECODE)
    sess.step()                     # the admission tick, not traced
    traced(sess.step, ticks, "select decode tick")


def phase_train(state):
    from repro_torch.config import OptimizerConfig, SplitEEConfig, TrainConfig
    from repro_torch.configs import glm4_9b
    from repro_torch.core.losses import softmax_cross_entropy
    from repro_torch.core.spmd import (StepConfig, boundary_ids_for_batch,
                                       make_train_step)
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from repro_torch.launch.e2e_train import cut_depth
    from repro_torch.models.backbone import backbone_forward, init_backbone
    from repro_torch.optim import adam_init
    from repro_torch.tree import tree_leaves

    cfg, profile = cut_depth(glm4_9b.config(), TRAIN_LAYERS)
    # warm-up (its first step counted), one counted sum step, the timed
    # steps, the traced window
    n_steps = TRAIN_WARM + 1 + TRAIN_EQ1 + TRAIN_SUM + 2
    opt_cfg = OptimizerConfig(lr=3e-4, total_steps=n_steps)
    t0 = time.perf_counter()
    params = init_backbone(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt = adam_init(params, opt_cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"train: glm4-9b widths cut to {cfg.num_layers} layers, exits "
          f"{cfg.exit_layers}, {profile.num_groups} client groups "
          f"{profile.split_layers}; {n_params / 1e9:.3f} B params "
          f"({weight_bytes(params) / 1e9:.2f} GB bf16) + fp32 Adam m/v "
          f"({weight_bytes(opt.m) * 2 / 1e9:.2f} GB), set up in "
          f"{time.perf_counter() - t0:.1f} s")
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=TRAIN_T,
                            seed=0)
    sids = boundary_ids_for_batch(profile, cfg, TRAIN_B, "cuda")
    batches = [{"tokens": torch.as_tensor(t, device="cuda"),
                "labels": torch.as_tensor(lab, device="cuda"),
                "split_ids": sids}
               for t, lab in ds.batches(TRAIN_B, n_steps)]
    tokens = TRAIN_B * TRAIN_T

    def first_batch_loss() -> float:
        with torch.no_grad():
            out = backbone_forward(params, cfg, tokens=batches[0]["tokens"],
                                   exit_heads=())
            return float(softmax_cross_entropy(out.logits,
                                               batches[0]["labels"]))

    steps = {mode: make_train_step(StepConfig(
        model=cfg, splitee=SplitEEConfig(profile=profile),
        train=TrainConfig(optimizer=opt_cfg), grad_mode=mode))
        for mode in ("eq1", "sum")}
    loss0 = first_batch_loss()
    it = iter(batches)
    metrics = []

    def one_step(mode):
        nonlocal params, opt
        params, opt, m = steps[mode](params, opt, next(it))
        metrics.append(m)

    counters = (flash_attention, flash_attention_bwd_dkv,
                flash_attention_bwd_dq)

    def run(mode, n):
        before = [c.launches for c in counters]
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            one_step(mode)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) / n * 1e3
        return ms, [(c.launches - b) / n for c, b in zip(counters, before)]

    # one block matmul of an attention kernel over the causal band
    band_mm = (2 * TRAIN_B * cfg.num_heads * TRAIN_T * (TRAIN_T + 1) // 2
               * cfg.head_dim)

    def counted_step(mode) -> float:
        """One step under FlopCounterMode: the FLOPs of the matmuls the
        step ran (the forward and the backward pulls as autograd pruned
        them), plus the attention kernels' block matmuls over the band
        from their launches (2 forward, 4 dK/dV, 3 dQ)."""
        from torch.utils.flop_counter import FlopCounterMode
        before = [c.launches for c in counters]
        with FlopCounterMode(display=False) as fc:
            one_step(mode)
        torch.cuda.synchronize()
        n = [c.launches - b for c, b in zip(counters, before)]
        return fc.get_total_flops() + band_mm * (2 * n[0] + 4 * n[1]
                                                 + 3 * n[2])

    # the forward's weight matmuls: every parameter but the embedding
    # table (a gather) and the norm gains multiplies each token once
    mm_params = sum(p.numel() for p in tree_leaves(params) if p.ndim >= 2)
    mm_params -= params["embed"]["table"].numel()
    fwd_flops = 2 * mm_params * tokens

    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    flops = {"eq1": counted_step("eq1")}
    run("eq1", TRAIN_WARM - 1)
    flops["sum"] = counted_step("sum")
    timed = {"eq1": run("eq1", TRAIN_EQ1), "sum": run("sum", TRAIN_SUM)}
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()
    loss1 = first_batch_loss()
    train = dict(params=n_params, peak_gib=peak / 2**30, loss0=loss0,
                 loss1=loss1, launches=launches)
    peak_s = PEAK_OPS_PER_S[torch.bfloat16] / 1e3
    for mode, (ms, per_step) in timed.items():
        nominal = 6 * n_params * tokens * (1.5 if mode == "eq1" else 1.0)
        share, share_nominal = flops[mode] / (ms * peak_s), nominal / (
            ms * peak_s)
        print(f"train {mode}: {ms:.1f} ms per step, "
              f"{tokens / ms * 1e3:,.0f} tokens/s; launches per step: "
              f"flash_attention {per_step[0]:g}, dK/dV {per_step[1]:g}, dQ "
              f"{per_step[2]:g}")
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
        check(min(per_step) > 0 and per_step[0] == cfg.num_layers,
              f"train {mode}: all three attention kernels launched every "
              f"step, one forward launch per layer")
        # forward + a backward of at least dW and dX for every weight
        check(flops[mode] >= 2.9 * fwd_flops,
              f"train {mode}: the counted FLOPs include the backward pulls")
    print(f"train: peak memory {peak / 2**30:.2f} GiB; first batch server "
          f"loss {loss0:.4f} before, {loss1:.4f} after "
          f"{TRAIN_WARM + 1 + TRAIN_EQ1 + TRAIN_SUM} steps")
    finite = all(math.isfinite(float(v)) for m in metrics
                 for v in m.values())
    check(finite, "train: every step's losses finite")
    check(loss1 < loss0, "train: the first batch's server loss fell")
    train["profile"] = traced(lambda: one_step("eq1"), 2, "eq1 train step")
    state["train"] = train
    for name, n in launches.items():
        launches_all = state.setdefault("launches", {})
        launches_all[name] = launches_all.get(name, 0) + n
    del params, opt, metrics
    torch.cuda.empty_cache()


def phase_timing(state):
    from repro_torch.kernels.entropy_exit import entropy_exit
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import entropy_exit_ref, flash_attention_ref
    gen = torch.Generator(device="cuda").manual_seed(1)
    buf = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    rows = []

    # attention at the decode shape: 8 slots, 161-slot ring, per-row prefix
    q, k, v = attn_inputs(gen, torch.bfloat16, B=8, Tq=1)
    kv_valid = kv_prefix(8, seed=2)
    B, H, _, D = q.shape
    Hkv = k.shape[1]
    n_keys = int(kv_valid.sum())
    bytes_ = (q.numel() + q.numel()) * 2 + 2 * n_keys * Hkv * D * 2 + B * 4
    ops = 4 * H * D * n_keys
    mask = (torch.arange(k.shape[2], device="cuda")[None]
            < kv_valid[:, None])[:, None, None, :]
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:141",
        shape="decode q (8,32,1,128) bf16, kv (8,2,161,128), per-row kv_valid",
        ms=time_ms(lambda: flash_attention(q, k, v, causal=False,
                                           kv_valid=kv_valid), buf),
        plain_ms=time_ms(lambda: flash_attention_ref(q, k, v, causal=False,
                                                     kv_valid=kv_valid), buf),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), buf),
        bytes=bytes_, ops=ops, dtype=torch.bfloat16))

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

    # entropy gate at the serve shape
    x = logits_inputs(gen, torch.bfloat16)
    tau = torch.full((x.shape[0],), 2.0, device="cuda")
    rows.append(dict(
        name="entropy_exit", route="cuda",
        source="src/repro_torch/kernels/csrc/entropy_exit.cu",
        replaces="src/repro/kernels/entropy_exit.py:57",
        shape="logits (8,151552) bf16, per-row tau",
        ms=time_ms(lambda: entropy_exit(x, tau), buf),
        plain_ms=time_ms(lambda: entropy_exit_ref(x, tau), buf),
        library_ms=None,
        bytes=x.numel() * 2 + 3 * 4 * x.shape[0], ops=4 * x.numel(),
        dtype=torch.float32))
    rows.extend(time_backward(gen, buf, state))
    state["timing"] = rows


def time_backward(gen, buf, state):
    """The two backward kernels at the train shape (B=12, H=32, Hkv=2,
    T=128, D=128, bf16, causal), each beside its plain version and the
    backward of PyTorch's SDPA (one call computing dQ, dK and dV)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from repro_torch.kernels.ref import (flash_attention_bwd_dkv_ref,
                                         flash_attention_bwd_dq_ref,
                                         flash_attention_ref)
    B, H, Hkv, T, D = TRAIN_B, 32, 2, TRAIN_T, 128
    q, k, v, do = bwd_inputs(gen, torch.bfloat16, B=B, H=H, Hkv=Hkv, T=T,
                             D=D)
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    n_pairs = T * (T + 1) // 2
    mm = 2 * B * H * n_pairs * D            # one block matmul over the band
    io = 2 * (2 * q.numel() + 2 * k.numel()) + 2 * 4 * B * H * T
    sq, sk, sv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True,
                                              enable_gqa=True)
    sdpa_ms = time_ms(lambda: torch.autograd.grad(
        sdpa_out, (sq, sk, sv), do, retain_graph=True), buf)
    state["train_fwd_timing"] = dict(
        ms=time_ms(lambda: flash_attention(q, k, v, causal=True,
                                           return_lse=True), buf),
        plain_ms=time_ms(lambda: flash_attention_ref(
            q, k, v, causal=True, return_lse=True), buf),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), buf),
        bound_ms=max((2 * q.numel() + 2 * k.numel()) * 2 / HBM_BYTES_PER_S,
                     2 * mm / PEAK_OPS_PER_S[torch.bfloat16]) * 1e3)
    shape = "train q/dO (12,32,128,128) bf16, k/v (12,2,128,128), causal"
    return [
        dict(name="flash_attention_bwd_dkv", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention.py:313",
             shape=shape,
             ms=time_ms(lambda: flash_attention_bwd_dkv(
                 q, k, v, do, lse, delta, causal=True), buf),
             plain_ms=time_ms(lambda: flash_attention_bwd_dkv_ref(
                 q, k, v, do, lse, delta, causal=True), buf),
             library_ms=sdpa_ms,
             bytes=io + 2 * 4 * k.numel(), ops=4 * mm,
             dtype=torch.bfloat16),
        dict(name="flash_attention_bwd_dq", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention.py:357",
             shape=shape,
             ms=time_ms(lambda: flash_attention_bwd_dq(
                 q, k, v, do, lse, delta, causal=True), buf),
             plain_ms=time_ms(lambda: flash_attention_bwd_dq_ref(
                 q, k, v, do, lse, delta, causal=True), buf),
             library_ms=sdpa_ms,
             bytes=io + 4 * q.numel(), ops=3 * mm,
             dtype=torch.bfloat16),
    ]


def kernels_line(state) -> dict:
    out = []
    for r in state["timing"]:
        bound_b = r["bytes"] / HBM_BYTES_PER_S * 1e3
        bound_o = r["ops"] / PEAK_OPS_PER_S[r["dtype"]] * 1e3
        out.append(dict(
            name=r["name"], route=r["route"], source=r["source"],
            replaces=r["replaces"], shape=r["shape"],
            launches=state["launches"][r["name"]],
            max_abs_err=state["max_abs_err"][r["name"]],
            ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=max(bound_b, bound_o),
            bound_by="bytes" if bound_b >= bound_o else "operations",
            library_ms=r["library_ms"]))
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
        print(f"== {name} took {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"total {time.perf_counter() - t_all:.1f} s")
    if ("timing" in state and "max_abs_err" in state
            and set(state.get("launches", ())) >= set(KERNELS)):
        line = kernels_line(state)
        if "prefill_timing" in state:
            pt = state["prefill_timing"]
            print("flash_attention prefill (1,32,128,128)/(1,2,161,128) "
                  f"causal bf16: {pt['ms']:.4f} ms, plain {pt['plain_ms']:.4f}"
                  f" ms, SDPA {pt['library_ms']:.4f} ms, bound "
                  f"{pt['bound_ms']:.5f} ms")
        if "train_fwd_timing" in state:
            pt = state["train_fwd_timing"]
            print("flash_attention train forward with lse (12,32,128,128)/"
                  f"(12,2,128,128) causal bf16: {pt['ms']:.4f} ms, plain "
                  f"{pt['plain_ms']:.4f} ms, SDPA {pt['library_ms']:.4f} ms, "
                  f"bound {pt['bound_ms']:.5f} ms")
        print("library time of both backward rows: one SDPA backward "
              "computing dQ, dK and dV together")
        for k in line["kernels"]:
            lib = ("none" if k["library_ms"] is None
                   else f"{k['library_ms']:.4f} ms")
            print(f"{k['name']} [{k['shape']}]: {k['ms']:.4f} ms, bound "
                  f"{k['bound_ms']:.5f} ms ({k['bound_by']}), plain "
                  f"{k['plain_ms']:.4f} ms, library {lib}, "
                  f"{k['launches']} launches on the main path")
        print("ported kernels: " + ", ".join(
            f"{k['name']} ({k['route']}, {k['source']}, replaces "
            f"{k['replaces']})" for k in line["kernels"]))
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

"""Drives the PyTorch/CUDA port on one CUDA card and checks it.

    python3 chip_smoke.py                    # every phase, one card
    python3 chip_smoke.py --phases build,kernels

Phases:
  build    builds every CUDA kernel from the sources in the checkout
           (one nvcc per source, all started together) and prints the card's
           name and power limit;
  kernels  holds each kernel against its plain PyTorch version on the card,
           at the serve shapes of full-width glm4-9b plus a sliding-window
           and an fp32 case;
  parity   glm4-9b smoke in fp32: the batched ServeSession against the
           port's sequential references, token and gate exact;
  main     the main path: ServeSession on full-width glm4-9b in bf16 (40
           layers, random weights from a seeded torch.Generator on the card),
           8 slots, 16 requests, under the select and the sticky policy; each
           run starts with every launch count at 0 and must launch both
           kernels;
  timing   each kernel, its plain version and (for attention) PyTorch's SDPA
           timed at the main path's shapes, beside the bound for the work.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Any failed check exits non-zero
and prints no result.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SRC = Path(__file__).resolve().parent / "src"
PHASES = ("build", "kernels", "parity", "main", "timing")

# NVIDIA H100 SXM data sheet (dense): HBM rate and peak rates by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# tolerances: fp32 kernels against fp32 plain versions (reassociation only);
# bf16 outputs compared in fp32 (the two sides round to bf16 at other points)
TOL_ATTN_F32 = 2e-5
TOL_ATTN_BF16 = 2e-2
TOL_LSE = 1e-4
TOL_H = 1e-4
GATE_MARGIN = 1e-3      # exits must agree wherever |H - tau| exceeds this

# the main path's shapes (glm4-9b, 8 slots, max_len 161)
SLOTS, REQUESTS, DECODE, MAX_LEN = 8, 16, 32, 161


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

    def attn_case(name, dtype, tol, *, B, Tq, causal, window=None,
                  kv_valid=None, lse=False, main=False):
        q, k, v = attn_inputs(gen, dtype, B=B, Tq=Tq)
        got = flash_attention(q, k, v, causal=causal, window=window,
                              kv_valid=kv_valid, return_lse=lse)
        want = flash_attention_ref(q, k, v, causal=causal, window=window,
                                   kv_valid=kv_valid, return_lse=lse)
        torch.cuda.synchronize()
        if lse:
            (got, got_lse), (want, want_lse) = got, want
            d_lse = (got_lse - want_lse).abs().max().item()
            check(d_lse <= TOL_LSE, f"attention {name} lse max|d|={d_lse:.3e} "
                                    f"<= {TOL_LSE:g}")
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


def profile_ticks(cfg, params, prompts, ticks: int = 5) -> None:
    """Device busy share over a few select decode ticks (a separate, traced
    run: the tick times above are measured untraced)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api.serve_session import ServeSession
    sess = ServeSession(cfg, params, tau=2.0, slots=SLOTS, max_len=MAX_LEN)
    for p in prompts[:SLOTS]:
        sess.submit(p, decode_tokens=DECODE)
    sess.step()                     # the admission tick, not traced
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            sess.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile select, {ticks} decode ticks traced: {wall_us / ticks / 1e3:.3f}"
          f" ms per tick, device busy {busy_us / ticks / 1e3:.3f} ms per tick "
          f"(idle share {1 - busy_us / wall_us:.3f}), "
          f"{len(kernels) / ticks:.0f} device kernels per tick")
    for name, us in top:
        print(f"  {us / ticks / 1e3:8.3f} ms/tick  {name[:90]}")


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
    state["timing"] = rows


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
    if "timing" in state and "launches" in state and "max_abs_err" in state:
        line = kernels_line(state)
        if "prefill_timing" in state:
            pt = state["prefill_timing"]
            print("flash_attention prefill (1,32,128,128)/(1,2,161,128) "
                  f"causal bf16: {pt['ms']:.4f} ms, plain {pt['plain_ms']:.4f}"
                  f" ms, SDPA {pt['library_ms']:.4f} ms, bound "
                  f"{pt['bound_ms']:.5f} ms")
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

"""The port's ServeSession against the JAX package's, on glm4-9b smoke.

Mirrors tests/test_serve_session.py: more requests than slots, a deeper
boundary, the sticky policy with mid-stream admission, a runtime tau
sweep.  The port's batched session must serve what the JAX session and the
JAX ``sequential_reference``/``sequential_sticky_reference`` serve: tokens
and gate decisions identical, entropies within 1e-4 (fp32 reassociation).
A token may differ only at a near tie of the logits that chose it (top-2
gap below 1e-5, asserted), after which the two streams are compared no
further.  Also here: the port imports no JAX, and its entry points refuse
to run without a device when CUDA is absent.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.api.serve_session import ServeSession as JaxServeSession
from repro.api.serve_session import (
    sequential_reference as jax_sequential_reference,
    sequential_sticky_reference as jax_sequential_sticky_reference,
    serve_step_config as jax_serve_step_config)
from repro.core.spmd import make_serve_step as jax_make_serve_step
from repro.models.backbone import backbone_forward as jax_backbone_forward
from repro.models.backbone import init_backbone as jax_init_backbone
from repro.models.backbone import init_cache as jax_init_cache
from repro_torch.api.serve_session import (ServeSession,
                                           sequential_reference,
                                           sequential_sticky_reference)
from repro_torch.convert import config_from_jax, params_from_jax

TAU = 2.0
ATOL_H = 1e-4
TIE_GAP = 1e-5
PORT_SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.fixture(scope="module")
def jcfg():
    return jconfigs.get("glm4-9b").smoke()


@pytest.fixture(scope="module")
def jparams(jcfg):
    return jax_init_backbone(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def cfg(jcfg):
    return config_from_jax(jcfg)


@pytest.fixture(scope="module")
def params(jparams, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                           device="cpu")


def _prompts(cfg, n, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(4, 10)))
            for _ in range(n)]


def _jax_logits_at(jcfg, jparams, prompt, ref, i, *, tau, boundary, max_len,
                   sticky_policy):
    """The JAX logits that chose ``ref.tokens[i]`` (prefill for i = 0, else
    decode tick i - 1 after ``ref``'s own history)."""
    cache = jax_init_cache(jcfg, 1, max_len, jcfg.dtype)
    out = jax_backbone_forward(jparams, jcfg, tokens=jnp.asarray(prompt)[None],
                               cache=cache, cache_len=jnp.zeros((), jnp.int32))
    logits, cache = out.logits[0, -1], out.cache
    sc, _, _ = jax_serve_step_config(jcfg, tau, boundary)
    step = jax.jit(jax_make_serve_step(sc, boundary=boundary))
    sticky = False
    for j in range(i):
        o = step(jparams, jnp.asarray([[ref.tokens[j]]], jnp.int32), cache,
                 jnp.asarray(len(prompt) + j, jnp.int32),
                 tau=jnp.float32(jnp.inf if sticky else tau))
        logits, cache = o["logits"][0, 0], o["cache"]
        sticky = sticky_policy and (sticky or ref.exited[j])
    return np.asarray(logits)


def _assert_same_stream(got, ref, logits_at, what):
    """Gate decisions and tokens identical, entropy within ATOL_H; a token
    mismatch must sit at a top-2 logit gap below TIE_GAP and ends the
    comparison."""
    assert len(got.tokens) == len(ref.tokens), what
    for i, (a, b) in enumerate(zip(got.tokens, ref.tokens)):
        if i:
            assert got.exited[i - 1] == ref.exited[i - 1], f"{what} gate {i}"
            assert abs(got.entropy[i - 1] - ref.entropy[i - 1]) <= ATOL_H, \
                f"{what} entropy {i}"
        if a != b:
            top2 = np.sort(logits_at(i))[-2:]
            assert top2[1] - top2[0] < TIE_GAP, \
                f"{what} token {i}: {a} vs {b} at top-2 gap {top2[1] - top2[0]}"
            return


def _serve_both(cfg, params, jcfg, jparams, prompts, decodes, *, tau,
                boundary, slots, max_len, policy="select"):
    sess = ServeSession(cfg, params, tau=tau, boundary=boundary, slots=slots,
                        max_len=max_len, exit_policy=policy, device="cpu")
    jsess = JaxServeSession(jcfg, jparams, tau=tau, boundary=boundary,
                            slots=slots, max_len=max_len, exit_policy=policy)
    for p, d in zip(prompts, decodes):
        sess.submit(p, decode_tokens=d)
        jsess.submit(p, decode_tokens=d)
    got = {r.rid: r for r in sess.run()}
    want = {r.rid: r for r in jsess.run()}
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    return sess, got, want


def _check_all(cfg, params, jcfg, jparams, prompts, decodes, got, want, *,
               tau, boundary, max_len, policy, jax_refs=2):
    """Port session vs JAX session and vs the port's sequential oracle for
    every request; vs the JAX sequential oracle for the first ``jax_refs``
    requests."""
    sticky = policy == "sticky"
    port_ref = sequential_sticky_reference if sticky else sequential_reference
    jax_ref = (jax_sequential_sticky_reference if sticky
               else jax_sequential_reference)
    for rid, (p, d) in enumerate(zip(prompts, decodes)):
        kw = dict(tau=tau, boundary=boundary, max_len=max_len)
        logits_at = lambda i, p=p, r=want[rid]: _jax_logits_at(  # noqa: E731
            jcfg, jparams, p, r, i, sticky_policy=sticky, **kw)
        _assert_same_stream(got[rid], want[rid], logits_at, f"request {rid}")
        mine = port_ref(cfg, params, p, d, device="cpu", **kw)
        assert (mine.tokens, mine.exited) == (got[rid].tokens,
                                              got[rid].exited), rid
        np.testing.assert_allclose(mine.entropy, got[rid].entropy, atol=ATOL_H)
        if rid < jax_refs:
            _assert_same_stream(mine, jax_ref(jcfg, jparams, p, d, **kw),
                                logits_at, f"sequential {rid}")


def test_batched_stream_matches_jax(cfg, params, jcfg, jparams):
    """More requests than slots, ragged prompts and budgets."""
    prompts = _prompts(cfg, 6)
    decodes = [5, 8, 3, 6, 4, 7]
    sess, got, want = _serve_both(cfg, params, jcfg, jparams, prompts,
                                  decodes, tau=TAU, boundary=0, slots=3,
                                  max_len=32)
    assert sess.stats.tokens == sum(decodes)
    _check_all(cfg, params, jcfg, jparams, prompts, decodes, got, want,
               tau=TAU, boundary=0, max_len=32, policy="select")


def test_deeper_boundary_matches_jax(cfg, params, jcfg, jparams):
    prompts = _prompts(cfg, 3, seed=2)
    sess, got, want = _serve_both(cfg, params, jcfg, jparams, prompts,
                                  [4] * 3, tau=TAU, boundary=1, slots=2,
                                  max_len=24)
    assert sess.cut == 2
    _check_all(cfg, params, jcfg, jparams, prompts, [4] * 3, got, want,
               tau=TAU, boundary=1, max_len=24, policy="select")


def test_sticky_with_mid_stream_admission_matches_jax(cfg, params, jcfg,
                                                       jparams):
    """A slot adopts, goes client-only, then is dragged back into full
    ticks when a new request joins: the sticky mask keeps it on the exit
    head in both packages."""
    prompts = _prompts(cfg, 4, seed=9)
    decodes = [8, 2, 6, 5]
    probe = jax_sequential_reference(jcfg, jparams, prompts[0], 6, tau=0.0,
                                     boundary=0, max_len=24)
    tau = float(np.median(probe.entropy))
    sess, got, want = _serve_both(cfg, params, jcfg, jparams, prompts,
                                  decodes, tau=tau, boundary=0, slots=2,
                                  max_len=24, policy="sticky")
    flags = [f for r in got.values() for f in r.exited]
    assert any(flags) and not all(flags)
    assert sess.stats.client_only_ticks > 0
    _check_all(cfg, params, jcfg, jparams, prompts, decodes, got, want,
               tau=tau, boundary=0, max_len=24, policy="sticky")


def test_runtime_tau_sweep_changes_gate(cfg, params):
    """tau is read every tick: one session serves an all-offload and an
    all-exit threshold, as the JAX session does."""
    prompt = _prompts(cfg, 1)[0]
    sess = ServeSession(cfg, params, tau=0.0, boundary=0, slots=2,
                        max_len=24, device="cpu")
    sess.submit(prompt, decode_tokens=4)
    sess.run()
    assert sess.stats.exited == 0
    sess.tau = 1.1 * float(np.log(cfg.vocab_size))
    sess.submit(prompt, decode_tokens=4)
    sess.run()
    assert sess.stats.exited == 4


def test_submit_and_policy_validation(cfg, params):
    sess = ServeSession(cfg, params, tau=TAU, slots=1, max_len=8,
                        device="cpu")
    with pytest.raises(ValueError, match="exceed the slot page"):
        sess.submit(np.zeros(6, np.int32), decode_tokens=4)
    with pytest.raises(ValueError, match="decode_tokens"):
        sess.submit(np.zeros(2, np.int32), decode_tokens=0)
    with pytest.raises(ValueError, match="exit_policy"):
        ServeSession(cfg, params, tau=TAU, exit_policy="eager", device="cpu")
    with pytest.raises(ValueError, match="boundary"):
        ServeSession(cfg, params, tau=TAU, boundary=2, device="cpu")


def test_jax_logits_helper_reproduces_the_chosen_tokens(cfg, jcfg, jparams):
    """The tie-gap helper above recomputes the logits that chose each JAX
    token (so a tolerated mismatch is measured at the right place)."""
    prompt = _prompts(cfg, 1, seed=3)[0]
    ref = jax_sequential_sticky_reference(jcfg, jparams, prompt, 3, tau=5.0,
                                          boundary=0, max_len=16)
    for i in range(4):
        logits = _jax_logits_at(jcfg, jparams, prompt, ref, i, tau=5.0,
                                boundary=0, max_len=16, sticky_policy=True)
        assert int(np.argmax(logits)) == ref.tokens[i]


# ---------------------------------------------------------------------------
# CLI, isolation, device rule
# ---------------------------------------------------------------------------


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(PORT_SRC.parent)
    return env


def test_serve_cli_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "3", "--slots", "2", "--prompt-len", "6",
         "--decode-tokens", "3", "--exit-policy", "sticky", "--tau", "9.0"],
        capture_output=True, text=True, env=_env(), timeout=120, check=True)
    lines = out.stdout.splitlines()
    assert lines[0].startswith("arch=glm4-9b-smoke tau=9.0 boundary=0")
    assert "served 3 requests / 9 decode tokens" in lines[1]
    assert lines[-1].startswith("client-only ticks:")


def test_port_imports_no_jax():
    """Every module of repro_torch imports in a fresh interpreter without
    pulling in jax."""
    mods = sorted(".".join(p.relative_to(PORT_SRC.parent).with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in PORT_SRC.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))")
    subprocess.run([sys.executable, "-c", code], env=_env(), timeout=120,
                   check=True, capture_output=True)


@pytest.mark.parametrize("path", sorted(
    p.relative_to(PORT_SRC.parents[1]).as_posix()
    for p in [*PORT_SRC.rglob("*.py"), PORT_SRC.parents[1] / "chip_smoke.py"]))
def test_no_jax_or_repro_import_statement(path):
    tree = ast.parse((PORT_SRC.parents[1] / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), (path, n)


def test_entry_points_refuse_to_run_without_cuda(cfg, params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeSession(cfg, params, tau=TAU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sequential_reference(cfg, params, [1, 2], 1, tau=TAU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({}, cfg)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "1"])

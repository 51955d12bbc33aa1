"""The port's fused cohort engine (``repro_torch/api/fused_engine.py``) on
the CPU: against the JAX package's fused engine, against the port's own
reference engine, and the behaviour the JAX package's
``tests/test_fused_engine.py`` and ``tests/test_staging.py`` hold its
engine to (population, spmd and checkpoint cases left out: those items are
not ported).  Also the pieces the engine stands on: the stacked Eq. (1)
against the JAX package's, the staging pipeline, and the kernel sites'
``vmap`` rules (``kernels/dispatch.py``) against a per-lane loop.

Both packages start from one state (the JAX session's round-0 state through
``repro_torch.convert.split_state_from_jax``) and draw the same numpy
batches.  Limits, as in ``tests/test_torch_session.py``: the MLP in fp32
1e-5 and the ResNet smoke in float64 1e-6 (the ReLU-kink reason given
there), every element of the trainables, the Adam moments and the
BatchNorm statistics, and the per-round losses.  Port fused against port
reference reads 0 on the MLP and on the float64 ResNet's trainables and
moments, 3e-16 in its BatchNorm statistics (``reading`` lines under
``pytest -s``).
"""
import dataclasses
import threading
import time
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import TrainSession as JaxSession
from repro.config import HeteroProfile as JHeteroProfile
from repro.config import OptimizerConfig as JOptimizerConfig
from repro.config import SplitEEConfig as JSplitEEConfig
from repro.configs import resnet18_cifar as jresnet18
from repro.core import aggregation as jaggregation
from repro.core import splitee as jsplitee
from repro.models import resnet as jresnet
from repro_torch.api import TrainSession, fused_engine
from repro_torch.config import HeteroProfile, OptimizerConfig, SplitEEConfig
from repro_torch.configs import resnet18_cifar
from repro_torch.convert import split_state_from_jax
from repro_torch.core import aggregation as taggregation
from repro_torch.core import splitee as tsplitee
from repro_torch.data.pipeline import ClientPartitioner
from repro_torch.data.staging import StagedChunkPipeline, StageStats
from repro_torch.data.synthetic import SyntheticImageDataset
from repro_torch.kernels import dispatch
from repro_torch.parity import dropped_lane, lane_loop_gaps
from repro_torch.tree import tree_leaves, tree_map

TOL = 1e-5
TOL_F64 = 1e-6
SPLITS = (3, 3, 4, 5)
ROUNDS, EPOCHS, BATCH = 3, 2, 16


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """At most two torch threads while this module runs: the suite runs
    files in parallel worker processes, and torch's CPU thread pools
    oversubscribed across workers stall at every parallel region (two
    processes of eight threads each ran the fused ResNet smoke ~100x
    slower than one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _blobs(n, d, classes, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, d)) * 2.0
    y = rng.integers(0, classes, n).astype(np.int32)
    x = (centers[y] + rng.normal(size=(n, d))).astype(np.float32)
    return x, y


class _JaxResNet(jsplitee.ResNetSplitModel):
    """The JAX adapter, its init drawn under ``jax.jit``."""

    def __post_init__(self):
        self.full_params, self.full_state = jax.jit(
            jresnet.init_resnet, static_argnums=1)(
                jax.random.PRNGKey(self.seed), self.cfg)


@pytest.fixture(scope="module")
def mlp():
    x, y = _blobs(400, 16, 3)
    return dict(jax=lambda: jsplitee.MLPSplitModel(16, 32, 3, num_layers=6),
                port=tsplitee.MLPSplitModel(16, 32, 3, num_layers=6,
                                            device="cpu"),
                data=ClientPartitioner(4).split(x, y), augment=None,
                lr=3e-3, x64=False, tol=TOL)


@pytest.fixture(scope="module")
def resnet():
    ds = SyntheticImageDataset(num_classes=10, image_size=32,
                               train_size=4 * 2 * BATCH, test_size=8, seed=0)
    wide = lambda xy: (xy[0].astype(np.float64), xy[1])  # noqa: E731
    return dict(
        jax=lambda: _JaxResNet(dataclasses.replace(jresnet18.smoke(),
                                                   dtype=jnp.float64)),
        port=tsplitee.ResNetSplitModel(dataclasses.replace(
            resnet18_cifar.smoke(), dtype=torch.float64), device="cpu"),
        data=[wide(p) for p in ClientPartitioner(4).split(*ds.train)],
        augment=ds.augment, lr=3e-5, x64=True, tol=TOL_F64)


def _configs(strategy, *, lr, x64=False, agg=2, clip=0.0):
    sdt = (jnp.float64, torch.float64) if x64 else (jnp.float32,
                                                    torch.float32)
    return ((JSplitEEConfig(profile=JHeteroProfile(SPLITS),
                            strategy=strategy, aggregate_every=agg),
             JOptimizerConfig(lr=lr, total_steps=20, state_dtype=sdt[0],
                              grad_clip=clip)),
            (SplitEEConfig(profile=HeteroProfile(SPLITS), strategy=strategy,
                           aggregate_every=agg),
             OptimizerConfig(lr=lr, total_steps=20, state_dtype=sdt[1],
                             grad_clip=clip)))


def _port(setup, strategy, engine, state=None, *, agg=2, clip=0.0,
          grad_mode="eq1"):
    _, (tsc, toc) = _configs(strategy, lr=setup["lr"], x64=setup["x64"],
                             agg=agg, clip=clip)
    return TrainSession(setup["port"], tsc, toc, setup["data"], BATCH,
                        engine=engine, augment=setup["augment"],
                        grad_mode=grad_mode, state=state)


def _flat(trees):
    leaves = [t.flatten().double() for t in tree_leaves(trees)]
    return torch.cat(leaves) if leaves else torch.zeros(0, dtype=torch.float64)


def _state_gaps(got, want):
    """The largest element gap of each part of two ``TrainState``s; Adam
    steps, rounds and batch cursors are asserted equal."""
    assert got.round == want.round
    assert got.batches_drawn == want.batches_drawn
    gaps = {}
    for name in ("clients", "servers"):
        g, w = getattr(got, name), getattr(want, name)
        for part in ("trainable", "state"):
            d = _flat([n[part] for n in g]) - _flat([n[part] for n in w])
            gaps[f"{name}.{part}"] = float(d.abs().max()) if d.numel() else 0.
    for name in ("client_opts", "server_opts"):
        g, w = getattr(got, name), getattr(want, name)
        assert [s.step for s in g] == [s.step for s in w]
        for part in ("m", "v"):
            d = _flat([getattr(s, part) for s in g]) - \
                _flat([getattr(s, part) for s in w])
            gaps[f"{name}.{part}"] = float(d.abs().max())
    return gaps


def _loss_gap(ha, hb):
    assert [a.round for a in ha] == [b.round for b in hb]
    return max(max(abs(a.client_loss - b.client_loss),
                   abs(a.server_loss - b.server_loss))
               for a, b in zip(ha, hb))


def _reading(what, gaps):
    print(f"reading {what}: " + ", ".join(f"{k} {v:.2e}"
                                          for k, v in gaps.items()))


def _gaps(a, b):
    gaps = _state_gaps(a.state, b.state)
    gaps["losses"] = _loss_gap(a.history, b.history)
    return gaps


# ---------------------------------------------------------------------------
# against the JAX package's fused engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,strategy", [
    ("mlp", "averaging"), ("mlp", "distributed"), ("resnet", "averaging")])
def test_fused_matches_jax_fused(model, strategy, request):
    setup = request.getfixturevalue(model)
    (jsc, joc), _ = _configs(strategy, lr=setup["lr"], x64=setup["x64"])
    with jax.enable_x64(setup["x64"]):
        js = JaxSession.from_config(setup["jax"](), jsc, joc, setup["data"],
                                    BATCH, engine="fused",
                                    augment=setup["augment"])
        if setup["x64"]:
            # jax.enable_x64 holds in this thread only: stage here, or the
            # producer thread would stage the float64 batches in float32
            js.engine.overlap_staging = False
            # the JAX ResNet's BatchNorm statistics start in fp32 and come
            # out of a float64 step in float64, which lax.scan's carry
            # refuses: start them in float64
            wide = lambda nets: tuple(  # noqa: E731
                {**n, "state": jax.tree.map(
                    lambda a: a.astype(jnp.float64), n["state"])}
                for n in nets)
            js.state = js.state.replace(clients=wide(js.state.clients),
                                        servers=wide(js.state.servers))
        start = split_state_from_jax(js.state, setup["port"])
        js.train(ROUNDS, EPOCHS)
        want = split_state_from_jax(js.state, setup["port"])
    ts = _port(setup, strategy, "fused", start)
    ts.train(ROUNDS, EPOCHS)
    gaps = _state_gaps(ts.state, want)
    gaps["losses"] = _loss_gap(ts.history, js.history)
    _reading(f"{model} {strategy} port fused vs JAX fused", gaps)
    assert max(gaps.values()) <= setup["tol"], gaps


# ---------------------------------------------------------------------------
# against the port's reference engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,strategy,agg", [
    ("mlp", "averaging", 1), ("mlp", "averaging", 2),
    ("mlp", "distributed", 1), ("resnet", "averaging", 1),
    ("resnet", "averaging", 2), ("resnet", "distributed", 1)])
def test_fused_matches_port_reference(model, strategy, agg, request):
    setup = request.getfixturevalue(model)
    ref = _port(setup, strategy, "reference", agg=agg)
    fus = _port(setup, strategy, "fused", ref.state, agg=agg)
    assert fus.engine.name == "fused"
    ref.train(ROUNDS, EPOCHS)
    fus.train(ROUNDS, EPOCHS)
    gaps = _gaps(fus, ref)
    _reading(f"{model} {strategy} aggregate_every={agg} fused vs reference",
             gaps)
    assert max(gaps.values()) <= setup["tol"], gaps
    if strategy == "averaging":
        # the last round (2) closes an Eq. (1) boundary for agg 1 only
        servers = [s["trainable"] for s in fus.state.servers]
        same = all(torch.equal(a, b) for s in servers[1:]
                   for a, b in zip(tree_leaves(servers[0]["head"]),
                                   tree_leaves(s["head"])))
        assert same == (agg == 1)


def test_planted_eq1_lane_fault_is_rejected(resnet):
    """One lane (client 0) left out of the stacked Eq. (1) mean: the
    comparison above must fail, in the servers only."""
    ref = _port(resnet, "averaging", "reference", agg=1)
    with dropped_lane():
        fus = _port(resnet, "averaging", "fused", ref.state, agg=1)
        fus.train(ROUNDS, EPOCHS)
    ref.train(ROUNDS, EPOCHS)
    gaps = _gaps(fus, ref)
    _reading("resnet averaging, client 0 left out of the stacked Eq. (1)",
             gaps)
    assert gaps["servers.trainable"] > 100 * resnet["tol"], gaps
    assert gaps["clients.trainable"] <= resnet["tol"], gaps


def test_stacked_aggregation_matches_jax():
    """JAX's stacked Eq. (1) against the port's, and both against the
    port's per-client loop, on random server nets of the MLP layout
    (cohorts cut at 1, 2 and 4 with 3, 1 and 2 lanes, clients interleaved
    across cohorts)."""
    rng = np.random.default_rng(0)
    splits = (1, 2, 1, 4, 1, 4)
    lanes = {li: [i for i, s in enumerate(splits) if s == li]
             for li in sorted(set(splits))}

    def net(li):
        keys = [f"layer{k}" for k in range(li + 1, 6)] + ["head"]
        return {k: {"w": rng.normal(size=(4, 3)).astype(np.float32),
                    "b": rng.normal(size=(3,)).astype(np.float32)}
                for k in keys}

    nets = [net(li) for li in splits]
    stack = lambda li, f: {k: {n: f([nets[i][k][n] for i in lanes[li]])  # noqa: E731
                               for n in ("w", "b")}
                           for k in nets[lanes[li][0]]}
    jgot = jaggregation.stacked_cross_layer_aggregate(
        {li: stack(li, jnp.stack) for li in lanes},
        {li: len(v) for li, v in lanes.items()})
    tstacked = {li: stack(li, lambda xs: torch.from_numpy(np.stack(xs)))
                for li in lanes}
    ptrs = [t.data_ptr() for t in tree_leaves(tstacked)]
    tgot = taggregation.stacked_cross_layer_aggregate(tstacked, lanes)
    assert [t.data_ptr() for t in tree_leaves(tgot)] == ptrs   # in place
    loop = taggregation.cross_layer_aggregate(
        [tree_map(torch.from_numpy, n) for n in nets], splits)
    for li, members in lanes.items():
        for j, i in enumerate(members):
            for k in nets[i]:
                for n in ("w", "b"):
                    got = tgot[li][k][n][j]
                    np.testing.assert_allclose(
                        got.numpy(), np.asarray(jgot[li][k][n][j]),
                        atol=1e-6, rtol=0)
                    assert torch.equal(got, loop[i][k][n]), (li, k, n)
    # layer2 is held only by the cut-1 clients: their mean, not the others'
    assert not torch.equal(tgot[1]["layer2"]["w"][0],
                           torch.from_numpy(nets[0]["layer2"]["w"]))


# ---------------------------------------------------------------------------
# behaviour (tests/test_fused_engine.py, tests/test_staging.py)
# ---------------------------------------------------------------------------


def _mlp_session(mlp, engine="fused", state=None, **kw):
    return _port(mlp, "averaging", engine, state, **kw)


def test_chunked_runs_are_bit_identical(mlp):
    one = _mlp_session(mlp)
    many = _mlp_session(mlp, state=one.state)
    one.engine.overlap_staging = many.engine.overlap_staging = False
    one.train(6, EPOCHS)
    many.train(6, EPOCHS, chunk_rounds=2)
    gaps = _gaps(many, one)
    assert max(gaps.values()) == 0.0, gaps
    assert one.engine.last_stage_stats["chunks"] == 1
    assert many.engine.last_stage_stats["chunks"] == 3
    # one host read of the losses per chunk
    assert (one.engine.last_host_syncs, many.engine.last_host_syncs) == (1, 3)


def test_overlap_on_off_bit_identical(mlp):
    """A multi-chunk plan whose boundaries straddle aggregate_every=2."""
    on = _mlp_session(mlp)
    off = _mlp_session(mlp, state=on.state)
    on.engine.overlap_staging, off.engine.overlap_staging = True, False
    on.train(6, EPOCHS, chunk_rounds=3)
    off.train(6, EPOCHS, chunk_rounds=3)
    gaps = _gaps(on, off)
    assert max(gaps.values()) == 0.0, gaps
    assert on.engine.last_stage_stats["overlap"] is True
    assert on.engine.last_stage_stats["chunks"] == 2
    assert off.engine.last_stage_stats["overlap"] is False
    assert off.engine.last_stage_stats["overlap_fraction"] == 0.0


@pytest.mark.parametrize("model", ["mlp", "resnet"])
def test_reference_to_fused_handoff(model, request):
    """k reference rounds, then k fused rounds from that state, equal 2k
    reference rounds."""
    setup = request.getfixturevalue(model)
    k = 2
    whole = _port(setup, "averaging", "reference")
    half = _port(setup, "averaging", "reference", whole.state)
    whole.train(2 * k, 1)
    half.train(k, 1)
    fus = _port(setup, "averaging", "fused", half.state)
    fus.history = list(half.history)
    fus.train(k, 1)
    gaps = _gaps(fus, whole)
    _reading(f"{model} {k} reference + {k} fused vs {2 * k} reference", gaps)
    assert max(gaps.values()) <= TOL, gaps


def test_per_lane_clipping_matches_reference(mlp):
    """grad_clip > 0: the fused engine clips each lane by its own norm, as
    the reference clips each client; a clip by the norm over all lanes
    would not match."""
    from repro_torch.optim import adam
    clip = 0.05
    ref = _mlp_session(mlp, "reference", clip=clip)
    start = ref.state
    fus = _mlp_session(mlp, state=start, clip=clip)
    ref.train(ROUNDS, EPOCHS)
    fus.train(ROUNDS, EPOCHS)
    gaps = _gaps(fus, ref)
    _reading(f"mlp grad_clip={clip} fused vs reference", gaps)
    assert max(gaps.values()) <= TOL, gaps
    # the clip was active and per lane matters: one norm over the lanes
    # moves the result
    wrong = _mlp_session(mlp, state=start, clip=clip)
    real = adam.lane_norms
    adam.lane_norms = lambda g: adam.global_norm(g).expand(  # noqa: E731
        next(x for x in tree_leaves(g) if x is not None).shape[0])
    try:
        wrong.train(ROUNDS, EPOCHS)
    finally:
        adam.lane_norms = real
    assert max(_gaps(wrong, ref).values()) > 10 * TOL


def test_sum_grad_mode_matches_eq1(mlp, resnet):
    for setup in (mlp, resnet):
        eq1 = _port(setup, "averaging", "fused")
        summ = _port(setup, "averaging", "fused", eq1.state, grad_mode="sum")
        eq1.train(ROUNDS, EPOCHS)
        summ.train(ROUNDS, EPOCHS)
        gaps = _gaps(summ, eq1)
        _reading("sum vs eq1", gaps)
        assert max(gaps.values()) <= setup["tol"], gaps


def test_run_leaves_its_input_alone_and_nets_share_no_storage(mlp):
    ts = _mlp_session(mlp)
    s0 = ts.state
    before = _flat([s0.clients, s0.servers,
                    [(s.m, s.v) for s in s0.client_opts + s0.server_opts]])
    s1, _ = ts.engine.run(s0, 2, local_epochs=2)
    after = _flat([s0.clients, s0.servers,
                   [(s.m, s.v) for s in s0.client_opts + s0.server_opts]])
    assert torch.equal(before, after)
    assert s0.round == 0 and s0.batches_drawn == (0,) * 4
    assert s1.round == 2 and s1.batches_drawn == (4,) * 4
    trees = [*s1.clients, *s1.servers,
             *[(s.m, s.v) for s in s1.client_opts + s1.server_opts]]
    ptrs = [t.untyped_storage().data_ptr() for tr in trees
            for t in tree_leaves(tr)]
    assert len(ptrs) == len(set(ptrs))


def test_fused_rejects_sequential_and_ragged_cohorts(mlp):
    with pytest.raises(ValueError, match="[Ss]equential"):
        _port(mlp, "sequential", "fused")
    x, y = _blobs(200, 16, 3)
    parts = [(x[:100], y[:100]), (x[100:140], y[100:140])]   # 100 vs 40
    cfg = SplitEEConfig(profile=HeteroProfile((2, 2)), strategy="averaging")
    model = tsplitee.MLPSplitModel(16, 32, 3, num_layers=4, device="cpu")
    with pytest.raises(ValueError, match="batch"):
        TrainSession.from_config(model, cfg, OptimizerConfig(), parts,
                                 batch_size=64, engine="fused")
    TrainSession.from_config(model, cfg, OptimizerConfig(), parts,
                             batch_size=64, engine="reference").train(1)


def test_reference_rejects_sum_and_unknown_grad_modes(mlp):
    with pytest.raises(ValueError, match="eq1"):
        _mlp_session(mlp, "reference", grad_mode="sum")
    with pytest.raises(ValueError, match="unknown grad_mode"):
        _mlp_session(mlp, grad_mode="nope")
    # auto takes the reference engine for Sequential, which rejects sum
    with pytest.raises(ValueError, match="eq1"):
        _port(mlp, "sequential", "auto", grad_mode="sum")


def test_auto_chunk_rounds_respects_stage_budget(mlp):
    eng = _mlp_session(mlp).engine
    per_round = eng._round_stage_bytes(local_epochs=1)
    # 4 clients x (16 x 16 fp32 x + 16 int32 y)
    assert per_round == 4 * (BATCH * 16 * 4 + BATCH * 4)
    eng.stage_budget_bytes = int(2.5 * per_round)
    assert eng._auto_chunk_rounds(6, 1) == 2
    assert eng._auto_chunk_rounds(1, 1) == 1
    eng.stage_budget_bytes = per_round - 1
    assert eng._auto_chunk_rounds(6, 1) == 1
    eng.stage_budget_bytes = 100 * per_round
    assert eng._auto_chunk_rounds(6, 1) == 6
    assert eng._auto_chunk_rounds(6, 2) == 6


def test_auto_plan_subdivides_for_the_pipeline(mlp):
    eng = _mlp_session(mlp).engine
    assert eng._chunk_plan(8, 0, 1, overlap=True) == [2, 2, 2, 2]
    assert eng._chunk_plan(8, 0, 1, overlap=False) == [8]
    assert eng._chunk_plan(8, 3, 1, overlap=True) == [3, 3, 2]
    assert eng._chunk_plan(1, 0, 1, overlap=True) == [1]
    eng.stage_budget_bytes = eng._round_stage_bytes(1) * 6
    assert eng._chunk_plan(8, 0, 1, overlap=True) == [3, 3, 2]
    assert eng._chunk_plan(8, 0, 1, overlap=False) == [6, 2]


def test_staging_knobs_and_their_errors(mlp, monkeypatch):
    ts = _mlp_session(mlp)
    eng = ts.engine
    for bad in (0, -1):
        eng.stage_budget_bytes = bad
        with pytest.raises(ValueError, match="stage_budget_bytes"):
            eng._auto_chunk_rounds(4, 1)
    eng.stage_budget_bytes = type(eng).stage_budget_bytes
    for bad in ("0", "-5", "lots"):
        monkeypatch.setenv("REPRO_STAGE_BUDGET_MB", bad)
        with pytest.raises(ValueError, match="REPRO_STAGE_BUDGET_MB"):
            eng._auto_chunk_rounds(4, 1)
    monkeypatch.setenv("REPRO_STAGE_BUDGET_MB", "1")
    assert eng._auto_chunk_rounds(10 ** 6, 1) == (1 << 20) // \
        eng._round_stage_bytes(1)
    monkeypatch.delenv("REPRO_STAGE_BUDGET_MB")
    for val, on in (("0", False), ("off", False), ("1", True)):
        monkeypatch.setenv("REPRO_OVERLAP_STAGING", val)
        assert eng._overlap_enabled() is on
    monkeypatch.delenv("REPRO_OVERLAP_STAGING")
    eng.overlap_staging = False
    assert eng._overlap_enabled() is False
    ts.train(2)
    assert eng.last_stage_stats["overlap"] is False


# ---------------------------------------------------------------------------
# the staging pipeline (a copy of the JAX package's)
# ---------------------------------------------------------------------------


def test_pipeline_preserves_plan_order():
    staged = []
    plan = [3, 1, 4, 1, 5]
    p = StagedChunkPipeline(lambda n: staged.append(n) or ("chunk", n), plan)
    try:
        got = []
        for _ in plan:
            got.append(p.get())
            p.release()
        assert got == [("chunk", n) for n in plan]
        assert staged == plan
        assert p.stats.chunks == len(plan)
    finally:
        p.close()


def test_pipeline_bounds_inflight_chunks_to_depth():
    inflight, live, lock = [], [0], threading.Lock()

    def stage(n):
        with lock:
            live[0] += 1
            inflight.append(live[0])
        return n

    p = StagedChunkPipeline(stage, [1] * 8, depth=2)
    try:
        for _ in range(8):
            p.get()
            time.sleep(0.01)
            with lock:
                live[0] -= 1
            p.release()
        assert max(inflight) <= 2
    finally:
        p.close()


def test_pipeline_errors_close_and_serial_mode():
    with pytest.raises(ValueError, match="depth"):
        StagedChunkPipeline(lambda n: n, [1, 2], depth=1)

    def stage(n):
        if n == 2:
            raise RuntimeError("disk on fire")
        return n

    p = StagedChunkPipeline(stage, [1, 2, 3])
    assert p.get() == 1
    p.release()
    with pytest.raises(RuntimeError, match="disk on fire"):
        p.get()
    p.close()
    p.close()
    p = StagedChunkPipeline(lambda n: n, [1] * 10, depth=2)
    assert p.get() == 1
    p.close()
    assert not p._thread.is_alive()
    staged = []
    p = StagedChunkPipeline(lambda n: staged.append(n) or n, [7, 8],
                            overlap=False)
    assert staged == []
    assert p.get() == 7 and staged == [7]
    p.release()
    assert p.get() == 8
    p.close()
    assert p.stats.overlap_fraction == 0.0
    assert p.stats.wait_s == p.stats.stage_s
    s = StageStats(chunks=3, stage_s=2.0, wait_s=0.5)
    assert s.overlap_fraction == pytest.approx(0.75)
    assert StageStats().overlap_fraction == 0.0
    assert StageStats(stage_s=1.0, wait_s=5.0).overlap_fraction == 0.0


# ---------------------------------------------------------------------------
# the kernel sites under lanes (CudaBackend on CPU tensors: the plain
# versions behind the same Functions and vmap rules)
# ---------------------------------------------------------------------------

LANES = 3


def _attn_inputs(gen):
    q = torch.randn(LANES, 2, 10, 4, 16, generator=gen)
    k = torch.randn(LANES, 2, 10, 2, 16, generator=gen)
    v = torch.randn(LANES, 2, 10, 2, 16, generator=gen)
    return q, k, v


def _wkv_inputs(gen):
    r, k, v = (torch.randn(LANES, 2, 12, 3, 8, generator=gen)
               for _ in range(3))
    log_w = -torch.rand(LANES, 2, 12, 3, 8, generator=gen) * 2
    u = torch.randn(LANES, 3, 8, generator=gen)     # one bonus a lane
    return r, k, v, log_w, u


def _lane_gaps(site, inputs):
    """The largest gap of the outputs and the gradients of ``site`` vmapped
    over the lanes against a per-lane loop (``parity.lane_loop_gaps``)."""
    r = lane_loop_gaps(site, inputs)
    return max(r["out"], r["grad"])


def _attention(q, k, v):
    return dispatch.get_backend("auto").attention(q, k, v, causal=True,
                                                  window=7)


def _wkv(r, k, v, log_w, u):
    return dispatch.get_backend("auto").wkv(r, k, v, log_w, u, chunk=4)


@contextmanager
def _spy(module, name, seen):
    real = getattr(module, name)

    def spy(*args, **kw):
        seen.append([(tuple(a.shape),
                      torch._C._functorch.is_batchedtensor(a))
                     for a in args if isinstance(a, torch.Tensor)])
        return real(*args, **kw)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


def test_attention_vmap_rule_equals_a_per_lane_loop():
    """Lanes fold into the batch: one forward and one backward call for
    all lanes, on plain tensors of shape (lanes * B, H, T, D)."""
    inputs = _attn_inputs(torch.Generator().manual_seed(0))
    fwd, bwd = [], []
    with _spy(dispatch, "flash_attention", fwd), \
            _spy(dispatch, "flash_attention_bwd", bwd):
        assert _lane_gaps(_attention, inputs) == 0.0
    assert fwd[0] == [((LANES * 2, 4, 10, 16), False),
                      ((LANES * 2, 2, 10, 16), False),
                      ((LANES * 2, 2, 10, 16), False)]
    assert len(bwd) == 1 + LANES            # the vmapped run, then the loop
    assert all(not batched for _, batched in bwd[0])
    assert bwd[0][0] == ((LANES * 2, 4, 10, 16), False)


def test_cross_attention_vmap_rule_equals_a_per_lane_loop():
    """Cross attention's launch (Tq 6 against Tk 11, non-causal) under the
    same rule: lanes fold into the batch, one forward and one backward
    call on plain tensors, equal to a per-lane loop."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(LANES, 2, 6, 4, 16, generator=gen)
    k, v = (torch.randn(LANES, 2, 11, 4, 16, generator=gen)
            for _ in range(2))
    fwd, bwd = [], []
    with _spy(dispatch, "flash_attention", fwd), \
            _spy(dispatch, "flash_attention_bwd", bwd):
        assert _lane_gaps(lambda *a: dispatch.get_backend("auto").attention(
            *a, causal=False), (q, k, v)) == 0.0
    assert fwd[0] == [((LANES * 2, 4, 6, 16), False),
                      ((LANES * 2, 4, 11, 16), False),
                      ((LANES * 2, 4, 11, 16), False)]
    assert len(bwd) == 1 + LANES
    assert all(not batched for _, batched in bwd[0])


def test_wkv_vmap_rule_equals_a_per_lane_loop():
    """Lanes fold into the heads (each lane's own u): one forward and one
    backward call on plain (B, T, lanes * H, K) tensors."""
    inputs = _wkv_inputs(torch.Generator().manual_seed(0))
    fwd, bwd = [], []
    with _spy(dispatch, "rwkv_wkv_fwd", fwd), \
            _spy(dispatch, "rwkv_wkv_bwd", bwd):
        assert _lane_gaps(_wkv, inputs) == 0.0
    assert fwd[0][0] == ((2, 12, LANES * 3, 8), False)
    assert fwd[0][4] == ((LANES * 3, 8), False)
    assert len(bwd) == 1 + LANES
    assert all(not batched for _, batched in bwd[0])


class _WkvLanesIntoBatch(dispatch.WkvFn):
    """A planted mis-fold: lanes into the batch with lane 0's u for all."""

    @staticmethod
    def vmap(info, in_dims, r, k, v, log_w, u, chunk):
        n = info.batch_size
        fold = lambda t: t.reshape(n * t.shape[1], *t.shape[2:])  # noqa: E731
        y, sT, s0 = dispatch.WkvFn.apply(fold(r), fold(k), fold(v),
                                         fold(log_w), u[0], chunk)
        return ((y.view(n, -1, *y.shape[1:]), sT.view(n, -1, *sT.shape[1:]),
                 s0), (0, 0, None))


def test_planted_wkv_mis_fold_is_rejected(monkeypatch):
    inputs = _wkv_inputs(torch.Generator().manual_seed(0))
    monkeypatch.setattr(dispatch, "WkvFn", _WkvLanesIntoBatch)
    gap = _lane_gaps(_wkv, inputs)
    assert gap > 1e-2, gap


def test_cohort_step_runs_the_sites_through_their_functions():
    """Under the fused engine's lanes the training sites route to the
    Functions (a batched operand reports requires_grad False, so routing
    on requires_grad alone would skip them) and the backward runs once per
    cohort step on folded plain tensors."""
    from repro_torch.configs import glm4_9b, rwkv6_3b
    from repro_torch.core.backbone_splitee import BackboneSplitModel
    from repro_torch.core.spmd import make_cohort_train_step
    from repro_torch.optim import adam_init
    for cfg, li, name in ((glm4_9b.smoke(), 1, "flash_attention_bwd"),
                          (rwkv6_3b.smoke(), 2, "rwkv_wkv_bwd")):
        model = BackboneSplitModel(cfg, device="cpu")
        c, s = model.make_client(li), model.make_server(li)
        opt = lambda n: fused_engine._stack_opts(  # noqa: E731
            [adam_init(n["trainable"], OptimizerConfig())] * 2)
        (c, co), (s, so) = ((model.stack_clients([n] * 2), opt(n))
                            for n in (c, s))
        x = torch.randint(0, cfg.vocab_size, (2, 3, 8))
        y = torch.randint(0, 8, (2, 3))
        seen = []
        with _spy(dispatch, name, seen):
            out = make_cohort_train_step(model, OptimizerConfig(), li)(
                c, co, s, so, x, y, 1e-3, 1e-3)
        per_layer = cfg.num_layers          # client and server layers
        assert len(seen) == per_layer, (name, len(seen))
        assert not any(b for call in seen for _, b in call)
        assert out[4].shape == out[5].shape == (2,)

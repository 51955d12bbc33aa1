"""The port's ``TrainSession`` (reference engine) against the JAX package's
``TrainSession(engine="reference")``, on the CPU: the paper's loop on the
MLP adapter and on the ResNet smoke (``resnet18_cifar.smoke()``, 32x32,
width 0.125, the paper's augmentation), under averaging, sequential and
distributed, with ``local_epochs=2`` and ``aggregate_every=2`` over 3
rounds; then evaluation (Alg. 3), engine resolution, the protocol, and
what the port must keep that JAX gets for free (``run`` leaves its input
alone; no two nets share storage, since the port's Adam is in place).

The ResNet's Sequential run and its planted fault live in
tests/test_torch_session_resnet_sequential.py, whose module fixture trains
on a worker of its own; it imports this module's setups and checks.

Both sessions start from one state: the JAX session's round-0 state,
converted by ``repro_torch.convert.split_state_from_jax`` and handed to
the port through ``state=``; both draw the same numpy batches.

The MLP runs in fp32 at lr 3e-3.  The ResNet smoke runs in float64 on both
sides (the JAX side under ``jax.enable_x64``) at lr 3e-5, because in fp32
the two packages cannot agree over 3 rounds: a ReLU input within fp32
rounding of 0 lands on either side of the kink depending on the order of
a sum, and the gradient jumps there (``tests/test_torch_resnet.py``
``test_jax_fp32_gradient_gap_is_a_relu_kink``: one layer-4 input at -2e-7
in float64 is +1.1e-6 in the JAX fp32 run, and that leaf's gradient moves
by 2.2e-3 of a scale 0.075).  The loop amplifies such flips: at lr 3e-3
even both packages in float64 (cross-entropy in fp32 on both sides, as
written) drift to 1.3e-3 in the trainables after 3 rounds, and at lr 1e-4
Sequential's shared server (24 steps a round) still reaches 1.3e-4 in
Adam's m.  At lr 3e-5 every strategy agrees to 1.8e-7.

Tolerances (``docs/ENGINES.md`` sets 1e-5 for engines of one package):
  * the MLP (fp32): per-round losses, trainables, Adam moments (m, v) and
    BatchNorm statistics 1e-5, every element;
  * the ResNet (float64): the same at 1e-6, every element.  Readings (the
    ``reading`` lines under ``pytest -s``): 1.8e-7 at most in the
    trainables; with the server LR planted 5% too large, 1.0e-5 in
    Sequential's server trainables alone (``test_session_parity_rejects_a_
    planted_fault``);
  * Adam steps, rounds and batch cursors exact;
  * evaluation: accuracies and client ratios equal, mean entropies 1e-5.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

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
from repro.core import inference as jinference
from repro.core import splitee as jsplitee
from repro.models import resnet as jresnet
from repro_torch import api as tapi
from repro_torch.api import TrainSession
from repro_torch.config import HeteroProfile, OptimizerConfig, SplitEEConfig
from repro_torch.configs import resnet18_cifar
from repro_torch.convert import split_state_from_jax
from repro_torch.core import inference as tinference
from repro_torch.core import splitee as tsplitee
from repro_torch.data.pipeline import ClientPartitioner
from repro_torch.data.synthetic import SyntheticImageDataset
from repro_torch.tree import tree_leaves

TOL = 1e-5
TOL_F64 = 1e-6          # the float64 ResNet's states and losses
SPLITS = (3, 3, 4, 5)
ROUNDS, EPOCHS, AGG_EVERY, BATCH = 3, 2, 2, 16
STRATEGIES = ("averaging", "sequential", "distributed")
TAUS = (0.0, 0.5, 1.5, 1e3)
EVAL_BATCH = 32


def _blobs(n, d, classes, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, d)) * 2.0
    y = rng.integers(0, classes, n).astype(np.int32)
    x = (centers[y] + rng.normal(size=(n, d))).astype(np.float32)
    return x, y


class _JaxResNet(jsplitee.ResNetSplitModel):
    """The JAX adapter, its init drawn under ``jax.jit`` (the same bits as
    the eager draws, in a fraction of the CPU time)."""

    def __post_init__(self):
        self.full_params, self.full_state = jax.jit(
            jresnet.init_resnet, static_argnums=1)(
                jax.random.PRNGKey(self.seed), self.cfg)


def mlp_setup():
    """The MLP adapters (fp32, lr 3e-3), their client shards and test set."""
    x, y = _blobs(400, 16, 3)
    return dict(jax=lambda: jsplitee.MLPSplitModel(16, 32, 3, num_layers=6),
                port=tsplitee.MLPSplitModel(16, 32, 3, num_layers=6,
                                            device="cpu"),
                data=ClientPartitioner(4).split(x, y), augment=None,
                test=_blobs(75, 16, 3, seed=1), lr=3e-3, x64=False,
                tol=TOL)


def resnet_setup():
    """The ResNet smoke adapters (float64 on both sides, lr 3e-5), their
    client shards, augmentation and test set."""
    ds = SyntheticImageDataset(num_classes=10, image_size=32,
                               train_size=4 * 2 * BATCH, test_size=75,
                               seed=0)
    wide = lambda xy: (xy[0].astype(np.float64), xy[1])  # noqa: E731
    return dict(
        jax=lambda: _JaxResNet(dataclasses.replace(jresnet18.smoke(),
                                                   dtype=jnp.float64)),
        port=tsplitee.ResNetSplitModel(dataclasses.replace(
            resnet18_cifar.smoke(), dtype=torch.float64), device="cpu"),
        data=[wide(p) for p in ClientPartitioner(4).split(*ds.train)],
        augment=ds.augment, test=wide(ds.test), lr=3e-5, x64=True,
        tol=TOL_F64)


def _configs(strategy, splits=SPLITS, lr=3e-3, x64=False):
    jcfg = (JSplitEEConfig(profile=JHeteroProfile(splits), strategy=strategy,
                           aggregate_every=AGG_EVERY),
            JOptimizerConfig(lr=lr, total_steps=20, state_dtype=(
                jnp.float64 if x64 else jnp.float32)))
    tcfg = (SplitEEConfig(profile=HeteroProfile(splits), strategy=strategy,
                          aggregate_every=AGG_EVERY),
            OptimizerConfig(lr=lr, total_steps=20, state_dtype=(
                torch.float64 if x64 else torch.float32)))
    return jcfg, tcfg


def _trained(setup, strategy, jax_model, compiled):
    """A JAX reference session and the port's, from the JAX round-0 state,
    trained for ROUNDS rounds; the JAX session's evaluations.  The JAX
    sessions of one model share ``compiled``, their engines' and
    evaluators' jitted functions: those depend on the model, the optimizer
    config and the cut only, not on the strategy."""
    (jsc, joc), (tsc, toc) = _configs(strategy, lr=setup["lr"],
                                      x64=setup["x64"])
    x, y = setup["test"]
    with jax.enable_x64(setup["x64"]):
        js = JaxSession.from_config(jax_model, jsc, joc, setup["data"],
                                    BATCH, engine="reference",
                                    augment=setup["augment"])
        js.engine._cstep, js.engine._sstep, js._evaluator._fns = compiled
        start = split_state_from_jax(js.state, setup["port"])
    ts = TrainSession(setup["port"], tsc, toc, setup["data"], BATCH,
                      engine="reference", augment=setup["augment"],
                      state=start)

    def jax_run():
        with jax.enable_x64(setup["x64"]):        # a thread's own setting
            return js.run(ROUNDS, EPOCHS)

    # the two sessions share nothing: the JAX one (compiling for most of
    # its time) in a thread beside the port's
    with ThreadPoolExecutor(1) as pool:
        jax_history = pool.submit(jax_run)
        th = ts.run(ROUNDS, EPOCHS)
        jh = jax_history.result()
    with jax.enable_x64(setup["x64"]):
        want = split_state_from_jax(js.state, setup["port"])
        evals = {"plain": js.evaluate(x, y, batch_size=EVAL_BATCH)}
        if strategy != "distributed":
            for tau in TAUS:
                evals[tau] = js.evaluate_adaptive(x, y, tau,
                                                  batch_size=EVAL_BATCH)
    return dict(start=start, jax_state=want, port=ts, jax_history=jh,
                port_history=th, jax_evals=evals, test=(x, y))


def _flat(trees):
    return torch.cat([t.flatten().double() for t in tree_leaves(trees)])


def _flat_or_empty(trees):
    leaves = list(tree_leaves(trees))
    return _flat(leaves) if leaves else torch.zeros(0, dtype=torch.float64)


def _state_gaps(got, want):
    """The largest element gap of each part of two ``TrainState``s; Adam
    steps, rounds and batch cursors are asserted equal."""
    assert got.round == want.round
    assert got.batches_drawn == want.batches_drawn
    gaps = {}
    for name in ("clients", "servers"):
        g, w = getattr(got, name), getattr(want, name)
        gaps[name] = float((_flat([n["trainable"] for n in g])
                            - _flat([n["trainable"] for n in w])).abs().max())
        bn_g = _flat_or_empty([n["state"] for n in g])
        bn_w = _flat_or_empty([n["state"] for n in w])
        assert bn_g.shape == bn_w.shape
        gaps[f"{name} BN"] = (float((bn_g - bn_w).abs().max())
                              if bn_w.numel() else 0.0)
    for name in ("client_opts", "server_opts"):
        g, w = getattr(got, name), getattr(want, name)
        assert [s.step for s in g] == [s.step for s in w]
        for part in ("m", "v"):
            d = _flat([getattr(s, part) for s in g]) - \
                _flat([getattr(s, part) for s in w])
            gaps[f"{name}.{part}"] = float(d.abs().max())
    return gaps


def _reading(what, gaps):
    print(f"reading {what}: " + ", ".join(f"{k} {v:.2e}"
                                          for k, v in gaps.items()))


def train_runs(setups: dict, cases) -> dict:
    """Per (model, strategy) of ``cases``: both sessions trained once,
    the JAX sessions of one model sharing their jitted functions."""
    out = {}
    for name in dict.fromkeys(m for m, _ in cases):
        setup = setups[name]
        with jax.enable_x64(setup["x64"]):
            jax_model = setup["jax"]()
        compiled = ({}, {}, {})
        for strategy in (s for m, s in cases if m == name):
            out[name, strategy] = _trained(setup, strategy, jax_model,
                                           compiled)
    return out


def check_train_session(run, model, strategy, tol):
    """The port's trained session against JAX's: states, Adam moments and
    per-round losses within ``tol``, steps and cursors equal."""
    jh, th, ts = run["jax_history"], run["port_history"], run["port"]
    assert len(jh) == len(th) == ROUNDS
    assert [a.round for a in jh] == [b.round for b in th]
    gaps = _state_gaps(ts.state, run["jax_state"])
    gaps["losses"] = max(max(abs(a.client_loss - b.client_loss),
                             abs(a.server_loss - b.server_loss))
                         for a, b in zip(jh, th))
    _reading(f"{model} {strategy}", gaps)
    assert max(gaps.values()) <= tol, gaps
    assert ts.round == ROUNDS
    assert len(ts.state.servers) == (1 if strategy == "sequential" else 4)


def check_evaluation(run, strategy):
    """The port's evaluations of a trained session against JAX's: 75 test
    samples at batch 32 (the tail batch of 11 is scored)."""
    ts, want, (x, y) = run["port"], run["jax_evals"], run["test"]
    assert ts.evaluate(x, y, batch_size=EVAL_BATCH) == want["plain"]
    if strategy == "distributed":
        return
    for tau in TAUS:
        got = ts.evaluate_adaptive(x, y, tau, batch_size=EVAL_BATCH)
        assert got["acc"] == want[tau]["acc"]
        assert got["client_ratio"] == want[tau]["client_ratio"]
        np.testing.assert_allclose(got["mean_entropy"],
                                   want[tau]["mean_entropy"], atol=TOL,
                                   rtol=0)
    assert ts.evaluate_adaptive(x, y, 0.0)["client_ratio"] == [0.0] * 4
    assert ts.evaluate_adaptive(x, y, 1e3)["client_ratio"] == [1.0] * 4




# every (model, strategy) pair but the ResNet's Sequential run, which
# tests/test_torch_session_resnet_sequential.py trains on a worker of its own
CASES = tuple((m, s) for m in ("mlp", "resnet") for s in STRATEGIES
              if (m, s) != ("resnet", "sequential"))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """At most two torch threads while this module runs (as
    tests/test_torch_fused.py): the suite runs files in parallel worker
    processes, and torch's CPU thread pools oversubscribed across workers
    stall at every parallel region; the float64 ResNet runs here are the
    suite's longest."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mlp():
    return mlp_setup()


@pytest.fixture(scope="module")
def resnet():
    return resnet_setup()


@pytest.fixture(scope="module")
def trained(mlp, resnet):
    """Per (model, strategy) of CASES: both sessions trained once for the
    module."""
    return train_runs({"mlp": mlp, "resnet": resnet}, CASES)


@pytest.mark.parametrize("model,strategy", CASES)
def test_train_session_matches_jax_reference(trained, model, strategy,
                                             request):
    check_train_session(trained[model, strategy], model, strategy,
                        request.getfixturevalue(model)["tol"])


@pytest.mark.parametrize("model,strategy", CASES)
def test_evaluation_matches_jax(trained, model, strategy):
    check_evaluation(trained[model, strategy], strategy)


def test_evaluation_is_batch_size_invariant(trained):
    run = trained["resnet", "averaging"]
    ts, (x, y) = run["port"], run["test"]
    whole = ts.evaluate_adaptive(x, y, 1.5, batch_size=512)
    for bs in (1, 7, 32, 75):
        got = ts.evaluate_adaptive(x, y, 1.5, batch_size=bs)
        assert got["acc"] == whole["acc"]
        assert got["client_ratio"] == whole["client_ratio"]
        np.testing.assert_allclose(got["mean_entropy"],
                                   whole["mean_entropy"], atol=TOL, rtol=0)
    assert ts.evaluate(x, y, batch_size=7) == ts.evaluate(x, y)


def test_pad_batches_matches_jax():
    from repro.api import pad_batches as jpad
    x, y = _blobs(23, 4, 3)
    for bs in (1, 5, 23, 64):
        for g, w in zip(tapi.pad_batches(x, y, bs), jpad(x, y, bs)):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="empty"):
        tapi.pad_batches(x[:0], y[:0], 4)


def test_inference_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(37, 10)) * 3).astype(np.float32)
    for tau in (0.5, 1.2, 2.5):
        got = tinference.exit_decision(torch.from_numpy(logits), tau)
        want = jinference.exit_decision(logits, tau)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tinference.paper_tau_to_entropy(1.5) == \
        jinference.paper_tau_to_entropy(1.5)
    w = rng.normal(size=(10, 10)).astype(np.float32)
    for tau in (0.5, 2.0):
        jeng = jinference.AdaptiveInferenceEngine(
            lambda x: (x, x), lambda x: x @ w, tau, pad_bucket=8)
        teng = tinference.AdaptiveInferenceEngine(
            lambda x: (x, x), lambda x: x @ torch.from_numpy(w), tau,
            pad_bucket=8)
        for chunk in (logits[:20], logits[20:]):
            np.testing.assert_array_equal(
                teng(torch.from_numpy(chunk)).numpy(), jeng(chunk))
        assert teng.stats.total == jeng.stats.total
        assert teng.stats.exited == jeng.stats.exited
        assert abs(teng.stats.mean_entropy - jeng.stats.mean_entropy) <= TOL


# ---------------------------------------------------------------------------
# what the port keeps by hand
# ---------------------------------------------------------------------------


def _storages(tree):
    return [t.untyped_storage().data_ptr() for t in tree_leaves(tree)]


def _all_storages(state):
    trees = [*state.clients, *state.servers,
             *[(s.m, s.v) for s in state.client_opts],
             *[(s.m, s.v) for s in state.server_opts]]
    return [p for t in trees for p in _storages(t)]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_run_leaves_its_input_alone_and_nets_share_no_storage(mlp, strategy):
    _, (tsc, toc) = _configs(strategy)
    ts = TrainSession(mlp["port"], tsc, toc, mlp["data"], BATCH,
                      engine="reference")
    s0 = ts.state
    ptrs = _all_storages(s0)
    assert len(ptrs) == len(set(ptrs))
    before = _flat([s0.clients, s0.servers,
                    [(s.m, s.v) for s in s0.client_opts + s0.server_opts]])
    steps = [s.step for s in s0.client_opts + s0.server_opts]
    s1, metrics = ts.engine.run(s0, 2, local_epochs=2)
    after = _flat([s0.clients, s0.servers,
                   [(s.m, s.v) for s in s0.client_opts + s0.server_opts]])
    assert torch.equal(before, after)
    assert [s.step for s in s0.client_opts + s0.server_opts] == steps
    assert s0.round == 0 and s0.batches_drawn == (0,) * 4
    assert s1.round == 2 and s1.batches_drawn == (4,) * 4
    # after training, and after the Eq. (1) boundary (round 2), every net
    # and moment still owns its tensors, none shared with the input
    ptrs1 = _all_storages(s1)
    assert len(ptrs1) == len(set(ptrs1))
    assert not set(ptrs1) & set(ptrs)
    # the same rounds again from the same input give the same state
    s2, again = ts.engine.run(s0, 2, local_epochs=2)
    assert [m.client_loss for m in metrics] == [m.client_loss for m in again]
    assert torch.equal(_flat([s1.clients, s1.servers]),
                       _flat([s2.clients, s2.servers]))


def test_averaging_synchronises_common_layers(trained):
    """After an Eq. (1) boundary every server holding a layer holds the
    same values; distributed never aggregates."""
    for strategy, synced in (("averaging", True), ("distributed", False)):
        ts = trained["resnet", strategy]["port"]
        if strategy == "averaging":   # rounds 0-2: the boundary is round 1
            ts = TrainSession(ts.model, ts.ctx.cfg, ts.ctx.opt_cfg,
                              ts.ctx.client_data, BATCH,
                              augment=ts.ctx.augment, state=ts.state)
            ts.train(1, EPOCHS)
        servers = [s["trainable"] for s in ts.state.servers]
        for key in ("layer6", "head"):
            same = all(torch.equal(a, b) for s in servers[1:]
                       for a, b in zip(tree_leaves(servers[0][key]),
                                       tree_leaves(s[key])))
            assert same == synced, (strategy, key)


def test_round_zero_state_keeps_paper_init(resnet):
    """Paper §III-B from the port's own init: common layers identical
    across clients and across servers."""
    _, (tsc, toc) = _configs("averaging")
    model = tsplitee.ResNetSplitModel(resnet18_cifar.smoke(), device="cpu")
    st = TrainSession(model, tsc, toc, resnet["data"], BATCH).state
    for key in ("layer1", "layer2", "layer3"):
        ref = _flat(st.clients[0]["trainable"]["layers"][key])
        for c in st.clients[1:]:
            assert torch.equal(_flat(c["trainable"]["layers"][key]), ref)
    for key in ("layer6", "head"):
        ref = _flat(st.servers[0]["trainable"][key])
        for s in st.servers[1:]:
            assert torch.equal(_flat(s["trainable"][key]), ref)


# ---------------------------------------------------------------------------
# engines and the protocol
# ---------------------------------------------------------------------------


def test_engine_resolution_and_its_errors(mlp):
    _, (tsc, toc) = _configs("averaging")
    sess = TrainSession(mlp["port"], tsc, toc, mlp["data"], BATCH)
    assert sess.engine.name == "fused"
    assert sess.engine_name.startswith("fused (spmd unavailable: ")
    assert "only 1 rank" in sess.engine_name
    assert tapi.available_engines() == ("fused", "reference", "spmd")
    # Sequential is ordered across clients: auto falls back to reference
    seq = TrainSession(mlp["port"], SplitEEConfig(HeteroProfile(SPLITS),
                                                  strategy="sequential"),
                       toc, mlp["data"], BATCH)
    assert seq.engine.name == "reference"
    assert "fused unavailable: supports averaging/distributed only" in \
        seq.engine_name
    # the spmd engine needs ranks: one process is a world of one
    with pytest.raises(ValueError, match="needs a mesh"):
        TrainSession(mlp["port"], tsc, toc, mlp["data"], BATCH,
                     engine="spmd")
    with pytest.raises(ValueError, match="unknown engine"):
        tapi.get_engine("nope")
    # mesh= and recipe= are taken (the one-rank mesh leaves auto on fused)
    from repro_torch.launch.mesh import MeshSpec
    one = TrainSession.from_config(mlp["port"], tsc, toc, mlp["data"], BATCH,
                                   mesh=MeshSpec((1, 1), ("data", "model")),
                                   recipe="fsdp-off")
    assert one.engine.name == "fused" and "no parallelism" in \
        one.engine_name
    assert one.ctx.recipe_name == "fsdp-off"
    for kw, item in ((dict(recipe="nope"), "unknown sharding recipe"),
                     (dict(population=object()),
                      "either client_data or population")):
        with pytest.raises(ValueError, match=item):
            TrainSession.from_config(mlp["port"], tsc, toc, mlp["data"],
                                     BATCH, **kw)
    with pytest.raises(ValueError, match="2 data shards"):
        TrainSession(mlp["port"], tsc, toc, mlp["data"][:2], BATCH)
    with pytest.raises(ValueError, match="unknown strategy"):
        TrainSession(mlp["port"], SplitEEConfig(HeteroProfile(SPLITS),
                                                strategy="nope"),
                     toc, mlp["data"], BATCH, engine="reference")
    for attr in ("save", "restore", "restore_latest"):
        assert callable(getattr(TrainSession, attr))


def test_cohort_helpers_match_jax(mlp):
    from repro.api import engines as jengines
    from repro_torch.api import engines as tengines
    for splits in (SPLITS, resnet18_cifar.HETERO_SPLITS, (2, 1, 2)):
        assert tengines.cohort_layout(splits) == \
            jengines.cohort_layout(splits)
    _, (tsc, toc) = _configs("averaging")
    ctx = tapi.SessionContext(mlp["port"], tsc, toc, mlp["data"], BATCH)
    assert tengines.ragged_cohort_reason(ctx) is None
    ragged = [mlp["data"][0], (mlp["data"][1][0][:5], mlp["data"][1][1][:5]),
              *mlp["data"][2:]]
    ctx = tapi.SessionContext(mlp["port"], tsc, toc, ragged, BATCH)
    assert "cohort l_i=3" in tengines.ragged_cohort_reason(ctx)


@pytest.mark.parametrize("make", [
    lambda: tsplitee.MLPSplitModel(8, 16, 3, num_layers=4, device="cpu"),
    lambda: tsplitee.ResNetSplitModel(resnet18_cifar.smoke(), device="cpu"),
], ids=["mlp", "resnet"])
def test_adapters_conform_to_the_protocol(make):
    model = make()
    assert isinstance(model, tapi.SplitModel)
    tapi.assert_split_model(model)
    assert model.device == torch.device("cpu")


def test_protocol_rejects_a_bad_adapter():
    class Broken:
        num_layers = 3

        def make_client(self, li):
            return {}

    with pytest.raises(TypeError, match="missing or non-callable"):
        tapi.assert_split_model(Broken())
    _, (tsc, toc) = _configs("averaging")
    with pytest.raises(TypeError, match="SplitModel protocol"):
        TrainSession(Broken(), tsc, toc, [], BATCH)


def test_adapters_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsplitee.MLPSplitModel(8, 16, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsplitee.ResNetSplitModel(resnet18_cifar.smoke())

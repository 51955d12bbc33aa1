"""Client populations in the port (``repro_torch/population``, the masked
cohort step, the masked Eq. (1), the fused engine's population staging)
against the JAX package's, after ``tests/test_population.py`` (its spmd
cases left out: the multi-GPU engine is not ported).

  * the numpy copies: plans, cursor streams, Dirichlet shards and the
    checkpoint fingerprint equal the JAX modules', for the same seeds;
  * participation parity: full participation is bit for bit the fixed
    cohort on the port's fused engine; K of N matches the smaller fixed
    cohort within the JAX gate (1e-4);
  * churn: a round launches the same operations whatever its active set;
    an all-masked round leaves the state exactly as it was; the lanes of a
    cohort end at different Adam steps;
  * the port's population session against the JAX population fused
    session on the same shards and schedule: the MLP in fp32 at 1e-5, the
    ResNet smoke in float64 at 1e-6, every element, Adam steps exact;
  * a churning population resumes from a mid-run checkpoint (port to
    port exactly, JAX to port within 1e-5), and restore refuses another
    fingerprint.
"""
import contextlib
import dataclasses

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
from repro.population import ClientPopulation as JPopulation
from repro.population import ParticipationSchedule as JSchedule
from repro.population import PopulationCursor as JCursor
from repro_torch.api import TrainSession
from repro_torch.api import fused_engine
from repro_torch.checkpoint import key_paths
from repro_torch.config import HeteroProfile, OptimizerConfig, SplitEEConfig
from repro_torch.configs import resnet18_cifar
from repro_torch.convert import state_to_jax
from repro_torch.core import aggregation as taggregation
from repro_torch.core import splitee as tsplitee
from repro_torch.core.spmd import (make_cohort_train_step,
                                   make_masked_cohort_step)
from repro_torch.optim import adam_init
from repro_torch.population import (ClientPopulation, ParticipationSchedule,
                                    PopulationCursor)
from repro_torch.tree import tree_leaves

PARITY_TOL_FULL = 1e-6      # the JAX gate of full participation
PARITY_TOL_MASKED = 1e-4    # the JAX gate of masked K of N
TOL = 1e-5
TOL_F64 = 1e-6
CHURN = dict(participation_rate=0.7, churn_seed=3, straggler_rate=0.25)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """At most two torch threads in this module (``tests/test_torch_
    fused.py`` says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _blob_data(n, d, classes, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, d)) * 2.0
    y = rng.integers(0, classes, n).astype(np.int32)
    x = (centers[y] + rng.normal(size=(n, d))).astype(np.float32)
    return x, y


def _shards(n_shards, per_shard=128, d=16, classes=3, seed=0):
    x, y = _blob_data(n_shards * per_shard, d, classes, seed=seed)
    return [(x[i::n_shards], y[i::n_shards]) for i in range(n_shards)]


def _model():
    return tsplitee.MLPSplitModel(16, 32, 3, num_layers=4, device="cpu")


def _session(splits, *, population=None, parts=None, engine="fused",
             batch_size=32, total_steps=200, model=None, **kw):
    return TrainSession.from_config(
        model or _model(),
        SplitEEConfig(profile=HeteroProfile(tuple(splits)),
                      strategy="averaging"),
        OptimizerConfig(lr=3e-3, total_steps=total_steps),
        parts, batch_size=batch_size, engine=engine,
        population=population, **kw)


def _keyed(state, model):
    return {k: np.asarray(v, np.float64) if np.asarray(v).dtype.kind == "f"
            else np.asarray(v)
            for k, v in key_paths(state_to_jax(state, model))}


def _jax_keyed(state):
    return {"/".join(str(p) for p in path): (
        np.asarray(leaf, np.float64) if np.asarray(leaf).dtype.kind == "f"
        else np.asarray(leaf))
        for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]}


def _gap(a, b):
    """The largest element gap of two keyed states; integer leaves (Adam
    steps, round, draw counts) must be equal."""
    assert set(a) == set(b)
    gap = 0.0
    for k in a:
        if a[k].dtype.kind in "iu":
            assert np.array_equal(a[k], b[k]), k
        elif a[k].size:
            gap = max(gap, float(np.max(np.abs(a[k] - b[k]))))
    return gap


def _loss_gap(ma, mb):
    return max(max(abs(a.client_loss - b.client_loss),
                   abs(a.server_loss - b.server_loss))
               for a, b in zip(ma, mb))


# ---------------------------------------------------------------------------
# the numpy copies against the JAX modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(participation_rate=0.8, churn_seed=11),
    dict(participation_rate=0.7, churn_seed=3,
         straggler_rates=[0.25] * 12, availability=[0.9] * 12),
    dict(churn_seed=0, step_budgets=[1, None] * 6)])
def test_schedule_plans_equal_jax(kw):
    splits = [(1, 2, 3)[i % 3] for i in range(12)]
    slots = (1, 2, 3, 1)
    mine, theirs = ParticipationSchedule(splits, slots, **kw), \
        JSchedule(splits, slots, **kw)
    for t in range(40):
        for epochs in (1, 2):
            a, b = mine.plan(t, epochs), theirs.plan(t, epochs)
            assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert mine.signature() == theirs.signature()


def test_schedule_config_validation():
    with pytest.raises(ValueError, match="participation_rate"):
        ParticipationSchedule([1, 2], [1, 2], participation_rate=0.0)
    with pytest.raises(ValueError, match="no cohort slot"):
        ParticipationSchedule([1, 3], [1, 2])
    with pytest.raises(ValueError, match="availability"):
        ParticipationSchedule([1, 2], [1, 2], availability=[1.0])


def test_dirichlet_population_and_cursor_equal_jax():
    """The port's Dirichlet population draws JAX's shards and fingerprint,
    and its cursor (aligned by replay) streams JAX's plans and batches."""
    x, y = _blob_data(1200, 16, 3, seed=2)
    kw = dict(alpha=0.5, seed=0, min_shard=32, **CHURN)
    mine = ClientPopulation.dirichlet(x, y, 12, (1, 2, 1, 2), **kw)
    theirs = JPopulation.dirichlet(x, y, 12, (1, 2, 1, 2), **kw)
    assert mine.meta() == theirs.meta()
    for a, b in zip(mine.clients, theirs.clients):
        np.testing.assert_array_equal(a.x, b.x)
        assert a.split == b.split
    assert [s[0].shape for s in mine.slot_stubs()] == \
        [s[0].shape for s in theirs.slot_stubs()]
    a, b = PopulationCursor(mine, 32, 0), JCursor(theirs, 32, 0)
    a.align(3, 2)                   # rebuild + replay rounds [0, 3)
    b.align(0, 2)
    for _ in range(3):
        b.next_round(2)
    for _ in range(4):
        (pa, ba), (pb, bb) = a.next_round(2), b.next_round(2)
        assert dataclasses.astuple(pa) == dataclasses.astuple(pb)
        assert set(ba) == set(bb)
        for e in ba:
            for (x1, y1), (x2, y2) in zip(ba[e], bb[e]):
                np.testing.assert_array_equal(x1, x2)
                np.testing.assert_array_equal(y1, y2)


# ---------------------------------------------------------------------------
# session binding
# ---------------------------------------------------------------------------


def _population(P=4, slots=(1, 2), per_shard=96, **kw):
    shards = _shards(P, per_shard=per_shard)
    splits = [slots[i % len(slots)] for i in range(P)]
    return ClientPopulation.from_shards(shards, splits, slot_splits=slots,
                                        **kw)


def test_session_binding_refusals():
    pop = _population()
    with pytest.raises(ValueError, match="either client_data or population"):
        _session((1, 2), population=pop, parts=_shards(2))
    with pytest.raises(ValueError, match="required without a population"):
        _session((1, 2))
    with pytest.raises(ValueError, match="slot layout"):
        _session((1, 2, 3), population=pop)
    with pytest.raises(ValueError, match="smaller than"):
        _session((1, 2), population=_population(per_shard=16),
                 batch_size=32)
    with pytest.raises(ValueError, match="fused or spmd"):
        _session((1, 2), population=pop, engine="reference")
    with pytest.raises(ValueError, match="augment is not supported"):
        _session((1, 2), population=pop, augment=lambda rng, x: x)


# ---------------------------------------------------------------------------
# the masked pieces
# ---------------------------------------------------------------------------


def test_masked_stacked_aggregation_matches_jax():
    """The port's masked Eq. (1) against the JAX package's on random server
    nets (cohorts of 3, 1 and 2 lanes, clients interleaved): random masks
    within 1e-6; all ones bit for bit the unmasked form; all zeros leave
    every lane as it was."""
    rng = np.random.default_rng(0)
    splits = (1, 2, 1, 4, 1, 4)
    lanes = {li: [i for i, s in enumerate(splits) if s == li]
             for li in sorted(set(splits))}
    keys = {1: ("layer2", "layer3", "layer4", "head"),
            2: ("layer3", "layer4", "head"), 4: ("head",)}
    nets = {li: {k: {"w": rng.normal(size=(len(lanes[li]), 3, 4))
                     .astype(np.float32)} for k in keys[li]}
            for li in lanes}

    def port(masks):
        stacked = {li: {k: {"w": torch.from_numpy(v["w"].copy())}
                        for k, v in n.items()} for li, n in nets.items()}
        return taggregation.masked_stacked_cross_layer_aggregate(
            stacked, {li: torch.tensor(m) for li, m in masks.items()},
            lanes)

    for trial in range(4):
        masks = {li: rng.integers(0, 2, len(v)).astype(np.float32)
                 for li, v in lanes.items()}
        want = jaggregation.masked_stacked_cross_layer_aggregate(
            {li: {k: {"w": jnp.asarray(v["w"])} for k, v in n.items()}
             for li, n in nets.items()},
            {li: jnp.asarray(m) for li, m in masks.items()},
            {li: len(v) for li, v in lanes.items()})
        got = port(masks)
        for li in lanes:
            for k in keys[li]:
                np.testing.assert_allclose(got[li][k]["w"].numpy(),
                                           np.asarray(want[li][k]["w"]),
                                           atol=1e-6)
    ones = port({li: np.ones(len(v), np.float32) for li, v in lanes.items()})
    plain = taggregation.stacked_cross_layer_aggregate(
        {li: {k: {"w": torch.from_numpy(v["w"].copy())}
              for k, v in n.items()} for li, n in nets.items()}, lanes)
    zeros = port({li: np.zeros(len(v), np.float32)
                  for li, v in lanes.items()})
    for li in lanes:
        for k in keys[li]:
            assert torch.equal(ones[li][k]["w"], plain[li][k]["w"])
            assert torch.equal(zeros[li][k]["w"],
                               torch.from_numpy(nets[li][k]["w"]))


def _resnet_cohort(li=3, k=3, seed=0):
    model = tsplitee.ResNetSplitModel(resnet18_cifar.smoke(), device="cpu")
    opt = OptimizerConfig(lr=1e-3)
    c, s = model.make_client(li), model.make_server(li)
    carry = [model.stack_clients([c] * k),
             fused_engine._stack_opts([adam_init(c["trainable"], opt)] * k),
             model.stack_clients([s] * k),
             fused_engine._stack_opts([adam_init(s["trainable"], opt)] * k)]
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(k, 4, 32, 32, 3, generator=gen)
    y = torch.randint(0, 10, (k, 4), generator=gen)
    return model, opt, carry, x, y


def _clone_carry(carry):
    from repro_torch.optim import AdamState
    from repro_torch.tree import tree_map

    def cl(t):
        if isinstance(t, AdamState):
            return AdamState(step=t.step.clone(), m=cl(t.m), v=cl(t.v))
        return tree_map(torch.clone, t)
    return [cl(t) for t in carry]


def _leaves(carry):
    out = []
    for t in carry:
        if hasattr(t, "step"):
            out += [t.step] + list(tree_leaves([t.m, t.v]))
        else:
            out += list(tree_leaves(t))
    return out


def test_masked_cohort_step_gates_each_lane():
    """On the ResNet smoke (BatchNorm statistics in the state): all lanes
    on, every output bit for bit the unmasked step's; lane 1 off, lane 1's
    parameters, moments, step and statistics unchanged and its losses 0,
    the other lanes bit for bit as with all on."""
    model, opt, carry, x, y = _resnet_cohort()
    plain = make_cohort_train_step(model, opt, 3)
    masked = make_masked_cohort_step(model, opt, 3)
    for _ in range(2):                  # steps 0 -> 1 -> 2
        want = plain(*_clone_carry(carry), x, y, 1e-3, 1e-3)
        got = masked(*_clone_carry(carry), x, y, 1e-3, 1e-3, torch.ones(3))
        assert all(torch.equal(a, b) for a, b in zip(_leaves(got[:4]),
                                                     _leaves(want[:4])))
        assert torch.equal(got[4], want[4]) and torch.equal(got[5], want[5])
        carry = list(want[:4])
    before = _clone_carry(carry)
    m = torch.tensor([1.0, 0.0, 1.0])
    got = masked(*_clone_carry(carry), x, y, 1e-3, 1e-3, m)
    want = plain(*_clone_carry(carry), x, y, 1e-3, 1e-3)
    assert got[1].step.tolist() == [3, 2, 3]
    for g, b, w in zip(_leaves(got[:4]), _leaves(before), _leaves(want[:4])):
        assert torch.equal(g[1], b[1])
        assert torch.equal(g[0], w[0]) and torch.equal(g[2], w[2])
    assert got[4][1] == 0 and got[5][1] == 0
    assert torch.equal(got[4][0], want[4][0])
    bn = [t for t in tree_leaves(before[0]["state"])]
    assert bn and any(not torch.equal(a[0], b[0]) for a, b in zip(
        tree_leaves(got[0]["state"]), bn))       # lane 0 did update its BN


# ---------------------------------------------------------------------------
# participation parity
# ---------------------------------------------------------------------------


def _resnet_parts(n):
    from repro_torch.data.synthetic import SyntheticImageDataset
    ds = SyntheticImageDataset(num_classes=10, image_size=32,
                               train_size=n * 32, test_size=8, seed=0)
    return [(ds.train[0][i::n], ds.train[1][i::n]) for i in range(n)]


@pytest.mark.parametrize("name", ["mlp", "resnet"])
def test_full_participation_is_bit_identical_to_fixed_cohort(name):
    """P == E, everyone always available, nobody straggles: the population
    session reproduces the fixed-cohort fused run bit for bit (the masks
    are all 1.0), within the JAX gate a fortiori."""
    if name == "mlp":
        splits, shards, model, batch = (1, 2, 1, 2), _shards(4), _model, 32
    else:
        splits, shards, batch = (3, 4, 3, 5), _resnet_parts(4), 8
        model = lambda: tsplitee.ResNetSplitModel(  # noqa: E731
            resnet18_cifar.smoke(), device="cpu")
    pop = ClientPopulation.from_shards(shards, splits)
    pop_sess = _session(splits, population=pop, model=model(),
                        batch_size=batch)
    fix_sess = _session(splits, parts=shards, model=model(),
                        batch_size=batch)
    pm = pop_sess.train(4, 2, chunk_rounds=3)
    fm = fix_sess.train(4, 2, chunk_rounds=3)
    gap = _gap(_keyed(pop_sess.state, pop_sess.model),
               _keyed(fix_sess.state, fix_sess.model))
    assert gap == 0.0 and _loss_gap(pm, fm) == 0.0
    assert gap <= PARITY_TOL_FULL
    assert all(m.active_clients == 4 and m.stragglers == 0 for m in pm)
    assert all(m.active_clients == -1 for m in fm)


def test_k_of_n_parity_with_smaller_fixed_cohort():
    """A 4-client population of which only clients 0 and 1 are ever
    available, on a 2-slot profile, against a 2-client session on their
    shards (the same seeded streams, seed + cid)."""
    shards = _shards(4)
    pop = ClientPopulation.from_shards(
        shards, [1, 2, 1, 2], slot_splits=(1, 2),
        availability=[1.0, 1.0, 0.0, 0.0])
    pop_sess = _session((1, 2), population=pop)
    fix_sess = _session((1, 2), parts=shards[:2])
    pm = pop_sess.train(6, 2, chunk_rounds=3)
    fm = fix_sess.train(6, 2, chunk_rounds=3)
    gap = _gap(_keyed(pop_sess.state, pop_sess.model),
               _keyed(fix_sess.state, fix_sess.model))
    dl = _loss_gap(pm, fm)
    print(f"reading K of N vs fixed cohort: state {gap:.2e}, losses "
          f"{dl:.2e}")
    assert max(gap, dl) <= PARITY_TOL_MASKED


# ---------------------------------------------------------------------------
# churn
# ---------------------------------------------------------------------------


def _churn_population(seed=2, P=12, slots=(1, 2, 1, 2)):
    x, y = _blob_data(1200, 16, 3, seed=seed)
    return ClientPopulation.dirichlet(x, y, P, slots, alpha=0.5, seed=0,
                                      min_shard=32, **CHURN)


def test_churn_keeps_each_rounds_operations_fixed():
    """Rounds of different active counts (an all-masked one included, the
    participation stats say) run the same operations: the round's work does
    not depend on its active set.  Counted as aten calls per round."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    pop = _churn_population()
    sess = _session((1, 2, 1, 2), population=pop)
    sess.engine.overlap_staging = False
    sess.train(1, 1)                                # warm-up
    per_round = {}
    for _ in range(12):
        Count.n = 0
        with Count():
            m, = sess.train(1, 1)
        per_round.setdefault(m.active_clients, set()).add(Count.n)
    assert len(per_round) > 1                       # churn varied
    counts = set().union(*per_round.values())
    assert len(counts) == 1, per_round
    stats = sess.engine.last_participation_stats
    assert stats["rounds"] == 1 and stats["population"] == 12
    assert stats["active_total"] + stats["masked_total"] == 4


def test_participation_stats_and_steps_follow_the_plans():
    pop = _churn_population()
    sess = _session((1, 2, 1, 2), population=pop)
    metrics = sess.train(12, 2, chunk_rounds=5)
    stats = sess.engine.last_participation_stats
    active = [m.active_clients for m in metrics]
    assert stats["active_per_round"] == active and len(set(active)) > 1
    assert stats["stragglers_per_round"] == [m.stragglers for m in metrics]
    assert stats["active_total"] + stats["masked_total"] == 12 * 4
    plans = [pop.schedule.plan(t, 2) for t in range(12)]
    steps = [2 * sum(p.slot_mask[i] > 0 for p in plans) for i in range(4)]
    assert [s.step for s in sess.state.client_opts] == steps
    assert [s.step for s in sess.state.server_opts] == steps
    assert len(set(steps[0::2])) > 1 or len(set(steps[1::2])) > 1


def test_all_masked_round_is_a_no_op():
    shards = _shards(2)
    pop = ClientPopulation.from_shards(shards, [1, 2],
                                       straggler_rates=[1.0, 1.0])
    sess = _session((1, 2), population=pop)
    before = _keyed(sess.state, sess.model)
    metrics = sess.train(2, 1)
    assert all(m.active_clients == 0 and m.client_loss == 0.0
               for m in metrics)
    after = _keyed(sess.state, sess.model)
    for k in before:
        if k.startswith((".round", ".batches_drawn")):
            continue
        assert np.array_equal(before[k], after[k]), k


# ---------------------------------------------------------------------------
# against the JAX population session
# ---------------------------------------------------------------------------


class _JaxResNet(jsplitee.ResNetSplitModel):
    name = "ResNetSplitModel"

    def __post_init__(self):
        self.full_params, self.full_state = jax.jit(
            jresnet.init_resnet, static_argnums=1)(
                jax.random.PRNGKey(self.seed), self.cfg)


def _pair(name):
    """(jax model, port model, x, y, batch, lr, x64, tol, slots); the JAX
    model is a callable, to be drawn under ``jax.enable_x64``."""
    if name == "mlp":
        x, y = _blob_data(1200, 16, 3, seed=4)
        return (lambda: jsplitee.MLPSplitModel(16, 32, 3, num_layers=4),
                _model(),
                x, y, 32, 3e-3, False, TOL, (1, 1, 2, 2))
    from repro_torch.data.synthetic import SyntheticImageDataset
    ds = SyntheticImageDataset(num_classes=10, image_size=32, train_size=192,
                               test_size=8, seed=0)
    return (lambda: _JaxResNet(dataclasses.replace(jresnet18.smoke(),
                                                   dtype=jnp.float64)),
            tsplitee.ResNetSplitModel(dataclasses.replace(
                resnet18_cifar.smoke(), dtype=torch.float64), device="cpu"),
            ds.train[0].astype(np.float64), ds.train[1], 8, 3e-5, True,
            TOL_F64, (3, 3, 4, 4))


@pytest.mark.parametrize("name", ["mlp", "resnet"])
def test_population_session_matches_jax(name):
    """The same Dirichlet shards and churning schedule through the JAX
    population fused session and the port's, from one round-0 state: every
    element, the losses and the active/straggler counts; the Adam steps
    exact, and apart within a cohort (lanes whose steps diverged)."""
    from repro_torch.convert import split_state_from_jax
    jmodel, model, x, y, batch, lr, x64, tol, slots = _pair(name)
    kw = dict(alpha=0.5, seed=0, min_shard=batch, **CHURN)
    sdt = (jnp.float64, torch.float64) if x64 else (jnp.float32,
                                                    torch.float32)
    with jax.enable_x64(x64):
        js = JaxSession.from_config(
            jmodel(), JSplitEEConfig(profile=JHeteroProfile(slots)),
            JOptimizerConfig(lr=lr, total_steps=30, state_dtype=sdt[0]),
            None, batch_size=batch, engine="fused",
            population=JPopulation.dirichlet(x, y, 10, slots, **kw))
        if x64:
            js.engine.overlap_staging = False
            wide = lambda nets: tuple(  # noqa: E731
                {**n, "state": jax.tree.map(
                    lambda a: a.astype(jnp.float64), n["state"])}
                for n in nets)
            js.state = js.state.replace(clients=wide(js.state.clients),
                                        servers=wide(js.state.servers))
        start = split_state_from_jax(js.state, model)
        jm = js.train(6, 2, chunk_rounds=4)
        want = _jax_keyed(js.state)
    ts = TrainSession(model, SplitEEConfig(profile=HeteroProfile(slots)),
                      OptimizerConfig(lr=lr, total_steps=30,
                                      state_dtype=sdt[1]),
                      None, batch, engine="fused", state=start,
                      population=ClientPopulation.dirichlet(x, y, 10, slots,
                                                            **kw))
    tm = ts.train(6, 2, chunk_rounds=4)
    gap, dl = _gap(_keyed(ts.state, model), want), _loss_gap(tm, jm)
    print(f"reading {name} population port vs JAX: state {gap:.2e}, "
          f"losses {dl:.2e}")
    assert max(gap, dl) <= tol, (gap, dl)
    assert [(m.active_clients, m.stragglers) for m in tm] == \
        [(m.active_clients, m.stragglers) for m in jm]
    steps = [s.step for s in ts.state.client_opts]
    cohorts = {li: {steps[i] for i, s in enumerate(slots) if s == li}
               for li in set(slots)}
    assert any(len(v) > 1 for v in cohorts.values()), steps


# ---------------------------------------------------------------------------
# checkpoints of population runs
# ---------------------------------------------------------------------------


def _resume_pop():
    x, y = _blob_data(1200, 16, 3, seed=4)
    return ClientPopulation.dirichlet(x, y, 10, (1, 2, 2, 3), alpha=0.5,
                                      seed=0, participation_rate=0.7,
                                      churn_seed=6, straggler_rate=0.2,
                                      min_shard=32)


def test_resume_equivalence_churning_population(tmp_path):
    """10 rounds = 5, save, restore with an equal population, 5: exact, the
    per-round active and straggler counts too (the restored cursor replays
    the schedule from round 0)."""
    full = _session((1, 2, 2, 3), population=_resume_pop(), total_steps=50)
    full.train(10, local_epochs=2)
    half = _session((1, 2, 2, 3), population=_resume_pop(), total_steps=50)
    half.train(5, local_epochs=2, chunk_rounds=2)
    half.save(str(tmp_path / "ckpt"))
    resumed = TrainSession.restore(str(tmp_path / "ckpt"), _model(), None,
                                   population=_resume_pop())
    resumed.train(5, local_epochs=2)
    assert resumed.round == full.round == 10
    assert _gap(_keyed(resumed.state, full.model),
                _keyed(full.state, full.model)) == 0.0
    assert [(m.round, m.active_clients, m.stragglers, m.client_loss,
             m.server_loss) for m in resumed.history] == \
        [(m.round, m.active_clients, m.stragglers, m.client_loss,
          m.server_loss) for m in full.history]


def test_jax_population_checkpoint_resumes_in_the_port(tmp_path):
    """JAX trains a churning population 3 rounds and saves; the port
    restores it with its own copy of the population (the fingerprints
    agree) and trains 3 more, against JAX's uninterrupted 6 (MLP, fp32,
    1e-5)."""
    x, y = _blob_data(1200, 16, 3, seed=4)
    kw = dict(alpha=0.5, seed=0, participation_rate=0.7, churn_seed=6,
              straggler_rate=0.2, min_shard=32)

    def jsess():
        return JaxSession.from_config(
            jsplitee.MLPSplitModel(16, 32, 3, num_layers=4),
            JSplitEEConfig(profile=JHeteroProfile((1, 2, 2, 3))),
            JOptimizerConfig(lr=3e-3, total_steps=50), None, batch_size=32,
            engine="fused",
            population=JPopulation.dirichlet(x, y, 10, (1, 2, 2, 3), **kw))

    full = jsess()
    full.train(6, 2)
    half = jsess()
    half.train(3, 2)
    half.save(str(tmp_path / "ckpt"))
    resumed = TrainSession.restore(
        str(tmp_path / "ckpt"), _model(), None,
        population=ClientPopulation.dirichlet(x, y, 10, (1, 2, 2, 3), **kw))
    resumed.train(3, 2)
    gap = _gap(_keyed(resumed.state, resumed.model), _jax_keyed(full.state))
    assert max(gap, _loss_gap(resumed.history, full.history)) <= TOL
    assert [m.active_clients for m in resumed.history] == \
        [m.active_clients for m in full.history]


def test_restore_validates_population_fingerprint(tmp_path):
    shards = _shards(4)
    make = lambda seed: ClientPopulation.from_shards(  # noqa: E731
        shards, [1, 2, 1, 2], participation_rate=0.8, churn_seed=seed)
    sess = _session((1, 2, 1, 2), population=make(9))
    sess.train(2, 1)
    path = str(tmp_path / "ckpt")
    sess.save(path)
    with pytest.raises(ValueError, match="population=None"):
        TrainSession.restore(path, _model(), shards)
    with pytest.raises(ValueError, match="population mismatch"):
        TrainSession.restore(path, _model(), None, population=make(10))
    assert TrainSession.restore(path, _model(), None,
                                population=make(9)).round == 2
    fix = _session((1, 2), parts=_shards(2))
    fix.train(1, 1)
    fpath = str(tmp_path / "fixed")
    fix.save(fpath)
    with pytest.raises(ValueError, match="fixed-cohort"):
        TrainSession.restore(fpath, _model(), None, population=_population())


def test_train_cli_population_run(tmp_path, capsys):
    from repro_torch.launch import train as train_cli
    argv = ["--device", "cpu", "--model", "mlp", "--clients", "4",
            "--population", "12", "--participation-rate", "0.7",
            "--straggler-rate", "0.2", "--churn-seed", "3",
            "--train-size", "1024", "--test-size", "128", "--batch", "32",
            "--log-every", "0", "--checkpoint-dir", str(tmp_path / "run"),
            "--save-every", "2"]
    train_cli.main(argv + ["--rounds", "4"])
    out = capsys.readouterr().out
    assert "population=12 (alpha=0.5, rate=0.7" in out
    assert "participation: active" in out and "(pool of 12)" in out
    train_cli.main(argv + ["--rounds", "6", "--resume"])
    assert "[resumed at round 4]" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--resume mismatch"):
        train_cli.main(argv + ["--rounds", "8", "--resume", "--churn-seed",
                               "4"])


def test_planted_faults_are_rejected(tmp_path):
    """The controls of ``chip_smoke.py`` phase lifecycle on the CPU: the
    population smoke against itself reads 0, and each planted fault (an
    inactive lane counted in the masked Eq. (1); a restored cursor left at
    round 0; a masked lane's Adam step advancing) is rejected by the same
    comparison at the paper loop's limits."""
    from repro_torch import parity
    x, y = parity.population_smoke_data()
    n, epochs = parity.POP_SMOKE_ROUNDS, parity.PAPER_EPOCHS
    ref = parity.population_session("cpu", x, y)
    start = ref.state.clone()
    hist = ref.train(n, epochs)
    assert all(0 < m.active_clients < 4 for m in hist)

    def drift(sess):
        d = parity.paper_drift(sess.state, ref.state, start)
        return max(d["clients"], d["servers"])

    with parity.inactive_lanes_counted():
        bad = parity.population_session("cpu", x, y, state=start)
        bad.train(n, epochs)
    assert drift(bad) > parity.TOL_PAPER_PARAMS
    first = parity.population_session("cpu", x, y, state=start)
    first.train(n // 2, epochs)
    first.save(str(tmp_path / "ckpt"))
    for planted in (False, True):
        with (parity.unaligned_cursor() if planted
              else contextlib.nullcontext()):
            back = TrainSession.restore(
                str(tmp_path / "ckpt"), ref.model, None,
                population=parity.population_smoke(x, y))
            back.train(n - n // 2, epochs)
        same = ([m.active_clients for m in back.history]
                == [m.active_clients for m in hist])
        assert (same and drift(back) == 0.0) != planted
    gaps = parity.masked_lane_gaps(ref, [1.0, 0.0])
    assert gaps["masked"] == gaps["masked_steps"] == 0.0 < gaps["active"]
    with parity.advancing_masked_step():
        assert parity.masked_lane_gaps(ref, [1.0, 0.0])["masked_steps"] == 1


def test_masked_lane_left_out_is_rejected_at_full_participation():
    """The planted fault of phase lifecycle's comparison under cuDNN's
    default algorithms, on the CPU: full participation over the fixed
    cohort's shards reads 0 against the fixed cohort, and with the first
    lane left out of the masked Eq. (1) it parts beyond the loop's
    limits."""
    from repro_torch import parity
    x, y = parity.population_smoke_data()
    n, epochs = parity.POP_SMOKE_ROUNDS, parity.PAPER_EPOCHS
    fixed = parity.population_session("cpu", x, y, population=None)
    start = fixed.state.clone()
    fixed.train(n, epochs)

    def drift(planted):
        with (parity.masked_lane_left_out() if planted
              else contextlib.nullcontext()):
            full = parity.population_session("cpu", x, y, state=start,
                                             population="full")
            hist = full.train(n, epochs)
        assert all(m.active_clients == len(parity.PAPER_SPLITS)
                   for m in hist)
        d = parity.paper_drift(full.state, fixed.state, start)
        return max(d["clients"], d["servers"])

    assert drift(False) == 0.0
    assert drift(True) > parity.TOL_PAPER_PARAMS

"""Checkpoints of the port (``repro_torch/checkpoint``, ``TrainSession.save``
/ ``restore`` / ``restore_latest``, ``ServeSession.restore`` and the
training CLI) against the JAX package's.

A checkpoint is the JAX package's file: the port writes its state in the
JAX layout (``convert.state_to_jax``: conv weights HWIO, backbone segments
restacked, bf16 widened to fp32, Adam steps, round and draw counts int32)
under JAX's key paths, with the JAX session's manifest.  So:

  * a port ``save`` loads in the JAX package (``TrainSession.restore``,
    which is ``load_pytree`` into ``init_train_state``) and a JAX ``save``
    restores in the port, every leaf equal, for the MLP, the ResNet (conv
    layout) and the glm4-9b, rwkv6 and zamba2 smokes in bf16 (stacked
    segments, widening; zamba2's shared block on both sides and its
    layer's ``{}`` placeholder); the manifests' key, dtype and shape sets are equal;
  * resume equivalence: JAX trains k rounds and saves, the port restores
    and trains k more, against JAX training 2k rounds uninterrupted: the
    MLP in fp32 at 1e-5 in every element, the ResNet smoke in float64 at
    1e-6 (``tests/test_torch_session.py`` says why float64);
  * port to port, after ``tests/test_session.py``: resume equivalence on
    each engine (exact), across engines and across an Eq. (1) boundary,
    rotation, ``restore_latest`` and the refusals;
  * serving: ``ServeSession.restore`` of one checkpoint in both packages
    (glm4-9b smoke, fp32, plain path) serves the same tokens and gate
    decisions, at the default and the deeper boundary;
  * the CLIs: ``repro_torch.launch.train`` with ``--checkpoint-dir``,
    ``--resume`` and the resume mismatch refusal, and ``e2e_train
    --checkpoint`` read by the JAX ``load_pytree``.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.api import TrainSession as JaxSession
from repro.api.serve_session import ServeSession as JaxServeSession
from repro.checkpoint import load_pytree as jax_load_pytree
from repro.config import HeteroProfile as JHeteroProfile
from repro.config import OptimizerConfig as JOptimizerConfig
from repro.config import SplitEEConfig as JSplitEEConfig
from repro.configs import resnet18_cifar as jresnet18
from repro.core import splitee as jsplitee
from repro.core.backbone_splitee import BackboneSplitModel as JBackbone
from repro.models import resnet as jresnet
from repro_torch.api import TrainSession
from repro_torch.api.serve_session import (ServeSession,
                                           assemble_serve_params)
from repro_torch.api.state import init_train_state
from repro_torch.checkpoint import key_paths, load_pytree, save_pytree
from repro_torch.config import HeteroProfile, OptimizerConfig, SplitEEConfig
from repro_torch.configs import resnet18_cifar
from repro_torch.convert import (config_from_jax, split_state_from_jax,
                                 state_to_jax)
from repro_torch.core import splitee as tsplitee
from repro_torch.core.backbone_splitee import BackboneSplitModel
from repro_torch.data.pipeline import ClientPartitioner
from repro_torch.data.synthetic import (SyntheticImageDataset,
                                        SyntheticSeqClsDataset)
from repro_torch.launch import e2e_train
from repro_torch.launch import train as train_cli
from repro_torch.tree import tree_leaves

TOL = 1e-5
TOL_F64 = 1e-6
SPLITS = (3, 3, 4, 5)
EPOCHS, BATCH = 2, 16


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """At most two torch threads in this module (``tests/test_torch_
    fused.py`` says why)."""
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
    """The JAX adapter, its init drawn under ``jax.jit``; manifests name it
    as they name the adapter."""

    name = "ResNetSplitModel"

    def __post_init__(self):
        self.full_params, self.full_state = jax.jit(
            jresnet.init_resnet, static_argnums=1)(
                jax.random.PRNGKey(self.seed), self.cfg)


@pytest.fixture(scope="module")
def mlp():
    x, y = _blobs(400, 16, 3)
    return dict(jax=lambda: jsplitee.MLPSplitModel(16, 32, 3, num_layers=6),
                port=lambda: tsplitee.MLPSplitModel(16, 32, 3, num_layers=6,
                                                    device="cpu"),
                data=ClientPartitioner(4).split(x, y), augment=None,
                lr=3e-3, x64=False, tol=TOL)


@pytest.fixture(scope="module")
def resnet():
    """The ResNet smoke in float64 on both sides."""
    ds = SyntheticImageDataset(num_classes=10, image_size=32,
                               train_size=4 * 2 * BATCH, test_size=8, seed=0)
    wide = lambda xy: (xy[0].astype(np.float64), xy[1])  # noqa: E731
    return dict(
        jax=lambda: _JaxResNet(dataclasses.replace(jresnet18.smoke(),
                                                   dtype=jnp.float64)),
        port=lambda: tsplitee.ResNetSplitModel(dataclasses.replace(
            resnet18_cifar.smoke(), dtype=torch.float64), device="cpu"),
        data=[wide(p) for p in ClientPartitioner(4).split(*ds.train)],
        augment=ds.augment, lr=3e-5, x64=True, tol=TOL_F64)


def _configs(setup, *, agg=2, splits=SPLITS, total=20):
    sdt = (jnp.float64, torch.float64) if setup["x64"] else (jnp.float32,
                                                             torch.float32)
    return ((JSplitEEConfig(profile=JHeteroProfile(splits),
                            aggregate_every=agg),
             JOptimizerConfig(lr=setup["lr"], total_steps=total,
                              state_dtype=sdt[0])),
            (SplitEEConfig(profile=HeteroProfile(splits),
                           aggregate_every=agg),
             OptimizerConfig(lr=setup["lr"], total_steps=total,
                             state_dtype=sdt[1])))


def _jax_session(setup, engine="fused", **kw):
    """A JAX session of ``setup``; under float64 its staging thread off
    and its BatchNorm statistics started in float64
    (``tests/test_torch_fused.py`` says why)."""
    (jsc, joc), _ = _configs(setup, **kw)
    js = JaxSession.from_config(setup["jax"](), jsc, joc, setup["data"],
                                BATCH, engine=engine,
                                augment=setup["augment"])
    if setup["x64"]:
        js.engine.overlap_staging = False
        wide = lambda nets: tuple(  # noqa: E731
            {**n, "state": jax.tree.map(lambda a: a.astype(jnp.float64),
                                        n["state"])} for n in nets)
        js.state = js.state.replace(clients=wide(js.state.clients),
                                    servers=wide(js.state.servers))
    return js


def _port_session(setup, engine="fused", state=None, **kw):
    _, (tsc, toc) = _configs(setup, **kw)
    return TrainSession(setup["port"](), tsc, toc, setup["data"], BATCH,
                        engine=engine, augment=setup["augment"], state=state)


def _keyed(tree_or_state, model=None):
    """{JAX key path: float64 or integer numpy array} of a JAX state (no
    ``model``) or a port state."""
    if model is not None:
        items = key_paths(state_to_jax(tree_or_state, model))
    else:
        items = (("/".join(str(p) for p in path), leaf) for path, leaf in
                 jax.tree_util.tree_flatten_with_path(tree_or_state)[0])
    out = {}
    for k, v in items:
        a = np.asarray(v)
        out[k] = a.astype(np.float64) if a.dtype.kind == "f" or \
            a.dtype.name == "bfloat16" else a
    return out


def _max_gap(a, b):
    """The largest element gap between two keyed states; integer leaves
    (steps, round, draw counts) must be equal."""
    assert set(a) == set(b), set(a) ^ set(b)
    gap = 0.0
    for k in a:
        assert a[k].shape == b[k].shape, k
        if a[k].dtype.kind in "iu":
            assert np.array_equal(a[k], b[k]), k
        elif a[k].size:
            gap = max(gap, float(np.max(np.abs(a[k] - b[k]))))
    return gap


def _loss_gap(ha, hb):
    assert [a.round for a in ha] == [b.round for b in hb]
    return max(max(abs(a.client_loss - b.client_loss),
                   abs(a.server_loss - b.server_loss))
               for a, b in zip(ha, hb))


# ---------------------------------------------------------------------------
# the file format
# ---------------------------------------------------------------------------


def test_save_pytree_writes_the_jax_format_and_loads_back(tmp_path):
    """Paths, widening and manifest as ``repro.checkpoint`` writes them, in
    both directions."""
    from repro.checkpoint import save_pytree as jax_save_pytree
    from repro_torch.convert import JaxAdamState
    tree = {"a": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
            "b": [torch.ones(4, dtype=torch.bfloat16),
                  np.asarray(3, np.int32)],
            "o": JaxAdamState(step=np.asarray(2, np.int32),
                              m={"x": torch.zeros(2)}, v=None)}
    jtree = {"a": {"w": jnp.arange(6, dtype=jnp.float32).reshape(2, 3)},
             "b": [jnp.ones(4, jnp.bfloat16), jnp.asarray(3, jnp.int32)]}
    save_pytree(str(tmp_path / "t"), tree, metadata={"step": 7})
    jax_save_pytree(str(tmp_path / "j"), jtree, metadata={"step": 7})
    t = json.load(open(tmp_path / "t.json"))
    j = json.load(open(tmp_path / "j.json"))
    assert t["keys"] == sorted(j["keys"] + ["['o']/.m/['x']",
                                            "['o']/.step"])
    assert t["dtypes"]["['b']/[0]"] == "float32" == j["dtypes"]["['b']/[0]"]
    assert t["metadata"] == j["metadata"] == {"step": 7}
    back = jax_load_pytree(str(tmp_path / "t"),
                           jax.tree.map(jnp.zeros_like, jtree))
    assert back["b"][0].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["a"]["w"]),
                                  np.arange(6).reshape(2, 3))
    mine = load_pytree(str(tmp_path / "j"), {
        "a": {"w": torch.zeros(2, 3)},
        "b": [torch.zeros(4, dtype=torch.bfloat16), np.zeros((), np.int32)]})
    assert mine["b"][0].dtype == np.float32          # as saved: widened
    np.testing.assert_array_equal(mine["b"][0], np.ones(4))
    assert mine["b"][1].dtype == np.int32 and int(mine["b"][1]) == 3
    with pytest.raises(KeyError):
        load_pytree(str(tmp_path / "j"), {"missing": torch.zeros(1)})


# ---------------------------------------------------------------------------
# round trips between the packages
# ---------------------------------------------------------------------------


def _backbone_setup(family):
    jcfg = jconfigs.get(family).smoke().with_(dtype=jnp.bfloat16,
                                              param_dtype=jnp.bfloat16)
    cfg = config_from_jax(jcfg)
    exits = tuple(sorted(jcfg.exit_layers))
    splits = tuple(exits[i % len(exits)] for i in range(3))
    ds = SyntheticSeqClsDataset(vocab_size=jcfg.vocab_size, seq_len=8,
                                num_classes=8, train_size=96, test_size=8,
                                seed=0)
    return dict(jax=lambda: JBackbone(jcfg, seed=0),
                port=lambda: BackboneSplitModel(cfg, device="cpu"),
                data=ClientPartitioner(3).split(*ds.train), augment=None,
                lr=1e-3, x64=False, splits=splits)


def _round_trip_setup(name, request):
    if name in ("glm4-9b", "rwkv6-3b", "zamba2-1.2b", "whisper-small"):
        return _backbone_setup(name)
    if name == "resnet":
        ds = SyntheticImageDataset(num_classes=10, image_size=32,
                                   train_size=4 * BATCH, test_size=8, seed=0)
        return dict(jax=lambda: _JaxResNet(jresnet18.smoke()),
                    port=lambda: tsplitee.ResNetSplitModel(
                        resnet18_cifar.smoke(), device="cpu"),
                    data=ClientPartitioner(4).split(*ds.train),
                    augment=ds.augment, lr=1e-3, x64=False, splits=SPLITS)
    return {**request.getfixturevalue(name), "splits": SPLITS}


def _randomized(state, seed=0):
    """``state`` with every float leaf drawn from a seed (so moments and
    statistics are not zero) and every integer leaf (Adam steps, the
    round, the draw counts) set to 3."""
    rng = np.random.default_rng(seed)

    def draw(a):
        a = np.asarray(a)
        if a.dtype.kind in "iu":
            return jnp.full(a.shape, 3, a.dtype)
        return jnp.asarray(rng.normal(size=a.shape), a.dtype)

    return jax.tree.map(draw, state)


@pytest.mark.parametrize("name", ["mlp", "resnet", "glm4-9b", "rwkv6-3b",
                                  "zamba2-1.2b", "whisper-small"])
def test_checkpoints_round_trip_between_packages(name, request, tmp_path):
    setup = _round_trip_setup(name, request)
    (jsc, joc), _ = _configs(setup, splits=setup["splits"])
    jmodel = setup["jax"]()
    js = JaxSession.from_config(jmodel, jsc, joc, setup["data"], BATCH,
                                engine="reference", augment=setup["augment"])
    js.state = _randomized(js.state)
    js.save(str(tmp_path / "jax"))
    # JAX -> port: every leaf equal
    model = setup["port"]()
    ts = TrainSession.restore(str(tmp_path / "jax"), model, setup["data"],
                              augment=setup["augment"])
    assert ts.engine.name == "reference" and ts.round == 3
    assert _max_gap(_keyed(ts.state, model), _keyed(js.state)) == 0.0
    # bf16 leaves were widened in the file and narrowed again: each tensor
    # in the dtype of a fresh port state
    fresh = init_train_state(model, *_configs(setup,
                                              splits=setup["splits"])[1])
    got = list(tree_leaves([ts.state.clients, ts.state.servers]))
    like = list(tree_leaves([fresh.clients, fresh.servers]))
    assert [t.dtype for t in got] == [t.dtype for t in like]
    assert (torch.bfloat16 in {t.dtype for t in got}) == ("-" in name)
    if name == "zamba2-1.2b":
        # the shared block on both sides of the cut, its layer's {} kept
        for net in (ts.state.clients[0], ts.state.servers[0]):
            assert "shared_attn" in net["trainable"]
        assert ts.state.servers[0]["trainable"]["seg1"][0] == {}
        assert ts.state.server_opts[0].m["seg1"][0] == {}
    if name == "whisper-small":
        # each side's own copy of the encoder-state projector, and the
        # cross attention of each layer
        for net, opt in ((ts.state.clients[0], ts.state.client_opts[0]),
                         (ts.state.servers[0], ts.state.server_opts[0])):
            assert net["trainable"]["frontend"]["w"].shape == (768, 128)
            assert "frontend" in opt.m
        assert "cross" in ts.state.clients[0]["trainable"]["segments"][0][0]
    # port -> JAX: every leaf equal, dtypes narrowed back
    ts.save(str(tmp_path / "port"))
    jb = JaxSession.restore(str(tmp_path / "port"), setup["jax"](),
                            setup["data"], augment=setup["augment"])
    for a, b in zip(jax.tree.leaves(jb.state), jax.tree.leaves(js.state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float64),
                                      np.asarray(b, np.float64))
    # the manifests: one key set, the same dtypes and shapes, the same
    # metadata fields and one-device sharding recipe
    mj = json.load(open(tmp_path / "jax.json"))
    mp = json.load(open(tmp_path / "port.json"))
    for field in ("keys", "dtypes", "shapes"):
        assert mp[field] == mj[field], field
    assert set(mp["metadata"]) == set(mj["metadata"])
    for field in ("format", "kind", "model", "splitee", "optimizer",
                  "recipe", "batch_size", "seed", "augmented", "round",
                  "population", "grad_mode"):
        assert mp["metadata"][field] == mj["metadata"][field], field


# ---------------------------------------------------------------------------
# resume equivalence against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["mlp", "resnet"])
def test_jax_save_port_resume_equals_uninterrupted_jax(name, request,
                                                       tmp_path):
    """JAX trains k rounds and saves; the port restores and trains k more;
    the result against JAX training 2k rounds: every element of the
    trainables, moments and BatchNorm statistics, and the per-round
    losses, within the setup's limit."""
    setup = request.getfixturevalue(name)
    k = 2
    with jax.enable_x64(setup["x64"]):
        full = _jax_session(setup)
        full.train(2 * k, EPOCHS)
        half = _jax_session(setup)
        half.train(k, EPOCHS)
        half.save(str(tmp_path / "ckpt"))
        want = _keyed(full.state)
    resumed = TrainSession.restore(str(tmp_path / "ckpt"), setup["port"](),
                                   setup["data"], augment=setup["augment"])
    assert resumed.engine.name == "fused" and resumed.round == k
    resumed.train(k, EPOCHS)
    gap = _max_gap(_keyed(resumed.state, resumed.model), want)
    dl = _loss_gap(resumed.history, full.history)
    print(f"reading {name}: JAX k + port k vs JAX 2k: state {gap:.2e}, "
          f"losses {dl:.2e}")
    assert max(gap, dl) <= setup["tol"], (gap, dl)


@pytest.fixture(scope="module")
def whisper():
    """The whisper smoke in fp32 at lr 1e-5 (tests/test_torch_backbone_
    split.py says why that lr against JAX)."""
    jcfg = jconfigs.get("whisper-small").smoke()
    ds = SyntheticSeqClsDataset(vocab_size=jcfg.vocab_size, seq_len=8,
                                num_classes=8, train_size=128, test_size=8,
                                seed=0)
    return dict(jax=lambda: JBackbone(jcfg, seed=0),
                port=lambda: BackboneSplitModel(config_from_jax(jcfg),
                                                device="cpu"),
                data=ClientPartitioner(4).split(*ds.train), augment=None,
                lr=1e-5, x64=False, tol=TOL)


def test_whisper_resume_across_packages_equals_uninterrupted_jax(whisper,
                                                                 tmp_path):
    """The whisper smoke (cuts (2, 2, 2, 2): each side's frontend copy
    in the file) both ways: JAX k + port k, and port k (from the JAX
    start) + JAX k, each against JAX training 2k rounds: every element of
    the trainables and moments, and the per-round losses, within 1e-5."""
    setup = {**whisper}
    k = 2
    splits = (2, 2, 2, 2)
    full = _jax_session(setup, splits=splits)
    start = full.state
    full.train(2 * k, EPOCHS)
    want = _keyed(full.state)
    # JAX k + port k
    half = _jax_session(setup, splits=splits)
    half.train(k, EPOCHS)
    half.save(str(tmp_path / "jax"))
    resumed = TrainSession.restore(str(tmp_path / "jax"), setup["port"](),
                                   setup["data"])
    resumed.train(k, EPOCHS)
    gaps = [(_max_gap(_keyed(resumed.state, resumed.model), want),
             _loss_gap(resumed.history, full.history))]
    # port k + JAX k
    model = setup["port"]()
    port = _port_session(setup, splits=splits,
                         state=split_state_from_jax(start, model))
    port.train(k, EPOCHS)
    port.save(str(tmp_path / "port"))
    back = JaxSession.restore(str(tmp_path / "port"), setup["jax"](),
                              setup["data"])
    back.train(k, EPOCHS)
    gaps.append((_max_gap(_keyed(back.state), want),
                 _loss_gap(port.history + back.history[-k:],
                           full.history)))
    print(f"reading whisper smoke: JAX k + port k, port k + JAX k vs JAX "
          f"2k: state and losses {gaps}")
    for gap, dl in gaps:
        assert max(gap, dl) <= setup["tol"], gaps


# ---------------------------------------------------------------------------
# port to port (tests/test_session.py)
# ---------------------------------------------------------------------------


def _state_gap(a, b, model):
    return _max_gap(_keyed(a, model), _keyed(b, model))


def test_save_restore_roundtrips_full_state(mlp, tmp_path):
    sess = _port_session(mlp)
    sess.train(3, local_epochs=2)
    sess.save(str(tmp_path / "ckpt"))
    back = TrainSession.restore(str(tmp_path / "ckpt"), mlp["port"](),
                                mlp["data"])
    assert back.engine_name == "fused" and back.round == 3
    assert back.state.batches_drawn == (6,) * 4
    assert _state_gap(back.state, sess.state, back.model) == 0.0
    assert [dataclasses.astuple(m) for m in back.history] == \
        [dataclasses.astuple(m) for m in sess.history]


@pytest.mark.parametrize("engine", ["reference", "fused"])
def test_resume_equivalence(engine, mlp, tmp_path):
    """2k rounds = k, save, restore, k, on each engine (bit for bit); the
    save point (after round 1, aggregate_every=2) is between two
    boundaries."""
    k = 2
    full = _port_session(mlp, engine)
    full.train(2 * k, local_epochs=2)
    half = _port_session(mlp, engine)
    half.train(k, local_epochs=2)
    half.save(str(tmp_path / "ckpt"))
    resumed = TrainSession.restore(str(tmp_path / "ckpt"), mlp["port"](),
                                   mlp["data"])
    assert resumed.engine.name == engine
    resumed.train(k, local_epochs=2)
    assert resumed.round == full.round == 2 * k
    assert _state_gap(resumed.state, full.state, full.model) == 0.0
    assert _loss_gap(resumed.history, full.history) == 0.0


def test_resume_straddles_aggregation_boundary(mlp, tmp_path):
    full = _port_session(mlp)
    full.train(4)
    half = _port_session(mlp)
    half.train(3)                                   # boundaries at t=1, 3
    half.save(str(tmp_path / "ckpt"))
    resumed = TrainSession.restore(str(tmp_path / "ckpt"), mlp["port"](),
                                   mlp["data"])
    resumed.train(1)                                # t=3 aggregates here
    assert _state_gap(resumed.state, full.state, full.model) == 0.0
    heads = [s["trainable"]["head"]["w"] for s in resumed.state.servers]
    assert all(torch.equal(heads[0], h) for h in heads[1:])


@pytest.mark.parametrize("first,second", [("fused", "reference"),
                                          ("reference", "fused")])
def test_cross_engine_restore(first, second, mlp, tmp_path):
    oracle = _port_session(mlp, "reference")
    oracle.train(4)
    half = _port_session(mlp, first)
    half.train(2)
    half.save(str(tmp_path / "ckpt"))
    resumed = TrainSession.restore(str(tmp_path / "ckpt"), mlp["port"](),
                                   mlp["data"], engine=second)
    assert resumed.engine_name == second
    resumed.train(2)
    assert _state_gap(resumed.state, oracle.state, oracle.model) <= TOL
    assert _loss_gap(resumed.history, oracle.history) <= TOL


def test_resnet_state_roundtrip_includes_bn(resnet, tmp_path):
    """The ResNet's BatchNorm statistics ride through save and restore and
    keep the resumed run on the uninterrupted one (float64, exact)."""
    full = _port_session(resnet)
    full.train(2)
    half = _port_session(resnet)
    half.train(1)
    half.save(str(tmp_path / "ckpt"))
    keys = json.load(open(tmp_path / "ckpt.json"))["keys"]
    assert any("running_mean" in k or "mean" in k for k in keys
               if k.startswith(".clients/[0]/['state']"))
    resumed = TrainSession.restore(str(tmp_path / "ckpt"), resnet["port"](),
                                   resnet["data"], augment=resnet["augment"])
    resumed.train(1)
    assert _state_gap(resumed.state, full.state, full.model) == 0.0


def test_save_every_rotation_and_restore_latest(mlp, tmp_path):
    sess = _port_session(mlp)
    ckdir = str(tmp_path / "run")
    sess.train(5, save_every=2, save_dir=ckdir, keep_last=2)
    assert sess.round == 5
    assert sorted(f for f in os.listdir(ckdir)) == [
        "ckpt-00000004.json", "ckpt-00000004.npz", "ckpt-00000005.json",
        "ckpt-00000005.npz"]
    back = TrainSession.restore_latest(ckdir, mlp["port"](), mlp["data"])
    assert back.round == 5
    assert _state_gap(back.state, sess.state, sess.model) == 0.0


def test_restore_latest_skips_corrupt_newest(mlp, tmp_path):
    sess = _port_session(mlp)
    ckdir = str(tmp_path / "run")
    sess.train(4, save_every=2, save_dir=ckdir, keep_last=3)
    with open(os.path.join(ckdir, "ckpt-00000004.npz"), "wb") as f:
        f.write(b"truncated")
    with pytest.warns(UserWarning, match="skipping unreadable"):
        back = TrainSession.restore_latest(ckdir, mlp["port"](), mlp["data"])
    assert back.round == 2


def test_restore_latest_empty_dir_raises(mlp, tmp_path):
    with pytest.raises(FileNotFoundError, match="no readable"):
        TrainSession.restore_latest(str(tmp_path), mlp["port"](), [])


def test_save_every_requires_save_dir(mlp):
    with pytest.raises(ValueError, match="save_dir"):
        _port_session(mlp).train(2, save_every=1)


def test_restore_refusals(mlp, tmp_path):
    """A checkpoint that is not a session's, of another format, of another
    model, or saved with augment active restored without it: each
    refused."""
    path = str(tmp_path / "raw")
    save_pytree(path, {"params": np.zeros(3)}, metadata={"arch": "x"})
    with pytest.raises(ValueError, match="not a TrainSession"):
        TrainSession.restore(path, mlp["port"](), [])
    sess = _port_session(mlp)
    sess.train(1)
    path = str(tmp_path / "ckpt")
    sess.save(path)
    other = tsplitee.ResNetSplitModel(resnet18_cifar.smoke(), device="cpu")
    with pytest.raises(ValueError, match="saved with model"):
        TrainSession.restore(path, other, mlp["data"])
    manifest = json.load(open(path + ".json"))
    manifest["metadata"]["format"] = 2
    json.dump(manifest, open(path + ".json", "w"))
    with pytest.raises(ValueError, match="checkpoint format 2"):
        TrainSession.restore(path, mlp["port"](), mlp["data"])
    x, y = _blobs(120, 16, 3)
    aug = lambda rng, bx: bx + rng.normal(size=bx.shape).astype(bx.dtype)  # noqa: E731
    model = tsplitee.MLPSplitModel(16, 32, 3, num_layers=4, device="cpu")
    sess = TrainSession(model, SplitEEConfig(profile=HeteroProfile((2,))),
                        OptimizerConfig(total_steps=10), [(x, y)], 32,
                        augment=aug)
    sess.train(1)
    sess.save(path)
    with pytest.raises(ValueError, match="augment"):
        TrainSession.restore(path, model, [(x, y)])
    back = TrainSession.restore(path, model, [(x, y)], augment=aug)
    back.train(1)
    assert back.round == 2


# ---------------------------------------------------------------------------
# serving a trained checkpoint
# ---------------------------------------------------------------------------

TAU = 2.0


@pytest.fixture(scope="module")
def trained_ckpt(tmp_path_factory):
    """The port's TrainSession on glm4-9b smoke (fp32), clients at both
    cuts, 2 rounds, saved; the JAX and port adapters of that config."""
    jcfg = jconfigs.get("glm4-9b").smoke()
    cfg = config_from_jax(jcfg)
    model = BackboneSplitModel(cfg, device="cpu")
    ds = SyntheticSeqClsDataset(vocab_size=cfg.vocab_size, seq_len=8,
                                num_classes=8, train_size=64, test_size=32,
                                seed=0)
    exits = sorted(cfg.exit_layers)
    sess = TrainSession(
        model, SplitEEConfig(profile=HeteroProfile((exits[0], exits[1])),
                             entropy_threshold=TAU),
        OptimizerConfig(lr=1e-3, total_steps=16),
        ClientPartitioner(2, seed=0).split(*ds.train), 16,
        engine="reference")
    sess.train(2)
    path = str(tmp_path_factory.mktemp("serve_ckpt") / "ckpt-00000002")
    sess.save(path)
    return path, model, JBackbone(jcfg, seed=0), sess


def _prompts(vocab, n, seed=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(4, 10)))
            for _ in range(n)]


@pytest.mark.parametrize("boundary", [0, 1])
def test_serve_restore_matches_jax(trained_ckpt, boundary):
    """One checkpoint restored by both packages' ServeSession serves the
    same tokens and gate decisions (entropies within 1e-4)."""
    path, model, jmodel, _ = trained_ckpt
    prompts = _prompts(model.cfg.vocab_size, 4)
    # tau at the median gate entropy of a first run, so the gate both
    # fires and holds
    probe = ServeSession.restore(path, model, boundary=boundary, slots=2,
                                 max_len=24)
    for p in prompts:
        probe.submit(p, decode_tokens=5)
    tau = float(np.median([h for r in probe.run() for h in r.entropy]))
    sess = ServeSession.restore(path, model, tau=tau, boundary=boundary,
                                slots=2, max_len=24)
    jsess = JaxServeSession.restore(path, jmodel, tau=tau,
                                    boundary=boundary, slots=2, max_len=24)
    assert sess.cut == jsess.cut == sorted(model.cfg.exit_layers)[boundary]
    for p in prompts:
        sess.submit(p, decode_tokens=5)
        jsess.submit(p, decode_tokens=5)
    got = {r.rid: r for r in sess.run()}
    want = {r.rid: r for r in jsess.run()}
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for rid in got:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].exited == want[rid].exited, rid
        np.testing.assert_allclose(got[rid].entropy, want[rid].entropy,
                                   atol=1e-4)
    exits = {e for r in got.values() for e in r.exited}
    assert exits == {True, False}


def test_serve_restore_defaults_and_refusals(trained_ckpt):
    path, model, _, _ = trained_ckpt
    sess = ServeSession.restore(path, model, slots=1, max_len=16)
    assert sess.tau == TAU and sess.boundary == 0
    other = BackboneSplitModel(config_from_jax(
        jconfigs.get("rwkv6-3b").smoke()), device="cpu")
    with pytest.raises(ValueError, match="saved with model"):
        ServeSession.restore(path, other)


def test_assembled_params_compose_trained_client_server(trained_ckpt):
    """The serving tree holds the boundary client's embed, segments and
    exit head and its server's deep segments and head, as trained; a
    boundary no client trained is refused."""
    _, model, _, sess = trained_ckpt
    state = sess.state
    params = assemble_serve_params(model, state, boundary=0)
    client, server = (state.clients[0]["trainable"],
                      state.servers[0]["trainable"])
    assert params["embed"] is client["embed"]
    assert params["exit_heads"][0] is client["out"]
    assert params["exit_heads"][1] is state.clients[1]["trainable"]["out"]
    assert params["head"] is server["head"]
    assert params["segments"][-1] is server[f"seg{len(model.plan) - 1}"]
    exits = sorted(model.cfg.exit_layers)
    shallow = init_train_state(
        model, SplitEEConfig(profile=HeteroProfile((exits[0],) * 2)),
        OptimizerConfig())
    with pytest.raises(ValueError, match="no client in the checkpoint"):
        assemble_serve_params(model, shallow, boundary=1)


def test_serve_cli_serves_a_checkpoint(trained_ckpt, capsys):
    from repro_torch.launch import serve
    path, _, _, _ = trained_ckpt
    serve.main(["--device", "cpu", "--ckpt", path, "--requests", "2",
                "--slots", "2", "--prompt-len", "5", "--decode-tokens", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=glm4-9b-smoke tau=2.0 boundary=0")
    assert "served 2 requests / 4 decode tokens" in out[1]


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

_CLI = ["--device", "cpu", "--model", "mlp", "--clients", "4",
        "--train-size", "512", "--test-size", "128", "--batch", "32",
        "--log-every", "0"]


def test_train_cli_checkpoints_and_resumes(tmp_path, capsys):
    ckdir = str(tmp_path / "run")
    train_cli.main(_CLI + ["--rounds", "5", "--checkpoint-dir", ckdir,
                           "--save-every", "2", "--keep-last", "2"])
    out = capsys.readouterr().out
    assert "engine=fused (spmd unavailable" in out
    assert "trained 5 rounds" in out
    assert sorted(os.listdir(ckdir)) == [
        "ckpt-00000004.json", "ckpt-00000004.npz", "ckpt-00000005.json",
        "ckpt-00000005.npz", "driver.json"]
    train_cli.main(_CLI + ["--rounds", "7", "--checkpoint-dir", ckdir,
                           "--resume"])
    out = capsys.readouterr().out
    assert "[resumed at round 5]" in out and "trained 2 rounds" in out
    assert "client 3 (l_i=1)" in out
    with pytest.raises(SystemExit, match="--resume mismatch"):
        train_cli.main(_CLI + ["--rounds", "8", "--checkpoint-dir", ckdir,
                               "--resume", "--arch", "glm4_9b", "--smoke"])
    # the same run resumed on 4 host ranks: the spmd engine over the
    # default data mesh, rank 0's output printed
    train_cli.main(_CLI + ["--rounds", "8", "--checkpoint-dir", ckdir,
                           "--resume", "--host-devices", "4"])
    out = capsys.readouterr().out
    assert "devices=4 (4 processes, rank 0)  engine=spmd  recipe=greedy" \
        in out
    assert "[resumed at round 7]" in out and "trained 1 rounds" in out
    with pytest.raises(SystemExit, match="does not divide the 4 devices"):
        train_cli.main(_CLI + ["--rounds", "9", "--host-devices", "4",
                               "--lanes", "3"])


def test_e2e_train_checkpoint_loads_in_jax(tmp_path):
    """``e2e_train --checkpoint`` writes {params, opt} that the JAX
    ``load_pytree`` reads into JAX's own trees, every leaf equal."""
    from repro.config import OptimizerConfig as JOpt
    from repro.models.backbone import init_backbone
    from repro.optim import adam_init
    path = str(tmp_path / "e2e")
    res = e2e_train.main(["--smoke", "--layers", "4", "--steps", "2",
                          "--batch", "12", "--seq", "8", "--device", "cpu",
                          "--checkpoint", path])
    cfg, _ = e2e_train.cut_depth(config_from_jax(
        jconfigs.get("glm4-9b").smoke()), 4)
    jcfg = jconfigs.get("glm4-9b").smoke().with_(
        num_layers=cfg.num_layers, exit_layers=cfg.exit_layers)
    jp = init_backbone(jax.random.PRNGKey(0), jcfg)
    like = {"params": jp, "opt": adam_init(jp, JOpt())}
    back = jax_load_pytree(path, like)
    assert int(back["opt"].step) == res["opt"].step == 2
    from repro_torch.convert import params_to_jax
    want = params_to_jax(res["params"], cfg)
    got = jax.tree.map(np.asarray, back["params"])
    flat_w = dict(key_paths(want))
    flat_g = {"/".join(str(p) for p in path_): v for path_, v in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert set(flat_w) == set(flat_g)
    for k in flat_w:
        np.testing.assert_array_equal(flat_g[k], flat_w[k])
    meta = json.load(open(path + ".json"))["metadata"]
    assert meta["steps"] == 2

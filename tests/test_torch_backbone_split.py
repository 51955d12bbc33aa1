"""The port's ``BackboneSplitModel`` (``repro_torch/core/backbone_splitee.
py``) through ``TrainSession`` on the CPU, mirroring the JAX package's
``tests/test_backbone_session.py`` (MoE, mamba2, Zamba2, spmd, checkpoint
and CLI cases left out: those items are not ported): the protocol and the
partition, the port's fused engine against the JAX package's fused engine
on ``glm4_9b.smoke()`` and ``rwkv6_3b.smoke()`` in fp32, and against the
port's reference engine.

Both packages start from the JAX session's round-0 state
(``repro_torch.convert.split_state_from_jax``, which unstacks the JAX
runs of identical layers) and draw the same numpy token batches.

Limits: 1e-5, every element of the trainables and the Adam moments, and
the per-round losses.  Against JAX the learning rate is 1e-5: Adam's
first steps move an element by about lr whatever its gradient's size, so
an element whose gradient is rounding noise in both packages moves by a
different fraction of lr in each.  The gap scales with lr, the signature
of that amplification (glm4 readings, 3 rounds: 3.1e-4 at lr 1e-3, 3.1e-5
at 1e-4, 9.4e-6 at 3e-5, all in layer 1's wq), and the port's two engines
agree to 3.5e-7 at lr 1e-3 on the same run.  Port fused against port
reference runs at lr 1e-3.
"""
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.api import TrainSession as JaxSession
from repro.config import HeteroProfile as JHeteroProfile
from repro.config import OptimizerConfig as JOptimizerConfig
from repro.config import SplitEEConfig as JSplitEEConfig
from repro.core.backbone_splitee import BackboneSplitModel as JaxBackbone
from repro_torch.api import TrainSession
from repro_torch.api.protocol import SplitModel, assert_split_model
from repro_torch.config import HeteroProfile, OptimizerConfig, SplitEEConfig
from repro_torch.configs import glm4_9b, rwkv6_3b
from repro_torch.convert import split_state_from_jax
from repro_torch.core.backbone_splitee import BackboneSplitModel
from repro_torch.data.pipeline import ClientPartitioner
from repro_torch.data.synthetic import SyntheticSeqClsDataset
from repro_torch.tree import tree_leaves

TOL = 1e-5
LR_JAX, LR = 1e-5, 1e-3
ROUNDS, BATCH, SEQ = 3, 16, 8
# (arch id, the port's smoke config, client cut layers)
ARCHS = {"glm4": ("glm4_9b", glm4_9b.smoke, (1, 1, 2, 2)),
         "rwkv6": ("rwkv6_3b", rwkv6_3b.smoke, (2, 2, 2))}


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


def _parts(cfg, n):
    ds = SyntheticSeqClsDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                num_classes=8, train_size=128, test_size=32,
                                seed=0)
    return ClientPartitioner(n).split(*ds.train), ds.test


@pytest.fixture(scope="module")
def glm4():
    return BackboneSplitModel(glm4_9b.smoke(), device="cpu")


def _port(model, parts, splits, engine, state=None, lr=LR, agg=2,
          grad_mode="eq1"):
    return TrainSession(
        model, SplitEEConfig(profile=HeteroProfile(splits),
                             strategy="averaging", aggregate_every=agg),
        OptimizerConfig(lr=lr, total_steps=64), parts, BATCH, engine=engine,
        grad_mode=grad_mode, state=state)


def _gap(a, b):
    """The largest element gap over the nets and Adam moments of two
    ``TrainState``s."""
    def flat(s):
        return [s.clients, s.servers,
                [(o.m, o.v) for o in s.client_opts + s.server_opts]]
    assert a.round == b.round and a.batches_drawn == b.batches_drawn
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(tree_leaves(flat(a)), tree_leaves(flat(b))))


def _loss_gap(ha, hb):
    return max(max(abs(a.client_loss - b.client_loss),
                   abs(a.server_loss - b.server_loss))
               for a, b in zip(ha, hb))


# ---------------------------------------------------------------- protocol


def test_protocol_conformance_and_partition(glm4):
    assert isinstance(glm4, SplitModel)
    assert_split_model(glm4)
    assert glm4.cut_layers == (1, 2)
    assert glm4.name == "glm4-9b-smoke"
    c, s = glm4.make_client(1), glm4.make_server(1)
    assert set(c["trainable"]) == {"embed", "segments", "out"}
    assert len(c["trainable"]["segments"]) == 1
    assert set(s["trainable"]) == {"seg1", "seg2", "head"}
    c2, s2 = glm4.make_client(2), glm4.make_server(2)
    assert len(c2["trainable"]["segments"]) == 2
    assert set(s2["trainable"]) == {"seg2", "head"}
    assert set(s2["trainable"]) < set(s["trainable"])
    # every net owns its tensors (the port's Adam is in place)
    ptrs = [t.data_ptr() for n in (c, s, c2, s2) for t in tree_leaves(n)]
    assert len(ptrs) == len(set(ptrs))


def test_partition_matches_jax_and_converts():
    """The JAX adapter's nets, converted, hold the port's keys and shapes;
    the same seeded values land in every client of a cut (paper §III-B)."""
    jm = JaxBackbone(jconfigs.get("glm4_9b").smoke(), seed=0)
    tm = BackboneSplitModel(glm4_9b.smoke(), device="cpu")
    js = JaxSession.from_config(
        jm, JSplitEEConfig(profile=JHeteroProfile((1, 2)),
                           strategy="averaging"),
        JOptimizerConfig(), _parts(tm.cfg, 2)[0], BATCH, engine="reference")
    st = split_state_from_jax(js.state, tm)
    for got, want in ((st.clients[0], tm.make_client(1)),
                      (st.servers[1], tm.make_server(2)),
                      (st.client_opts[1].m, tm.make_client(2)["trainable"])):
        got_l, want_l = list(tree_leaves(got)), list(tree_leaves(want))
        assert [t.shape for t in got_l] == [t.shape for t in want_l]
    assert len(st.clients[1]["trainable"]["segments"][1]) == 1


def test_invalid_cut_layers_and_unported_families(glm4):
    with pytest.raises(ValueError, match="not an exit boundary"):
        glm4.make_client(3)
    with pytest.raises(ValueError, match="exit_layers"):
        BackboneSplitModel(glm4_9b.smoke().with_(exit_layers=()),
                           device="cpu")
    for kw, what in ((dict(arch_type="moe"), "MoE"),
                     (dict(cross_attention=True), "Whisper")):
        with pytest.raises(NotImplementedError, match=f"{what}.*item 7"):
            BackboneSplitModel(glm4_9b.smoke().with_(**kw), device="cpu")


def test_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BackboneSplitModel(glm4_9b.smoke())


# ------------------------------------------------------------- equivalence


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_fused_matches_jax_fused(arch):
    name, smoke, splits = ARCHS[arch]
    tm = BackboneSplitModel(smoke(), device="cpu")
    parts, _ = _parts(tm.cfg, len(splits))
    js = JaxSession.from_config(
        JaxBackbone(jconfigs.get(name).smoke(), seed=0),
        JSplitEEConfig(profile=JHeteroProfile(splits), strategy="averaging",
                       aggregate_every=2),
        JOptimizerConfig(lr=LR_JAX, total_steps=64), parts, BATCH,
        engine="fused")
    start = split_state_from_jax(js.state, tm)
    js.train(ROUNDS)
    ts = _port(tm, parts, splits, "fused", start, lr=LR_JAX)
    ts.train(ROUNDS)
    gap = _gap(ts.state, split_state_from_jax(js.state, tm))
    dl = _loss_gap(ts.history, js.history)
    print(f"reading {arch} port fused vs JAX fused (lr {LR_JAX}): state "
          f"{gap:.2e}, losses {dl:.2e}")
    assert max(gap, dl) <= TOL


@pytest.mark.parametrize("grad_mode", ["eq1", "sum"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_fused_matches_port_reference(arch, grad_mode):
    _, smoke, splits = ARCHS[arch]
    tm = BackboneSplitModel(smoke(), device="cpu")
    parts, (xt, yt) = _parts(tm.cfg, len(splits))
    ref = _port(tm, parts, splits, "reference")
    fus = _port(tm, parts, splits, "fused", ref.state, grad_mode=grad_mode)
    assert fus.engine.name == "fused"
    ref.train(ROUNDS, local_epochs=2)
    fus.train(ROUNDS, local_epochs=2, chunk_rounds=2)
    gap, dl = _gap(fus.state, ref.state), _loss_gap(fus.history, ref.history)
    print(f"reading {arch} {grad_mode} port fused vs port reference: state "
          f"{gap:.2e}, losses {dl:.2e}")
    assert max(gap, dl) <= TOL
    assert all(np.isfinite([m.client_loss, m.server_loss]).all()
               for m in fus.history)
    ev = fus.evaluate(xt, yt)
    assert ev == ref.evaluate(xt, yt)
    assert len(ev["client_acc"]) == len(splits)

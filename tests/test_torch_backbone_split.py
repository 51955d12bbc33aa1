"""The port's ``BackboneSplitModel`` (``repro_torch/core/backbone_splitee.
py``) through ``TrainSession`` on the CPU, mirroring the JAX package's
``tests/test_backbone_session.py`` (mamba2, Zamba2, spmd, checkpoint and
CLI cases left out: those items are not ported): the protocol and the
partition, the port's fused engine against the JAX package's fused engine
on ``glm4_9b.smoke()``, ``rwkv6_3b.smoke()`` and
``qwen3_moe_235b_a22b.smoke()`` in fp32, and against the port's reference
engine; the qwen3 smoke's reference engine against JAX's; the MoE router
aux loss on both sides of the cut through the adapter's loss hooks.

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
from repro_torch.configs import (glm4_9b, qwen3_moe_235b_a22b, rwkv6_3b,
                                 whisper_small)
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
         "rwkv6": ("rwkv6_3b", rwkv6_3b.smoke, (2, 2, 2)),
         "qwen3": ("qwen3_moe_235b_a22b", qwen3_moe_235b_a22b.smoke,
                   (2, 2)),
         "whisper": ("whisper_small", whisper_small.smoke, (2, 2))}


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
    # cross attention is ported: each side holds its own copy of the
    # encoder-state projector, the VLM's stays out of the trainables
    audio = BackboneSplitModel(glm4_9b.smoke().with_(
        cross_attention=True, arch_type="audio", cross_source_len=4),
        device="cpu")
    assert "frontend" in audio.make_client(1)["trainable"]
    assert "frontend" in audio.make_server(1)["trainable"]
    vlm = BackboneSplitModel(glm4_9b.smoke().with_(arch_type="vlm"),
                             device="cpu")
    assert "frontend" in vlm.full_params
    assert "frontend" not in vlm.make_client(1)["trainable"]
    # Zamba2's shared block is ported: each side holds its own copy
    zamba = BackboneSplitModel(glm4_9b.smoke().with_(
        block_pattern=("attn", "shared_attn", "attn", "attn")), device="cpu")
    assert "shared_attn" in zamba.make_client(1)["trainable"]
    assert "shared_attn" in zamba.make_server(1)["trainable"]


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


def test_reference_matches_jax_reference_qwen3_moe():
    """The qwen3 smoke (MoE in every layer, the aux loss on both sides)
    on the reference engine of both packages, from one round-0 state."""
    name, smoke, splits = ARCHS["qwen3"]
    tm = BackboneSplitModel(smoke(), device="cpu")
    parts, _ = _parts(tm.cfg, len(splits))
    js = JaxSession.from_config(
        JaxBackbone(jconfigs.get(name).smoke(), seed=0),
        JSplitEEConfig(profile=JHeteroProfile(splits), strategy="averaging",
                       aggregate_every=2),
        JOptimizerConfig(lr=LR_JAX, total_steps=64), parts, BATCH,
        engine="reference")
    start = split_state_from_jax(js.state, tm)
    js.train(ROUNDS)
    ts = _port(tm, parts, splits, "reference", start, lr=LR_JAX)
    ts.train(ROUNDS)
    gap = _gap(ts.state, split_state_from_jax(js.state, tm))
    dl = _loss_gap(ts.history, js.history)
    print(f"reading qwen3 port reference vs JAX reference (lr {LR_JAX}): "
          f"state {gap:.2e}, losses {dl:.2e}")
    assert max(gap, dl) <= TOL


def _hook_losses(model, x, y, li, nets=None):
    """(client CE, client hook loss, server CE, server hook loss) of
    ``model``'s nets at cut ``li`` (``nets``, else fresh ones), as
    floats."""
    from repro.core.losses import softmax_cross_entropy as jce
    from repro_torch.core.losses import softmax_cross_entropy as tce
    c, s = nets or (model.make_client(li), model.make_server(li))
    h, logits, _ = model.client_forward(c["trainable"], c["state"], x, True)
    loss, (h2, _) = model.client_loss(c["trainable"], c["state"], x, y)
    slogits, _ = model.server_forward(s["trainable"], s["state"], h, li,
                                      True)
    sloss, _ = model.server_loss(s["trainable"], s["state"], h, li, y)
    ce = jce if isinstance(model, JaxBackbone) else tce
    np.testing.assert_array_equal(np.asarray(h2), np.asarray(h))
    return [float(v) for v in (ce(logits, y), loss, ce(slogits, y), sloss)]


def test_moe_aux_loss_rides_the_hooks_on_both_sides():
    """The adapter's ``client_loss`` / ``server_loss`` hooks add each
    side's own segments' aux total to its cross-entropy, as the JAX
    adapter's do (1e-5 against JAX, both sides nonzero); a dense config
    pays exactly nothing; the same comparison rejects a planted fault, the
    router aux weight 10x too large in the port."""
    import dataclasses

    import jax.numpy as jnp
    name, smoke, _ = ARCHS["qwen3"]
    jcfg = jconfigs.get(name).smoke()
    tm, jm = BackboneSplitModel(smoke(), device="cpu"), JaxBackbone(jcfg)
    parts, _ = _parts(tm.cfg, 2)
    x, y = parts[0][0][:8], parts[0][1][:8]
    from repro_torch.convert import backbone_net_from_jax
    jnets = (jm.make_client(2), jm.make_server(2))
    tnets = [backbone_net_from_jax(n, tm.cfg, "cpu") for n in jnets]
    want = _hook_losses(jm, jnp.asarray(x), jnp.asarray(y), 2, jnets)
    got = _hook_losses(tm, torch.from_numpy(x), torch.from_numpy(y), 2,
                       tnets)
    aux = [want[1] - want[0], want[3] - want[2]]
    print(f"reading qwen3 hooks: aux client {aux[0]:.4e}, server "
          f"{aux[1]:.4e}; port - JAX max "
          f"{max(abs(a - b) for a, b in zip(got, want)):.2e}")
    assert min(aux) > 0
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    heavy = BackboneSplitModel(smoke().with_(moe=dataclasses.replace(
        smoke().moe, router_aux_weight=10 * smoke().moe.router_aux_weight)),
        device="cpu")
    planted = _hook_losses(heavy, torch.from_numpy(x), torch.from_numpy(y),
                           2, tnets)
    np.testing.assert_allclose([planted[1] - planted[0],
                                planted[3] - planted[2]],
                               [10 * a for a in aux], rtol=1e-4)
    assert abs(planted[1] - want[1]) > TOL and abs(planted[3] - want[3]) > TOL
    dense = BackboneSplitModel(glm4_9b.smoke(), device="cpu")
    dparts, _ = _parts(dense.cfg, 2)
    ce, loss, sce, sloss = _hook_losses(
        dense, torch.from_numpy(dparts[0][0][:8]),
        torch.from_numpy(dparts[0][1][:8]), 2)
    assert loss == ce and sloss == sce


def test_qwen3_chunked_and_staged_runs_are_bit_identical():
    """The MoE dispatch and combine hold no atomics and no order that
    depends on the schedule: one chunk without staging overlap and one
    chunk a round with it give the same bits."""
    _, smoke, splits = ARCHS["qwen3"]
    tm = BackboneSplitModel(smoke(), device="cpu")
    parts, _ = _parts(tm.cfg, len(splits))
    one = _port(tm, parts, splits, "fused")
    many = _port(tm, parts, splits, "fused", one.state)
    one.engine.overlap_staging, many.engine.overlap_staging = False, True
    one.train(ROUNDS)
    many.train(ROUNDS, chunk_rounds=1)
    assert many.engine.last_stage_stats["chunks"] == ROUNDS
    assert _gap(one.state, many.state) == 0.0
    assert _loss_gap(one.history, many.history) == 0.0

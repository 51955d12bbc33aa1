"""A data split of a mixture-of-experts model under the port's spmd engine
(``models/moe.py`` routing the whole batch over the batch ranks, each
rank keeping its chunk of the expert stacks, the dispatch and combine an
exchange over them), over 2 and 4 CPU ranks (gloo).

The ranks are spawned once per world size (``launch.hostdevices``) in a
module fixture that runs every leg of ``tests/torch_moe_legs.py``: a data
split over 2 ranks (the experts over the grid of mesh (2, 1)), lanes x
data over 4 (mesh (2, 2, 1)), on the qwen3-moe and deepseek-v3 smokes in
fp32, at the smokes' capacity factor and at ``legs.TIGHT``, where experts
drop entries past the first rank's.  Limits:

  * against the port's one-rank fused engine with the routing pinned
    (``parity.pinned_routes``): losses and every state leaf 1e-5, and one
    cohort step's gradients, the router's included, 1e-5;
  * against the JAX package's fused engine on one device: 1e-5, the limit
    tests/test_torch_backbone_split.py holds the port's fused engine to;
  * each rank holds E / (data ranks) experts and gathers none of their
    weights; the exchange moved bytes;
  * the planted faults -- each rank's expert loads left unsummed, the
    entries written at their local slots, the experts' gradients
    all-reduced over the batch ranks -- must miss the one-rank run by
    more than 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_moe_legs as legs
from repro import configs as jconfigs
from repro.api import TrainSession as JaxSession
from repro.config import HeteroProfile as JHeteroProfile
from repro.config import OptimizerConfig as JOptimizerConfig
from repro.config import SplitEEConfig as JSplitEEConfig
from repro.core.backbone_splitee import BackboneSplitModel as JaxBackbone
from repro_torch.convert import split_state_from_jax
from repro_torch.launch.hostdevices import HostRanks

TOL = 1e-5
JAX_IDS = {"qwen3": "qwen3_moe_235b_a22b", "deepseek": "deepseek_v3_671b"}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """At most two torch threads in this process (tests/test_torch_fused.py
    says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _flat(state, model):
    return legs.flat_state(split_state_from_jax(state, model))


@pytest.fixture(scope="module")
def refs():
    """The round-0 states of both smokes from the JAX package's fused
    sessions, the ranks of both world sizes started on them, then the JAX
    runs while the ranks work."""
    jsessions, starts = {}, {}
    for arch, jid in JAX_IDS.items():
        for tight in (False, True):
            m = legs.model(arch, tight)
            jcfg = jconfigs.get(jid).smoke()
            if tight:
                jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
                    jcfg.moe, capacity_factor=legs.TIGHT))
            js = JaxSession.from_config(
                JaxBackbone(jcfg, seed=0),
                JSplitEEConfig(profile=JHeteroProfile(legs.SPLITS),
                               strategy="averaging", aggregate_every=2),
                JOptimizerConfig(lr=legs.LR, total_steps=64),
                legs.parts(m.cfg), legs.BATCH, engine="fused")
            jsessions[arch, tight] = (js, m)
            if not tight:
                starts[arch] = split_state_from_jax(js.state, m)
    ranks = {w: HostRanks(w, legs.run_legs, (w, dict(starts)), device="cpu",
                          timeout=900) for w in (2, 4)}
    out = {}
    try:
        for (arch, tight), (js, m) in jsessions.items():
            js.train(legs.ROUNDS)
            out[arch + ("-tight" if tight else "")] = (
                _flat(js.state, m),
                [(h.client_loss, h.server_loss) for h in js.history])
    finally:
        out["ranks"] = {w: [r for _, r in h.wait()] for w, h in ranks.items()}
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["data2", "lanes2xdata2"])
def runs(request, refs):
    return request.param, refs["ranks"][request.param]


def _leg(runs, name):
    world, ranks = runs
    res = ranks[0][name]
    assert "error" not in res, res["error"]
    return world, res


def _gap(a, b):
    assert len(a) == len(b)
    return max(float(np.max(np.abs(x - y))) for x, y in zip(a, b))


def _loss_gap(ha, hb):
    assert len(ha) == len(hb)
    return max(max(abs(a[0] - b[0]), abs(a[1] - b[1]))
               for a, b in zip(ha, hb))


@pytest.mark.parametrize("leg", ["split", "tight"])
@pytest.mark.parametrize("arch", sorted(legs.ARCHS))
def test_split_keeps_each_ranks_experts(runs, arch, leg):
    """Every rank holds E / (data ranks) experts of each stack for
    compute and gathers none of their weights; the dispatch and combine
    moved this rank's entries over the exchange."""
    world, res = _leg(runs, leg)
    r = res[arch]
    print(f"reading {arch} moe {leg} world {world}: {r['experts']} of "
          f"{r['num_experts']} experts a rank, expert weights gathered "
          f"{r['expert_gathered']:.0f} B a step (all leaves "
          f"{r['gathered']:.0f}, plan {r['planned']:.0f}), exchanged "
          f"{r['exchanged']:.0f} B a step; census {r['census']}")
    assert r["experts"] == r["num_experts"] // r["data_ranks"] > 0
    assert r["expert_gathered"] == 0
    assert r["gathered"] == r["planned"]
    assert r["exchanged"] > 0
    if leg == "tight":
        assert r["census"]["dropped"] > 0 and r["census"]["crossing"] > 0


@pytest.mark.parametrize("arch", sorted(legs.ARCHS))
def test_split_matches_one_rank_fused(runs, arch):
    world, res = _leg(runs, "split")
    r = res[arch]
    gaps = {"state": _gap(r["state"], r["fused"]),
            "losses": _loss_gap(r["history"], r["fused_history"])}
    print(f"reading {arch} moe split world {world} vs port fused (pinned, "
          f"{r['flipped']} of {r['tokens']} choices replayed against their "
          f"own): " + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()))
    assert r["engine"] == "spmd"
    assert r["calls"] == r["recorded"] > 0
    assert max(gaps.values()) <= TOL, gaps


@pytest.mark.parametrize("arch", sorted(legs.ARCHS))
def test_split_matches_jax_fused(runs, refs, arch):
    world, res = _leg(runs, "split")
    want, jh = refs[arch]
    r = res[arch]
    gaps = {"state": _gap(r["state"], want),
            "losses": _loss_gap(r["history"], jh)}
    print(f"reading {arch} moe split world {world} vs JAX fused: "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()))
    assert max(gaps.values()) <= TOL, gaps


@pytest.mark.parametrize("arch", sorted(legs.ARCHS))
def test_split_gradients_match_one_rank_step(runs, arch):
    """One cohort step's gradients averaged over the batch ranks, as the
    engine averages them, equal the whole-batch step's leaf for leaf; the
    router's too (the aux loss's P carries dp times each rank's share)."""
    world, res = _leg(runs, "grads")
    r = res[arch]
    gaps = [float(np.max(np.abs(g - w))) for g, w in zip(r["got"], r["want"])]
    router = max(g for g, is_r in zip(gaps, r["router"]) if is_r)
    loss = float(np.max(np.abs(r["losses"] - r["want_losses"])))
    print(f"reading {arch} moe split world {world} gradients: max "
          f"{max(gaps):.2e}, router {router:.2e}, losses {loss:.2e}")
    assert len(gaps) == len(r["want"]) and any(r["router"])
    assert max(gaps + [loss]) <= TOL


@pytest.mark.parametrize("arch", sorted(legs.ARCHS))
def test_tight_split_matches_one_rank_and_jax_fused(runs, refs, arch):
    """At capacity factor ``legs.TIGHT`` experts drop entries and keep
    some of a later rank's (slots past the earlier ranks' loads): the
    split equals the one-rank fused run with routes pinned and the JAX
    fused run at 1e-5."""
    world, res = _leg(runs, "tight")
    r = res[arch]
    want, jh = refs[arch + "-tight"]
    gaps = {"state": _gap(r["state"], r["fused"]),
            "losses": _loss_gap(r["history"], r["fused_history"]),
            "jax state": _gap(r["state"], want),
            "jax losses": _loss_gap(r["history"], jh)}
    print(f"reading {arch} moe tight split world {world} (census "
          f"{r['census']}): " + ", ".join(f"{k} {v:.2e}"
                                          for k, v in gaps.items()))
    assert r["census"]["dropped"] > 0 and r["census"]["crossing"] > 0
    assert max(gaps.values()) <= TOL, gaps


@pytest.mark.parametrize("arch", sorted(legs.ARCHS))
def test_tight_gradients_match_one_rank_step(runs, arch):
    """One cohort step's gradients at ``legs.TIGHT``, each rank's experts
    only, the batch over every rank of the world: each rank's expert
    gradients equal the one-rank gradients' chunk, the rest (the router's
    included) their whole."""
    world, res = _leg(runs, "tight_grads")
    r = res[arch]
    gaps = [float(np.max(np.abs(g - w))) for g, w in zip(r["got"], r["want"])]
    loss = float(np.max(np.abs(r["losses"] - r["want_losses"])))
    print(f"reading {arch} moe tight gradients world {world}: max "
          f"{max(gaps):.2e}, losses {loss:.2e}, census {r['census']}, "
          f"exchanged {r['exchanged']:.0f} B")
    assert r["experts_split"] and any(r["router"])
    assert r["census"]["dropped"] > 0 and r["census"]["crossing"] > 0
    assert max(gaps + [loss]) <= TOL


@pytest.mark.parametrize("leg", ["slots_fault", "grads_fault"])
def test_expert_parallel_faults_are_rejected(runs, leg):
    """Entries written at their local slot (each rank's own entries from
    slot 0), and the owners' expert gradients all-reduced over the batch
    ranks as if every rank held all experts: each misses the one-rank
    run."""
    world, res = _leg(runs, leg)
    r = res["qwen3"]
    gap = max(_gap(r["state"], r["fused"]),
              _loss_gap(r["history"], r["fused_history"]))
    print(f"reading qwen3 moe split world {world} {leg}: {gap:.2e}")
    assert gap > TOL


def test_per_rank_loads_are_rejected(runs):
    world, res = _leg(runs, "loads_fault")
    r = res["qwen3"]
    gap = max(_gap(r["state"], r["fused"]),
              _loss_gap(r["history"], r["fused_history"]))
    print(f"reading qwen3 moe split world {world} per-rank loads fault: "
          f"{gap:.2e}")
    assert gap > TOL


def test_ranks_hold_the_same_results(runs):
    world, ranks = runs
    for other in ranks[1:]:
        for arch in legs.ARCHS:
            a, b = ranks[0]["split"][arch], other["split"][arch]
            assert "error" not in b, b["error"]
            assert a["history"] == b["history"], arch
            assert _gap(a["state"], b["state"]) == 0.0, arch


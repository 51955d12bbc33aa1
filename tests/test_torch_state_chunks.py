"""The spmd engine keeps the session's state as each rank's chunks
(``api.state.ShardedTrainState``) over 2 and 4 CPU ranks (gloo).

The ranks are spawned once per world size (``launch.hostdevices``) in a
module fixture that runs ``tests/torch_spmd_legs.chunk_legs``: the MLP
with its lanes over the ranks and with FSDP over "data", the glm4-9b
smoke tensor-parallel over "model" ((1, 2) and (2, 2), megatron) and the
qwen3-moe smoke with its experts over the data ranks (the data layout,
and on 4 ranks the grid).  Each leg trains K rounds, checks what the rank
holds, trains K more; beside it the same session trains 2K rounds in one
run, the parent's path (the state gathered whole between the two runs
and cut again), the planted fault (the second run's carry re-cut with
this rank's chunk index off by one, ``parity.shifted_chunks``) and the
fused engine on one rank.  Limits:

  * every tensor a rank holds is its chunk of the whole state, and
    ``SpmdEngine.state_bytes`` equals the ``chunk_shapes`` reckoning and
    the dry run's (``launch.dryrun.session_state_bytes``);
  * K + K rounds equal 2K rounds and the parent's path bit for bit;
  * the split run and its evaluations (``evaluate`` and
    ``evaluate_adaptive``, gathering one client's nets at a time) equal
    the fused engine's on one rank at tests/test_torch_spmd_engine.py's
    limits (1e-5 for lanes, tensor parallelism and the experts; 1e-4 for
    a data split), on every rank alike, and the MLP's equal the JAX
    package's fused session's;
  * the planted fault must miss the 2K-round run by more than the limit.
"""
import jax
import numpy as np
import pytest
import torch

import torch_spmd_legs as legs
from repro.api import TrainSession as JaxSession
from repro.config import HeteroProfile as JHeteroProfile
from repro.config import OptimizerConfig as JOptimizerConfig
from repro.config import SplitEEConfig as JSplitEEConfig
from repro.core import splitee as jsplitee
from repro_torch.convert import split_state_from_jax
from repro_torch.launch.hostdevices import HostRanks

#: tests/test_torch_spmd_engine.py's limits, by case
TOL = {"lanes": 1e-5, "fsdp": 1e-4, "tp": 1e-5, "qwen3-data": 1e-5,
       "qwen3-grid": 1e-5}
CASES = [(w, c[0]) for w in (2, 4) for c in legs.chunk_cases(w)]


def _ids(p):
    return f"world{p[0]}-{p[1]}"


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


def _eval_gap(a, b):
    """The largest gap of two (evaluate, evaluate_adaptive) results."""
    gap = 0.0
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            gap = max(gap, float(np.max(np.abs(np.asarray(x[k], float)
                                               - np.asarray(y[k], float)))))
    return gap


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def refs():
    """The MLP's start (the JAX init), the ranks of both world sizes on
    it, then the JAX package's fused session on the same data while the
    ranks work."""
    data = legs.mlp_data()
    js = JaxSession.from_config(
        jsplitee.MLPSplitModel(16, 32, 3, num_layers=4),
        JSplitEEConfig(profile=JHeteroProfile(legs.MLP_SPLITS),
                       aggregate_every=legs.MLP_AGG),
        JOptimizerConfig(lr=legs.MLP_LR, total_steps=30), data,
        legs.MLP_BATCH, engine="fused")
    inputs = {"mlp_data": data,
              "mlp_start": split_state_from_jax(js.state, legs.mlp_model())}
    ranks = {w: HostRanks(w, legs.chunk_legs, (w, inputs), device="cpu",
                          timeout=600) for w in (2, 4)}
    out = {}
    try:
        js.train(2 * legs.CHUNK_K["mlp"])
        xt, yt = legs.blobs(100, 16, 3, seed=9)
        out["jax"] = (_jax_keyed(js.state),
                      (js.evaluate(xt, yt), js.evaluate_adaptive(xt, yt,
                                                                 tau=0.5)))
    finally:
        out["ranks"] = {w: [r for _, r in h.wait()] for w, h in ranks.items()}
    return out


def _leg(refs, world, case):
    ranks = refs["ranks"][world]
    for r in ranks:
        assert "error" not in r[case], r[case]["error"]
    return ranks


@pytest.mark.parametrize("world,case", CASES, ids=map(_ids, CASES))
def test_state_is_each_ranks_chunks(refs, world, case):
    for r in _leg(refs, world, case):
        c = r[case]["chunks"]
        print(f"reading state bytes {case} world {world}: held "
              f"{c['held']:,}, reckoned {c['reckoned']:,}, engine "
              f"{c['state_bytes']:,}, dry run {c['dryrun']:,}, whole "
              f"{c['whole']:,}")
        assert c["bad"] == []
        assert (c["held"] == c["reckoned"] == c["state_bytes"]
                == c["dryrun"] > 0)
        assert c["state_bytes"] < c["whole"]


@pytest.mark.parametrize("world,case", CASES, ids=map(_ids, CASES))
def test_runs_from_chunks_equal_one_run_and_the_parents_path(refs, world,
                                                             case):
    for r in _leg(refs, world, case):
        res = r[case]
        assert res["engine"] == "spmd"
        assert _gap(res["split"], res["once"]) == 0.0
        assert _gap(res["split"], res["parent"]) == 0.0
        assert res["split_history"] == res["once_history"] == \
            res["parent_history"]


@pytest.mark.parametrize("world,case", CASES, ids=map(_ids, CASES))
def test_split_run_and_evaluation_match_one_rank(refs, world, case):
    ranks = _leg(refs, world, case)
    res = ranks[0][case]
    gaps = {"state": _gap(res["split"], res["fused"]),
            "evaluation": _eval_gap(res["split_eval"], res["fused_eval"])}
    print(f"reading chunks {case} world {world} vs the fused engine: "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()))
    assert max(gaps.values()) <= TOL[case], gaps
    for other in ranks[1:]:
        assert other[case]["split_eval"] == res["split_eval"]
        assert _gap(other[case]["split"], res["split"]) == 0.0


@pytest.mark.parametrize("world,case", CASES, ids=map(_ids, CASES))
def test_shifted_chunks_are_rejected(refs, world, case):
    res = _leg(refs, world, case)[0][case]
    gap = _gap(res["fault"], res["once"])
    print(f"reading chunks {case} world {world} planted fault: {gap:.2e}")
    assert gap > TOL[case]


@pytest.mark.parametrize("world,case", [(w, c) for w in (2, 4)
                                        for c in ("lanes", "fsdp")])
def test_mlp_chunks_match_jax(refs, world, case):
    res = _leg(refs, world, case)[0][case]
    want, want_eval = refs["jax"]
    gaps = {"state": _gap(res["split"], want),
            "evaluation": _eval_gap(res["split_eval"], want_eval)}
    print(f"reading chunks {case} world {world} vs JAX fused: "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()))
    assert max(gaps.values()) <= TOL[case], gaps

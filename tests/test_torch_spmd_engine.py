"""The port's spmd engine (``repro_torch.api.spmd_engine``) over 2 and 4
CPU ranks (gloo), held against the JAX package's fused engine and the
port's own.

The ranks are spawned once per world size (``launch.hostdevices``) in a
module fixture that runs every leg of ``tests/torch_spmd_legs.py``; each
leg's result, or its traceback, is stored under its own key, so one broken
leg fails its own tests only.  Limits:

  * lanes spread over ranks, no data split: 1e-5 against the port's and
    the JAX package's fused engines (the engine-equivalence bound);
  * a data split (FSDP on and off): 1e-4, the JAX spmd tests' own
    reduction-order bound (tests/test_spmd_engine.py);
  * the float64 ResNet with BatchNorm under a data split: 1e-6 against the
    JAX fused engine, and the same run with per-rank statistics must miss
    it;
  * the population run: tests/test_torch_population.py's MLP bound, 1e-5;
  * tensor parallelism over "model" (the glm4-9b smoke, fp32, on (1, 2)
    and (2, 2) under megatron and greedy; the deepseek-v3, qwen3-moe,
    rwkv6 and zamba2 smokes at a lowered ``min_shard_elems``;
    tests/torch_tp_legs.py): the steps and two rounds of the sessions
    against the one-rank port at 1e-5, four planted faults that must
    miss, and the dry run's fake trace equal to the real step's counts.

The refusals (``SpmdEngine.supports``) are compared with the JAX engine's
in this process, on device-free ``MeshSpec``s.
"""
import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spmd_legs as legs
import torch_tp_legs as tl_legs
from repro.api import TrainSession as JaxSession
from repro.api.engines import SessionContext as JContext
from repro.api.spmd_engine import SpmdEngine as JSpmd
from repro.config import HeteroProfile as JHeteroProfile
from repro.config import OptimizerConfig as JOptimizerConfig
from repro.config import SplitEEConfig as JSplitEEConfig
from repro.core import splitee as jsplitee
from repro.launch.mesh import MeshSpec as JMeshSpec
from repro.models import resnet as jresnet
from repro.population import ClientPopulation as JPopulation
from repro_torch.api import TrainSession
from repro_torch.api.engines import SessionContext
from repro_torch.api.spmd_engine import SpmdEngine
from repro_torch.convert import split_net_to_jax, split_state_from_jax
from repro_torch.data.pipeline import ClientPartitioner
from repro_torch.data.synthetic import SyntheticImageDataset
from repro_torch.launch.hostdevices import HostRanks
from repro_torch.launch.mesh import MeshSpec

TOL_LANES = 1e-5
TOL_DATA = 1e-4
TOL_F64 = 1e-6
TOL_POP = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """At most two torch threads in this process (tests/test_torch_fused.py
    says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


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


def _loss_gap(ha, hb):
    assert len(ha) == len(hb)
    return max(max(abs(a[0] - b[0]), abs(a[1] - b[1]))
               for a, b in zip(ha, hb))


def _jhist(h):
    return [(m.client_loss, m.server_loss, m.active_clients, m.stragglers)
            for m in h]


@dataclasses.dataclass
class _JaxResNet(jsplitee.ResNetSplitModel):
    """The JAX adapter holding the port model's initial weights (the JAX
    init compiles for seconds in float64; the runs are compared from one
    state either way)."""

    port: object = None

    def __post_init__(self):
        self.full_params = _to_jax(self.port.full_params)
        self.full_state = _to_jax(self.port.full_state)

    def make_client(self, li):
        return _to_jax(self.port.make_client(li))


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, split_net_to_jax(tree))


def _wide_bn(js):
    """The JAX ResNet's BatchNorm statistics started in float64 (the
    scanned carry refuses a dtype change)."""
    wide = lambda nets: tuple(  # noqa: E731
        {**n, "state": jax.tree.map(lambda a: a.astype(jnp.float64),
                                    n["state"])} for n in nets)
    js.state = js.state.replace(clients=wide(js.state.clients),
                                servers=wide(js.state.servers))


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The inputs of every leg, the ranks of both world sizes started on
    them, then the JAX package's fused runs while the ranks work."""
    tmp = tmp_path_factory.mktemp("spmd")
    out = {"tmp": str(tmp)}
    data = legs.mlp_data()
    js = JaxSession.from_config(
        jsplitee.MLPSplitModel(16, 32, 3, num_layers=4),
        JSplitEEConfig(profile=JHeteroProfile(legs.MLP_SPLITS),
                       aggregate_every=legs.MLP_AGG),
        JOptimizerConfig(lr=legs.MLP_LR, total_steps=30), data,
        legs.MLP_BATCH, engine="fused")
    out["mlp_data"] = data
    out["mlp_start"] = split_state_from_jax(js.state, legs.mlp_model())
    out["jax_ckpt"] = str(tmp / "jax-ckpt")
    js.save(out["jax_ckpt"])                      # a JAX checkpoint, round 0
    ds = SyntheticImageDataset(num_classes=10,
                               image_size=legs.RES_CFG["image_size"],
                               train_size=4 * 2 * legs.RES_BATCH,
                               test_size=8, seed=0)
    out["res_data"] = [(x.astype(np.float64), y)
                       for x, y in ClientPartitioner(4).split(*ds.train)]
    with jax.enable_x64(True):
        jr = JaxSession.from_config(
            _JaxResNet(dataclasses.replace(
                jresnet.ResNetConfig(**legs.RES_CFG), dtype=jnp.float64),
                port=legs.resnet_model()),
            JSplitEEConfig(profile=JHeteroProfile(legs.RES_SPLITS)),
            JOptimizerConfig(lr=legs.RES_LR, total_steps=20,
                             state_dtype=jnp.float64),
            out["res_data"], legs.RES_BATCH, engine="fused")
        jr.engine.overlap_staging = False
        _wide_bn(jr)
        out["res_start"] = split_state_from_jax(jr.state, legs.resnet_model())
    x, y = legs.pop_data()
    jp = JaxSession.from_config(
        jsplitee.MLPSplitModel(16, 32, 3, num_layers=4),
        JSplitEEConfig(profile=JHeteroProfile(legs.POP_SLOTS)),
        JOptimizerConfig(lr=3e-3, total_steps=30), None,
        batch_size=legs.POP_BATCH, engine="fused",
        population=JPopulation.dirichlet(
            x, y, 10, legs.POP_SLOTS, alpha=0.5, seed=0,
            min_shard=legs.POP_BATCH, **legs.CHURN))
    out["pop_start"] = split_state_from_jax(jp.state, legs.mlp_model())

    ranks = {w: HostRanks(w, legs.run_legs, (w, dict(out)), device="cpu",
                          timeout=900) for w in (2, 4)}

    def mlp():
        js.train(legs.MLP_ROUNDS)
        return _jax_keyed(js.state), _jhist(js.history)

    def resnet():
        with jax.enable_x64(True):          # a thread's own setting
            jr.train(legs.RES_ROUNDS)
            return _jax_keyed(jr.state), _jhist(jr.history)

    def pop():
        jp.train(legs.POP_ROUNDS, legs.POP_EPOCHS, chunk_rounds=4)
        return _jax_keyed(jp.state), _jhist(jp.history)

    try:
        # the references, each run alone in a thread of its own (the JAX
        # runs compile for most of their time), and the port's fused
        # engine on the tiny dense backbone
        with ThreadPoolExecutor(3) as pool:
            runs = {k: pool.submit(f) for k, f in (
                ("mlp_want", mlp), ("res_want", resnet), ("pop_want", pop))}
            out["backbone_want"] = legs.backbone_run("fused")
            out.update({k: f.result() for k, f in runs.items()})
    finally:
        out["ranks"] = {w: [r for _, r in h.wait()] for w, h in ranks.items()}
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def runs(request, refs):
    """Every leg's result on ``world`` ranks: ``(world, [per rank])``."""
    return request.param, refs["ranks"][request.param]


def _leg(runs, name):
    world, ranks = runs
    res = ranks[0][name]
    assert "error" not in res, res["error"]
    return world, res


def _reading(what, world, gaps):
    print(f"reading {what} world {world}: "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()))


# ---------------------------------------------------------------------------
# the MLP: lanes, data split, Eq. (1), sum mode
# ---------------------------------------------------------------------------


def test_lanes_match_both_fused_engines(runs, refs):
    world, res = _leg(runs, "lanes")
    want, jh = refs["mlp_want"]
    gaps = {"vs JAX fused": _gap(res["state"], want),
            "losses vs JAX": _loss_gap(res["history"], jh),
            "vs port fused": _gap(res["state"], res["fused"]),
            "losses vs port": _loss_gap(res["history"],
                                        res["fused_history"])}
    _reading("mlp lanes", world, gaps)
    assert res["engine"] == "spmd"
    assert max(gaps.values()) <= TOL_LANES, gaps


@pytest.mark.parametrize("leg", ["data_fsdp", "data_nofsdp"])
def test_data_split_matches_jax_fused(runs, refs, leg):
    world, res = _leg(runs, leg)
    want, jh = refs["mlp_want"]
    gaps = {"state": _gap(res["state"], want),
            "losses": _loss_gap(res["history"], jh)}
    _reading(f"mlp {leg}", world, gaps)
    assert res["engine"] == "spmd"
    assert max(gaps.values()) <= TOL_DATA, gaps


def test_skipped_eq1_lane_reduce_is_rejected(runs, refs):
    """The planted fault: Eq. (1)'s partial sums not summed over the lanes
    group.  The lanes comparison must see it."""
    world, res = _leg(runs, "lanes_eq1_fault")
    gap = _gap(res["state"], refs["mlp_want"][0])
    _reading("mlp eq1 lanes fault", world, {"state": gap})
    assert gap > TOL_LANES


def test_sum_mode_converges(runs):
    world, res = _leg(runs, "sum")
    h = res["history"]
    assert all(np.isfinite(v) for m in h for v in m[:2])
    assert h[-1][0] < h[0][0] and h[-1][1] < h[0][1], h


@pytest.mark.parametrize("leg", ["data_fsdp", "lanes"])
def test_gather_plan_matches_measured_bytes(runs, leg):
    """``api/spmd_engine.unshard_plan`` (what the dry run reads) predicts
    the bytes each cohort step gathered on every rank, to the byte, on the
    FSDP data leg (gathers over "data") and the lanes leg."""
    world, ranks = runs
    for r in ranks:
        res = r[leg]
        assert "error" not in res, res["error"]
        print(f"reading gathered bytes {leg} world {world}: measured "
              f"{res['gathered']:.1f}, planned {res['planned']:.1f}")
        assert res["planned"] == res["gathered"]
    if leg == "data_fsdp":
        assert ranks[0][leg]["gathered"] > 0


def test_ranks_hold_the_same_results(runs):
    world, ranks = runs
    for name in ("lanes", "data_fsdp", "resnet", "population"):
        a = ranks[0][name]
        assert "error" not in a, a["error"]
        for other in ranks[1:]:
            b = other[name]
            assert b["history"] == a["history"], name
            assert _gap(a["state"], b["state"]) == 0.0, name


# ---------------------------------------------------------------------------
# BatchNorm under a data split
# ---------------------------------------------------------------------------


def test_resnet_synced_batchnorm_matches_jax(runs, refs):
    world, res = _leg(runs, "resnet")
    want, jh = refs["res_want"]
    gaps = {"state": _gap(res["state"], want),
            "losses": _loss_gap(res["history"], jh)}
    _reading("resnet f64 data split", world, gaps)
    assert max(gaps.values()) <= TOL_F64, gaps


def test_resnet_per_rank_statistics_are_rejected(runs, refs):
    world, res = _leg(runs, "resnet_bn_fault")
    gap = _gap(res["state"], refs["res_want"][0])
    _reading("resnet per-rank BatchNorm fault", world, {"state": gap})
    assert gap > TOL_F64


# ---------------------------------------------------------------------------
# populations, the backbone, shards
# ---------------------------------------------------------------------------


def test_population_matches_jax(runs, refs):
    world, res = _leg(runs, "population")
    want, jh = refs["pop_want"]
    gaps = {"state": _gap(res["state"], want),
            "losses": _loss_gap(res["history"], jh)}
    _reading("population masked spmd", world, gaps)
    assert res["engine"] == "spmd"
    assert max(gaps.values()) <= TOL_POP, gaps
    assert [m[2:] for m in res["history"]] == [m[2:] for m in jh]


def test_backbone_under_lanes_matches_fused(runs, refs):
    world, res = _leg(runs, "backbone")
    want = refs["backbone_want"]
    gaps = {"state": _gap(res["state"], want["state"]),
            "losses": _loss_gap(res["history"], want["history"])}
    _reading("glm4 smoke lanes vs fused", world, gaps)
    assert res["engine"] == "spmd" and want["engine"] == "fused"
    assert max(gaps.values()) <= TOL_LANES, gaps


def test_lane_fsdp_shards_are_real(runs):
    """Every stored leaf holds 1/size of the whole cohort tensor where its
    spec splits it: its lanes and its chunk of every sharded dim."""
    world, res = _leg(runs, "shards")
    sizes = res["sizes"]
    split = 0
    for li, path, shape, spec, numel, whole in res["leaves"]:
        n = 1
        for entry in spec:
            for a in legs._axes(entry):
                n *= sizes[a]
        assert numel * n == whole, (li, path, shape, spec)
        split += any(e is not None for e in spec[1:])
    assert split > 0


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_resume_across_recipes_and_engines(runs):
    world, res = _leg(runs, "resume")
    assert res["replicate_engine"] == "spmd"
    assert res["replicate_recipe"] == "replicate"
    assert res["fused_engine"] == "fused"
    for name in ("replicate", "fused"):
        gaps = {"state": _gap(res[name], res["full"]),
                "losses": _loss_gap(res[f"{name}_history"],
                                    res["full_history"])}
        _reading(f"resume under {name}", world, gaps)
        assert max(gaps.values()) <= TOL_DATA, (name, gaps)


def test_only_the_coordinator_wrote_the_checkpoint(runs):
    world, res = _leg(runs, "resume")
    assert res["files"] == ["ckpt-00000002.json", "ckpt-00000002.npz"]


def test_spmd_checkpoint_loads_in_jax(runs):
    """The spmd run's round-2 checkpoint restores in the JAX package, every
    leaf equal to the state the ranks held."""
    world, res = _leg(runs, "resume")
    js = JaxSession.restore(res["ckpt"],
                            jsplitee.MLPSplitModel(16, 32, 3, num_layers=4),
                            legs.mlp_data(), engine="fused")
    assert _gap(_jax_keyed(js.state), res["saved"]) == 0.0
    assert js.ctx.recipe_name == "custom"


def test_jax_checkpoint_resumes_under_spmd(runs, refs):
    world, res = _leg(runs, "jax_checkpoint")
    want, jh = refs["mlp_want"]
    gaps = {"state": _gap(res["state"], want),
            "losses": _loss_gap(res["history"], jh)}
    _reading("JAX checkpoint resumed under spmd", world, gaps)
    assert res["engine"] == "spmd" and res["recipe"] == "greedy"
    assert max(gaps.values()) <= TOL_LANES, gaps


# ---------------------------------------------------------------------------
# refusals, reason for reason
# ---------------------------------------------------------------------------

LDM = ("lanes", "data", "model")


@pytest.mark.parametrize("mesh,recipe,batch,phrase", [
    (None, None, 32, "needs a mesh"),
    (((2, 1, 1), LDM), "replicate", 32, "only has parallelism on its lanes"),
    (((1, 1), ("data", "model")), None, 32, "has no parallelism"),
    (((3, 1), ("data", "model")), None, 32, "does not divide over the "
                                            "data-parallel size"),
    (((3, 1, 1), LDM), None, 30, "divides no cohort's lane count"),
], ids=["no-ranks", "lanes-disabled", "no-parallelism", "batch",
        "lanes-divide-none"])
def test_refusals_mirror_jax(mesh, recipe, batch, phrase):
    data = legs.mlp_data()
    jm = None if mesh is None else JMeshSpec(*mesh)
    tm = None if mesh is None else MeshSpec(*mesh)
    jctx = JContext(jsplitee.MLPSplitModel(16, 32, 3, num_layers=4),
                    JSplitEEConfig(profile=JHeteroProfile(legs.MLP_SPLITS)),
                    JOptimizerConfig(), data, batch, mesh=jm, recipe=recipe)
    tctx = SessionContext(legs.mlp_model(),
                          legs.mlp_configs()[0], legs.mlp_configs()[1], data,
                          batch, mesh=tm, recipe=recipe)
    jr, tr = JSpmd.supports(jctx), SpmdEngine.supports(tctx)
    assert jr is not None and phrase in jr, jr
    assert tr is not None and phrase in tr, tr
    with pytest.raises(ValueError, match=phrase.split("'")[0]):
        TrainSession(legs.mlp_model(), *legs.mlp_configs(), data, batch,
                     engine="spmd", mesh=tm, recipe=recipe)


def test_mesh_of_another_size_and_moe_data_split_are_refused():
    """The port's one further reason, a mesh that does not match the
    world, is refused; a data split of a mixture-of-experts model is not
    (``models/moe.py`` routes the whole batch over the batch ranks;
    tests/test_torch_moe_split.py runs it): on a world of one rank its
    only reason is the world's size."""
    data = legs.mlp_data()
    tctx = SessionContext(legs.mlp_model(), *legs.mlp_configs(), data, 32,
                          mesh=MeshSpec((2, 1), ("data", "model")))
    world = SpmdEngine.supports(tctx)
    assert "the torch.distributed world has 1" in world
    from repro_torch.configs import qwen3_moe_235b_a22b
    from repro_torch.core.backbone_splitee import BackboneSplitModel
    moe = BackboneSplitModel(qwen3_moe_235b_a22b.smoke(), device="cpu")
    tctx = SessionContext(moe, legs.mlp_configs()[0].__class__(
        profile=legs.mlp_configs()[0].profile.__class__(
            (sorted(moe.cfg.exit_layers)[0],) * 4)),
        legs.mlp_configs()[1], data, 32,
        mesh=MeshSpec((2, 1), ("data", "model")))
    assert SpmdEngine.supports(tctx) == world


def test_unknown_recipe_dies_at_the_facade():
    with pytest.raises(ValueError, match="unknown sharding recipe"):
        SessionContext(legs.mlp_model(), *legs.mlp_configs(),
                       legs.mlp_data(), 32, recipe="nope")



# ---------------------------------------------------------------------------
# tensor parallelism over "model" (tests/torch_tp_legs.py, run in these
# worlds: (1, 2) on 2 ranks, (2, 2) on 4)
# ---------------------------------------------------------------------------

TOL_TP = 1e-5


def _tp(runs, name, rank=0):
    world, ranks = runs
    res = ranks[rank]["tp"][name]
    assert "error" not in res, res["error"]
    return world, res


@pytest.mark.parametrize("recipe", ["megatron", "greedy"])
def test_tp_step_matches_one_rank(runs, recipe):
    """On every rank the tensor-parallel train step's client and server
    losses and every gradient (its chunks gathered) equal the one-rank
    step's, the clip norm of the chunks equals the whole gradients', and
    the vocab-parallel accuracy finds the whole logits' argmax."""
    world, ranks = runs
    for r in range(world):
        _, res = _tp(runs, f"step-{recipe}", r)
        gaps = {k: abs(res["metrics"][k] - res["want_metrics"][k])
                for k in res["want_metrics"]}
        gaps["gradients"] = res["grad_gap"]
        gaps["clip norm (relative)"] = res["norm_gap"]
        if r == 0:
            _reading(f"tp step {recipe}", world, gaps)
        assert max(gaps.values()) <= TOL_TP, (r, gaps)
        assert res["tp_bytes"]["all_reduce"] > 0
        # the accuracy over vocab-split logits: every argmax found
        assert res["logits_split"] and res["argmax_hits"] == 1.0, r


@pytest.mark.parametrize("recipe", ["megatron", "greedy"])
def test_tp_session_matches_one_rank(runs, refs, recipe):
    """Two rounds of ``TrainSession`` over the model mesh equal the port's
    one-rank fused run (Adam states included), every rank holds the same
    state, and a step gathers exactly what the plan says: on (1, 2) no
    weight at all (every split leaf's chunk is read in place)."""
    world, res = _tp(runs, f"session-{recipe}")
    want = refs["backbone_want"]
    gaps = {"state": _gap(res["state"], want["state"]),
            "losses": _loss_gap(res["history"], want["history"])}
    _reading(f"tp session {recipe}", world, gaps)
    assert res["engine"] == "spmd"
    assert max(gaps.values()) <= TOL_TP, gaps
    for r in range(1, world):
        other = _tp(runs, f"session-{recipe}", r)[1]
        assert _gap(other["state"], res["state"]) == 0.0, r
        assert other["history"] == res["history"], r
    assert res["gathered"] == res["planned"]
    if world == 2:
        assert res["gathered"] == 0
    assert res["tp_bytes"] > 0


def test_tp_clip_norm_sums_the_split_leaves(runs):
    """With a clip norm that clips, the tensor-parallel session equals the
    one-rank fused run: the norm sums the split leaves' squares over the
    model group and counts the whole leaves once."""
    world, res = _tp(runs, "clip")
    gaps = {"state": _gap(res["spmd"]["state"], res["fused"]["state"]),
            "losses": _loss_gap(res["spmd"]["history"],
                                res["fused"]["history"])}
    _reading("tp clip", world, gaps)
    assert max(gaps.values()) <= TOL_TP, gaps


@pytest.mark.parametrize("fault", ["fault-row", "fault-sumexp",
                                   "fault-expert-parts",
                                   "fault-norm-squares"])
def test_tp_planted_faults_are_rejected(runs, fault):
    """A row-parallel output left un-reduced, a vocab-parallel cross
    entropy whose sum of exponentials is left per rank, the deepseek
    smoke's expert outputs left unsummed over the model group (each
    rank's own experts taken as the whole MoE), and the rwkv6 smoke's
    output norm taking each rank's sum of squares as the row's: the step
    comparison must miss on some rank."""
    world, ranks = runs
    worst = 0.0
    for r in range(world):
        _, res = _tp(runs, fault, r)
        gaps = [abs(res["metrics"][k] - res["want_metrics"][k])
                for k in res["want_metrics"]] + [res["grad_gap"]]
        worst = max(worst, max(gaps))
    _reading(f"tp {fault}", world, {"worst": worst})
    assert worst > TOL_TP


def _fake_trace(world, name, recipe):
    """The dry run's trace of smoke ``name``'s tensor-parallel step under
    ``recipe`` on fake tensors: a counting model group (nothing sent),
    each leaf at rank 0's compute shape; where the expert stacks keep
    their chunks over the data ranks, rank 0's rows under a counting
    batch group and expert group, as its real step ran them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    import torch_tp_legs as tl
    from repro_torch.core.spmd import make_grad_step
    from repro_torch.launch import tensor_parallel as tpm
    from repro_torch.launch.meshcomm import chunk_shapes
    from repro_torch.launch.shardings import (_lookup, expert_axes,
                                              expert_blocks, jax_layout,
                                              kept_experts, kept_spec,
                                              map_with_path,
                                              param_specs, port_specs,
                                              resolve_recipe, tp_roles)
    from repro_torch.launch.step_analysis import StepAnalysis
    from repro_torch.models.sync_stats import synced_batch_stats
    cfg, params, batch, sc = tl.step_setup(name)
    mesh = MeshSpec(tl.MESH[world], tl.DM)
    sizes = {"data": tl.MESH[world][0], "model": 2}
    rc = resolve_recipe(recipe)
    specs = port_specs(param_specs(jax_layout(params, cfg), cfg, mesh, rc),
                       params, cfg)
    roles = tp_roles(params, specs, mesh, cfg, rc)
    g = tpm.ModelGroup(None, 2, 0, expert_blocks=expert_blocks(roles))
    shapes = chunk_shapes(params, map_with_path(
        lambda p, _: kept_spec(_lookup(specs, p), _lookup(roles, p)),
        params), sizes, lead=0)
    split = contextlib.nullcontext()
    if expert_axes(roles):
        D = sizes["data"]
        batch = {k: v[:tl.STEP_B // D] for k, v in batch.items()}
        split = contextlib.ExitStack()
        split.enter_context(synced_batch_stats(None, D, 0))
        split.enter_context(tpm.expert_parallel(tpm.ExpertGroup(
            None, D, 0, kept_experts(roles, cfg.moe.num_experts, sizes))))
    with FakeTensorMode(allow_non_fake_inputs=True):
        local = map_with_path(lambda _, t: torch.empty(t.shape,
                                                       dtype=t.dtype),
                              shapes)
        fake_batch = {k: torch.empty(v.shape, dtype=v.dtype)
                      for k, v in batch.items()}
        with StepAnalysis() as a, tpm.model_parallel(g), split:
            make_grad_step(sc)(local, fake_batch)
    return a.result()


def _same_counts(fake, real, what):
    """The fake trace counts the real step's FLOPs, kernel sites and
    collectives; an expert exchange, whose rows the routing decides, at
    a bound the real one cannot exceed (every entry's row)."""
    print(f"reading tp fake vs real {what}: flops "
          f"{fake['flops']:.0f} / {real['flops']:.0f}, site flops "
          f"{fake['site_flops']} / {real['site_flops']}, collectives "
          f"{fake['collectives']} / {real['collectives']}")
    for key in ("flops", "site_flops", "site_calls"):
        assert fake[key] == real[key], key
    fk, rk = dict(fake["collectives"]), dict(real["collectives"])
    bound, moved = fk.pop("all_to_all", None), rk.pop("all_to_all", None)
    assert fk == rk
    assert (bound is None) == (moved is None)
    if bound is not None:
        assert bound["count"] == moved["count"]
        assert bound["bytes"] >= moved["bytes"] > 0
    assert fake["collectives"]["all_reduce"]["bytes"] > 0


@pytest.mark.parametrize("recipe", ["megatron", "greedy"])
def test_tp_fake_trace_counts_the_real_step(runs, recipe):
    """The dry run's trace of the tensor-parallel step on fake tensors (a
    counting model group, nothing sent) counts the FLOPs, the kernel
    sites and the collectives that rank 0's real step counted."""
    world, res = _tp(runs, f"step-{recipe}")
    _same_counts(_fake_trace(world, "glm4", recipe), res["analysis"],
                 f"{recipe} world {world}")


# ---------------------------------------------------------------------------
# the MoE, MLA, RWKV6 and Mamba2 smokes over "model" (tests/torch_tp_legs.py
# FAMILY_STEPS, FAMILY_SESSIONS: a recipe with a lowered min_shard_elems)
# ---------------------------------------------------------------------------

FAMILY_STEPS = [leg for leg, _, _ in tl_legs.FAMILY_STEPS]


@pytest.mark.parametrize("leg", FAMILY_STEPS)
def test_tp_family_step_matches_one_rank(runs, leg):
    """deepseek-v3 (MLA over heads and over its latent, experts over the
    grid), qwen3-moe (experts over the grid and in the data layout),
    rwkv6 (the wkv on each rank's heads) and zamba2 (Mamba2's projections)
    smokes: on every rank the step's losses and every gradient equal the
    one-rank step's (a split leaf's gradient its chunk, an expert stack's
    its experts') at 1e-5, the clip norm of the chunks the whole
    gradients', and some leaf of the family is split."""
    world, ranks = runs
    for r in range(world):
        _, res = _tp(runs, f"step-{leg}", r)
        gaps = {k: abs(res["metrics"][k] - res["want_metrics"][k])
                for k in res["want_metrics"]}
        gaps["gradients"] = res["grad_gap"]
        gaps["clip norm (relative)"] = res["norm_gap"]
        if r == 0:
            _reading(f"tp step {leg}", world, gaps)
        assert max(gaps.values()) <= TOL_TP, (r, gaps)
        assert res["tp_bytes"]["all_reduce"] > 0
        assert res["logits_split"] and res["argmax_hits"] == 1.0, r
    kinds = {}
    for path, kind in res["roles"]:
        if any(k in path for k in ("mixer", "ffn", "shared_attn")):
            kinds[kind] = kinds.get(kind, 0) + 1
    print(f"reading tp step {leg} block roles: {kinds}")
    assert kinds.get("column", 0) + kinds.get("expert", 0) > 0, kinds
    if leg.startswith(("deepseek", "qwen3-grid")):
        assert kinds.get("expert", 0) > 0, kinds


@pytest.mark.parametrize("leg", ["deepseek-megatron", "deepseek-greedy",
                                 "qwen3-grid", "qwen3-data"])
def test_tp_family_experts_stay_split(runs, leg):
    """The MoE smokes' expert stacks stay this rank's chunk for the step:
    over (1, 2) the grid's E / 2 experts a rank; over (2, 2) E / 4 over
    the grid and E / 2 in the data layout (``"data-experts"``: E over
    "data", the hidden dims over "model"), the batch split over the data
    ranks and the dispatch and combine an exchange over them."""
    world, ranks = runs
    for r in range(world):
        _, res = _tp(runs, f"step-{leg}", r)
        E = tl_legs.SMOKES[leg.split("-")[0]]().moe.num_experts
        per = E // res["expert_ranks"]
        if not leg.endswith("data"):
            per //= 2
        if r == 0:
            print(f"reading tp step {leg} world {world}: experts a rank "
                  f"{sorted(set(res['experts']))} of {E}, exchanged "
                  f"{res['exchanged']:.0f} B")
        assert set(res["experts"]) == {per}, (r, res["experts"])
        assert res["expert_ranks"] == tl_legs.MESH[world][0]
        assert (res["exchanged"] > 0) == (world == 4)


@pytest.mark.parametrize("leg", ["deepseek-megatron", "qwen3-data"])
def test_tp_family_session_keeps_the_experts(runs, leg):
    """Two rounds of ``TrainSession`` over the model mesh: a rank holds
    its experts alone for compute and gathers no expert weight; over
    (2, 2) its entries cross the exchange."""
    world, res = _tp(runs, f"session-{leg}")
    got = res["spmd"]
    E = tl_legs.SMOKES[leg.split("-")[0]]().moe.num_experts
    per = E // tl_legs.MESH[world][0] // (1 if leg.endswith("data") else 2)
    print(f"reading tp session {leg} world {world}: {got['experts']} "
          f"experts a rank, expert weights gathered "
          f"{got['expert_gathered']:.0f} B a step, exchanged "
          f"{got['exchanged']:.0f} B a step")
    assert got["experts"] == per
    assert got["expert_gathered"] == 0
    assert (got["exchanged"] > 0) == (world == 4)


@pytest.mark.parametrize("leg", list(tl_legs.FAMILY_SESSIONS))
def test_tp_family_session_matches_one_rank(runs, leg):
    """Two rounds of ``TrainSession`` on the spmd engine over the model
    mesh equal the port's fused engine on one rank (Adam states
    included), and every rank holds the same state."""
    world, res = _tp(runs, f"session-{leg}")
    got, want = res["spmd"], res["fused"]
    gaps = {"state": _gap(got["state"], want["state"]),
            "losses": _loss_gap(got["history"], want["history"])}
    _reading(f"tp session {leg}", world, gaps)
    assert got["engine"] == "spmd"
    assert max(gaps.values()) <= TOL_TP, gaps
    assert got["tp_bytes"] > 0
    for r in range(1, world):
        other = _tp(runs, f"session-{leg}", r)[1]["spmd"]
        assert _gap(other["state"], got["state"]) == 0.0, r
        assert other["history"] == got["history"], r


@pytest.mark.parametrize("leg,name,recipe", [
    ("deepseek-megatron", "deepseek", "megatron"),
    ("qwen3-data", "qwen3", "data-experts"),
    ("rwkv6-megatron", "rwkv6", "megatron")])
def test_tp_family_fake_trace_counts_the_real_step(runs, leg, name, recipe):
    """The dry run's fake trace of the deepseek (a rank's experts over
    the grid), qwen3-moe (in the data layout) and rwkv6 (the wkv on a
    rank's heads) steps counts what rank 0's real step counted: FLOPs,
    the wkv site's FLOPs and calls, collectives -- over (2, 2), where the
    experts keep their chunks over the data ranks, the exchange at its
    bound, at or above the real exchange's bytes; the wkv sites count
    one rank's heads (``dispatch.wkv_site_flops(..., ranks=2)``, below
    the whole model's)."""
    from repro_torch.kernels.dispatch import wkv_site_flops
    world, res = _tp(runs, f"step-{leg}")
    fake = _fake_trace(world, name, tl_legs.family_recipe(recipe))
    _same_counts(fake, res["analysis"], f"{leg} world {world}")
    if name == "rwkv6":
        cfg = tl_legs.SMOKES[name]()
        for kind in ("fwd", "bwd"):
            assert fake["site_flops"][f"wkv_{kind}"] == wkv_site_flops(
                cfg, tl_legs.STEP_B, tl_legs.STEP_T,
                "train" if kind == "fwd" else kind, ranks=2) < \
                wkv_site_flops(cfg, tl_legs.STEP_B, tl_legs.STEP_T,
                               "train" if kind == "fwd" else kind), kind

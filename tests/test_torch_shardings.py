"""The port's sharding recipes (``repro_torch.launch.shardings``) held leaf
for leaf against the JAX package's (``repro.launch.shardings``), and the
port's mesh helpers against the JAX ones.

Every architecture id of the registry, at full size (the JAX parameter
trees through ``jax.eval_shape``, the port's initialised on the meta
device, so nothing is materialised) and as the smoke cohort carries of
tests/test_configs_conformance.py, under every named recipe (and the
conformance test's recipes with the tiny-leaf floor lowered, so the small
leaves shard too), on five ``MeshSpec``s: (2,2,1) lanes/data/model, (4,2)
data/model, the (16,16) and (2,16,16) production meshes and the
production mesh with the lanes factored out, (2,8,16).  The port's trees
keep one dict per layer and OIHW convs; ``jax_layout`` restacks them into
the JAX package's layout first, and the test asserts the shapes equal
leaf for leaf before it compares the specs.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.api.spmd_engine import abstract_cohort_carry as jax_carry
from repro.config import OptimizerConfig as JOptimizerConfig
from repro.config import ShapeConfig
from repro.configs import resnet18_cifar as jresnet18
from repro.core.backbone_splitee import BackboneSplitModel as JBackbone
from repro.core.splitee import ResNetSplitModel as JResNetSplitModel
from repro.launch import mesh as jmesh
from repro.launch import shardings as jsh
from repro.launch.inputs import abstract_params, train_input_specs
from repro.models import sharding_ctx as jsharding_ctx
from repro.models.backbone import init_cache as jinit_cache
from repro_torch import configs as tconfigs
from repro_torch.api.spmd_engine import abstract_cohort_carry, carry_specs
from repro_torch.config import OptimizerConfig
from repro_torch.configs import resnet18_cifar
from repro_torch.core.backbone_splitee import BackboneSplitModel
from repro_torch.core.splitee import ResNetSplitModel
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shardings as tsh
from repro_torch.models import sharding_ctx
from repro_torch.models.backbone import init_backbone, init_cache

MESHES = [((2, 2, 1), ("lanes", "data", "model")),
          ((4, 2), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 8, 16), ("lanes", "data", "model"))]
RECIPES = sorted(jsh.NAMED_RECIPES)


class _MetaGenerator:
    """Stands in for a ``torch.Generator``: the port's initialisers draw on
    the generator's device, and a draw on the meta device allocates
    nothing."""

    device = torch.device("meta")


def _jax_specs(specs, tree):
    """The JAX spec of every leaf of ``tree``, one entry per dim."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    ps = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, P))
    assert len(ps) == len(flat)
    return [tuple(p) + (None,) * (len(leaf.shape) - len(tuple(p)))
            for p, (_, leaf) in zip(ps, flat)]


def _same_shapes(jtree, ttree):
    jl = [tuple(l.shape) for l in jax.tree.leaves(jtree)]
    tl = [tuple(l.shape) for _, l in tsh.tree_paths(ttree)]
    assert jl == tl


def _recipes(lowered):
    """``(name, JAX recipe, port recipe)``: every named recipe, or the
    conformance test's two with the tiny-leaf floor lowered."""
    if not lowered:
        return [(n, jsh.NAMED_RECIPES[n], tsh.NAMED_RECIPES[n])
                for n in RECIPES]
    return [(n, dataclasses.replace(jsh.NAMED_RECIPES[n], min_shard_elems=2),
             dataclasses.replace(tsh.NAMED_RECIPES[n], min_shard_elems=2))
            for n in ("greedy", "megatron")]


def _pairs(fn_j, fn_t, jtree, ttree, lowered=False):
    """Every (mesh, recipe) pair whose specs differ."""
    bad = []
    for shape, names in MESHES:
        jm, tm = jmesh.MeshSpec(shape, names), tmesh.MeshSpec(shape, names)
        for name, jr, tr in _recipes(lowered):
            if _jax_specs(fn_j(jr, jm), jtree) != tsh.spec_leaves(
                    fn_t(tr, tm), ttree):
                bad.append((shape, name))
    return bad


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_full_size_param_and_cache_specs_equal_jax(arch):
    """``param_specs`` and ``cache_specs`` (and ``serve_state_specs``, their
    pair) at published widths and depths."""
    jcfg, tcfg = jconfigs.get(arch).config(), tconfigs.get(arch).config()
    jp = abstract_params(jcfg)
    tp = tsh.jax_layout(init_backbone(_MetaGenerator(), tcfg), tcfg)
    _same_shapes(jp, tp)
    assert not _pairs(lambda r, m: jsh.param_specs(jp, jcfg, m, r),
                      lambda r, m: tsh.param_specs(tp, tcfg, m, r), jp, tp)
    jc = jax.eval_shape(lambda: jinit_cache(jcfg, 8, 64, jcfg.dtype))
    tc = tsh.jax_layout({"segments": init_cache(tcfg, 8, 64, tcfg.dtype,
                                                "meta")},
                        tcfg)["segments"]
    _same_shapes(jc, tc)
    assert not _pairs(lambda r, m: jsh.cache_specs(jc, jcfg, m, r),
                      lambda r, m: tsh.cache_specs(tc, tcfg, m, r), jc, tc)
    jm = jmesh.MeshSpec((2, 8, 16), ("lanes", "data", "model"))
    tm = tmesh.MeshSpec((2, 8, 16), ("lanes", "data", "model"))
    js = jsh.serve_state_specs(jsh.NAMED_RECIPES["greedy"], jm, jp, jc, jcfg)
    ts = tsh.serve_state_specs(tsh.NAMED_RECIPES["greedy"], tm, tp, tc, tcfg)
    assert _jax_specs(js["cache"], jc) == tsh.spec_leaves(ts["cache"], tc)
    assert _jax_specs(js["params"], jp) == tsh.spec_leaves(ts["params"], tp)


@functools.lru_cache(maxsize=None)
def _smoke_carries(arch):
    """(JAX carry, port model, port carry, its JAX layout, experts) of the
    4-client smoke cohort, built once per arch."""
    jcfg, tcfg = jconfigs.get(arch).smoke(), tconfigs.get(arch).smoke()
    cuts = tuple(sorted(jcfg.exit_layers))
    splits = tuple(cuts[i % len(cuts)] for i in range(4))
    jc = jax_carry(lambda: JBackbone(jcfg, seed=0), splits,
                   JOptimizerConfig(total_steps=8))
    model = BackboneSplitModel(tcfg, seed=0, device="cpu")
    tc = abstract_cohort_carry(model, splits, OptimizerConfig(total_steps=8))
    return (jc, model, tc, tsh.jax_layout(tc, tcfg, lead=1),
            jcfg.moe.num_experts if jcfg.moe else -1)


@pytest.mark.parametrize("lowered", [False, True], ids=["named", "floor2"])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_smoke_cohort_carry_specs_equal_jax(arch, lowered):
    """``train_state_specs`` on the 4-client smoke cohort carry."""
    jc, model, tc, tv, n_exp = _smoke_carries(arch)
    _same_shapes(jc, tv)
    assert not _pairs(
        lambda r, m: jsh.train_state_specs(r, m, jc, num_experts=n_exp),
        lambda r, m: tsh.train_state_specs(r, m, tv, num_experts=n_exp),
        jc, tv, lowered)
    # the engine's specs on the port's own leaves: each layer of a run
    # takes the run's spec without its layer entry
    rec = tsh.NAMED_RECIPES["greedy"]
    ms = tmesh.MeshSpec((2, 2, 1), ("lanes", "data", "model"))
    port = carry_specs(rec, ms, tc, model)
    assert len(tsh.spec_leaves(port, tc)) == len(list(tsh.tree_paths(tc)))


def test_resnet_paper_carry_specs_equal_jax():
    """The Table-I ResNet-18 cohort carry (12 clients at cuts 3/4/5), at
    full width: the port's OIHW convs map to the JAX package's HWIO ones."""
    splits = resnet18_cifar.HETERO_SPLITS
    jc = jax_carry(lambda: JResNetSplitModel(jresnet18.config("cifar10")),
                   splits, JOptimizerConfig(total_steps=8))
    model = ResNetSplitModel(resnet18_cifar.config("cifar10"), device="meta")
    tc = abstract_cohort_carry(model, splits, OptimizerConfig(total_steps=8))
    tv = tsh.jax_layout(tc, None, lead=1)
    _same_shapes(jc, tv)
    assert not _pairs(lambda r, m: jsh.train_state_specs(r, m, jc),
                      lambda r, m: tsh.train_state_specs(r, m, tv), jc, tv)
    # a conv's spec lands on the same channel dims after the permutation
    ms = tmesh.MeshSpec((1, 2, 1), ("lanes", "data", "model"))
    spec = tsh.spec_leaves(carry_specs(tsh.NAMED_RECIPES["greedy"], ms, tc,
                                       model), tc)
    conv = [(tuple(t.shape), s) for (_, t), s in
            zip(tsh.tree_paths(tc), spec) if t.ndim == 5 and any(s)]
    assert conv and all(s[3] is None and s[4] is None for _, s in conv)


@pytest.mark.parametrize("arch", ["glm4_9b", "whisper_small",
                                  "paligemma_3b"])
def test_batch_and_stage_specs_equal_jax(arch):
    jcfg = jconfigs.get(arch).config()
    jin = train_input_specs(jcfg, ShapeConfig("t", 256, 64, "train"))
    tin = {k: torch.empty(v.shape, device="meta") for k, v in jin.items()}
    for shape, names in MESHES:
        jm, tm = jmesh.MeshSpec(shape, names), tmesh.MeshSpec(shape, names)
        assert _jax_specs(jsh.batch_specs(jin, jm), jin) == \
            tsh.spec_leaves(tsh.batch_specs(tin, tm), tin)
        for name in RECIPES:
            for lanes, batch in ((4, 32), (3, 32), (4, 30), (2, 256)):
                want = tuple(jsh.stage_batch_spec(jsh.NAMED_RECIPES[name],
                                                  jm, lanes, batch))
                assert tsh.stage_batch_spec(tsh.NAMED_RECIPES[name], tm,
                                            lanes, batch) == want


def test_recipe_meta_round_trips_like_jax():
    for name in RECIPES:
        jr, tr = jsh.NAMED_RECIPES[name], tsh.NAMED_RECIPES[name]
        assert tsh.recipe_to_meta(tr) == jsh.recipe_to_meta(jr)
        assert tsh.recipe_from_meta(tsh.recipe_to_meta(tr)) == tr
        assert tsh.recipe_name(tr) == jsh.recipe_name(jr) == name
        assert tsh.resolve_recipe(name) == tr
    custom = dataclasses.replace(tsh.NAMED_RECIPES["greedy"],
                                 fsdp_axes=("pod", "data"))
    jcustom = dataclasses.replace(jsh.NAMED_RECIPES["greedy"],
                                  fsdp_axes=("pod", "data"))
    assert tsh.recipe_to_meta(custom) == jsh.recipe_to_meta(jcustom)
    assert tsh.recipe_name(custom) == jsh.recipe_name(jcustom) == "custom"
    assert tsh.recipe_name(None) == "greedy"
    with pytest.raises(ValueError, match="unknown sharding recipe"):
        tsh.resolve_recipe("nope")


def test_mesh_helpers_raise_like_jax():
    for call in (lambda m: m.make_lane_host_mesh(3, devices=4),
                 lambda m: m.make_lane_host_mesh(0, devices=4),
                 lambda m: m.make_production_mesh(lanes=3),
                 lambda m: m.make_production_mesh(multi_pod=True, lanes=5)):
        with pytest.raises(ValueError) as je:
            call(jmesh)
        with pytest.raises(ValueError) as te:
            call(tmesh)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="MeshSpec shape"):
        tmesh.MeshSpec((2, 2), ("data",))
    # a live mesh needs exactly its ranks: this process is a world of one
    with pytest.raises(ValueError, match="needs 256 ranks but the torch."
                                         "distributed world has 1"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs 4 ranks"):
        tmesh.make_lane_host_mesh(2, devices=4)


def test_production_mesh_shapes_and_axis_queries():
    for kw, shape, names in (
            ({}, (16, 16), ("data", "model")),
            ({"multi_pod": True}, (2, 16, 16), ("pod", "data", "model")),
            ({"lanes": 2}, (2, 8, 16), ("lanes", "data", "model")),
            ({"multi_pod": True, "lanes": 4}, (2, 4, 4, 16),
             ("pod", "lanes", "data", "model"))):
        spec = tmesh.production_mesh_spec(**kw)
        assert (spec.axis_shape, spec.axis_names) == (shape, names)
        js = jmesh.MeshSpec(shape, names)
        assert tmesh.axis_sizes(spec) == jmesh.axis_sizes(js)
        assert tmesh.batch_axes(spec) == jmesh.batch_axes(js)
        assert tmesh.lane_axis(spec) == jmesh.lane_axis(js)


def test_constrain_picks_the_jax_axes_and_keeps_the_tensor(monkeypatch):
    """The rule that picks an axis per dim against the JAX rule on the
    same sizes (its sharding constraint intercepted to return the spec it
    was given), and ``constrain`` returning its input: each rank holds
    whole local tensors."""
    import types

    import numpy as np
    monkeypatch.setattr(jsharding_ctx.jax.lax, "with_sharding_constraint",
                        lambda x, spec: spec)
    shape, names = (2, 4, 2), ("lanes", "data", "model")
    jmesh_like = types.SimpleNamespace(axis_names=names,
                                       devices=np.empty(shape))
    x = torch.zeros(16, 6, 32)
    assert sharding_ctx.constrained_spec(x.shape, "data") is None
    cases = [("data", None, "model"),
             ([("data", "model"), "data"], None, [None, "model"]),
             ("model", "data", "lanes"),
             ([("lanes", "data")], ["model"], ["data"]),
             ("pod", ["lanes", "data"], None)]
    with sharding_ctx.activation_sharding(tmesh.MeshSpec(shape, names)), \
            jsharding_ctx.activation_sharding(jmesh_like):
        assert sharding_ctx.constrain(x, "data", None, "model") is x
        for axes in cases:
            want = tuple(jsharding_ctx.constrain(jnp.zeros(x.shape), *axes))
            want += (None,) * (x.ndim - len(want))
            assert sharding_ctx.constrained_spec(x.shape, *axes) == want
    assert sharding_ctx.constrained_spec(x.shape, "data") is None

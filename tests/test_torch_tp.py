"""Tensor-parallel compute over the mesh's "model" axis
(``repro_torch.launch.tensor_parallel``, ``shardings.tp_roles``) on the
CPU, in one process: the role of every leaf held against the JAX
package's ``param_specs``, and the dry run's ``replicated_over_model``
(its two repairs are tests/test_torch_dryrun_trace.py's).  The spawned
legs (``tests/torch_tp_legs.py``) run in
the worlds that tests/test_torch_spmd_engine.py and
tests/test_torch_serve_ranks.py already spawn, and are checked there.
"""
import jax
import pytest
from jax.sharding import PartitionSpec as P

import torch_tp_legs as tl

from repro import configs as jconfigs
from repro.launch import mesh as jmesh
from repro.launch import shardings as jsh
from repro.models.backbone import init_backbone as jinit_backbone
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.launch import shardings as tsh
from repro_torch.launch.inputs import abstract_params
from repro_torch.launch.mesh import MeshSpec

DM = ("data", "model")
MESHES = [(1, 2), (2, 2), (16, 16)]
SMOKES = ["glm4-9b", "paligemma-3b", "whisper-small"]


def _port_specs_of_jax(jspecs, jparams, params, cfg):
    """The JAX package's spec of every port leaf: its specs, padded to
    each leaf's rank, looked up by path in the JAX layout of the port
    tree and mapped back through ``port_specs``."""
    def key(path):
        return tuple(getattr(k, "key", getattr(k, "idx", None))
                     for k in path)
    ps = dict(jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda s: isinstance(s, P))[0])
    by_path = {key(path): tuple(ps[path]) + (None,) * (
        len(leaf.shape) - len(tuple(ps[path])))
        for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    layout = tsh.jax_layout(params, cfg)
    tree = tsh.map_with_path(lambda path, _: by_path[tuple(path)], layout)
    return tsh.port_specs(tree, params, cfg)


@pytest.mark.parametrize("recipe", ["greedy", "megatron", "hybrid"])
@pytest.mark.parametrize("arch", SMOKES)
def test_roles_follow_the_jax_specs(arch, recipe):
    """Each dense, VLM and audio smoke on (1, 2), (2, 2) and the
    production mesh: every ``column``/``row`` leaf has the JAX spec its
    role implies (its dim over "model"), every ``gathered`` leaf says
    why, and the split products exist on every mesh but the production
    one (whose 16-way axis divides few smoke dims)."""
    jcfg = jconfigs.get(arch).smoke()
    cfg = tconfigs.get(arch).smoke()
    jparams = jax.eval_shape(lambda: jinit_backbone(jax.random.PRNGKey(0),
                                                    jcfg))
    params = abstract_params(cfg)
    for shape in MESHES:
        jspecs = jsh.param_specs(jparams, jcfg, jmesh.MeshSpec(shape, DM),
                                 jsh.NAMED_RECIPES[recipe])
        specs = _port_specs_of_jax(jspecs, jparams, params, cfg)
        mesh = MeshSpec(shape, DM)
        roles = tsh.tp_roles(params, specs, mesh, cfg,
                             tsh.resolve_recipe(recipe))
        kinds = {}
        for path, r in tsh.tree_paths(roles):
            spec = tsh._lookup(specs, path)
            kinds[r.kind] = kinds.get(r.kind, 0) + 1
            if r.split:
                assert spec[r.dim] == "model", (path, spec, r)
                fam, name = tsh._families(cfg, path)
                assert tsh._TP_DIMS[fam][name][r.dim] == r.kind, (path, r)
            else:
                assert r.reason, path
                if "model" in spec:
                    assert r.dim == spec.index("model"), (path, r)
        print(f"reading {arch} {recipe} {shape}: {kinds}")
        if shape != (16, 16):
            assert kinds.get("column", 0) > 0, (shape, kinds)


#: the MoE, MLA, RWKV6 and Mamba2 smokes (d = 128: their leaves fall
#: below the default ``min_shard_elems``, so the recipes here lower it on
#: both sides) and the recipes they are held under: the three schemes and
#: an expert stack in the data layout (E over "data", a hidden dim over
#: "model") in place of the grid
FAMILY_SMOKES = ["deepseek-v3-671b", "qwen3-moe-235b-a22b", "rwkv6-3b",
                 "zamba2-1.2b"]
FAMILY_RECIPES = list(tl.FAMILY_RECIPES)
COVERED = ("mla", "rwkv6", "rwkv_cm", "mamba2", "moe")


@pytest.mark.parametrize("recipe", FAMILY_RECIPES)
@pytest.mark.parametrize("arch", FAMILY_SMOKES)
def test_family_roles_follow_the_jax_specs(arch, recipe):
    """The MoE, MLA, RWKV6 and Mamba2 smokes on (1, 2), (2, 2) and the
    production mesh, at a lowered ``min_shard_elems``: a ``column`` or
    ``row`` leaf has "model" on the dim its role names, an ``expert``
    leaf its expert dim over a tuple ending in "model" (the grid); a leaf
    of these families whose JAX spec puts "model" on a dim that a product
    splits is split, and every gathered leaf says why."""
    jcfg = jconfigs.get(arch).smoke()
    cfg = tconfigs.get(arch).smoke()
    jparams = jax.eval_shape(lambda: jinit_backbone(jax.random.PRNGKey(0),
                                                    jcfg))
    params = abstract_params(cfg)
    rc = tl.family_recipe(recipe)
    for shape in MESHES:
        jspecs = jsh.param_specs(jparams, jcfg, jmesh.MeshSpec(shape, DM),
                                 tl.family_recipe(recipe, jsh))
        specs = _port_specs_of_jax(jspecs, jparams, params, cfg)
        roles = tsh.tp_roles(params, specs, MeshSpec(shape, DM), cfg, rc)
        kinds = {}
        for path, r in tsh.tree_paths(roles):
            spec = tsh._lookup(specs, path)
            fam, name = tsh._families(cfg, path)
            kinds[r.kind] = kinds.get(r.kind, 0) + 1
            if r.kind == "expert":
                assert spec[r.dim][-1] == "model" and fam == "moe", path
            elif r.split:
                assert spec[r.dim] == "model", (path, spec, r)
                assert tsh._TP_DIMS[fam][name][r.dim] == r.kind, (path, r)
            else:
                assert r.reason, path
                if fam in COVERED and "model" in spec:
                    d = spec.index("model")
                    assert d not in tsh._TP_DIMS.get(fam, {}).get(name, {}), \
                        (path, spec, r)
        print(f"reading {arch} {recipe} {shape}: {kinds}")
        if shape != (16, 16):
            assert kinds.get("column", 0) + kinds.get("expert", 0) > 0, \
                (shape, kinds)
        if cfg.moe is not None and recipe != "data-experts":
            grid = shape[0] * shape[1]
            assert (kinds.get("expert", 0) > 0) == (
                cfg.moe.num_experts % grid == 0), (shape, kinds)


@pytest.mark.parametrize("recipe,want", [
    ("greedy", {"wq": "row", "wk": "row", "wv": "row", "wo": "column",
                "w_gate": "column", "w_up": "column", "w_down": "row",
                "table": "column", "w": "column"}),
    ("megatron", {"wq": "column", "wk": "gathered", "wv": "gathered",
                  "wo": "row", "w_gate": "column", "w_up": "column",
                  "w_down": "row", "table": "column", "w": "column"}),
])
def test_glm4_roles_at_published_widths(recipe, want):
    """glm4-9b whole on the production mesh: greedy splits ``d`` in the
    q/k/v products (row-parallel) and in ``wo``'s output (column), the
    hidden 13696 in the SwiGLU; megatron splits the heads, and its 2 KV
    heads do not divide 16 ranks, so ``wk``/``wv`` stay whole (each rank
    reads the one KV head its query heads need)."""
    cfg = tconfigs.get("glm4-9b").config()
    params = abstract_params(cfg)
    mesh = MeshSpec((16, 16), DM)
    rc = tsh.resolve_recipe(recipe)
    specs = tsh.port_specs(tsh.param_specs(tsh.jax_layout(params, cfg), cfg,
                                           mesh, rc), params, cfg)
    roles = tsh.tp_roles(params, specs, mesh, cfg, rc)
    seen = {}
    for path, r in tsh.tree_paths(roles):
        name = path[-1]
        if name in want and "shared_attn" not in path:
            seen.setdefault(name, set()).add(r.kind)
    assert seen == {k: {v} for k, v in want.items()}, seen


@pytest.mark.parametrize("recipe,mesh,want", [
    ("megatron", (1, 2), 1.0), ("replicate", (16, 16), 16.0)])
def test_replicated_over_model_is_measured(recipe, mesh, want):
    """glm4-9b at published widths (4 layers), a train step: on (1, 2)
    under megatron every product splits (1); under "replicate" none does
    (the model axis' 16)."""
    rc = tsh.resolve_recipe(recipe)
    rec = dryrun.run_one("glm4-9b", "train_4k", layers=4, recipe=rc,
                         mesh=MeshSpec(mesh, DM))
    print(f"reading replicated_over_model {recipe} {mesh}: "
          f"{rec['replicated_over_model']}")
    assert rec["replicated_over_model"] == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("arch,layers,recipe,most", [
    ("deepseek-v3-671b", 4, "megatron", 1.01),
    ("qwen3-moe-235b-a22b", 4, "megatron", 1.01),
    ("rwkv6-3b", 4, "megatron", 1.1),
    ("zamba2-1.2b", 6, "greedy", 1.1)])
def test_family_replicated_over_model(arch, layers, recipe, most):
    """The MoE, MLA, RWKV6 and Mamba2 archs at published widths (cut to
    ``layers``, deepseek-v3 past its 3 dense layers, zamba2 to its first
    shared attention block), a train step on (1, 2): the experts, MLA's
    heads, the wkv's heads and Mamba2's projections split, so a rank
    computes about half its group's step (the model axis' 2 where none
    would); what stays repeated is the router, RWKV6's ``wr`` under
    megatron and Mamba2's conv and scan."""
    rec = dryrun.run_one(arch, "train_4k", layers=layers,
                         recipe=tsh.resolve_recipe(recipe),
                         mesh=MeshSpec((1, 2), DM))
    print(f"reading replicated_over_model {arch} {recipe} (1, 2): "
          f"{rec['replicated_over_model']}")
    assert 1.0 <= rec["replicated_over_model"] < most


@pytest.mark.parametrize("fn", ["cross_entropy", "accuracy", "embed"])
def test_vocab_sized_calls_need_the_vocab_under_a_group(fn):
    """Under an active model group (a counting group: no process group) a
    vocab-sized call that does not name the whole V raises, rather than
    reading one rank's chunk as the whole row; named, whole logits and
    tables take the one-rank path, and without a group nothing changes."""
    import torch

    from repro_torch.core.losses import accuracy, softmax_cross_entropy
    from repro_torch.launch import tensor_parallel as tp
    from repro_torch.models.common import embed

    V = 8
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(3, V, generator=gen)
    labels = torch.tensor([1, 5, 7])
    table = {"table": torch.randn(V, 4, generator=gen)}
    call = {"cross_entropy": lambda **kw: softmax_cross_entropy(
                logits, labels, **kw),
            "accuracy": lambda **kw: accuracy(logits, labels, **kw),
            "embed": lambda **kw: embed(table, labels, **kw)}[fn]
    alone = call()
    with tp.model_parallel(tp.ModelGroup(None, 2, 0)):
        with pytest.raises(ValueError, match="whole vocab"):
            call()
        torch.testing.assert_close(call(vocab=V), alone, rtol=0, atol=0)


@pytest.mark.parametrize("arch,recipe,shape,layout,experts", [
    ("qwen3-moe-235b-a22b", "megatron", (16, 16), "data", 8),
    ("qwen3-moe-235b-a22b", "greedy", (16, 16), "data", 8),
    ("deepseek-v3-671b", "megatron", (16, 16), "grid", 1),
    ("deepseek-v3-671b", "megatron", (2, 2), "grid", 64),
    ("deepseek-v3-671b", "megatron", (1, 2), "grid", 128),
    ("qwen3-moe-235b-a22b", "data-experts", (2, 2), "data", 64)])
def test_expert_stacks_keep_their_batch_chunk(arch, recipe, shape, layout,
                                              experts):
    """Meta shapes, no ranks: at published widths an expert stack whose
    expert dim is over "data" (the grid, or the data layout with a hidden
    dim over "model": ``column`` or ``row``) has ``Role.experts``
    ("data",) where that axis holds
    more than one rank, and its compute spec gathers over no axis of more
    than one rank (the compute
    chunk: ``experts`` of E); with ``experts=False`` it is gathered over
    "data"; every other leaf's compute spec is the same either way."""
    cfg = tconfigs.get(arch).config()
    params = abstract_params(cfg)
    mesh = MeshSpec(shape, DM)
    rc = (tsh.ShardingRecipe(**tl.FAMILY_RECIPES[recipe])
          if recipe in tl.FAMILY_RECIPES else tsh.resolve_recipe(recipe))
    specs = tsh.port_specs(tsh.param_specs(tsh.jax_layout(params, cfg), cfg,
                                           mesh, rc), params, cfg)
    roles = tsh.tp_roles(params, specs, mesh, cfg, rc)
    sizes = {"data": shape[0], "model": shape[1]}
    seen = 0
    for path, r in tsh.tree_paths(roles):
        spec = tsh._lookup(specs, path)
        train = tsh.compute_spec(spec, r)
        serve = tsh.compute_spec(spec, r, experts=False)
        if not tsh.is_expert_stack(cfg, path):
            assert not r.experts and train == serve, path
            continue
        seen += 1
        assert (r.kind == "expert") == (layout == "grid") and r.split, \
            (path, r)
        assert r.experts == (("data",) if shape[0] > 1 else ()), (path, r)
        assert all(sizes[a] == 1 for e in train
                   for a in tsh._entry_axes(e)), (path, train)
        kept = tsh.kept_spec(spec, r)
        n = tsh._lookup(params, path).shape[0]
        for a in tsh._entry_axes(kept[0]):
            n //= sizes[a]
        assert n == experts, (path, kept)
        if shape[0] > 1:
            assert "data" in tsh._entry_axes(serve[0]), (path, serve)
    assert seen > 0
    # the expert group's count, from the same roles
    assert tsh.kept_experts(roles, cfg.moe.num_experts, sizes) == (
        experts if shape[0] > 1 else 0)


def test_moe_forward_refuses_a_stack_its_group_does_not_keep():
    """Under an expert group that keeps 2 of the qwen3-moe smoke's 4
    experts a rank, a block runs a stack of 2 (exchanging, here through a
    counting group) or of 4 (its role keeps it whole: no exchange) and
    raises on any other."""
    import torch

    from repro_torch.launch import tensor_parallel as tpm
    from repro_torch.models.moe import init_moe, moe_forward
    from repro_torch.models.sync_stats import synced_batch_stats
    cfg = tconfigs.get("qwen3-moe-235b-a22b").smoke()
    params = init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    for n, sent in ((2, True), (4, False), (3, None)):
        ep = tpm.ExpertGroup(None, 2, 0, 2)
        cut = {k: v[:n] if k != "router" else v for k, v in params.items()}
        with synced_batch_stats(None, 2, 0), tpm.expert_parallel(ep):
            if sent is None:
                with pytest.raises(ValueError, match="keeps 2 of 4"):
                    moe_forward(cut, x, cfg)
                continue
            out, _ = moe_forward(cut, x, cfg)
        assert out.shape == x.shape
        assert (ep.bytes["all_to_all"] > 0) == sent, (n, ep.bytes)

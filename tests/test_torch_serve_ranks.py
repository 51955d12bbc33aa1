"""``ServeSession(mesh=, recipe=)``: serving over 2 and 4 CPU ranks (gloo),
held against the port's one-rank session, its sequential references and
the JAX package's session.

The ranks are spawned once per world size (``launch.hostdevices``) in a
module fixture that serves every case of ``tests/torch_serve_legs.py``:
the meshes (2, 1) and (1, 2) on 2 ranks, (4, 1) and (2, 2) on 4, over
``("data", "model")``; glm4-9b's smoke under the recipes greedy,
replicate and megatron, and the tiny_swa (a 6-slot ring), rwkv6-3b
(recurrent states over ``"model"``; with one-layer runs on the model
split meshes), deepseek-v3 (MLA, 1-token prompts) and qwen3-moe
(per-slot routing) smokes under greedy; both exit policies,
six requests on four slots (mid-stream admissions), all fp32.  Limits:

  * data-only meshes: tokens and gate decisions equal to the port's
    one-rank session and ``sequential_reference``, entropies within 1e-5;
  * meshes with a model split (the decode ring's sequence split over the
    ranks, each part's attention combined by its LSE):
    ``parity.stream_parity`` against ``sequential_reference`` at the fp32
    limits ``TIE_GAP_F32`` / ``TOL_H_F32``;
  * the JAX package's ``ServeSession`` on a 1x1 mesh under "greedy"
    (tests/test_serve_session.py's placement path) on the same prompts and
    weights: the same streams, parting only at a near tie of the port's
    plain logits (tests/test_torch_serve.py's limits);
  * the planted fault, each rank's part of the attention taken as the
    whole, must part from the references;
  * tensor parallelism over "model" (tests/torch_tp_legs.py): the glm4-9b,
    whisper-small, deepseek-v3, qwen3-moe, rwkv6 and zamba2 smokes'
    streams equal to the one-rank session's and the JAX session's.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_serve_legs as legs
import torch_tp_legs as tl
from repro import configs as jconfigs
from repro.api.serve_session import ServeSession as JaxServeSession
from repro.config import ModelConfig as JModelConfig
from repro.models.backbone import init_backbone as jax_init_backbone
from repro_torch.api.serve_session import (ServeSession,
                                           sequential_reference,
                                           sequential_sticky_reference,
                                           serve_placement)
from repro_torch.configs import glm4_9b
from repro_torch.convert import config_from_jax, params_from_jax
from repro_torch.launch.e2e_train import cut_depth
from repro_torch.launch.hostdevices import HostRanks
from repro_torch.launch.inputs import abstract_params
from repro_torch.launch.mesh import MeshSpec, axis_sizes
from repro_torch.launch.meshcomm import chunk_shapes, plan_bytes, unshard_plan
from repro_torch.launch.shardings import resolve_recipe
from repro_torch.models.backbone import init_cache
from repro_torch.tree import tree_leaves
from repro_torch.parity import TIE_GAP_F32, TOL_H_F32, stream_parity

TOL_H_DATA = 1e-5
#: threads for the JAX package's inits and sessions (each compiles its
#: own small programs for most of its time)
JAX_THREADS = 4
JAX_IDS = {"glm4": "glm4-9b", "rwkv6": "rwkv6-3b",
           "deepseek": "deepseek-v3-671b", "qwen3": "qwen3-moe-235b-a22b",
           "whisper": "whisper-small", "zamba2": "zamba2-1.2b"}
#: the (config, policy) pairs also served by the JAX package's session
NAMES = list(legs.CONFIGS) + list(legs.SPLIT_ONLY)
#: served only by the tensor-parallel legs (cross attention; Mamba2)
TP_ONLY = ["whisper", "zamba2"]
JAX_SERVED = ([(n, "select") for n in NAMES + TP_ONLY]
              + [("glm4", "sticky")])
CASES = [(w, c) for w in (2, 4) for c in legs.cases(w)]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """At most two torch threads in this process (tests/test_torch_fused.py
    says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _jax_cfg(name):
    if name == "rwkv6x":
        return jconfigs.get("rwkv6-3b").smoke().with_(exit_layers=(1, 2, 3))
    if name == "swa":
        base = legs.tiny_swa()
        return JModelConfig(**{f.name: getattr(base, f.name) for f in
                               dataclasses.fields(JModelConfig)
                               if f.name in ("name", "arch_type",
                                             "num_layers", "d_model",
                                             "num_heads", "num_kv_heads",
                                             "d_ff", "vocab_size",
                                             "sliding_window",
                                             "exit_layers")},
                            dtype=jnp.float32, param_dtype=jnp.float32)
    return jconfigs.get(JAX_IDS[name]).smoke()


def _streams(done):
    return {r.rid: (list(r.tokens), list(r.exited), list(r.entropy))
            for r in done}


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The weights (the JAX init, exported), each config's gate threshold
    (the median entropy of its first request's plain stream), the ranks
    of both world sizes started on them, then every reference while the
    ranks work."""
    out = {"jcfg": {}, "jparams": {}}
    inputs = {"params": {}, "cfg": {}, "tau": {},
              "tmp": str(tmp_path_factory.mktemp("serve-ranks"))}

    def init(name):
        jcfg = _jax_cfg(name)
        return jcfg, jax_init_backbone(jax.random.PRNGKey(0), jcfg)

    # the JAX inits compile their ops for most of their time: in threads
    with ThreadPoolExecutor(JAX_THREADS) as pool:
        inits = dict(zip(NAMES + TP_ONLY, pool.map(init, NAMES + TP_ONLY)))
    for name, (jcfg, jp) in inits.items():
        cfg = config_from_jax(jcfg)
        params = params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                 device="cpu")
        p0 = legs.prompts(name, cfg)[0]
        h = sequential_reference(cfg, params, p0, legs.DECODE, tau=0.0,
                                 max_len=legs.MAX_LEN, device="cpu").entropy
        out["jcfg"][name], out["jparams"][name] = jcfg, jp
        inputs["params"][name], inputs["cfg"][name] = params, cfg
        inputs["tau"][name] = float(np.median(h))
    ranks = {w: HostRanks(w, legs.run_legs, (w, inputs), device="cpu",
                          timeout=1200) for w in (2, 4)}
    try:
        out.update(_references(inputs, out))
    finally:
        out["ranks"] = {w: [r for _, r in h.wait()] for w, h in ranks.items()}
    out["inputs"] = inputs
    return out


def _jax_session(out, inputs, name, policy):
    """The JAX package's session on a 1x1 mesh, "greedy"."""
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    js = JaxServeSession(out["jcfg"][name], out["jparams"][name],
                         tau=inputs["tau"][name], slots=legs.SLOTS,
                         max_len=legs.MAX_LEN, exit_policy=policy,
                         mesh=mesh, recipe="greedy")
    for p in legs.prompts(name, inputs["cfg"][name]):
        js.submit(p, decode_tokens=legs.DECODE)
    return _streams(js.run())


def _references(inputs, out):
    """Per (config, policy, slots): the port's one-rank session and its
    sequential references; per JAX_SERVED pair, the JAX session (in
    threads beside the port's, each session alone)."""
    pool = ThreadPoolExecutor(JAX_THREADS)
    jax_runs = {pair: pool.submit(_jax_session, out, inputs, *pair)
                for pair in JAX_SERVED}
    one, seq = {}, {}
    for name in TP_ONLY:
        cfg, params = inputs["cfg"][name], inputs["params"][name]
        s = ServeSession(cfg, params, tau=inputs["tau"][name],
                         slots=legs.SLOTS, max_len=legs.MAX_LEN,
                         device="cpu")
        for p in legs.prompts(name, cfg):
            s.submit(p, legs.DECODE)
        one[name, "select", legs.SLOTS] = _streams(s.run())
        seq[name, "select"] = [
            sequential_reference(cfg, params, p, legs.DECODE,
                                 tau=inputs["tau"][name],
                                 max_len=legs.MAX_LEN, device="cpu")
            for p in legs.prompts(name, cfg)]
    for name in NAMES:
        cfg, params = inputs["cfg"][name], inputs["params"][name]
        tau = inputs["tau"][name]
        ps = legs.prompts(name, cfg)
        for policy in legs.POLICIES:
            ref = (sequential_sticky_reference if policy == "sticky"
                   else sequential_reference)
            seq[name, policy] = [ref(cfg, params, p, legs.DECODE, tau=tau,
                                     max_len=legs.MAX_LEN, device="cpu")
                                 for p in ps]
            for slots in (legs.SLOTS, 3):
                s = ServeSession(cfg, params, tau=tau, slots=slots,
                                 max_len=legs.MAX_LEN, exit_policy=policy,
                                 device="cpu")
                for p in ps:
                    s.submit(p, legs.DECODE)
                one[name, policy, slots] = _streams(s.run())
    jax_res = {pair: f.result() for pair, f in jax_runs.items()}
    pool.shutdown()
    return {"one": one, "seq": seq, "jax": jax_res}


def _result(refs, world, key, rank=0):
    res = refs["ranks"][world][rank][key]
    assert "error" not in res, res["error"]
    return res


def _same_streams(got, want, what, tol_h):
    assert sorted(got) == sorted(want), what
    for rid in want:
        g, w = got[rid], want[rid]
        assert g[0] == w[0] and g[1] == w[1], (what, rid, g[:2], w[:2])
        assert max(abs(a - b) for a, b in zip(g[2], w[2])) <= tol_h, \
            (what, rid)


def _as_results(streams):
    from repro_torch.api.serve_session import ServeResult
    return {rid: ServeResult(rid, None, tokens=t, exited=e, entropy=h)
            for rid, (t, e, h) in streams.items()}


@pytest.mark.parametrize("world,case", CASES,
                         ids=[f"w{w}-{c[0]}" for w, c in CASES])
def test_case_serves_the_references(refs, world, case):
    cid, name, shape, recipe, policy, slots = case
    res = _result(refs, world, cid)
    got = res["results"]
    wants = refs["seq"][name, policy]
    tau = refs["inputs"]["tau"][name]
    if shape[1] == 1:
        _same_streams(got, refs["one"][name, policy, slots], "one-rank",
                      TOL_H_DATA)
        _same_streams(got, {i: (w.tokens, w.exited, w.entropy)
                            for i, w in enumerate(wants)}, "sequential",
                      TOL_H_DATA)
    else:
        sp = stream_parity(_as_results(got), wants, tau,
                           tie_gap=TIE_GAP_F32, tol_h=TOL_H_F32)
        print(f"reading w{world} {cid}: compared {sp.compared} tokens, "
              f"max|dH| {sp.max_dh:.2e}, parted {sp.parted}")
        assert sp.ok and sp.max_dh <= TOL_H_F32, sp
    requests, ticks, tokens, exited, client_only = res["stats"]
    assert requests == len(wants) and tokens == len(wants) * legs.DECODE
    if shape[1] == 1:
        assert exited == sum(sum(w.exited) for w in wants)


@pytest.mark.parametrize("world,case", [
    (w, c) for w, c in CASES if (c[1], c[4]) in JAX_SERVED
    and c[5] == legs.SLOTS], ids=[
    f"w{w}-{c[0]}" for w, c in CASES if (c[1], c[4]) in JAX_SERVED
    and c[5] == legs.SLOTS])
def test_case_matches_the_jax_session(refs, world, case):
    """The JAX session's streams, parting only where the port's plain
    logits have a top-2 gap below tests/test_torch_serve.py's 1e-5."""
    cid, name, _, _, policy, _ = case
    got = _result(refs, world, cid)["results"]
    want = refs["jax"][name, policy]
    plain = refs["seq"][name, policy]
    assert sorted(got) == sorted(want)
    for rid in want:
        g, w, p = got[rid], want[rid], plain[rid]
        for i, (a, b) in enumerate(zip(g[0], w[0])):
            if i:
                assert g[1][i - 1] == w[1][i - 1], (rid, i)
                assert abs(g[2][i - 1] - w[2][i - 1]) <= 1e-4, (rid, i)
            if a != b:
                assert p.top2_gap[i] < TIE_GAP_F32, (rid, i)
                break


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_hold_the_same_results(refs, world):
    ranks = refs["ranks"][world]
    for cid, *_ in legs.cases(world):
        a = _result(refs, world, cid)
        for r in range(1, world):
            b = _result(refs, world, cid, r)
            assert b["results"] == a["results"], (cid, r)
            assert b["stats"] == a["stats"], (cid, r)
    assert len(ranks) == world


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_stores_its_chunk_of_the_cache(refs, world):
    """Every stored cache leaf is its spec's chunk of the whole leaf; under
    a model split no rank holds a whole decode ring, and with the slots
    split each data group holds its own."""
    rings = 0
    for cid, name, shape, *_ in legs.cases(world):
        res = _result(refs, world, cid)
        sizes = res["sizes"]
        for path, stored, spec, whole in res["shapes"]:
            want = list(whole)
            for d, e in enumerate(spec):
                for a in (() if e is None else
                          (e if isinstance(e, tuple) else (e,))):
                    want[d] //= sizes[a]
            assert list(stored) == want, (cid, path, spec)
            if shape[1] > 1 and path[-1] in ("k", "v", "ckv", "k_rope"):
                # the ring's sequence split (or, where the rules put a
                # stacked run's layers over the batch axes, its slots)
                assert np.prod(stored) * shape[1] <= np.prod(whole), \
                    (cid, path)
                rings += stored[1] < whole[1]
    assert rings > 0


@pytest.mark.parametrize("world", [2, 4])
def test_uncombined_parts_are_rejected(refs, world):
    """The planted fault: each rank takes its part of the split ring as the
    whole.  Some rank's streams must part from the references."""
    wants = refs["seq"]["glm4", "select"]
    tau = refs["inputs"]["tau"]["glm4"]
    verdicts = []
    for r in range(world):
        got = _result(refs, world, "fault", r)["results"]
        sp = stream_parity(_as_results(got), wants, tau,
                           tie_gap=TIE_GAP_F32, tol_h=TOL_H_F32)
        verdicts.append(sp.ok and sp.max_dh <= TOL_H_F32)
        print(f"reading w{world} no-combine fault rank {r}: max|dH| "
              f"{sp.max_dh:.2e}, parted {sp.parted}")
    assert not all(verdicts)


@pytest.mark.parametrize("world", [2, 4])
def test_slots_that_do_not_divide_stay_replicated(refs, world):
    cid = [c for c in legs.cases(world) if c[5] == 3][0][0]
    for r in range(world):
        res = _result(refs, world, cid, r)
        assert res["slots"] == (0, 3)
        assert all(stored[0] == 3 for _, stored, _, _ in res["shapes"])


@pytest.mark.parametrize("world", [2, 4])
def test_restore_serves_a_multi_rank_checkpoint(refs, world):
    res = _result(refs, world, "restore")
    assert res["engine"] == "spmd"
    for shape in legs.MESHES[world]:
        got = res["x".join(map(str, shape))]
        if shape[1] == 1:
            _same_streams(got, res["one"], f"restore {shape}", TOL_H_DATA)
        else:
            sp = stream_parity(_as_results(got), res["seq"], res["tau"],
                               tie_gap=TIE_GAP_F32, tol_h=TOL_H_F32)
            assert sp.ok and sp.max_dh <= TOL_H_F32, sp


@pytest.mark.parametrize("world", [2, 4])
def test_ticks_count_their_gathers(refs, world):
    """The sharded recipes gather weights each tick; "replicate" gathers
    only the tick's results (and the split rings' parts)."""
    data = "x".join(map(str, legs.MESHES[world][0]))
    greedy = _result(refs, world, f"glm4-{data}-greedy-select")
    rep = _result(refs, world, f"glm4-{data}-replicate-select")
    assert greedy["gathered_per_tick"] > 1e6 > rep["gathered_per_tick"] > 0


@pytest.mark.parametrize("world", [2, 4])
def test_sticky_cases_run_client_only_ticks(refs, world):
    """Some sticky streams above went through the client-only tick (every
    occupied slot adopted) on every mesh, so that tick ran over the
    ranks."""
    for shape in legs.MESHES[world]:
        ticks = {cid: _result(refs, world, cid)["stats"][4]
                 for cid, _, sh, _, policy, _ in legs.cases(world)
                 if sh == shape and policy == "sticky"}
        print(f"reading w{world} {shape} client-only ticks: {ticks}")
        assert max(ticks.values()) > 0, shape


@pytest.mark.parametrize("layers", [8, 4])
@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_weight_gather_plan_at_published_widths(shape, layers):
    """glm4-9b at its published widths cut to ``layers`` layers by phase
    main's rule (meta tensors, recipe greedy, 8 slots of 160): a rank
    stores its chunks and a tick gathers exactly the rest of the tree,
    the weights phase spmd's serving legs gather on the card."""
    cfg, _ = cut_depth(glm4_9b.config(), layers)
    params = abstract_params(cfg)
    mesh = MeshSpec(shape, ("data", "model"))
    pspecs, _ = serve_placement(resolve_recipe("greedy"), mesh, cfg, params,
                                init_cache(cfg, 8, 160, cfg.dtype, "meta"))
    sizes = axis_sizes(mesh)
    chunks = chunk_shapes(params, pspecs, sizes, lead=0)

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    whole, stored = nbytes(params), nbytes(chunks)
    gathered = plan_bytes(unshard_plan(chunks, pspecs, sizes, lead=0))
    print(f"reading glm4-9b {layers} layers {shape}: whole {whole:,} bytes, "
          f"stored a rank {stored:,}, gathered a tick {gathered:,}")
    assert gathered == whole - stored > 0


# ---------------------------------------------------------------------------
# tensor parallelism over "model" (tests/torch_tp_legs.py, served in these
# worlds: (1, 2) on 2 ranks, (2, 2) on 4)
# ---------------------------------------------------------------------------

TP_CASES = [(w, c) for w in (2, 4) for c in tl.serve_cases(w)]


def _tp(refs, world, cid, rank=0):
    res = refs["ranks"][world][rank]["tp"][cid]
    assert "error" not in res, res["error"]
    return res


@pytest.mark.parametrize("world,case", TP_CASES,
                         ids=[f"w{w}-{c[0]}" for w, c in TP_CASES])
def test_tp_serves_the_one_rank_and_jax_sessions(refs, world, case):
    """Every rank's streams under tensor-parallel products: tokens and gate
    decisions equal to the port's one-rank session, entropies within
    1e-5, and the JAX package's session's, parting only at a near tie of
    the port's plain logits."""
    cid, name, _, _, policy = case
    got = _tp(refs, world, cid)["results"]
    _same_streams(got, refs["one"][name, policy, legs.SLOTS], "one-rank",
                  TOL_H_DATA)
    for r in range(1, world):
        assert _tp(refs, world, cid, r)["results"] == got, r
    want = refs["jax"][name, policy]
    for rid in want:
        g, w = got[rid], want[rid]
        for i, (a, b) in enumerate(zip(g[0], w[0])):
            if i:
                assert g[1][i - 1] == w[1][i - 1], (rid, i)
                assert abs(g[2][i - 1] - w[2][i - 1]) <= 1e-4, (rid, i)
            if a != b:
                assert refs["seq"][name, policy][rid].top2_gap[i] < \
                    TIE_GAP_F32, (rid, i)
                break


@pytest.mark.parametrize("world", [2, 4])
def test_tp_family_ticks_gather_no_covered_weight(refs, world):
    """Under megatron at a lowered ``min_shard_elems`` every leaf of the
    deepseek (MLA, experts over the grid), qwen3-moe and rwkv6 smokes
    that the model axis splits is split for compute: on (1, 2) a tick
    gathers no weight, and the expert stacks hold the expert role."""
    m = "x".join(map(str, tl.MESH[world]))
    for name in ("deepseek", "qwen3", "rwkv6"):
        res = _tp(refs, world, f"tp-{name}-{m}-megatron-select")
        print(f"reading tp serve {name} w{world}: weights gathered a tick "
              f"{res['weights_per_tick']:.0f}, tensor-parallel bytes a "
              f"tick {res['tp_per_tick']:.0f}, roles {res['kinds']}")
        assert res["tp_per_tick"] > 0
        assert ("expert" in res["kinds"]) == (name != "rwkv6"), name
        if world == 2:
            assert res["weights_per_tick"] == 0, name


@pytest.mark.parametrize("world", [2, 4])
def test_tp_ticks_gather_no_covered_weight(refs, world):
    """Under megatron every leaf of the glm4-9b smoke that the model axis
    splits is tensor-parallel: on (1, 2) a tick gathers no weight at all,
    on (2, 2) only over "data"; the tensor-parallel collectives move
    bytes every tick."""
    m = "x".join(map(str, tl.MESH[world]))
    res = _tp(refs, world, f"tp-glm4-{m}-megatron-select")
    print(f"reading tp serve w{world}: weights gathered a tick "
          f"{res['weights_per_tick']:.0f}, tensor-parallel bytes a tick "
          f"{res['tp_per_tick']:.0f}, roles {res['kinds']}")
    assert res["tp_per_tick"] > 0
    assert "column" in res["kinds"] and "row" in res["kinds"]
    if world == 2:
        assert res["weights_per_tick"] == 0

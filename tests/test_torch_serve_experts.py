"""Serving over the batch ranks keeps each rank's experts
(``ServeSession(mesh=, recipe=)``, ``RankPlacement.ep``) over 2 and 4 CPU
ranks (gloo).

The ranks are spawned once per world size (``launch.hostdevices``) in a
module fixture that runs ``tests/torch_serve_legs.expert_legs``: the
deepseek-v3 (MLA, a dense layer first, a shared expert) and qwen3-moe
smokes at a lowered ``min_shard_elems`` (``torch_tp_legs.family_recipe``)
with their expert stacks over the data ranks -- (2, 1) under greedy on 2
ranks, the (2, 2) grid under megatron on 4, and qwen3-moe's data layout
(E over "data", the hidden dims over "model") on 4 -- under select and
sticky, six requests on four slots (qwen3-moe's last prompt repeats one
token, so its prefill drops entries), so that the second wave's ticks
find a rank's data group with no occupied slot.  Limits:

  * tokens and gate decisions equal to the port's one-rank session's and
    to the JAX package's ``ServeSession``'s, entropies within 1e-5 of the
    one-rank session's and 1e-4 of the JAX session's, on every rank;
  * each rank holds E / D of a stack's experts (E / (D x P) over the
    grid), a tick gathers none of them, and the dry run's decode record
    (``launch.dryrun``) gathers the same weights a tick, keeps the same
    experts and counts the exchange at a bound of the session's;
  * the planted faults must part from the one-rank streams: each entry
    sent to the owner of the next chunk, and a rank's slots routed as
    one group (twelve copies of one prompt, six a rank, whose pooled
    loads pass the capacity; their sound control must not part).
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import torch_serve_legs as legs
from repro import configs as jconfigs
from repro.api.serve_session import ServeSession as JaxServeSession
from repro.models.backbone import init_backbone as jax_init_backbone
from repro_torch.api.serve_session import ServeSession, sequential_reference
from repro_torch.convert import config_from_jax, params_from_jax
from repro_torch.launch.hostdevices import HostRanks
from repro_torch.models import moe

TOL_H = 1e-5
TOL_H_JAX = 1e-4
JAX_IDS = {"deepseek": "deepseek-v3-671b", "qwen3": "qwen3-moe-235b-a22b"}
CASES = [(w, c) for w in (2, 4) for c in legs.expert_cases(w)]


def _ids(cases):
    return [f"w{w}-{c[0]}" for w, c in cases]


def _streams(done):
    return {r.rid: (list(r.tokens), list(r.exited), list(r.entropy))
            for r in done}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _one_rank(cfg, params, tau, policy, ps, slots, decode):
    s = ServeSession(cfg, params, tau=tau, slots=slots,
                     max_len=legs.MAX_LEN, exit_policy=policy, device="cpu")
    for p in ps:
        s.submit(p, decode)
    return _streams(s.run())


def _jax_session(jcfg, jparams, tau, policy, ps):
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    js = JaxServeSession(jcfg, jparams, tau=tau, slots=legs.SLOTS,
                         max_len=legs.MAX_LEN, exit_policy=policy, mesh=mesh,
                         recipe="greedy")
    for p in ps:
        js.submit(p, decode_tokens=legs.DECODE)
    return _streams(js.run())


def _drops(cfg, params, prompt):
    """The entries the port's one-rank prefill of ``prompt`` drops, over
    every MoE block (each block's loads against its capacity)."""
    dropped = []
    real = moe.route

    def watch(p, x, m):
        topi, topw, aux = real(p, x, m)
        C = moe.expert_capacity(x.shape[-2], m)
        load = torch.bincount(topi.reshape(-1), minlength=m.num_experts)
        dropped.append(int(torch.where(load > C, load - (C - 1), 0).sum()))
        return topi, topw, aux
    moe.route = watch
    try:
        sequential_reference(cfg, params, prompt, 1, tau=0.0,
                             max_len=legs.MAX_LEN, device="cpu")
    finally:
        moe.route = real
    return sum(dropped)


@pytest.fixture(scope="module")
def refs():
    """The weights (the JAX init, exported), each config's gate threshold
    (the median entropy of its first request's plain stream), the ranks
    of both world sizes started on them, then the references."""
    inputs = {"params": {}, "cfg": {}, "tau": {}}
    jax_side = {}
    for name, jid in JAX_IDS.items():
        jcfg = jconfigs.get(jid).smoke()
        jp = jax_init_backbone(jax.random.PRNGKey(0), jcfg)
        cfg = config_from_jax(jcfg)
        params = params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                 device="cpu")
        p0 = legs.prompts(name, cfg)[0]
        h = sequential_reference(cfg, params, p0, legs.DECODE, tau=0.0,
                                 max_len=legs.MAX_LEN, device="cpu").entropy
        inputs["params"][name], inputs["cfg"][name] = params, cfg
        inputs["tau"][name] = float(np.median(h))
        jax_side[name] = (jcfg, jp)
    ranks = {w: HostRanks(w, legs.expert_legs, (w, inputs), device="cpu",
                          timeout=600) for w in (2, 4)}
    out = {"one": {}, "jax": {}, "inputs": inputs}
    try:
        with ThreadPoolExecutor(2) as pool:
            jax_runs = {(name, policy): pool.submit(
                _jax_session, *jax_side[name], inputs["tau"][name], policy,
                legs.expert_prompts(name, inputs["cfg"][name]))
                for name in JAX_IDS for policy in legs.POLICIES}
            for name in JAX_IDS:
                cfg, params = inputs["cfg"][name], inputs["params"][name]
                for policy in legs.POLICIES:
                    out["one"][name, policy] = _one_rank(
                        cfg, params, inputs["tau"][name], policy,
                        legs.expert_prompts(name, cfg), legs.SLOTS,
                        legs.DECODE)
            cfg, params = inputs["cfg"]["qwen3"], inputs["params"]["qwen3"]
            ps = legs.expert_prompts("qwen3", cfg)
            out["pooled"] = _one_rank(cfg, params, inputs["tau"]["qwen3"],
                                      "select", [ps[0]] * legs.SLOTS_POOLED,
                                      legs.SLOTS_POOLED, legs.DECODE_POOLED)
            out["drops"] = _drops(cfg, params, ps[-1])
            out["jax"] = {k: f.result() for k, f in jax_runs.items()}
    finally:
        out["ranks"] = {w: [r for _, r in h.wait()] for w, h in ranks.items()}
    return out


def _res(refs, world, key, rank=0):
    res = refs["ranks"][world][rank][key]
    assert "error" not in res, res["error"]
    return res


def _same(got, want, tol_h, what):
    assert sorted(got) == sorted(want), what
    for rid in want:
        g, w = got[rid], want[rid]
        assert g[0] == w[0] and g[1] == w[1], (what, rid, g[:2], w[:2])
        assert max(abs(a - b) for a, b in zip(g[2], w[2])) <= tol_h, \
            (what, rid)


def _parts(got, want):
    """Whether ``got`` parts from ``want``: a token, a gate decision or
    an entropy beyond 1e-5."""
    try:
        _same(got, want, TOL_H, "fault")
    except AssertionError:
        return True
    return False


def test_the_overloading_prompt_drops_entries(refs):
    print(f"reading qwen3-moe smoke prefill of a repeated token: "
          f"{refs['drops']} entries dropped")
    assert refs["drops"] > 0


@pytest.mark.parametrize("world,case", CASES, ids=_ids(CASES))
def test_streams_equal_one_rank_and_jax(refs, world, case):
    cid, name, _, _, policy = case
    got = _res(refs, world, cid)["results"]
    _same(got, refs["one"][name, policy], TOL_H, "one-rank")
    _same(got, refs["jax"][name, policy], TOL_H_JAX, "JAX")
    for r in range(1, world):
        assert _res(refs, world, cid, r)["results"] == got, r


@pytest.mark.parametrize("world,case", CASES, ids=_ids(CASES))
def test_each_rank_keeps_its_experts(refs, world, case):
    cid, name, shape, recipe, policy = case
    E = refs["inputs"]["cfg"][name].moe.num_experts
    per = E // shape[0] // (shape[1] if recipe == "megatron" else 1)
    idle = []
    for r in range(world):
        res = _res(refs, world, cid, r)
        idle.append(res["idle_ticks"])
        print(f"reading w{world} {cid} rank {r}: {res['experts']} experts "
              f"a rank, expert gathers {res['expert_gathers']}, weights "
              f"gathered a tick {res['weights_per_tick']:.0f}, exchange a "
              f"tick {res['exchange_per_tick']:.0f} (decode "
              f"{res['exchange_decode']:.0f}), idle ticks "
              f"{res['idle_ticks']}, client-only {res['client_only']}")
        assert res["experts"] == per and res["stack_experts"] == [per]
        assert res["expert_gathers"] == 0
        assert res["exchange_decode"] > 0
    # some tick found a data group with no occupied slot
    assert max(idle) > 0
    if policy == "sticky":
        assert _res(refs, world, cid)["client_only"] > 0


@pytest.mark.parametrize("world,case", CASES, ids=_ids(CASES))
def test_dry_run_counts_the_sessions_tick(refs, world, case):
    cid = case[0]
    res = _res(refs, world, cid)
    rec = res["dryrun"]
    print(f"reading w{world} {cid} dry run: weights gathered "
          f"{rec['weight_gathered_bytes']}, exchange bound "
          f"{rec['exchange_bytes']}, {rec['experts_per_rank']} experts "
          f"a rank; the session: {res['weights_per_tick']:.0f}, "
          f"{res['exchange_decode']:.0f}")
    assert rec["weight_gathered_bytes"] == res["weights_per_tick"]
    assert rec["experts_per_rank"] == res["experts"]
    assert rec["exchange_bytes"] >= res["exchange_decode"] > 0


@pytest.mark.parametrize("world", [2, 4])
def test_misrouted_entries_are_rejected(refs, world):
    got = _res(refs, world, "fault-misrouted")
    assert _parts(got, refs["one"]["qwen3", "select"])


@pytest.mark.parametrize("world", [2, 4])
def test_pooled_slots_are_rejected(refs, world):
    _same(_res(refs, world, "pooled-control"), refs["pooled"], TOL_H,
          "control")
    assert _parts(_res(refs, world, "fault-pooled"), refs["pooled"])

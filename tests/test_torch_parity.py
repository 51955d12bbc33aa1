"""The bf16 parity helpers (``repro_torch/parity.py``), the sequential
references' top-2 gaps and ``make_grad_step``, on the CPU.

``chip_smoke.py`` and the card tests hold the kernels against the plain
versions with these helpers; here they run on synthetic streams and on the
plain versions of the smoke configs.
"""
import numpy as np
import pytest
import torch

from repro_torch.api.serve_session import ServeResult, sequential_reference
from repro_torch.config import HeteroProfile, SplitEEConfig
from repro_torch.configs import glm4_9b, rwkv6_3b
from repro_torch.core.spmd import (StepConfig, boundary_ids_for_batch,
                                   make_grad_step, make_train_step)
from repro_torch.models.backbone import backbone_forward, init_backbone
from repro_torch.optim import adam_init, adam_update, make_schedule
from repro_torch.parity import (TIE_GAP_BF16, TOL_H_BF16, grad_rel_errors,
                                bf16_step, live_rwkv, session_parity,
                                smoke_batches, stream_parity)
from repro_torch.tree import tree_leaves


def _stream(tokens, exited, entropy, gaps):
    return ServeResult(rid=0, prompt=np.zeros(1, np.int32),
                       tokens=list(tokens), exited=list(exited),
                       entropy=list(entropy), top2_gap=list(gaps))


WANT = _stream([5, 6, 7, 8], [False, True, False], [3.0, 1.0, 2.005],
               [1.0, 0.5, 0.01, 1.0])


@pytest.mark.parametrize("tokens,exited,entropy,ok,compared,parted,max_dh", [
    # the same stream, entropies a little apart
    (WANT.tokens, WANT.exited, [3.001, 1.0, 2.005], True, 4, 0, 1e-3),
    # a token parts where the plain top-2 gap (0.01) is a near tie
    ([5, 6, 9, 8], WANT.exited, WANT.entropy, True, 2, 1, 0.0),
    # a token parts where the plain gap (0.5) is not
    ([5, 4, 7, 8], WANT.exited, WANT.entropy, False, 1, 1, 0.0),
    # a gate parts where the plain |H - tau| is 0.005, and where it is 1
    (WANT.tokens, [False, True, True], [3.0, 1.0, 1.999], True, 3, 1, 6e-3),
    (WANT.tokens, [False, False, False], [3.0, 2.2, 2.005], False, 2, 1,
     1.2),
    # a shorter stream
    ([5, 6, 7], WANT.exited[:2], WANT.entropy[:2], False, 3, 0, 0.0),
])
def test_stream_parity_lets_streams_part_only_at_near_ties(
        tokens, exited, entropy, ok, compared, parted, max_dh):
    res = stream_parity({0: _stream(tokens, exited, entropy, [])}, [WANT],
                        tau=2.0, tie_gap=0.05, tol_h=0.01)
    assert (res.ok, res.compared, len(res.parted)) == (ok, compared, parted)
    assert res.max_dh == pytest.approx(max_dh, abs=1e-9)


ONE = _stream([5, 6, 7, 8], [False, True, False], [3.0, 1.0, 2.005], [])


@pytest.mark.parametrize("tokens,alone,ok,compared,parted", [
    # the same stream as the one-rank session
    (ONE.tokens, WANT.tokens, True, 4, 0),
    # parts from the one-rank session where the alone run's gap is 0.01
    ([5, 6, 9, 8], WANT.tokens, True, 2, 1),
    # parts where the gap (0.5) is not a tie and the two sound runs agree
    ([5, 4, 7, 8], WANT.tokens, False, 1, 1),
    # parts where the gap (0.5) is wide but the one-rank session and the
    # request alone already choose different tokens
    ([5, 4, 7, 8], [5, 3, 7, 8], True, 1, 1),
    # the one-rank session parts from the request alone: compared no
    # further, whatever follows
    ([5, 6, 7, 1], [5, 6, 7, 2], True, 3, 1),
])
def test_session_parity_parts_only_at_ties_of_sound_runs(
        tokens, alone, ok, compared, parted):
    """Streams over ranks against the one-rank session: a parting is a
    tie where the request alone has a top-2 gap below the limit, or where
    it and the one-rank session (two sound runs) disagree."""
    want = _stream(alone, WANT.exited, WANT.entropy, WANT.top2_gap)
    res = session_parity({0: _stream(tokens, ONE.exited, ONE.entropy, [])},
                         {0: ONE}, [want], tau=2.0, tie_gap=0.05,
                         tol_h=0.01)
    assert (res.ok, res.compared, len(res.parted)) == (ok, compared, parted)


def test_session_parity_counts_one_bf16_step_at_the_logit_as_a_tie():
    """At logits in [4, 8) one bf16 step is 2^-5, above TIE_GAP_BF16: a
    stream may part from the one-rank session there at a gap of one step,
    not of two (by default); at logits in [2, 4) the step is below
    TIE_GAP_BF16."""
    assert bf16_step(5.0) == 2.0 ** -5 and bf16_step(-3.0) == 2.0 ** -6
    assert bf16_step(2.0 ** -6 * 3) == 2.0 ** -12 and bf16_step(0.0) == 0.0
    for gap, ok in ((2.0 ** -5, True), (2.0 ** -4, False)):
        want = _stream([5, 6], [False], [3.0], [1.0, gap])
        want.top_logit = [6.0, 6.0]
        res = session_parity({0: _stream([5, 7], [False], [3.0], [])},
                             {0: _stream([5, 6], [False], [3.0], [])},
                             [want], tau=2.0)
        assert res.ok == ok, gap
        # two steps pass where the caller allows two (a tensor-parallel
        # product rounds its partial sums too), four do not
        res = session_parity({0: _stream([5, 7], [False], [3.0], [])},
                             {0: _stream([5, 6], [False], [3.0], [])},
                             [want], tau=2.0, tie_steps=2)
        assert res.ok and "bf16 steps" in res.parted[0], gap
    want.top2_gap[1] = 2.0 ** -3
    res = session_parity({0: _stream([5, 7], [False], [3.0], [])},
                         {0: _stream([5, 6], [False], [3.0], [])},
                         [want], tau=2.0, tie_steps=2)
    assert not res.ok


def test_default_limits_let_one_bf16_step_part_a_stream():
    """The defaults: a token may part where the plain top-2 logits are one
    bf16 step apart at logits in [2, 4) (2^-6), not two; a gate only
    within TOL_H_BF16 of tau."""
    step = 2.0 ** -6
    want = _stream([5, 6], [False], [2.0 + TOL_H_BF16 / 2], [1.0, step])
    for gap, ok in ((step, True), (2 * step, False)):
        want.top2_gap[1] = gap
        res = stream_parity({0: _stream([5, 7], [False], want.entropy, [])},
                            [want], tau=2.0)
        assert res.ok == ok and TIE_GAP_BF16 > step
    res = stream_parity({0: _stream([5, 6], [True], [2.0 - 1e-4], [])},
                        [want], tau=2.0)
    assert res.ok and res.parted


def test_smoke_batches_are_seeded_and_routed():
    cfg = glm4_9b.smoke()
    a, b = (smoke_batches(cfg, steps=2, seq=5, device="cpu")
            for _ in range(2))
    assert len(a) == 2 and a[0]["tokens"].shape == (8, 5)
    for x, y in zip(a, b):
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert not torch.equal(a[0]["tokens"], a[1]["tokens"])
    assert sorted(a[0]["split_ids"].tolist()) == a[0]["split_ids"].tolist()


def test_grad_rel_errors():
    a = torch.tensor([3.0, 4.0])
    got = [a, None, a + torch.tensor([0.0, 0.5]), torch.zeros(2), a]
    want = [a, None, a, torch.zeros(2), None]
    assert grad_rel_errors(got, want) == [0.0, 0.0, 0.1, 0.0, float("inf")]
    assert grad_rel_errors([torch.ones(2)], [torch.zeros(2)]) == [
        float("inf")]
    # bf16 leaves are compared in fp32
    assert grad_rel_errors([a.bfloat16()], [a]) == [0.0]


def test_live_rwkv_redraws_only_the_rwkv_mixers():
    """Decay LoRA, bonus and base decays redrawn from the seed, the same
    values on every call; other leaves, and a glm4-9b tree, untouched."""
    cfg = rwkv6_3b.smoke()
    fresh = init_backbone(torch.Generator().manual_seed(0), cfg)
    a = init_backbone(torch.Generator().manual_seed(0), cfg)
    b = init_backbone(torch.Generator().manual_seed(0), cfg)
    live_rwkv(a)
    live_rwkv(b)
    mixers = [m for m in _dicts(a) if "w_lora_b" in m and "u" in m]
    assert mixers
    for m in mixers:
        assert m["u"].abs().max() > 0 and m["w_lora_b"].abs().max() > 0
        assert (m["w_base"] <= 0).all() and (m["w_base"] >= -2).all()
    changed = [not torch.equal(x, y) for x, y in
               zip(tree_leaves(fresh), tree_leaves(a))]
    assert 0 < sum(changed) == 3 * len(mixers)
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))
    glm = init_backbone(torch.Generator().manual_seed(0), glm4_9b.smoke())
    before = [t.clone() for t in tree_leaves(glm)]
    live_rwkv(glm)
    assert all(torch.equal(x, y) for x, y in zip(before, tree_leaves(glm)))


def _dicts(t):
    if isinstance(t, dict):
        yield t
        for v in t.values():
            yield from _dicts(v)
    elif isinstance(t, (list, tuple)):
        for v in t:
            yield from _dicts(v)


def test_sequential_reference_keeps_each_tokens_top2_gap():
    cfg = glm4_9b.smoke()
    params = init_backbone(torch.Generator().manual_seed(0), cfg)
    prompt = np.arange(3, 9)
    res = sequential_reference(cfg, params, prompt, 4, tau=2.0, max_len=16,
                               device="cpu")
    assert len(res.top2_gap) == len(res.tokens) == 5
    assert all(g >= 0 for g in res.top2_gap)
    logits = backbone_forward(params, cfg, tokens=torch.as_tensor(
        prompt)[None]).logits[0, -1].float()
    top2 = logits.topk(2).values
    assert res.tokens[0] == int(logits.argmax())
    assert res.top2_gap[0] == pytest.approx(float(top2[0] - top2[1]),
                                            abs=1e-5)


@pytest.mark.parametrize("grad_mode", ["eq1", "sum"])
def test_train_step_is_grad_step_then_adam(grad_mode):
    """make_train_step = make_grad_step's gradients, then Adam: the same
    bits as the two halves run by hand."""
    cfg = glm4_9b.smoke().with_(exit_layers=(1, 2))
    profile = HeteroProfile((1, 1, 2, 2))
    sc = StepConfig(model=cfg, splitee=SplitEEConfig(profile=profile),
                    grad_mode=grad_mode)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (8, 6))),
             "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (8, 6))),
             "split_ids": boundary_ids_for_batch(profile, cfg, 8, "cpu")}
    p0 = init_backbone(torch.Generator().manual_seed(0), cfg)
    p1 = init_backbone(torch.Generator().manual_seed(0), cfg)
    opt0 = adam_init(p0, sc.train.optimizer)
    opt1 = adam_init(p1, sc.train.optimizer)
    p0, opt0, m0 = make_train_step(sc)(p0, opt0, batch)
    grads, m1 = make_grad_step(sc)(p1, batch)
    assert sum(g is not None for g in grads) > 0
    p1, opt1 = adam_update(p1, grads, opt1, sc.train.optimizer,
                           make_schedule(sc.train.optimizer)(0))
    assert sorted(m0) == sorted([*m1, "lr"])
    for k in m1:
        assert torch.equal(m0[k], m1[k])
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(p0), tree_leaves(p1)))

"""The entropy gate's split algorithm (``csrc/entropy_exit.cu``) on the CPU.

The kernel splits each row's vocab over the blocks of a thread block
cluster, reduces each slice to an (m, S, U) triple and merges the triples
in rank order.  Its plain mirror, ``kernels/ref.py:entropy_exit_split_ref``,
does the same at the kernel's slice bounds; here it is held against the
JAX package's Pallas kernel (``repro.kernels.ops.entropy_exit``, interpret
mode) and ``repro.core.losses.softmax_entropy`` on the same seeded numpy
inputs, at the entropy gate of docs/ENGINES.md (1e-4, fp32), with
decisions equal wherever |H - tau| > 1e-3.  A row with -inf entries has
H = NaN in the JAX kernel, the plain version and the kernel's mirror alike
(p log p = 0 * -inf = NaN), and never exits; for the value comparisons the
row goes to every side with -inf replaced by -1e4 (p = 0 in fp32).  The
kernel itself runs on the card only (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.losses import softmax_entropy as jax_softmax_entropy
from repro.kernels import ops
from repro_torch.kernels import entropy_exit as gate_mod
from repro_torch.kernels.entropy_exit import entropy_exit, gate_splits
from repro_torch.kernels.ref import (entropy_exit_ref, entropy_exit_split_ref,
                                     gate_merge, gate_slice_bounds,
                                     gate_slice_triples)
from repro_torch.parity import GATE_CLUSTER_ROWS, gate_cluster_vocab

ATOL_H = 1e-4
GATE_MARGIN = 1e-3
SPLITS = (1, 2, 3, 8, 16)
VOCABS = (97, 2053, 4099)


def _logits(V: int) -> np.ndarray:
    """Six rows: plain random; the max (8 above the rest) in the last
    slice at every split count; -inf entries (a tenth, and the first half
    of the row: whole slices of -inf); all equal (H = log V); random at
    scale 10 (peaked); the max in the first element."""
    rng = np.random.default_rng(V)
    x = (3 * rng.standard_normal((6, V))).astype(np.float32)
    x[1, V - 1] = x[1].max() + 8
    x[2, rng.random(V) < 0.1] = -np.inf
    x[2, :V // 2] = -np.inf
    x[3] = 0.75
    x[4] *= 10 / 3
    x[5, 0] = x[5].max() + 8
    return x


_JAX = {}


def _finite(x: np.ndarray) -> np.ndarray:
    """``x`` with -inf read as -1e4 (p = 0 in fp32 either way)."""
    return np.where(np.isneginf(x), np.float32(-1e4), x)


def _jax_entropy(V: int):
    """H from the Pallas kernel (interpret) and from softmax_entropy, and
    each row's JAX decision at its threshold, on ``_logits(V)`` with -inf
    read as -1e4; computed once per V."""
    if V not in _JAX:
        finite = _finite(_logits(V))
        H_k, _ = ops.entropy_exit(jnp.asarray(finite), 0.0, interpret=True)
        H_k = np.asarray(H_k)
        H_o = np.asarray(jax_softmax_entropy(jnp.asarray(finite)))
        tau = (H_k + np.array([-0.5, 0.5, -2e-3, 2e-3, -5e-4, 5e-4])
               ).astype(np.float32)
        ex = np.array([bool(np.asarray(ops.entropy_exit(
            jnp.asarray(finite[b:b + 1]), jnp.float32(tau[b]),
            interpret=True)[1])[0]) for b in range(len(finite))])
        _JAX[V] = (H_k, H_o, tau, ex)
    return _JAX[V]


@pytest.mark.parametrize("V", VOCABS)
@pytest.mark.parametrize("splits", SPLITS)
def test_split_mirror_matches_jax(splits, V):
    H_k, H_o, tau, ex_jax = _jax_entropy(V)
    np.testing.assert_allclose(H_o, H_k, atol=ATOL_H, rtol=0)
    raw, _ = entropy_exit_split_ref(torch.from_numpy(_logits(V)), 0.0,
                                    splits)
    assert torch.isnan(raw).tolist() == [r == 2 for r in range(6)]
    H, ex = entropy_exit_split_ref(torch.from_numpy(_finite(_logits(V))),
                                   torch.from_numpy(tau), splits)
    assert ex.dtype == torch.int32
    for want in (H_k, H_o):
        np.testing.assert_allclose(H.numpy(), want, atol=ATOL_H, rtol=0)
    np.testing.assert_allclose(H[3].item(), np.log(V), atol=ATOL_H)
    far = np.abs(H_k - tau) > GATE_MARGIN
    assert far.sum() >= 4
    np.testing.assert_array_equal(ex.numpy().astype(bool)[far], ex_jax[far])


@pytest.mark.parametrize("V", VOCABS)
@pytest.mark.parametrize("splits", SPLITS)
def test_slice_bounds_tile_the_row(splits, V):
    """Slices in rank order cover [0, V) once; every bound but V is a
    multiple of 8 elements; empty slices only at the end."""
    bounds = gate_slice_bounds(V, splits)
    assert len(bounds) == splits and bounds[0][0] == 0
    assert bounds[-1][1] == V
    for (lo, hi), (nlo, _) in zip(bounds, bounds[1:]):
        assert lo <= hi == nlo
    assert all(b % 8 == 0 for lo, hi in bounds for b in (lo, hi) if b != V)
    sizes = [hi - lo for lo, hi in bounds]
    filled = sum(s > 0 for s in sizes)
    assert all(s > 0 for s in sizes[:filled])


def test_empty_slices_when_the_row_is_narrow():
    """V < splits x 8 leaves trailing slices empty; they merge as the
    empty triple and change nothing."""
    V, splits = 97, 16
    bounds = gate_slice_bounds(V, splits)
    assert sum(hi == lo for lo, hi in bounds) == 3
    x = torch.from_numpy(_logits(V))
    triples = gate_slice_triples(x, splits)
    for (lo, hi), (m, s, u) in zip(bounds, triples):
        if hi == lo:
            assert torch.all(m == -torch.inf) and not s.any() and not u.any()
    H16, _ = entropy_exit_split_ref(x, 0.0, splits)
    H1, _ = entropy_exit_split_ref(x, 0.0, 1)
    # row 2 holds -inf entries: NaN at every split count
    torch.testing.assert_close(H16, H1, atol=ATOL_H, rtol=0, equal_nan=True)


@pytest.mark.parametrize("splits", (2, 3, 8, 16))
def test_dropping_one_slice_fails_the_gate(splits):
    """Planted fault: the merge without one non-empty slice's triple
    misses the JAX entropy by more than 1e-4 in some row, for every
    slice."""
    V = 4099
    H_k, _, _, _ = _jax_entropy(V)
    x = torch.from_numpy(_finite(_logits(V)))
    triples = gate_slice_triples(x, splits)
    M, S, U = gate_merge(triples)
    H = M + torch.log(S.clamp(min=1e-30)) - U / S.clamp(min=1e-30)
    assert np.abs(H.numpy() - H_k).max() <= ATOL_H
    for r, (lo, hi) in enumerate(gate_slice_bounds(V, splits)):
        assert hi > lo
        empty = (torch.full_like(M, -torch.inf), torch.zeros_like(M),
                 torch.zeros_like(M))
        M, S, U = gate_merge(triples[:r] + [empty] + triples[r + 1:])
        S = S.clamp(min=1e-30)
        H = M + torch.log(S) - U / S
        assert np.nanmax(np.abs(H.numpy() - H_k)) > ATOL_H, r


@pytest.mark.parametrize("rows,vocab,sms,want", [
    (8, 151552, 132, 16),          # glm4-9b serve tick: 128 blocks
    (8, 65536, 132, 16),           # rwkv6-3b serve tick
    (1, 151552, 132, 16),          # one slot: the largest cluster
    (300, 151552, 132, 1),         # the rows alone fill the card
    (8, 512, 132, 1),              # the fp32 smokes: too narrow to split
    (66, 151552, 132, 1),          # rows >= SMs / 2
    (65, 151552, 132, 3),          # just below: ceil(132 / 65)
    (9, 151552, 132, 15),          # ceil(132 / 9)
    (8, 8191, 132, 1), (8, 8192, 132, 2),  # MIN_SLICE elements a block
])
def test_gate_splits(rows, vocab, sms, want):
    """The cluster size per row."""
    assert gate_splits(rows, vocab, sms) == want


@pytest.mark.parametrize("splits", range(1, 17))
def test_gate_cluster_vocab_reaches_every_cluster_size(splits):
    """The card cases of every cluster size (tests/test_torch_cuda.py,
    chip_smoke.py) rely on this row width: ``gate_splits`` gives it
    ``splits`` blocks on an H100 SXM (132 SMs), an H100 PCIe (114) and
    the fewest SMs the helper promises (46)."""
    V = gate_cluster_vocab(splits)
    for sms in (132, 114, 46):
        assert gate_splits(GATE_CLUSTER_ROWS, V, sms) == splits
    assert V % 8 != 0      # a tail after the last whole vector


def _c_params(source: str, fn: str):
    """(name, ctypes type) of each parameter of ``extern "C" int fn(...)``
    in ``source``: pointers as c_void_p, long long, int."""
    src = (Path(gate_mod.__file__).parent / "csrc" / source).read_text()
    args = re.search(r'extern "C" int ' + fn + r"\((.*?)\)", src, re.S)
    params = []
    for decl in args.group(1).split(","):
        decl = " ".join(decl.split())
        name = decl.replace("*", " ").split()[-1]
        if "*" in decl:
            params.append((name, ctypes.c_void_p))
        elif decl.startswith("long long"):
            params.append((name, ctypes.c_longlong))
        else:
            assert decl.startswith("int "), decl
            params.append((name, ctypes.c_int))
    return params


def test_ctypes_argtypes_match_the_c_signature():
    params = _c_params("entropy_exit.cu", "entropy_exit_launch")
    assert [t for _, t in params] == gate_mod._ARGTYPES
    assert [n for n, _ in params] == [
        "logits", "dtype", "rows", "row_stride", "vocab", "splits", "tau",
        "entropy", "exit_flag", "stream"]


def test_wrapper_on_the_cpu_runs_the_plain_version():
    """On a CPU tensor the wrapper is the plain version and launches
    nothing."""
    x = torch.from_numpy(_logits(2053))
    x = x.masked_fill(x.isneginf(), -1e4)
    before = entropy_exit.launches
    H, ex = entropy_exit(x, 2.0)
    H_ref, ex_ref = entropy_exit_ref(x, 2.0)
    assert torch.equal(H, H_ref) and torch.equal(ex, ex_ref)
    assert entropy_exit.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_minus_inf_logits_answer_by_device(dtype):
    """Pins the -inf rule the wrapper's docstring states: a row with a
    -inf entry and a row of -inf only have H = NaN and do not exit, in the
    wrapper on the CPU (the plain version), in the JAX kernel and in the
    kernel's mirror, which the card's answers are held to."""
    x = torch.from_numpy(_logits(2053)[:2].copy())
    x[0, 7] = -torch.inf
    x[1] = -torch.inf
    x = x.to(dtype)
    H, ex = entropy_exit(x, 2.0)
    assert torch.isnan(H).all() and not ex.any()
    H_k, ex_k = ops.entropy_exit(jnp.asarray(x.float().numpy()), 2.0,
                                 interpret=True)
    assert np.isnan(np.asarray(H_k)).all() and not np.asarray(ex_k).any()
    for splits in (1, 16):
        H_card, ex_card = entropy_exit_split_ref(x, 2.0, splits)
        assert torch.isnan(H_card).all() and not ex_card.any()

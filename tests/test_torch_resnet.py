"""The port's paper model and its pieces against the JAX package, on the CPU:
the Table-I ResNet (``repro_torch.models.resnet``), the split adapters
(``core/splitee.py``), the client and server losses and steps
(``core/strategies.py``), Eq. (1) (``core/aggregation.py``) and the numpy
data copies (``data/synthetic.py``, ``data/pipeline.py``).

Both sides start from one set of weights: the port's init, handed to the
JAX functions in their layout (OIHW conv weights to HWIO, the inverse of
``repro_torch.convert``'s map; the JAX init's eager random draws take
seconds per shape on the CPU); inputs from seeded numpy.  The JAX init's
tree and shapes are checked once against the port's.
Sizes: widths 0.125 and 0.0625 (at 0.0625 the channels are 8, 8, 8, 8, 16,
32, so layer4 takes the identity shortcut at stride 2), images 16 and 20
(odd halvings: SAME padding pads (0, 1) at even sizes and symmetrically at
odd ones), stem stride 1 and 2.

Tolerances, fp32: features, logits, BatchNorm state and gradients 1e-5 of
each tensor's scale, max(1, max|reference|) (reassociation between XLA's
and PyTorch's convolutions only).  Measured: 1.45e-5 absolute on train-mode
features of magnitude 5.9 after six layers (width 0.125, image 20); the
port in float64 differs from the JAX package in fp32 by as much (1.47e-5)
and from itself in fp32 by 5.5e-6, so the gap is the JAX side's own fp32
rounding.  The client and server losses (loss, features, BatchNorm state,
gradients) are held against the JAX losses run in float64
(``jax.enable_x64``), the more exact value of the same function: at width
0.0625, image 16, cut 5 the JAX package's fp32 gradient of layer4's conv1
departs from its float64 run by 2.2e-3 of a scale 0.075, where the port's
fp32 gradients stay within 1e-7 of it.  That gap is no fault of either
package: one of layer4's ReLU inputs lies within fp32 rounding of 0, and
the JAX fp32 run puts it on the other side of the kink
(``test_jax_fp32_gradient_gap_is_a_relu_kink``).  Eq. (1) 1e-6 (the same fp32 sums
in the same order); data copies exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import OptimizerConfig as JOptimizerConfig
from repro.configs import resnet18_cifar as jresnet18
from repro.core import aggregation as jagg
from repro.core import splitee as jsplitee
from repro.core import strategies as jstrategies
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro.models import resnet as jresnet
from repro.optim import adam_init as jadam_init
from repro_torch.config import OptimizerConfig
from repro_torch.configs import resnet18_cifar
from repro_torch.convert import (CONV_HWIO_TO_OIHW, IMAGES_NHWC_TO_NCHW,
                                 images_to_nchw, split_net_from_jax)
from repro_torch.core import aggregation as tagg
from repro_torch.core import splitee as tsplitee
from repro_torch.core import strategies as tstrategies
from repro_torch.data import pipeline as tpipeline
from repro_torch.data import synthetic as tsynthetic
from repro_torch.models import resnet as tresnet
from repro_torch.optim import adam_init
from repro_torch.tree import tree_leaves, tree_map

TOL = 1e-5

# (width_mult, image_size, stem_stride)
CONFIGS = [(0.0625, 16, 1), (0.0625, 20, 2), (0.125, 20, 1)]
CFG_IDS = ["w0.0625-16-s1-identity", "w0.0625-20-s2", "w0.125-20-s1"]
CONV_OIHW_TO_HWIO = tuple(int(i) for i in np.argsort(CONV_HWIO_TO_OIHW))


def _cfgs(width, size, stride, classes=10):
    j = jresnet.ResNetConfig(num_classes=classes, width_mult=width,
                             image_size=size, stem_stride=stride)
    t = tresnet.ResNetConfig(num_classes=classes, width_mult=width,
                             image_size=size, stem_stride=stride)
    return j, t


def _images(n, size, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, size, size, 3)).astype(np.float32)


def _to_nchw(a):
    """A JAX NHWC activation in the port's layout."""
    return np.transpose(np.asarray(a), IMAGES_NHWC_TO_NCHW)


def _close(got, want, tol=TOL):
    """Within ``tol`` of the reference's scale, max(1, max|want|)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=tol * scale, rtol=0)


def _close_trees(got, want_jax, tol=TOL):
    """A port tree against a JAX tree (converted to the port's layout)."""
    want = split_net_from_jax(jax.tree.map(np.asarray, want_jax), "cpu")
    gl, wl = list(tree_leaves(got)), list(tree_leaves(want))
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.shape == w.shape
        _close(g, w, tol)


def _to_jax(tree):
    """A port tree as numpy in the JAX package's layout."""
    return tree_map(lambda t: (np.transpose(t.numpy(), CONV_OIHW_TO_HWIO)
                               if t.ndim == 4 else t.numpy()), tree)


def _nets(tcfg, seed=0):
    """The port's init of ``tcfg`` and the same weights in JAX's layout."""
    tp, ts = tresnet.init_resnet(torch.Generator().manual_seed(seed), tcfg)
    return (tp, ts), (_to_jax(tp), _to_jax(ts))


class _JaxResNet(jsplitee.ResNetSplitModel):
    """The JAX adapter without its init: its forwards, on weights given."""

    def __post_init__(self):
        pass


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------


def test_table1_structure_and_configs():
    for ds in ("cifar10", "cifar100", "stl10"):
        t, j = resnet18_cifar.config(ds), jresnet18.config(ds)
        for f in ("num_classes", "stem_stride", "width_mult", "num_layers",
                  "image_size", "bn_momentum"):
            assert getattr(t, f) == getattr(j, f), (ds, f)
        assert t.channels() == j.channels() and t.strides() == j.strides()
    assert resnet18_cifar.config("cifar10").channels() == (64, 64, 64, 128,
                                                           256, 512)
    assert resnet18_cifar.smoke() == resnet18_cifar.config("cifar10", 0.125)
    assert resnet18_cifar.HETERO_SPLITS == jresnet18.HETERO_SPLITS
    assert resnet18_cifar.profile().split_layers == \
        jresnet18.profile().split_layers
    assert resnet18_cifar.profile(4).split_layers == (4,) * 12
    assert [f.name for f in dataclasses.fields(tresnet.ResNetConfig)] == \
        [f.name for f in dataclasses.fields(jresnet.ResNetConfig)]
    assert tresnet.layer_names(resnet18_cifar.smoke()) == \
        jresnet.layer_names(jresnet18.smoke())


@pytest.mark.parametrize("n,k,s", [(32, 3, 1), (32, 3, 2), (16, 1, 2),
                                   (20, 3, 2), (5, 3, 2), (10, 1, 2),
                                   (3, 3, 2)])
def test_same_padding_matches_jax(n, k, s):
    """The conv of one channel against lax's "SAME" conv at each size."""
    x = _images(2, n)[..., :1]
    w = np.random.default_rng(1).normal(size=(k, k, 1, 1)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        x, w, (s, s), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tresnet._conv(split_net_from_jax(w, "cpu"),
                        images_to_nchw(torch.from_numpy(x)), s)
    _close(got, _to_nchw(want))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=CFG_IDS)
def test_resnet_features_and_bn_state_match_jax(cfg, train):
    jcfg, tcfg = _cfgs(*cfg)
    (tp, ts), (params, state) = _nets(tcfg)
    if not train:   # running statistics away from their init
        ts = tree_map(lambda a: a + 0.1 * a.abs() + 0.05, ts)
        state = _to_jax(ts)
    x = _images(6, jcfg.image_size)
    xt = images_to_nchw(torch.from_numpy(x))
    for end in (1, 4):
        jh, jns = jresnet.resnet_features(params, state, x, jcfg,
                                          end_layer=end, train=train)
        th, tns = tresnet.resnet_features(tp, ts, xt, tcfg, end_layer=end,
                                          train=train)
        _close(th, _to_nchw(jh))
        _close_trees(tns, jns)
        # the rest of the net from the cut, and the heads
        jf, jns2 = jresnet.resnet_features(params, jns, jh, jcfg,
                                           start_layer=end, train=train)
        tf, tns2 = tresnet.resnet_features(tp, tns, th, tcfg,
                                           start_layer=end, train=train)
        _close(tf, _to_nchw(jf))
        _close_trees(tns2, jns2)
        _close(tresnet.head_forward(tp["head"], tf),
               jresnet.head_forward(params["head"], jf))
        thead = tresnet.init_client_head(torch.Generator().manual_seed(3),
                                         tcfg, end)
        _close(tresnet.client_head_forward(thead, th),
               jresnet.client_head_forward(_to_jax(thead), jh))


def test_identity_shortcut_is_taken_at_stride_2():
    """At width 0.0625 layer4 maps 8 -> 8 channels at stride 2: no
    projection, the shortcut is x[:, :, ::2, ::2]."""
    tcfg = tresnet.ResNetConfig(width_mult=0.0625, image_size=16)
    params, _ = tresnet.init_resnet(torch.Generator().manual_seed(0), tcfg)
    assert tcfg.channels()[2:4] == (8, 8)
    assert "proj" not in params["layer4"] and "proj" in params["layer5"]


def test_port_init_has_the_jax_init_tree_and_scale():
    """The port's own init has the JAX init's tree, shapes and per-leaf
    scale (std 1/sqrt(fan_in), 2-sigma truncation)."""
    jcfg, tcfg = _cfgs(*CONFIGS[0])
    jp, js = jax.jit(jresnet.init_resnet, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tp, ts = tresnet.init_resnet(torch.Generator().manual_seed(0), tcfg)
    want_p = split_net_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    want_s = split_net_from_jax(jax.tree.map(np.asarray, js), "cpu")
    for got, want in ((tp, want_p), (ts, want_s)):
        gl, wl = list(tree_leaves(got)), list(tree_leaves(want))
        assert [g.shape for g in gl] == [w.shape for w in wl]
    w = tp["layer6"]["conv2"]
    fan_in = w.shape[1] * 9
    std = 1 / np.sqrt(fan_in)
    assert w.abs().max() <= 2 * std + 1e-6
    assert 0.7 * std < w.std() < 1.0 * std


# ---------------------------------------------------------------------------
# split adapters
# ---------------------------------------------------------------------------


def _storages(tree):
    return [t.untyped_storage().data_ptr() for t in tree_leaves(tree)]


@pytest.mark.parametrize("make", [
    lambda: tsplitee.ResNetSplitModel(resnet18_cifar.smoke(), device="cpu"),
    lambda: tsplitee.MLPSplitModel(12, 16, 5, num_layers=6, device="cpu"),
], ids=["resnet", "mlp"])
def test_common_layers_start_identical_and_share_no_storage(make):
    """Paper §III-B: common layers identical across clients and servers,
    clients with one cut share one head init; yet every net owns its
    tensors (the port's Adam updates in place)."""
    model = make()
    splits = (3, 3, 4, 5)
    clients = [model.make_client(li) for li in splits]
    servers = [model.make_server(li) for li in splits]
    for k in ("layer1", "layer2", "layer3"):
        for c in clients[1:]:
            for a, b in zip(tree_leaves(clients[0]["trainable"]["layers"][k]),
                            tree_leaves(c["trainable"]["layers"][k])):
                assert torch.equal(a, b)
    for a, b in zip(tree_leaves(clients[0]["trainable"]["out"]),
                    tree_leaves(clients[1]["trainable"]["out"])):
        assert torch.equal(a, b)
    assert not torch.equal(clients[0]["trainable"]["out"]["b"] + 1,
                           clients[0]["trainable"]["out"]["b"])
    for k in ("layer6", "head"):
        for s in servers[1:]:
            for a, b in zip(tree_leaves(servers[0]["trainable"][k]),
                            tree_leaves(s["trainable"][k])):
                assert torch.equal(a, b)
    ptrs = [p for net in clients + servers for p in _storages(net)]
    ptrs += _storages(model.full_params)
    assert len(ptrs) == len(set(ptrs))
    # a second model from the same seed draws the same weights
    again = make()
    for a, b in zip(tree_leaves(model.make_client(4)),
                    tree_leaves(again.make_client(4))):
        assert torch.equal(a, b)


def test_adapter_nets_and_forwards_match_jax():
    """The port adapter's nets have the JAX adapter's keys and shapes, and
    its forwards on them give the JAX forwards' outputs."""
    tm = tsplitee.ResNetSplitModel(resnet18_cifar.smoke(), device="cpu")
    jm = _JaxResNet(jresnet18.smoke())
    jm.full_params, jm.full_state = _to_jax(tm.full_params), \
        _to_jax(tm.full_state)
    x = _images(4, 32)
    for li in (3, 4, 5):
        tc, ts = tm.make_client(li), tm.make_server(li)
        jc, js = jm.make_client(li), jm.make_server(li)
        for j, t in ((jc, tc), (js, ts)):
            want = split_net_from_jax(j, "cpu")
            assert [w.shape for w in tree_leaves(want)] == \
                [g.shape for g in tree_leaves(t)]
        jc["trainable"]["out"] = _to_jax(tc["trainable"]["out"])
        for j, t in ((jc, tc), (js, ts)):
            for u, v in zip(tree_leaves(split_net_from_jax(j, "cpu")),
                            tree_leaves(t)):
                assert torch.equal(u, v)
        jh, jl, _ = jm.client_forward(jc["trainable"], jc["state"], x, False)
        th, tl, _ = tm.client_forward(tc["trainable"], tc["state"],
                                      torch.from_numpy(x), False)
        _close(th, _to_nchw(jh))
        _close(tl, jl)
        jo, _ = jm.server_forward(js["trainable"], js["state"], jh, li, False)
        to, _ = tm.server_forward(ts["trainable"], ts["state"], th, li, False)
        _close(to, jo)


def test_stack_and_unstack():
    tm = tsplitee.MLPSplitModel(6, 8, 3, num_layers=4, device="cpu")
    nets = [tm.make_client(2) for _ in range(3)]
    stacked = tm.stack_clients(nets)
    assert stacked["trainable"]["out"]["w"].shape == (3, 8, 3)
    for a, b in zip(tm.unstack(stacked, 3), nets):
        for u, v in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(u, v)


# ---------------------------------------------------------------------------
# losses, gradients and steps
# ---------------------------------------------------------------------------


def _grads_jax(loss_fn, trainable, *args):
    """Loss, aux and gradients of the JAX loss run in float64, as fp32
    numpy."""
    def cast(tree, src, dst):
        return jax.tree.map(lambda a: (np.asarray(a, dst)
                                       if np.asarray(a).dtype == src
                                       else np.asarray(a)), tree)

    with jax.enable_x64(True):
        wide = cast((trainable, args), np.float32, np.float64)
        out = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(wide[0],
                                                                 *wide[1])
        (loss, aux), g = cast(out, np.float64, np.float32)
    return loss, aux, g


def _grads_port(loss_fn, trainable, *args):
    leaves = list(tree_leaves(trainable))
    for p in leaves:
        p.requires_grad_(True)
    loss, aux = loss_fn(trainable, *args)
    g = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    return loss, aux, g


@pytest.mark.parametrize("cfg", CONFIGS, ids=CFG_IDS)
@pytest.mark.parametrize("li", [3, 5])
def test_client_and_server_loss_gradients_match_jax(cfg, li):
    jcfg, tcfg = _cfgs(*cfg)
    jm = _JaxResNet(jcfg)
    tm = tsplitee.ResNetSplitModel(tcfg, device="cpu")
    x = _images(8, jcfg.image_size, seed=2)
    y = np.random.default_rng(3).integers(0, 10, 8).astype(np.int32)
    tc, ts = tm.make_client(li), tm.make_server(li)
    jc, js = _to_jax(tc), _to_jax(ts)

    jloss, (jh, jst), jg = _grads_jax(jstrategies.client_loss_fn(jm),
                                      jc["trainable"], jc["state"], x, y)
    tloss, (th, tst), tg = _grads_port(
        tstrategies.client_loss_fn(tm), tc["trainable"], tc["state"],
        torch.from_numpy(x), torch.from_numpy(y))
    _close(tloss, jloss)
    _close(th, _to_nchw(jh))
    _close_trees(tst, jst)
    _close_trees(list(tg), jg)
    assert all(not t.requires_grad for t in tree_leaves(tst))

    # both servers take the JAX client's features
    jloss, jst, jg = _grads_jax(jstrategies.server_loss_fn(jm, li),
                                js["trainable"], js["state"], jh, y)
    tloss, tst, tg = _grads_port(
        tstrategies.server_loss_fn(tm, li), ts["trainable"], ts["state"],
        torch.from_numpy(_to_nchw(jh)), torch.from_numpy(y))
    _close(tloss, jloss)
    _close_trees(tst, jst)
    _close_trees(list(tg), jg)


def test_jax_fp32_gradient_gap_is_a_relu_kink(monkeypatch):
    """Where the JAX package's fp32 client gradients depart from its
    float64 run by more than TOL (width 0.0625, image 16, cut 5), some ReLU
    input lies within fp32 rounding of 0 and changes sign between the two
    runs: the gradient is discontinuous there, so the gap says nothing of
    either package's arithmetic.  Should a later XLA round that input the
    other way, the gap and the flip both go and the test still holds."""
    jcfg, tcfg = _cfgs(*CONFIGS[0])
    jm = _JaxResNet(jcfg)
    tc = tsplitee.ResNetSplitModel(tcfg, device="cpu").make_client(5)
    jc = _to_jax(tc)
    x = _images(8, jcfg.image_size, seed=2)
    y = np.random.default_rng(3).integers(0, 10, 8).astype(np.int32)
    loss_fn = jstrategies.client_loss_fn(jm)
    _, _, g64 = _grads_jax(loss_fn, jc["trainable"], jc["state"], x, y)
    _, g32 = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jc["trainable"], jc["state"], x, y)
    gap = max(float(np.abs(np.asarray(a, np.float64) - np.asarray(b)).max())
              / max(1.0, float(np.abs(b).max()))
              for a, b in zip(jax.tree.leaves(g32), jax.tree.leaves(g64)))

    inputs = []
    relu = jax.nn.relu
    monkeypatch.setattr(jax.nn, "relu",
                        lambda v: inputs.append(np.asarray(v)) or relu(v))
    jm.client_forward(jc["trainable"], jc["state"], x, train=True)
    fp32 = inputs[:]
    inputs.clear()
    with jax.enable_x64(True):
        wide = jax.tree.map(lambda a: np.asarray(a, np.float64), jc)
        jm.client_forward(wide["trainable"], wide["state"],
                          x.astype(np.float64), train=True)
    flips = [(float(a[i]), float(b[i])) for a, b in zip(inputs, fp32)
             for i in map(tuple, np.argwhere(np.sign(a) != np.sign(b)))]
    print(f"reading fp32 vs float64 JAX gradients: gap {gap:.2e} of "
          f"scale; ReLU inputs that change sign (float64, fp32): {flips}")
    assert gap <= TOL or flips
    assert all(abs(a) < 1e-5 and abs(b) < 1e-5 for a, b in flips)


def test_server_step_moves_unreached_layers_as_jax():
    """Sequential's shared server (cut 3) stepped for a client cut at 3,
    then at 5: the second step does not reach layer4/5, whose gradient is
    None in the port and zeros in JAX; Adam's moments decay and the layers
    move alike."""
    jcfg, tcfg = _cfgs(0.0625, 16, 1)
    jm = _JaxResNet(jcfg)
    tm = tsplitee.ResNetSplitModel(tcfg, device="cpu")
    jopt_cfg, topt_cfg = JOptimizerConfig(lr=1e-3), OptimizerConfig(lr=1e-3)
    ts = tm.make_server(3)
    js = _to_jax(ts)
    layer4 = ts["trainable"]["layer4"]["conv1"].clone()
    jo, to = jadam_init(js["trainable"], jopt_cfg), adam_init(ts["trainable"],
                                                              topt_cfg)
    rng = np.random.default_rng(4)
    y = rng.integers(0, 10, 8).astype(np.int32)
    for li in (3, 5):
        c = jcfg.channels()[li - 1]
        side = 16 // (2 ** max(0, li - 3))
        h = rng.normal(size=(8, side, side, c)).astype(np.float32)
        jtr, jst, jo, jl = jax.jit(jstrategies.make_server_step(
            jm, jopt_cfg, li))(js["trainable"], js["state"], jo, h, y, 1e-3)
        js = {"trainable": jtr, "state": jst}
        ttr, tst, to, tl = tstrategies.make_server_step(tm, topt_cfg, li)(
            ts["trainable"], ts["state"], to,
            images_to_nchw(torch.from_numpy(h)), torch.from_numpy(y), 1e-3)
        ts = {"trainable": ttr, "state": tst}
        _close(tl, jl)
    _close_trees(ts, js)
    _close_trees(to.m, jo.m)
    _close_trees(to.v, jo.v)
    assert to.step == int(jo.step) == 2
    assert not torch.equal(ts["trainable"]["layer4"]["conv1"], layer4)


# ---------------------------------------------------------------------------
# Eq. (1)
# ---------------------------------------------------------------------------


def _random_servers(splits, seed=0):
    """Server trees like the MLP's: layer{l} for l > l_i, plus head."""
    rng = np.random.default_rng(seed)
    out = []
    for li in splits:
        net = {f"layer{l}": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                             "b": rng.normal(size=(4,)).astype(np.float32)}
               for l in range(li + 1, 7)}
        net["head"] = {"w": rng.normal(size=(4, 2)).astype(np.float32)}
        out.append(net)
    return out


@pytest.mark.parametrize("splits", [(3, 3, 4, 5), (1, 2, 5), (2,), (4, 4)])
@pytest.mark.parametrize("shared", [("head",), ()])
def test_cross_layer_aggregate_matches_jax(splits, shared):
    nets = _random_servers(splits)
    want = jagg.cross_layer_aggregate(
        [jax.tree.map(jnp.asarray, n) for n in nets], splits,
        extra_shared_keys=shared)
    inputs = [split_net_from_jax(n, "cpu") for n in nets]
    before = [[t.clone() for t in tree_leaves(n)] for n in inputs]
    got = tagg.cross_layer_aggregate(inputs, splits,
                                     extra_shared_keys=shared)
    assert [sorted(g) for g in got] == [sorted(w) for w in want]
    for g, w in zip(got, want):
        _close_trees(g, w, tol=1e-6)
    # inputs untouched; no two outputs share a tensor, and no averaged
    # layer shares one with an input
    for n, b in zip(inputs, before):
        for t, u in zip(tree_leaves(n), b):
            assert torch.equal(t, u)
    ptrs = [p for g in got for p in _storages(g)]
    assert len(ptrs) == len(set(ptrs))
    held = {p for n in inputs for p in _storages(n)}
    for g in got:
        for k in g:
            if sum(k in n for n in inputs) > 1:
                assert not set(_storages(g[k])) & held, k


def test_participation_counts_match_jax():
    for splits in ((3, 3, 4, 5), resnet18_cifar.HETERO_SPLITS, (1, 6)):
        assert tagg.participation_counts(splits, 6) == \
            tuple(jagg.participation_counts(splits, 6))


# ---------------------------------------------------------------------------
# data copies
# ---------------------------------------------------------------------------


def _equal_batches(a, b):
    for (ax, ay), (bx, by) in zip(a, b):
        np.testing.assert_array_equal(ax, bx)
        np.testing.assert_array_equal(ay, by)


@pytest.mark.parametrize("kw", [dict(num_classes=10, image_size=32,
                                     train_size=96, test_size=40, seed=0),
                                dict(num_classes=100, image_size=16,
                                     train_size=64, test_size=8, noise=2.0,
                                     seed=3)], ids=["cifar10", "cifar100"])
def test_image_dataset_and_augment_match_jax(kw):
    t, j = tsynthetic.SyntheticImageDataset(**kw), \
        jsynthetic.SyntheticImageDataset(**kw)
    _equal_batches([t.train, t.test], [j.train, j.test])
    np.testing.assert_array_equal(t.prototypes, j.prototypes)
    a = t.augment(np.random.default_rng(5), t.train[0][:16])
    b = j.augment(np.random.default_rng(5), j.train[0][:16])
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, t.train[0][:16])
    # the seeded batch streams, augmentation included, over two epochs
    parts_t = tpipeline.ClientPartitioner(3, seed=1).split(*t.train)
    parts_j = jpipeline.ClientPartitioner(3, seed=1).split(*j.train)
    _equal_batches(parts_t, parts_j)
    for (xt, yt), (xj, yj) in zip(parts_t, parts_j):
        it_t = tpipeline.batch_iterator(xt, yt, 8, seed=2, augment=t.augment)
        it_j = jpipeline.batch_iterator(xj, yj, 8, seed=2, augment=j.augment)
        _equal_batches([next(it_t) for _ in range(9)],
                       [next(it_j) for _ in range(9)])


def test_pipeline_helpers_match_jax():
    ds_t = tsynthetic.SyntheticSeqClsDataset(vocab_size=50, seq_len=6,
                                             train_size=120, test_size=10)
    ds_j = jsynthetic.SyntheticSeqClsDataset(vocab_size=50, seq_len=6,
                                             train_size=120, test_size=10)
    _equal_batches([ds_t.train, ds_t.test], [ds_j.train, ds_j.test])
    _equal_batches(ds_t.dirichlet_shards(4, min_size=5),
                   ds_j.dirichlet_shards(4, min_size=5))
    x, y = ds_t.train
    for alpha in (0.1, 5.0):
        _equal_batches(
            tpipeline.DirichletPartitioner(5, alpha, seed=2).split(x, y),
            jpipeline.DirichletPartitioner(5, alpha, seed=2).split(x, y))
    for n, b in ((100, 64), (10, 64), (64, 64)):
        assert tpipeline.effective_batch_size(n, b) == \
            jpipeline.effective_batch_size(n, b)
    got = tpipeline.prestage_batches(tpipeline.batch_iterator(x, y, 16), 3, 2)
    want = jpipeline.prestage_batches(jpipeline.batch_iterator(x, y, 16), 3, 2)
    _equal_batches([got], [want])
    batches = [(x[:4], y[:4]), (x[4:10], y[4:10])]
    for g, w in zip(tpipeline.global_hetero_batch(batches, [0, 2]),
                    jpipeline.global_hetero_batch(batches, [0, 2])):
        np.testing.assert_array_equal(g, w)

"""The port's model layer against the JAX package's, module by module.

Weights come from the JAX ``init_backbone(PRNGKey(0), cfg)`` through
``repro_torch.convert``; inputs are seeded numpy.  Tolerance 1e-4 (fp32
reassociation between the two frameworks' matmuls and reductions); the
JAX side runs with ``kernels="ref"`` and with ``kernels="pallas"``
(interpret mode), as its own tests do.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as jconfig
from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import backbone as jbackbone
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import rope as jrope
import repro_torch.config as tconfig
from repro_torch import configs as tconfigs
from repro_torch.convert import config_from_jax, params_from_jax, to_tensor
from repro_torch.models import attention as tattn
from repro_torch.models import backbone as tbackbone
from repro_torch.models import blocks as tblocks
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import rope as trope

ATOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.fixture(scope="module")
def smoke_cfg():
    return jconfigs.get("glm4-9b").smoke()


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ModelConfig", "HeteroProfile",
                                  "SplitEEConfig", "SSMConfig", "MoEConfig",
                                  "MLAConfig"])
def test_config_fields_mirror_jax(name):
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]  # noqa: E731
    assert names(getattr(tconfig, name)) == names(getattr(jconfig, name))


@pytest.mark.parametrize("which", ["config", "smoke"])
@pytest.mark.parametrize("arch", tconfigs.PORTED)
def test_config_matches_jax(arch, which):
    """Every ported config and its smoke equal ``config_from_jax`` of the
    JAX package's, sub-configs mapped to the port's own classes."""
    j = getattr(jconfigs.get(arch), which)()
    t = getattr(tconfigs.get(arch), which)()
    assert t == config_from_jax(j)
    assert t.segments() == j.segments()
    assert (tconfigs.get(arch).profile().split_layers
            == jconfigs.get(arch).profile().split_layers)
    for field, cls in (("moe", tconfig.MoEConfig), ("mla", tconfig.MLAConfig),
                       ("ssm", tconfig.SSMConfig)):
        sub = getattr(config_from_jax(j), field)
        assert sub is None or type(sub) is cls
    if j.moe is not None:
        assert config_from_jax(j).moe.router_dtype is torch.float32


@pytest.mark.parametrize("arch", tconfigs.PORTED)
def test_bf16_smokes_keep_the_family(arch):
    """``smoke_bf16``: the smoke at head dim 64 in bf16 (paligemma: its
    published 256), with the model's GQA group for command-r and
    paligemma (8)."""
    mod = tconfigs.get(arch)
    full, smoke, b = mod.config(), mod.smoke(), mod.smoke_bf16()
    assert (b.dtype, b.param_dtype, b.head_dim) == (
        torch.bfloat16, torch.bfloat16,
        256 if arch == "paligemma_3b" else 64)
    assert (b.num_layers, b.d_model, b.exit_layers, b.ffn_pattern,
            b.block_pattern) == (smoke.num_layers, smoke.d_model,
                                 smoke.exit_layers, smoke.ffn_pattern,
                                 smoke.block_pattern)
    if arch in ("command_r_35b", "paligemma_3b"):
        assert b.q_heads_per_kv == full.q_heads_per_kv == 8


def test_unported_architectures_raise():
    """Every architecture id of the JAX registry resolves; an unknown id
    and an unknown kernels setting raise."""
    for arch in jconfigs.ARCH_IDS:
        assert tconfigs.get(arch).config() == config_from_jax(
            jconfigs.get(arch).config())
    assert tconfigs.get("whisper-small").config().cross_attention
    with pytest.raises(ValueError, match="not a registered"):
        tconfigs.get("gpt-17")
    with pytest.raises(ValueError, match="kernels"):
        tconfigs.get("glm4-9b").smoke().with_(kernels="pallas")


def test_cross_attention_blocks_build_and_convert(smoke_cfg):
    """Cross attention and the frontend parameters are ported: a
    cross-attending config initialises ``norm_x``/``cross`` in its
    attention blocks and a ``frontend`` for audio, keeps no cross cache,
    and ``params_from_jax`` carries all of them leaf for leaf."""
    jcfg = smoke_cfg.with_(cross_attention=True, arch_type="audio",
                           cross_source_len=8)
    cfg = config_from_jax(jcfg)
    tp = tbackbone.init_backbone(torch.Generator().manual_seed(0), cfg)
    assert tp["frontend"]["w"].shape == (768, cfg.d_model)
    assert {"norm_x", "cross"} <= set(tp["segments"][0][0])
    cache = tblocks.init_block_cache(cfg, "attn", "mlp", 1, 8,
                                     torch.float32, "cpu")
    assert sorted(cache) == ["mixer"]
    with pytest.raises(ValueError, match="unknown mixer"):
        tblocks.init_block(cfg, "lstm", "mlp", torch.Generator(), "cpu")
    jp = _np(jbackbone.init_backbone(jax.random.PRNGKey(0), jcfg))
    got = params_from_jax(jp, cfg, device="cpu")
    np.testing.assert_array_equal(got["frontend"]["w"].numpy(),
                                  jp["frontend"]["w"])
    assert tbackbone.build_plan(cfg)[0][0].length == 1   # not stacked
    for k in ("wq", "wk", "wv", "wo"):
        np.testing.assert_array_equal(
            got["segments"][0][0]["cross"][k].numpy(),
            jp["segments"][0][0]["cross"][k])


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def test_rope_rotates_split_halves_like_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 4, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11], [40, 41, 42, 43, 44]],
                   np.int32)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    _close(trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            10000.0), want)


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(1)
    x = (5 * rng.standard_normal((2, 3, 64))).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = jcommon.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)
    _close(tcommon.rmsnorm({"scale": torch.from_numpy(scale)},
                           torch.from_numpy(x), 1e-5), want)


def test_swiglu_matches_jax(tiny_dense):
    p = jmlp.init_mlp(jax.random.PRNGKey(3), tiny_dense)
    x = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(np.float32)
    want = jmlp.mlp_forward(p, jnp.asarray(x), tiny_dense)
    tp = {k: to_tensor(v, "cpu") for k, v in _np(p).items()}
    _close(tmlp.mlp_forward(tp, torch.from_numpy(x),
                            config_from_jax(tiny_dense)), want)


@pytest.mark.parametrize("fixture", ["tiny_dense", "tiny_swa"])
@pytest.mark.parametrize("jkernels", ["ref", "pallas"])
def test_gqa_prefill_and_decode_match_jax(fixture, jkernels, request):
    """All four mask paths: full causal (no cache), short prefill into the
    ring (ragged Tq < Tk), long prefill over a sliding window (T >= W), and
    decode with one cache_len per row against scalar JAX calls."""
    jcfg = request.getfixturevalue(fixture).with_(kernels=jkernels)
    cfg = config_from_jax(jcfg)
    p = jattn.init_gqa(jax.random.PRNGKey(1), jcfg)
    tp = {k: to_tensor(v, "cpu") for k, v in _np(p).items()}
    rng = np.random.default_rng(4)
    B, T, max_len = 2, 9, 16
    x = rng.standard_normal((B, T, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))

    want, _ = jattn.gqa_forward(p, jnp.asarray(x), jnp.asarray(pos), jcfg)
    got, _ = tattn.gqa_forward(tp, torch.from_numpy(x),
                               torch.from_numpy(pos.copy()), cfg)
    _close(got, want)

    # prefill into a ring page (short, or longer than the window)
    jcache = jattn.init_gqa_cache(jcfg, B, max_len, jnp.float32)
    tcache = tattn.init_gqa_cache(cfg, B, max_len, torch.float32, "cpu")
    want, jcache = jattn.gqa_forward(p, jnp.asarray(x), jnp.asarray(pos), jcfg,
                                     cache=jcache,
                                     cache_len=jnp.zeros((), jnp.int32))
    got, tcache = tattn.gqa_forward(tp, torch.from_numpy(x),
                                    torch.from_numpy(pos.copy()), cfg,
                                    cache=tcache,
                                    cache_len=torch.zeros(B, dtype=torch.int32))
    _close(got, want)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])

    # decode: rows at different fill levels, each against its own JAX call
    lens = np.array([T, T + 5], np.int32)
    for name in ("k", "v"):     # row 1 pretends 5 more tokens were written
        tcache[name][1] = torch.from_numpy(
            rng.standard_normal(tcache[name].shape[1:]).astype(np.float32))
    xd = rng.standard_normal((B, 1, 64)).astype(np.float32)
    got, tcache_new = tattn.gqa_forward(
        tp, torch.from_numpy(xd), torch.from_numpy(lens[:, None].copy()), cfg,
        cache={n: t.clone() for n, t in tcache.items()},
        cache_len=torch.from_numpy(lens))
    for b in range(B):
        jc = {n: jnp.asarray(tcache[n][b:b + 1].numpy()) for n in ("k", "v")}
        want_b, jc = jattn.gqa_forward(
            p, jnp.asarray(xd[b:b + 1]), jnp.asarray(lens[b:b + 1, None]),
            jcfg, cache=jc, cache_len=jnp.int32(lens[b]))
        _close(got[b:b + 1], want_b)
        for name in ("k", "v"):
            _close(tcache_new[name][b:b + 1], jc[name])


# ---------------------------------------------------------------------------
# the backbone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fixture", ["tiny_dense", "tiny_swa", "smoke_cfg"])
def test_backbone_logits_and_exits_match_jax(fixture, request):
    jcfg = request.getfixturevalue(fixture).with_(kernels="ref")
    cfg = config_from_jax(jcfg)
    jp = jbackbone.init_backbone(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(_np(jp), cfg, device="cpu")
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 10))
    jo = jbackbone.backbone_forward(jp, jcfg, tokens=jnp.asarray(toks))
    to = tbackbone.backbone_forward(tp, cfg, tokens=torch.from_numpy(toks))
    _close(to.logits, jo.logits)
    assert len(to.exit_logits) == len(jo.exit_logits) == len(jcfg.exit_layers)
    for got, want in zip(to.exit_logits, jo.exit_logits):
        _close(got, want)


def test_backbone_prefill_then_decode_matches_jax(smoke_cfg):
    jcfg = smoke_cfg.with_(kernels="pallas")
    cfg = config_from_jax(jcfg)
    jp = jbackbone.init_backbone(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(_np(jp), cfg, device="cpu")
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab_size, (1, 7))
    jc = jbackbone.init_cache(jcfg, 1, 16, jnp.float32)
    tc = tbackbone.init_cache(cfg, 1, 16, torch.float32, "cpu")
    jo = jbackbone.backbone_forward(jp, jcfg, tokens=jnp.asarray(prompt),
                                    cache=jc, cache_len=jnp.int32(0))
    to = tbackbone.backbone_forward(tp, cfg, tokens=torch.from_numpy(prompt),
                                    cache=tc,
                                    cache_len=torch.zeros(1, dtype=torch.int32),
                                    exit_heads=(1,))
    _close(to.logits, jo.logits)
    assert to.exit_logits[0] is None
    _close(to.exit_logits[1], jo.exit_logits[1])
    tok = np.array([[int(np.argmax(np.asarray(jo.logits)[0, -1]))]])
    jo2 = jbackbone.backbone_forward(jp, jcfg, tokens=jnp.asarray(tok),
                                     cache=jo.cache, cache_len=jnp.int32(7))
    to2 = tbackbone.backbone_forward(
        tp, cfg, tokens=torch.from_numpy(tok), cache=to.cache,
        cache_len=torch.full((1,), 7, dtype=torch.int32))
    _close(to2.logits, jo2.logits)
    for got, want in zip(to2.exit_logits, jo2.exit_logits):
        _close(got, want)


def test_port_init_has_the_converted_jax_layout(smoke_cfg):
    """init_backbone draws the same tree of shapes and dtypes that convert
    produces from the JAX init."""
    cfg = config_from_jax(smoke_cfg)
    conv = params_from_jax(_np(jbackbone.init_backbone(jax.random.PRNGKey(0),
                                                       smoke_cfg)),
                           cfg, device="cpu")
    own = tbackbone.init_backbone(torch.Generator().manual_seed(0), cfg)

    def shapes(tree):
        if isinstance(tree, torch.Tensor):
            return (tuple(tree.shape), tree.dtype)
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return [shapes(v) for v in tree]

    assert shapes(own) == shapes(conv)
    assert [len(s) for s in own["segments"]] == [1, 1, 2]


def test_convert_keeps_bfloat16_bits():
    a = jnp.asarray(np.linspace(-3, 3, 7, dtype=np.float32)).astype(
        jnp.bfloat16)
    t = to_tensor(np.asarray(a), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))

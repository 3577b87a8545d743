"""The port's dense decoders (yi-34b, qwen3-8b, qwen3-8b-sw4k, qwen1.5-110b,
stablelm-1.6b) held to the JAX reference on the CPU.

Each config runs in two reduced forms: ``reduced()``, which makes every one
of them MHA (4 heads, 4 KV heads), and ``reduced().replace(n_kv_heads=2)``,
which keeps GQA, the per-KV-head biases and the q/k norm over a shared KV
head in play.  Weights come from the reference's ``Transformer.init``;
before they reach the port through ``convert.params_from_numpy``, the
leaves the reference initialises to constants -- the QKV biases and
LayerNorm biases (zeros), every norm scale including ``q_norm``/``k_norm``
(ones) -- and the untied ``unembedding`` are overwritten with numpy draws
from a seed, so the bias, norm and untied paths are held away from their
identity init.  Token and activation inputs are numpy draws too.

Tolerances, all float32, those of ``test_torch_substrate.py``: modules
atol 1e-5 / rtol 1e-5; whole-model logits and decode steps atol 2e-4 /
rtol 1e-3 (the reference's decode-parity tolerance); greedy tokens exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.launch import steps as jsteps
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models.transformer import Transformer as JTransformer
from repro_torch import convert
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import seq_ops
from repro_torch.launch import serve, steps
from repro_torch.models import attention, build_model, layers
from repro_torch.models.transformer import Transformer
from _torch_threads import one_torch_thread  # noqa: F401

MOD_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=2e-4, rtol=1e-3)

DENSE = ("yi-34b", "qwen3-8b", "qwen3-8b-sw4k", "qwen1.5-110b",
         "stablelm-1.6b")
# the last two architectures ported, each through its own model family
LAST_PORTED = ("xlstm-125m", "whisper-large-v3")
FORMS = ("reduced", "gqa")
SETUPS = [(a, f) for a in DENSE for f in FORMS]


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _form(cfg, form):
    cfg = cfg.reduced()
    return cfg.replace(n_kv_heads=2) if form == "gqa" else cfg


def _perturb(tree, rng):
    """The constant-initialised leaves (norm scales, biases) and the
    untied output table replaced by seeded draws, recursively."""
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            out[key] = _perturb(leaf, rng)
            continue
        leaf = np.asarray(leaf)
        if key == "scale":
            leaf = 1.0 + 0.2 * rng.normal(size=leaf.shape)
        elif key in ("bias", "bq", "bk", "bv"):
            leaf = 0.3 * rng.normal(size=leaf.shape)
        elif key == "unembedding":
            leaf = 0.02 * rng.normal(size=leaf.shape)
        out[key] = leaf.astype(np.float32)
    return out


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.fixture(scope="module", params=SETUPS,
                ids=[f"{a}-{f}" for a, f in SETUPS])
def setup(request):
    arch, form = request.param
    cfg_p = _form(get_config(arch), form)
    cfg_r = _form(jget_config(arch), form)
    jmodel = JTransformer(cfg_r)
    # eager: its small ops compile once for all configs, where a jitted
    # init compiles each config's whole program (~1.5 s each)
    raw = jax.tree.map(np.asarray, jmodel.init(jax.random.key(3)))
    if not cfg_r.tie_embeddings:
        # the reference draws its own output table (a second split of the
        # embedding key), so the untied path is exercised before the draw
        assert not np.array_equal(raw["embed"]["unembedding"],
                                  raw["embed"]["embedding"])
    params = _perturb(raw, np.random.default_rng(
        DENSE.index(arch) * 2 + FORMS.index(form)))
    model = convert.params_from_numpy(params, cfg_p, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    return dict(arch=arch, form=form, cfg=cfg_p, jmodel=jmodel,
                jparams=jparams, params=params, model=model)


# -- configs ------------------------------------------------------------------

@pytest.mark.parametrize("form", ("full",) + FORMS)
@pytest.mark.parametrize("arch", DENSE)
def test_config_matches_reference(arch, form):
    port, ref = get_config(arch), jget_config(arch)
    if form != "full":
        port, ref = _form(port, form), _form(ref, form)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert arch in list_archs()


@pytest.mark.parametrize("arch", LAST_PORTED)
def test_every_reference_arch_is_ported(arch):
    """The port's registry is the reference's, ``hfl-mnist`` (the port's
    ``configs.hfl_mnist.CONFIG``) included, ``list_models()`` all of it
    but ``hfl-mnist``, and each architecture builds; an unknown name
    raises."""
    from repro_torch.configs import hfl_mnist, list_models
    assert list_archs() == jlist_archs()
    assert get_config("hfl-mnist") is hfl_mnist.CONFIG
    assert list_models() == [a for a in jlist_archs() if a != "hfl-mnist"]
    assert arch in list_models()
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    assert type(model).__name__ == ("EncDecTransformer" if cfg.encoder_layers
                                    else "Transformer")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config(arch + "-x")


@pytest.mark.parametrize("arch", DENSE)
def test_transformer_builds_from_a_generator(arch):
    cfg = _form(get_config(arch), "gqa")
    gen = torch.Generator().manual_seed(0)
    model = Transformer(cfg, device="cpu", generator=gen)
    blk = model.blocks[0]
    assert (model.unembedding is None) == cfg.tie_embeddings
    assert (blk.norm1.bias is not None) == (cfg.norm == "layernorm")
    assert hasattr(blk.attn, "bq") == cfg.qkv_bias
    assert hasattr(blk.attn, "q_norm") == cfg.qk_norm
    if cfg.qkv_bias:
        assert blk.attn.bk.shape == (cfg.n_kv_heads, cfg.d_head)
    logits = model.apply(torch.zeros((1, 5), dtype=torch.int64))
    assert logits.shape == (1, 5, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


# -- layers -------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 2, 4, 32)])
def test_layernorm_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.normal(size=shape) * 3.0 + 1.5).astype(np.float32)
    scale = rng.normal(size=shape[-1:]).astype(np.float32)
    bias = rng.normal(size=shape[-1:]).astype(np.float32)
    got = layers.layernorm_apply(_t(scale), _t(bias), _t(x)).numpy()
    want = jlayers.layernorm_apply({"scale": jnp.asarray(scale),
                                    "bias": jnp.asarray(bias)},
                                   jnp.asarray(x))
    np.testing.assert_allclose(got, _np(want), **MOD_TOL)
    norm = layers.Norm("layernorm", shape[-1], torch.float32, "cpu", None)
    norm.scale.copy_(_t(scale))
    norm.bias.copy_(_t(bias))
    np.testing.assert_array_equal(norm(_t(x)).numpy(), got)
    with pytest.raises(ValueError, match="norm kind"):
        layers.norm_apply("batchnorm", _t(scale), None, _t(x))


def test_norm_apply_kinds_match_reference():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 3, 48)).astype(np.float32)
    p = {"scale": rng.normal(size=(48,)).astype(np.float32),
         "bias": rng.normal(size=(48,)).astype(np.float32)}
    for kind in layers.NORM_KINDS:
        bias = _t(p["bias"]) if kind == "layernorm" else None
        got = layers.norm_apply(kind, _t(p["scale"]), bias, _t(x)).numpy()
        want = jlayers.norm_apply(kind, {k: jnp.asarray(v)
                                         for k, v in p.items()},
                                  jnp.asarray(x))
        np.testing.assert_allclose(got, _np(want), err_msg=kind, **MOD_TOL)


# -- the model, one setup at a time -------------------------------------------

def _mask(cfg):
    return "sliding" if cfg.block_pattern == ("swa",) else "global"


def test_attention_apply_matches_reference(setup):
    """The first layer's attention with its (perturbed) bias and q/k norm,
    over S beyond the sliding window where there is one."""
    cfg = setup["cfg"]
    s = 40
    x = np.random.default_rng(4).normal(size=(2, s, cfg.d_model)) \
        .astype(np.float32)
    p = jax.tree.map(lambda l: l[0], setup["jparams"]["stage_0"]["0"])
    got = attention.attention_apply(setup["model"].blocks[0].attn, _t(x), cfg,
                                    mask_kind=_mask(cfg)).numpy()
    want = jattention.attention_apply(p["attn"], jnp.asarray(x),
                                      setup["jmodel"].cfg,
                                      mask_kind=_mask(cfg))
    np.testing.assert_allclose(got, _np(want), **MOD_TOL)
    assert seq_ops.LAUNCHES["flash_attention"] == 0     # CPU: plain version


def test_convert_carries_every_leaf(setup):
    """Each port parameter holds the (perturbed) reference leaf it came
    from: the untied table, the norms' biases, the nested q/k norms."""
    model, params, cfg = setup["model"], setup["params"], setup["cfg"]
    if not cfg.tie_embeddings:
        np.testing.assert_array_equal(model.unembedding.numpy(),
                                      params["embed"]["unembedding"])
    tree = params["stage_0"]["0"]
    blk = model.blocks[-1]
    r = cfg.n_layers - 1
    np.testing.assert_array_equal(blk.norm1.scale.numpy(),
                                  tree["norm1"]["scale"][r])
    if cfg.norm == "layernorm":
        np.testing.assert_array_equal(model.final_norm.bias.numpy(),
                                      params["final_norm"]["bias"])
    if cfg.qk_norm:
        np.testing.assert_array_equal(blk.attn.k_norm.scale.numpy(),
                                      tree["attn"]["k_norm"]["scale"][r])
    if cfg.qkv_bias:
        np.testing.assert_array_equal(blk.attn.bv.numpy(),
                                      tree["attn"]["bv"][r])
    missing = dict(params, stage_0={"0": {k: v for k, v in tree.items()
                                          if k != "attn"}})
    with pytest.raises(KeyError, match="attn"):
        convert.params_from_numpy(missing, cfg, device="cpu")


def _jit_logits_and_prefill(jmodel):
    """The reference's full logits and its ``make_prefill_step`` output in
    one compiled program."""
    jprefill, _ = jsteps.make_prefill_step(jmodel.cfg)
    return jax.jit(lambda p, t: (jmodel.apply(p, t)[0],
                                 jprefill(p, {"tokens": t})))


def test_transformer_apply_and_prefill_match_reference(setup):
    model, cfg = setup["model"], setup["cfg"]
    toks = _tokens(cfg, 2, 40, 6)
    want, want_last = _jit_logits_and_prefill(setup["jmodel"])(
        setup["jparams"], jnp.asarray(toks))
    got = model.apply(_t(toks)).numpy()
    assert got.shape == (2, 40, cfg.vocab_size)
    np.testing.assert_allclose(got, _np(want), **MODEL_TOL)
    prefill, _ = steps.make_prefill_step(cfg, model=model)
    np.testing.assert_allclose(prefill({"tokens": _t(toks)}).numpy(),
                               _np(want_last), **MODEL_TOL)


def test_serve_step_matches_reference(setup):
    """A prompt of 6 fed through the serve step, then 8 greedy tokens,
    exact against the reference's ``make_serve_step``; the cache's K/V
    after it."""
    model, cfg = setup["model"], setup["cfg"]
    jmodel, jparams = setup["jmodel"], setup["jparams"]
    toks = _tokens(cfg, 2, 6, 8)
    serve_step, _ = steps.make_serve_step(cfg, model=model)
    jserve = jax.jit(jsteps.make_serve_step(jmodel.cfg)[0])
    cache, jcache = model.init_cache(2, 16), jmodel.init_cache(2, 16)
    for i in range(6):
        _, cache = serve_step(_t(toks[:, i:i + 1]), cache, i)
        _, jcache = jserve(jparams, jnp.asarray(toks[:, i:i + 1]), jcache,
                           jnp.asarray(i, jnp.int32))
    tok, jtok = _t(toks[:, 5:6]), jnp.asarray(toks[:, 5:6])
    for i in range(6, 14):
        tok, cache = serve_step(tok, cache, i)
        jtok, jcache = jserve(jparams, jtok, jcache, jnp.asarray(i, jnp.int32))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok),
                                      err_msg=f"step {i}")
    for key in ("k", "v"):
        np.testing.assert_allclose(cache["stage_0"]["0"][key].numpy(),
                                   _np(jcache["stage_0"]["0"][key]),
                                   err_msg=key, **MODEL_TOL)


def test_prefill_matches_token_by_token_decode(setup):
    model = setup["model"]
    toks = _t(_tokens(model.cfg, 2, 24, 9))
    prefill, _ = steps.make_prefill_step(model.cfg, model=model)
    logits, _ = serve.prefill_into_cache(model, toks,
                                         model.init_cache(2, 24))
    np.testing.assert_allclose(prefill({"tokens": toks}).numpy(),
                               logits[:, 0].numpy(), **MODEL_TOL)


@pytest.mark.parametrize("form", FORMS)
def test_sw4k_decode_ring_matches_reference(form):
    """qwen3-8b-sw4k reduced to a window of 8: 24 decode steps (the ring
    wraps twice), step by step against the reference's decode_step."""
    cfg_p = _form(get_config("qwen3-8b-sw4k"), form).replace(window=8)
    cfg_r = _form(jget_config("qwen3-8b-sw4k"), form).replace(window=8)
    jmodel = JTransformer(cfg_r)
    params = _perturb(jax.tree.map(np.asarray,
                                   jmodel.init(jax.random.key(5))),
                      np.random.default_rng(11))
    jparams = jax.tree.map(jnp.asarray, params)
    model = convert.params_from_numpy(params, cfg_p, device="cpu")
    toks = _tokens(cfg_p, 2, 24, 7)
    cache, jcache = model.init_cache(2, 24), jmodel.init_cache(2, 24)
    assert cache["stage_0"]["0"]["k"].shape == (cfg_p.n_layers, 2, 8,
                                                cfg_p.n_kv_heads,
                                                cfg_p.d_head)
    jdec = jax.jit(jmodel.decode_step)
    for i in range(24):
        got, cache = model.decode_step(_t(toks[:, i:i + 1]), cache, i)
        want, jcache = jdec(jparams, jnp.asarray(toks[:, i:i + 1]), jcache,
                            jnp.asarray(i, jnp.int32))
        np.testing.assert_allclose(got.numpy(), _np(want),
                                   err_msg=f"step {i}", **MODEL_TOL)


@pytest.mark.parametrize("arch", ("qwen3-8b", "stablelm-1.6b"))
def test_serve_cli_on_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                       "--tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert f"{arch}-reduced" in out and "device=cpu" in out

"""The port's prefix-LM decoder (paligemma-3b) held to the JAX reference on
the CPU.

paligemma runs in two reduced forms: ``reduced()`` (4 heads, 1 KV head:
MQA) and ``reduced().replace(n_kv_heads=2)``.  Weights come from the
reference's ``Transformer.init``, with the constant-initialised norm
scales redrawn from numpy before ``convert.params_from_numpy`` (all-ones
scales would hide the norm path); tokens, patch embeddings and activations
are numpy draws from a seed.  On the CPU the flash wrapper runs its plain
version, which computes the reference's ``prefix`` mask (causal, or key
before ``prefix_len``); ``chip_smoke.py`` and ``test_torch_cuda.py`` hold
the kernels to it on the card.

Tolerances, float32, those of ``test_torch_substrate.py``: modules atol
1e-5 / rtol 1e-5; logits and decode steps atol 2e-4 / rtol 1e-3 (the
reference's decode-parity tolerance); greedy tokens exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro.models import attention as jattention
from repro.models.transformer import Transformer as JTransformer
from repro_torch import convert
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import seq_ops
from repro_torch.launch import serve, steps
from repro_torch.models import attention
from _torch_threads import one_torch_thread  # noqa: F401

MOD_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=2e-4, rtol=1e-3)

ARCH = "paligemma-3b"
FORMS = ("reduced", "gqa")


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _form(cfg, form):
    cfg = cfg.reduced()
    return cfg.replace(n_kv_heads=2) if form == "gqa" else cfg


def _perturb(tree, rng):
    """The norm scales (ones at init) redrawn, recursively."""
    return {k: _perturb(v, rng) if isinstance(v, dict) else
            (1.0 + 0.2 * rng.normal(size=np.shape(v))).astype(np.float32)
            if k == "scale" else np.asarray(v, np.float32)
            for k, v in tree.items()}


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.fixture(scope="module", params=FORMS)
def setup(request):
    form = request.param
    cfg = _form(get_config(ARCH), form)
    jmodel = JTransformer(_form(jget_config(ARCH), form))
    params = _perturb(jax.tree.map(np.asarray, jmodel.init(jax.random.key(2))),
                      np.random.default_rng(FORMS.index(form)))
    return dict(form=form, cfg=cfg, jmodel=jmodel, params=params,
                jparams=jax.tree.map(jnp.asarray, params),
                model=convert.params_from_numpy(params, cfg, device="cpu"))


# -- config --------------------------------------------------------------------

@pytest.mark.parametrize("form", ("full",) + FORMS)
def test_config_matches_reference(form):
    port, ref = get_config(ARCH), jget_config(ARCH)
    if form != "full":
        port, ref = _form(port, form), _form(ref, form)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert ARCH in list_archs()
    assert port.prefix_tokens == (256 if form == "full" else 8)


# -- the prefix mask -------------------------------------------------------------

@pytest.mark.parametrize("s,prefix,kv", [(40, 8, 1), (40, 1, 2), (40, 40, 1),
                                         (33, 17, 4)])
def test_attention_plain_prefix_matches_reference_sdpa(s, prefix, kv):
    """The flash wrapper's plain version under the prefix mask against the
    reference's ``_sdpa(..., "prefix")``: a prefix of 1, a ragged one,
    and one of S (full attention)."""
    q = _normal((2, s, 4, 32), s + prefix)
    k, v = _normal((2, s, kv, 32), 1), _normal((2, s, kv, 32), 2)
    got = seq_ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                  prefix_len=prefix).numpy()
    pos = jnp.arange(s)
    want = jattention._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            pos, pos, "prefix", prefix_len=prefix)
    np.testing.assert_allclose(got, _np(want), **MOD_TOL)
    assert seq_ops.LAUNCHES["flash_attention"] == 0     # CPU: plain version
    mask = seq_ops.attention_mask(s, "cpu", prefix_len=prefix)
    assert bool(mask[:prefix, :prefix].all())           # bidirectional
    assert int(mask.sum()) == s * (s + 1) // 2 + prefix * (prefix - 1) // 2


@pytest.mark.parametrize("kw", [dict(window=4, prefix_len=3),
                                dict(window=4, chunk=8),
                                dict(prefix_len=3, chunk=8),
                                dict(causal=False, prefix_len=3),
                                dict(causal=False, chunk=8),
                                dict(chunk=-1)])
def test_flash_rejects_masks_the_reference_never_makes(kw):
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="flash_attention"):
        seq_ops.flash_attention(q, q, q, **kw)


def test_attention_apply_and_decode_prefix_match_reference(setup):
    """The first layer's attention over 8 patches and 24 text positions,
    then one decode step at index 31 with the prefix mask, against the
    reference's."""
    cfg, model = setup["cfg"], setup["model"]
    p = jax.tree.map(lambda l: l[0], setup["jparams"]["stage_0"]["0"])
    attn = model.blocks[0].attn
    x = _normal((2, 32, cfg.d_model), 4)
    got = attention.attention_apply(attn, _t(x), cfg, mask_kind="prefix",
                                    prefix_len=8).numpy()
    want = jattention.attention_apply(p["attn"], jnp.asarray(x),
                                      setup["jmodel"].cfg, mask_kind="prefix",
                                      prefix_len=8)
    np.testing.assert_allclose(got, _np(want), **MOD_TOL)
    ck = _normal((2, 40, cfg.n_kv_heads, cfg.d_head), 5)
    cv = _normal((2, 40, cfg.n_kv_heads, cfg.d_head), 6)
    xd = _normal((2, 1, cfg.d_model), 7)
    cache = {"k": _t(ck.copy()), "v": _t(cv.copy())}
    got, cache = attention.attention_decode(attn, _t(xd), cfg, cache, 31,
                                            mask_kind="prefix", prefix_len=8)
    want, jcache = jattention.attention_decode(
        p["attn"], jnp.asarray(xd), setup["jmodel"].cfg,
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, jnp.asarray(31),
        mask_kind="prefix", prefix_len=8)
    np.testing.assert_allclose(got.numpy(), _np(want), **MOD_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), _np(jcache[key]),
                                   **MOD_TOL)


# -- the model -------------------------------------------------------------------

def test_transformer_apply_with_prefix_matches_reference(setup):
    """Logits of the text positions only, 8 patch embeddings in front."""
    cfg, model, jmodel = setup["cfg"], setup["model"], setup["jmodel"]
    toks = _tokens(cfg, 2, 24, 8)
    extra = _normal((2, cfg.prefix_tokens, cfg.d_model), 9)
    jprefill, _ = jsteps.make_prefill_step(jmodel.cfg)
    want, want_last = jax.jit(lambda p, t, e: (
        jmodel.apply(p, t, extra_embeddings=e)[0],
        jprefill(p, {"tokens": t, "embeddings": e})))(
        setup["jparams"], jnp.asarray(toks), jnp.asarray(extra))
    got, aux = model.apply(_t(toks), _t(extra), with_aux=True)
    assert got.shape == (2, 24, cfg.vocab_size)
    assert float(aux) == 0.0                             # no MoE layer
    np.testing.assert_allclose(got.numpy(), _np(want), **MODEL_TOL)
    prefill, _ = steps.make_prefill_step(cfg, model=model)
    last = prefill({"tokens": _t(toks), "embeddings": _t(extra)})
    np.testing.assert_allclose(last.numpy(), _np(want_last), **MODEL_TOL)
    # the prefix changes the text's logits
    assert not np.allclose(model.apply(_t(toks)).numpy(), got.numpy(),
                           atol=1e-3)


def test_prefill_prefix_then_decode_matches_reference(setup):
    """The reference's ``_roundtrip`` (tests/test_decode_parity.py): the
    prefix through ``prefill_prefix``, then 24 text tokens decoded from
    index P with ``prefix_len=P``; each step's logits against the
    reference's and against the full forward's, the caches after the
    prefix against the reference's."""
    cfg, model, jmodel = setup["cfg"], setup["model"], setup["jmodel"]
    jparams, p_len, s = setup["jparams"], cfg.prefix_tokens, 24
    toks = _tokens(cfg, 2, s, 10)
    extra = _normal((2, p_len, cfg.d_model), 11)
    cache = model.prefill_prefix(model.init_cache(2, s + p_len), _t(extra))
    jcache = jax.jit(jmodel.prefill_prefix)(
        jparams, jmodel.init_cache(2, s + p_len), jnp.asarray(extra))
    for key in ("k", "v"):
        np.testing.assert_allclose(cache["stage_0"]["0"][key].numpy(),
                                   _np(jcache["stage_0"]["0"][key]),
                                   err_msg=key, **MODEL_TOL)
    jdec = jax.jit(lambda p, t, c, i: jmodel.decode_step(
        p, t, c, i, prefix_len=p_len))
    steps_got, steps_want = [], []
    for i in range(s):
        got, cache = model.decode_step(_t(toks[:, i:i + 1]), cache, p_len + i,
                                       prefix_len=p_len)
        want, jcache = jdec(jparams, jnp.asarray(toks[:, i:i + 1]), jcache,
                            jnp.asarray(p_len + i, jnp.int32))
        steps_got.append(got[:, 0].numpy())
        steps_want.append(_np(want[:, 0]))
    np.testing.assert_allclose(np.stack(steps_got, 1),
                               np.stack(steps_want, 1), **MODEL_TOL)
    full = model.apply(_t(toks), _t(extra)).numpy()
    np.testing.assert_allclose(np.stack(steps_got, 1), full, **MODEL_TOL)


def test_serve_step_matches_reference(setup):
    """``make_serve_step`` passes the config's ``prefix_tokens`` as the
    reference's does: a prompt of 6 fed from index 0, then 8 greedy
    tokens, exact."""
    cfg, model, jmodel = setup["cfg"], setup["model"], setup["jmodel"]
    toks = _tokens(cfg, 2, 6, 12)
    serve_step, _ = steps.make_serve_step(cfg, model=model)
    jserve = jax.jit(jsteps.make_serve_step(jmodel.cfg)[0])
    cache, jcache = model.init_cache(2, 16), jmodel.init_cache(2, 16)
    _, cache = serve.prefill_into_cache(model, _t(toks), cache)
    for i in range(6):
        _, jcache = jserve(setup["jparams"], jnp.asarray(toks[:, i:i + 1]),
                           jcache, jnp.asarray(i, jnp.int32))
    tok, jtok = _t(toks[:, 5:6]), jnp.asarray(toks[:, 5:6])
    for i in range(6, 14):
        tok, cache = serve_step(tok, cache, i)
        jtok, jcache = jserve(setup["jparams"], jtok, jcache,
                              jnp.asarray(i, jnp.int32))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok),
                                      err_msg=f"step {i}")


def test_convert_carries_the_perturbed_norms(setup):
    model, params = setup["model"], setup["params"]
    np.testing.assert_array_equal(model.blocks[1].norm2.scale.numpy(),
                                  params["stage_0"]["0"]["norm2"]["scale"][1])
    assert model.unembedding is None                     # tied
    assert model.embed_scale == pytest.approx(setup["cfg"].d_model ** 0.5)


def test_serve_cli_on_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                       "--tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert f"{ARCH}-reduced" in out and "device=cpu" in out

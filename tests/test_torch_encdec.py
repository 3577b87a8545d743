"""The port's encoder-decoder (whisper-large-v3) and the flash kernel's
own key length held to the JAX reference on the CPU.

The config runs in two reduced forms: ``reduced()`` (2 + 2 layers,
d_model 256, 4 heads, 4 KV heads: MHA; 16 stub frames) and
``reduced().replace(n_kv_heads=2)``.  Weights come from the reference's
``EncDecTransformer.init`` with the LayerNorm scales and biases and the
QKV and MLP biases redrawn from numpy away from ones and zeros, so a
misplaced add shows; they reach the port through
``convert.params_from_numpy``.  Frames and tokens are numpy draws: 16
frames, 12 decoder tokens.  The reference programs are jitted once a
module (``functools.lru_cache``).

Tolerances, float32, those of ``test_torch_moe_archs.py``: modules atol
1e-5 / rtol 1e-5; logits and decode steps atol 2e-4 / rtol 1e-3; greedy
tokens exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro.models import attention as jattention
from repro.models import encdec as jencdec
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import seq_ops
from repro_torch.launch import serve, steps
from repro_torch.models import attention, build_model
from repro_torch.models.encdec import EncDecTransformer, sinusoid_positions
from _torch_threads import one_torch_thread  # noqa: F401

MOD_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=2e-4, rtol=1e-3)

ARCH = "whisper-large-v3"
FORMS = ("reduced", "gqa")
# the leaves initialised to constants: LayerNorm scales and biases, the
# QKV and MLP biases
CONSTANTS = ("scale", "bias", "bq", "bk", "bv", "b_in", "b_out")
B, S, FRAMES = 2, 12, 16


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _form(cfg, form):
    cfg = cfg.reduced()
    return cfg.replace(n_kv_heads=2) if form == "gqa" else cfg


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)) \
        .astype(np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _perturb(tree, rng):
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            out[key] = _perturb(leaf, rng)
            continue
        leaf = np.asarray(leaf, np.float32)
        if key == "scale":
            leaf = 1.0 + 0.2 * rng.normal(size=leaf.shape)
        elif key in CONSTANTS:
            leaf = 0.3 * rng.normal(size=leaf.shape)
        out[key] = leaf.astype(np.float32)
    return out


@pytest.fixture(scope="module", params=FORMS)
def setup(request):
    form = request.param
    cfg = _form(get_config(ARCH), form)
    jmodel = jencdec.EncDecTransformer(_form(jget_config(ARCH), form))
    params = _perturb(jax.tree.map(np.asarray, jmodel.init(jax.random.key(6))),
                      np.random.default_rng(FORMS.index(form)))
    return dict(cfg=cfg, jmodel=jmodel, params=params,
                jparams=jax.tree.map(jnp.asarray, params),
                model=convert.params_from_numpy(params, cfg, device="cpu"),
                frames=_normal((B, FRAMES, cfg.d_model), 30),
                tokens=_tokens(cfg, B, S, 31))


@functools.lru_cache(maxsize=None)
def _jit(jmodel, what):
    if what == "apply":
        return jax.jit(lambda p, t, f: jmodel.apply(
            p, t, extra_embeddings=f)[0])
    if what == "encode":
        return jax.jit(jmodel.encode)
    if what == "prefill_cross":
        return jax.jit(jmodel.prefill_cross)
    return jax.jit(lambda p, t, c, i: jmodel.decode_step(p, t, c, i))


def _layer(jparams, group, i=0):
    return jax.tree.map(lambda a: a[i], jparams[group])


# -- configs and construction ---------------------------------------------------

@pytest.mark.parametrize("form", ("full",) + FORMS)
def test_config_matches_reference(form):
    port, ref = get_config(ARCH), jget_config(ARCH)
    if form != "full":
        port, ref = _form(port, form), _form(ref, form)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_build_model_is_an_encoder_decoder():
    """``build_model`` returns an ``EncDecTransformer``; drawn from a
    generator, the biases are zeros and the norm scales ones, and the MLP
    is whisper's: no gate, both biases."""
    cfg = get_config(ARCH).reduced()
    assert isinstance(build_model(cfg, device="cpu"), EncDecTransformer)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    assert len(model.encoder) == cfg.encoder_layers
    assert len(model.decoder) == cfg.n_layers
    mlp = model.decoder[0].mlp
    assert mlp.w_gate is None and mlp.b_in.shape == (cfg.d_ff,)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in CONSTANTS:
            assert float(p.abs().sum() if leaf != "scale"
                         else (p - 1).abs().sum()) == 0.0, name
    logits = model.apply(torch.zeros((1, 3), dtype=torch.int64),
                         torch.zeros((1, 5, cfg.d_model)))
    assert logits.shape == (1, 3, cfg.vocab_size)
    with pytest.raises(ValueError, match="frames"):
        model.apply(torch.zeros((1, 3), dtype=torch.int64))


@pytest.mark.parametrize("d", [256, 1280, 2])
def test_sinusoid_positions_match_reference(d):
    """At the positions the other tests use, at the module tolerance; at
    whisper's 447 and 1499 within p · 2^-22: XLA's float32 ``exp`` and
    torch's round a frequency up to one ulp (2^-24 relative) apart, and
    the angle p · f carries that times p into sin and cos."""
    pos = np.array([0, 1, 7, 11, 15, 447, 1499], np.int32)
    want = _np(jencdec.sinusoid_positions(jnp.asarray(pos), d))
    got = sinusoid_positions(_t(pos), d).numpy()
    assert got.dtype == np.float32 and got.shape == (pos.size, d)
    np.testing.assert_allclose(got[:5], want[:5], **MOD_TOL)
    for i in (5, 6):
        np.testing.assert_allclose(got[i], want[i], rtol=0,
                                   atol=pos[i] * 2.0 ** -22)


# -- the flash kernel's own key length ---------------------------------------------

@pytest.mark.parametrize("s_q,s_kv,h,kv", [(1, 16, 4, 4), (12, 16, 4, 2),
                                           (9, 5, 4, 1), (3, 70, 2, 2)])
def test_attention_plain_two_lengths_matches_reference(s_q, s_kv, h, kv):
    """``attention_plain`` (and ``flash_attention`` on the CPU) with S_kv
    != S_q against the reference's cross-attention einsum
    (``encdec._cross_decode`` with identity projections: q = x over the
    given K/V)."""
    dh = 16
    x = _normal((B, s_q, h * dh), 40)
    k = _normal((B, s_kv, kv, dh), 41)
    v = _normal((B, s_kv, kv, dh), 42)
    eye = np.eye(h * dh, dtype=np.float32)
    p = {"wq": eye.reshape(h * dh, h, dh), "wo": eye.reshape(h, dh, h * dh)}
    jcfg = jget_config(ARCH).reduced().replace(qkv_bias=False)
    want = jencdec._cross_decode(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                 jnp.asarray(k), jnp.asarray(v), jcfg)
    q = _t(x).reshape(B, s_q, h, dh)
    for got in (seq_ops.attention_plain(q, _t(k), _t(v), causal=False),
                seq_ops.flash_attention(q, _t(k), _t(v), causal=False)):
        np.testing.assert_allclose(got.reshape(B, s_q, h * dh).numpy(),
                                   _np(want), **MOD_TOL)


@pytest.mark.parametrize("mask", [dict(causal=True), dict(window=4),
                                  dict(causal=True, prefix_len=3),
                                  dict(causal=True, chunk=4)],
                         ids=["causal", "window", "prefix", "chunk"])
def test_two_lengths_take_full_attention_only(mask):
    kw = dict(causal=False, window=0, prefix_len=0, chunk=0)
    kw.update(mask)
    with pytest.raises(ValueError, match="full attention only"):
        seq_ops.check_mask(kw["causal"], kw["window"], kw["prefix_len"],
                           kw["chunk"], 6, 9)
    q, k = torch.zeros((1, 6, 2, 16)), torch.zeros((1, 9, 2, 16))
    with pytest.raises(ValueError, match="full attention only"):
        seq_ops.flash_attention(q, k, k, **kw)
    seq_ops.check_mask(kw["causal"], kw["window"], kw["prefix_len"],
                       kw["chunk"], 9, 9)


# -- the layers ----------------------------------------------------------------------

def test_bidirectional_attention_matches_reference(setup):
    cfg, jcfg = setup["cfg"], setup["jmodel"].cfg
    x = _normal((B, FRAMES, cfg.d_model), 50)
    jp = _layer(setup["jparams"], "encoder")["attn"]
    want = jattention.bidirectional_attention_apply(jp, jnp.asarray(x), jcfg,
                                                    use_rope=False)
    got = attention.bidirectional_attention_apply(
        setup["model"].encoder[0].attn, _t(x), cfg, use_rope=False)
    np.testing.assert_allclose(got.numpy(), _np(want), **MOD_TOL)


def test_cross_attention_matches_reference(setup):
    cfg, jcfg = setup["cfg"], setup["jmodel"].cfg
    x = _normal((B, S, cfg.d_model), 51)
    enc = _normal((B, FRAMES, cfg.d_model), 52)
    jp = _layer(setup["jparams"], "decoder")["cross_attn"]
    want = jattention.cross_attention_apply(jp, jnp.asarray(x),
                                            jnp.asarray(enc), jcfg)
    got = attention.cross_attention_apply(
        setup["model"].decoder[0].cross_attn, _t(x), _t(enc), cfg)
    np.testing.assert_allclose(got.numpy(), _np(want), **MOD_TOL)


# -- the model ----------------------------------------------------------------------

def test_encode_matches_reference(setup):
    want = _jit(setup["jmodel"], "encode")(setup["jparams"],
                                           jnp.asarray(setup["frames"]))
    got = setup["model"].encode(_t(setup["frames"]))
    np.testing.assert_allclose(got.numpy(), _np(want), **MODEL_TOL)


def test_logits_match_reference(setup):
    want = _jit(setup["jmodel"], "apply")(
        setup["jparams"], jnp.asarray(setup["tokens"]),
        jnp.asarray(setup["frames"]))
    got, aux = setup["model"].apply(_t(setup["tokens"]).long(),
                                    _t(setup["frames"]), with_aux=True)
    np.testing.assert_allclose(got.numpy(), _np(want), **MODEL_TOL)
    assert float(aux) == 0.0 and aux.dtype == torch.float32


def _reference_cache(s, steps_fed):
    """The reference's cache after ``prefill_cross`` and ``steps_fed``
    decode steps of the tokens, and the logits of each of those steps."""
    jmodel = s["jmodel"]
    jcache = _jit(jmodel, "prefill_cross")(
        s["jparams"], jmodel.init_cache(B, S), jnp.asarray(s["frames"]))
    out = []
    for i in range(steps_fed):
        logits, jcache = _jit(jmodel, "decode")(
            s["jparams"], jnp.asarray(s["tokens"][:, i:i + 1]), jcache,
            jnp.asarray(i, jnp.int32))
        out.append(logits)
    return jcache, out


def test_prefill_cross_cache_leaves_match_reference(setup):
    model = setup["model"]
    jcache, _ = _reference_cache(setup, 0)
    cache = model.prefill_cross(model.init_cache(B, S), _t(setup["frames"]))
    assert set(cache["decoder"]) == {"k", "v", "cross_k", "cross_v"}
    for name, leaf in jcache["decoder"].items():
        assert tuple(cache["decoder"][name].shape) == leaf.shape
        np.testing.assert_allclose(cache["decoder"][name].numpy(), _np(leaf),
                                   **MODEL_TOL, err_msg=name)


def test_decode_from_reference_cache(setup):
    """The reference fills the cross cache and decodes 6 tokens; its cache
    reaches the port through ``convert.cache_from_numpy``; the port decodes
    the other 6, each step's logits against the reference's, and the last
    against the teacher-forced logits."""
    model = setup["model"]
    jcache, _ = _reference_cache(setup, 6)
    cache = convert.cache_from_numpy(jax.tree.map(np.asarray, jcache), model)
    _, want = _reference_cache(setup, S)
    for i in range(6, S):
        with torch.no_grad():
            got, cache = model.decode_step(
                _t(setup["tokens"][:, i:i + 1]).long(), cache, i)
        np.testing.assert_allclose(got.numpy(), _np(want[i]), **MODEL_TOL)
    full = model.apply(_t(setup["tokens"]).long(), _t(setup["frames"]))
    np.testing.assert_allclose(got[:, 0].numpy(), full[:, -1].numpy(),
                               **MODEL_TOL)


def test_prefill_and_serve_steps_match_reference(setup):
    cfg, jcfg = setup["cfg"], setup["jmodel"].cfg
    batch = {"tokens": setup["tokens"], "embeddings": setup["frames"]}
    jprefill, _ = jsteps.make_prefill_step(jcfg)
    want = jax.jit(jprefill)(setup["jparams"],
                             jax.tree.map(jnp.asarray, batch))
    prefill, _ = steps.make_prefill_step(cfg, model=setup["model"])
    got = prefill({"tokens": _t(batch["tokens"]).long(),
                   "embeddings": _t(batch["embeddings"])})
    np.testing.assert_allclose(got.numpy(), _np(want), **MODEL_TOL)

    jserve, _ = jsteps.make_serve_step(jcfg)
    jserve = jax.jit(jserve)
    serve_step, model = steps.make_serve_step(cfg, model=setup["model"])
    jcache, _ = _reference_cache(setup, 0)
    cache = model.prefill_cross(model.init_cache(B, S), _t(setup["frames"]))
    jtok = setup["tokens"][:, :1]
    tok = _t(jtok).long()
    for i in range(6):
        jtok, jcache = jserve(setup["jparams"], jnp.asarray(jtok), jcache,
                              jnp.asarray(i, jnp.int32))
        tok, cache = serve_step(tok, cache, i)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_serve_cli_runs_on_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "4", "--tokens", "4",
                       "--cache-len", "16"]) == 0
    assert "arch=whisper-large-v3-reduced device=cpu" in \
        capsys.readouterr().out

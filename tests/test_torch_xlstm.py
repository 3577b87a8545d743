"""The port's xLSTM (xlstm-125m: mLSTM and sLSTM blocks alternating, no
FFN) held to the JAX reference on the CPU.

The config runs reduced (2 layers, d_model 256, 4 heads: an mLSTM head
of 128, an sLSTM head of 64 and an odd sLSTM post-projection of 341).
Weights come from the reference's ``Transformer.init`` with every leaf
initialised to a constant -- norm scales, ``b_fgate`` and ``b_gates``
(the forget slices at 3.0), ``b_igate``, the conv biases -- redrawn away
from it from numpy, so a misplaced add or scale shows; they reach the
port through ``convert.params_from_numpy``.  Tokens, activations and
decode states are numpy draws.  The reference programs are jitted once a
module (``functools.lru_cache``).

Tolerances, float32, those of ``test_torch_moe_archs.py``: blocks atol
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
from repro.models import xlstm as jxlstm
from repro.models.transformer import Transformer as JTransformer
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve, steps
from repro_torch.models import xlstm
from repro_torch.models.transformer import Block, Transformer
from _torch_threads import one_torch_thread  # noqa: F401

MOD_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=2e-4, rtol=1e-3)

ARCH = "xlstm-125m"
KINDS = ("mlstm", "slstm")
# the reference's tuple caches, leaf by leaf
LEAVES = {"mlstm": ("c", "n", "m", "conv"),
          "slstm": ("c", "n", "h", "m", "conv")}
# the leaves a block initialises to constants
CONSTANTS = ("scale", "norm_scale", "b_igate", "b_fgate", "b_gates",
             "conv_b")
B, S = 2, 24


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


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
        if key in CONSTANTS:
            scale = 0.2 if "scale" in key else 0.3
            leaf = leaf + scale * rng.normal(size=leaf.shape)
        out[key] = leaf.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def setup():
    cfg = get_config(ARCH).reduced()
    jmodel = JTransformer(jget_config(ARCH).reduced())
    params = _perturb(jax.tree.map(np.asarray, jmodel.init(jax.random.key(5))),
                      np.random.default_rng(0))
    jparams = jax.tree.map(jnp.asarray, params)
    return dict(cfg=cfg, jcfg=jmodel.cfg, jmodel=jmodel, params=params,
                jparams=jparams,
                model=convert.params_from_numpy(params, cfg, device="cpu"))


@functools.lru_cache(maxsize=None)
def _japply(jmodel):
    return jax.jit(lambda p, t: jmodel.apply(p, t)[0])


@functools.lru_cache(maxsize=None)
def _jdecode(jmodel):
    return jax.jit(lambda p, t, c, i: jmodel.decode_step(p, t, c, i))


def _block(s, kind):
    """The first ``kind`` block: the reference's params and the port's
    module."""
    pos = s["cfg"].block_pattern.index(kind)
    jp = jax.tree.map(lambda a: a[0], s["jparams"]["stage_0"][str(pos)][kind])
    return jp, getattr(s["model"].blocks[pos], kind)


# -- configs and construction ---------------------------------------------------

@pytest.mark.parametrize("reduce", [False, True])
def test_config_matches_reference(reduce):
    port, ref = get_config(ARCH), jget_config(ARCH)
    if reduce:
        port, ref = port.reduced(), ref.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_transformer_builds_from_a_generator():
    """Gate weights, biases and norm scales stay float32 under bf16
    parameters; the forget biases start at 3.0; a ``none`` FFN block has no
    norm2 and no MLP; the heads and widths are the reference's."""
    cfg = get_config(ARCH).reduced().replace(param_dtype_str="bfloat16")
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    assert [blk.kind for blk in model.blocks] == ["mlstm", "slstm"]
    m, sl = model.blocks[0].mlstm, model.blocks[1].slstm
    d = cfg.d_model
    assert m.wq.shape == (2 * d, cfg.n_heads, 2 * d // cfg.n_heads)
    assert m.w_up_main.dtype == torch.bfloat16
    for p in (m.w_igate, m.w_fgate, m.b_fgate, m.norm_scale, sl.r_gates,
              sl.b_gates, sl.norm_scale):
        assert p.dtype == torch.float32
    assert bool((m.b_fgate == 3.0).all()) and bool((m.b_igate == 0).all())
    assert bool((sl.b_gates[d:2 * d] == 3.0).all())
    assert float(sl.b_gates[:d].abs().sum() + sl.b_gates[2 * d:].abs().sum()) \
        == 0.0
    assert sl.w_up.shape == (d, 341) and sl.w_down.shape == (341, d)
    for blk in model.blocks:
        assert not hasattr(blk, "norm2") and not hasattr(blk, "mlp")
    assert int(4.0 / 3.0 * get_config(ARCH).d_model) == 1024
    logits = model.apply(torch.zeros((1, 5), dtype=torch.int64))
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("what", ["mixer", "ffn"])
def test_unknown_layer_kinds_raise(what):
    cfg = get_config(ARCH).reduced()
    kind, ffn = ("lstm", "none") if what == "mixer" else ("mlstm", "glu")
    with pytest.raises(ValueError, match="unknown"):
        Block(cfg, kind, ffn, "cpu", None)


# -- the blocks -------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_block_apply_matches_reference(setup, kind):
    jp, p = _block(setup, kind)
    x = _normal((B, S, setup["cfg"].d_model), 11)
    apply = {"mlstm": jxlstm.mlstm_block_apply,
             "slstm": jxlstm.slstm_block_apply}[kind]
    want = jax.jit(lambda p, x: apply(p, x, setup["jcfg"]))(jp, x)
    got = getattr(xlstm, f"{kind}_block_apply")(p, _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **MOD_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_block_decode_steps_and_cache_leaves(setup, kind):
    """Six decode steps from a drawn (non-zero) state: each step's output
    and every leaf of the new cache against the reference's tuple."""
    jp, p = _block(setup, kind)
    cfg = setup["cfg"]
    zero = getattr(xlstm, f"{kind}_init_cache")(cfg, B, "cpu")
    rng = np.random.default_rng(12)
    state = {k: (rng.normal(size=v.shape) * (0.5 if k != "m" else 1.0))
             .astype(np.float32) for k, v in zero.items()}
    if kind == "slstm":
        state["n"] = np.abs(state["n"]) + 0.5
    jstate = tuple(jnp.asarray(state[k]) for k in LEAVES[kind])
    cache = {k: _t(v) for k, v in state.items()}
    jdec = jax.jit(lambda p, x, c: getattr(jxlstm, f"{kind}_block_decode")(
        p, x, setup["jcfg"], c))
    for t in range(6):
        x = _normal((B, 1, cfg.d_model), 20 + t)
        want, jstate = jdec(jp, x, jstate)
        got, cache = getattr(xlstm, f"{kind}_block_decode")(p, _t(x), cache)
        np.testing.assert_allclose(got.numpy(), _np(want), **MODEL_TOL)
        for name, leaf in zip(LEAVES[kind], jstate):
            np.testing.assert_allclose(cache[name].numpy(), _np(leaf),
                                       **MODEL_TOL, err_msg=f"{name} {t}")


# -- the model ----------------------------------------------------------------------

def test_logits_match_reference(setup):
    tokens = _tokens(setup["cfg"], B, S, 3)
    want = _japply(setup["jmodel"])(setup["jparams"], jnp.asarray(tokens))
    got = setup["model"].apply(_t(tokens).long())
    np.testing.assert_allclose(got.numpy(), _np(want), **MODEL_TOL)


def test_decode_from_reference_cache(setup):
    """The reference decodes 5 tokens; its cache (tuples) reaches the port
    through ``convert.cache_from_numpy``; both decode the next 5, every
    step's logits held."""
    jmodel, model = setup["jmodel"], setup["model"]
    tokens = _tokens(setup["cfg"], B, 10, 4)
    jdec = _jdecode(jmodel)
    jcache = jmodel.init_cache(B, 10)
    for i in range(5):
        _, jcache = jdec(setup["jparams"], jnp.asarray(tokens[:, i:i + 1]),
                         jcache, jnp.asarray(i, jnp.int32))
    cache = convert.cache_from_numpy(jax.tree.map(np.asarray, jcache), model)
    assert set(cache["stage_0"]["1"]) == set(LEAVES["slstm"])
    for i in range(5, 10):
        want, jcache = jdec(setup["jparams"], jnp.asarray(tokens[:, i:i + 1]),
                            jcache, jnp.asarray(i, jnp.int32))
        with torch.no_grad():
            got, cache = model.decode_step(_t(tokens[:, i:i + 1]).long(),
                                           cache, i)
        np.testing.assert_allclose(got.numpy(), _np(want), **MODEL_TOL)


def test_prefill_matches_token_by_token_decode(setup):
    model = setup["model"]
    tokens = _t(_tokens(setup["cfg"], B, 12, 6)).long()
    with torch.no_grad():
        full = model.apply(tokens)
    cache = model.init_cache(B, 12)
    fed, _ = serve.prefill_into_cache(model, tokens, cache)
    np.testing.assert_allclose(fed[:, 0].numpy(), full[:, -1].numpy(),
                               **MODEL_TOL)


def test_prefill_and_serve_steps_match_reference(setup):
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    tokens = _tokens(cfg, B, 12, 7)
    jprefill, _ = jsteps.make_prefill_step(jcfg)
    want = jax.jit(jprefill)(setup["jparams"], {"tokens": jnp.asarray(tokens)})
    prefill, _ = steps.make_prefill_step(cfg, model=setup["model"])
    got = prefill({"tokens": _t(tokens).long()})
    np.testing.assert_allclose(got.numpy(), _np(want), **MODEL_TOL)

    jserve, jmodel = jsteps.make_serve_step(jcfg)
    jserve = jax.jit(jserve)
    serve_step, model = steps.make_serve_step(cfg, model=setup["model"])
    jcache, cache = jmodel.init_cache(B, 16), model.init_cache(B, 16)
    tok = jtok = tokens[:, :1]
    for i in range(8):
        jtok, jcache = jserve(setup["jparams"], jnp.asarray(jtok), jcache,
                              jnp.asarray(i, jnp.int32))
        tok, cache = serve_step(_t(tok).long() if i == 0 else tok, cache, i)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_serve_cli_runs_on_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "4", "--tokens", "4",
                       "--cache-len", "16"]) == 0
    assert "arch=xlstm-125m-reduced device=cpu" in capsys.readouterr().out

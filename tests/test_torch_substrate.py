"""The port's substrate (recurrentgemma serving) held to the JAX reference on
the CPU.

Weights come from the reference's ``Transformer.init`` and reach the port
through ``convert.params_from_numpy``; token and activation inputs are made
with numpy from a seed.  On the CPU the port's flash-attention and
linear-recurrence wrappers run their plain versions, so these tests hold
the model code around the kernels; ``test_torch_seq_kernels.py`` holds the
plain versions to the Pallas kernels, and ``chip_smoke.py`` the CUDA
kernels to the plain versions on the card.

Tolerances, all float32: modules atol 1e-5 / rtol 1e-5 (the same
arithmetic, summed in another order); whole-model logits and decode
steps atol 2e-4 / rtol 1e-3, the reference's own decode-parity tolerance
(``tests/test_decode_parity.py``).
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
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro.models.transformer import Transformer as JTransformer
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import seq_ops
from repro_torch.launch import serve, steps
from repro_torch.models import attention, layers, rglru
from _torch_threads import one_torch_thread  # noqa: F401

MOD_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=2e-4, rtol=1e-3)


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _setup(cfg_port, cfg_ref, seed=0):
    jmodel = JTransformer(cfg_ref)
    jparams = jax.jit(jmodel.init)(jax.random.key(seed))
    model = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg_port, device="cpu")
    return jmodel, jparams, model


@pytest.fixture(scope="module")
def reduced():
    return _setup(get_config("recurrentgemma-9b").reduced(),
                  jget_config("recurrentgemma-9b").reduced())


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("reduce", [False, True])
def test_config_matches_reference(reduce):
    port = get_config("recurrentgemma-9b")
    ref = jget_config("recurrentgemma-9b")
    if reduce:
        port, ref = port.reduced(), ref.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.compute_dtype == (torch.float32 if reduce else torch.bfloat16)
    assert port.param_dtype == torch.float32


def test_unknown_arch_raises():
    """Every architecture of the reference is ported; a name outside the
    registry raises, as the reference's ``get_config`` does."""
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("xlstm-7b")


# -- layers --------------------------------------------------------------------

def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3.0
    scale = rng.normal(size=(64,)).astype(np.float32)
    got = layers.rmsnorm_apply(_t(scale), _t(x)).numpy()
    want = jlayers.rmsnorm_apply({"scale": jnp.asarray(scale)},
                                 jnp.asarray(x))
    np.testing.assert_allclose(got, _np(want), **MOD_TOL)


def test_apply_rope_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 40, 3, 32)).astype(np.float32)
    pos = np.arange(7, 47)
    got = layers.apply_rope(_t(x), _t(pos), 10_000.0).numpy()
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    np.testing.assert_allclose(got, _np(want), **MOD_TOL)


@pytest.mark.parametrize("activation", ["gelu", "silu"])
def test_mlp_apply_matches_reference(activation):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 32)).astype(np.float32)
    w = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_in", (32, 48)), ("w_gate", (32, 48)),
                      ("w_out", (48, 32)))}
    got = layers.mlp_apply(_t(w["w_in"]), _t(w["w_gate"]), _t(w["w_out"]),
                           _t(x), activation=activation).numpy()
    want = jlayers.mlp_apply({k: jnp.asarray(v) for k, v in w.items()},
                             jnp.asarray(x), activation=activation)
    np.testing.assert_allclose(got, _np(want), **MOD_TOL)


# -- mixers --------------------------------------------------------------------

def _block_params(jparams, kind_pos):
    return jax.tree.map(lambda l: l[0], jparams["stage_0"][kind_pos])


def test_attention_apply_sliding_matches_reference(reduced):
    jmodel, jparams, model = reduced
    cfg = model.cfg
    s = 48
    assert s > cfg.window
    x = np.random.default_rng(4).normal(size=(2, s, cfg.d_model)) \
        .astype(np.float32)
    got = attention.attention_apply(model.blocks[2].attn, _t(x), cfg,
                                    mask_kind="sliding").numpy()
    want = jattention.attention_apply(_block_params(jparams, "2")["attn"],
                                      jnp.asarray(x), jmodel.cfg,
                                      mask_kind="sliding")
    np.testing.assert_allclose(got, _np(want), **MOD_TOL)
    assert seq_ops.LAUNCHES["flash_attention"] == 0     # CPU: plain version


@pytest.mark.parametrize("entry", ["apply", "init_cache", "decode"])
def test_unknown_mask_kind_raises(reduced, entry):
    """A mask kind the reference's ``mask_logits`` does not know raises
    ``ValueError`` there and in each attention entry point of the port."""
    _, _, model = reduced
    cfg, attn = model.cfg, model.blocks[2].attn
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(ValueError, match="unknown mask kind"):
        jattention.mask_logits(jnp.zeros((4, 4)), jnp.arange(4),
                               jnp.arange(4), "bidirectional")
    with pytest.raises(ValueError, match="unknown mask kind"):
        if entry == "apply":
            attention.attention_apply(attn, x, cfg, mask_kind="bidirectional")
        elif entry == "init_cache":
            attention.init_cache(cfg, 1, 8, "bidirectional", "cpu")
        else:
            cache = attention.init_cache(cfg, 1, 8, "global", "cpu")
            attention.attention_decode(attn, x[:, :1], cfg, cache, 0,
                                       mask_kind="bidirectional")


def test_rglru_block_apply_matches_reference(reduced):
    jmodel, jparams, model = reduced
    x = np.random.default_rng(5).normal(size=(2, 40, model.cfg.d_model)) \
        .astype(np.float32)
    got = rglru.rglru_block_apply(model.blocks[0].rec, _t(x)).numpy()
    want = jax.jit(jrglru.rglru_block_apply, static_argnums=2)(
        _block_params(jparams, "0")["rec"], jnp.asarray(x), jmodel.cfg)
    np.testing.assert_allclose(got, _np(want), **MOD_TOL)
    assert seq_ops.LAUNCHES["linear_recurrence"] == 0


# -- the model and the serving steps --------------------------------------------

def test_transformer_apply_matches_reference(reduced):
    jmodel, jparams, model = reduced
    toks = _tokens(model.cfg, 2, 64, 6)
    got = model.apply(_t(toks)).numpy()
    want, _ = jmodel.apply(jparams, jnp.asarray(toks))
    assert got.shape == (2, 64, model.cfg.vocab_size)
    np.testing.assert_allclose(got, _np(want), **MODEL_TOL)


def test_decode_step_ring_wraps_matches_reference():
    """24 decode steps with a window of 8 (the ring wraps twice) against
    the reference's decode_step, step by step."""
    cfg_p = get_config("recurrentgemma-9b").reduced().replace(window=8)
    cfg_r = jget_config("recurrentgemma-9b").reduced().replace(window=8)
    jmodel, jparams, model = _setup(cfg_p, cfg_r, seed=1)
    toks = _tokens(cfg_p, 2, 24, 7)
    cache = model.init_cache(2, 24)
    jcache = jmodel.init_cache(2, 24)
    assert cache["stage_0"]["2"]["k"].shape == (1, 2, 8, 1, cfg_p.d_head)
    jdec = jax.jit(jmodel.decode_step)
    for i in range(24):
        got, cache = model.decode_step(_t(toks[:, i:i + 1]), cache, i)
        want, jcache = jdec(jparams, jnp.asarray(toks[:, i:i + 1]), jcache,
                            jnp.asarray(i, jnp.int32))
        np.testing.assert_allclose(got.numpy(), _np(want), err_msg=f"step {i}",
                                   **MODEL_TOL)
    for key in ("h", "conv"):
        np.testing.assert_allclose(cache["stage_0"]["0"][key].numpy(),
                                   _np(jcache["stage_0"]["0"][key]),
                                   **MODEL_TOL)


def test_prefill_and_serve_steps_match_reference(reduced):
    jmodel, jparams, model = reduced
    cfg = model.cfg
    toks = _tokens(cfg, 2, 40, 8)
    prefill, _ = steps.make_prefill_step(cfg, model=model)
    jprefill, _ = jsteps.make_prefill_step(jmodel.cfg)
    got = prefill({"tokens": _t(toks)}).numpy()
    want = jprefill(jparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(got, _np(want), **MODEL_TOL)

    serve_step, _ = steps.make_serve_step(cfg, model=model)
    jserve, _ = jsteps.make_serve_step(jmodel.cfg)
    jserve = jax.jit(jserve)
    cache, jcache = model.init_cache(2, 32), jmodel.init_cache(2, 32)
    _, cache = serve.prefill_into_cache(model, _t(toks[:, :8]), cache)
    jdec = jax.jit(jmodel.decode_step)
    for i in range(8):
        _, jcache = jdec(jparams, jnp.asarray(toks[:, i:i + 1]), jcache,
                         jnp.asarray(i, jnp.int32))
    tok, jtok = _t(toks[:, 7:8]), jnp.asarray(toks[:, 7:8])
    for i in range(8, 20):
        tok, cache = serve_step(tok, cache, i)
        jtok, jcache = jserve(jparams, jtok, jcache, jnp.asarray(i, jnp.int32))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok),
                                      err_msg=f"step {i}")
        assert tok.dtype == torch.int32


def test_prefill_matches_token_by_token_decode(reduced):
    """The kernel path (flash + scan) and the decode path agree."""
    _, _, model = reduced
    toks = _t(_tokens(model.cfg, 2, 40, 9))
    prefill, _ = steps.make_prefill_step(model.cfg, model=model)
    logits, _ = serve.prefill_into_cache(model, toks,
                                         model.init_cache(2, 40))
    np.testing.assert_allclose(prefill({"tokens": toks}).numpy(),
                               logits[:, 0].numpy(), **MODEL_TOL)


def test_serve_cli_on_cpu(capsys):
    assert serve.main(["--arch", "recurrentgemma-9b", "--device", "cpu",
                       "--batch", "2", "--tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "recurrentgemma-9b-reduced" in out and "device=cpu" in out

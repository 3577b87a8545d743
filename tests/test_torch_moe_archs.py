"""The port's mixture-of-experts decoders (grok-1-314b: top-2 on every
layer; llama4-maverick: top-1 on every other layer, chunked attention and
NoPE global layers) held to the JAX reference on the CPU.

Each runs in two reduced forms: ``reduced()`` (4 heads, 4 KV heads: MHA;
4 experts) and ``reduced().replace(n_kv_heads=2)``.  Weights come from the
reference's ``Transformer.init`` (the norm scales, ones at init, redrawn
from numpy, and the untied output table too) and reach the port through
``convert.params_from_numpy``; tokens and activations are numpy draws.

Routing is held exactly: each (token, choice)'s expert, its slot in the
expert's buffer, which pairs are kept and the (G, g, E, C) dispatch mask,
at the published capacity factor (1.25) and at 0.3, where pairs drop.  The
reference's slot arithmetic is not a function of its own, so the test
recomputes it with the reference's lines (``models/moe.py:74-87``) from the
reference's ``router_probs``.

Tolerances, float32, those of ``test_torch_substrate.py``: modules (the MoE
output, the aux) atol 1e-5 / rtol 1e-5; logits, the aux sum and decode
steps atol 2e-4 / rtol 1e-3; greedy tokens exact.
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
from repro.models import moe as jmoe
from repro.models.transformer import Transformer as JTransformer
from repro_torch import convert
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import seq_ops
from repro_torch.launch import serve, steps
from repro_torch.models import moe
from repro_torch.models.transformer import Transformer
from _torch_threads import one_torch_thread  # noqa: F401

MOD_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=2e-4, rtol=1e-3)

ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b")
FORMS = ("reduced", "gqa")
SETUPS = [(a, f) for a in ARCHS for f in FORMS]


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _form(cfg, form):
    cfg = cfg.reduced()
    return cfg.replace(n_kv_heads=2) if form == "gqa" else cfg


def _perturb(tree, rng):
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            out[key] = _perturb(leaf, rng)
            continue
        leaf = np.asarray(leaf)
        if key == "scale":
            leaf = 1.0 + 0.2 * rng.normal(size=leaf.shape)
        elif key == "unembedding":
            leaf = 0.02 * rng.normal(size=leaf.shape)
        out[key] = leaf.astype(np.float32)
    return out


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)) \
        .astype(np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _moe_pos(arch):
    """The unit position of the first MoE layer."""
    return str(get_config(arch).ffn_pattern.index("moe"))


@pytest.fixture(scope="module", params=SETUPS,
                ids=[f"{a}-{f}" for a, f in SETUPS])
def setup(request):
    arch, form = request.param
    cfg = _form(get_config(arch), form)
    jmodel = JTransformer(_form(jget_config(arch), form))
    params = _perturb(jax.tree.map(np.asarray, jmodel.init(jax.random.key(4))),
                      np.random.default_rng(SETUPS.index(request.param)))
    return dict(arch=arch, cfg=cfg, jmodel=jmodel, params=params,
                jparams=jax.tree.map(jnp.asarray, params),
                model=convert.params_from_numpy(params, cfg, device="cpu"))


# -- configs ---------------------------------------------------------------------

@pytest.mark.parametrize("form", ("full",) + FORMS)
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, form):
    port, ref = get_config(arch), jget_config(arch)
    if form != "full":
        port, ref = _form(port, form), _form(ref, form)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert arch in list_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_transformer_builds_from_a_generator(arch):
    """The router stays float32 under bf16 parameters; llama4's unit
    alternates dense and MoE FFNs."""
    cfg = get_config(arch).reduced().replace(param_dtype_str="bfloat16")
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    kinds = [blk.ffn_kind for blk in model.blocks]
    assert kinds == list(cfg.ffn_pattern) * (cfg.n_layers
                                             // len(cfg.ffn_pattern))
    blk = model.blocks[int(_moe_pos(arch))]
    assert blk.moe.router.dtype == torch.float32
    assert blk.moe.w_in.dtype == torch.bfloat16
    assert blk.moe.w_out.shape == (cfg.moe_experts, cfg.moe_d_ff,
                                   cfg.d_model)
    assert not hasattr(blk, "mlp")
    logits = model.apply(torch.zeros((1, 8), dtype=torch.int64))
    assert bool(torch.isfinite(logits).all())


def test_sliced_draw_keeps_the_distribution(monkeypatch):
    """A bf16 leaf above ``DRAW_SLICE`` elements is drawn in slices along
    its leading axis: its scale and mean are those of a whole draw."""
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "DRAW_SLICE", 1000)
    gen = torch.Generator().manual_seed(0)
    w = layers.normal_init((7, 64, 50), gen, torch.bfloat16, stddev=0.5)
    assert w.dtype == torch.bfloat16 and w.shape == (7, 64, 50)
    assert abs(float(w.float().std()) - 0.5) < 0.02
    assert abs(float(w.float().mean())) < 0.02
    assert not torch.equal(w[0], w[1])                  # no repeated slice


# -- routing and the MoE FFN ---------------------------------------------------------

def _ref_routing(jparams, x, cfg):
    """The reference's routing of x (B, S, d): its ``router_probs`` and
    ``_capacity``, then its slot arithmetic (``models/moe.py:74-87``)."""
    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    g = min(jmoe.MOE_GROUP, b * s)
    cap = jmoe._capacity(g, e, k, cfg.moe_capacity_factor)
    gate, idx, aux = jmoe.router_probs(jparams, jnp.asarray(x).reshape(-1, g, d),
                                       k)
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.int32)
    flat = onehot.reshape(-1, g * k, e)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape)
                  * onehot, axis=-1)
    keep = pos < cap
    gate = gate * keep.astype(gate.dtype)
    pos_oh = jax.nn.one_hot(jnp.where(keep, pos, cap), cap, dtype=gate.dtype)
    combine = jnp.einsum("gsk,gske,gskc->gsec", gate,
                         onehot.astype(gate.dtype), pos_oh)
    return dict(gate=gate, idx=idx, pos=pos, keep=keep, cap=cap, aux=aux,
                dispatch=np.asarray(combine > 0.0))


def _port_dispatch(r, e):
    """The port's routing as the reference's (G, g, E, C) dispatch mask."""
    n_groups, g, k = r.idx.shape
    out = torch.zeros((n_groups, g, e, r.capacity), dtype=torch.bool)
    gi, ti, ki = torch.nonzero(r.keep & (r.gate > 0), as_tuple=True)
    out[gi, ti, r.idx[gi, ti, ki], r.pos[gi, ti, ki]] = True
    return out.numpy()


@pytest.mark.parametrize("factor", [1.25, 0.3])
def test_routing_and_moe_apply_match_reference(setup, factor):
    """The first MoE layer's routing exact and its output within 1e-5, on
    2 × 40 activations; at 0.3 pairs drop."""
    cfg = setup["cfg"].replace(moe_capacity_factor=factor)
    pos_key = _moe_pos(setup["arch"])
    jp = jax.tree.map(lambda l: l[0],
                      setup["jparams"]["stage_0"][pos_key]["moe"])
    layer = setup["model"].blocks[int(pos_key)].moe
    x = _normal((2, 40, cfg.d_model), 5)
    want = _ref_routing(jp, x, cfg)
    got = moe.route(layer.router, _t(x), cfg)
    assert got.capacity == want["cap"]
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want["idx"]))
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want["pos"]))
    np.testing.assert_array_equal(got.keep.numpy(), np.asarray(want["keep"]))
    np.testing.assert_array_equal(_port_dispatch(got, cfg.moe_experts),
                                  want["dispatch"])
    np.testing.assert_allclose(got.gate.numpy(), _np(want["gate"]), **MOD_TOL)
    np.testing.assert_allclose(float(got.aux), float(want["aux"]), **MOD_TOL)
    dropped = int((~got.keep).sum())
    assert (dropped > 0) == (factor < 1.0)
    y, aux = moe.moe_apply(layer, _t(x), cfg)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), cfg)
    np.testing.assert_allclose(y.numpy(), _np(jy), **MOD_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **MOD_TOL)


def test_moe_rejects_tokens_the_group_does_not_divide(setup):
    cfg = setup["cfg"]
    layer = setup["model"].blocks[int(_moe_pos(setup["arch"]))].moe
    x = torch.zeros((1, moe.MOE_GROUP + 2, cfg.d_model))
    with pytest.raises(ValueError, match="routing group"):
        moe.moe_apply(layer, x, cfg)


# -- chunked attention -----------------------------------------------------------

@pytest.mark.parametrize("s,chunk,kv", [(40, 8, 2), (40, 32, 4), (33, 10, 1),
                                        (40, 64, 2)])
def test_attention_plain_chunked_matches_reference_sdpa(s, chunk, kv):
    """The flash wrapper's plain version under the chunked mask against the
    reference's ``_sdpa(..., "chunked")``, a chunk of S or more included
    (equal to causal)."""
    q = _normal((2, s, 4, 32), s + chunk)
    k, v = _normal((2, s, kv, 32), 1), _normal((2, s, kv, 32), 2)
    got = seq_ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                  chunk=chunk).numpy()
    pos = jnp.arange(s)
    want = jattention._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            pos, pos, "chunked", chunk=chunk)
    np.testing.assert_allclose(got, _np(want), **MOD_TOL)
    assert seq_ops.LAUNCHES["flash_attention"] == 0
    if chunk >= s:
        np.testing.assert_array_equal(
            got, seq_ops.flash_attention(_t(q), _t(k), _t(v)).numpy())


def test_chunked_decode_ring_matches_reference():
    """llama4 reduced to a chunk of 8 (the ring holds one chunk): 24
    decode steps, three chunks, step by step against the reference's
    ``decode_step`` at its no-drop factor, the rings after them too."""
    arch = "llama4-maverick-400b-a17b"
    over = dict(attn_chunk=8, moe_capacity_factor=8.0, n_kv_heads=2)
    cfg = get_config(arch).reduced().replace(**over)
    jmodel = JTransformer(jget_config(arch).reduced().replace(**over))
    params = _perturb(jax.tree.map(np.asarray, jmodel.init(jax.random.key(6))),
                      np.random.default_rng(13))
    jparams = jax.tree.map(jnp.asarray, params)
    model = convert.params_from_numpy(params, cfg, device="cpu")
    toks = _tokens(cfg, 2, 24, 7)
    cache, jcache = model.init_cache(2, 24), jmodel.init_cache(2, 24)
    assert cache["stage_0"]["0"]["k"].shape == (1, 2, 8, 2, cfg.d_head)
    assert cache["stage_0"]["3"]["k"].shape == (1, 2, 24, 2, cfg.d_head)
    jdec = jax.jit(jmodel.decode_step)
    got_steps = []
    for i in range(24):
        got, cache = model.decode_step(_t(toks[:, i:i + 1]), cache, i)
        want, jcache = jdec(jparams, jnp.asarray(toks[:, i:i + 1]), jcache,
                            jnp.asarray(i, jnp.int32))
        np.testing.assert_allclose(got.numpy(), _np(want),
                                   err_msg=f"step {i}", **MODEL_TOL)
        got_steps.append(got[:, 0])
    for pos in ("0", "3"):
        np.testing.assert_allclose(cache["stage_0"][pos]["k"].numpy(),
                                   _np(jcache["stage_0"][pos]["k"]),
                                   **MODEL_TOL)
    # the full forward (the kernel path) computes the same logits
    np.testing.assert_allclose(torch.stack(got_steps, 1).numpy(),
                               model.apply(_t(toks)).numpy(), **MODEL_TOL)


# -- the model ---------------------------------------------------------------------

def test_transformer_apply_and_prefill_match_reference(setup):
    """Logits and the aux sum over 2 × 40 tokens (llama4's chunk of 32
    cut), and the prefill step's last logits."""
    cfg, model, jmodel = setup["cfg"], setup["model"], setup["jmodel"]
    toks = _tokens(cfg, 2, 40, 8)
    jprefill, _ = jsteps.make_prefill_step(jmodel.cfg)
    (want, want_aux), want_last = jax.jit(lambda p, t: (
        jmodel.apply(p, t), jprefill(p, {"tokens": t})))(
        setup["jparams"], jnp.asarray(toks))
    got, aux = model.apply(_t(toks), with_aux=True)
    assert got.shape == (2, 40, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), _np(want), **MODEL_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **MODEL_TOL)
    assert float(aux) > 0.0
    prefill, _ = steps.make_prefill_step(cfg, model=model)
    np.testing.assert_allclose(prefill({"tokens": _t(toks)}).numpy(),
                               _np(want_last), **MODEL_TOL)


def test_prefill_matches_decode_at_the_no_drop_factor(setup):
    """At the reference's raised factor (8.0, ``test_decode_parity.py``)
    nothing drops, so every position's logits from one forward (the kernel
    path) equal a token-by-token decode's; at the published factor the
    forward drops pairs and the two differ."""
    model = setup["model"]
    cfg = model.cfg
    toks = _t(_tokens(cfg, 2, 40, 9))
    cache = model.init_cache(2, 40)
    decoded = torch.cat([model.decode_step(toks[:, i:i + 1], cache, i)[0]
                         for i in range(40)], 1)
    model.cfg = cfg.replace(moe_capacity_factor=8.0)
    try:
        full = model.apply(toks)
    finally:
        model.cfg = cfg
    np.testing.assert_allclose(full.numpy(), decoded.numpy(), **MODEL_TOL)
    assert not np.allclose(model.apply(toks).numpy(), decoded.numpy(),
                           **MODEL_TOL)


def test_serve_step_matches_reference(setup):
    """A prompt of 6 fed through the serve step, then 8 greedy tokens,
    exact against the reference's ``make_serve_step``."""
    cfg, model, jmodel = setup["cfg"], setup["model"], setup["jmodel"]
    toks = _tokens(cfg, 2, 6, 10)
    serve_step, _ = steps.make_serve_step(cfg, model=model)
    jserve = jax.jit(jsteps.make_serve_step(jmodel.cfg)[0])
    cache, jcache = model.init_cache(2, 16), jmodel.init_cache(2, 16)
    for i in range(6):
        _, cache = serve_step(_t(toks[:, i:i + 1]), cache, i)
        _, jcache = jserve(setup["jparams"], jnp.asarray(toks[:, i:i + 1]),
                           jcache, jnp.asarray(i, jnp.int32))
    tok, jtok = _t(toks[:, 5:6]), jnp.asarray(toks[:, 5:6])
    for i in range(6, 14):
        tok, cache = serve_step(tok, cache, i)
        jtok, jcache = jserve(setup["jparams"], jtok, jcache,
                              jnp.asarray(i, jnp.int32))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok),
                                      err_msg=f"step {i}")


def test_convert_carries_every_moe_leaf(setup):
    model, params, cfg = setup["model"], setup["params"], setup["cfg"]
    pos_key = _moe_pos(setup["arch"])
    tree = params["stage_0"][pos_key]
    i = len(model.blocks) - len(cfg.ffn_pattern) + int(pos_key)
    r = model.block_index[i][1]
    blk = model.blocks[i]
    for leaf in ("router", "w_gate", "w_in", "w_out"):
        np.testing.assert_array_equal(getattr(blk.moe, leaf).numpy(),
                                      tree["moe"][leaf][r], err_msg=leaf)
    np.testing.assert_array_equal(model.unembedding.numpy(),
                                  params["embed"]["unembedding"])
    missing = dict(params, stage_0=dict(params["stage_0"], **{
        pos_key: {k: v for k, v in tree.items() if k != "moe"}}))
    with pytest.raises(KeyError, match="moe"):
        convert.params_from_numpy(missing, cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                       "--tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert f"{arch}-reduced" in out and "device=cpu" in out

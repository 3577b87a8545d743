"""Per-unit rematerialisation (``cfg.remat``) in the port's substrate, on
the CPU.

With ``remat`` and a gradient recorded, each unit of the decoder stack
(one repetition of a stage's pattern) and each whisper encoder and
decoder layer runs through a non-reentrant ``torch.utils.checkpoint``
(``transformer.run_unit``).  The recompute runs the same operations on
the same inputs, so on the CPU the loss and every gradient leaf are
bit-equal to the un-remat'd model's, for each mixer kind of
``test_torch_train.py`` (and recurrentgemma over two stages).  The
attention and encoder-decoder kinds are held against ``jax.grad`` of the
reference built with ``remat=True`` at ``test_torch_train.py``'s bounds
(loss rtol 1e-5; a leaf max|Δ| ≤ 1e-4·max|g_ref| + 1e-6).

The kernels' forwards (``seq_ops._flash_forward``, ``_linrec_forward``:
where the card launches) are counted: a train step runs each forward of
a unit twice (forward and recompute), so an attention layer makes 2
flash launches and a ``rec`` layer 3 recurrence launches (forward,
recompute, adjoint) -- the counts ``chip_smoke.py``'s ``[train]`` holds
on the card.  Serving does not change: a no-grad prefill, or a forward
of frozen weights, makes the same calls with ``remat`` on as off and no
checkpoint.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild_model
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import seq_ops
from repro_torch.launch import steps
from repro_torch.models import build_model, transformer
from _torch_threads import one_torch_thread  # noqa: F401

B, S = 2, 16
LOSS_RTOL = 1e-5
LEAF_REL, LEAF_ABS = 1e-4, 1e-6
# test_torch_train.py's kinds, and recurrentgemma over a (rec, rec, swa)
# unit and a (rec, rec) remainder stage
KINDS = {"attention": ("stablelm-1.6b", None),
         "rec": ("recurrentgemma-9b", None),
         "xlstm": ("xlstm-125m", None), "moe": ("grok-1-314b", None),
         "prefix-lm": ("paligemma-3b", None),
         "encdec": ("whisper-large-v3", None),
         "rec-two-stages": ("recurrentgemma-9b", 5)}


def _cfg(kind, remat=True):
    arch, layers = KINDS[kind]
    cfg = get_config(arch).reduced().replace(remat=remat)
    return cfg if layers is None else cfg.replace(n_layers=layers)


def _batch(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    n = cfg.prefix_tokens or cfg.stub_frames
    if n:
        batch["embeddings"] = rng.normal(size=(b, n, cfg.d_model)) \
            .astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _models(kind):
    """The same weights (drawn, then every leaf moved by 0.05·N(0, 1) so
    constant leaves carry a gradient) with ``remat`` on and off."""
    on = _cfg(kind)
    gen = torch.Generator().manual_seed(3)
    model_on = build_model(on, device="cpu", generator=gen)
    with torch.no_grad():
        for p in model_on.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    model_off = build_model(on.replace(remat=False), device="cpu")
    model_off.load_state_dict(model_on.state_dict())
    return model_on, model_off


def _units(cfg):
    """Checkpointed spans a forward: the decoder's units, or whisper's
    encoder and decoder layers."""
    if cfg.encoder_layers:
        return cfg.encoder_layers + cfg.n_layers
    return sum(reps for _, reps in transformer.compute_stages(
        cfg.n_layers, tuple(zip(cfg.block_pattern, cfg.ffn_pattern))))


def _want_launches(cfg, remat):
    """Kernel forwards a train step: a flash forward an attention layer
    (whisper: one an encoder layer, two a decoder layer), a recurrence
    forward and its adjoint a ``rec`` layer; ``remat`` adds the
    recompute's forwards."""
    kinds = [cfg.block_pattern[i % len(cfg.block_pattern)]
             for i in range(cfg.n_layers)]
    flash = cfg.encoder_layers + 2 * cfg.n_layers if cfg.encoder_layers \
        else sum(k in transformer.ATTENTION_KINDS for k in kinds)
    rec = kinds.count("rec")
    return {"flash": flash * (2 if remat else 1),
            "linrec": rec * (3 if remat else 2)}


@pytest.fixture
def calls(monkeypatch):
    """Counts of the kernels' forwards and of checkpointed spans."""
    seen = {"flash": 0, "linrec": 0, "checkpoint": 0}

    def counting(key, fn):
        def call(*a, **kw):
            seen[key] += 1
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(seq_ops, "_flash_forward",
                        counting("flash", seq_ops._flash_forward))
    monkeypatch.setattr(seq_ops, "_linrec_forward",
                        counting("linrec", seq_ops._linrec_forward))
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        counting("checkpoint",
                                 torch.utils.checkpoint.checkpoint))
    return seen


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_remat_loss_and_every_gradient_bit_equal(kind, calls):
    model_on, model_off = _models(kind)
    cfg = model_on.cfg
    batch = _batch(cfg, 4)
    loss_off, g_off = steps.loss_and_grads(model_off, batch)
    assert calls == {**_want_launches(cfg, False), "checkpoint": 0}
    for key in calls:
        calls[key] = 0
    loss_on, g_on = steps.loss_and_grads(model_on, batch)
    assert calls == {**_want_launches(cfg, True),
                     "checkpoint": _units(cfg)}
    assert torch.equal(loss_on, loss_off)
    assert list(g_on) == list(g_off)
    for name, g in g_on.items():
        assert g is not None, name
        assert torch.equal(g, g_off[name]), name


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(reference weights as numpy, batch, loss, gradients) of the
    reference built with ``remat=True``."""
    jcfg = jget_config(arch).reduced().replace(remat=True)
    jmodel = jbuild_model(jcfg)
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        jax.jit(jmodel.init)(jax.random.key(2)))
    batch = {k: v.numpy() for k, v in _batch(get_config(arch).reduced(),
                                             3).items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jsteps.model_loss(jmodel, p, b)))(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return params, batch, float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("kind", ["attention", "encdec"])
def test_remat_matches_jax_grad_of_the_remat_reference(kind, calls):
    arch = KINDS[kind][0]
    params, batch, want_loss, want = _reference(arch)
    cfg = _cfg(kind)
    model = convert.params_from_numpy(params, cfg, device="cpu")
    assert model.cfg.remat
    loss, grads = steps.loss_and_grads(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert calls["checkpoint"] == _units(cfg)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    got = convert.params_to_numpy(model, grads)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    for (path, w), g in zip(flat, jax.tree.leaves(got)):
        bound = LEAF_REL * np.abs(w).max() + LEAF_ABS
        err = np.abs(g - w).max()
        assert err <= bound, (jax.tree_util.keystr(path), err, bound)


@pytest.mark.parametrize("kind", ["attention", "rec", "encdec"])
def test_serving_under_remat_makes_the_same_calls(kind, calls):
    """A no-grad prefill step, and a forward with grad on of frozen
    weights, make the same kernel calls with ``remat`` on as off, and no
    checkpoint; the logits are bit-equal."""
    model_on, model_off = _models(kind)
    model_on.requires_grad_(False)
    model_off.requires_grad_(False)
    batch = _batch(model_on.cfg, 5)
    seen, outs = [], []
    for model in (model_on, model_off):
        prefill, _ = steps.make_prefill_step(model.cfg, model=model)
        for key in calls:
            calls[key] = 0
        outs.append(prefill(batch))
        frozen = model.apply(batch["tokens"], batch.get("embeddings"))
        assert frozen.grad_fn is None
        seen.append(dict(calls))
    assert model_on.cfg.remat and not model_off.cfg.remat
    assert seen[0] == seen[1]
    assert seen[0]["checkpoint"] == 0
    assert seen[0]["flash"] > 0
    assert torch.equal(outs[0], outs[1])


def test_remat_active_needs_the_flag_grad_mode_and_a_trainable_weight():
    model_on, model_off = _models("attention")
    assert not transformer.remat_active(model_on)       # built frozen
    model_on.requires_grad_(True)
    model_off.requires_grad_(True)
    assert transformer.remat_active(model_on)
    assert not transformer.remat_active(model_off)
    with torch.no_grad():
        assert not transformer.remat_active(model_on)
    assert get_config("stablelm-1.6b").remat
    assert not get_config("stablelm-1.6b").reduced().remat

"""Gradients through the port's substrate held to ``jax.grad`` of the JAX
reference on the CPU, and the two differentiable kernel wrappers' backward
held to autograd of their plain versions (the train step and the CLI are
in ``test_torch_train_step.py``).

One reduced config per mixer kind: attention (stablelm-1.6b: LayerNorm,
partial biases, an untied table), ``rec`` (recurrentgemma-9b: two RG-LRU
layers and a windowed one), mLSTM/sLSTM (xlstm-125m), MoE (grok-1-314b:
top-2 of 4 experts, the aux loss), prefix-LM (paligemma-3b: 8 patch
embeddings) and encoder-decoder (whisper-large-v3: 16 frames, the
gradient reaching the encoder through cross-attention's k/v).  Weights
are the reference's ``init`` with every leaf moved by 0.05·N(0, 1) from
numpy (so constant leaves -- norm scales, biases, gate biases -- carry a
gradient that a misplaced term would change), carried over by
``convert.params_from_numpy``; the port's gradients come back through
``convert.params_to_numpy`` in the reference's layout.  Tokens, labels
and embeddings are numpy draws; B = 2, S = 16.  The reference's
``value_and_grad(model_loss)`` is jitted once a config.

Tolerances, float32: the loss rtol 1e-5 (measured at most 2.2e-7); each
gradient leaf max|Δ| ≤ 1e-4·max|g_ref| + 1e-6 (the worst leaf of any
kind measured at 2.6% of that bound: stablelm's ``wq``, grok's
``norm1``).  The RG-LRU leaves meet the same bound although the
reference runs its scan as ``lax.associative_scan`` and the port as a
step recurrence and its adjoint (worst of them 1.6% of it).

The wrappers, float32 unless stated.  ``flash_attention``'s Function
(``_FlashAttention``): its output and dq, dk, dv bit-equal to autograd of
``attention_plain`` under every mask kind, GQA, a key length of its own
and bfloat16 (its backward is that same recompute, so this holds the
wiring: the mask passed through, the group's sum); and, under the masks
the reference's ``ops.flash_attention`` takes, against ``jax.grad`` of
its ``custom_vjp`` (the Pallas forward in interpret mode) at the
reference kernels' attention tolerance, atol = rtol = 2e-5 (measured
max|Δ| 1.4e-6).  ``linear_recurrence``'s Function (``_LinearRecurrence``:
the adjoint recurrence over reversed time, the plain step loop here for
both passes): against autograd through the step loop at rtol 1e-6
(measured 1.7e-7; ∂x exact; bfloat16 inputs exact, the gradients in
bfloat16), and against ``jax.grad`` of the reference's ``rglru_scan`` (an
associative scan, which sums in another order) at max|Δ| ≤
1e-6·max|∂_ref| (measured 1.6e-7 of it).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild_model
from repro.models.rglru import rglru_scan
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import seq_ops
from repro_torch.launch import steps
from repro_torch.models.transformer import loss_fn
from _torch_threads import one_torch_thread  # noqa: F401

B, S = 2, 16
LOSS_RTOL = 1e-5
LEAF_REL, LEAF_ABS = 1e-4, 1e-6
# one reduced config per mixer kind
KINDS = {"attention": "stablelm-1.6b", "rec": "recurrentgemma-9b",
         "xlstm": "xlstm-125m", "moe": "grok-1-314b",
         "prefix-lm": "paligemma-3b", "encdec": "whisper-large-v3"}


def _batch(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    n = cfg.prefix_tokens or cfg.stub_frames
    if n:
        batch["embeddings"] = rng.normal(size=(b, n, cfg.d_model)) \
            .astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _case(arch):
    """(port cfg, reference params as numpy, batch, reference loss, reference
    gradients as numpy)."""
    jcfg = jget_config(arch).reduced()
    jmodel = jbuild_model(jcfg)
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        jax.jit(jmodel.init)(jax.random.key(2)))
    cfg = get_config(arch).reduced()
    batch = _batch(cfg, 3)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jsteps.model_loss(jmodel, p, b)))(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return cfg, params, batch, float(loss), jax.tree.map(np.asarray, grads)


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_loss_and_every_gradient_leaf_match_jax_grad(kind):
    cfg, params, batch, want_loss, want = _case(KINDS[kind])
    model = convert.params_from_numpy(params, cfg, device="cpu")
    loss, grads = steps.loss_and_grads(model, _port_batch(batch))
    assert all(g is not None for g in grads.values()), \
        [k for k, g in grads.items() if g is None]
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    got = convert.params_to_numpy(model, grads)
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    got_leaves = jax.tree.leaves(got)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for (path, w), g in zip(flat, got_leaves):
        bound = LEAF_REL * np.abs(w).max() + LEAF_ABS
        err = np.abs(g - w).max()
        assert err <= bound, (jax.tree_util.keystr(path), err, bound)


def test_loss_fn_adds_the_moe_aux_as_the_reference():
    """``transformer.loss_fn`` (the aux always added) is the cross entropy
    plus ``moe_aux_weight`` · aux, and equals ``model_loss`` (the aux
    added where the config has experts) and the reference's loss on a MoE
    config."""
    from repro_torch.models import layers
    cfg, params, batch, want_loss, _ = _case(KINDS["moe"])
    model = convert.params_from_numpy(params, cfg, device="cpu")
    pb = _port_batch(batch)
    with torch.no_grad():
        full = loss_fn(model, pb)
        logits, aux = model.apply(pb["tokens"], with_aux=True)
        ce = layers.softmax_cross_entropy(logits, pb["labels"])
        assert float(aux) > 0.0
        assert float(full) == float(ce + cfg.moe_aux_weight * aux)
        assert float(full) == float(steps.model_loss(model, pb))
    np.testing.assert_allclose(float(full), want_loss, rtol=LOSS_RTOL)


def test_masked_loss_matches_reference():
    """``loss_mask``: the masked mean over at least one token."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32) * 3.0
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    for mask in (None, (rng.uniform(size=(2, 5)) < 0.5).astype(np.float32),
                 np.zeros((2, 5), np.float32)):
        got = layers.softmax_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if mask is None else torch.from_numpy(mask))
        want = jlayers.softmax_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-7)


# -- the differentiable kernel wrappers ----------------------------------------

ATTN_TOL = dict(atol=2e-5, rtol=2e-5)
SCAN_REL = 1e-6


def _normal(shape, seed, dtype=torch.float32):
    return torch.tensor(np.random.default_rng(seed).normal(size=shape)
                        .astype(np.float32)).to(dtype)


def _leaves(*tensors):
    return [t.clone().requires_grad_() for t in tensors]


def _qkvg(b, s, s_kv, h, kv, d, dtype=torch.float32):
    return (_normal((b, s, h, d), 1, dtype), _normal((b, s_kv, kv, d), 2, dtype),
            _normal((b, s_kv, kv, d), 3, dtype), _normal((b, s, h, d), 4, dtype))


@pytest.mark.parametrize("b,s,s_kv,h,kv,d,mask,dtype", [
    (1, 64, 64, 4, 2, 32, dict(causal=True), torch.float32),
    (2, 64, 64, 4, 1, 32, dict(causal=True, window=16), torch.float32),
    (1, 64, 64, 4, 2, 32, dict(causal=False, window=24), torch.float32),
    (1, 40, 40, 4, 2, 16, dict(causal=True, prefix_len=9), torch.float32),
    (1, 40, 40, 4, 2, 16, dict(causal=True, chunk=16), torch.float32),
    (2, 12, 20, 4, 2, 16, dict(causal=False), torch.float32),
    (1, 48, 48, 4, 1, 32, dict(causal=True), torch.bfloat16)],
    ids=["causal", "window", "window-full", "prefix", "chunk", "two-lengths",
         "causal-bf16"])
def test_flash_function_matches_plain_autograd(b, s, s_kv, h, kv, d, mask,
                                               dtype):
    q, k, v, g = _qkvg(b, s, s_kv, h, kv, d, dtype)
    got_in = _leaves(q, k, v)
    out = seq_ops.flash_attention(*got_in, **mask)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(out, got_in, g)
    plain_in = _leaves(q, k, v)
    want_out = seq_ops.attention_plain(*plain_in, **mask)
    want = torch.autograd.grad(want_out, plain_in, g)
    assert torch.equal(out, want_out)
    for a, w, t in zip(got, want, (q, k, v)):
        assert a.dtype == dtype and a.shape == t.shape
        assert torch.equal(a, w)
    assert seq_ops.LAUNCHES["flash_attention"] == 0     # CPU: no launch


@pytest.mark.parametrize("b,h,kv,mask", [
    (1, 4, 2, dict(causal=True)), (2, 4, 1, dict(causal=True, window=16)),
    (1, 4, 2, dict(causal=False, window=24)), (1, 4, 4, dict(causal=False))],
    ids=["causal", "window", "window-full", "full"])
def test_flash_function_gradient_matches_reference_custom_vjp(b, h, kv, mask):
    q, k, v, g = _qkvg(b, 64, 64, h, kv, 32)
    leaves = _leaves(q, k, v)
    got = torch.autograd.grad(seq_ops.flash_attention(*leaves, **mask),
                              leaves, g)
    jg = jnp.asarray(g.numpy())
    want = jax.grad(lambda *a: jnp.sum(ops.flash_attention(
        *a, block_q=32, block_k=32, interpret=True, **mask) * jg),
        argnums=(0, 1, 2))(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **ATTN_TOL)


def _recurrence(b, s, c, dtype=torch.float32):
    log_a = (-0.3 * _normal((b, s, c), 5).abs()).to(dtype)
    return log_a, _normal((b, s, c), 6, dtype), _normal((b, s, c), 7)


@pytest.mark.parametrize("b,s,c,dtype", [
    (2, 40, 13, torch.float32), (1, 70, 32, torch.float32),
    (1, 1, 8, torch.float32), (2, 33, 7, torch.bfloat16)],
    ids=["odd-c", "s70", "s1", "bf16"])
def test_linear_recurrence_adjoint_matches_plain_autograd(b, s, c, dtype):
    log_a, x, g = _recurrence(b, s, c, dtype)
    leaves = _leaves(log_a, x)
    out = seq_ops.linear_recurrence(*leaves)
    assert type(out.grad_fn).__name__ == "_LinearRecurrenceBackward"
    got = torch.autograd.grad(out, leaves, g)
    plain = _leaves(log_a, x)
    want = torch.autograd.grad(seq_ops.linear_recurrence_plain(*plain),
                               plain, g)
    for a, w in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), w.float(), rtol=1e-6, atol=0.0)
    torch.testing.assert_close(got[1], want[1], rtol=0.0, atol=0.0)
    assert seq_ops.LAUNCHES["linear_recurrence"] == 0


@pytest.mark.parametrize("b,s,c", [(2, 40, 13), (1, 70, 32)])
def test_linear_recurrence_adjoint_matches_jax_grad_of_rglru_scan(b, s, c):
    log_a, x, g = _recurrence(b, s, c)
    leaves = _leaves(log_a, x)
    got = torch.autograd.grad(seq_ops.linear_recurrence(*leaves), leaves, g)
    jg = jnp.asarray(g.numpy())
    want = jax.jit(jax.grad(lambda la, xs: jnp.sum(rglru_scan(la, xs) * jg),
                            argnums=(0, 1)))(jnp.asarray(log_a.numpy()),
                                             jnp.asarray(x.numpy()))
    for a, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(a.numpy() - w).max() <= SCAN_REL * np.abs(w).max()

"""The port's decode with a float8 (e4m3fn) KV cache held to the JAX
reference on the CPU: reduced qwen3-8b with ``kv_cache_dtype_str=
"float8_e4m3fn"``, the reference's weights (``Transformer.init``, norm
scales redrawn from a seed so the q/k norms are not the identity), 12
decode steps of seeded tokens from an empty cache of 12 slots.

Tolerances:

* against the reference's ``decode_step`` with the same fp8 cache, each
  step's logits within 2e-3 of the step's largest logit (rtol 0): fp8
  keeps 3 mantissa bits, so a K/V value the two packages compute ~1e-6
  apart in float32 can round to neighbouring fp8 values (a step of 2^-3
  relative) when it sits at a rounding boundary.  The worst step measured
  on this config is ``FP8_WORST`` of the largest logit (the compute-dtype
  cache: ~1e-6); the bound leaves ~5x room for other draws.
* against the port's own decode with the compute-dtype cache, the mean
  absolute logit gap at most 0.15 of the mean absolute logit: the
  reference's bound for the same pair (``tests/test_context_parallel.py``,
  ``test_fp8_cache_close_to_bf16``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro_torch import convert
from repro_torch.configs import get_config
from _torch_threads import one_torch_thread  # noqa: F401

FP8 = "float8_e4m3fn"
STEPS, BATCH = 12, 2
# a step's max |port - reference| over its largest |logit|
FP8_REL_BOUND = 2e-3
CLOSE_TO_COMPUTE_DTYPE = 0.15


def _perturb(tree, rng):
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            out[key] = _perturb(leaf, rng)
            continue
        leaf = np.asarray(leaf, np.float32)
        if key == "scale":
            leaf = (1.0 + 0.2 * rng.normal(size=leaf.shape)).astype(
                np.float32)
        out[key] = leaf
    return out


@pytest.fixture(scope="module")
def runs():
    """Each side's step logits (STEPS, B, V): the reference with the fp8
    cache, the port with the fp8 cache and with the compute-dtype one."""
    jcfg = jget_config("qwen3-8b").reduced().replace(kv_cache_dtype_str=FP8)
    jmodel = jbuild_model(jcfg)
    rng = np.random.default_rng(8)
    params = _perturb(jax.tree.map(np.asarray,
                                   jmodel.init(jax.random.PRNGKey(8))), rng)
    toks = rng.integers(0, jcfg.vocab_size, (BATCH, STEPS)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, params)
    dec = jax.jit(jmodel.decode_step)
    cache = jmodel.init_cache(BATCH, STEPS)
    ref = []
    for i in range(STEPS):
        lg, cache = dec(jparams, jnp.asarray(toks[:, i:i + 1]), cache,
                        jnp.asarray(i, jnp.int32))
        ref.append(np.asarray(lg[:, 0], np.float32))
    leaf = jax.tree.leaves(cache)[0]
    out = dict(ref=np.stack(ref), ref_dtype=str(leaf.dtype))
    base = get_config("qwen3-8b").reduced()
    for key, cfg in (("fp8", base.replace(kv_cache_dtype_str=FP8)),
                     ("compute", base)):
        model = convert.params_from_numpy(params, cfg, device="cpu")
        cache = model.init_cache(BATCH, STEPS)
        out[f"{key}_dtype"] = cache["stage_0"]["0"]["k"].dtype
        steps = []
        with torch.no_grad():
            for i in range(STEPS):
                lg, cache = model.decode_step(
                    torch.from_numpy(toks[:, i:i + 1]).long(), cache, i)
                steps.append(lg[:, 0].numpy())
        out[key] = np.stack(steps)
    return out


def _step_rel(got, want):
    """Each step's max |got - want| over its largest |want|."""
    gap = np.abs(got - want).reshape(got.shape[0], -1).max(axis=1)
    return gap / np.abs(want).reshape(want.shape[0], -1).max(axis=1)


def test_fp8_cache_is_float8_on_both_sides(runs):
    assert runs["ref_dtype"] == FP8
    assert runs["fp8_dtype"] == torch.float8_e4m3fn
    assert runs["compute_dtype"] == torch.float32


def test_fp8_decode_matches_reference(runs):
    """Each of the 12 steps' logits against the reference's fp8 decode,
    within ``FP8_REL_BOUND`` of the step's largest logit; the greedy
    token of every step alike."""
    rel = _step_rel(runs["fp8"], runs["ref"])
    assert np.all(np.isfinite(runs["fp8"]))
    assert rel.max() <= FP8_REL_BOUND, rel
    np.testing.assert_array_equal(runs["fp8"].argmax(-1),
                                  runs["ref"].argmax(-1))


def test_fp8_close_to_compute_dtype_cache(runs):
    """The port's fp8 logits against its own float32-cache decode, under
    the reference's 0.15 bound on the mean relative gap, and not equal to
    them (the cache really rounds)."""
    fp8, full = runs["fp8"], runs["compute"]
    gap = float(np.mean(np.abs(fp8 - full)))
    scale = float(np.mean(np.abs(full))) + 1e-9
    assert gap / scale < CLOSE_TO_COMPUTE_DTYPE, (gap, scale)
    assert gap > 0.0

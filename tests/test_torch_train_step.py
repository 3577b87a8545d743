"""The port's training path on the CPU: ``make_train_step`` against the
reference's jitted ``train_step``, ``grad_accum``, the loss falling for
every architecture, the train CLI, and the accounting (``count_params``,
``input_specs``, ``shape_applicable``, ``ASSIGNED``) and
``convert.params_to_numpy`` against the reference.  The kernel wrappers'
backward is in ``test_torch_train.py``.

Three train steps (lr 1e-2, B = 2, S = 16, reduced MoE, prefix-LM and
encoder-decoder configs from the reference's weights): losses rtol 1e-4,
``step`` exact, parameters within the reference's own Adam-sign bound
(``tests/test_arch_smoke.py``'s ``grad_accum`` test: at step 0 Adam moves
a weight by ~lr·sign(g), so gradients of opposite sign within rounding
put 2·lr between the two sides) taken once a step -- max|Δ| ≤ 2.5e-2 a
step, a leaf's mean |Δ| < 2e-3 (measured after three steps: max 1.3e-2,
mean 1.9e-4; losses within 1.3e-5).
"""
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jcheckpoint
from repro.configs import ASSIGNED as JASSIGNED
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.configs import shape_applicable as jshape_applicable
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild_model
from repro_torch import convert
from repro_torch.checkpoint import store
from repro_torch.configs import (ASSIGNED, INPUT_SHAPES, TensorSpec,
                                 get_config, input_specs, list_archs,
                                 list_models, shape_applicable)
from repro_torch.launch import steps, train
from repro_torch.models import build_model
from _torch_threads import one_torch_thread  # noqa: F401

LR = 1e-2
B, S = 2, 16
STEP_ATOL, STEP_MEAN = 2.5e-2, 2e-3


def _batch(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    n = cfg.prefix_tokens or cfg.stub_frames
    if n:
        batch["embeddings"] = rng.normal(size=(b, n, cfg.d_model)) \
            .astype(np.float32)
    return batch


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- make_train_step ---------------------------------------------------------------

def _reference_weights(arch, seed=2):
    """The reference's ``init`` with every leaf moved by 0.05·N(0, 1)."""
    jmodel = jbuild_model(jget_config(arch).reduced())
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        jax.jit(jmodel.init)(jax.random.key(seed)))


@pytest.mark.parametrize("arch", ["grok-1-314b", "paligemma-3b",
                                  "whisper-large-v3"])
def test_three_train_steps_match_reference(arch):
    jstep, _, jopt = jsteps.make_train_step(jget_config(arch).reduced(),
                                            lr=LR)
    jstep = jax.jit(jstep)
    cfg = get_config(arch).reduced()
    params = _reference_weights(arch)
    batches = [_batch(cfg, 10 + i) for i in range(3)]
    jp = jax.tree.map(jnp.asarray, params)
    jstate, jcount = jopt.init(jp), jnp.zeros((), jnp.int32)
    step_fn, model, opt = steps.make_train_step(
        cfg, lr=LR, model=convert.params_from_numpy(params, cfg,
                                                    device="cpu"))
    state, count = opt.init(dict(model.named_parameters())), 0
    for i, batch in enumerate(batches):
        jp, jstate, jcount, jm = jstep(
            jp, jstate, jcount, {k: jnp.asarray(v) for k, v in batch.items()})
        state, count, m = step_fn(state, count, _port_batch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        assert count == int(jcount) == i + 1
        got = jax.tree.leaves(convert.params_to_numpy(model))
        for w, g in zip(jax.tree.leaves(jp), got):
            d = np.abs(np.asarray(w, np.float32) - g)
            assert d.max() <= STEP_ATOL * (i + 1)
            assert d.mean() < STEP_MEAN
    assert jax.tree_util.tree_structure(convert.params_to_numpy(
        model, state["m"])) == jax.tree_util.tree_structure(jstate["m"])


def test_grad_accum_equivalence():
    """grad_accum=2 matches grad_accum=1 on the same batch (the reference's
    test, on the port)."""
    cfg = get_config("stablelm-1.6b").reduced()
    batch = _port_batch(_batch(cfg, 4, b=4))

    def run(accum):
        c = cfg.replace(grad_accum=accum)
        gen = torch.Generator().manual_seed(0)
        step_fn, model, opt = steps.make_train_step(c, lr=LR, device="cpu",
                                                    generator=gen)
        _, count, m = step_fn(opt.init(dict(model.named_parameters())), 0,
                              batch)
        assert count == 1
        return [p.detach().clone() for p in model.parameters()], \
            float(m["loss"])

    p1, l1 = run(1)
    p2, l2 = run(2)
    assert l1 == pytest.approx(l2, rel=1e-4)
    for a, b in zip(p1, p2):
        torch.testing.assert_close(a, b, atol=2.5e-2, rtol=0.0)
        assert float(torch.mean(torch.abs(a - b))) < 2e-3


def test_grad_accum_needs_a_divisible_batch():
    cfg = get_config("stablelm-1.6b").reduced().replace(grad_accum=2)
    step_fn, model, opt = steps.make_train_step(
        cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="microbatches"):
        step_fn(opt.init(dict(model.named_parameters())), 0,
                _port_batch(_batch(cfg, 5, b=3)))


@pytest.mark.parametrize("arch", ASSIGNED)
def test_train_step_reduces_loss(arch):
    """The reference's smoke test on the port: 4 steps on one batch at lr
    1e-2, every loss finite, the last below the first."""
    cfg = get_config(arch).reduced()
    step_fn, model, opt = steps.make_train_step(
        cfg, lr=LR, device="cpu", generator=torch.Generator().manual_seed(0))
    batch = _port_batch(_batch(cfg, 6))
    state, count, losses = opt.init(dict(model.named_parameters())), 0, []
    for _ in range(4):
        state, count, m = step_fn(state, count, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0]


def test_weights_are_frozen_until_the_train_step():
    """Serving builds no graph: weights are built frozen and
    ``make_train_step`` makes them trainable."""
    cfg = get_config("recurrentgemma-9b").reduced()
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in model.parameters())
    steps.make_train_step(cfg, model=model)
    assert all(p.requires_grad for p in model.parameters())


def test_train_cli_writes_a_checkpoint_the_reference_reads(tmp_path, capsys):
    argv = ["--arch", "xlstm-125m", "--steps", "3", "--batch", "2", "--seq",
            "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3",
            "--device", "cpu"]
    assert train.main(argv) == 0
    out = capsys.readouterr().out
    assert "step    2" in out
    assert any(f.startswith("step_") for f in os.listdir(tmp_path))
    cfg = get_config("xlstm-125m").reduced()
    template = build_model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    tree, step, _ = store.load_checkpoint(str(tmp_path),
                                          convert.params_to_tree(template))
    assert step == 3
    jtree, jstep, _ = jcheckpoint.load_checkpoint(
        str(tmp_path), jax.eval_shape(
            jbuild_model(jget_config("xlstm-125m").reduced()).init,
            jax.random.key(0)))
    assert jstep == 3
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    mine = jax.tree.leaves(convert.params_to_numpy(
        convert.params_from_numpy(
            jax.tree.map(lambda t: t.numpy(), tree,
                         is_leaf=lambda t: isinstance(t, torch.Tensor)),
            cfg, device="cpu")))
    for (path, leaf), m in zip(flat, mine):
        np.testing.assert_array_equal(np.asarray(leaf), m,
                                      err_msg=jax.tree_util.keystr(path))


def test_train_cli_resumes_and_takes_a_mesh_of_one(tmp_path, capsys):
    """``--resume DIR`` starts from the latest checkpoint's weights, Adam
    moments and step: two steps and a resumed third write the checkpoint
    of three uninterrupted steps, weights and moments bit for bit (a
    checkpoint without moments restarts them and Adam's count);
    ``--mesh 1x1`` without a process group is the unsharded run, bit for
    bit; a mesh the processes do not fill, or not DxM, raises."""
    base = ["--arch", "stablelm-1.6b", "--batch", "2", "--seq", "16",
            "--device", "cpu"]
    first = str(tmp_path / "first")
    assert train.main(base + ["--steps", "2", "--ckpt-dir", first,
                              "--ckpt-every", "2"]) == 0
    capsys.readouterr()
    again = str(tmp_path / "again")
    assert train.main(base + ["--steps", "1", "--resume", first,
                              "--ckpt-dir", again, "--ckpt-every", "3"]) == 0
    out = capsys.readouterr().out
    assert "resumed at step 2" in out and "step    2 loss" in out
    cfg = get_config("stablelm-1.6b").reduced()
    template = convert.params_to_tree(build_model(cfg, device="cpu"))
    tree, step, _ = store.load_checkpoint(again, template)
    before, _, _ = store.load_checkpoint(first, template)
    assert step == 3
    changed = [not torch.equal(a, b) for a, b in
               zip(jax.tree.leaves(tree), jax.tree.leaves(before))]
    assert any(changed)
    whole = str(tmp_path / "whole")
    assert train.main(base + ["--steps", "3", "--ckpt-dir", whole,
                              "--ckpt-every", "3"]) == 0
    for sub, like in (("", template), ("adam", {"m": template,
                                                "v": template})):
        got, _, _ = store.load_checkpoint(os.path.join(again, sub), like)
        want, step, _ = store.load_checkpoint(os.path.join(whole, sub), like)
        assert step == 3
        assert all(torch.equal(a, b) for a, b in
                   zip(jax.tree.leaves(got), jax.tree.leaves(want))), sub
    shutil.rmtree(os.path.join(first, "adam"))
    capsys.readouterr()
    assert train.main(base + ["--steps", "1", "--resume", first]) == 0
    assert "no Adam moments" in capsys.readouterr().out
    runs = []
    for mesh in ([], ["--mesh", "1x1"]):
        assert train.main(base + ["--steps", "2"] + mesh) == 0
        runs.append([line.split("(")[0] for line in
                     capsys.readouterr().out.splitlines()
                     if line.startswith("step")])
    assert runs[0] == runs[1] and len(runs[0]) == 2
    with pytest.raises(ValueError, match="needs 2 processes"):
        train.main(base + ["--mesh", "1x2"])
    with pytest.raises(ValueError, match="DxM"):
        train.parse_mesh("2by2")
    assert train.parse_mesh("2x2") == (2, 2)


def test_train_cli_embeds_the_vlm_prefix(capsys):
    assert train.main(["--arch", "paligemma-3b", "--steps", "2", "--batch",
                       "2", "--seq", "16", "--device", "cpu"]) == 0
    assert "step    1" in capsys.readouterr().out


# -- accounting and carrying weights -------------------------------------------------

def test_assigned_and_registry_match_reference():
    assert ASSIGNED == JASSIGNED
    assert set(ASSIGNED) <= set(list_archs())


@pytest.mark.parametrize("arch", list_models())
def test_param_count_matches_built_model_and_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    red = cfg.reduced()
    model = build_model(red, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == red.param_count()
    assert red.param_count() == jcfg.reduced().param_count()


@functools.lru_cache(maxsize=None)
def _jspecs(arch, shape):
    return jinput_specs(jget_config(arch), JSHAPES[shape])


def _cache_leaves(tree):
    """Every (shape, dtype) of a cache spec tree, sorted: the reference
    keeps an xLSTM block's cache as a tuple where the port names its
    leaves."""
    if isinstance(tree, TensorSpec):
        return [(tuple(tree.shape), str(tree.dtype).replace("torch.", ""))]
    if isinstance(tree, dict):
        return sorted(x for v in tree.values() for x in _cache_leaves(v))
    return sorted((tuple(s.shape), str(s.dtype))
                  for s in jax.tree.leaves(tree))


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
def test_input_specs_and_applicability_match_reference(shape):
    assert vars(INPUT_SHAPES[shape]) == vars(JSHAPES[shape])
    for arch in ASSIGNED:
        cfg = get_config(arch)
        got = input_specs(cfg, INPUT_SHAPES[shape])
        want = _jspecs(arch, shape)
        assert sorted(got) == sorted(want), arch
        for key in got:
            if key == "cache":
                for stage in want["cache"]:
                    for pos in want["cache"][stage]:
                        assert _cache_leaves(got["cache"][stage][pos]) == \
                            _cache_leaves(want["cache"][stage][pos]), \
                            (arch, stage, pos)
            else:
                assert _cache_leaves(got[key]) == _cache_leaves(want[key]), \
                    (arch, key)
        assert shape_applicable(cfg, INPUT_SHAPES[shape]) == \
            jshape_applicable(jget_config(arch), JSHAPES[shape])


@pytest.mark.parametrize("arch,param_dtype", [
    ("recurrentgemma-9b", "float32"), ("llama4-maverick-400b-a17b",
                                       "bfloat16"),
    ("whisper-large-v3", "float32")])
def test_params_to_numpy_round_trip_is_exact(arch, param_dtype):
    cfg = get_config(arch).reduced().replace(param_dtype_str=param_dtype)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    tree = convert.params_to_numpy(model)
    back = convert.params_from_numpy(tree, cfg, device="cpu")
    for (name, p), (name2, q) in zip(model.named_parameters(),
                                     back.named_parameters()):
        assert name == name2 and p.dtype == q.dtype and torch.equal(p, q)
    shapes = jax.eval_shape(jbuild_model(jget_config(arch).reduced()).init,
                            jax.random.key(0))
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(shapes)
    for got, want in zip(jax.tree.leaves(tree), jax.tree.leaves(shapes)):
        assert got.shape == want.shape

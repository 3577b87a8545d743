"""The port's optimizers, schedules, clipping and token data held to the JAX
reference on the CPU.

Both sides take the same numpy parameters and gradients (four leaves of
mixed shapes, a bias and a near-zero one among them) over five steps, the
learning rate a schedule of the step.  Tolerances: parameters, moments,
norms and schedule values rtol 1e-6 (float32 arithmetic in the same
order; XLA's and torch's float32 ``pow``, ``cos`` and ``sqrt`` may round
an ulp apart); with bfloat16 moments the moments at one bfloat16 ulp
(rtol 2^-7: a float32 sum an ulp apart can round to the neighbouring
bfloat16) and the parameters at rtol 1e-5.  Measured with jax 0.9.0 and
torch 2.13 on the CPU: every optimizer's parameters and moments, the
bfloat16 path included, bit-equal over the five steps.  The token stream and its
batches are bit-equal from one numpy generator.  The rest mirrors the
reference's ``tests/test_data_optim_ckpt.py`` on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsynthetic
from repro.data import tokens as jtokens
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch.data import synthetic, tokens
from repro_torch.optim import (adam, adamw, clip_by_global_norm,
                               constant, cosine_decay, global_norm,
                               linear_warmup, momentum, sgd, warmup_cosine)
from repro_torch.optim import schedules as psched
from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=0.0)
BF16_MOMENT_TOL = dict(rtol=2.0 ** -7, atol=1e-30)
BF16_PARAM_TOL = dict(rtol=1e-5, atol=0.0)
SHAPES = {"w": (5, 7), "b": (7,), "table": (3, 4, 2), "tiny": (6,)}
STEPS = 5


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    out = {k: (scale * rng.normal(size=s)).astype(np.float32)
           for k, s in SHAPES.items()}
    out["tiny"] *= 1e-6
    return out


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, tol=TOL):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float32),
                                   np.asarray(want[k], np.float32), **tol,
                                   err_msg=k)


# (name, port factory, reference factory) with the same schedule and knobs
OPTIMIZERS = {
    "sgd": (lambda: sgd(0.1), lambda: jopt.sgd(0.1)),
    "momentum": (lambda: momentum(psched.linear_warmup(0.05, 3)),
                 lambda: jopt.momentum(jsched.linear_warmup(0.05, 3))),
    "nesterov": (lambda: momentum(0.05, beta=0.8, nesterov=True),
                 lambda: jopt.momentum(0.05, beta=0.8, nesterov=True)),
    "adam": (lambda: adam(psched.cosine_decay(0.1, 4)),
             lambda: jopt.adam(jsched.cosine_decay(0.1, 4))),
    "adamw": (lambda: adamw(psched.warmup_cosine(3e-2, 2, 10),
                            weight_decay=0.1),
              lambda: jopt.adamw(jsched.warmup_cosine(3e-2, 2, 10),
                                 weight_decay=0.1)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_reference(name):
    make, jmake = OPTIMIZERS[name]
    opt, jo = make(), jmake()
    params = _tree(0)
    pp, jp = _torch(params), {k: jnp.asarray(v) for k, v in params.items()}
    ps, js = opt.init(pp), jo.init(jp)
    for step in range(STEPS):
        grads = _tree(10 + step, scale=0.5)
        pp, ps = opt.update(_torch(grads), ps, pp, step)
        jp, js = jo.update({k: jnp.asarray(v) for k, v in grads.items()}, js,
                           jp, jnp.asarray(step, jnp.int32))
        _close(pp, jp)
        for moment in js:
            _close(ps[moment], js[moment])


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_bf16_moments_match_reference(weight_decay):
    """The ≥300B configs' moments in bfloat16, each moment update in
    float32 and rounded once, as the reference's."""
    opt = adamw(0.01, weight_decay=weight_decay, opt_dtype="bfloat16")
    jo = jopt.adamw(0.01, weight_decay=weight_decay, opt_dtype="bfloat16")
    params = _tree(1)
    pp, jp = _torch(params), {k: jnp.asarray(v) for k, v in params.items()}
    ps, js = opt.init(pp), jo.init(jp)
    assert all(m.dtype == torch.bfloat16 for m in ps["m"].values())
    for step in range(STEPS):
        grads = _tree(20 + step, scale=0.5)
        pp, ps = opt.update(_torch(grads), ps, pp, step)
        jp, js = jo.update({k: jnp.asarray(v) for k, v in grads.items()}, js,
                           jp, jnp.asarray(step, jnp.int32))
        _close(pp, jp, BF16_PARAM_TOL)
        for moment in ("m", "v"):
            _close({k: v.float() for k, v in ps[moment].items()},
                   {k: np.asarray(v, np.float32)
                    for k, v in js[moment].items()}, BF16_MOMENT_TOL)
    assert all(p.dtype == torch.float32 for p in pp.values())


def test_adam_bf16_params_keep_their_dtype():
    """A bfloat16 parameter (grok's and llama4's weights) steps in float32
    and is cast back, as the reference's."""
    params = {k: v.astype(np.float32) for k, v in _tree(2).items()}
    pp = {k: torch.from_numpy(v).to(torch.bfloat16)
          for k, v in params.items()}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    grads = _tree(3)
    opt = adamw(0.01, opt_dtype="bfloat16")
    jo = jopt.adamw(0.01, opt_dtype="bfloat16")
    new, _ = opt.update(_torch(grads), opt.init(pp), pp, 0)
    jnew, _ = jo.update({k: jnp.asarray(v) for k, v in grads.items()},
                        jo.init(jp), jp, jnp.zeros((), jnp.int32))
    for k in new:
        assert new[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(new[k].float().numpy(),
                                      np.asarray(jnew[k], np.float32))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_reference(max_norm):
    tree = _tree(4, scale=0.3)
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    np.testing.assert_allclose(float(global_norm(_torch(tree))),
                               float(jopt.global_norm(jt)), **TOL)
    _close(clip_by_global_norm(_torch(tree), max_norm),
           jopt.clip_by_global_norm(jt, max_norm))


SCHEDULES = {
    "constant": (lambda m: m.constant(3e-4)),
    "linear_warmup": (lambda m: m.linear_warmup(1.0, 10)),
    "cosine_decay": (lambda m: m.cosine_decay(0.7, 100, final_frac=0.05)),
    "warmup_cosine": (lambda m: m.warmup_cosine(2e-3, 10, 50)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_reference(name):
    ps, js = SCHEDULES[name](psched), SCHEDULES[name](jsched)
    for step in (0, 1, 5, 9, 10, 11, 37, 60, 100, 150):
        got = ps(step)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(
            float(got), float(js(jnp.asarray(step, jnp.int32))), **TOL,
            err_msg=f"step {step}")


def test_make_tokens_bit_equal():
    a = synthetic.make_tokens(np.random.default_rng(7), n_tokens=5000,
                              vocab=513)
    b = jsynthetic.make_tokens(np.random.default_rng(7), n_tokens=5000,
                               vocab=513)
    assert a.dtype == np.int32
    np.testing.assert_array_equal(a, b)


def test_token_batches_bit_equal():
    kw = dict(vocab=1000, batch=3, seq_len=17, n_batches=4)
    got = list(tokens.token_batches(np.random.default_rng(3), **kw))
    want = list(jtokens.token_batches(np.random.default_rng(3), **kw))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


# -- the reference's own cases, on the port --------------------------------------

def test_token_batches():
    bs = list(tokens.token_batches(np.random.default_rng(0), vocab=100,
                                   batch=4, seq_len=16, n_batches=3))
    assert len(bs) == 3
    for b in bs:
        assert b["tokens"].shape == (4, 16)
        np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
        assert b["tokens"].max() < 100


def _quadratic(params):
    return sum(torch.sum(torch.square(leaf)) for leaf in params.values())


@pytest.mark.parametrize("factory", [
    lambda: sgd(0.1), lambda: momentum(0.05), lambda: adam(0.1),
    lambda: adamw(0.1, weight_decay=0.0)])
def test_optimizer_reduces_quadratic(factory):
    opt = factory()
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor([[1.0, 4.0]])}
    state = opt.init(params)
    start = float(_quadratic(params))
    for step in range(50):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        grads = dict(zip(leaves, torch.autograd.grad(
            _quadratic(leaves), list(leaves.values()))))
        params, state = opt.update(grads, state, params, step)
    assert float(_quadratic(params)) < 0.05 * start


@pytest.mark.parametrize("seed", range(8))
def test_adam_step_bounded(seed):
    """Adam's per-step move is bounded by ~lr regardless of grad scale."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.5, 5.0)
    params = {"w": torch.tensor(rng.normal(size=4), dtype=torch.float32)}
    opt = adam(0.01)
    grads = {"w": torch.tensor(scale * rng.normal(size=4),
                               dtype=torch.float32)}
    new, _ = opt.update(grads, opt.init(params), params, 0)
    assert (torch.abs(new["w"] - params["w"]) <= 0.011).all()


def test_clip_by_global_norm():
    t = {"a": torch.tensor([3.0, 4.0])}          # norm 5
    c = clip_by_global_norm(t, 1.0)
    assert float(global_norm(c)) == pytest.approx(1.0, rel=1e-5)
    c2 = clip_by_global_norm(t, 10.0)            # under the cap: unchanged
    np.testing.assert_allclose(c2["a"].numpy(), [3.0, 4.0])


def test_schedules():
    s = linear_warmup(1.0, 10)
    assert float(s(0)) == pytest.approx(0.1)
    assert float(s(9)) == pytest.approx(1.0)
    c = cosine_decay(1.0, 100, final_frac=0.1)
    assert float(c(0)) == pytest.approx(1.0)
    assert float(c(100)) == pytest.approx(0.1)
    wc = warmup_cosine(1.0, 10, 100)
    assert float(wc(5)) < 1.0
    assert float(wc(10)) == pytest.approx(1.0)
    assert float(constant(0.5)(7)) == 0.5


def test_adam_bf16_moments():
    opt = adam(0.01, opt_dtype="bfloat16")
    params = {"w": torch.ones(4)}
    state = opt.init(params)
    assert state["m"]["w"].dtype == torch.bfloat16
    new, state = opt.update({"w": torch.ones(4)}, state, params, 0)
    assert new["w"].dtype == torch.float32
    assert torch.isfinite(new["w"]).all()


def test_update_changes_nothing_it_was_given():
    """``update`` returns new tensors; the train step copies them in."""
    params = _torch(_tree(5))
    before = {k: v.clone() for k, v in params.items()}
    opt = adamw(0.1)
    state = opt.init(params)
    state_before = {m: {k: v.clone() for k, v in d.items()}
                    for m, d in state.items()}
    opt.update(_torch(_tree(6)), state, params, 0)
    for k in params:
        assert torch.equal(params[k], before[k])
        for m in state:
            assert torch.equal(state[m][k], state_before[m][k])

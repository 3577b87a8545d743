"""The port's core modules against their JAX counterparts, on the CPU.

Each test feeds the same numpy-seeded inputs to a reference function and
to its port and compares: integer and mask outputs exactly, floats within
the stated tolerance (float32 summation order and ulp-level ``pow``/``log``
differences between XLA and PyTorch).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.hfl_mnist import CONFIG as JCONFIG
from repro.core import aggregation as jagg
from repro.core import association as jassoc
from repro.core import cost as jcost
from repro.core import engine as jengine
from repro.core import noma as jnoma
from repro.core import pdd as jpdd
from repro.core import staleness as jstale
from repro.data import federated as jfed
from repro.models.mlp import MLPClassifier
from repro_torch import convert
from repro_torch.configs.hfl_mnist import CONFIG
from repro_torch.core import (aggregation, association, cost, engine, noma,
                              pdd, staleness)
from repro_torch.data import federated
from repro_torch.models import mlp
from _torch_threads import one_torch_thread  # noqa: F401

SMALL_KW = dict(n_clients=16, n_edges=2, clients_per_edge=3, min_samples=60,
                max_samples=120, hidden=32, input_dim=64)
SMALL = dataclasses.replace(CONFIG, **SMALL_KW)
JSMALL = dataclasses.replace(JCONFIG, **SMALL_KW)


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _one_hot(rng, n, m, per_edge=None):
    assoc = np.zeros((n, m), np.float32)
    owner = rng.integers(0, m, n)
    for e in range(m):
        rows = np.flatnonzero(owner == e)
        assoc[rows[:per_edge], e] = 1.0
    return assoc


def test_config_matches_reference():
    assert dataclasses.asdict(CONFIG) == dataclasses.asdict(JCONFIG)
    assert (CONFIG.tau1, CONFIG.tau2) == (JCONFIG.tau1, JCONFIG.tau2)


# -- data + init ---------------------------------------------------------------

@pytest.mark.parametrize("iid", [True, False])
def test_federated_data_bit_equal(iid):
    kw = dict(n_clients=12, dim=20, iid=iid, min_samples=30, max_samples=90,
              test_samples=50, noise=0.9)
    got = federated.make_federated(np.random.default_rng(4), **kw)
    want = jfed.make_federated(np.random.default_rng(4), **kw)
    for f in ("x", "y", "counts", "test_x", "test_y"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)


def test_standalone_init_bit_equal_on_topology_and_data():
    state, bundle, aux = engine.init_simulation(SMALL, seed=3, device="cpu")
    jstate, jbundle, jaux = jengine.init_simulation(JSMALL, seed=3)
    np.testing.assert_array_equal(aux["topo"]["dist"], jaux["topo"]["dist"])
    for f in ("dist", "x", "y", "counts", "test_x", "test_y"):
        np.testing.assert_array_equal(getattr(bundle, f).numpy(),
                                      np.asarray(getattr(jbundle, f)), f)
    np.testing.assert_array_equal(state.staleness.numpy(),
                                  np.asarray(jstate.staleness))
    assert state.gains.shape == jstate.gains.shape
    assert bool(torch.isfinite(state.gains).all()) and \
        bool((state.gains > 0).all())
    for k, leaf in state.global_params.items():
        assert leaf.shape == jstate.global_params[k].shape
        assert state.client_params[k].shape == jstate.client_params[k].shape


def test_convert_carries_reference_state():
    jstate, jbundle, _ = jengine.init_simulation(JSMALL, seed=1)
    snp = jax.tree.map(np.asarray, jstate._replace(key=None, scenario=None))
    state, bundle = convert.state_from_numpy(
        snp, jax.tree.map(np.asarray, jbundle), "cpu")
    for k in mlp.PARAM_KEYS:
        np.testing.assert_array_equal(state.global_params[k].numpy(),
                                      snp.global_params[k])
        np.testing.assert_array_equal(state.client_params[k].numpy(),
                                      snp.client_params[k])
    np.testing.assert_array_equal(state.gains.numpy(), snp.gains)
    assert state.staleness.dtype == torch.int32 and state.round_idx == 0
    assert bundle.y.dtype == torch.int32 and bundle.counts.dtype == \
        torch.float32


# -- models ---------------------------------------------------------------------

def test_mlp_loss_and_accuracy_match_reference():
    model = MLPClassifier(20, 16, 10)
    p = model.init(jax.random.key(2))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, 20)).astype(np.float32)
    y = rng.integers(0, 10, 64).astype(np.int32)
    tp = {k: _t(v) for k, v in p.items()}
    np.testing.assert_allclose(float(mlp.loss(tp, _t(x), _t(y))),
                               float(model.loss(p, (x, y))), rtol=1e-6)
    assert float(mlp.accuracy(tp, _t(x), _t(y))) == \
        float(model.accuracy(p, x, y))


def test_mlp_init_shapes_and_scale():
    g = torch.Generator().manual_seed(0)
    p = mlp.init_params(784, 128, 10, generator=g, device=torch.device("cpu"))
    assert [tuple(p[k].shape) for k in mlp.PARAM_KEYS] == [
        (784, 128), (128,), (128, 128), (128,), (128, 10), (10,)]
    assert abs(float(p["w1"].std()) - 1 / np.sqrt(784)) < 2e-3
    assert float(p["b1"].abs().max()) == 0.0


# -- noma -----------------------------------------------------------------------

def test_gains_from_replayed_fading_match_reference():
    rng = np.random.default_rng(0)
    dist = jnp.asarray(rng.uniform(0.5, 400.0, (24, 3)), jnp.float32)
    key = jax.random.key(5)
    fading = np.asarray(jax.random.exponential(key, dist.shape))
    want = jnoma.rayleigh_gains(key, dist, path_loss_exponent=3.76)
    got = noma.rayleigh_gains(_t(fading), _t(dist), path_loss_exponent=3.76)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6)
    prev = np.asarray(want)
    want_ev = jnoma.evolve_gains(key, jnp.asarray(prev), dist,
                                 path_loss_exponent=3.76, rho=0.9)
    got_ev = noma.evolve_gains(_t(fading), _t(prev), _t(dist),
                               path_loss_exponent=3.76, rho=0.9)
    np.testing.assert_allclose(got_ev.numpy(), np.asarray(want_ev),
                               rtol=2e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_pairwise_sic_matches_reference(masked):
    rng = np.random.default_rng(7)
    p = rng.uniform(0.01, 0.1, 20).astype(np.float32)
    g = (rng.uniform(0.1, 10.0, 20) * 1e-9).astype(np.float32)
    g[5] = g[4]
    p[5] = p[4]                                  # an exact received tie
    mask = rng.random(20) < 0.6 if masked else None
    noise = noma.noise_power_w(-174.0, 1e6)
    got = noma.achievable_rates(_t(p), _t(g), bandwidth_hz=1e6, noise_w=noise,
                                mask=None if mask is None else _t(mask))
    want = jnoma.achievable_rates(jnp.asarray(p), jnp.asarray(g),
                                  bandwidth_hz=1e6, noise_w=noise,
                                  mask=None if mask is None
                                  else jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# -- association ------------------------------------------------------------------

def _market(seed, n, m, radius=300.0):
    rng = np.random.default_rng(seed)
    dist = rng.uniform(10.0, 400.0, (n, m)).astype(np.float32)
    scores = rng.uniform(0.0, 100.0, (n, m)).astype(np.float32)
    scores[::4] = np.round(scores[::4] / 20.0) * 20.0      # exact ties
    coverage = dist <= radius
    return dist, scores, coverage


@pytest.mark.parametrize("seed,n,m,quota", [
    (0, 16, 2, 3), (1, 64, 4, 4), (2, 40, 5, 2), (3, 30, 3, 12),
    (4, 9, 4, 1)])
def test_resolver_equals_numpy_oracle(seed, n, m, quota):
    """Orders fed from the reference: the port's sweep resolver equals the
    numpy serial oracle ``_resolve`` exactly."""
    dist, scores, coverage = _market(seed, n, m)
    pref = np.where(coverage, scores, -np.inf)
    order = np.argsort(-pref, axis=0, kind="stable").T
    want = jassoc._resolve(order, dist, quota, coverage)
    got = association.resolve_parallel(_t(order), _t(dist), quota,
                                       _t(coverage))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("policy", ["fcea", "gcea", "rcea"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_associate_matches_reference(policy, seed):
    """rcea: the port ranks by the uniform the reference draws from its
    key, handed over as ``uniform``."""
    dist, scores, _ = _market(seed, 48, 4)
    gains = np.random.default_rng(seed + 9).uniform(
        1e-12, 1e-8, (48, 4)).astype(np.float32)
    key = jax.random.key(seed)
    want, want_sweeps = jassoc.associate_jax(
        policy, scores=jnp.asarray(scores), gains=jnp.asarray(gains),
        dist=jnp.asarray(dist), quota=4, coverage_radius_m=300.0,
        key=key, return_sweeps=True)
    uniform = _t(jax.random.uniform(key, (48, 4)))
    got, sweeps = association.associate(
        policy, scores=_t(scores), gains=_t(gains), dist=_t(dist), quota=4,
        coverage_radius_m=300.0, uniform=uniform, return_sweeps=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sweeps == int(want_sweeps)


def test_rcea_is_not_ported_yet():
    """rcea is ported without a generator of its own: its uniform is a
    drawn argument (``RoundDraws.assoc_u``), and a call without it
    raises."""
    with pytest.raises(ValueError, match="uniform"):
        association.associate("rcea", scores=None, gains=torch.ones(4, 2),
                              dist=torch.ones(4, 2), quota=1,
                              coverage_radius_m=10.0)


# -- cost + pdd -------------------------------------------------------------------

def _cost_inputs(seed, cfg, per_edge=None):
    rng = np.random.default_rng(seed)
    n, m = cfg.n_clients, cfg.n_edges
    return dict(
        power_w=rng.uniform(cfg.p_min_w, cfg.p_max_w, n).astype(np.float32),
        f_hz=rng.uniform(cfg.f_min_hz, cfg.f_max_hz, n).astype(np.float32),
        gains=rng.uniform(1e-12, 1e-9, (n, m)).astype(np.float32),
        assoc=_one_hot(rng, n, m, per_edge),
        z=(rng.random(m) < 0.5).astype(np.float32),
        n_samples=rng.integers(60, 120, n).astype(np.float32))


@pytest.mark.parametrize("noma_enabled", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_round_cost_matches_reference(noma_enabled, seed):
    cfg = dataclasses.replace(CONFIG, n_clients=24, n_edges=4)
    jcfg = dataclasses.replace(JCONFIG, n_clients=24, n_edges=4)
    inp = _cost_inputs(seed, cfg, per_edge=4)
    got = cost.round_cost(cfg, **{k: _t(v) for k, v in inp.items()},
                          noma_enabled=noma_enabled)
    want = jcost.round_cost(jcfg, **{k: jnp.asarray(v)
                                     for k, v in inp.items()},
                            noma_enabled=noma_enabled, sic_impl="pairwise")
    for f in got._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   err_msg=f)
    z = _t(np.asarray([1.0, 0.0, 1.0, 1.0], np.float32))
    got_s = cost.apply_schedule(cfg, got, z)
    want_s = jcost.apply_schedule(jcfg, want, jnp.asarray(z.numpy()))
    np.testing.assert_allclose(float(got_s.cost), float(want_s.cost),
                               rtol=1e-5)


def test_local_compute_matches_reference():
    inp = _cost_inputs(3, SMALL)
    got = cost.local_compute(SMALL, _t(inp["f_hz"]), _t(inp["n_samples"]))
    want = jcost.local_compute(JSMALL, jnp.asarray(inp["f_hz"]),
                               jnp.asarray(inp["n_samples"]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _pdd_problem(seed, m):
    rng = np.random.default_rng(seed)
    energy = rng.uniform(1.0, 80.0, m).astype(np.float32)
    t_cloud = np.full((m,), 0.05, np.float32)
    U = rng.uniform(0.5, 8.0, m).astype(np.float32)
    return energy, t_cloud, U


@pytest.mark.parametrize("seed,m,quota", [(0, 4, 2), (1, 4, 1), (2, 8, 4),
                                          (3, 6, None)])
def test_pdd_schedule_matches_reference(seed, m, quota):
    energy, t_cloud, U = _pdd_problem(seed, m)
    want = jpdd.pdd_schedule(jnp.asarray(energy), jnp.asarray(t_cloud),
                             jnp.asarray(U), lam_t=0.5, lam_e=0.5,
                             quota=quota)
    got = pdd.pdd_schedule(_t(energy), _t(t_cloud), _t(U), lam_t=0.5,
                           lam_e=0.5, quota=quota)
    np.testing.assert_array_equal(got.z_binary.numpy(),
                                  np.asarray(want.z_binary))
    np.testing.assert_allclose(got.z.numpy(), np.asarray(want.z), atol=1e-5)
    np.testing.assert_allclose(float(got.objective), float(want.objective),
                               rtol=1e-6)
    assert got.iterations == int(want.iterations)


@pytest.mark.parametrize("outer,inner", [(1, 1), (2, 3)])
@pytest.mark.parametrize("seed", [0, 2])
def test_pdd_iterates_match_reference(seed, outer, inner):
    """Stopped early, z is still fractional: the iteration itself (not
    just its 0/1 fixed point) must follow the float32 reference."""
    energy, t_cloud, U = _pdd_problem(seed, 4 if seed == 0 else 8)
    quota = 2 if seed == 0 else 4
    kw = dict(lam_t=0.5, lam_e=0.5, quota=quota, outer_iters=outer,
              inner_iters=inner)
    want = jpdd.pdd_schedule(jnp.asarray(energy), jnp.asarray(t_cloud),
                             jnp.asarray(U), **kw)
    got = pdd.pdd_schedule(_t(energy), _t(t_cloud), _t(U), **kw)
    for f in ("z", "residual", "W"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)


def test_pdd_objective_is_the_billed_cost():
    """With U = τ₂·max t_n the PDD objective at its own z equals the bill
    ``apply_schedule`` charges for that z."""
    cfg = dataclasses.replace(CONFIG, n_clients=16, n_edges=4)
    inp = _cost_inputs(5, cfg)
    inp.pop("z")
    rc_all = cost.round_cost(cfg, **{k: _t(v) for k, v in inp.items()},
                             z=torch.ones(4))
    t_cloud = torch.full((4,), cfg.edge_model_size_bits / cfg.edge_rate_bps)
    U = rc_all.per_edge_time_s - t_cloud
    for quota in (1, 2, 3):
        res = pdd.pdd_schedule(rc_all.per_edge_energy_j, t_cloud, U,
                               lam_t=cfg.lambda_t, lam_e=cfg.lambda_e,
                               quota=quota)
        billed = cost.apply_schedule(cfg, rc_all, res.z_binary)
        assert float(res.z_binary.sum()) == quota
        np.testing.assert_allclose(float(res.objective), float(billed.cost),
                                   rtol=1e-6)


def test_semi_sync_fastest_matches_reference():
    t = np.asarray([3.0, 1.0, 2.0, 1.0, 5.0], np.float32)
    for quota in (1, 2, 3):
        np.testing.assert_array_equal(
            pdd.semi_sync_fastest(_t(t), quota).numpy(),
            np.asarray(jpdd.semi_sync_fastest(jnp.asarray(t), quota)))


# -- aggregation + staleness -------------------------------------------------------

def _stack(rng, n):
    return {"w": rng.normal(size=(n, 5, 3)).astype(np.float32),
            "b": rng.normal(size=(n, 3)).astype(np.float32)}


def test_aggregation_matches_reference():
    rng = np.random.default_rng(8)
    n, m = 10, 3
    clients = _stack(rng, n)
    assoc = _one_hot(rng, n, m)
    assoc[0] = 0.0                                   # one unassociated client
    counts = rng.integers(60, 120, n).astype(np.float32)
    z = np.asarray([1.0, 0.0, 1.0], np.float32)
    tc = {k: _t(v) for k, v in clients.items()}
    jc = {k: jnp.asarray(v) for k, v in clients.items()}
    edge = aggregation.edge_aggregate(tc, _t(assoc), _t(counts))
    jedge = jagg.edge_aggregate(jc, jnp.asarray(assoc), jnp.asarray(counts))
    edge_data = assoc.T @ counts
    cloud = aggregation.cloud_aggregate(edge, _t(z), _t(edge_data))
    jcloud = jagg.cloud_aggregate(jedge, jnp.asarray(z),
                                  jnp.asarray(edge_data))
    back = aggregation.broadcast_to_clients(_t(assoc), edge, tc)
    jback = jagg.broadcast_to_clients(None, jnp.asarray(assoc), jedge, jc)
    rep = aggregation.replicate({k: v[0] for k, v in tc.items()}, 4)
    jrep = jagg.replicate({k: v[0] for k, v in jc.items()}, 4)
    for got, want in ((edge, jedge), (cloud, jcloud), (back, jback),
                      (rep, jrep)):
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(back["w"][0].numpy(), clients["w"][0])


def test_staleness_matches_reference():
    s = np.asarray([1, 4, 7, staleness.STALENESS_MAX, 2], np.int32)
    sel = np.asarray([True, False, True, False, False])
    got = staleness.update_staleness(_t(s), _t(sel))
    want = jstale.update_staleness(jnp.asarray(s), jnp.asarray(sel))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        staleness.init_staleness(5, torch.device("cpu")).numpy(),
        np.asarray(jstale.init_staleness(5)))

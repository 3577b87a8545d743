"""The port's (N, K) candidate-frontier round, held to the JAX reference on
the CPU.

Every input is made with numpy from a seed and fed to both packages.
Integers, masks and sweep counts are compared exactly; scores at the
score kernel's tolerance (atol 2e-4, rtol 1e-5, as in
``tests/test_torch_kernels.py``); SIC rates and bills at rtol 1e-5
(float32 summation order); the engine as in ``tests/test_torch_engine.py``
(cost/time/energy rtol 1e-5, loss rtol 1e-4, accuracy within 2 test
samples), with the mean staleness to an ulp.  The reference's sweep
counts come from its own resolver's ``return_sweeps`` and, in the engine,
from its telemetry trace.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.hfl_mnist import CONFIG as JCONFIG
from repro.core import association as jassoc
from repro.core import candidates as jcand
from repro.core import cost as jcost
from repro.core import engine as jengine
from repro.core import fuzzy as jfuzzy
from repro.core import noma as jnoma
from repro.kernels import hfl_ops as jops
from repro_torch.configs.hfl_mnist import CONFIG
from repro_torch.core import association, candidates, cost, engine, fuzzy, noma
from repro_torch.kernels import hfl_ops
from test_torch_engine import _replayed_draws, _start
from test_torch_kernels import edge_case_gains
from _torch_threads import one_torch_thread  # noqa: F401

SCORE_TOL = dict(atol=2e-4, rtol=1e-5)

# 24 clients over 6 edges (two of them placed at random): coverage
# degrees vary, so K = 2 and K = 3 prune
SMALL_KW = dict(n_clients=24, n_edges=6, clients_per_edge=3, min_samples=60,
                max_samples=120, hidden=16, input_dim=32, local_batch=16)
SMALL = dataclasses.replace(CONFIG, **SMALL_KW)
JSMALL = dataclasses.replace(JCONFIG, **SMALL_KW)


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _world(seed, n, m, kind):
    """(dist, pref, radius): ``ties`` quantises distances and shares one
    preference column across edges (exact ties on both sides);
    ``zero_cov`` puts a third of the clients out of every edge's reach."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        dist = rng.choice([50.0, 100.0, 150.0], (n, m)).astype(np.float32)
        pref = np.repeat(rng.integers(0, 4, (n, 1)), m, axis=1
                         ).astype(np.float32)
        return dist, pref, 120.0
    dist = rng.uniform(10.0, 400.0, (n, m)).astype(np.float32)
    pref = rng.uniform(0.0, 100.0, (n, m)).astype(np.float32)
    if kind == "zero_cov":
        dist[rng.random(n) < 1.0 / 3.0] = 500.0
    return dist, pref, 300.0


def _both_sets(dist, k, radius):
    return (candidates.build_candidates(_t(dist), k, coverage_radius_m=radius),
            jcand.build_candidates(jnp.asarray(dist), k,
                                   coverage_radius_m=radius))


# -- the frontier -----------------------------------------------------------------

@pytest.mark.parametrize("seed,n,m,k,kind", [
    (0, 20, 5, 2, "random"), (1, 30, 4, 4, "ties"), (2, 12, 6, 9, "ties"),
    (3, 16, 3, 1, "zero_cov")])
def test_build_candidates_matches_reference(seed, n, m, k, kind):
    """Exact distance ties keep edge-index order (the reference's top_k)."""
    dist, _, radius = _world(seed, n, m, kind)
    got, want = _both_sets(dist, k, radius)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    assert got.idx.dtype == torch.int32
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))


def test_build_candidates_row_order():
    cand = candidates.build_candidates(
        torch.tensor([[3.0, 1.0, 2.0, 1.0], [5.0, 5.0, 5.0, 5.0]]), 4,
        coverage_radius_m=4.0)
    np.testing.assert_array_equal(cand.idx.numpy(),
                                  [[1, 3, 2, 0], [0, 1, 2, 3]])
    np.testing.assert_array_equal(cand.valid.numpy(),
                                  [[True] * 4, [False] * 4])


def test_gather_one_hot_and_own_edge_match_reference():
    rng = np.random.default_rng(7)
    n, m = 18, 5
    dist, _, radius = _world(7, n, m, "random")
    field = rng.normal(size=(n, m)).astype(np.float32)
    assigned = rng.integers(-1, m, n).astype(np.int32)
    got, want = _both_sets(dist, 3, radius)
    np.testing.assert_array_equal(
        candidates.gather(got, _t(field)).numpy(),
        np.asarray(jcand.gather(want, jnp.asarray(field))))
    np.testing.assert_array_equal(
        candidates.assigned_one_hot(_t(assigned), m).numpy(),
        np.asarray(jcand.assigned_one_hot(jnp.asarray(assigned), m)))
    np.testing.assert_array_equal(
        candidates.own_edge_gather(_t(assigned), _t(field)).numpy(),
        np.asarray(jcand.own_edge_gather(jnp.asarray(assigned),
                                         jnp.asarray(field))))


def test_max_coverage_degree_matches_reference():
    dist, _, radius = _world(4, 25, 6, "zero_cov")
    assert candidates.max_coverage_degree(_t(dist), radius) == \
        jcand.max_coverage_degree(dist, radius)


# -- scoring ----------------------------------------------------------------------

# ``edge``: exact dB ties, gains under the 1e-30 clamp and zeros, and
# all-zero staleness (its max clamps to 1); the frontier's int32 indices
@pytest.mark.parametrize("n,m,k,block_r,edge", [
    pytest.param(20, 4, 2, 16, False, id="20-4-2-16"),
    pytest.param(33, 6, 3, 512, False, id="33-6-3-512"),
    pytest.param(10, 3, 3, 8, False, id="10-3-3-8"),
    pytest.param(24, 5, 3, 32, True, id="24-5-3-32-edge")])
def test_score_candidates_matches_pallas_and_jnp(n, m, k, block_r, edge):
    rng = np.random.default_rng(n + k)
    gains = rng.uniform(1e-12, 1e-8, (n, m)).astype(np.float32)
    counts = rng.integers(60, 120, n).astype(np.float32)
    stale = rng.integers(1, 9, n).astype(np.int32)
    if edge:
        gains, stale = edge_case_gains(gains), np.zeros(n, np.int32)
    dist, _, radius = _world(n, n, m, "random")
    cand, jc = _both_sets(dist, k, radius)
    got = hfl_ops.score_candidates(_t(gains), cand.idx, _t(counts),
                                   _t(stale), data_max=120.0)
    plain = fuzzy.score_candidates(_t(gains), cand, _t(counts), _t(stale),
                                   data_max=120.0)
    want_jnp = jfuzzy.score_candidates(jnp.asarray(gains), jc,
                                       jnp.asarray(counts),
                                       jnp.asarray(stale), data_max=120.0)
    want_pallas = jops.score_candidates(jnp.asarray(gains), jc.idx,
                                        jnp.asarray(counts),
                                        jnp.asarray(stale), data_max=120.0,
                                        block_r=block_r, interpret=True)
    assert got.shape == (n, k) and cand.idx.dtype == torch.int32
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jnp), **SCORE_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas),
                               **SCORE_TOL)
    # each frontier score is the dense score at the same pair
    dense = hfl_ops.score_matrix(_t(gains), _t(counts), _t(stale),
                                 data_max=120.0)
    assert torch.equal(got, candidates.gather(cand, dense))
    assert torch.equal(got, plain)
    assert hfl_ops.LAUNCHES["score_candidates"] == 0   # CPU: no kernel


# -- the candidate resolver -------------------------------------------------------

def _resolve_both(dist, pref, radius, quota, k):
    cand, jc = _both_sets(dist, k, radius)
    m = dist.shape[1]
    got, sweeps = association.resolve_candidates(
        candidates.gather(cand, _t(pref)), cand, quota, m,
        return_sweeps=True)
    want, want_sweeps = jassoc.resolve_candidates(
        jcand.gather(jc, jnp.asarray(pref)), jc, quota, m,
        return_sweeps=True)
    return got, sweeps, np.asarray(want), int(want_sweeps)


@pytest.mark.parametrize("kind", ["random", "ties", "zero_cov"])
@pytest.mark.parametrize("k", [1, 2, "M"])
@pytest.mark.parametrize("seed,n,m,quota", [(0, 24, 4, 3), (1, 40, 5, 2),
                                            (2, 15, 3, 6)])
def test_resolve_candidates_matches_reference(kind, k, seed, n, m, quota):
    dist, pref, radius = _world(seed, n, m, kind)
    k = m if k == "M" else k
    got, sweeps, want, want_sweeps = _resolve_both(dist, pref, radius, quota,
                                                   k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    assert sweeps == want_sweeps


@pytest.mark.parametrize("kind", ["random", "ties", "zero_cov"])
def test_resolve_candidates_at_full_k_equals_dense(kind):
    """K = M loses nothing: the port's candidate resolver makes the port's
    dense ``resolve_parallel`` matching in as many sweeps."""
    n, m, quota = 32, 4, 3
    dist, pref, radius = _world(11, n, m, kind)
    cand = candidates.build_candidates(_t(dist), m, coverage_radius_m=radius)
    assigned, sweeps = association.resolve_candidates(
        candidates.gather(cand, _t(pref)), cand, quota, m, return_sweeps=True)
    cov = _t(dist) <= radius
    order = torch.argsort(-torch.where(cov, _t(pref), -torch.inf), dim=0,
                          stable=True).T
    dense, dense_sweeps = association.resolve_parallel(
        order, _t(dist), quota, cov, return_sweeps=True)
    assert torch.equal(candidates.assigned_one_hot(assigned, m), dense)
    assert sweeps == dense_sweeps


@pytest.mark.parametrize("policy", ["fcea", "gcea", "rcea"])
def test_associate_candidates_matches_reference(policy):
    """rcea gathers the reference's dense (N, M) uniform at the frontier."""
    n, m, k, quota = 30, 5, 2, 3
    dist, scores, radius = _world(5, n, m, "random")
    gains = np.random.default_rng(6).uniform(1e-12, 1e-8, (n, m)
                                             ).astype(np.float32)
    key = jax.random.key(3)
    cand, jc = _both_sets(dist, k, radius)
    want, want_sweeps = jassoc.associate_candidates(
        policy, scores=jcand.gather(jc, jnp.asarray(scores)),
        gains=jnp.asarray(gains), cand=jc, quota=quota, key=key, n_edges=m,
        return_sweeps=True)
    got, sweeps = association.associate_candidates(
        policy, scores=candidates.gather(cand, _t(scores)), gains=_t(gains),
        cand=cand, quota=quota, n_edges=m,
        uniform=_t(jax.random.uniform(key, (n, m))), return_sweeps=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sweeps == int(want_sweeps)


def test_associate_candidates_rejects_dense_scores():
    dist, _, radius = _world(0, 8, 3, "random")
    cand = candidates.build_candidates(_t(dist), 2, coverage_radius_m=radius)
    with pytest.raises(ValueError, match="frontier"):
        association.associate_candidates(
            "fcea", scores=torch.zeros(8, 3), gains=torch.ones(8, 3),
            cand=cand, quota=2, n_edges=3)


# -- compact SIC and the bill ---------------------------------------------------

def _assigned_world(seed, n, m, quota, ties=False):
    """Gains, powers and a quota-feasible assignment, some clients
    unmatched; ``ties`` repeats received powers exactly."""
    rng = np.random.default_rng(seed)
    gains = rng.uniform(1e-12, 1e-8, (n, m)).astype(np.float32)
    power = rng.uniform(0.05, 0.5, n).astype(np.float32)
    if ties:
        gains[1::3], power[1::3] = gains[0::3][:len(gains[1::3])], \
            power[0::3][:len(power[1::3])]
    assigned = np.full(n, -1, np.int32)
    slots = [e for e in range(m) for _ in range(quota)]
    picks = rng.permutation(n)[:min(len(slots), int(n * 0.8))]
    for i, c in enumerate(picks):
        assigned[c] = slots[i]
    if ties:   # tied pairs on one edge
        assigned[1::3] = assigned[0::3][:len(assigned[1::3])]
        for e in range(m):   # keep the quota
            extra = np.flatnonzero(assigned == e)[quota:]
            assigned[extra] = -1
    return gains, power, assigned


@pytest.mark.parametrize("seed,n,m,quota,ties", [
    (0, 24, 3, 3, False), (1, 24, 3, 3, True), (2, 6, 2, 5, False),
    (3, 40, 6, 4, True), (4, 4, 1, 2, False)])
def test_sic_rates_assigned_matches_reference(seed, n, m, quota, ties):
    gains, power, assigned = _assigned_world(seed, n, m, quota, ties)
    kw = dict(n_edges=m, max_per_edge=quota, bandwidth_hz=CONFIG.bandwidth_hz,
              noise_w=1e-13)
    own = jcand.own_edge_gather(jnp.asarray(assigned), jnp.asarray(gains))
    want = jnoma.sic_rates_assigned(jnp.asarray(power), own,
                                    jnp.asarray(assigned), **kw)
    got = noma.sic_rates_assigned(
        _t(power), candidates.own_edge_gather(_t(assigned), _t(gains)),
        _t(assigned), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert bool((got[_t(assigned) < 0] == 0.0).all())


@pytest.mark.parametrize("noma_enabled", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_round_cost_assigned_matches_reference(noma_enabled, seed):
    n, m, quota = 24, 3, 3
    gains, power, assigned = _assigned_world(seed, n, m, quota)
    rng = np.random.default_rng(seed + 100)
    f_hz = rng.uniform(CONFIG.f_min_hz, CONFIG.f_max_hz, n
                       ).astype(np.float32)
    counts = rng.integers(60, 120, n).astype(np.float32)
    z = rng.integers(0, 2, m).astype(np.float32)
    assoc = np.asarray(jcand.assigned_one_hot(jnp.asarray(assigned), m),
                       np.float32)
    want = jcost.round_cost(JCONFIG, power_w=jnp.asarray(power),
                            f_hz=jnp.asarray(f_hz), gains=jnp.asarray(gains),
                            assoc=jnp.asarray(assoc), z=jnp.asarray(z),
                            n_samples=jnp.asarray(counts),
                            noma_enabled=noma_enabled,
                            sic_max_per_edge=quota,
                            assigned=jnp.asarray(assigned))
    got = cost.round_cost(CONFIG, power_w=_t(power), f_hz=_t(f_hz),
                          gains=_t(gains), assoc=_t(assoc), z=_t(z),
                          n_samples=_t(counts), noma_enabled=noma_enabled,
                          sic_max_per_edge=quota, assigned=_t(assigned))
    for field in want._fields:
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-5, err_msg=field)


def test_round_cost_assigned_requires_bound():
    with pytest.raises(ValueError, match="sic_max_per_edge"):
        cost.round_cost(CONFIG, power_w=torch.ones(4), f_hz=torch.ones(4),
                        gains=torch.ones(4, 2), assoc=torch.zeros(4, 2),
                        z=torch.ones(2), n_samples=torch.ones(4),
                        assigned=torch.zeros(4, dtype=torch.int32))


# -- the candidate round ----------------------------------------------------------

@pytest.mark.parametrize("policy,allocator,scheduler,noma_enabled,k,pallas", [
    pytest.param("fcea", "mid", "pdd", True, 2, False, id="fcea-pdd-k2"),
    pytest.param("gcea", "mid", "fastest", True, 2, False,
                 id="gcea-fastest-k2"),
    pytest.param("rcea", "rra", "fastest", True, 6, False,
                 id="rcea-rra-fastest-kM"),
    pytest.param("fcea", "mid", "pdd", False, 3, False, id="fcea-pdd-oma-k3"),
    pytest.param("fcea", "mid", "pdd", True, 2, True,
                 id="fcea-pdd-k2-pallas")])
def test_candidate_round_trajectory_matches_reference(
        policy, allocator, scheduler, noma_enabled, k, pallas):
    """Four rounds of the candidate round against ``round_step_jit`` with
    the reference's own draws replayed; ``pallas`` routes the reference's
    scoring through its Pallas kernel (interpret mode)."""
    kw = dict(policy=policy, allocator=allocator, scheduler=scheduler,
              noma_enabled=noma_enabled, candidates_k=k)
    jspec = jengine.EngineSpec(**kw, telemetry=True, pallas_score=pallas)
    spec = engine.EngineSpec(**kw)
    jstate, jbundle, state, bundle = _start(seed=0, jcfg=JSMALL)
    assert candidates.max_coverage_degree(bundle.dist,
                                          engine.coverage_radius(SMALL)) > 2
    n_test = int(jbundle.test_y.shape[0])
    for r in range(4):
        draws = _replayed_draws(JSMALL, jspec, jstate, jbundle)
        jstate, out = jengine.round_step_jit(JSMALL, jspec, jstate, jbundle)
        jm, trace = jengine.split_output(jspec, out)
        state, m = engine.round_step(SMALL, spec, state, bundle, draws)
        want, got = jengine.metrics_row(jm), engine.metrics_row(m)
        msg = f"{policy}-{allocator}-{scheduler} K={k} round {r}"
        np.testing.assert_array_equal(got["z"], want["z"], msg)
        for key in ("round", "n_associated", "n_available"):
            assert got[key] == want[key], (msg, key)
        # the staleness vector is held exactly below; its mean to an ulp,
        # as XLA's mean over 24 clients multiplies by the reciprocal
        np.testing.assert_allclose(got["avg_staleness"],
                                   want["avg_staleness"], rtol=1e-6,
                                   err_msg=msg)
        assert got["sweeps"] == int(trace.assoc_sweeps), msg
        np.testing.assert_array_equal(state.staleness.numpy(),
                                      np.asarray(jstate.staleness), msg)
        for key in ("cost", "total_time_s", "total_energy_j"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       err_msg=f"{msg} {key}")
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4,
                                   err_msg=msg)
        assert abs(got["accuracy"] - want["accuracy"]) <= 2.0 / n_test, msg

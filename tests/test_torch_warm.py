"""The port's warm-started association held to the JAX reference on the CPU.

The seeded resolvers (``resolve_parallel(seed=)``,
``resolve_candidates(seed=)``) are fed the same numpy-made markets and
seeds as the reference's: matchings and sweep counts exact, the fleet's
cold fallback chosen seed by seed.  Warm and cold runs are bit-equal but
for the sweep counts, in the port and in the reference, and a reference
warm state carried over by ``convert.state_from_numpy`` makes the
reference's next round (its draws replayed by
``test_torch_scenarios._round_draws``): decisions, the ``warm`` leaf,
staleness and the sweeps exact, the bill at rtol 1e-5, the loss at rtol
1e-4, the accuracy within 2 test samples (the tolerances of
``tests/test_torch_engine.py``).  The warm engine's trajectories against
the reference are in ``tests/test_torch_warm_engine.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import association as jassoc
from repro.core import candidates as jcand
from repro.core import engine as jengine
from repro_torch import convert
from repro_torch.core import association, candidates, engine
from test_torch_engine import JSMALL, SMALL
from test_torch_scenarios import _round_draws
from _torch_threads import one_torch_thread  # noqa: F401

ROUNDS = 6
WORLD = "random_waypoint"


def _t(a):
    return torch.tensor(np.asarray(a))


def _market(seed, n, m, kind):
    """(dist, pref, radius) of a numpy-made market; ``ties`` quantises the
    distances and shares one preference column (exact ties on both
    sides), ``zero_cov`` puts a third of the clients out of reach."""
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


def _order(dist, pref, radius):
    cov = dist <= radius
    order = np.argsort(-np.where(cov, pref, -np.inf), axis=0,
                       kind="stable").T
    return order.astype(np.int32), cov


# the reference's resolvers compiled once a shape (eager, each call traces
# its while loops anew)
_jresolve = jax.jit(jassoc.resolve_parallel,
                    static_argnames=("quota", "return_sweeps"))
_jresolve_cand = jax.jit(jassoc.resolve_candidates,
                         static_argnames=("quota", "n_edges",
                                          "return_sweeps"))


def _stale_seed(seed, dist, pref, radius, quota):
    """Last round's matching of a moved market (distances and preferences
    jittered), with up to two seeds moved onto an edge that does not cover
    their client today -- into a free slot, or swapped with a client held
    there: a quota-feasible seed, some of it out of today's coverage."""
    rng = np.random.default_rng(seed + 100)
    d0 = (dist * rng.uniform(0.7, 1.3, dist.shape)).astype(np.float32)
    p0 = (pref + rng.uniform(-20.0, 20.0, pref.shape)).astype(np.float32)
    order, cov = _order(d0, p0, radius)
    assoc = np.asarray(_jresolve(jnp.asarray(order), jnp.asarray(d0), quota,
                                 jnp.asarray(cov)))
    out = np.where(assoc.sum(1) > 0, assoc.argmax(1), -1).astype(np.int32)
    load = np.bincount(out[out >= 0], minlength=dist.shape[1])
    moved = 0
    for c in range(len(out)):
        far = np.flatnonzero(dist[c] > radius)
        if moved == 2 or out[c] < 0 or not far.size:
            continue
        free = far[load[far] < quota]
        if free.size:
            load[out[c]] -= 1
            load[free[0]] += 1
            out[c] = free[0]
        else:
            other = np.flatnonzero(out == far[0])[0]
            out[other], out[c] = out[c], far[0]
        moved += 1
    return out


def _worst_seed(order, cov, quota):
    """Each edge holding its lowest-ranked in-coverage clients, each client
    at most once: a feasible seed whose warm fixpoint blocks."""
    m, n = order.shape
    seed = np.full(n, -1, np.int32)
    for e in range(m):
        held = 0
        for c in order[e][::-1]:
            if held < quota and cov[c, e] and seed[c] < 0:
                seed[c], held = e, held + 1
    return seed


SEEDED_CASES = [(0, 24, 4, 3, "random"), (1, 30, 4, 3, "ties"),
                (2, 25, 5, 2, "zero_cov"), (3, 16, 3, 6, "random")]


@pytest.mark.parametrize("seed,n,m,quota,kind", SEEDED_CASES)
def test_seeded_resolve_parallel_matches_reference(seed, n, m, quota, kind):
    """Stale seeds (some of them out of coverage), the worst feasible seed
    (its fixpoint blocks: the fallback runs), the cold matching itself and
    an empty seed: matching and sweeps as the reference's."""
    dist, pref, radius = _market(seed, n, m, kind)
    order, cov = _order(dist, pref, radius)
    jargs = (jnp.asarray(order), jnp.asarray(dist), quota, jnp.asarray(cov))
    cold = np.asarray(_jresolve(*jargs))
    seeds = {"stale": _stale_seed(seed, dist, pref, radius, quota),
             "worst": _worst_seed(order, cov, quota),
             "cold": np.where(cold.sum(1) > 0, cold.argmax(1), -1
                              ).astype(np.int32),
             "empty": np.full(n, -1, np.int32)}
    assert (~cov[np.arange(n), np.maximum(seeds["stale"], 0)]
            & (seeds["stale"] >= 0)).any() or kind == "ties"
    for name, s in seeds.items():
        want, want_sw = _jresolve(*jargs, return_sweeps=True,
                                                seed=jnp.asarray(s))
        got, sw = association.resolve_parallel(
            _t(order), _t(dist), quota, _t(cov), return_sweeps=True,
            seed=_t(s))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)
        np.testing.assert_array_equal(got.numpy(), cold, name)
        assert sw == int(want_sw), (name, sw, int(want_sw))


def _frontier(dist, k, radius, up):
    return (candidates.build_candidates(_t(dist), k, coverage_radius_m=radius,
                                        edge_up=_t(up)),
            jcand.build_candidates(jnp.asarray(dist), k,
                                   coverage_radius_m=radius,
                                   edge_up=jnp.asarray(up)))


@pytest.mark.parametrize("seed,n,m,quota,kind", SEEDED_CASES)
@pytest.mark.parametrize("k,dead", [(2, None), (3, 1)])
def test_seeded_resolve_candidates_matches_reference(seed, n, m, quota, kind,
                                                     k, dead):
    """The frontier's seeded resolver, K = 2 and K = 3 with one edge dead
    (its slots invalid, so a seed on it is dropped): the assigned vector
    and sweeps as the reference's."""
    dist, pref, radius = _market(seed, n, m, kind)
    order, cov = _order(dist, pref, radius)
    up = np.ones(m, np.float32)
    if dead is not None:
        up[dead] = 0.0
    cand, jc = _frontier(dist, k, radius, up)
    jpref = jcand.gather(jc, jnp.asarray(pref))
    cold = np.asarray(_jresolve_cand(jpref, jc, quota, m))
    seeds = {"stale": _stale_seed(seed, dist, pref, radius, quota),
             "worst": _worst_seed(order, cov, quota), "cold": cold,
             "empty": np.full(n, -1, np.int32)}
    for name, s in seeds.items():
        want, want_sw = _jresolve_cand(
            jpref, jc, quota, m, return_sweeps=True, seed=jnp.asarray(s))
        got, sw = association.resolve_candidates(
            candidates.gather(cand, _t(pref)), cand, quota, m,
            return_sweeps=True, seed=_t(s))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)
        assert sw == int(want_sw), (name, sw, int(want_sw))


@pytest.fixture
def fallback_flags(monkeypatch):
    """Every blocking-pair read of the resolvers, as host lists."""
    flags = []
    for name in ("_blocking_pair_dense", "_blocking_pair_frontier"):
        fn = getattr(association, name)

        def wrapped(*a, _fn=fn, **kw):
            out = _fn(*a, **kw)
            flags.append(out.tolist())
            return out
        monkeypatch.setattr(association, name, wrapped)
    return flags


@pytest.mark.parametrize("frontier", [False, True], ids=["dense", "k2"])
def test_fleet_fallback_is_chosen_per_seed(frontier, fallback_flags):
    """A fleet of three markets seeded with their cold matching (no
    fallback), their worst seed (fallback) and a stale seed: one flag read
    for the fleet, and each seed's matching and sweeps as the reference's
    own call gives them."""
    n, m, quota, k = 24, 4, 3, 2
    rows, jrows = [], []
    for s, kind in enumerate(("random", "random", "zero_cov")):
        dist, pref, radius = _market(10 + s, n, m, kind)
        order, cov = _order(dist, pref, radius)
        seed = [None, _worst_seed(order, cov, quota),
                _stale_seed(s, dist, pref, radius, quota)][s]
        up = np.ones(m, np.float32)
        if frontier:
            cand, jc = _frontier(dist, k, radius, up)
            jpref = jcand.gather(jc, jnp.asarray(pref))
            if seed is None:
                seed = np.asarray(_jresolve_cand(jpref, jc, quota,
                                                            m))
            want = _jresolve_cand(jpref, jc, quota, m,
                                             return_sweeps=True,
                                             seed=jnp.asarray(seed))
            rows.append((candidates.gather(cand, _t(pref)), cand, seed))
        else:
            jargs = (jnp.asarray(order), jnp.asarray(dist), quota,
                     jnp.asarray(cov))
            if seed is None:
                a = np.asarray(_jresolve(*jargs))
                seed = np.where(a.sum(1) > 0, a.argmax(1), -1
                                ).astype(np.int32)
            want = _jresolve(*jargs, return_sweeps=True,
                                           seed=jnp.asarray(seed))
            rows.append((_t(order), _t(dist), _t(cov), seed))
        jrows.append(want)
    stack = lambda *t: torch.stack(t)                       # noqa: E731
    if frontier:
        pref = stack(*(r[0] for r in rows))
        cand = engine._map(stack, *(r[1] for r in rows))
        got, sweeps = association.resolve_candidates(
            pref, cand, quota, m, return_sweeps=True,
            seed=_t(np.stack([r[2] for r in rows])))
        got = candidates.assigned_one_hot(got, m)
        want_assoc = [np.eye(m, dtype=np.int32)[np.asarray(w)]
                      * (np.asarray(w) >= 0)[:, None] for w, _ in jrows]
    else:
        got, sweeps = association.resolve_parallel(
            stack(*(r[0] for r in rows)), stack(*(r[1] for r in rows)),
            quota, stack(*(r[2] for r in rows)), return_sweeps=True,
            seed=_t(np.stack([r[3] for r in rows])))
        want_assoc = [np.asarray(w) for w, _ in jrows]
    assert fallback_flags == [[False, True, fallback_flags[0][2]]]
    for s in range(3):
        np.testing.assert_array_equal(got[s].numpy(), want_assoc[s],
                                      f"seed {s}")
        assert sweeps[s] == int(jrows[s][1]), (s, sweeps, jrows)


def test_warm_leaf_structural_absence():
    """The reference's ``test_warm_leaf_structural_absence`` on the port,
    and over a fleet: the seed is (S, N) there."""
    state, bundle, _ = engine.init_simulation(SMALL, seed=0, device="cpu")
    spec = engine.EngineSpec(policy="gcea", scheduler="fastest")
    warm_spec = engine.EngineSpec(policy="gcea", scheduler="fastest",
                                  warm_start=True)
    cold = engine.ensure_carry(SMALL, spec, state)
    assert cold.warm is None
    warm = engine.ensure_carry(SMALL, warm_spec, state)
    assert warm.warm.dtype == torch.int32
    np.testing.assert_array_equal(warm.warm.numpy(),
                                  np.full(SMALL.n_clients, -1, np.int32))
    assert engine.ensure_carry(SMALL, warm_spec, warm) is warm
    # a stale warm leaf is stripped when the flag is off
    assert engine.ensure_carry(SMALL, spec, warm).warm is None
    states, _ = engine.stack_fleet([(state, bundle)] * 2)
    fleet = engine.ensure_carry(SMALL, warm_spec, states)
    assert tuple(fleet.warm.shape) == (2, SMALL.n_clients)
    assert engine.select_seed(fleet, 1).warm.shape == (SMALL.n_clients,)
    stacked, _ = engine.stack_fleet([(warm, bundle), (warm, bundle)])
    assert tuple(stacked.warm.shape) == (2, SMALL.n_clients)


def _check_round(state, m, tr, jstate, jout, n_test, msg):
    jm, jtr = jout
    got, want = engine.metrics_row(m), jengine.metrics_row(jm)
    np.testing.assert_array_equal(got["z"], want["z"], msg)
    for key in ("round", "n_associated", "n_available", "avg_staleness"):
        assert got[key] == want[key], (msg, key)
    assert got["sweeps"] == int(jtr.assoc_sweeps), msg
    for key in ("cost", "total_time_s", "total_energy_j"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=f"{msg} {key}")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4,
                               err_msg=msg)
    assert abs(got["accuracy"] - want["accuracy"]) <= 2.0 / n_test, msg
    np.testing.assert_array_equal(tr.assoc_sweeps.numpy(),
                                  np.asarray(jtr.assoc_sweeps), msg)
    np.testing.assert_array_equal(state.warm.numpy(),
                                  np.asarray(jstate.warm), msg)
    np.testing.assert_array_equal(state.staleness.numpy(),
                                  np.asarray(jstate.staleness), msg)


@pytest.mark.parametrize("candidates_k", [None, 2])
def test_warm_equals_cold_in_port_and_reference(candidates_k):
    """Warm and cold runs from one start and one generator state are
    bit-equal in everything but the sweep counts, in the port and, with
    its own draws, in the reference."""
    outs, jouts = {}, {}
    for warm in (False, True):
        kw = dict(policy="gcea", scheduler="fastest", scenario="dynamic",
                  warm_start=warm, candidates_k=candidates_k)
        state, bundle, _ = engine.init_simulation(SMALL, seed=0, device="cpu",
                                                  scenario=WORLD)
        outs[warm] = engine.run_scanned(SMALL, engine.EngineSpec(**kw), state,
                                        bundle, ROUNDS,
                                        torch.Generator().manual_seed(5))
        jstate, jbundle, _ = jengine.init_simulation(JSMALL, seed=0,
                                                     scenario=WORLD)
        jouts[warm] = jengine.run_scanned(JSMALL, jengine.EngineSpec(**kw),
                                          jstate, jbundle, ROUNDS)
    (cold, mc), (warm, mw) = outs[False], outs[True]
    for name in engine.RoundMetrics._fields:
        if name != "sweeps":
            a, b = getattr(mc, name), getattr(mw, name)
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b), name
    for name in ("global_params", "client_params"):
        for key, leaf in getattr(cold, name).items():
            assert torch.equal(leaf, getattr(warm, name)[key]), (name, key)
    assert torch.equal(cold.staleness, warm.staleness)
    assert cold.warm is None and warm.warm is not None
    (jc, jmc), (jw, jmw) = jouts[False], jouts[True]
    for a, b in zip(jax.tree.leaves((jc.global_params, jmc)),
                    jax.tree.leaves((jw.global_params, jmw))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_state_from_numpy_carries_the_warm_leaf():
    """A reference warm state mid-run carried over: the port's next round
    starts from its seed and makes the reference's next round."""
    kw = dict(policy="gcea", scheduler="fastest", scenario="dynamic",
              warm_start=True, telemetry=True)
    jspec, spec = jengine.EngineSpec(**kw), engine.EngineSpec(**kw)
    jstate, jbundle, _ = jengine.init_simulation(JSMALL, seed=1,
                                                 scenario=WORLD)
    # normalised as the round does first thing: one compile, not two
    jstate = jengine.ensure_carry(JSMALL, jspec, jstate)
    for _ in range(2):
        jstate, _ = jengine.round_step_jit(JSMALL, jspec, jstate, jbundle)
    snp = jax.tree.map(np.asarray, jstate._replace(key=None))
    state, bundle = convert.state_from_numpy(
        snp, jax.tree.map(np.asarray, jbundle), "cpu")
    assert state.warm.dtype == torch.int32
    np.testing.assert_array_equal(state.warm.numpy(), np.asarray(jstate.warm))
    assert convert.state_from_numpy(
        jax.tree.map(np.asarray, jstate._replace(key=None, warm=None)),
        jax.tree.map(np.asarray, jbundle), "cpu")[0].warm is None
    draws = _round_draws(JSMALL, jspec, jstate, jbundle)
    jstate, jout = jengine.round_step_jit(JSMALL, jspec, jstate, jbundle)
    state, (m, tr) = engine.round_step(SMALL, spec, state, bundle, draws)
    _check_round(state, m, tr, jstate, jout, int(jbundle.test_y.shape[0]),
                 "carried")

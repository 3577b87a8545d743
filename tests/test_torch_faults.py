"""The port's fault layer (``repro_torch.faults``, ``EngineSpec(faults=)``)
held to a live run of the JAX reference (``repro.faults``), then the
reference's own fault tests on the port.

The reference draws its fault uniforms from four keys split off the fade
key (``split(fault_key(k_fade), 4)``: churn, loss, crash, poison, each
``uniform(k, shape)``); the port takes them as ``RoundDraws.faults``, so
every test replays them (``_fault_draws``) beside the round's other
draws (``tests/test_torch_scenarios.py``'s ``_round_draws``).

* Units: every process against the reference on the same uniforms.
  Masks and counts exactly, floats at rtol 1e-6.
* Trajectories at ``SMALL`` through ``round_step_jit``: integers exactly
  (every ``FaultState`` leaf and the trace's five fault leaves among
  them), the bill at rtol 1e-5, the loss at rtol 1e-4, params at the
  buffered tests' ``PARAM_TOL``, the buffered engine's carry as
  ``tests/test_torch_buffered.py`` holds it.
* The reference's own cases (``tests/test_faults.py``) on the port.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jaggregation
from repro.core import engine as jengine
from repro.faults import FaultSpec as JFaultSpec
from repro.faults import guard as jguard
from repro.faults import inject as jinject
from repro_torch.core import aggregation, engine
from repro_torch.faults import FaultSpec, FaultState, guard, inject
from test_torch_buffered import (PARAM_TOL, SPEC_KW, _assert_params,
                                 _assert_step)
from test_torch_engine import JSMALL, SMALL
from test_torch_scenarios import _round_draws
from test_torch_scenarios import _start as _scenario_start
from test_torch_telemetry import _assert_trace
from _torch_threads import one_torch_thread  # noqa: F401

ROUNDS = 4
N, M = SMALL.n_clients, SMALL.n_edges
# "chaos": the reference's chaos sweep cell (edge churn and a
# lossy, channel-tied uplink) plus crashes and NaN poisoning
CHAOS = dict(edge_p_kill=0.2, edge_p_respawn=0.5, uplink_p_loss=0.1,
             uplink_loss_slope=0.2, client_p_crash=0.05, p_poison=0.1,
             poison_nan=True)
# churn frozen: a pre-set edge_up mask stays put
FROZEN = dict(edge_p_kill=0.0, edge_p_respawn=0.0)
SYNC_KW = dict(policy="gcea", scheduler="fastest")
BUF_KW = {k: v for k, v in SPEC_KW.items() if k != "telemetry"}
FLOAT_RTOL = 1e-6


def _specs(base, fault_kw, **kw):
    """The reference's and the port's EngineSpec with the same faults."""
    return (jengine.EngineSpec(**base, **kw,
                               faults=JFaultSpec(**fault_kw)),
            engine.EngineSpec(**base, **kw, faults=FaultSpec(**fault_kw)))


def _t(a):
    return torch.tensor(np.asarray(a))


def _fault_draws(jspec, key):
    """The reference round's fault uniforms from its round key."""
    k_fade = jengine.round_keys(jspec, key)[2]
    ks = jax.random.split(jinject.fault_key(k_fade), 4)
    return engine.FaultDraws(*(_t(jax.random.uniform(k, (n,)))
                               for k, n in zip(ks, (M, N, N, N))))


def _draws(jspec, jstate, jbundle):
    draws = _round_draws(JSMALL, jspec, jstate, jbundle)
    return draws._replace(faults=_fault_draws(jspec, jstate.key))


def _assert_faults(got, want, msg):
    assert isinstance(got, FaultState), msg
    for name in FaultState._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == (torch.float32 if name == "edge_up"
                           else torch.int32), (msg, name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      f"{msg} {name}")


def _kill(state, spec, dead, cfg=SMALL):
    """``state`` with the fault state attached and edge ``dead`` down."""
    state = engine.ensure_carry(cfg, spec, state)
    up = torch.ones_like(state.faults.edge_up)
    up[..., dead] = 0.0
    return state._replace(faults=state.faults._replace(edge_up=up))


def _jkill(jstate, jspec, dead):
    jstate = jengine.ensure_carry(JSMALL, jspec, jstate)
    up = np.ones((M,), np.float32)
    up[dead] = 0.0
    return jstate._replace(faults=jstate.faults._replace(
        edge_up=jnp.asarray(up)))


# -- units against the reference ---------------------------------------------

def _key_u(seed, shape):
    k = jax.random.key(seed)
    return k, _t(jax.random.uniform(k, shape))


@pytest.mark.parametrize("fault_kw,up", [
    (dict(edge_p_kill=0.4, edge_p_respawn=0.6), [1, 0, 1, 1, 0, 1, 0, 1]),
    (dict(edge_p_kill=1.0, edge_p_respawn=0.0, min_edges_up=1), [1] * 8),
    (dict(edge_p_kill=1.0, edge_p_respawn=0.0, min_edges_up=0), [1] * 8),
    (FROZEN, [0, 1, 1, 0, 1, 0, 0, 1])], ids=["random", "veto", "no-veto",
                                             "frozen"])
def test_advance_edges_matches_reference(fault_kw, up):
    jf, pf = JFaultSpec(**fault_kw), FaultSpec(**fault_kw)
    up = np.asarray(up, np.float32)
    for seed in range(6):
        key, u = _key_u(seed, up.shape)
        want = np.asarray(jinject.advance_edges(jf, key, jnp.asarray(up)))
        got = inject.advance_edges(pf, u, torch.tensor(up))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want, f"seed {seed}")


def test_advance_edges_vetoes_per_seed():
    """A fleet's veto is per seed: one seed keeps its mask, the other
    steps."""
    fsp = FaultSpec(edge_p_kill=0.5, edge_p_respawn=0.0, min_edges_up=2)
    up = torch.ones((2, 3))
    u = torch.tensor([[0.1, 0.2, 0.9], [0.6, 0.7, 0.1]])
    got = inject.advance_edges(fsp, u, up)
    np.testing.assert_array_equal(got.numpy(), [[1, 1, 1], [1, 1, 0]])


def test_masked_dist_and_orphan_count_match_reference():
    rng = np.random.default_rng(0)
    dist = rng.uniform(0.0, 600.0, (N, M)).astype(np.float32)
    radius = 250.0
    avail = (rng.uniform(size=N) > 0.3).astype(np.float32)
    for up in ([0.0, 1.0], [1.0, 0.0], [0.0, 0.0], [1.0, 1.0]):
        jup = jnp.asarray(up, jnp.float32)
        np.testing.assert_array_equal(
            inject.masked_dist(torch.tensor(dist), torch.tensor(up)).numpy(),
            np.asarray(jinject.masked_dist(jnp.asarray(dist), jup)))
        for av in (None, avail):
            want = int(jinject.orphan_count(
                jnp.asarray(dist), jup, radius,
                None if av is None else jnp.asarray(av)))
            got = inject.orphan_count(torch.tensor(dist), torch.tensor(up),
                                      radius,
                                      None if av is None else torch.tensor(av))
            assert got.dtype == torch.int32 and int(got) == want, (up, av)


@pytest.mark.parametrize("fault_kw", [
    dict(uplink_p_loss=0.1, uplink_loss_slope=0.2),
    dict(uplink_p_loss=0.95, uplink_loss_slope=0.4)])
def test_uplink_loss_and_crashes_match_reference(fault_kw):
    jf, pf = JFaultSpec(**fault_kw, client_p_crash=0.3), \
        FaultSpec(**fault_kw, client_p_crash=0.3)
    rng = np.random.default_rng(1)
    gains = (rng.exponential(size=(N, M)) * 1e-9).astype(np.float32)
    active = rng.uniform(size=N) > 0.3
    for up in ([1.0, 1.0], [0.0, 1.0]):
        jup = jnp.asarray(up, jnp.float32)
        want_p = np.asarray(jinject.uplink_loss_prob(jf, jnp.asarray(gains),
                                                     jup))
        got_p = inject.uplink_loss_prob(pf, torch.tensor(gains),
                                        torch.tensor(up))
        np.testing.assert_allclose(got_p.numpy(), want_p, rtol=FLOAT_RTOL)
        assert float(got_p.max()) <= 0.95
        for seed in range(4):
            key, u = _key_u(seed, (N,))
            want = np.asarray(jinject.draw_losses(
                jf, key, jnp.asarray(gains), jup, jnp.asarray(active)))
            got = inject.draw_losses(pf, u, torch.tensor(gains),
                                     torch.tensor(up), torch.tensor(active))
            np.testing.assert_array_equal(got.numpy(), want)
            want = np.asarray(jinject.draw_crashes(jf, key,
                                                   jnp.asarray(active)))
            got = inject.draw_crashes(pf, u, torch.tensor(active))
            np.testing.assert_array_equal(got.numpy(), want)


def _rand_deltas(seed, lead=(N,)):
    rng = np.random.default_rng(seed)
    shapes = {"w1": (8, 6), "b1": (6,), "w2": (6, 5), "b2": (5,),
              "w3": (5, 3), "b3": (3,)}
    return {k: (0.3 * rng.standard_normal(lead + s)).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("poison_nan", [False, True], ids=["scale", "nan"])
def test_poison_deltas_matches_reference(poison_nan):
    kw = dict(p_poison=0.4, poison_scale=1e6, poison_nan=poison_nan)
    jf, pf = JFaultSpec(**kw), FaultSpec(**kw)
    d = _rand_deltas(2)
    produced = np.arange(N) % 3 != 0
    key, u = _key_u(5, (N,))
    want, jpois = jinject.poison_deltas(
        jf, key, {k: jnp.asarray(v) for k, v in d.items()},
        jnp.asarray(produced))
    got, pois = inject.poison_deltas(
        pf, u, {k: torch.tensor(v) for k, v in d.items()},
        torch.tensor(produced))
    np.testing.assert_array_equal(pois.numpy(), np.asarray(jpois))
    assert 0 < int(pois.sum()) < N
    for k in d:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      k)


@pytest.mark.parametrize("base,factor", [(2.0, 2.0), (0.1, 3.0),
                                         (1.5, 1.7)])
def test_backoff_matches_reference(base, factor):
    jf = JFaultSpec(backoff_base_s=base, backoff_factor=factor)
    pf = FaultSpec(backoff_base_s=base, backoff_factor=factor)
    att = np.arange(8, dtype=np.int32)
    want = np.asarray(jinject.backoff_s(jf, jnp.asarray(att)))
    got = inject.backoff_s(pf, torch.tensor(att))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=FLOAT_RTOL)
    if factor == 2.0:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("clip", [100.0, 0.5])
def test_quarantine_matches_reference(clip):
    """NaN and Inf rows rejected, big rows clipped, the rest untouched:
    the masks and counts exactly, the cleaned tree at rtol 1e-6 (the norm
    sums its leaves in the reference's sorted-key order)."""
    d = _rand_deltas(3)
    d["w2"][1, 0, 0] = np.nan
    d["b3"][4, 1] = np.inf
    d["w1"][6] *= 1e4
    produced = np.arange(N) % 5 != 2
    want, jok, jrej = jguard.quarantine(
        {k: jnp.asarray(v) for k, v in d.items()}, jnp.asarray(produced),
        clip)
    got, ok, rej = guard.quarantine({k: torch.tensor(v) for k, v in d.items()},
                                    torch.tensor(produced), clip)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert rej.dtype == torch.int32 and int(rej) == int(jrej) == 2
    for k in d:
        assert bool(torch.isfinite(got[k]).all()), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=FLOAT_RTOL, atol=1e-30, err_msg=k)
    norms = guard.delta_norms({k: torch.tensor(v) for k, v in d.items()})
    np.testing.assert_allclose(
        norms.numpy(), np.asarray(jguard.delta_norms(
            {k: jnp.asarray(v) for k, v in d.items()})), rtol=FLOAT_RTOL)


def test_quarantine_over_a_seed_axis_is_per_seed():
    d = {k: torch.tensor(v) for k, v in _rand_deltas(4, (2, N)).items()}
    d["w1"][1, 3, 0, 0] = float("nan")
    produced = torch.ones((2, N), dtype=torch.bool)
    clean, ok, rej = guard.quarantine(d, produced, 0.5)
    for s in range(2):
        c1, o1, r1 = guard.quarantine({k: v[s] for k, v in d.items()},
                                      produced[s], 0.5)
        assert torch.equal(ok[s], o1) and int(rej[s]) == int(r1)
        for k in d:
            assert torch.equal(clean[k][s], c1[k]), k
    np.testing.assert_array_equal(rej.numpy(), [0, 1])


@pytest.mark.parametrize("case", ["some", "none"])
def test_faulted_cloud_aggregate_matches_reference(case):
    rng = np.random.default_rng(6)
    g = {k: v[0] for k, v in _rand_deltas(7, (1,)).items()}
    d = _rand_deltas(8)
    assoc = np.zeros((N, M), np.float32)
    assoc[np.arange(N), np.arange(N) % M] = 1.0
    ok = rng.uniform(size=N) > 0.4 if case == "some" else np.zeros(N, bool)
    assoc_eff = assoc * ok[:, None]
    counts = rng.integers(60, 120, N).astype(np.float32)
    z = np.asarray([1.0, 0.0], np.float32) if case == "some" else \
        np.ones(M, np.float32)
    want = jaggregation.faulted_cloud_aggregate(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in d.items()}, jnp.asarray(assoc_eff),
        jnp.asarray(counts), jnp.asarray(z))
    got = aggregation.faulted_cloud_aggregate(
        {k: torch.tensor(v)[None] for k, v in g.items()},
        {k: torch.tensor(v)[None] for k, v in d.items()},
        torch.tensor(assoc_eff)[None], torch.tensor(counts)[None],
        torch.tensor(z)[None])
    for k in g:
        if case == "none":      # no surviving data: bit for bit unchanged
            np.testing.assert_array_equal(got[k][0].numpy(), g[k], k)
            np.testing.assert_array_equal(np.asarray(want[k]), g[k], k)
        else:
            assert not np.array_equal(got[k][0].numpy(), g[k]), k
            np.testing.assert_allclose(got[k][0].numpy(),
                                       np.asarray(want[k]),
                                       rtol=FLOAT_RTOL, atol=1e-7,
                                       err_msg=k)


# -- trajectories against the reference --------------------------------------

def _assert_sync_round(state, out, jstate, jout, n_test, msg, trace=True):
    (m, tr), (jm, jtr) = (out, jout) if trace else ((out, None),
                                                    (jout, None))
    got, want = engine.metrics_row(m), jengine.metrics_row(jm)
    np.testing.assert_array_equal(got["z"], want["z"], msg)
    for k in ("round", "n_associated", "n_available", "avg_staleness"):
        assert got[k] == want[k], (msg, k)
    for k in ("cost", "total_time_s", "total_energy_j"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   err_msg=f"{msg} {k}")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4,
                               err_msg=msg)
    assert abs(got["accuracy"] - want["accuracy"]) <= 2.0 / n_test, msg
    if trace:
        _assert_trace(tr, jtr, msg)
    np.testing.assert_array_equal(state.staleness.numpy(),
                                  np.asarray(jstate.staleness), msg)
    _assert_faults(state.faults, jstate.faults, msg)
    _assert_params(state.global_params, jstate.global_params,
                   f"{msg} global")


def _run_both(jspec, spec, jstate, jbundle, state, bundle, steps, label,
              buffered=False):
    """``steps`` rounds (micro-steps) of the reference's ``round_step_jit``
    and the port's ``round_step`` on the reference's draws, held each
    step.  Returns both final states and the port's outputs."""
    n_test = int(jbundle.test_y.shape[0])
    outs = []
    # the reference's carry normalised as its round does first thing, so
    # ``round_step_jit`` compiles once (not again for the carried state)
    jstate = jengine.ensure_carry(JSMALL, jspec, jstate)
    for i in range(steps):
        draws = _draws(jspec, jstate, jbundle)
        jstate, jout = jengine.round_step_jit(JSMALL, jspec, jstate, jbundle)
        state, out = engine.round_step(SMALL, spec, state, bundle, draws)
        msg = f"{label} step {i}"
        if buffered:
            _assert_step(state, out, jstate, jout, n_test, msg)
            _assert_faults(state.faults, jstate.faults, msg)
        else:
            _assert_sync_round(state, out, jstate, jout, n_test, msg,
                               trace=spec.telemetry)
        outs.append(out)
    return jstate, state, outs


def _total(outs, leaf):
    return sum(int(getattr(tr, leaf)) for _, tr in outs)


def test_sync_chaos_dense_matches_reference():
    """gcea + fastest under chaos, 4 rounds: every fault process acts
    (asserted) and each round's decisions, bill, trace and fault state
    equal the reference's."""
    jspec, spec = _specs(SYNC_KW, CHAOS, telemetry=True)
    jstate, jbundle, state, bundle = _scenario_start(JSMALL, 0, None)
    jstate, state, outs = _run_both(jspec, spec, jstate, jbundle, state,
                                    bundle, ROUNDS, "chaos")
    flt = state.faults
    assert int(flt.n_dropped) > 0 and int(flt.n_quarantined) > 0
    assert int(flt.n_retries) == 0           # sync: nothing to retry from
    assert _total(outs, "dead_edges") > 0, "the churn never killed an edge"


def test_sync_dead_edge_on_the_frontier_matches_reference():
    """fcea + PDD at K = 2 with edge 0 dead and the churn frozen: the
    frontier marks its slots invalid, nobody is admitted there, and the
    trace (valid share, load, orphans) equals the reference's."""
    jspec, spec = _specs(dict(policy="fcea", scheduler="pdd"), FROZEN,
                         telemetry=True, candidates_k=2)
    jstate, jbundle, state, bundle = _scenario_start(JSMALL, 0, None)
    jstate, state = _jkill(jstate, jspec, 0), _kill(state, spec, 0)
    _, _, outs = _run_both(jspec, spec, jstate, jbundle, state, bundle,
                           ROUNDS, "K=2 dead edge")
    for m, tr in outs:
        assert int(tr.edge_load[0]) == 0 and int(tr.dead_edges) == 1
        assert float(m.z[0]) == 0.0
    assert _total(outs, "orphaned_clients") > 0


def test_sync_all_nan_poison_keeps_both_global_models():
    """Every delivered delta NaN-poisoned: both packages quarantine all of
    them, and both global models stay bit for bit where they started."""
    kw = dict(**FROZEN, p_poison=1.0, poison_nan=True)
    jspec, spec = _specs(SYNC_KW, kw)
    jstate, jbundle, state, bundle = _scenario_start(JSMALL, 0, None)
    g0 = {k: v.clone() for k, v in state.global_params.items()}
    jg0 = jstate.global_params
    jstate, state, _ = _run_both(jspec, spec, jstate, jbundle, state, bundle,
                                 ROUNDS, "all-NaN")
    for k in g0:
        assert torch.equal(state.global_params[k], g0[k]), k
        np.testing.assert_array_equal(np.asarray(jstate.global_params[k]),
                                      np.asarray(jg0[k]), k)
    assert int(state.faults.n_quarantined) > 0


def test_sync_scaled_poison_clipped_matches_reference():
    """Deltas scaled 1e6 and clipped to norm 1: the merged model follows
    the reference's at PARAM_TOL (the clip scale is the norm's ratio)."""
    kw = dict(**FROZEN, p_poison=1.0, poison_scale=1e6, quarantine_clip=1.0)
    jspec, spec = _specs(SYNC_KW, kw)
    jstate, jbundle, state, bundle = _scenario_start(JSMALL, 0, None)
    g0 = state.global_params
    _, state, _ = _run_both(jspec, spec, jstate, jbundle, state, bundle, 2,
                            "clip")
    assert int(state.faults.n_quarantined) == 0
    assert any(not torch.equal(state.global_params[k], g0[k]) for k in g0)


def test_sync_markov_dropout_with_churn_matches_reference():
    kw = dict(edge_p_kill=0.3, edge_p_respawn=0.5, client_p_crash=0.1)
    jspec, spec = _specs(SYNC_KW, kw, telemetry=True, scenario="dynamic")
    jstate, jbundle, state, bundle = _scenario_start(JSMALL, 0,
                                                     "markov_dropout")
    _, state, _ = _run_both(jspec, spec, jstate, jbundle, state, bundle,
                            ROUNDS, "markov_dropout")
    assert int(state.faults.n_crashed) > 0


def test_buffered_chaos_matches_reference():
    """``SPEC_BUF`` under chaos, 24 micro-steps: the buffer, the fault
    state and the trace each micro-step."""
    jspec, spec = _specs(BUF_KW, CHAOS, telemetry=True)
    jstate, jbundle, state, bundle = _scenario_start(JSMALL, 0, None)
    _, state, outs = _run_both(jspec, spec, jstate, jbundle, state, bundle,
                               24, "buffered chaos", buffered=True)
    flt = state.faults
    assert int(flt.n_retries) > 0 and int(flt.n_crashed) > 0
    assert int(state.buffer.version) > 0


def test_buffered_retries_then_drops_matches_reference():
    kw = dict(**FROZEN, uplink_p_loss=0.95, max_attempts=2,
              backoff_base_s=0.1)
    jspec, spec = _specs(BUF_KW, kw, telemetry=True)
    jstate, jbundle, state, bundle = _scenario_start(JSMALL, 0, None)
    _, state, _ = _run_both(jspec, spec, jstate, jbundle, state, bundle, 16,
                            "retries", buffered=True)
    flt = state.faults
    assert int(flt.n_retries) > 0 and int(flt.n_dropped) > 0
    assert int(flt.attempts.max()) <= 2


def test_buffered_min_participation_matches_reference():
    kw = dict(**FROZEN, min_participation=N + 1)
    jspec, spec = _specs(BUF_KW, kw, telemetry=True)
    jstate, jbundle, state, bundle = _scenario_start(JSMALL, 0, None)
    _, state, outs = _run_both(jspec, spec, jstate, jbundle, state, bundle,
                               12, "min_participation", buffered=True)
    assert int(state.buffer.version) == 0
    assert any(int(tr.trigger_cause) > 0 for _, tr in outs)


def test_fleet_chaos_matches_reference_run_fleet():
    """A fleet of 2 under chaos (gcea + fastest, telemetry) against the
    reference's ``run_fleet``, each lane's draws replayed from its own key
    chain: each round's decisions, bill and fault leaves, and the final
    fault state of each seed."""
    jspec, spec = _specs(SYNC_KW, CHAOS, telemetry=True)
    starts = [_scenario_start(JSMALL, s, None) for s in (0, 1)]
    jstates, jbundles = jengine.stack_fleet([(a, b) for a, b, _, _ in starts])
    states, bundles = engine.stack_fleet([(c, d) for _, _, c, d in starts])
    jfinal, (jm, jtr) = jengine.run_fleet(JSMALL, jspec, jstates, jbundles,
                                          ROUNDS)
    keys = [jstates.key[s] for s in (0, 1)]
    n_test = int(jbundles.test_y.shape[1])
    for r in range(ROUNDS):
        rows = [_draws(jspec, SimpleNamespace(key=keys[s]),
                       jax.tree.map(lambda a: a[s], jbundles))
                for s in (0, 1)]
        draws = engine._map(lambda *t: torch.stack(t), *rows)
        keys = [jengine.round_keys(jspec, k)[0] for k in keys]
        states, (m, tr) = engine.fleet_step(SMALL, spec, states, bundles,
                                            draws)
        for s in (0, 1):
            want = jengine.metrics_row(jax.tree.map(lambda a: a[s], jm), r)
            got = engine.metrics_row(engine.select_seed(m, s))
            msg = f"seed {s} round {r}"
            np.testing.assert_array_equal(got["z"], want["z"], msg)
            for k in ("n_associated", "avg_staleness"):
                assert got[k] == want[k], (msg, k)
            np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-5)
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
            assert abs(got["accuracy"] - want["accuracy"]) <= 2.0 / n_test
            _assert_trace(engine.select_seed(tr, s),
                          jax.tree.map(lambda a: a[s, r], jtr), msg)
    _assert_faults(states.faults, jfinal.faults, "final")
    np.testing.assert_array_equal(states.staleness.numpy(),
                                  np.asarray(jfinal.staleness))


# -- the reference's own cases, on the port ----------------------------------

SPEC_SYNC = engine.EngineSpec(**SYNC_KW)
SPEC_BUF = engine.EngineSpec(**BUF_KW)


def _faulted(spec, **kw):
    return dataclasses.replace(spec, faults=FaultSpec(**kw))


def _init(seed=0):
    return engine.init_simulation(SMALL, seed=seed, device="cpu")


def _run(spec, state, bundle, n, seed=0):
    return engine.run_scanned(SMALL, spec, state, bundle, n,
                              torch.Generator().manual_seed(seed))


def test_ensure_carry_attaches_and_strips_fault_state():
    spec_f = _faulted(SPEC_SYNC, edge_p_kill=0.3)
    state, _, _ = _init()
    with_f = engine.ensure_carry(SMALL, spec_f, state)
    assert isinstance(with_f.faults, FaultState)
    assert with_f.faults.edge_up.shape == (M,)
    assert with_f.faults.attempts.dtype == torch.int32
    stripped = engine.ensure_carry(SMALL, SPEC_SYNC, with_f)
    assert stripped.faults is None
    assert engine.ensure_carry(SMALL, SPEC_SYNC, state) is state
    assert engine.ensure_carry(SMALL, spec_f, with_f) is with_f
    # a buffered faulted spec attaches both parts; a fleet's are per seed
    both = engine.ensure_carry(SMALL, _faulted(SPEC_BUF), state)
    assert both.buffer is not None and both.faults is not None
    pairs = [_init(s)[:2] for s in (0, 1)]
    states, _ = engine.stack_fleet(pairs)
    fleet = engine.ensure_carry(SMALL, spec_f, states)
    assert fleet.faults.edge_up.shape == (2, M)
    assert fleet.faults.n_dropped.shape == (2,)


def test_no_fault_run_ignores_stale_fault_state():
    state, bundle, _ = _init()
    stale = engine.ensure_carry(SMALL, _faulted(SPEC_SYNC), state)
    f_clean, ms_clean = _run(SPEC_SYNC, state, bundle, ROUNDS)
    f_stale, ms_stale = _run(SPEC_SYNC, stale, bundle, ROUNDS)
    engine._map(lambda a, b: torch.equal(a, b) or pytest.fail("metrics"),
                ms_clean, ms_stale)
    assert f_stale.faults is None
    for k in f_clean.global_params:
        assert torch.equal(f_clean.global_params[k],
                           f_stale.global_params[k]), k


def test_sample_draws_adds_fault_uniforms_last():
    """With faults off no fault uniform is drawn; with them on, the four
    come after every other draw, so the rest of the stream is today's."""
    spec_f = _faulted(SPEC_SYNC, edge_p_kill=0.2)
    _, bundle, _ = _init()
    base = engine.sample_draws(SMALL, bundle,
                               torch.Generator().manual_seed(3), SPEC_SYNC)
    gen = torch.Generator().manual_seed(3)
    both = engine.sample_draws(SMALL, bundle, gen, spec_f)
    assert base.faults is None
    assert torch.equal(base.fading, both.fading)
    assert torch.equal(base.batch_idx, both.batch_idx)
    shapes = [tuple(u.shape) for u in both.faults]
    assert shapes == [(M,), (N,), (N,), (N,)]
    # the fault uniforms are the next four draws of the same generator
    again = torch.Generator().manual_seed(3)
    engine.sample_draws(SMALL, bundle, again, SPEC_SYNC)
    assert torch.equal(torch.rand((M,), generator=again), both.faults.edge_u)


def test_a_faulted_round_keeps_the_unfaulted_fading_and_lattice():
    """From one generator state, a faulted round draws the unfaulted
    round's fading and lattice; with faults that never fire (no churn,
    all probabilities 0) it makes the same decisions and bill, and the
    same model up to the delta-space merge's rounding.  (Over a run the
    four extra uniforms a round shift the later rounds' draws: the
    reference's fold_in stream consumes no split, a generator does.)"""
    spec_f = _faulted(SPEC_SYNC, **FROZEN)
    state, bundle, _ = _init()
    s0, m0 = _run(SPEC_SYNC, state, bundle, 1, seed=5)
    s1, m1 = _run(spec_f, state, bundle, 1, seed=5)
    assert torch.equal(m0.z, m1.z) and torch.equal(m0.cost, m1.cost)
    assert torch.equal(s0.staleness, s1.staleness)
    assert torch.equal(s0.gains, s1.gains)
    for k in s0.global_params:
        torch.testing.assert_close(s1.global_params[k], s0.global_params[k],
                                   **PARAM_TOL)
    assert int(s1.faults.n_dropped) == 0


@pytest.mark.parametrize("candidates_k", [None, 2])
def test_dead_edge_masked_from_frontier_cohort_reforms(candidates_k):
    spec = dataclasses.replace(_faulted(SPEC_SYNC, **FROZEN),
                               telemetry=True, candidates_k=candidates_k)
    state, bundle, _ = _init()
    state = _kill(state, spec, 0)
    final, (ms, tr) = _run(spec, state, bundle, ROUNDS)
    load = tr.edge_load.numpy()
    assert np.all(load[:, 0] == 0), "dead edge admitted clients"
    assert np.all(load[:, 1] > 0), "cohort failed to re-form on survivor"
    np.testing.assert_array_equal(tr.dead_edges.numpy(), ROUNDS * [1])
    assert bool((ms.n_associated > 0).all())
    assert bool(torch.isfinite(ms.loss).all())
    np.testing.assert_array_equal(final.faults.edge_up.numpy(), [0., 1.])
    # the snapshot routes around the dead edge as the round does
    snap = engine.associate_snapshot(SMALL, spec, final, bundle)
    assert float(snap[:, 0].sum()) == 0.0 and float(snap.sum()) > 0


def test_scaled_poison_clipped_to_quarantine_sphere():
    clip = 1.0
    spec = _faulted(SPEC_SYNC, **FROZEN, p_poison=1.0, poison_scale=1e6,
                    quarantine_clip=clip)
    state, bundle, aux = _init()
    gen = aux["generator"]
    prev, moved = state.global_params, 0.0
    for _ in range(2):
        state, _ = engine.run_scanned(SMALL, spec, state, bundle, 1, gen)
        step = float(torch.sqrt(sum(
            torch.sum((state.global_params[k] - prev[k]) ** 2)
            for k in prev)))
        assert step <= clip * (1.0 + 1e-4), "delta escaped the clip sphere"
        moved = max(moved, step)
        prev = state.global_params
    assert moved > 0.0
    assert int(state.faults.n_quarantined) == 0


def test_buffered_uplink_loss_retries_then_drops():
    spec = _faulted(SPEC_BUF, **FROZEN, uplink_p_loss=0.95, max_attempts=2,
                    backoff_base_s=0.1)
    state, bundle, _ = _init()
    final, ms = _run(spec, state, bundle, 32)
    flt = final.faults
    assert int(flt.n_retries) > 0 and int(flt.n_dropped) > 0
    assert int(flt.attempts.max()) <= 2
    assert bool(torch.isfinite(ms.loss).all())


def test_buffered_moderate_loss_still_merges():
    spec = _faulted(SPEC_BUF, **FROZEN, uplink_p_loss=0.3, max_attempts=3)
    state, bundle, _ = _init()
    final, _ = _run(spec, state, bundle, 24)
    assert int(final.buffer.version) > 0
    assert int(final.faults.n_retries) > 0


def test_buffered_min_participation_blocks_merge():
    spec = _faulted(SPEC_BUF, **FROZEN, min_participation=N + 1)
    state, bundle, _ = _init()
    final, _ = _run(spec, state, bundle, 16)
    assert int(final.buffer.version) == 0
    assert float(final.buffer.clock_s) > 0.0


def test_buffered_all_nan_poison_keeps_the_global_model():
    spec = _faulted(SPEC_BUF, **FROZEN, p_poison=1.0, poison_nan=True)
    state, bundle, _ = _init()
    final, ms = _run(spec, state, bundle, 12)
    for k, g in state.global_params.items():
        assert torch.equal(final.global_params[k], g), k
    assert int(final.faults.n_quarantined) > 0
    assert int(final.buffer.version) == 0
    assert bool(torch.isfinite(ms.loss).all())


@pytest.mark.parametrize("mode", ["sync", "buffered"])
def test_faults_through_the_fleet_and_the_sinks(mode, tmp_path):
    """``run_fleet`` and ``run_fleet_actors`` under faults carry a
    FaultState per seed, and the JSONL tee writes the fault leaves."""
    from repro_torch.telemetry import sink
    spec = dataclasses.replace(SPEC_SYNC if mode == "sync" else SPEC_BUF,
                               faults=FaultSpec(**CHAOS), telemetry=True)
    pairs = [_init(s)[:2] for s in (0, 1)]
    states, bundles = engine.stack_fleet(pairs)
    gens = [torch.Generator().manual_seed(s) for s in (0, 1)]
    final, (ms, tr) = engine.run_fleet(SMALL, spec, states, bundles, 3, gens)
    assert final.faults.edge_up.shape == (2, M)
    assert tr.dead_edges.shape == (2, 3)
    for s in (0, 1):
        own, (_, tr_s) = engine.run_scanned(
            SMALL, spec, pairs[s][0], pairs[s][1], 3,
            torch.Generator().manual_seed(s))
        for name in ("edge_up", "n_dropped", "n_quarantined"):
            assert torch.equal(getattr(final.faults, name)[s],
                               getattr(own.faults, name)), (s, name)
        assert torch.equal(tr.uplink_dropped[s], tr_s.uplink_dropped)
    path = tmp_path / "t.jsonl"
    with sink.JsonlSink(str(path)) as js:
        _, _, tr0 = sink.stream_scanned(SMALL, spec, pairs[0][0],
                                        pairs[0][1], 3, js,
                                        torch.Generator().manual_seed(0))
    back = sink.load_jsonl(str(path))
    for name in ("dead_edges", "orphaned_clients", "uplink_retries",
                 "uplink_dropped", "quarantined"):
        np.testing.assert_array_equal(back[name], getattr(tr0, name).numpy(),
                                      name)


@pytest.mark.parametrize("mode", ["sync", "buffered"])
@pytest.mark.parametrize("k", [None, 2], ids=["dense", "k2"])
@pytest.mark.parametrize("world", ["static", "full_dynamic"])
def test_a_dead_edge_on_every_path(mode, k, world):
    """Edge 0 dead (churn frozen) beside crashes and NaN poisoning, through
    both engines, dense and on the frontier, static and moving: nobody is
    admitted to it, the trace counts it, and the run stays finite; a fleet
    of 2 billed by one DDPG actor a seed (``run_fleet_actors``) too."""
    from repro_torch.core import ddpg
    kw = dict(FROZEN, client_p_crash=0.2, p_poison=0.3, poison_nan=True)
    spec = engine.EngineSpec(
        policy="fcea", scheduler="fastest", engine_mode=mode, candidates_k=k,
        telemetry=True, faults=FaultSpec(**kw),
        scenario="static" if world == "static" else "dynamic",
        allocator="ddpg")
    pairs = [engine.init_simulation(
        SMALL, seed=s, device="cpu",
        scenario=None if world == "static" else world)[:2] for s in (0, 1)]
    states, bundles = engine.stack_fleet(pairs)
    states = _kill(states, spec, 0)
    dcfg = ddpg.allocator_config(SMALL, spec, hidden=8)
    actors = engine._map(lambda *t: torch.stack(t), *(
        ddpg.init_ddpg(torch.Generator().manual_seed(s), dcfg).actor
        for s in (0, 1)))
    gens = [torch.Generator().manual_seed(s) for s in (0, 1)]
    final, (ms, tr) = engine.run_fleet_actors(SMALL, spec, states, bundles,
                                              4, gens, actors)
    assert bool((tr.edge_load[..., 0] == 0).all())
    assert bool((tr.dead_edges == 1).all())
    assert bool((ms.n_associated > 0).any())
    assert bool(torch.isfinite(ms.loss).all())
    assert bool(torch.isfinite(ms.cost).all())
    for g in final.global_params.values():
        assert bool(torch.isfinite(g).all())
    np.testing.assert_array_equal(final.faults.edge_up.numpy(),
                                  [[0.0, 1.0], [0.0, 1.0]])
    snap = engine.fleet_snapshot(SMALL, spec, final, bundles)
    assert float(snap[..., 0].sum()) == 0.0

"""The port's warm-started round engine held to the JAX reference on the
CPU: sync rounds dense and at K = 2, buffered micro-steps, faulted rounds
and a fleet of three, each against the reference's ``round_step_jit`` or
``run_fleet`` with its draws replayed (``test_torch_scenarios._round_draws``,
each fleet lane from its own key chain).  Decisions, the ``warm`` leaf,
staleness and the sweeps (the metrics' and the trace's ``assoc_sweeps``)
exact; the bill at rtol 1e-5, the loss at rtol 1e-4, the accuracy within
2 test samples (the tolerances of ``tests/test_torch_engine.py``); the
buffered engine's leaves at ``test_torch_buffered``'s tolerances.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro_torch.core import engine
from test_torch_buffered import SPEC_KW, _assert_buffer, _assert_step
from test_torch_engine import JSMALL, SMALL
from test_torch_faults import CHAOS, SYNC_KW, _assert_sync_round, _draws, \
    _specs
from test_torch_scenarios import _round_draws
from test_torch_scenarios import _start as _scenario_start
from test_torch_warm import ROUNDS, WORLD, _check_round
from test_torch_warm import fallback_flags  # noqa: F401  (a fixture)
from _torch_threads import one_torch_thread  # noqa: F401


WARM_CASES = [
    pytest.param(dict(policy="fcea", scheduler="pdd"), id="fcea-pdd-dense"),
    pytest.param(dict(policy="gcea", scheduler="fastest", candidates_k=2),
                 id="gcea-fastest-k2")]


@pytest.mark.parametrize("kw", WARM_CASES)
def test_run_scanned_warm_matches_reference(kw):
    """6 random_waypoint rounds warm against the reference, its draws
    replayed: each round's decisions, the warm leaf and the sweeps (warm
    plus fallback) exact, and the fallback seen to fire and to be
    skipped."""
    spec_kw = dict(scenario="dynamic", warm_start=True, telemetry=True, **kw)
    jspec = jengine.EngineSpec(**spec_kw)
    spec = engine.EngineSpec(**spec_kw)
    jstate, jbundle, state, bundle = _scenario_start(JSMALL, 0, WORLD)
    # the reference's carry normalised as its round does first thing, so
    # ``round_step_jit`` compiles once (not again for the carried state)
    jstate = jengine.ensure_carry(JSMALL, jspec, jstate)
    n_test = int(jbundle.test_y.shape[0])
    sweeps = []
    for r in range(ROUNDS):
        draws = _round_draws(JSMALL, jspec, jstate, jbundle)
        jstate, jout = jengine.round_step_jit(JSMALL, jspec, jstate, jbundle)
        state, (m, tr) = engine.round_step(SMALL, spec, state, bundle, draws)
        _check_round(state, m, tr, jstate, jout, n_test, f"round {r}")
        sweeps.append(m.sweeps)
    assert len(set(sweeps)) > 1, sweeps


def test_buffered_warm_matches_reference():
    """The buffered engine warm (the tier-eligible mask is the seeds'
    availability, so in-flight and other-tier clients drop theirs), 12
    micro-steps against the reference: the buffer, the trace and the
    warm leaf each micro-step."""
    jspec = jengine.EngineSpec(**SPEC_KW, warm_start=True)
    spec = engine.EngineSpec(**SPEC_KW, warm_start=True)
    jstate, jbundle, state, bundle = _scenario_start(JSMALL, 0, None)
    # the reference's carry normalised as its round does first thing, so
    # ``round_step_jit`` compiles once (not again for the carried state)
    jstate = jengine.ensure_carry(JSMALL, jspec, jstate)
    n_test = int(jbundle.test_y.shape[0])
    for i in range(12):
        draws = _round_draws(JSMALL, jspec, jstate, jbundle)
        jstate, jout = jengine.round_step_jit(JSMALL, jspec, jstate, jbundle)
        state, out = engine.round_step(SMALL, spec, state, bundle, draws)
        msg = f"micro-step {i}"
        _assert_step(state, out, jstate, jout, n_test, msg)
        _assert_buffer(state.buffer, jstate.buffer, msg)
        assert out[0].sweeps == int(jout[1].assoc_sweeps), msg
        np.testing.assert_array_equal(state.warm.numpy(),
                                      np.asarray(jstate.warm), msg)


@pytest.mark.parametrize("candidates_k", [None, 2])
def test_faulted_warm_round_matches_reference(candidates_k):
    """Warm under chaos (edge churn moves seeds onto dead edges, which the
    dense path's masked distances and the frontier's invalid slots drop),
    4 rounds: decisions, trace, fault state and warm leaf exact."""
    jspec, spec = _specs(SYNC_KW, CHAOS, telemetry=True, warm_start=True,
                         candidates_k=candidates_k)
    jstate, jbundle, state, bundle = _scenario_start(JSMALL, 0, None)
    # the reference's carry normalised as its round does first thing, so
    # ``round_step_jit`` compiles once (not again for the carried state)
    jstate = jengine.ensure_carry(JSMALL, jspec, jstate)
    n_test = int(jbundle.test_y.shape[0])
    for r in range(4):
        draws = _draws(jspec, jstate, jbundle)
        jstate, jout = jengine.round_step_jit(JSMALL, jspec, jstate, jbundle)
        state, out = engine.round_step(SMALL, spec, state, bundle, draws)
        msg = f"chaos warm round {r}"
        _assert_sync_round(state, out, jstate, jout, n_test, msg)
        assert out[0].sweeps == int(jout[1].assoc_sweeps), msg
        np.testing.assert_array_equal(state.warm.numpy(),
                                      np.asarray(jstate.warm), msg)


def test_fleet_warm_matches_reference_run_fleet(fallback_flags):
    """Three random_waypoint worlds warm as one fleet against the
    reference's ``run_fleet``, each lane's draws replayed from its own key
    chain: each seed's decisions, sweeps and warm leaf as the reference's
    lanes, with a round in which one seed falls back and another does
    not."""
    kw = dict(policy="gcea", scheduler="fastest", scenario="dynamic",
              warm_start=True, telemetry=True)
    jspec, spec = jengine.EngineSpec(**kw), engine.EngineSpec(**kw)
    starts = [_scenario_start(JSMALL, s, WORLD) for s in (0, 1, 2)]
    jstates, jbundles = jengine.stack_fleet([(a, b) for a, b, _, _ in starts])
    states, bundles = engine.stack_fleet([(c, d) for _, _, c, d in starts])
    jfinal, (jm, jtr) = jengine.run_fleet(JSMALL, jspec, jstates, jbundles,
                                          ROUNDS)
    keys = [jstates.key[s] for s in (0, 1, 2)]
    for r in range(ROUNDS):
        rows = [_round_draws(JSMALL, jspec, SimpleNamespace(key=keys[s]),
                             jax.tree.map(lambda a: a[s], jbundles))
                for s in (0, 1, 2)]
        draws = engine._map(lambda *t: torch.stack(t), *rows)
        keys = [jengine.round_keys(jspec, k)[0] for k in keys]
        states, (m, tr) = engine.fleet_step(SMALL, spec, states, bundles,
                                            draws)
        for s in (0, 1, 2):
            want = jengine.metrics_row(jax.tree.map(lambda a: a[s], jm), r)
            got = engine.metrics_row(engine.select_seed(m, s))
            msg = f"seed {s} round {r}"
            np.testing.assert_array_equal(got["z"], want["z"], msg)
            assert got["n_associated"] == want["n_associated"], msg
            assert got["sweeps"] == int(jtr.assoc_sweeps[s, r]), msg
            np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-5)
            np.testing.assert_array_equal(tr.assoc_sweeps[s].numpy(),
                                          np.asarray(jtr.assoc_sweeps[s, r]))
    np.testing.assert_array_equal(states.warm.numpy(),
                                  np.asarray(jfinal.warm))
    np.testing.assert_array_equal(states.staleness.numpy(),
                                  np.asarray(jfinal.staleness))
    assert len(fallback_flags) == ROUNDS
    assert any(len(set(f)) > 1 for f in fallback_flags), fallback_flags

"""The port's buffered engine (``EngineSpec(engine_mode="buffered")``, the
semi-async FedBuff micro-step with TiFL tiers) held to a live run of the
JAX reference's, then the reference's own buffered unit tests on the port.

Both sides start from the reference's ``init_simulation`` state; the port
replays the reference's draws each micro-step (the buffered step keeps
the sync round's ``round_keys`` layout, ``tests/test_torch_engine.py``).
Each micro-step every ``BufferState`` leaf is compared:
``in_flight``, ``tier``, ``pulled_ver``, ``fill``, ``version`` and
``step`` exactly, the clock, finish times, duration EMA and weights at
``TIME_RTOL``, the deltas and params at ``PARAM_TOL``; and the metrics
(decisions exactly, the bill at rtol 1e-5) and the whole trace as
``tests/test_torch_telemetry.py`` holds it.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from repro.configs.hfl_mnist import CONFIG as JCONFIG
from repro.core import engine as jengine
from repro_torch import convert
from repro_torch.configs.hfl_mnist import CONFIG
from repro_torch.core import aggregation, engine, staleness
from repro_torch.telemetry import sink
from test_torch_scenarios import _lane_draws, _round_draws
from test_torch_scenarios import _start as _scenario_start
from test_torch_engine import JSMALL, SMALL
from test_torch_telemetry import _assert_trace
from _torch_threads import one_torch_thread  # noqa: F401

SPEC_KW = dict(policy="gcea", scheduler="fastest", engine_mode="buffered",
               n_tiers=2, retier_every=3, timeout_s=5.0, telemetry=True)
SPEC_BUF = engine.EngineSpec(**SPEC_KW)
EXACT = ("in_flight", "tier", "pulled_ver", "fill", "version", "step")
# the virtual clock, finish times, duration EMA and merge weights: sums of
# the per-client bill's terms (rtol 1e-5 in the sync tests)
TIME_RTOL = 1e-5
# the deltas and params after τ₂ SGD steps and buffered merges: the sync
# tests' global-params tolerance
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _assert_params(got, want, msg, scale=1.0):
    """Params or deltas at ``PARAM_TOL``; ``scale`` (broadcast over the
    leaves' leading axes) multiplies the atol."""
    for k, leaf in got.items():
        # |g - w| <= atol·scale + rtol·|w|, as both divided by the scale
        div = np.asarray(scale, np.float64).reshape(
            np.shape(scale) + (1,) * (leaf.dim() - np.ndim(scale)))
        np.testing.assert_allclose(leaf.double().numpy() / div,
                                   np.asarray(want[k], np.float64) / div,
                                   err_msg=f"{msg} {k}", **PARAM_TOL)


def _assert_buffer(got, want, msg):
    for name in engine.BufferState._fields:
        g, w = getattr(got, name), getattr(want, name)
        if name == "pending_delta":
            _assert_params(g, w, f"{msg} {name}")
        elif name == "delta_sum":
            # Σ w·Δ over landed updates, w = D_n · age^-1/2 up to ~10^2:
            # each delta's atol, weighted
            _assert_params(g, w, f"{msg} {name}",
                           np.maximum(np.asarray(want.weight_sum), 1.0))
        elif name in EXACT:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          f"{msg} {name}")
            assert g.dtype == (torch.bool if name == "in_flight"
                               else torch.int32), name
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=TIME_RTOL, err_msg=f"{msg} {name}")


def _assert_step(state, out, jstate, jout, n_test, msg):
    (m, tr), (jm, jtr) = out, jout
    got, want = engine.metrics_row(m), jengine.metrics_row(jm)
    np.testing.assert_array_equal(got["z"], want["z"], msg)
    for k in ("round", "n_associated", "n_available", "avg_staleness"):
        assert got[k] == want[k], (msg, k)
    # the time charge is the clock's advance, a difference of two clock
    # readings: it carries the clock's own rounding (TIME_RTOL of it)
    clock_tol = TIME_RTOL * float(np.asarray(jstate.buffer.clock_s))
    np.testing.assert_allclose(got["total_energy_j"], want["total_energy_j"],
                               rtol=1e-5, err_msg=msg)
    for k, scale in (("total_time_s", 1.0), ("cost", JSMALL.lambda_t)):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   atol=clock_tol * scale,
                                   err_msg=f"{msg} {k}")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4,
                               err_msg=msg)
    assert abs(got["accuracy"] - want["accuracy"]) <= 2.0 / n_test, msg
    _assert_trace(tr, jtr, msg)
    np.testing.assert_array_equal(state.staleness.numpy(),
                                  np.asarray(jstate.staleness), msg)
    _assert_buffer(state.buffer, jstate.buffer, msg)
    _assert_params(state.global_params, jstate.global_params,
                   f"{msg} global")
    _assert_params(state.client_params, jstate.client_params,
                   f"{msg} clients")


def _run_both(jcfg, cfg, jspec, spec, jstate, jbundle, state, bundle, steps,
              label):
    """``steps`` micro-steps of the reference's ``run_scanned`` (one step a
    call) and of the port's ``round_step`` on the reference's draws, held
    step by step.  Returns both final states, the trigger causes and the
    clock's advance each micro-step."""
    n_test = int(jbundle.test_y.shape[0])
    causes, advances = [], []
    # the reference's carry normalised as ``run_scanned`` does first, so
    # its one-step program compiles once (not again for the carried state)
    jstate = jengine.ensure_carry(jcfg, jspec, jstate)
    for i in range(steps):
        draws = _round_draws(jcfg, jspec, jstate, jbundle)
        jstate, jout = jengine.run_scanned(jcfg, jspec, jstate, jbundle, 1)
        jout = jax.tree.map(lambda a: a[0], jout)
        clock = float(state.buffer.clock_s) if state.buffer is not None \
            else 0.0
        state, out = engine.round_step(cfg, spec, state, bundle, draws)
        _assert_step(state, out, jstate, jout, n_test, f"{label} step {i}")
        causes.append(int(out[1].trigger_cause))
        advances.append(float(state.buffer.clock_s) - clock)
    return jstate, state, causes, advances


def test_buffered_trajectory_matches_reference_run_scanned():
    """24 micro-steps of ``SPEC_BUF`` from seed 0, then 8 more from the
    reference's own state carried over mid-run (``convert``, buffer
    included) with its last trigger moved one timeout and one second back,
    so its deadline has passed.  At this size the fill trigger fires every
    third micro-step and the 5 s timeout never comes due on its own (the
    reference's own 48-step run has no timeout), so the window must move
    the timer to reach the timeout branch.  Asserted: fill merges, a
    timeout and retiers inside the compared window."""
    jspec = jengine.EngineSpec(**SPEC_KW)
    jstate, jbundle, state, bundle = _scenario_start(JSMALL, 0, None)
    jstate, state, causes, _ = _run_both(JSMALL, SMALL, jspec, SPEC_BUF,
                                         jstate, jbundle, state, bundle, 24,
                                         "SPEC_BUF")
    assert int(state.buffer.step) == 24
    assert not torch.equal(state.buffer.tier,
                           torch.arange(SMALL.n_clients) % 2), "no retier"
    jbuf = jstate.buffer
    jstate = jstate._replace(buffer=jbuf._replace(
        last_agg_s=jbuf.clock_s - jnp.float32(SPEC_BUF.timeout_s + 1.0)))
    snp = jax.tree.map(np.asarray, jstate._replace(key=None))
    state, bundle = convert.state_from_numpy(
        snp, jax.tree.map(np.asarray, jbundle), "cpu")
    _assert_buffer(state.buffer, jstate.buffer, "carried over")
    jstate, state, more, _ = _run_both(JSMALL, SMALL, jspec, SPEC_BUF,
                                       jstate, jbundle, state, bundle, 8,
                                       "mid-run")
    causes += more
    assert 1 in causes, f"no fill merge in the window: {causes}"
    assert 2 in causes, f"no timeout merge in the window: {causes}"
    assert int(state.buffer.step) == 32


BUFFERED_CASES = [
    pytest.param("static", dict(policy="fcea"), id="fcea-dense"),
    pytest.param("static", dict(candidates_k=2), id="gcea-k2"),
    pytest.param("static", dict(allocator="rra", policy="rcea"),
                 id="rcea-rra"),
    pytest.param("markov_dropout", dict(), id="markov_dropout"),
    # the timeout the port's trigger-reconstruction test uses: short
    # enough that the clock itself runs to the deadline
    pytest.param("static", dict(timeout_s=0.5), id="timeout-0.5"),
    # FedBuff's buffer size and server step off their defaults (SMALL's
    # automatic fill is 3; CONFIG's, 8, meets a fill of 3 below)
    pytest.param("static", dict(buffer_fill=2), id="fill-2"),
    pytest.param("static", dict(buffer_lr=0.5), id="lr-0.5"),
    pytest.param("static", dict(buffer_fill=2, buffer_lr=0.5),
                 id="fill-2-lr-0.5"),
]


@pytest.mark.parametrize("world,kw", BUFFERED_CASES)
def test_buffered_variants_match_reference(world, kw):
    """8 micro-steps of ``SPEC_BUF`` with another policy, the K = 2
    frontier, rcea + rra (their uniforms replayed), a dropout world, a
    0.5 s timeout, or a buffer fill of 2 and a server step of 0.5 alone
    and together.  With the short timeout the window must hold a timeout
    merge that the clock reached by itself: the event clock jumps to the
    deadline (dt > 0) and the trigger compares the clock with it at the
    edge.  With the fill of 2 it must hold a fill merge."""
    kind = "static" if world == "static" else "dynamic"
    spec_kw = {**SPEC_KW, **kw, "scenario": kind}
    jspec = jengine.EngineSpec(**spec_kw)
    spec = engine.EngineSpec(**spec_kw)
    jstate, jbundle, state, bundle = _scenario_start(
        JSMALL, 0, None if world == "static" else world)
    _, _, causes, advances = _run_both(JSMALL, SMALL, jspec, spec, jstate,
                                       jbundle, state, bundle, 8,
                                       f"{world} {kw}")
    if "timeout_s" in kw:
        assert any(c == 2 and dt > 0 for c, dt in zip(causes, advances)), \
            f"no timeout reached by the clock: {causes} {advances}"
    if "buffer_fill" in kw:
        assert engine.buffer_fill_for(SMALL, spec) == kw["buffer_fill"]
        assert 1 in causes, f"no fill merge in the window: {causes}"


def test_buffered_config_matches_reference():
    """6 fcea dense micro-steps at ``CONFIG`` (N = 64, default tiers and
    timeout) against the reference billed with ``sic_impl="pairwise"``."""
    kw = dict(engine_mode="buffered", telemetry=True)
    jspec = jengine.EngineSpec(sic_impl="pairwise", **kw)
    spec = engine.EngineSpec(**kw)
    jstate, jbundle, state, bundle = _scenario_start(JCONFIG, 0, None)
    _run_both(JCONFIG, CONFIG, jspec, spec, jstate, jbundle, state, bundle, 6,
              "CONFIG")


@pytest.mark.parametrize("kw", [dict(buffer_fill=3),
                                dict(buffer_fill=3, buffer_lr=0.5)],
                         ids=["fill-3", "fill-3-lr-0.5"])
def test_buffered_config_knobs_match_reference(kw):
    """6 fcea dense micro-steps at ``CONFIG`` with a buffer fill of 3 (its
    automatic fill is 8), alone and with a server step of 0.5, against
    the reference billed with ``sic_impl="pairwise"``: the fill merges
    fire at 3 updates."""
    kw = dict(engine_mode="buffered", telemetry=True, **kw)
    jspec = jengine.EngineSpec(sic_impl="pairwise", **kw)
    spec = engine.EngineSpec(**kw)
    assert engine.buffer_fill_for(CONFIG, engine.EngineSpec()) == 8
    assert engine.buffer_fill_for(CONFIG, spec) == 3
    jstate, jbundle, state, bundle = _scenario_start(JCONFIG, 0, None)
    _, _, causes, _ = _run_both(JCONFIG, CONFIG, jspec, spec, jstate,
                                jbundle, state, bundle, 6, f"CONFIG {kw}")
    assert 1 in causes, f"no fill merge: {causes}"


def test_buffered_fleet_matches_reference_run_fleet():
    """A fleet of 2 against the reference's ``run_fleet`` (``vmap`` of its
    scanned driver), each lane's draws replayed from its own key chain:
    every micro-step's metrics and trace, then the final buffers."""
    jspec = jengine.EngineSpec(**SPEC_KW)
    starts = [_scenario_start(JSMALL, s, None) for s in (0, 1)]
    jstates, jbundles = jengine.stack_fleet([(a, b) for a, b, _, _ in starts])
    states, bundles = engine.stack_fleet([(c, d) for _, _, c, d in starts])
    steps = 8
    jfinal, (jm, jtr) = jengine.run_fleet(JSMALL, jspec, jstates, jbundles,
                                          steps)
    keys = [jstates.key[s] for s in range(2)]
    n_test = int(jbundles.test_y.shape[1])
    rows = []
    for r in range(steps):
        draws = _lane_draws(jspec, keys, jbundles)
        keys = [jengine.round_keys(jspec, k)[0] for k in keys]
        states, out = engine.fleet_step(SMALL, SPEC_BUF, states, bundles,
                                        draws)
        rows.append(out)
        for s in range(2):
            got = engine.metrics_row(engine.select_seed(out[0], s))
            want = jengine.metrics_row(jax.tree.map(lambda a: a[s], jm), r)
            np.testing.assert_array_equal(got["z"], want["z"])
            for k in ("n_associated", "n_available"):
                assert got[k] == want[k], (s, r, k)
            np.testing.assert_allclose(
                got["cost"], want["cost"], rtol=1e-5,
                atol=TIME_RTOL * JSMALL.lambda_t
                * float(np.asarray(jm.total_time_s)[s, :r + 1].sum()))
            assert abs(got["accuracy"] - want["accuracy"]) <= 2.0 / n_test
    _, tr = engine.stack_metrics(rows)
    _assert_trace(tr, jtr, "buffered fleet of 2")
    _assert_buffer(states.buffer, jfinal.buffer, "fleet final")
    np.testing.assert_array_equal(states.staleness.numpy(),
                                  np.asarray(jfinal.staleness))


# -- drivers and the fleet helpers --------------------------------------------

def test_drivers_run_buffered_and_telemetry_alone_and_together():
    """``round_step``, ``run_scanned``, ``run_fleet`` and
    ``run_fleet_actors`` (DDPG actors a seed) take buffered, telemetry and
    both; a fleet member follows its own ``run_scanned``."""
    from repro_torch.core import ddpg
    for kw in (dict(engine_mode="buffered"), dict(telemetry=True),
               dict(engine_mode="buffered", telemetry=True)):
        spec = engine.EngineSpec(policy="gcea", scheduler="fastest", **kw)
        pairs = [engine.init_simulation(SMALL, seed=s, device="cpu")[:2]
                 for s in (0, 1)]
        final, own = engine.run_scanned(SMALL, spec, *pairs[1], 3,
                                        torch.Generator().manual_seed(11))
        states, bundles = engine.stack_fleet(pairs)
        gens = [torch.Generator().manual_seed(s) for s in (10, 11)]
        fleet_final, out = engine.run_fleet(SMALL, spec, states, bundles, 3,
                                            gens)
        ms, tr = engine.split_output(spec, out)
        own_ms, own_tr = engine.split_output(spec, own)
        assert torch.equal(ms.cost[1], own_ms.cost)
        assert torch.equal(ms.z[1], own_ms.z)
        assert (tr is None) == (not spec.telemetry)
        if tr is not None:
            assert torch.equal(tr.trigger_cause[1], own_tr.trigger_cause)
        buffered = spec.engine_mode == "buffered"
        assert (fleet_final.buffer is not None) == buffered
        if buffered:
            assert torch.equal(fleet_final.buffer.step,
                               torch.tensor([3, 3], dtype=torch.int32))
            assert torch.equal(engine.select_seed(fleet_final, 1).buffer
                               .in_flight, final.buffer.in_flight)
        spec_d = dataclasses.replace(spec, allocator="ddpg")
        dcfg = ddpg.allocator_config(SMALL, spec_d, hidden=8)
        actors = engine._map(lambda *t: torch.stack(t), *(
            ddpg.init_ddpg(torch.Generator().manual_seed(s), dcfg).actor
            for s in (0, 1)))
        fa, out = engine.run_fleet_actors(SMALL, spec_d, states, bundles, 2,
                                          gens, actors)
        assert engine.split_output(spec_d, out)[0].cost.shape == (2, 2)
        assert (fa.buffer is not None) == buffered


def test_stack_select_and_lift_carry_a_buffer_or_none():
    """``stack_fleet``, ``select_seed`` and ``_lift`` walk a ``BufferState``
    and keep a ``None`` buffer beside the tensors."""
    pairs = [engine.init_simulation(SMALL, seed=s, device="cpu")[:2]
             for s in (0, 1)]
    states, _ = engine.stack_fleet(pairs)
    assert states.buffer is None and states.staleness.shape == (2, 16)
    assert engine.select_seed(states, 1).buffer is None
    assert engine._lift(pairs[0][0]).buffer is None
    buffered = [engine.ensure_buffer(SMALL, SPEC_BUF, st) for st, _ in pairs]
    states, _ = engine.stack_fleet([(st, b) for st, (_, b)
                                    in zip(buffered, pairs)])
    buf = states.buffer
    assert isinstance(buf, engine.BufferState)
    assert buf.step.shape == (2,) and buf.in_flight.shape == (2, 16)
    assert buf.delta_sum["w1"].shape == (2,) + pairs[0][0].global_params[
        "w1"].shape
    one = engine.select_seed(states, 0).buffer
    assert one.step.shape == () and one.tier.shape == (16,)
    lifted = engine._lift(buffered[0]).buffer
    assert lifted.fill.shape == (1,) and lifted.finish_s.shape == (1, 16)
    # a fleet's own fresh buffer equals the stacked single ones
    fresh = engine.init_buffer(SMALL, SPEC_BUF, engine.stack_fleet(pairs)[0])
    engine._map(lambda a, b: torch.equal(a, b) or pytest.fail("init"),
                fresh, buf)


# -- the reference's buffered unit tests, on the port -------------------------

def test_sync_strips_an_attached_buffer():
    spec_sync = engine.EngineSpec(policy="gcea", scheduler="fastest")
    state, bundle, aux = engine.init_simulation(SMALL, seed=0, device="cpu")
    with_buf = engine.ensure_buffer(SMALL, SPEC_BUF, state)
    assert isinstance(with_buf.buffer, engine.BufferState)
    stripped = engine.ensure_buffer(SMALL, spec_sync, with_buf)
    assert stripped.buffer is None
    assert engine.ensure_buffer(SMALL, spec_sync, state) is state
    assert engine.ensure_buffer(SMALL, SPEC_BUF, with_buf) is with_buf
    # a sync round from a buffered state runs the sync engine, no buffer
    draws = engine.sample_draws(SMALL, bundle, aux["generator"], spec_sync)
    s1, m1 = engine.round_step(SMALL, spec_sync, with_buf, bundle, draws)
    s2, m2 = engine.round_step(SMALL, spec_sync, state, bundle, draws)
    assert s1.buffer is None and torch.equal(m1.cost, m2.cost)


def test_unknown_engine_mode_raises():
    with pytest.raises(ValueError, match="engine_mode"):
        engine.EngineSpec(engine_mode="psync")


def test_trigger_fires_at_exactly_fill_or_timeout():
    """Replay the virtual clock from (dt, fill, cause) of the trace and
    check the trigger at every micro-step: (fill ≥ target) ∨ (clock ≥
    deadline), fill winning ties; the metrics' z is the applied merge."""
    spec = dataclasses.replace(SPEC_BUF, timeout_s=0.5)
    state, bundle, aux = engine.init_simulation(SMALL, seed=0, device="cpu")
    steps = 24
    final, (ms, tr) = engine.run_scanned(SMALL, spec, state, bundle, steps,
                                         aux["generator"])
    target = engine.buffer_fill_for(SMALL, spec)
    dt = ms.total_time_s.double().numpy()
    fill, cause = tr.buffer_fill.numpy(), tr.trigger_cause.numpy()
    applied = ms.z[:, 0].numpy() > 0
    clock, last_agg, n_merges = 0.0, 0.0, 0
    for i in range(steps):
        clock += dt[i]
        by_fill = fill[i] >= target
        by_time = clock >= last_agg + spec.timeout_s - 1e-4
        fired = by_fill or by_time
        assert cause[i] == (0 if not fired else 1 if by_fill else 2), i
        if fired:
            last_agg = clock
            n_merges += fill[i] > 0
        assert applied[i] == (fired and fill[i] > 0), i
    assert float(final.buffer.clock_s) == pytest.approx(clock, rel=1e-5)
    assert int(final.buffer.version) == n_merges >= 1
    assert {1, 2} <= set(cause.tolist())


def test_drained_client_resets_staleness_and_in_flight():
    state, bundle, aux = engine.init_simulation(SMALL, seed=0, device="cpu")
    state = engine.ensure_buffer(SMALL, SPEC_BUF, state)
    n = SMALL.n_clients
    # client 1: in flight, tier 1 (not admitted at step 0), finishing at
    # once; client 3: in flight, finishing far in the future
    in_flight = torch.zeros(n, dtype=torch.bool)
    in_flight[[1, 3]] = True
    finish = torch.zeros(n)
    finish[1], finish[3] = 1e-4, 1e6
    tier = torch.zeros(n, dtype=torch.int32)
    tier[[1, 3]] = 1
    buf = state.buffer._replace(in_flight=in_flight, finish_s=finish,
                                tier=tier)
    state = state._replace(buffer=buf,
                           staleness=torch.full((n,), 7, dtype=torch.int32))
    draws = engine.sample_draws(SMALL, bundle, aux["generator"], SPEC_BUF)
    new_state, ms = engine.round_step(SMALL, dataclasses.replace(
        SPEC_BUF, telemetry=False), state, bundle, draws)
    stale, nbuf = new_state.staleness, new_state.buffer
    assert int(stale[1]) == 1                   # landed -> reset (Eq. 20)
    assert not bool(nbuf.in_flight[1])          # drained -> idle again
    assert int(stale[3]) == 8                   # still flying -> +1
    assert bool(nbuf.in_flight[3])
    assert int(nbuf.fill) >= 1                  # the landing was buffered


def test_all_pad_cohort_leaves_params_and_deltas_untouched():
    """A micro-step whose tier has no idle client: every SGD lane is a pad
    lane, nothing is admitted, and no client's params or pending delta
    moves."""
    state, bundle, aux = engine.init_simulation(SMALL, seed=1, device="cpu")
    state = engine.ensure_buffer(SMALL, SPEC_BUF, state)
    buf = state.buffer
    noise = {k: torch.randn(v.shape, generator=torch.Generator()
                            .manual_seed(2)) for k, v in
             buf.pending_delta.items()}
    state = state._replace(buffer=buf._replace(
        tier=torch.ones_like(buf.tier),         # step 0 admits tier 0
        pending_delta=noise))
    draws = engine.sample_draws(SMALL, bundle, aux["generator"], SPEC_BUF)
    new_state, (m, tr) = engine.round_step(SMALL, SPEC_BUF, state, bundle,
                                           draws)
    assert m.n_associated == 0 and int(tr.tier_occupancy) == 0
    for k in noise:
        assert torch.equal(new_state.buffer.pending_delta[k], noise[k])
        assert torch.equal(new_state.client_params[k],
                           state.client_params[k])
    assert not bool(new_state.buffer.in_flight.any())


def test_stream_scanned_accepts_buffered_spec():
    state, bundle, aux = engine.init_simulation(SMALL, seed=0, device="cpu")
    assert state.buffer is None
    mem = sink.MemorySink()
    final, ms, tr = sink.stream_scanned(SMALL, SPEC_BUF, state, bundle, 3,
                                        mem, aux["generator"])
    assert len(mem.records) == 3 and int(final.buffer.step) == 3
    assert tr.buffer_fill.shape == (3,)
    np.testing.assert_array_equal(
        np.stack([r.buffer_fill for r in mem.records]), tr.buffer_fill)


# -- the buffer algebra (skips without hypothesis) ---------------------------

@given(st.floats(0.1, 50.0), st.floats(0.1, 50.0), st.floats(0.1, 50.0),
       st.floats(0.01, 100.0))
@settings(max_examples=25, deadline=None)
def test_merge_weights_sum_to_one(w1, w2, w3, scale):
    """The merge is Σwδ/Σw: identical deltas merge to that delta, and a
    common rescaling of the raw weights changes nothing."""
    g = {"w": torch.zeros((1, 3)), "b": torch.zeros((1,))}
    weights = torch.tensor([[w1, w2, w3]], dtype=torch.float32)
    v = torch.tensor([1.0, -2.0, 0.5])
    deltas = {"w": v.expand(1, 3, 3), "b": torch.ones((1, 3))}
    fired = torch.tensor([True])

    def merged(ws):
        ds, wsum = aggregation.buffer_accumulate(
            aggregation.buffer_zeros(g), torch.zeros(1), deltas, ws)
        return aggregation.buffer_apply(g, ds, wsum, fired)

    out = merged(weights)
    np.testing.assert_allclose(out["w"][0].numpy(), v.numpy(), rtol=1e-5)
    np.testing.assert_allclose(float(out["b"][0]), 1.0, rtol=1e-5)
    out2 = merged(weights * scale)
    np.testing.assert_allclose(out2["w"].numpy(), out["w"].numpy(),
                               rtol=1e-4)
    # an unfired or empty buffer leaves the model bit-unchanged
    ds, wsum = aggregation.buffer_accumulate(
        aggregation.buffer_zeros(g), torch.zeros(1), deltas, weights)
    held = aggregation.buffer_apply(g, ds, wsum, torch.tensor([False]))
    assert torch.equal(held["w"], g["w"])
    empty = aggregation.buffer_apply(g, ds, torch.zeros(1), fired)
    assert torch.equal(empty["b"], g["b"])


@given(st.integers(1, 10**7), st.integers(0, 10**7))
@settings(max_examples=50, deadline=None)
def test_staleness_weight_bounded_and_monotone(age, bump):
    w = float(staleness.buffer_weight(torch.tensor(age)))
    w2 = float(staleness.buffer_weight(torch.tensor(age + bump)))
    assert 0.0 < w <= 1.0
    assert w2 <= w + 1e-7                       # older is never up-weighted
    if age == 1:
        assert w == 1.0                         # fresh update undiscounted


@given(st.integers(1, 2**30))
@settings(max_examples=50, deadline=None)
def test_update_staleness_saturates(a):
    out = int(staleness.update_staleness(
        torch.tensor([a], dtype=torch.int32), torch.tensor([False]))[0])
    assert out == min(a + 1, staleness.STALENESS_MAX)


def test_buffer_age_saturates_and_floors():
    ver = torch.tensor(5, dtype=torch.int32)
    assert int(staleness.buffer_age(ver, torch.tensor(5))) == 1
    assert int(staleness.buffer_age(ver, torch.tensor(9))) == 1
    big = torch.tensor(staleness.STALENESS_MAX + 7, dtype=torch.int32)
    assert int(staleness.buffer_age(big, torch.tensor(0))) \
        == staleness.STALENESS_MAX


@pytest.mark.parametrize("lr", [1.0, 0.5, 0.1])
def test_buffer_apply_server_step_matches_reference(lr):
    """``buffer_apply`` with a server step against the reference's on the
    same buffer, bit for bit; at lr 1 it is global + Σw·Δ / Σw exactly."""
    from repro.core import aggregation as jagg
    rng = np.random.default_rng(7)
    g = {"w": rng.normal(size=(4, 3)).astype(np.float32),
         "b": rng.normal(size=(3,)).astype(np.float32)}
    ds = {k: (5.0 * rng.normal(size=v.shape)).astype(np.float32)
          for k, v in g.items()}
    ws = np.float32(3.7)
    out = aggregation.buffer_apply(
        {k: torch.tensor(v)[None] for k, v in g.items()},
        {k: torch.tensor(v)[None] for k, v in ds.items()},
        torch.tensor([ws]), torch.tensor([True]), lr)
    jout = jagg.buffer_apply(g, ds, jnp.asarray(ws), lr, jnp.asarray(True))
    for k in g:
        np.testing.assert_array_equal(out[k][0].numpy(), np.asarray(jout[k]))
        if lr == 1.0:
            want = torch.tensor(g[k]) + torch.tensor(ds[k]) / torch.tensor(ws)
            assert torch.equal(out[k][0], want)


def test_buffer_algebra_matches_reference():
    """``buffer_age``, ``buffer_weight``, ``buffer_accumulate``,
    ``buffer_apply`` and ``cohort_cost`` against the reference's on the
    same inputs (one seed)."""
    from repro.core import aggregation as jagg
    from repro.core import cost as jcost
    from repro.core import staleness as jstale
    from repro_torch.core import cost
    rng = np.random.default_rng(0)
    ver = rng.integers(0, 40, 16).astype(np.int32)
    pulled = rng.integers(0, 40, 16).astype(np.int32)
    age = staleness.buffer_age(torch.tensor(ver), torch.tensor(pulled))
    jage = jstale.buffer_age(jnp.asarray(ver), jnp.asarray(pulled))
    np.testing.assert_array_equal(age.numpy(), np.asarray(jage))
    np.testing.assert_allclose(staleness.buffer_weight(age).numpy(),
                               np.asarray(jstale.buffer_weight(jage)),
                               rtol=2e-7)
    g = {"w": rng.normal(size=(4, 3)).astype(np.float32)}
    d = {"w": rng.normal(size=(16, 4, 3)).astype(np.float32)}
    w = rng.uniform(0, 5, 16).astype(np.float32)
    ds, ws = aggregation.buffer_accumulate(
        {"w": torch.zeros((1, 4, 3))}, torch.zeros(1),
        {"w": torch.tensor(d["w"])[None]}, torch.tensor(w)[None])
    jds, jws = jagg.buffer_accumulate({"w": jnp.zeros((4, 3))},
                                      jnp.zeros(()), d, jnp.asarray(w))
    np.testing.assert_allclose(ds["w"][0].numpy(), np.asarray(jds["w"]),
                               rtol=1e-5, atol=1e-6)
    out = aggregation.buffer_apply({"w": torch.tensor(g["w"])[None]}, ds, ws,
                                   torch.tensor([True]))
    jout = jagg.buffer_apply(g, jds, jws, 1.0, jnp.asarray(True))
    np.testing.assert_allclose(out["w"][0].numpy(), np.asarray(jout["w"]),
                               rtol=1e-5, atol=1e-6)
    rc = SimpleNamespace(client_energy_j=rng.uniform(0, 3, 16)
                         .astype(np.float32))
    cohort = rng.random(16) < 0.4
    for fired in (True, False):
        got = cost.cohort_cost(
            SMALL, cost.RoundCost(*([torch.zeros(1)] * 7),
                                  torch.tensor(rc.client_energy_j)),
            torch.tensor(cohort), torch.tensor(0.25), torch.tensor(fired))
        want = jcost.cohort_cost(
            JSMALL, jcost.RoundCost(*([jnp.zeros(1)] * 7),
                                    jnp.asarray(rc.client_energy_j)),
            jnp.asarray(cohort), jnp.float32(0.25), jnp.asarray(fired))
        for a, b in ((got.total_energy_j, want.total_energy_j),
                     (got.cost, want.cost),
                     (got.total_time_s, want.total_time_s)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)

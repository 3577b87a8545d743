"""The port's dynamic scenarios and fpa/fca allocators on the CPU, held to
the live JAX reference.

* ``init_scenario``: every leaf of every preset, bit for bit (the numpy
  draws follow topology and data in the reference's order).
* The transitions, 6 rounds each, with the reference's uniforms replayed
  from its key splits (``advance_dynamic``: a waypoint field and a
  dropout uniform; ``flash_crowd``: a burst scalar and a decay field;
  ``regional_outage``: an event scalar, a centre and a recovery field;
  ``diurnal``: one field): every leaf bit for bit.
* 4-round trajectories through ``round_step`` on dynamic kinds, the
  scenario draws replayed from the round key's slot 1 (the dynamic path
  splits the round key 6 ways): as ``tests/test_torch_engine.py`` holds
  the static round -- integers exactly, the bill at rtol 1e-5, the loss
  at rtol 1e-4, the accuracy within 2 test samples.
* A fleet of mixed worlds against the reference's ``run_fleet``, and each
  member against its own ``run_scanned``.
* The reference's behavioural checks (``tests/test_scenarios.py``): the
  all-dropped round, ``n_associated ≤ n_available``, a custom transition
  end to end, preset and kind validation.
* fpa/fca: ``grid_best_action`` exactly, its grid against
  ``jnp.linspace``, 4 engine rounds each, and a ``CONFIG`` round.
"""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenarios as jscen
from repro.configs.hfl_mnist import CONFIG as JCONFIG
from repro.core import engine as jengine
from repro.core import env as jenv
from repro_torch import convert, scenarios
from repro_torch.configs.hfl_mnist import CONFIG
from repro_torch.core import engine, env
from repro_torch.core.hfl import HFLSimulation
from test_torch_engine import JSMALL, SMALL, _replayed_draws
from _torch_threads import one_torch_thread  # noqa: F401

ROUNDS = 4
N = SMALL.n_clients


def _pack(cfg, kind, u):
    """``{name: (…, *shape)}`` uniforms -> the flat (…, U) layout
    ``scenarios.advance`` takes (the inverse of ``unpack_draws``)."""
    parts = [u[name].reshape(u[name].shape[:u[name].dim() - len(shape)]
                             + (-1,))
             for name, shape in scenarios.draw_shapes(cfg, kind).items()]
    return torch.cat(parts, dim=-1)


def _ref_uniforms(kind, key, n):
    """The reference transition's uniforms from its scenario key, split as
    ``repro.scenarios.base`` splits it, in the port's flat layout."""
    fn = jscen.TRANSITIONS[kind]
    u = jax.random.uniform
    if fn is jscen.advance_dynamic:
        k_wp, k_drop = jax.random.split(key)
        out = {"waypoint": u(k_wp, (n, 2)), "drop": u(k_drop, (n,))}
    elif fn is jscen.flash_crowd_transition:
        k_burst, k_drop = jax.random.split(key)
        out = {"burst": u(k_burst, ()), "decay": u(k_drop, (n,))}
    elif fn is jscen.base.regional_outage_transition:
        k_evt, k_ctr, k_rec = jax.random.split(key, 3)
        out = {"event": u(k_evt, ()), "centre": u(k_ctr, (2,)),
               "recover": u(k_rec, (n,))}
    elif fn is jscen.base.diurnal_transition:
        out = {"level": u(key, (n,))}
    else:
        raise ValueError(kind)
    cfg = dataclasses.replace(SMALL, n_clients=n)
    return _pack(cfg, kind, {k: torch.tensor(np.asarray(v))
                             for k, v in out.items()})


def _round_draws(jcfg, jspec, jstate, jbundle):
    """A reference round's own draws, the scenario's from slot 1."""
    draws = _replayed_draws(jcfg, jspec, jstate, jbundle)
    if jspec.scenario == "static":
        return draws
    k_scen = jengine.round_keys(jspec, jstate.key)[1]
    return draws._replace(scenario=_ref_uniforms(jspec.scenario, k_scen,
                                                 jcfg.n_clients))


@functools.lru_cache(maxsize=None)
def _ref_start(jcfg, seed, scenario):
    """The reference's ``init_simulation`` (immutable arrays, so one build
    serves every test of a process that starts from it)."""
    jstate, jbundle, _ = jengine.init_simulation(jcfg, seed=seed,
                                                 scenario=scenario)
    return jstate, jbundle


def _start(jcfg, seed, scenario):
    """Both sides from the reference's ``init_simulation``."""
    jstate, jbundle = _ref_start(jcfg, seed, scenario)
    snp = jax.tree.map(np.asarray, jstate._replace(key=None))
    state, bundle = convert.state_from_numpy(
        snp, jax.tree.map(np.asarray, jbundle), "cpu")
    return jstate, jbundle, state, bundle


def _assert_scenario_equal(got, want, msg):
    for field in scenarios.ScenarioState._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      f"{msg} {field}")


# positions, waypoints and distances after a round: the reference compiles
# the transition into the round's one XLA program, which rounds the
# waypoint step and the norm other than the transition alone does (1 ulp);
# alone, the two transitions are bit-equal (test_transition_matches_reference)
IN_ROUND_WORLD_RTOL = 1e-6


def _assert_world(got, want, msg):
    """A scenario state after rounds: the availability and every
    init-time leaf exactly, the moved leaves at IN_ROUND_WORLD_RTOL."""
    for field in scenarios.ScenarioState._fields:
        g = getattr(got, field).numpy()
        w = np.asarray(getattr(want, field))
        if field in ("pos", "waypoint", "dist"):
            np.testing.assert_allclose(g, w, rtol=IN_ROUND_WORLD_RTOL,
                                       err_msg=f"{msg} {field}")
        else:
            np.testing.assert_array_equal(g, w, f"{msg} {field}")


def _assert_round(got, want, n_test, msg):
    np.testing.assert_array_equal(got["z"], want["z"], msg)
    for k in ("round", "n_associated", "n_available", "avg_staleness"):
        assert got[k] == want[k], (msg, k)
    for k in ("cost", "total_time_s", "total_energy_j"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   err_msg=f"{msg} {k}")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4,
                               err_msg=msg)
    assert abs(got["accuracy"] - want["accuracy"]) <= 2.0 / n_test, msg


# -- init and transitions -----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(jscen.PRESETS))
def test_init_scenario_matches_reference(name, seed):
    """Both ``init_simulation``s draw the scenario after topology and data
    from one numpy stream: every leaf equal, and so the bundle."""
    jstate, jbundle, _ = jengine.init_simulation(JSMALL, seed=seed,
                                                 scenario=name)
    state, bundle, aux = engine.init_simulation(SMALL, seed=seed,
                                                device="cpu", scenario=name)
    assert aux["scenario_spec"] == scenarios.preset(name)
    assert dataclasses.asdict(aux["scenario_spec"]) == \
        dataclasses.asdict(jscen.preset(name))
    _assert_scenario_equal(state.scenario, jstate.scenario, name)
    np.testing.assert_array_equal(bundle.dist.numpy(),
                                  np.asarray(jbundle.dist))


TRANSITION_PRESETS = ["full_dynamic", "mobile_flaky", "flash_crowd",
                      "regional_outage", "diurnal"]


@pytest.mark.parametrize("name", TRANSITION_PRESETS)
def test_transition_matches_reference(name):
    """Six rounds of the preset's transition from one world, the
    reference's uniforms replayed: avail exact, and positions, waypoints,
    distances and every other leaf bit for bit (``vector_norm`` is
    ``jnp.linalg.norm``'s sum of squares)."""
    sspec = jscen.preset(name)
    kind = sspec.engine_kind()
    jstate, _, state, _ = _start(JSMALL, 0, name)
    js, ps = jstate.scenario, state.scenario
    key = jax.random.key(7)
    changed = False
    for r in range(6):
        key, k = jax.random.split(key)
        js = jscen.advance(JSMALL, kind, k, js)
        new = scenarios.advance(SMALL, kind, _ref_uniforms(kind, k, N), ps)
        changed |= not torch.equal(new.avail, ps.avail)
        ps = new
        _assert_scenario_equal(ps, js, f"{name} round {r}")
    assert changed, "the availability never moved: a vacuous check"


def test_transitions_reduce_over_each_seeds_own_clients():
    """The per-client means of flash_crowd, regional_outage and diurnal are
    each seed's own: a stacked pair advances as each seed alone."""
    for name in ("flash_crowd", "regional_outage", "diurnal"):
        kind = scenarios.preset(name).engine_kind()
        pairs = []
        for s, spec in enumerate((scenarios.preset(name),
                                  dataclasses.replace(scenarios.preset(name),
                                                      p_drop=0.9,
                                                      p_return=0.05))):
            st = engine.init_simulation(SMALL, seed=s, device="cpu",
                                        scenario=spec)[0]
            gen = torch.Generator().manual_seed(s)
            u = torch.rand((scenarios.draw_size(SMALL, kind),),
                           generator=gen)
            pairs.append((st.scenario, u))
        fleet = scenarios.advance(
            SMALL, kind, torch.stack([u for _, u in pairs]),
            engine._map(lambda *t: torch.stack(t), *(s for s, _ in pairs)))
        for i, (st, u) in enumerate(pairs):
            alone = scenarios.advance(SMALL, kind, u, st)
            for field in scenarios.ScenarioState._fields:
                assert torch.equal(getattr(fleet, field)[i],
                                   getattr(alone, field)), (name, field)


# -- trajectories through round_step ------------------------------------------

TRAJECTORY_CASES = [
    pytest.param("full_dynamic", dict(policy="fcea", scheduler="pdd"),
                 id="full_dynamic-fcea-pdd"),
    pytest.param("mobile_flaky", dict(policy="gcea", scheduler="fastest"),
                 id="mobile_flaky-gcea-fastest"),
    pytest.param("hetero_devices", dict(policy="fcea", scheduler="pdd",
                                        allocator="rra"),
                 id="hetero_devices-fcea-pdd-rra"),
    pytest.param("markov_dropout", dict(policy="rcea", scheduler="fastest"),
                 id="markov_dropout-rcea-fastest"),
    pytest.param("flash_crowd", dict(policy="gcea", scheduler="fastest"),
                 id="flash_crowd-gcea-fastest"),
    pytest.param("regional_outage", dict(policy="gcea", scheduler="fastest"),
                 id="regional_outage-gcea-fastest"),
    pytest.param("diurnal", dict(policy="gcea", scheduler="fastest"),
                 id="diurnal-gcea-fastest"),
    pytest.param("full_dynamic", dict(policy="fcea", scheduler="pdd",
                                      candidates_k=2),
                 id="full_dynamic-fcea-pdd-k2"),
    pytest.param("hetero_devices", dict(policy="fcea", scheduler="pdd",
                                        allocator="fpa"),
                 id="hetero_devices-fcea-pdd-fpa"),
    pytest.param("hetero_devices", dict(policy="gcea", scheduler="fastest",
                                        allocator="fca"),
                 id="hetero_devices-gcea-fastest-fca"),
    pytest.param("static", dict(policy="fcea", scheduler="pdd",
                                allocator="fpa"), id="static-fcea-pdd-fpa"),
    pytest.param("static", dict(policy="fcea", scheduler="pdd",
                                allocator="fca"), id="static-fcea-pdd-fca"),
]


@pytest.mark.parametrize("name,kw", TRAJECTORY_CASES)
def test_scenario_trajectory_matches_reference(name, kw):
    kind = jscen.preset(name).engine_kind()
    jspec = jengine.EngineSpec(scenario=kind, **kw)
    spec = engine.EngineSpec(scenario=kind, **kw)
    jstate, jbundle, state, bundle = _start(JSMALL, 0, name)
    n_test = int(jbundle.test_y.shape[0])
    seen_avail = set()
    for r in range(ROUNDS):
        draws = _round_draws(JSMALL, jspec, jstate, jbundle)
        jstate, jm = jengine.round_step_jit(JSMALL, jspec, jstate, jbundle)
        state, m = engine.round_step(SMALL, spec, state, bundle, draws)
        got, want = engine.metrics_row(m), jengine.metrics_row(jm)
        msg = f"{name} {kw} round {r}"
        _assert_round(got, want, n_test, msg)
        assert got["n_associated"] <= got["n_available"], msg
        seen_avail.add(got["n_available"])
        np.testing.assert_array_equal(state.staleness.numpy(),
                                      np.asarray(jstate.staleness), msg)
        _assert_world(state.scenario, jstate.scenario, msg)
    if kind == "static":
        assert isinstance(m.n_available, int)
    else:
        assert m.n_available.dtype == torch.int32
    if name in ("mobile_flaky", "markov_dropout", "flash_crowd",
                "regional_outage", "diurnal"):
        assert len(seen_avail) > 1, "availability never moved"
    for k, leaf in state.global_params.items():
        np.testing.assert_allclose(leaf.numpy(),
                                   np.asarray(jstate.global_params[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_hetero_clamp_acts():
    """On hetero_devices the caps bite: the mid allocation exceeds some
    device's cap, so the clamp changes p and f."""
    state = engine.init_simulation(SMALL, seed=0, device="cpu",
                                   scenario="hetero_devices")[0]
    scen = state.scenario
    mid_p = 0.5 * (SMALL.p_min_w + SMALL.p_max_w)
    mid_f = 0.5 * (SMALL.f_min_hz + SMALL.f_max_hz)
    assert bool((scen.p_max_w < mid_p).any())
    assert bool((scen.f_max_hz < mid_f).any())
    assert bool((scen.kappa > SMALL.capacitance).any())


def test_frontier_masks_dropped_clients_as_reference():
    """``build_candidates(avail=)`` marks a dropped client's whole row
    invalid, and ``max_coverage_degree(avail=)`` counts available clients
    only, as the reference's do."""
    from repro.core import candidates as jcand
    from repro_torch.core import candidates
    jstate, _, state, _ = _start(JSMALL, 0, "markov_dropout")
    rng = np.random.default_rng(5)
    avail = (rng.random(N) < 0.5).astype(np.float32)
    dist = state.scenario.dist
    radius = engine.coverage_radius(SMALL)
    got = candidates.build_candidates(dist, 2, coverage_radius_m=radius,
                                      avail=torch.tensor(avail))
    want = jcand.build_candidates(jstate.scenario.dist, 2,
                                  coverage_radius_m=radius,
                                  avail=jnp.asarray(avail))
    for field in ("idx", "valid", "dist"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    assert not bool(got.valid[torch.tensor(avail) == 0].any())
    for a in (None, avail, np.zeros(N, np.float32)):
        assert candidates.max_coverage_degree(dist, radius, avail=a) == \
            jcand.max_coverage_degree(np.asarray(jstate.scenario.dist),
                                      radius, avail=a)


# -- the fleet of mixed worlds ------------------------------------------------

MIXED = ("random_waypoint", "markov_dropout", "hetero_devices")
FLEET_ROUNDS = 3


def _lane_draws(jspec, keys, jbundles):
    rows = [_round_draws(JSMALL, jspec, SimpleNamespace(key=keys[s]),
                         jax.tree.map(lambda a: a[s], jbundles))
            for s in range(len(keys))]
    return engine._map(lambda *t: torch.stack(t), *rows)


@pytest.mark.parametrize("kw", [
    pytest.param(dict(policy="fcea", scheduler="pdd"), id="fcea-pdd"),
    pytest.param(dict(policy="gcea", scheduler="fastest", candidates_k=2),
                 id="gcea-fastest-k2")])
def test_mixed_fleet_matches_reference_run_fleet(kw):
    """Three worlds (kind "dynamic": which parts act is in each state) as
    one fleet against the reference's ``run_fleet``, each lane's draws
    replayed from its own key chain."""
    jspec = jengine.EngineSpec(scenario="dynamic", **kw)
    spec = engine.EngineSpec(scenario="dynamic", **kw)
    starts = [_start(JSMALL, s, name) for s, name in enumerate(MIXED)]
    jstates, jbundles = jengine.stack_fleet([(a, b) for a, b, _, _ in starts])
    states, bundles = engine.stack_fleet([(c, d) for _, _, c, d in starts])
    jfinal, jm = jengine.run_fleet(JSMALL, jspec, jstates, jbundles,
                                   FLEET_ROUNDS)
    keys = [jstates.key[s] for s in range(len(MIXED))]
    n_test = int(jbundles.test_y.shape[1])
    for r in range(FLEET_ROUNDS):
        draws = _lane_draws(jspec, keys, jbundles)
        keys = [jengine.round_keys(jspec, k)[0] for k in keys]
        states, m = engine.fleet_step(SMALL, spec, states, bundles, draws)
        assert m.n_available.shape == (len(MIXED),)
        for s in range(len(MIXED)):
            want = jengine.metrics_row(jax.tree.map(lambda a: a[s], jm), r)
            got = engine.metrics_row(engine.select_seed(m, s))
            _assert_round(got, want, n_test, f"{MIXED[s]} round {r}")
    np.testing.assert_array_equal(states.staleness.numpy(),
                                  np.asarray(jfinal.staleness))
    _assert_world(states.scenario, jfinal.scenario, "final")


def test_mixed_fleet_members_follow_their_own_runs():
    spec = engine.EngineSpec(scenario="dynamic")
    pairs, gens, own = [], [], []
    for s, name in enumerate(MIXED):
        state, bundle, _ = engine.init_simulation(SMALL, seed=s,
                                                  device="cpu", scenario=name)
        pairs.append((state, bundle))
        gens.append(torch.Generator().manual_seed(40 + s))
        own.append(engine.run_scanned(SMALL, spec, state, bundle,
                                      FLEET_ROUNDS,
                                      torch.Generator().manual_seed(40 + s)))
    states, bundles = engine.stack_fleet(pairs)
    final, fm = engine.run_fleet(SMALL, spec, states, bundles, FLEET_ROUNDS,
                                 gens)
    assert fm.n_available.shape == (len(MIXED), FLEET_ROUNDS)
    for s, (o_state, om) in enumerate(own):
        sm = engine.select_seed(fm, s)
        for i in range(FLEET_ROUNDS):
            got, want = engine.metrics_row(sm, i), engine.metrics_row(om, i)
            np.testing.assert_array_equal(got["z"], want["z"])
            for key in ("n_associated", "n_available", "sweeps"):
                assert got[key] == want[key], (MIXED[s], i, key)
            for key in ("loss", "cost", "total_time_s", "total_energy_j"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
        assert torch.equal(final.staleness[s], o_state.staleness)
        for field in scenarios.ScenarioState._fields:
            assert torch.equal(getattr(final.scenario, field)[s],
                               getattr(o_state.scenario, field)), field


# -- behaviour ----------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    pytest.param(dict(policy="gcea", scheduler="fastest"), id="gcea-fastest"),
    pytest.param(dict(policy="fcea", scheduler="pdd"), id="fcea-pdd"),
    pytest.param(dict(policy="fcea", scheduler="pdd", candidates_k=1),
                 id="fcea-pdd-k1")])
def test_all_clients_dropped_keeps_global_model(kw):
    """Nobody available: nothing associates or trains, the global model
    rides through bit for bit, and the bill stays finite -- as in the
    reference."""
    sspec = scenarios.ScenarioSpec(kind="markov_dropout", p_drop=1.0,
                                   p_return=0.0)
    jspec = jengine.EngineSpec(scenario="dynamic", **kw)
    spec = engine.EngineSpec(scenario="dynamic", **kw)
    jstate, jbundle, state, bundle = _start(
        JSMALL, 0, jscen.ScenarioSpec(kind="markov_dropout", p_drop=1.0,
                                      p_return=0.0))
    _, _, aux = engine.init_simulation(SMALL, seed=0, device="cpu",
                                       scenario=sspec)
    draws = _round_draws(JSMALL, jspec, jstate, jbundle)
    _, jm = jengine.round_step_jit(JSMALL, jspec, jstate, jbundle)
    s1, m = engine.round_step(SMALL, spec, state, bundle, draws)
    assert int(m.n_available) == 0 and int(m.n_associated) == 0
    for k in state.global_params:
        assert torch.equal(s1.global_params[k], state.global_params[k])
        assert torch.equal(s1.client_params[k], state.client_params[k])
    assert np.isfinite(float(m.cost))
    _assert_round(engine.metrics_row(m), jengine.metrics_row(jm),
                  int(jbundle.test_y.shape[0]), "all dropped")
    assert aux["scenario_spec"] == sspec


def test_unavailable_clients_never_associated():
    """n_associated ≤ n_available every round, n_available is the mask's
    count, and no dropped client holds an edge (its staleness grows)."""
    sspec = scenarios.ScenarioSpec(kind="markov_dropout", p_drop=0.6,
                                   p_return=0.2)
    sim = HFLSimulation(SMALL, seed=0, scenario=sspec, device="cpu")
    assert sim.spec.scenario == "dynamic" and sim.scenario_spec == sspec
    for _ in range(6):
        before = sim.state.staleness.clone()
        m = sim.run_round()
        avail = sim.state.scenario.avail
        assert m.n_associated <= m.n_available
        assert m.n_available == int(avail.sum())
        dropped = avail == 0
        assert torch.equal(sim.state.staleness[dropped], before[dropped] + 1)


def test_register_custom_transition_end_to_end():
    """A registered custom kind, with draws of its own, flows through
    preset, init_simulation, EngineSpec, sample_draws and round_step."""
    kind = "_test_coin_blackout"

    def blackout(cfg, u, s):
        return s._replace(avail=(u["coin"] > 2.0).to(torch.float32)
                          .expand(s.avail.shape))

    scenarios.register_transition(kind, blackout,
                                  draws=lambda cfg: {"coin": (1,)})
    try:
        sspec = scenarios.preset(kind)
        assert sspec.is_dynamic and sspec.parts == ()
        assert sspec.engine_kind() == kind
        spec = engine.EngineSpec(policy="gcea", scheduler="fastest",
                                 scenario=kind)
        state, bundle, aux = engine.init_simulation(SMALL, seed=0,
                                                    device="cpu",
                                                    scenario=kind)
        draws = engine.sample_draws(SMALL, bundle, aux["generator"], spec)
        assert draws.scenario.shape == (1,)
        _, m = engine.round_step(SMALL, spec, state, bundle, draws)
        assert int(m.n_available) == 0 and int(m.n_associated) == 0
        sim = HFLSimulation(SMALL, seed=0, policy="gcea", scheduler="fastest",
                            scenario=kind, device="cpu")
        assert sim.run_round().n_available == 0
    finally:
        del scenarios.TRANSITIONS[kind], scenarios.DRAWS[kind]
    with pytest.raises(ValueError):
        engine.EngineSpec(scenario=kind)


def test_preset_and_kind_validation():
    assert scenarios.preset("static").engine_kind() == "static"
    assert scenarios.preset("full_dynamic").engine_kind() == "dynamic"
    assert scenarios.preset(
        "random_waypoint+markov_dropout").engine_kind() == "dynamic"
    assert scenarios.preset(None) == scenarios.ScenarioSpec()
    with pytest.raises(ValueError):
        scenarios.preset("warp_drive").parts
    with pytest.raises(ValueError):
        scenarios.advance(SMALL, "warp_drive", {}, None)
    with pytest.raises(ValueError):
        scenarios.draw_shapes(SMALL, "warp_drive")
    with pytest.raises(ValueError):
        HFLSimulation(SMALL, scenario="warp_drive", device="cpu")
    assert scenarios.preset("full_dynamic").stationary_availability == \
        jscen.preset("full_dynamic").stationary_availability


def test_presets_and_transitions_match_reference():
    """The same presets, specs and kinds: every "+"-mixture of the three
    parts, in any order, is registered to the shared transition."""
    assert set(scenarios.PRESETS) == set(jscen.PRESETS)
    for name, spec in jscen.PRESETS.items():
        assert dataclasses.asdict(scenarios.PRESETS[name]) == \
            dataclasses.asdict(spec)
        assert scenarios.PRESETS[name].engine_kind() == spec.engine_kind()
    assert set(scenarios.TRANSITIONS) == set(jscen.TRANSITIONS)
    for kind, fn in jscen.TRANSITIONS.items():
        assert (scenarios.TRANSITIONS[kind] is scenarios.advance_dynamic) == \
            (fn is jscen.advance_dynamic), kind


@pytest.mark.parametrize("kind", sorted(jscen.TRANSITIONS))
def test_every_kind_and_grid_allocator_is_accepted(kind):
    for allocator in ("mid", "fpa", "fca"):
        spec = engine.EngineSpec(scenario=kind, allocator=allocator)
        assert (spec.scenario, spec.allocator) == (kind, allocator)


def test_hfl_simulation_takes_a_scenario_and_grid_allocators():
    for scenario in ("full_dynamic", "random_waypoint+hetero_devices",
                     scenarios.PRESETS["diurnal"], None):
        sspec = scenarios.preset(scenario)
        for allocator in ("fpa", "fca"):
            sim = HFLSimulation(SMALL, seed=1, allocator=allocator,
                                scheduler="fastest", scenario=scenario,
                                device="cpu")
            assert sim.spec.scenario == sspec.engine_kind()
            assert sim.scenario_spec == sspec
            m = sim.run_round()
            assert np.isfinite(m.cost) and m.n_associated <= m.n_available


def test_sample_draws_add_scenario_uniforms_after_the_static_stream():
    """A dynamic kind draws its uniforms after every other draw, so the
    static stream is the one it was."""
    _, bundle, _ = engine.init_simulation(SMALL, seed=0, device="cpu")
    base = engine.sample_draws(SMALL, bundle,
                               torch.Generator().manual_seed(3))
    assert base.scenario.shape == (0,)
    for kind, names in (("dynamic", {"waypoint": (N, 2), "drop": (N,)}),
                        ("flash_crowd", {"burst": (), "decay": (N,)}),
                        ("regional_outage", {"event": (), "centre": (2,),
                                             "recover": (N,)}),
                        ("diurnal", {"level": (N,)})):
        spec = engine.EngineSpec(scenario=kind, policy="rcea",
                                 allocator="rra")
        both = engine.sample_draws(SMALL, bundle,
                                   torch.Generator().manual_seed(3), spec)
        assert torch.equal(base.fading, both.fading)
        assert torch.equal(base.batch_idx, both.batch_idx)
        u = scenarios.unpack_draws(SMALL, kind, both.scenario)
        assert {k: tuple(v.shape) for k, v in u.items()} == names
        assert both.scenario.shape == (scenarios.draw_size(SMALL, kind),)
        assert bool(((both.scenario >= 0) & (both.scenario < 1)).all())
        assert torch.equal(_pack(SMALL, kind, u), both.scenario)


# -- fpa / fca ----------------------------------------------------------------

def test_grid_fractions_equal_jnp_linspace():
    for n_grid in (1, 2, 7, 16, 33):
        want = np.asarray(jnp.linspace(0.0, 1.0, n_grid))
        got = env.grid_fractions(n_grid, "cpu").numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, f"n_grid={n_grid}")


# The bill weighted 100:1 toward time: the grid's best point moves inside
# [0, 1].  At the paper's 1:1 weights these seeds mostly pick point 0,
# which a wrong fold of the G·S grid or a wrong argmin would pick as well.
JTIMED = dataclasses.replace(JSMALL, lambda_t=1.0, lambda_e=0.01)
TIMED = dataclasses.replace(SMALL, lambda_t=1.0, lambda_e=0.01)


@functools.lru_cache(maxsize=None)
def _grid_inputs(jcfg, name, seed):
    """A reference round's grid inputs: its post-round gains, its
    association snapshot and the scenario's caps and κ (immutable, so
    built once for both pinned axes)."""
    kind = jscen.preset(name).engine_kind()
    jspec = jengine.EngineSpec(scenario=kind)
    jstate, jbundle = _ref_start(jcfg, seed, name)
    jstate, _ = jengine.round_step_jit(jcfg, jspec, jstate, jbundle)
    assoc = jengine.associate_snapshot(jcfg, jspec, jstate, jbundle)
    assoc = jnp.asarray(assoc, jnp.float32)
    scen = jstate.scenario if kind != "static" else None
    return jstate, jbundle, assoc, scen


def _grid_case(jcfg, cfg, name, seeds, fixed_axis, p_cap=None):
    """The reference's grid action of each seed's round, and the port's
    for all the seeds in one fleet call on the same inputs.  ``p_cap``
    replaces every client's power cap.  Returns (want (S, 2N) numpy, got
    (S, 2, N), the port's ``EnvParams``, the reference's, seed by seed)."""
    t = lambda a: torch.tensor(np.asarray(a))
    want, rows, jrows = [], [], []
    for seed in seeds:
        jstate, jbundle, assoc, scen = _grid_inputs(jcfg, name, seed)
        caps = {} if scen is None else dict(kappa=scen.kappa,
                                            p_max_w=scen.p_max_w,
                                            f_max_hz=scen.f_max_hz)
        if p_cap is not None:
            caps["p_max_w"] = jnp.full((jcfg.n_clients,), p_cap, jnp.float32)
        jparams = jenv.make_env_params(jcfg, assoc,
                                       jnp.ones((jcfg.n_edges,)),
                                       jbundle.dist, jbundle.counts, **caps)
        want.append(np.asarray(jenv.grid_best_action(
            jcfg, jparams, jstate.gains, fixed_axis=fixed_axis,
            fixed_frac=1.0)))
        jrows.append(jparams)
        rows.append((env.make_env_params(
            cfg, t(assoc), torch.ones(cfg.n_edges), t(jbundle.dist),
            t(jbundle.counts),
            **{k: t(v) for k, v in caps.items()}), t(jstate.gains)))
    params = engine._map(lambda *a: torch.stack(a), *(p for p, _ in rows))
    gains = torch.stack([g for _, g in rows])
    got = env.grid_best_action(cfg, params, gains, fixed_axis=fixed_axis,
                               fixed_frac=1.0)
    return np.stack(want), got, params, jrows


def _grid_index(got, fixed_axis):
    """Each seed's chosen grid point: the index of its free fraction."""
    fr = env.grid_fractions(16, "cpu").tolist()
    return [fr.index(float(a[1 - fixed_axis, 0])) for a in got]


@pytest.mark.parametrize("fixed_axis", [0, 1])
@pytest.mark.parametrize("name,jcfg,cfg", [
    pytest.param("static", JSMALL, SMALL, id="static"),
    pytest.param("hetero_devices", JSMALL, SMALL, id="hetero_devices"),
    pytest.param("hetero_devices", JCONFIG, CONFIG, id="hetero-CONFIG"),
    pytest.param("hetero_devices", JTIMED, TIMED, id="hetero-timed")])
def test_grid_best_action_matches_reference(name, jcfg, cfg, fixed_axis):
    """The grid's chosen action equals the reference's exactly, static and
    with the scenario's caps and κ; so does the decoded (p, f)."""
    want, got, params, (jparams,) = _grid_case(jcfg, cfg, name, [0],
                                               fixed_axis)
    np.testing.assert_array_equal(got.reshape(1, -1).numpy(), want)
    wp, wf = jenv.env_decode_action(jcfg, jparams, jnp.asarray(want[0]))
    gp, gf = env.env_decode_action(cfg, params, got)
    np.testing.assert_array_equal(gp[0].numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gf[0].numpy(), np.asarray(wf))
    # the free axis is a grid point, the pinned one at its maximum
    assert float(got[0, fixed_axis].min()) == 1.0
    _grid_index(got, fixed_axis)


@pytest.mark.parametrize("fixed_axis", [0, 1])
def test_grid_fleet_picks_interior_points_as_the_reference(fixed_axis):
    """Three seeds' grids in one fleet call, with the bill weighted toward
    time: each seed's action equals its own reference grid exactly, and
    the seeds pick different points, some inside the grid -- so a fold
    that mixed seeds or grid points, or an argmin that ignored them,
    shows."""
    want, got, _, _ = _grid_case(JTIMED, TIMED, "hetero_devices", [0, 1, 2],
                                 fixed_axis)
    np.testing.assert_array_equal(got.reshape(3, -1).numpy(), want)
    idx = _grid_index(got, fixed_axis)
    assert max(idx) > 0 and len(set(idx)) > 1, idx


def test_grid_first_minimum_among_capped_ties():
    """fca with every client's power capped inside the grid: the points
    at and above the cap decode to the same power, so they bill the same,
    and the first of them must win, as ``jnp.argmin`` picks it."""
    p_cap = TIMED.p_min_w + 0.45 * (TIMED.p_max_w - TIMED.p_min_w)
    want, got, params, _ = _grid_case(JTIMED, TIMED, "hetero_devices",
                                      [0, 1, 2], 1, p_cap=np.float32(p_cap))
    np.testing.assert_array_equal(got.reshape(3, -1).numpy(), want)
    idx = _grid_index(got, 1)
    fr = env.grid_fractions(16, "cpu")
    tied = int(torch.nonzero(fr >= 0.45)[0])     # the first capped point
    assert tied in idx, (idx, tied)
    last = got.clone()
    last[:, 0, :] = 1.0
    p, _ = env.env_decode_action(TIMED, params, got)
    p_last, _ = env.env_decode_action(TIMED, params, last)
    s = idx.index(tied)
    assert torch.equal(p[s], p_last[s])


def test_grid_fleet_equals_each_seeds_own_grid():
    """Over a fleet, the G·S grid folds onto one leading axis: each seed
    picks the action it picks alone (with the bill weighted toward time,
    so that the picks differ and lie inside the grid)."""
    rows = []
    for s in range(3):
        state, bundle, _ = engine.init_simulation(
            TIMED, seed=s, device="cpu", scenario="hetero_devices")
        assoc = torch.zeros(N, TIMED.n_edges)
        assoc[torch.arange(N), torch.arange(N) % TIMED.n_edges] = 1.0
        assoc[::5] = 0.0
        sc = state.scenario
        rows.append((env.make_env_params(
            TIMED, assoc, torch.ones(TIMED.n_edges), bundle.dist,
            bundle.counts,
            kappa=sc.kappa, p_max_w=sc.p_max_w, f_max_hz=sc.f_max_hz),
            state.gains))
    fleet = engine._map(lambda *t: torch.stack(t), *(p for p, _ in rows))
    gains = torch.stack([g for _, g in rows])
    for axis in (0, 1):
        got = env.grid_best_action(TIMED, fleet, gains, fixed_axis=axis,
                                   fixed_frac=1.0)
        idx = _grid_index(got, axis)
        assert max(idx) > 0 and len(set(idx)) > 1, (axis, idx)
        for s, (p, g) in enumerate(rows):
            alone = env.grid_best_action(
                TIMED, engine._map(lambda a: a[None], p), g[None],
                fixed_axis=axis, fixed_frac=1.0)[0]
            assert torch.equal(got[s], alone), (axis, s)


@pytest.mark.parametrize("allocator", ["fpa", "fca"])
def test_config_grid_round_matches_reference(allocator):
    """One ``CONFIG`` round of fcea + PDD on hetero_devices: decisions
    exact against the reference's default spec (whose grid bills with its
    sorted SIC from N = 64 on, the port's with the pairwise one: the
    chosen fractions still agree), the bill at rtol 1e-5 against
    ``sic_impl="pairwise"`` and at 1e-3 against the default."""
    kw = dict(policy="fcea", scheduler="pdd", allocator=allocator,
              scenario="dynamic")
    jspec = jengine.EngineSpec(**kw)
    jspec_pw = jengine.EngineSpec(**kw, sic_impl="pairwise")
    spec = engine.EngineSpec(**kw)
    jstate, jbundle, state, bundle = _start(JCONFIG, 0, "hetero_devices")
    draws = _round_draws(JCONFIG, jspec, jstate, jbundle)
    _, jm = jengine.round_step_jit(JCONFIG, jspec, jstate, jbundle)
    _, jm_pw = jengine.round_step_jit(JCONFIG, jspec_pw, jstate, jbundle)
    _, m = engine.round_step(CONFIG, spec, state, bundle, draws)
    got = engine.metrics_row(m)
    n_test = int(jbundle.test_y.shape[0])
    _assert_round(got, jengine.metrics_row(jm_pw), n_test, "pairwise")
    want = jengine.metrics_row(jm)
    np.testing.assert_array_equal(got["z"], want["z"])
    for k in ("n_associated", "n_available"):
        assert got[k] == want[k], k
    for k in ("cost", "total_time_s", "total_energy_j"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)

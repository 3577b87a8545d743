"""The port's fleet driver -- ``stack_fleet``, ``fleet_draws``,
``fleet_step``, ``run_fleet`` -- on the CPU.

* Against the live reference: ``jengine.run_fleet`` (``vmap`` of its
  scanned driver) over seeds 0-2 at the engine tests' ``SMALL``, with each
  lane's draws replayed from that lane's own key chain (``round_keys``)
  into the port's ``fleet_step``: z, n_associated, sweeps and the
  staleness exactly, cost/time/energy to rtol 1e-5, loss to rtol 1e-4
  (as in ``tests/test_torch_engine.py``), accuracy within 2 test samples,
  the final global params to rtol 1e-4, atol 1e-5.
* Each seed against its own run: every member of ``run_fleet`` follows
  its own ``run_scanned`` from the same generator -- decisions exactly,
  floats to rtol 1e-5, the reference's own fleet tolerance
  (``tests/test_round_engine.py``).
* No leakage across seeds: a fleet whose seeds' gains differ by orders of
  magnitude scores and associates each seed as it does alone.
"""
import re
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro_torch.core import association, engine, fuzzy
from repro_torch.faults import FaultSpec
from repro_torch.kernels import _build, hfl_ops
from repro_torch.models import mlp
from test_torch_engine import JSMALL, SMALL, _replayed_draws, _start
from _torch_threads import one_torch_thread  # noqa: F401

SEEDS = (0, 1, 2)
ROUNDS = 3

REFERENCE_CASES = [
    pytest.param(dict(policy="fcea", scheduler="pdd"), id="fcea-pdd"),
    pytest.param(dict(policy="gcea", scheduler="fastest"), id="gcea-fastest"),
    pytest.param(dict(policy="rcea", allocator="rra", scheduler="fastest"),
                 id="rcea-rra-fastest"),
    pytest.param(dict(policy="fcea", scheduler="pdd", candidates_k=2),
                 id="fcea-pdd-k2"),
]


def _lane_draws(jspec, keys, jbundles):
    """Each lane's round draws from its own key (all ``_replayed_draws``
    reads of a reference state), stacked for the port."""
    rows = [_replayed_draws(JSMALL, jspec, SimpleNamespace(key=keys[s]),
                            jax.tree.map(lambda a: a[s], jbundles))
            for s in range(len(keys))]
    return engine.RoundDraws(*(None if f[0] is None else torch.stack(f)
                               for f in zip(*rows)))


@pytest.mark.parametrize("kw", REFERENCE_CASES)
def test_fleet_matches_reference_run_fleet(kw):
    jspec = jengine.EngineSpec(**kw, telemetry=True)
    spec = engine.EngineSpec(**kw)
    starts = [_start(seed=s) for s in SEEDS]
    jstates, jbundles = jengine.stack_fleet([(js, jb)
                                             for js, jb, _, _ in starts])
    states, bundles = engine.stack_fleet([(st, b) for _, _, st, b in starts])
    jfinal, outs = jengine.run_fleet(JSMALL, jspec, jstates, jbundles,
                                     ROUNDS)
    jm, trace = jengine.split_output(jspec, outs)
    assert np.asarray(jm.accuracy).shape == (len(SEEDS), ROUNDS)
    # the seeds resolve in different numbers of sweeps in some round, so
    # the per-seed stop is exercised
    sweeps = np.asarray(trace.assoc_sweeps)
    assert any(len(set(col)) > 1 for col in sweeps.T.tolist())
    keys = [jstates.key[s] for s in range(len(SEEDS))]
    n_test = int(jbundles.test_y.shape[1])
    for r in range(ROUNDS):
        draws = _lane_draws(jspec, keys, jbundles)
        keys = [jengine.round_keys(jspec, k)[0] for k in keys]
        states, m = engine.fleet_step(SMALL, spec, states, bundles, draws)
        for s in range(len(SEEDS)):
            msg = f"{kw} seed {SEEDS[s]} round {r}"
            want = jengine.metrics_row(jax.tree.map(lambda a: a[s], jm), r)
            got = engine.metrics_row(engine.select_seed(m, s))
            np.testing.assert_array_equal(got["z"], want["z"], msg)
            for key in ("round", "n_associated", "n_available"):
                assert got[key] == want[key], (msg, key)
            assert got["sweeps"] == int(sweeps[s, r]), msg
            np.testing.assert_allclose(got["avg_staleness"],
                                       want["avg_staleness"], rtol=1e-6,
                                       err_msg=msg)
            for key in ("cost", "total_time_s", "total_energy_j"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                           err_msg=f"{msg} {key}")
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4,
                                       err_msg=msg)
            assert abs(got["accuracy"] - want["accuracy"]) <= 2.0 / n_test
    np.testing.assert_array_equal(states.staleness.numpy(),
                                  np.asarray(jfinal.staleness))
    for k, leaf in states.global_params.items():
        np.testing.assert_allclose(leaf.numpy(),
                                   np.asarray(jfinal.global_params[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def _own_runs(cfg, spec, seeds, rounds, gen_seed=lambda s: 100 + s):
    """``run_fleet`` of ``seeds`` and each seed's own ``run_scanned``, from
    the same ``init_simulation`` and a generator seeded ``gen_seed(s)``."""
    pairs, gens, own = [], [], []
    for s in seeds:
        state, bundle, _ = engine.init_simulation(cfg, seed=s, device="cpu")
        pairs.append((state, bundle))
        gens.append(torch.Generator().manual_seed(gen_seed(s)))
        own.append(engine.run_scanned(cfg, spec, state, bundle, rounds,
                                      torch.Generator().manual_seed(
                                          gen_seed(s))))
    states, bundles = engine.stack_fleet(pairs)
    fleet = engine.run_fleet(cfg, spec, states, bundles, rounds, gens)
    return fleet, own


OWN_CASES = REFERENCE_CASES + [
    pytest.param(dict(policy="fcea", scheduler="pdd", noma_enabled=False),
                 id="fcea-pdd-oma"),
    pytest.param(dict(policy="gcea", scheduler="fastest", candidates_k=1,
                      noma_enabled=False), id="gcea-fastest-oma-k1"),
]


@pytest.mark.parametrize("kw", OWN_CASES)
def test_every_member_follows_its_own_run(kw):
    spec = engine.EngineSpec(**kw)
    seeds = (0, 3, 4, 7)
    (states, fm), own = _own_runs(SMALL, spec, seeds, ROUNDS)
    assert fm.accuracy.shape == (len(seeds), ROUNDS)
    assert fm.z.shape == (len(seeds), ROUNDS, SMALL.n_edges)
    assert fm.round.shape == fm.sweeps.shape == (len(seeds), ROUNDS)
    assert states.round_idx == ROUNDS
    for s, (o_state, om) in enumerate(own):
        sm = engine.select_seed(fm, s)
        for i in range(ROUNDS):
            got, want = engine.metrics_row(sm, i), engine.metrics_row(om, i)
            msg = f"{kw} seed {seeds[s]} round {i}"
            np.testing.assert_array_equal(got["z"], want["z"], msg)
            for key in ("round", "n_associated", "n_available", "sweeps"):
                assert got[key] == want[key], (msg, key)
            for key in ("accuracy", "loss", "avg_staleness", "cost",
                        "total_time_s", "total_energy_j"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                           err_msg=f"{msg} {key}")
        assert torch.equal(states.staleness[s], o_state.staleness)
        assert torch.equal(states.gains[s], o_state.gains)
        for k in o_state.global_params:
            torch.testing.assert_close(states.global_params[k][s],
                                       o_state.global_params[k], rtol=1e-5,
                                       atol=1e-7)
            torch.testing.assert_close(states.client_params[k][s],
                                       o_state.client_params[k], rtol=1e-5,
                                       atol=1e-7)


@pytest.mark.parametrize("kw", [
    pytest.param(dict(policy="gcea", scheduler="fastest"), id="dense"),
    pytest.param(dict(policy="gcea", scheduler="fastest", candidates_k=2),
                 id="k2")])
def test_seeds_stop_at_their_own_sweep(kw):
    """Seeds whose resolutions take different numbers of sweeps: each
    counts its own, and its association is the one it gets alone -- the
    loop keeps running for the others without touching it."""
    spec = engine.EngineSpec(**kw)
    seeds = tuple(range(8))
    (_, fm), own = _own_runs(SMALL, spec, seeds, 2)
    assert len({tuple(row) for row in fm.sweeps.tolist()}) > 1
    assert len(set(fm.sweeps[:, 0].tolist())) > 1
    for s, (_, om) in enumerate(own):
        assert fm.sweeps[s].tolist() == om.sweeps.tolist()
        assert torch.equal(fm.n_associated[s], om.n_associated)
        assert torch.equal(fm.z[s], om.z)


def _fleet_inputs(scales, seed=0):
    """(S, N, M) gains of one world scaled by ``scales`` (orders of
    magnitude apart), counts and staleness that differ by seed."""
    rng = np.random.default_rng(seed)
    n, m = 16, 3
    g = rng.uniform(1e-12, 1e-8, (n, m)).astype(np.float32)
    gains = torch.tensor(np.stack([g * np.float32(c) for c in scales]))
    counts = torch.tensor(rng.integers(60, 121, (len(scales), n))
                          .astype(np.float32))
    top = 4 + 3 * np.arange(len(scales))[:, None]       # ranges differ too
    stale = torch.tensor(rng.integers(1, top, (len(scales), n))
                         .astype(np.int32))
    dist = torch.tensor(rng.uniform(10.0, 400.0, (len(scales), n, m))
                        .astype(np.float32))
    return gains, counts, stale, dist


def test_fleet_scores_each_seed_on_its_own_range():
    """The Eq. 21 min/max and max staleness are per seed: the fleet's
    scores equal each seed's own, bit for bit, dense and on the frontier,
    and a fleet-wide normalisation would have given other scores."""
    gains, counts, stale, dist = _fleet_inputs((1.0, 1e6, 1e-6))
    dense = hfl_ops.score_matrix(gains, counts, stale, data_max=120.0)
    idx = torch.sort(dist, dim=-1, stable=True).indices[..., :2].int()
    front = hfl_ops.score_candidates(gains, idx, counts, stale,
                                     data_max=120.0)
    assert dense.shape == (3, 16, 3) and front.shape == (3, 16, 2)
    for s in range(3):
        assert torch.equal(dense[s], hfl_ops.score_matrix(
            gains[s], counts[s], stale[s], data_max=120.0))
        assert torch.equal(front[s], hfl_ops.score_candidates(
            gains[s], idx[s], counts[s], stale[s], data_max=120.0))
    pooled = fuzzy.score_matrix(gains.reshape(-1, 3), counts.reshape(-1),
                                stale.reshape(-1), data_max=120.0)
    assert not torch.equal(pooled.reshape(3, 16, 3), dense)


def test_fleet_associates_each_seed_as_alone():
    """``associate`` over the fleet's scores: each seed's association and
    sweeps are its own call's; and one fleet round from scaled gains is
    each seed's own round."""
    gains, counts, stale, dist = _fleet_inputs((1.0, 1e6, 1e-6))
    scores = hfl_ops.score_matrix(gains, counts, stale, data_max=120.0)
    assoc, sweeps = association.associate(
        "fcea", scores=scores, gains=gains, dist=dist, quota=3,
        coverage_radius_m=300.0, return_sweeps=True)
    for s in range(3):
        one, n_sw = association.associate(
            "fcea", scores=scores[s], gains=gains[s], dist=dist[s], quota=3,
            coverage_radius_m=300.0, return_sweeps=True)
        assert torch.equal(assoc[s], one) and sweeps[s] == n_sw

    spec = engine.EngineSpec()
    pairs, gens = [], []
    for s, scale in enumerate((1.0, 1e6, 1e-6)):
        state, bundle, aux = engine.init_simulation(SMALL, seed=s,
                                                    device="cpu")
        pairs.append((state._replace(gains=state.gains * scale), bundle))
        gens.append(aux["generator"])
    states, bundles = engine.stack_fleet(pairs)
    draws = engine.fleet_draws(SMALL, bundles, gens, spec)
    _, fm = engine.fleet_step(SMALL, spec, states, bundles, draws)
    for s, (state, bundle) in enumerate(pairs):
        one = engine.RoundDraws(*(None if f is None else f[s]
                                  for f in draws))
        _, m = engine.round_step(SMALL, spec, state, bundle, one)
        assert torch.equal(fm.z[s], m.z)
        assert int(fm.sweeps[s]) == m.sweeps
        assert torch.equal(fm.n_associated[s], m.n_associated)
        torch.testing.assert_close(fm.cost[s], m.cost, rtol=1e-5, atol=0.0)


def test_fleet_draws_are_each_seeds_own():
    """Every field of seed s's fleet draws (the fault uniforms, with
    faults on, too; an absent field stays absent) is its own
    ``sample_draws``'s."""
    pairs = [engine.init_simulation(SMALL, seed=s, device="cpu")[:2]
             for s in (0, 1)]
    _, bundles = engine.stack_fleet(pairs)
    for spec in (engine.EngineSpec(policy="rcea", allocator="rra"),
                 engine.EngineSpec(faults=FaultSpec(edge_p_kill=0.1))):
        draws = engine.fleet_draws(SMALL, bundles, [
            torch.Generator().manual_seed(5),
            torch.Generator().manual_seed(6)], spec)
        assert (draws.faults is None) == (spec.faults is None)
        for s, gen_seed in enumerate((5, 6)):
            want = engine.sample_draws(
                SMALL, pairs[s][1], torch.Generator().manual_seed(gen_seed),
                spec)
            engine._map(lambda got, w: torch.equal(got, w)
                        or pytest.fail(f"seed {s}: {spec}"),
                        engine.select_seed(draws, s), want)
    spec = engine.EngineSpec(policy="rcea", allocator="rra")
    with pytest.raises(ValueError, match="generators"):
        engine.fleet_draws(SMALL, bundles, [torch.Generator()], spec)


def test_fleet_loss_is_each_seeds_own():
    """``mlp.loss`` over a fleet's models and test sets (S = 3) equals,
    seed by seed and bit for bit, the loss of that seed's model alone and
    in a fleet of one."""
    rng = np.random.default_rng(5)
    models = [mlp.init_params(20, 12, 10,
                              generator=torch.Generator().manual_seed(s),
                              device=torch.device("cpu")) for s in range(3)]
    fleet = {k: torch.stack([m[k] for m in models]) for k in models[0]}
    x = torch.tensor(rng.normal(size=(3, 500, 20)).astype(np.float32))
    y = torch.tensor(rng.integers(0, 10, (3, 500)).astype(np.int32))
    got = mlp.loss(fleet, x, y)
    assert got.shape == (3,)
    for s, m in enumerate(models):
        assert torch.equal(got[s], mlp.loss(m, x[s], y[s]))
        one = mlp.loss({k: v[None] for k, v in m.items()}, x[s:s + 1],
                       y[s:s + 1])
        assert torch.equal(got[s:s + 1], one)


def test_stack_fleet_needs_one_round():
    a = engine.init_simulation(SMALL, seed=0, device="cpu")[:2]
    b = engine.init_simulation(SMALL, seed=1, device="cpu")[:2]
    states, bundles = engine.stack_fleet([a, b])
    assert states.gains.shape == (2, SMALL.n_clients, SMALL.n_edges)
    assert states.client_params["w1"].shape == (
        2, SMALL.n_clients, SMALL.input_dim, SMALL.hidden)
    assert bundles.x.shape[0] == 2 and states.round_idx == 0
    with pytest.raises(ValueError, match="round_idx"):
        engine.stack_fleet([a, (b[0]._replace(round_idx=1), b[1])])


def test_round_step_is_a_fleet_of_one():
    """``round_step`` unsqueezes, runs ``fleet_step`` and squeezes: the
    same metrics and state as ``fleet_step`` over the lifted inputs."""
    spec = engine.EngineSpec()
    state, bundle, aux = engine.init_simulation(SMALL, seed=2, device="cpu")
    draws = engine.sample_draws(SMALL, bundle, aux["generator"], spec)
    s1, m1 = engine.round_step(SMALL, spec, state, bundle, draws)
    sf, mf = engine.fleet_step(SMALL, spec, engine._lift(state),
                               engine._lift(bundle), engine._lift(draws))
    assert isinstance(m1.sweeps, int) and m1.sweeps == int(mf.sweeps[0])
    for a, b in zip(m1, engine.select_seed(mf, 0)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert torch.equal(s1.staleness, sf.staleness[0])
    for k in s1.global_params:
        assert torch.equal(s1.global_params[k], sf.global_params[k][0])


def test_ctypes_signatures_match_the_c_entry_points():
    """Every entry point's ctypes argument list has as many entries as its
    C declaration has parameters: a seed axis added to a kernel's C
    signature must reach its binding."""
    src = "\n".join(p.read_text() for p in _build.sources())
    for name, argtypes in _build._SIGNATURES.items():
        m = re.search(rf"\bint {name}\(([^)]*)\)", src)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name


def test_seed_grid_limit_matches_the_source():
    """The wrappers refuse more seeds than the kernels' y grid holds, the
    limit both C entry points check."""
    src = (_build.CSRC / "hfl_ops.cu").read_text()
    assert src.count(f"seeds > {hfl_ops.MAX_SEEDS}") == 2
    assert hfl_ops._seeds(()) == 1
    assert hfl_ops._seeds((3, hfl_ops.MAX_SEEDS // 3)) == hfl_ops.MAX_SEEDS
    with pytest.raises(ValueError, match="seeds"):
        hfl_ops._seeds((hfl_ops.MAX_SEEDS + 1,))

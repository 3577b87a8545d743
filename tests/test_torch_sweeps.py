"""The port's sweep runner (``repro_torch.sweeps``) held to the reference's
``repro.sweeps`` on the CPU.

The grid's cells, ids and groups equal the reference's; a small grid
(SMALL, 2 scenarios × fcea/gcea × 2 seeds, 3 rounds) runs cell for cell
as the reference's ``run_sweep`` does, with the port's world init and
draws replaced in this file by the reference's converted state and
replayed draws (each lane's own key chain, found by its generator's
state): integers exact, the bill at rtol 1e-5, the loss at rtol 1e-4, the
accuracy within 2 test samples (the fleet test's tolerances).  The files
``run_sweep`` writes have the reference's names and keys (a spec without
the reference's implementation switches) and render with
``results/render_tables.py``.
"""
import dataclasses
import importlib.util
import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro import scenarios as jscenarios
from repro import sweeps as jsweeps
from repro.core import engine as jengine
from repro_torch import convert, scenarios, sweeps
from repro_torch.core import ddpg, engine
from repro_torch.sweeps import grid as sweep_grid
from test_torch_engine import JSMALL, SMALL
from test_torch_scenarios import _round_draws
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _blackout(mod):
    return mod.ScenarioSpec(kind="markov_dropout", p_drop=1.0, p_return=0.0)


GRID_CASES = [
    pytest.param(lambda mod: dict(
        scenarios=("random_waypoint", "markov_dropout", "hetero_devices"),
        policies=("fcea", "gcea"), seeds=(0, 1)), id="dynamic"),
    pytest.param(lambda mod: dict(
        scenarios=("static", ("blackout", _blackout(mod))),
        policies=("gcea",), allocators=("mid", "ddpg"),
        engine_modes=("sync", "buffered")), id="pairs-modes-ddpg"),
    pytest.param(lambda mod: dict(
        scenarios=("static", "full_dynamic", _blackout(mod)),
        schedulers=("pdd", "fastest"), noma=(True, False), seeds=(3,),
        candidates_k=2), id="specs-noma-k2"),
    pytest.param(lambda mod: dict(
        scenarios=("static", "random_waypoint"), policies=("fcea", "gcea"),
        engine_modes=("sync", "buffered"), buffer_fill=2, timeout_s=2.0,
        n_tiers=2, retier_every=3), id="buffered-knobs")]

# the reference's implementation switches, which the port's EngineSpec
# does not have, so its written specs lack them
REFERENCE_ONLY_SPEC = {"resolver", "sic_impl", "pallas_score", "train_impl"}


@pytest.mark.parametrize("case", GRID_CASES)
def test_expand_grid_and_groups_match_reference(case):
    """Cell ids and order, and the partition into groups with each group's
    spec, as the reference's."""
    grid = sweeps.SweepGrid(name="t", **case(scenarios))
    jgrid = jsweeps.SweepGrid(name="t", **case(jscenarios))
    cells, jcells = sweeps.expand_grid(grid), jsweeps.expand_grid(jgrid)
    assert [c.cell_id for c in cells] == [c.cell_id for c in jcells]
    for c, jc in zip(cells, jcells):
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)
    groups = sweep_grid._group_cells(cells, grid)
    jgroups = jsweeps.grid._group_cells(jcells, jgrid)
    assert [[c.cell_id for c in g] for g in groups.values()] == \
        [[c.cell_id for c in g] for g in jgroups.values()]
    for spec, jspec in zip(groups, jgroups):
        want = dataclasses.asdict(jspec)
        got = dataclasses.asdict(spec)
        assert set(want) - set(got) == REFERENCE_ONLY_SPEC
        for k, v in got.items():
            assert v == want[k], k


def test_duplicate_scenario_labels_rejected():
    a = scenarios.ScenarioSpec(kind="markov_dropout", p_drop=0.1)
    b = scenarios.ScenarioSpec(kind="markov_dropout", p_drop=0.9)
    with pytest.raises(ValueError, match="ambiguous"):
        sweeps.expand_grid(sweeps.SweepGrid(name="t", scenarios=(a, b)))


def _bits(gen):
    return bytes(gen.get_state().numpy())


def _replay_reference(monkeypatch):
    """The port's ``init_simulation`` and ``fleet_draws`` replaced by the
    reference's: each world built by the reference and carried over, its
    generator a marker whose state names the world and the round, and
    each lane's draws replayed from that world's own key chain."""
    lanes = {}

    def init(cfg, *, seed, iid, device, scenario):
        jstate, jbundle, _ = jengine.init_simulation(
            JSMALL, seed=seed, iid=iid, scenario=jscenarios.ScenarioSpec(
                **dataclasses.asdict(scenario)))
        state, bundle = convert.state_from_numpy(
            jax.tree.map(np.asarray, jstate._replace(key=None)),
            jax.tree.map(np.asarray, jbundle), "cpu")
        gen = torch.Generator().manual_seed(1000 + len(lanes))
        lanes[_bits(gen)] = (jstate.key, jbundle)
        return state, bundle, {"generator": gen}

    def draws(cfg, bundles, generators, spec):
        jspec = jengine.EngineSpec(policy=spec.policy,
                                   allocator=spec.allocator,
                                   scheduler=spec.scheduler,
                                   scenario=spec.scenario)
        rows = []
        for gen in generators:
            key, jbundle = lanes[_bits(gen)]
            rows.append(_round_draws(JSMALL, jspec, SimpleNamespace(key=key),
                                     jbundle))
            torch.rand((1,), generator=gen)        # the next round's marker
            lanes[_bits(gen)] = (jengine.round_keys(jspec, key)[0], jbundle)
        return engine._map(lambda *t: torch.stack(t), *rows)

    monkeypatch.setattr(engine, "init_simulation", init)
    monkeypatch.setattr(engine, "fleet_draws", draws)


PARITY = dict(name="parity", scenarios=("static", "random_waypoint"),
              policies=("fcea", "gcea"), seeds=(0, 1), n_rounds=3)


def test_small_grid_matches_reference_run_sweep(monkeypatch):
    """2 scenarios × fcea/gcea × 2 seeds, 3 rounds, in 4 groups: every
    cell's rows as the reference's ``run_sweep`` gives them."""
    want = jsweeps.run_sweep(JSMALL, jsweeps.SweepGrid(**PARITY),
                             write_json=False)
    n_test = int(engine.init_simulation(SMALL, seed=0, device="cpu")[1]
                 .test_y.shape[0])
    _replay_reference(monkeypatch)
    got = sweeps.run_sweep(SMALL, sweeps.SweepGrid(**PARITY),
                           write_json=False, device="cpu")
    assert got["n_cells"] == want["n_cells"] == 8
    assert got["n_compiles"] == want["n_compiles"] == 4
    assert not got["failed_cells"]
    assert [g["n_cells"] for g in got["groups"]] == [2, 2, 2, 2]
    assert list(got["cells"]) == list(want["cells"])
    for cid, w in want["cells"].items():
        g = got["cells"][cid]
        assert set(g) == set(w), cid
        for k in ("round", "n_associated", "n_available", "z",
                  "avg_staleness"):
            assert g[k] == w[k], (cid, k)
        for k in ("cost", "total_time_s", "total_energy_j"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                       err_msg=f"{cid} {k}")
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4,
                                   err_msg=cid)
        assert np.max(np.abs(np.subtract(g["accuracy"], w["accuracy"]))
                      ) <= 2.0 / n_test, cid
    assert got["final"].keys() == want["final"].keys()


# the buffered engine's four grid knobs off their defaults (SMALL's
# automatic fill is 3, its tiers 4, its timeout 10 s, a retier every 8)
KNOBS = dict(name="knobs", scenarios=("static",), policies=("fcea", "gcea"),
             seeds=(0, 1), n_rounds=6, engine_modes=("buffered",),
             buffer_fill=2, timeout_s=2.0, n_tiers=2, retier_every=3)


def test_buffered_knob_grid_matches_reference_run_sweep(monkeypatch):
    """fcea/gcea × 2 seeds, 6 buffered micro-steps, with ``buffer_fill``,
    ``timeout_s``, ``n_tiers`` and ``retier_every`` off their defaults:
    every group's spec and every cell's rows as the reference's
    ``run_sweep`` gives them (the bill also within 1e-5 of the cell's
    virtual clock, as ``test_torch_buffered.py`` holds it)."""
    want = jsweeps.run_sweep(JSMALL, jsweeps.SweepGrid(**KNOBS),
                             write_json=False)
    n_test = int(engine.init_simulation(SMALL, seed=0, device="cpu")[1]
                 .test_y.shape[0])
    _replay_reference(monkeypatch)
    got = sweeps.run_sweep(SMALL, sweeps.SweepGrid(**KNOBS),
                           write_json=False, device="cpu")
    assert got["n_cells"] == want["n_cells"] == 4
    assert got["n_compiles"] == want["n_compiles"] == 2
    assert not got["failed_cells"]
    for g, w in zip(got["groups"], want["groups"]):
        spec = {k: v for k, v in w["spec"].items()
                if k not in REFERENCE_ONLY_SPEC}
        assert g["spec"] == spec
        assert (g["spec"]["buffer_fill"], g["spec"]["timeout_s"],
                g["spec"]["n_tiers"], g["spec"]["retier_every"]) == \
            (2, 2.0, 2, 3)
    assert list(got["cells"]) == list(want["cells"])
    for cid, w in want["cells"].items():
        g = got["cells"][cid]
        assert set(g) == set(w), cid
        for k in ("round", "n_associated", "n_available", "z",
                  "avg_staleness"):
            assert g[k] == w[k], (cid, k)
        clock = np.cumsum(w["total_time_s"])
        for k, atol in (("total_energy_j", 0.0),
                        ("total_time_s", 1e-5 * clock),
                        ("cost", 1e-5 * clock * JSMALL.lambda_t)):
            gap = np.abs(np.subtract(g[k], w[k]))
            assert np.all(gap <= atol + 1e-5 * np.abs(w[k])), (cid, k, gap)
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4,
                                   err_msg=cid)
        assert np.max(np.abs(np.subtract(g["accuracy"], w["accuracy"]))
                      ) <= 2.0 / n_test, cid


def test_a_cell_equals_its_own_run_scanned():
    """Cells of the first and the last group bit-equal to their own
    ``run_scanned`` from a fresh ``init_simulation(seed)``, whatever groups
    ran before (the worlds are shared, the generators fresh each group)."""
    grid = sweeps.SweepGrid(**{**PARITY, "n_rounds": 2})
    out = sweeps.run_sweep(SMALL, grid, write_json=False, device="cpu")
    cells = {c.cell_id: c for c in sweeps.expand_grid(grid)}
    for cid in ("static__fcea__mid__pdd__noma__s1",
                "random_waypoint__gcea__mid__pdd__noma__s0"):
        cell = cells[cid]
        state, bundle, aux = engine.init_simulation(
            SMALL, seed=cell.seed, device="cpu", scenario=cell.sspec)
        _, ms = engine.run_scanned(SMALL, sweep_grid._spec_for(cell, grid),
                                   state, bundle, grid.n_rounds,
                                   aux["generator"])
        rows = out["cells"][cid]
        for k in rows:
            assert rows[k] == getattr(ms, k).tolist(), (cid, k)


def _render_tables():
    spec = importlib.util.spec_from_file_location(
        "render_tables", os.path.join(ROOT, "results", "render_tables.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shape(obj):
    """The key structure of a JSON value: dicts by key, lists by their
    length and first element."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [len(obj)] + ([_shape(obj[0])] if obj else [])
    return type(obj).__name__ if not isinstance(obj, (int, float)) else "n"


def _without_reference_only(payload):
    """A reference file with ``REFERENCE_ONLY_SPEC`` taken out of each
    spec it holds (a cell file's, a summary's groups')."""
    for holder in [payload] + payload.get("groups", []):
        if "spec" in holder:
            holder["spec"] = {k: v for k, v in holder["spec"].items()
                              if k not in REFERENCE_ONLY_SPEC}
    return payload


def test_written_files_match_the_reference_key_for_key(tmp_path):
    """Telemetry on, 2 scenarios × 2 seeds: the same file names, and each
    file (cell, spec, metrics, trace, summary with its groups) with the
    same keys and lengths, but for the reference's implementation
    switches, which a port spec, the port's own ``EngineSpec``, lacks;
    ``render_tables.sweep_report`` renders the port's directory."""
    kw = dict(name="t", scenarios=("static", "markov_dropout"),
              policies=("gcea",), schedulers=("fastest",), seeds=(0, 1),
              n_rounds=2, telemetry=True)
    jsweeps.run_sweep(JSMALL, jsweeps.SweepGrid(**kw),
                      out_dir=str(tmp_path / "ref"))
    sweeps.run_sweep(SMALL, sweeps.SweepGrid(**kw),
                     out_dir=str(tmp_path / "port"), device="cpu")
    ref, port = tmp_path / "ref" / "sweep_t", tmp_path / "port" / "sweep_t"
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(port)) == names
    assert len(names) == 2 * 4 + 1
    for name in names:
        want = _without_reference_only(json.loads((ref / name)
                                                  .read_text()))
        got = json.loads((port / name).read_text())
        if "spec" in got:
            cell = sweeps.SweepCell(**{
                **got["cell"],
                "sspec": scenarios.ScenarioSpec(**got["cell"]["sspec"])})
            assert got["spec"] == dataclasses.asdict(sweep_grid._spec_for(
                cell, sweeps.SweepGrid(**kw))), name
        if name == "summary.json":
            for g in got["groups"] + want["groups"]:
                g["wall_s"] = 0.0
        assert _shape(got) == _shape(want), name
    report = _render_tables().sweep_report(str(port))
    assert "Final accuracy" in report and "Mean round cost" in report
    assert "gcea/mid/fastest/noma" in report
    assert "| static |" in report and "| markov_dropout |" in report
    assert "±" in report


DDPG_GRID = dict(name="t", scenarios=("full_dynamic",), policies=("gcea",),
                 schedulers=("fastest",), allocators=("ddpg", "mid"),
                 seeds=(0, 1), n_rounds=2, ddpg_episodes=1, ddpg_steps=4,
                 ddpg_warmup=2, ddpg_hidden=16)


def test_ddpg_cells_train_their_own_actor_on_their_own_world():
    """Each ddpg cell trains its own actor (one ``train_allocator_fleet``
    a group) from the documented training generator: a cell's rows are
    those of its own world billed by the actor ``train_allocator`` trains
    from ``TRAIN_SEED_BASE + seed``."""
    grid = sweeps.SweepGrid(**DDPG_GRID)
    out = sweeps.run_sweep(SMALL, grid, write_json=False, device="cpu")
    trained = [g for g in out["groups"] if g["spec"]["allocator"] == "ddpg"]
    assert len(trained) == 1 and len(out["groups"]) == 2
    assert trained[0]["ddpg_trained"] is True
    assert trained[0]["ddpg_actors"] == 2
    assert trained[0]["ddpg_train_s"] > 0
    costs = {cid: rows["cost"] for cid, rows in out["cells"].items()}
    d0, d1 = (costs[f"full_dynamic__gcea__ddpg__fastest__noma__s{s}"]
              for s in (0, 1))
    assert d0 != d1
    assert d0 != costs["full_dynamic__gcea__mid__fastest__noma__s0"]
    cell = [c for c in sweeps.expand_grid(grid)
            if c.allocator == "ddpg" and c.seed == 1][0]
    spec = sweep_grid._spec_for(cell, grid)
    state, bundle, aux = engine.init_simulation(SMALL, seed=1, device="cpu",
                                                scenario=cell.sspec)
    gen = torch.Generator().manual_seed(sweep_grid.TRAIN_SEED_BASE + 1)
    dcfg = ddpg.allocator_config(SMALL, spec, hidden=16)
    agent = ddpg.init_ddpg(gen, dcfg)
    draws = ddpg.sample_ddpg_draws(SMALL, dcfg, [gen], 1, 4).seed(0)
    agent, _ = ddpg.train_allocator(SMALL, spec, state, bundle, dcfg, agent,
                                    draws, warmup=2)
    _, ms = engine.run_scanned(SMALL, spec, state, bundle, 2,
                               aux["generator"], agent.actor)
    rows = out["cells"][cell.cell_id]
    assert rows["n_associated"] == ms.n_associated.tolist()
    np.testing.assert_allclose(rows["cost"], ms.cost.numpy(), rtol=1e-5)


def test_shared_actor_with_mixed_observation_shapes_is_refused():
    grid = sweeps.SweepGrid(name="t", scenarios=("static", "full_dynamic"),
                            allocators=("ddpg",))
    with pytest.raises(ValueError, match="observation"):
        sweeps.run_sweep(SMALL, grid, write_json=False, device="cpu",
                         actor_params={"w": torch.zeros(1)})


def test_a_failing_group_is_recorded_and_the_rest_runs(tmp_path,
                                                        monkeypatch):
    """A group that raises is written against each of its cells; the
    other group's cells run and are written."""
    run_fleet = engine.run_fleet

    def flaky(cfg, spec, *a, **kw):
        if spec.policy == "gcea":
            raise RuntimeError("injected group failure")
        return run_fleet(cfg, spec, *a, **kw)
    monkeypatch.setattr(engine, "run_fleet", flaky)
    grid = sweeps.SweepGrid(name="t", scenarios=("static",),
                            policies=("gcea", "fcea"), seeds=(0, 1),
                            n_rounds=1)
    out = sweeps.run_sweep(SMALL, grid, out_dir=str(tmp_path), device="cpu")
    assert sorted(out["failed_cells"]) == [
        "static__gcea__mid__pdd__noma__s0", "static__gcea__mid__pdd__noma__s1"]
    assert all("injected group failure" in e
               for e in out["failed_cells"].values())
    assert sorted(out["final"]) == ["static__fcea__mid__pdd__noma__s0",
                                    "static__fcea__mid__pdd__noma__s1"]
    assert "error" in out["groups"][0] and "wall_s" in out["groups"][1]
    written = json.loads((tmp_path / "sweep_t" / "summary.json").read_text())
    assert written["failed_cells"] == out["failed_cells"]
    assert (tmp_path / "sweep_t" / "static__fcea__mid__pdd__noma__s1.json"
            ).exists()


def test_quick_cli_runs_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.sweeps.grid --quick --device cpu``: the
    reference's demo grid, 12 cells in 6 groups, written and printed."""
    sweep_grid.main(["--quick", "--device", "cpu", "--out", str(tmp_path)])
    summary = json.loads((tmp_path / "sweep_demo" / "summary.json")
                         .read_text())
    assert summary["n_cells"] == 12 and summary["n_compiles"] == 6
    assert not summary["failed_cells"]
    assert len(os.listdir(tmp_path / "sweep_demo")) == 13
    assert "static__fcea__mid__pdd__noma__s0: acc=" in capsys.readouterr().out

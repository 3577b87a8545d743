"""Declarative scenario × policy × allocator sweep runner (the reference's
``repro.sweeps.grid``).

A ``SweepGrid`` names the axes of an experiment grid -- scenarios (preset
names, ``ScenarioSpec``s or ``(label, ScenarioSpec)`` pairs), association
policies, allocators, schedulers, NOMA on/off, seeds, engine modes -- and
``run_sweep`` runs its cross product in as few batched calls as the
engine's switches allow:

* the axes that pick code paths (policy, allocator, scheduler, NOMA, the
  scenario's engine kind, the engine mode) partition the grid into groups
  of one ``EngineSpec``;
* everything else (a scenario's parameters, the seed) is data: the cells
  of a group are stacked along the fleet axis (``engine.stack_fleet``) and
  the group runs as one ``engine.run_fleet`` call, or one
  ``engine.run_fleet_actors`` call for ddpg cells that train their own
  actors.  Every built-in dynamic scenario is the engine kind "dynamic",
  so all of them ride one group a policy.

Worlds and draws.  Cells that differ only in their group's switches share
one ``(seed, scenario)`` world, built once by ``init_simulation`` with its
generator's state (``get_state()``) taken right after.  Every group gives
each of its cells a fresh ``torch.Generator`` set to its world's state,
so a cell draws what its own ``engine.run_scanned`` from a fresh
``init_simulation(seed)`` draws, whatever groups ran before it: the fcea
and the gcea cell of one world see the same fading, as in the reference,
whose draw key lives in the shared state.

DDPG cells.  With no ``actor_params``, each ddpg cell trains its own
actor on its own world: ``ddpg.allocator_config`` at ``ddpg_hidden``,
``init_ddpg``, ``sample_ddpg_draws`` (and rcea's snapshot uniforms), in
that order, from a training generator seeded with ``7919 · 2³² + seed``
-- a stream apart from ``init_simulation(seed)``'s, which seeds with
``seed`` (the reference folds 7919 into the seed's key for the same
purpose) -- then ``train_allocator_fleet`` over the group's stacked
worlds at the grid's ``ddpg_*`` budget.  ``actor_params`` instead gives
one shared actor to every ddpg cell; a grid that then mixes static (2N,)
and dynamic (3N,) observations is refused.

Output.  Each cell's rows go to ``<out_dir>/sweep_<name>/<cell_id>.json``
(with telemetry also ``<cell_id>.trace.json``) and the whole sweep to
``summary.json``, key for key as the reference writes them, so
``results/render_tables.py`` renders either.  Every metrics leaf and
trace leaf is copied to the host once a group, and a group's ``wall_s``
is read after that copy.  A group that raises is recorded against each
of its cells, and the sweep goes on.

The buffered knobs ``buffer_fill``, ``timeout_s``, ``n_tiers`` and
``retier_every`` go into every cell's ``EngineSpec``, as the
reference's; like the reference's grid it has no ``buffer_lr``, so a
sweep's server step is ``EngineSpec``'s default.

Sharded.  ``run_sweep(..., mesh=engine.fleet_mesh())`` splits each
group's fleet over the mesh's ranks through ``engine.run_fleet_sharded``
(``per_sim_actors`` for ddpg cells that train their own actors, which
every rank trains, as the reference trains them before it shards); each
rank builds the worlds on its own card, every cell is bit-equal to the
unsharded sweep's, and only rank 0 writes files.  A group that fails on
one rank fails on every rank (``engine.PeerFailed``), so the ranks record
it alike and go on together; a failed collective or kernel build is
raised, not recorded.

Not carried over from the reference: ``SweepGrid.sic_impl``, since the
port bills the dense path with one SIC formulation, the pairwise one.  A
written spec is the port's own ``EngineSpec``, so it lacks the
reference's implementation switches (``resolver``, ``sic_impl``,
``pallas_score``, ``train_impl``).

    PYTHONPATH=src python -m repro_torch.sweeps.grid --quick [--device cpu]
    torchrun --nproc_per_node=W -m repro_torch.sweeps.grid --quick --sharded
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import scenarios
from repro_torch.core import engine
from repro_torch.device import resolve_device
from repro_torch.faults import FaultSpec
from repro_torch.kernels._build import BuildError

DEFAULT_OUT = "results_torch"
# the ddpg training generator of a cell is seeded with TRAIN_SEED_BASE + seed
TRAIN_SEED_BASE = 7919 << 32
# the chaos grid's faults: the reference's chaos sweep cell (edge churn and
# a lossy, channel-tied uplink)
CHAOS = FaultSpec(edge_p_kill=0.2, edge_p_respawn=0.5, uplink_p_loss=0.1,
                  uplink_loss_slope=0.2)


@dataclasses.dataclass(frozen=True)
class SweepCell:
    """One point of the grid; carries the resolved scenario spec, so a
    custom parameterisation survives the trip through the runner."""
    scenario: str                  # display label (preset name / kind)
    sspec: scenarios.ScenarioSpec
    policy: str
    allocator: str
    scheduler: str
    noma_enabled: bool
    seed: int
    engine_mode: str = "sync"      # sync | buffered

    @property
    def cell_id(self) -> str:
        noma = "noma" if self.noma_enabled else "oma"
        mode = "" if self.engine_mode == "sync" else f"__{self.engine_mode}"
        return (f"{self.scenario}__{self.policy}__{self.allocator}"
                f"__{self.scheduler}__{noma}__s{self.seed}{mode}")


@dataclasses.dataclass
class SweepGrid:
    """The declarative grid: every sequence field is an axis of the cross
    product.  ``scenarios`` entries may be preset names or kind strings,
    ``ScenarioSpec``s, or ``(label, ScenarioSpec)`` pairs -- a pair gives
    a custom parameterisation its own cell label."""
    name: str
    scenarios: Sequence[Any] = ("static",)
    policies: Sequence[str] = ("fcea",)
    allocators: Sequence[str] = ("mid",)
    schedulers: Sequence[str] = ("pdd",)
    noma: Sequence[bool] = (True,)
    seeds: Sequence[int] = (0,)
    n_rounds: int = 10
    iid: bool = True
    # every cell on the (N, K) candidate frontier; None = dense
    candidates_k: "int | None" = None
    # every cell also writes its per-round RoundTrace
    telemetry: bool = False
    # "sync" rounds and/or "buffered" micro-steps (n_rounds of them); the
    # next four fields set every buffered cell's trigger and tiers
    engine_modes: Sequence[str] = ("sync",)
    buffer_fill: int = 0           # 0 = auto ((quota · M) // 2)
    timeout_s: float = 10.0
    n_tiers: int = 4
    retier_every: int = 8
    # a FaultSpec makes every cell a chaos cell; None: the layer is off
    faults: "FaultSpec | None" = None
    # each ddpg cell's training budget (when no actor_params is given)
    ddpg_episodes: int = 12
    ddpg_steps: int = 40
    ddpg_warmup: int = 64
    ddpg_hidden: int = 64


def _resolve_scenario(entry: Any) -> Tuple[str, scenarios.ScenarioSpec]:
    """(label, spec) of a grid scenario entry, its parameters kept."""
    if isinstance(entry, tuple):
        label, spec = entry
        return str(label), scenarios.preset(spec)
    if isinstance(entry, scenarios.ScenarioSpec):
        return entry.kind, entry
    return str(entry), scenarios.preset(entry)


def expand_grid(grid: SweepGrid) -> List[SweepCell]:
    """The grid's cells in the reference's order (scenario, policy,
    allocator, scheduler, NOMA, seed, engine mode; the last fastest).
    Two cells with one ``cell_id`` raise ``ValueError``."""
    cells = [SweepCell(label, sspec, po, al, sch, nm, sd, em)
             for label, sspec in map(_resolve_scenario, grid.scenarios)
             for po in grid.policies for al in grid.allocators
             for sch in grid.schedulers for nm in grid.noma
             for sd in grid.seeds for em in grid.engine_modes]
    ids = [c.cell_id for c in cells]
    if len(set(ids)) != len(ids):
        dupes = sorted({i for i in ids if ids.count(i) > 1})
        raise ValueError(
            f"ambiguous sweep cells {dupes}: two scenario entries share a "
            f"label -- use (label, ScenarioSpec) pairs to disambiguate")
    return cells


def _spec_for(cell: SweepCell, grid: SweepGrid) -> engine.EngineSpec:
    return engine.EngineSpec(policy=cell.policy, allocator=cell.allocator,
                             scheduler=cell.scheduler,
                             noma_enabled=cell.noma_enabled,
                             scenario=cell.sspec.engine_kind(),
                             candidates_k=grid.candidates_k,
                             telemetry=grid.telemetry,
                             engine_mode=cell.engine_mode,
                             buffer_fill=grid.buffer_fill,
                             timeout_s=grid.timeout_s,
                             n_tiers=grid.n_tiers,
                             retier_every=grid.retier_every,
                             faults=grid.faults)


def _group_cells(cells: Sequence[SweepCell], grid: SweepGrid
                 ) -> Dict[engine.EngineSpec, List[SweepCell]]:
    """Cells by ``EngineSpec``, groups and members in first-seen order."""
    groups: Dict[engine.EngineSpec, List[SweepCell]] = {}
    for cell in cells:
        groups.setdefault(_spec_for(cell, grid), []).append(cell)
    return groups


def _train_actors(cfg, spec, grid: SweepGrid, members, states, bundles,
                  dev: torch.device):
    """One actor a cell, each trained on its own world (see the module
    docstring for the generator rule); returns the stacked actors."""
    from repro_torch.core import ddpg
    gens = [torch.Generator(device=dev).manual_seed(TRAIN_SEED_BASE + c.seed)
            for c in members]
    dcfg = ddpg.allocator_config(cfg, spec, hidden=grid.ddpg_hidden)
    agents = ddpg.stack_agents([ddpg.init_ddpg(g, dcfg) for g in gens])
    draws = ddpg.sample_ddpg_draws(cfg, dcfg, gens, grid.ddpg_episodes,
                                   grid.ddpg_steps)
    assoc_u = None
    if spec.policy == "rcea":
        assoc_u = torch.stack([torch.rand(bundles.dist.shape[1:],
                                          generator=g, device=dev)
                               for g in gens])
    agents, _ = ddpg.train_allocator_fleet(
        cfg, spec, states, bundles, dcfg, agents, draws,
        warmup=grid.ddpg_warmup, assoc_u=assoc_u)
    return agents.actor


def _host(tree, skip=()) -> Dict[str, np.ndarray]:
    """A metrics or trace tuple's leaves on the host, one copy a leaf
    (the fields in ``skip`` left out)."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))
            for k, v in tree._asdict().items() if k not in skip}


def _dump(path: str, payload: Dict[str, Any]) -> None:
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=1)


def run_sweep(cfg, grid: SweepGrid, *, out_dir: str = DEFAULT_OUT,
              write_json: bool = True, actor_params=None,
              device: "str | torch.device" = "cuda",
              mesh=None) -> Dict[str, Any]:
    """Run the grid on ``device``; returns (and, with ``write_json``,
    writes under ``<out_dir>/sweep_<name>/``) the summary, with the
    per-cell rows under ``"cells"``.

    One ``run_fleet`` call a group (``run_fleet_actors`` for ddpg cells
    trained per cell); ``actor_params`` is one shared, already trained
    actor for every ddpg cell instead (see the module docstring).
    ``mesh`` (``engine.fleet_mesh()``): each group's fleet split over its
    ranks by ``engine.run_fleet_sharded``, on the mesh's device (which
    then overrides ``device``); only rank 0 writes."""
    dev = resolve_device(device) if mesh is None else mesh.device
    write_json = write_json and (mesh is None or mesh.rank == 0)
    cells = expand_grid(grid)
    ddpg_cells = [c for c in cells if c.allocator == "ddpg"]
    if ddpg_cells and actor_params is not None:
        if len({c.sspec.engine_kind() == "static" for c in ddpg_cells}) > 1:
            raise ValueError(
                "ddpg cells mix static (2N,) and dynamic (3N,) observation "
                "shapes -- one actor cannot serve both; split the grid or "
                "drop actor_params to train one actor a cell")
    groups = _group_cells(cells, grid)
    sweep_dir = os.path.join(out_dir, f"sweep_{grid.name}")
    if write_json:
        os.makedirs(sweep_dir, exist_ok=True)

    per_cell: Dict[str, Dict[str, list]] = {}
    timings: List[Dict[str, Any]] = []
    failed: Dict[str, str] = {}
    # (seed, scenario) -> (state, bundle, generator state after init)
    worlds: Dict[Tuple[int, scenarios.ScenarioSpec], tuple] = {}

    def world(c: SweepCell):
        key = (c.seed, c.sspec)
        if key not in worlds:
            state, bundle, aux = engine.init_simulation(
                cfg, seed=c.seed, iid=grid.iid, device=dev,
                scenario=c.sspec)
            worlds[key] = (state, bundle, aux["generator"].get_state())
        return worlds[key]

    def prepare(spec: engine.EngineSpec, members: List[SweepCell]):
        built = [world(c) for c in members]
        states, bundles = engine.stack_fleet([(s, b) for s, b, _ in built])
        gens = [torch.Generator(device=dev).set_state(g) for _, _, g in built]
        cell_actors, train_s = None, 0.0
        if spec.allocator == "ddpg" and actor_params is None:
            t0 = time.perf_counter()
            cell_actors = _train_actors(cfg, spec, grid, members, states,
                                        bundles, dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            train_s = time.perf_counter() - t0
        return states, bundles, gens, cell_actors, train_s

    def run_group(spec: engine.EngineSpec, members: List[SweepCell]):
        if mesh is None:
            prepared = prepare(spec, members)
        else:
            # a rank that fails here stops every rank at the same point
            prepared = engine.guarded(mesh, lambda: prepare(spec, members))
        states, bundles, gens, cell_actors, train_s = prepared
        if dev.type == "cuda":
            # the stacking's copies still queued are not the group's run
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if mesh is not None:
            _, out = engine.run_fleet_sharded(
                cfg, spec, states, bundles, grid.n_rounds, gens,
                cell_actors if cell_actors is not None else actor_params,
                mesh=mesh, per_sim_actors=cell_actors is not None)
        elif cell_actors is not None:
            _, out = engine.run_fleet_actors(cfg, spec, states, bundles,
                                             grid.n_rounds, gens,
                                             cell_actors)
        else:
            _, out = engine.run_fleet(cfg, spec, states, bundles,
                                      grid.n_rounds, gens, actor_params)
        ms, traces = engine.split_output(spec, out)
        # the reference's metrics have no sweeps (its trace has them)
        host = _host(ms, skip=("sweeps",))
        tr_host = None if traces is None else _host(traces)
        dt = time.perf_counter() - t0
        timing = {"spec": dataclasses.asdict(spec),
                  "n_cells": len(members), "wall_s": round(dt, 4)}
        if spec.allocator == "ddpg":
            timing["ddpg_trained"] = actor_params is None
            timing["ddpg_train_s"] = round(train_s, 4)
            timing["ddpg_actors"] = (len(members) if actor_params is None
                                     else "shared")
        timings.append(timing)
        for i, cell in enumerate(members):
            rows = {k: v[i].tolist() for k, v in host.items()}
            per_cell[cell.cell_id] = rows
            if not write_json:
                continue
            _dump(os.path.join(sweep_dir, f"{cell.cell_id}.json"),
                  {"cell": dataclasses.asdict(cell),
                   "spec": dataclasses.asdict(spec),
                   "n_rounds": grid.n_rounds, "metrics": rows})
            if tr_host is not None:
                _dump(os.path.join(sweep_dir, f"{cell.cell_id}.trace.json"),
                      {"cell": dataclasses.asdict(cell),
                       "n_rounds": grid.n_rounds,
                       "trace": {k: v[i].tolist()
                                 for k, v in tr_host.items()}})

    for spec, members in groups.items():
        # a group that raises (a divergent chaos cell, an out-of-memory
        # card) is recorded against each of its cells; the rest goes on
        try:
            run_group(spec, members)
        except (torch.distributed.DistError, BuildError):
            raise
        except Exception as exc:  # noqa: BLE001
            traceback.print_exc()
            for cell in members:
                failed[cell.cell_id] = repr(exc)
            timings.append({"spec": dataclasses.asdict(spec),
                            "n_cells": len(members), "error": repr(exc)})

    summary = {
        "name": grid.name,
        "n_cells": len(cells),
        "n_compiles": len(groups),     # one run_fleet call a group
        "n_rounds": grid.n_rounds,
        "axes": {"scenarios": [_resolve_scenario(s)[0]
                               for s in grid.scenarios],
                 "policies": list(grid.policies),
                 "allocators": list(grid.allocators),
                 "schedulers": list(grid.schedulers),
                 "noma": list(grid.noma),
                 "seeds": list(grid.seeds),
                 "engine_modes": list(grid.engine_modes)},
        "groups": timings,
        "final": summarize(per_cell),
        "failed_cells": failed,
    }
    if write_json:
        _dump(os.path.join(sweep_dir, "summary.json"), summary)
    summary["cells"] = per_cell
    return summary


def summarize(per_cell: Dict[str, Dict[str, list]]) -> Dict[str, dict]:
    """Each cell's final round: the numbers the paper's figures plot."""
    out = {}
    for cid, rows in per_cell.items():
        out[cid] = {"accuracy": rows["accuracy"][-1],
                    "loss": rows["loss"][-1],
                    "cost": rows["cost"][-1],
                    "mean_cost": float(np.mean(rows["cost"])),
                    "n_associated": rows["n_associated"][-1],
                    "n_available": rows["n_available"][-1]}
    return out


def main(argv=None) -> None:
    import argparse

    from repro_torch.configs.hfl_mnist import CONFIG

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--sharded", action="store_true",
                    help="split each group's fleet over the ranks of "
                         "torchrun (one a card; gloo with --device cpu); "
                         "rank 0 writes and prints")
    ap.add_argument("--candidates", type=int, default=None, metavar="K",
                    help="run every cell on the (N, K) candidate frontier")
    ap.add_argument("--telemetry", action="store_true",
                    help="write each cell's per-round RoundTrace beside "
                         "its metrics")
    ap.add_argument("--buffered", action="store_true",
                    help="add the buffered engine as a second engine mode")
    ap.add_argument("--faults", action="store_true",
                    help="run the chaos grid instead: the buffered engine "
                         "under edge churn and SINR-tied uplink loss, "
                         "telemetry on")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(CONFIG, n_clients=32, n_edges=4,
                              min_samples=60, max_samples=120, hidden=32,
                              input_dim=64)
    if args.faults:
        grid = SweepGrid(
            name="chaos",
            scenarios=("static", "markov_dropout"),
            policies=("gcea",),
            seeds=(0,) if args.quick else (0, 1),
            n_rounds=3 if args.quick else 10,
            candidates_k=args.candidates,
            telemetry=True,
            engine_modes=("buffered",),
            faults=CHAOS)
    else:
        grid = SweepGrid(
            name="demo",
            scenarios=("static", "random_waypoint", "markov_dropout",
                       "hetero_devices", "full_dynamic", "flash_crowd"),
            policies=("fcea", "gcea"),
            seeds=(0,) if args.quick else (0, 1),
            n_rounds=3 if args.quick else 10,
            candidates_k=args.candidates,
            telemetry=args.telemetry,
            engine_modes=("sync", "buffered") if args.buffered
            else ("sync",))
    mesh = engine.fleet_mesh(args.device) if args.sharded else None
    summary = run_sweep(cfg, grid, out_dir=args.out, device=args.device,
                        mesh=mesh)
    if mesh is not None and mesh.group is not None:
        torch.distributed.destroy_process_group()
    if mesh is not None and mesh.rank != 0:
        return
    print(json.dumps({k: summary[k] for k in
                      ("name", "n_cells", "n_compiles", "groups")}, indent=1))
    for cid, row in summary["final"].items():
        print(f"{cid}: acc={row['accuracy']:.3f} "
              f"cost={row['mean_cost']:.3f} avail={row['n_available']}")
    if summary["failed_cells"]:
        for cid, err in summary["failed_cells"].items():
            print(f"FAILED {cid}: {err}")
        if not summary["final"]:
            raise SystemExit(1)


if __name__ == "__main__":
    main()

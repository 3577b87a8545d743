"""What each gloo rank of ``tests/test_torch_sharding.py`` runs: the
target that ``core.mesh.spawn`` imports in every child (this directory is
on the parent's ``sys.path``, which the children inherit).

``rank_main(jobs, sweep, replays)`` returns this rank's results, in
order: each ``launch.sharded.Job`` through ``run_sharded``; the sweep
``(cfg, grid, out_dir)`` through ``run_sweep(..., mesh=)`` (its per-cell
rows and failures); each replay, a run of the sharded drivers' stages on
a world and round draws the reference gave (``replay``).
"""
from repro_torch.core import engine
from repro_torch.core.mesh import client_mesh, fleet_mesh
from repro_torch.launch import sharded


def _mesh(axis):
    return fleet_mesh("cpu") if axis == "fleet" else client_mesh("cpu")


def replay(axis, cfg, spec, state, bundle, draws):
    """The rounds of one sharded run with each round's ``RoundDraws``
    given, not drawn.  The client axis: ``pad_clients`` to a multiple of
    the ranks, ``shard_clients``, then ``round_step`` with the mesh, as
    ``run_scanned_client_sharded`` runs them (``draws`` span the padded
    world).  The seed axis: ``shard_fleet`` of the stacked fleet and of
    each round's stacked draws, ``fleet_step`` on the rank's block and
    the metrics gathered in seed order, as ``run_fleet_sharded`` runs
    them.  Returns each round's metrics (a fleet's: each seed's),
    the final global model and the staleness, as numpy."""
    mesh = _mesh(axis)
    rows = []
    if axis == "clients":
        cfg, state, bundle = engine.pad_clients(cfg, state, bundle,
                                                mesh.world)
        state, bundle = engine.shard_clients(state, bundle, mesh)
        state = engine.ensure_carry(cfg, spec, state)
        for d in draws:
            state, m = engine.round_step(cfg, spec, state, bundle, d,
                                         mesh=mesh)
            rows.append(engine.metrics_row(m))
    else:
        seeds = bundle.dist.shape[0]
        state, bundle = engine.shard_fleet((state, bundle), mesh)
        for d in draws:
            state, m = engine.fleet_step(cfg, spec, state, bundle,
                                         engine.shard_fleet(d, mesh))
            m = engine._gather_seeds(m, mesh, seeds)
            rows.append([engine.metrics_row(engine.select_seed(m, s))
                         for s in range(seeds)])
        state = engine._gather_seeds(state, mesh, seeds)
    return (rows, {k: v.numpy() for k, v in state.global_params.items()},
            state.staleness.numpy())


def rank_main(jobs, sweep=None, replays=()):
    results = [sharded.run_sharded(job, _mesh(job.axis)) for job in jobs]
    if sweep is not None:
        from repro_torch.sweeps import run_sweep
        cfg, grid, out_dir = sweep
        summary = run_sweep(cfg, grid, out_dir=out_dir, mesh=_mesh("fleet"))
        results.append({"cells": summary["cells"],
                        "failed": summary["failed_cells"]})
    results.extend(replay(**case) for case in replays)
    return results

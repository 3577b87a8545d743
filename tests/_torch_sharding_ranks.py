"""What each gloo rank of ``tests/test_torch_sharding.py`` runs: the
target that ``core.mesh.spawn`` imports in every child (this directory is
on the parent's ``sys.path``, which the children inherit).

``rank_main(jobs, sweep, replays, landed)`` returns this rank's results,
in order: each ``launch.sharded.Job`` through ``run_sharded``; the sweep
``(cfg, grid, out_dir)`` through ``run_sweep(..., mesh=)`` (its per-cell
rows and failures); each replay, a run of the sharded drivers' stages on
a world and round draws the reference gave (``replay``); the buffered
landing's sums on the client axis (``landed_sums``).
"""
import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.mesh import client_mesh, fleet_mesh
from repro_torch.launch import sharded


def _mesh(axis):
    return fleet_mesh("cpu") if axis == "fleet" else client_mesh("cpu")


def replay(axis, cfg, spec, state, bundle, draws,
           exact=("in_flight", "tier", "pulled_ver", "fill", "version",
                  "step")):
    """The rounds of one sharded run with each round's ``RoundDraws``
    given, not drawn.  The client axis: ``pad_clients`` to a multiple of
    the ranks, ``shard_clients``, then ``round_step`` with the mesh, as
    ``run_scanned_client_sharded`` runs them (``draws`` span the padded
    world).  The seed axis: ``shard_fleet`` of the stacked fleet and of
    each round's stacked draws, ``fleet_step`` on the rank's block and
    the metrics gathered in seed order, as ``run_fleet_sharded`` runs
    them.  Returns each round's metrics (a fleet's: each seed's),
    the final global model, the staleness and, on the client axis, the
    buffer's ``exact`` leaves and every ``FaultState`` leaf there are
    (``"buffer.<name>"``, ``"faults.<name>"``), as numpy."""
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
    extra = {}
    if state.buffer is not None:
        extra.update({f"buffer.{k}": getattr(state.buffer, k).numpy()
                      for k in exact})
    if state.faults is not None:
        extra.update({f"faults.{k}": v.numpy() for k, v in
                      zip(state.faults._fields, state.faults)})
    return (rows, {k: v.numpy() for k, v in state.global_params.items()},
            state.staleness.numpy(), extra)


def landed_inputs(n, seed):
    """A landing of N rows for ``landed_sums``: two leaves with negative
    entries, a NaN and an inf in two rows that did not land, the landed
    mask (1, N), the weights (zero where not landed) and two accumulators
    (+0.0, and a drawn one)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    tree = {"w": torch.tensor(rng.normal(size=(1, n, 3, 2)).astype(f32)),
            "b": torch.tensor(rng.normal(size=(1, n, 5)).astype(f32))}
    tree["w"][0, 3, 1, 0] = float("nan")
    tree["b"][0, n - 2, 2] = float("inf")
    landed = torch.tensor(rng.uniform(size=(1, n)) < 0.4)
    landed[0, 3] = landed[0, n - 2] = False
    w = torch.where(landed, torch.tensor(rng.uniform(1, 3, (1, n))
                                         .astype(f32)), 0.0)
    zero = {k: torch.zeros_like(v[:, 0]) for k, v in tree.items()}
    drawn = {k: torch.tensor(rng.normal(size=v[:, 0].shape).astype(f32))
             for k, v in tree.items()}
    return tree, landed, w, (zero, drawn)


def landed_sums(n, seed):
    """``engine._landed_sum`` on this rank's rows of ``landed_inputs``:
    its (delta_sum, weight_sum) from each accumulator, as numpy."""
    mesh = client_mesh("cpu")
    tree, landed, w, accs = landed_inputs(n, seed)
    lo, rows = engine._row_share(mesh, n)
    mine = {k: v[:, lo:lo + rows] for k, v in tree.items()}
    out = []
    for acc in accs:
        got, total = engine._landed_sum(mesh, acc, torch.ones(1), mine, w,
                                        landed, n, finite=False)
        out.append(({k: v.numpy() for k, v in got.items()}, total.numpy()))
    return out


def rank_main(jobs, sweep=None, replays=(), landed=None):
    results = [sharded.run_sharded(job, _mesh(job.axis)) for job in jobs]
    if sweep is not None:
        from repro_torch.sweeps import run_sweep
        cfg, grid, out_dir = sweep
        summary = run_sweep(cfg, grid, out_dir=out_dir, mesh=_mesh("fleet"))
        results.append({"cells": summary["cells"],
                        "failed": summary["failed_cells"]})
    results.extend(replay(**case) for case in replays)
    if landed is not None:
        results.append(landed_sums(**landed))
    return results

"""Run the HFL engine's sharded drivers on a mesh of processes, and hold
them to the unsharded drivers.

  torchrun --nproc_per_node=W -m repro_torch.launch.sharded --axis fleet \\
      --seeds 8 --rounds 3
  torchrun --nproc_per_node=W -m repro_torch.launch.sharded --axis clients \\
      --clients 2048 --edges 16 --rounds 3 [--candidates 4] [--buffered] \\
      [--faults]

One process a card (NCCL); ``--device cpu`` runs gloo ranks on the host.
Every rank builds the world (``engine.init_simulation``, one a seed, at
``CONFIG``'s widths with the given N and M) and runs its share: the seed
axis through ``engine.run_fleet_sharded``, the client axis through
``engine.run_scanned_client_sharded``, sync or with ``--buffered`` the
semi-async micro-step, under the sweep runner's chaos faults with
``--faults`` (``sweeps.grid.CHAOS``).  Rank 0 prints each round's
seconds, the steady rate (seed-rounds/s, or s a round) and the final
accuracy and cost; each rank prints its launches and, on a card, its
peak memory.  The whole world is built on the host of every rank, as the
reference builds it: at 2048 × 16 that is the 7.7 GB data array, twice
while it is copied, a rank.

Beside the CLI, what ``chip_smoke.py`` and the tests hold the sharded
drivers with: a ``Job`` names one run (axis, config, spec, rounds,
seeds, scenario, telemetry teed to a ``MemorySink``); ``run_sharded``
runs it on a mesh and ``run_unsharded`` runs the same world (the client
axis: padded to the mesh's world) through ``run_fleet`` or
``run_scanned``.  Both return ``(outputs, stats)``: ``outputs`` maps
each leaf of the per-round output, the final state (the client axis's
``client_params`` and ``pending_delta`` gathered whole) and the generators' states to a numpy
array, or, with ``digest=True``, to its dtype, shape and SHA-256
(bit-equal ⇔ equal); ``stats`` holds each round's seconds, the launches
and the peak memory (and, on the client axis, the rows of
``client_params`` and of the buffer's ``pending_delta`` a rank held).
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.mesh import Mesh, client_mesh, fleet_mesh
from repro_torch.kernels import hfl_ops
from repro_torch.telemetry import sink as tsink


@dataclasses.dataclass(frozen=True)
class Job:
    """One sharded run: the seed axis ("fleet": one world a seed, stacked)
    or the client axis ("clients": the world of ``seeds[0]``)."""
    axis: str
    cfg: Any
    spec: engine.EngineSpec
    rounds: int = 3
    seeds: Tuple[int, ...] = (0,)
    scenario: Any = None
    stream: bool = False     # tee the trace to a MemorySink (telemetry on)
    # > 0: the ddpg allocator deploys one actor of this width, drawn from
    # a generator seeded ACTOR_SEED on the run's device (every rank alike)
    actor_hidden: int = 0

    def __post_init__(self):
        if self.axis not in ("fleet", "clients"):
            raise ValueError(f"unknown axis {self.axis!r}")
        if self.stream and not self.spec.telemetry:
            raise ValueError("a streamed job needs EngineSpec(telemetry=True)")


ACTOR_SEED = 1234


def _actor(job: Job, n_clients: int, device: torch.device):
    """The job's deployed actor for a world of ``n_clients`` (a ragged
    client axis deploys one shaped for the padded world), or None."""
    if not job.actor_hidden:
        return None
    from repro_torch.core import ddpg
    dcfg = ddpg.allocator_config(
        dataclasses.replace(job.cfg, n_clients=n_clients), job.spec,
        hidden=job.actor_hidden)
    gen = torch.Generator(device=device).manual_seed(ACTOR_SEED)
    return ddpg.init_ddpg(gen, dcfg).actor


def build_world(job: Job, device: "str | torch.device"):
    """The job's unsharded inputs on ``device``: ``(states, bundles,
    generators)`` for the seed axis (stacked, one generator a seed),
    ``(state, bundle, generator)`` for the client axis; each generator in
    its state right after ``init_simulation``."""
    built = [engine.init_simulation(job.cfg, seed=s, device=device,
                                    scenario=job.scenario)
             for s in (job.seeds if job.axis == "fleet" else job.seeds[:1])]
    if job.axis == "clients":
        state, bundle, aux = built[0]
        return state, bundle, aux["generator"]
    states, bundles = engine.stack_fleet([(s, b) for s, b, _ in built])
    return states, bundles, [aux["generator"] for _, _, aux in built]


def _flatten(prefix: str, tree, out: Dict[str, Any]) -> None:
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}.{k}", v, out)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            _flatten(f"{prefix}.{k}", v, out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten(f"{prefix}.{i}", v, out)
    else:
        out[prefix] = torch.tensor(tree)


def _host(t: torch.Tensor, digest: bool):
    a = t.detach().cpu().contiguous().numpy()
    if not digest:
        return a
    return (str(a.dtype), tuple(a.shape), hashlib.sha256(a.tobytes())
            .hexdigest())


def _outputs(spec, final, out, generators, records, digest: bool):
    metrics, trace = engine.split_output(spec, out)
    flat: Dict[str, Any] = {}
    _flatten("metrics", metrics, flat)
    _flatten("trace", trace, flat)
    _flatten("state", final, flat)
    _flatten("generator", [g.get_state() for g in generators], flat)
    if records is not None and records.records:   # rank 0's alone
        _flatten("stream", records.stacked(), flat)
    return {k: _host(v, digest) for k, v in flat.items()}


class _Clock:
    """``on_round``: each round's end on the host clock, after the
    round's queued work on ``device``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.marks = [time.perf_counter()]

    def __call__(self, out) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.marks.append(time.perf_counter())

    def seconds(self):
        return [b - a for a, b in zip(self.marks[:-1], self.marks[1:])]


def _start_stats(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    hfl_ops.reset_launches()


def host_resident_bytes() -> Optional[int]:
    """This process's resident host memory now (``/proc/self/statm``), or
    None where the system does not say."""
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return None


def _stats(clock: _Clock, device: torch.device) -> Dict[str, Any]:
    """Each round's seconds, the launches since ``_start_stats``, the
    process's resident host memory at the end and, on a card, the peak
    device memory this process's allocator held since ``_start_stats``
    (which starts from what it held then, ``start_bytes``; tensors a
    parent shares through CUDA IPC are the parent's)."""
    out = {"seconds": clock.seconds(), "launches": dict(hfl_ops.LAUNCHES),
           "host_resident_bytes": host_resident_bytes()}
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


def run_sharded(job: Job, mesh: Optional[Mesh] = None, world=None, *,
                digest: bool = False):
    """``job`` on ``mesh`` (default: the job's axis's mesh on the card):
    ``world`` (``build_world``'s triple, on any device) or one built on
    the rank's device.  Returns ``(outputs, stats)`` on every rank."""
    if mesh is None:
        mesh = fleet_mesh() if job.axis == "fleet" else client_mesh()
    dev = mesh.device
    if world is None:
        world = build_world(job, dev)
    states, bundles, gens = world
    records = tsink.MemorySink() if job.stream else None
    clock = _Clock(dev)           # (a streamed run is not timed)
    start = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    n = job.cfg.n_clients
    actor = _actor(job, n if job.axis == "fleet"
                   else -(-n // mesh.world) * mesh.world, dev)
    _start_stats(dev)
    if job.axis == "fleet":
        gens = list(gens)
        if job.stream:
            final, ms, tr = tsink.stream_fleet(
                job.cfg, job.spec, states, bundles, job.rounds, records,
                gens, actor, mesh=mesh)
            out = (ms, tr)
        else:
            final, out = engine.run_fleet_sharded(
                job.cfg, job.spec, states, bundles, job.rounds, gens,
                actor, mesh=mesh, on_round=clock)
        return (_outputs(job.spec, final, out, gens, records, digest),
                {**_stats(clock, dev), "start_bytes": start})
    gen = gens
    if job.stream:
        final, ms, tr = tsink.stream_scanned_client_sharded(
            job.cfg, job.spec, states, bundles, job.rounds, records, gen,
            actor, mesh=mesh)
        out = (ms, tr)
    else:
        final, out = engine.run_scanned_client_sharded(
            job.cfg, job.spec, states, bundles, job.rounds, gen, actor,
            mesh=mesh, on_round=clock)
    stats = {**_stats(clock, dev), "start_bytes": start,
             "client_rows": next(iter(final.client_params.values())).shape[0]}
    if final.buffer is not None:
        stats["pending_rows"] = next(iter(
            final.buffer.pending_delta.values())).shape[0]
    final = engine.gather_clients(final, mesh)
    return _outputs(job.spec, final, out, [gen], records, digest), stats


def run_unsharded(job: Job, world_size: int = 1,
                  device: "str | torch.device" = "cuda", world=None, *,
                  digest: bool = False):
    """``job`` through the unsharded driver on ``device`` (the client
    axis on its world padded to a multiple of ``world_size``, as
    ``run_scanned_client_sharded`` pads it).  Returns ``(outputs,
    stats)``, shaped as ``run_sharded``'s."""
    dev = torch.device(device)
    if world is None:
        world = build_world(job, dev)
    states, bundles, gens = world
    records = tsink.MemorySink() if job.stream else None
    clock = _Clock(dev)
    cfg = job.cfg
    if job.axis == "clients":
        cfg, states, bundles = engine.pad_clients(cfg, states, bundles,
                                                  world_size)
        gens = [gens]
    actor = _actor(job, cfg.n_clients, dev)
    start = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    _start_stats(dev)
    if job.axis == "fleet" and job.stream:
        final, ms, tr = tsink.stream_fleet(cfg, job.spec, states, bundles,
                                           job.rounds, records, gens, actor)
        out = (ms, tr)
    elif job.axis == "fleet":
        final, out = engine.run_fleet(cfg, job.spec, states, bundles,
                                      job.rounds, gens, actor,
                                      on_round=clock)
    elif job.stream:
        final, ms, tr = tsink.stream_scanned(cfg, job.spec, states, bundles,
                                             job.rounds, records, gens[0],
                                             actor)
        out = (ms, tr)
    else:
        final, out = engine.run_scanned(cfg, job.spec, states, bundles,
                                        job.rounds, gens[0], actor,
                                        on_round=clock)
    stats = {**_stats(clock, dev), "start_bytes": start}
    return _outputs(job.spec, final, out, gens, records, digest), stats


def main(argv=None) -> int:
    from repro_torch.configs.hfl_mnist import CONFIG
    from repro_torch.sweeps.grid import CHAOS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--axis", choices=("fleet", "clients"), default="fleet")
    ap.add_argument("--seeds", type=int, default=8,
                    help="the fleet's seeds 0..S-1 (seed axis)")
    ap.add_argument("--clients", type=int, default=CONFIG.n_clients)
    ap.add_argument("--edges", type=int, default=CONFIG.n_edges)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--policy", default="fcea")
    ap.add_argument("--scheduler", default="pdd")
    ap.add_argument("--candidates", type=int, default=None, metavar="K")
    ap.add_argument("--scenario", default=None)
    ap.add_argument("--buffered", action="store_true",
                    help="the buffered engine's micro-steps (FedBuff)")
    ap.add_argument("--faults", action="store_true",
                    help="the sweep runner's chaos fault spec")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, one rank a card) or cpu (gloo)")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(CONFIG, n_clients=args.clients,
                              n_edges=args.edges)
    spec = engine.EngineSpec(
        policy=args.policy, scheduler=args.scheduler,
        candidates_k=args.candidates,
        scenario=("static" if args.scenario in (None, "static")
                  else "dynamic"),
        engine_mode="buffered" if args.buffered else "sync",
        faults=CHAOS if args.faults else None)
    job = Job(args.axis, cfg, spec, args.rounds,
              tuple(range(args.seeds)) if args.axis == "fleet" else (0,),
              args.scenario)
    mesh = (fleet_mesh(args.device) if args.axis == "fleet"
            else client_mesh(args.device))
    outputs, stats = run_sharded(job, mesh)
    if mesh.group is not None:
        torch.distributed.destroy_process_group()
    secs = stats["seconds"]
    steady = float(np.median(secs[1:])) if len(secs) > 1 else secs[0]
    peak = stats.get("peak_bytes")
    print(f"[rank {mesh.rank}/{mesh.world}] launches {stats['launches']}"
          + ("" if peak is None else f", peak {peak / 1e9:.3f} GB"),
          flush=True)
    if mesh.rank == 0:
        step = "micro-step" if args.buffered else "round"
        for r, s in enumerate(secs):
            print(f"{step} {r + 1}: {s:.4f} s")
        acc = outputs["metrics.accuracy"]
        cost = outputs["metrics.cost"]
        if args.axis == "fleet":
            print(f"{args.seeds} seeds over {mesh.world} ranks: "
                  f"{args.seeds / steady:.2f} seed-rounds/s steady; final "
                  f"accuracy {acc[:, -1].mean():.4f}, cost "
                  f"{cost[:, -1].mean():.4f}")
        else:
            print(f"{cfg.n_clients} x {cfg.n_edges} over {mesh.world} "
                  f"ranks: {steady:.4f} s a {step} steady; final accuracy "
                  f"{acc[-1]:.4f}, cost {cost[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

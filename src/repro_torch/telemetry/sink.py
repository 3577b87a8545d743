"""Host-side trace sinks and streaming drivers (the reference's
``repro.telemetry.sink``).

Two ways to consume a telemetry-enabled engine
(``EngineSpec(telemetry=True)``):

* **collect** -- the drivers already stack each round's ``RoundTrace``
  beside the metrics; ``collect_scanned``/``collect_fleet`` split it off.
* **stream** -- ``stream_scanned``/``stream_fleet`` are the drivers' loops
  with a tee: after each round its trace moves to the host (one copy of
  all leaves) and goes to ``sink.emit``, a fleet's seed by seed within
  the round.  The stream is a tee, not another result: they return what
  the collect helpers return.  ``stream_scanned_client_sharded`` and
  ``stream_fleet(..., mesh=)`` are the sharded drivers' tees; only rank 0
  of the mesh emits, the same records in the same order as unsharded.

Sinks are duck-typed objects with ``emit(trace)``: ``MemorySink`` keeps
host (numpy) traces, ``JsonlSink`` appends one JSON object a round in the
reference's format, field for field, so each side reads the other's
files (``load_jsonl``).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.telemetry.trace import RoundTrace

INT_FIELDS = frozenset({
    "round", "assoc_sweeps", "edge_load", "pdd_iters", "sic_depth",
    "stale_hist", "buffer_fill", "trigger_cause", "tier_active",
    "tier_occupancy", "dead_edges", "orphaned_clients", "uplink_retries",
    "uplink_dropped", "quarantined"})


# ---------------------------------------------------------------------------
# Sinks
# ---------------------------------------------------------------------------

def _numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class MemorySink:
    """Accumulates per-round traces as host numpy ``RoundTrace``s."""

    def __init__(self) -> None:
        self.records: List[RoundTrace] = []

    def emit(self, trace: RoundTrace) -> None:
        self.records.append(RoundTrace(*(_numpy(l) for l in trace)))

    def stacked(self) -> RoundTrace:
        """The records stacked along a leading rounds axis, sorted by
        round (stable: records of one round keep their order)."""
        order = np.argsort([int(r.round) for r in self.records],
                           kind="stable")
        recs = [self.records[i] for i in order]
        return RoundTrace(*(np.stack(ls) for ls in zip(*recs)))


class JsonlSink:
    """Appends one JSON object a round: ``{"round": 3, "time_local_s":
    ..., "edge_load": [...], ...}``.  A context manager whose exit flushes
    and closes even when the body raised; ``close`` is idempotent, and an
    ``emit`` after it is a no-op."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._fh: Optional[Any] = open(path, "a")

    def emit(self, trace: RoundTrace) -> None:
        if self._fh is None:
            return
        self._fh.write(json.dumps(trace_record(trace)) + "\n")
        self._fh.flush()

    def close(self) -> None:
        fh, self._fh = self._fh, None
        if fh is None:
            return
        try:
            fh.flush()
        finally:
            fh.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def trace_record(trace: RoundTrace) -> Dict[str, Any]:
    """One round's trace as a JSON-serialisable flat dict."""
    out: Dict[str, Any] = {}
    for name, leaf in trace._asdict().items():
        arr = _numpy(leaf)
        out[name] = arr.item() if arr.ndim == 0 else arr.tolist()
    return out


def load_jsonl(path: str) -> Dict[str, np.ndarray]:
    """A ``JsonlSink`` file (the port's or the reference's) back to
    round-sorted stacked arrays, int32 or float32 as the ``RoundTrace``
    leaves; a field missing from older files reads as zeros."""
    with open(path) as fh:
        rows = [json.loads(l) for l in fh if l.strip()]
    rows.sort(key=lambda r: r["round"])
    return {name: np.asarray([r.get(name, 0) for r in rows],
                             np.int32 if name in INT_FIELDS else np.float32)
            for name in RoundTrace._fields}


def host_trace(trace: RoundTrace) -> RoundTrace:
    """A trace's leaves on the host as numpy arrays, in one device-to-host
    copy (one copy synchronises the stream once, 25 would 25 times): the
    int32 leaves are bit-cast to float32 beside the float leaves, every
    leaf flattened behind its leading axes into one buffer."""
    lead = trace.round.shape
    flat = [(l if l.dtype == torch.float32 else l.view(torch.float32)
             ).reshape(lead + (-1,)) for l in trace]
    host = torch.cat(flat, dim=-1).cpu().numpy()
    out, at = [], 0
    for leaf, f in zip(trace, flat):
        width = f.shape[-1]
        part = host[..., at:at + width]
        at += width
        if leaf.dtype != torch.float32:
            part = part.view(np.int32)
        out.append(part.reshape(tuple(leaf.shape)))
    return RoundTrace(*out)


# ---------------------------------------------------------------------------
# Collect mode
# ---------------------------------------------------------------------------

def collect_scanned(cfg, spec, state, bundle, n_rounds: int,
                    generator: torch.Generator, actor_params=None):
    """``engine.run_scanned`` with the (metrics, trace) output split:
    (final state, metrics, trace), the trace ``None`` with telemetry
    off."""
    final, out = engine.run_scanned(cfg, spec, state, bundle, n_rounds,
                                    generator, actor_params)
    ms, trace = engine.split_output(spec, out)
    return final, ms, trace


def collect_fleet(cfg, spec, states, bundles, n_rounds: int, generators,
                  actor_params=None):
    """``engine.run_fleet`` with the output split; trace leaves (S,
    n_rounds, …)."""
    final, out = engine.run_fleet(cfg, spec, states, bundles, n_rounds,
                                  generators, actor_params)
    ms, trace = engine.split_output(spec, out)
    return final, ms, trace


def emit_stacked(trace: RoundTrace, sink, fleet_axes: int = 0) -> None:
    """Feed a stacked trace to ``sink`` one round at a time, after one
    copy to the host; ``fleet_axes`` leading batch axes (1 for a fleet's
    trace) are walked seed by seed."""
    if isinstance(trace.round, torch.Tensor):
        trace = host_trace(trace)
    leaves = [np.asarray(l) for l in trace]
    sims = leaves[0].shape[:fleet_axes]
    for sim in np.ndindex(*sims):
        for r in range(leaves[0].shape[fleet_axes]):
            sink.emit(RoundTrace(*(l[sim][r] for l in leaves)))


# ---------------------------------------------------------------------------
# Streaming drivers: the drivers' loops with a tee
# ---------------------------------------------------------------------------

def _require_telemetry(spec) -> None:
    if not spec.telemetry:
        raise ValueError("streaming drivers need EngineSpec(telemetry=True)"
                         " -- with it off the engine builds no trace")


def stream_scanned(cfg, spec, state, bundle, n_rounds: int, sink,
                   generator: torch.Generator, actor_params=None):
    """``engine.run_scanned`` with each round's trace teed to ``sink``
    after the round.  Returns (final state, metrics, trace) as
    ``collect_scanned`` does."""
    _require_telemetry(spec)
    state, (ms, trace) = engine._drive(
        cfg, spec, state, bundle, n_rounds, generator, actor_params,
        fleet=False, on_round=lambda out: sink.emit(host_trace(out[1])))
    return state, ms, trace


def stream_scanned_client_sharded(cfg, spec, state, bundle, n_rounds: int,
                                  sink, generator: torch.Generator,
                                  actor_params=None, *, mesh=None):
    """``engine.run_scanned_client_sharded`` (pad, shard, run) with each
    round's trace teed to ``sink`` by rank 0 of the mesh (every rank holds
    the same trace: the round's control plane is replicated).  Returns the
    padded world's (final state, metrics, trace), the state's
    ``client_params`` this rank's rows."""
    _require_telemetry(spec)
    mesh = engine.client_mesh() if mesh is None else mesh

    def tee(out):
        if mesh.rank == 0:
            sink.emit(host_trace(out[1]))

    state, (ms, trace) = engine.run_scanned_client_sharded(
        cfg, spec, state, bundle, n_rounds, generator, actor_params,
        mesh=mesh, on_round=tee)
    return state, ms, trace


def stream_fleet(cfg, spec, states, bundles, n_rounds: int, sink,
                 generators, actor_params=None, *, mesh=None):
    """``engine.run_fleet`` with each round's traces teed to ``sink``
    after the round, seed by seed.  Returns (final states, metrics,
    trace) as ``collect_fleet`` does.

    With ``mesh`` (``engine.fleet_mesh()``) the seed axis is split as in
    ``engine.run_fleet_sharded``: after each round the ranks' traces are
    gathered in seed order (behind an ``all_ok`` flag, so that a rank
    that raised stops every rank) and rank 0 emits them, seed by seed;
    the other ranks emit nothing."""
    _require_telemetry(spec)
    seeds = bundles.dist.shape[0]

    def emit(host):
        for s in range(seeds):
            sink.emit(RoundTrace(*(l[s] for l in host)))

    if mesh is None:
        states, (ms, trace) = engine._drive(
            cfg, spec, states, bundles, n_rounds, generators,
            engine.every_seed(actor_params, seeds), fleet=True,
            on_round=lambda out: emit(host_trace(out[1])))
        return states, ms, trace

    def tee(out):
        if not mesh.all_ok(True):
            raise engine.PeerFailed(f"rank {mesh.rank}: another rank of "
                                    f"the fleet mesh failed")
        full = RoundTrace(*(mesh.all_gather(l)[:seeds] for l in out[1]))
        if mesh.rank == 0:
            emit(host_trace(full))

    states, (ms, trace) = engine.run_fleet_sharded(
        cfg, spec, states, bundles, n_rounds, generators, actor_params,
        mesh=mesh, on_round=tee)
    return states, ms, trace

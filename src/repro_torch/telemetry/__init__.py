"""Round telemetry (the reference's ``repro.telemetry``), on by
``EngineSpec(telemetry=True)``; off, the engine builds no trace.

* ``trace`` -- the ``RoundTrace`` of per-stage observables the engine
  returns beside ``RoundMetrics``;
* ``sink``  -- host-side sinks (JSONL, in-memory), the collect helpers and
  the streaming drivers (each round's trace teed to a sink);
* ``spans`` -- ``torch.profiler``/NVTX ranges around the paper's stages
  and the capture helper ``profile_scanned``.

``sink`` imports the engine, so it is not imported here (the engine
imports ``trace`` and ``spans``)::

    from repro_torch.telemetry import sink
"""
from repro_torch.telemetry import spans, trace
from repro_torch.telemetry.trace import RoundTrace, STALE_BIN_EDGES, round_trace

__all__ = ["RoundTrace", "STALE_BIN_EDGES", "round_trace", "spans", "trace"]

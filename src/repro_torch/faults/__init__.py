"""Fault injection and graceful degradation for the round engine (the
reference's ``repro.faults``).

* ``spec``   -- ``FaultSpec`` (the knobs, on ``EngineSpec.faults``) and the
  ``FaultState`` carry;
* ``inject`` -- the per-round fault processes over explicit uniforms (edge
  churn, SINR-tied uplink loss, crashes, delta poisoning, backoff);
* ``guard``  -- the update quarantine (norm clip, NaN/Inf reject) every
  delta passes before aggregation;
* ``resume`` -- the checkpointed, resumable driver
  (``run_scanned_resumable``).  It is imported on first use: it imports
  ``core.engine``, which imports this package's leaf modules.
"""
from repro_torch.faults.spec import FaultSpec, FaultState, init_faults  # noqa: F401

__all__ = ["FaultSpec", "FaultState", "init_faults",
           "run_scanned_resumable", "ResumableRun"]


def __getattr__(name):
    if name in ("run_scanned_resumable", "ResumableRun", "resume"):
        import importlib
        resume = importlib.import_module("repro_torch.faults.resume")
        return resume if name == "resume" else getattr(resume, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""Run-level fault tolerance: the checkpointed, resumable driver (the
reference's ``repro.faults.resume``).

``run_scanned_resumable`` splits one ``run_scanned`` experiment into
segments of ``segment_rounds`` rounds and, after every segment,
checkpoints the whole carry (``RoundState`` with its ``BufferState``,
``FaultState`` and warm-start seed), the outputs so far and the random-number generator's
state (``checkpoint.store``).  A later call with the same ``directory``
resumes from the newest snapshot, and its trajectory is bit-identical to
the uninterrupted run's:

* the reference's carry holds its PRNG key; the port draws from a
  ``torch.Generator`` outside the carry, so each snapshot stores
  ``generator.get_state()`` (a CPU uint8 tensor, for a CUDA generator
  too), and a resume calls ``generator.set_state`` before its first
  segment: the draws go on where they stopped;
* the checkpoint round-trips every leaf bit for bit, onto the device the
  leaf came from;
* each segment's outputs are copied to the host and concatenated there,
  untouched.

The checkpoint's step is the number of completed rounds, so
``latest_step`` is the resume cursor.  ``max_segments`` bounds how many
segments one call runs: a call that stops there leaves the checkpoint
behind as a crashed host would.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.checkpoint import store
from repro_torch.core import engine
from repro_torch.telemetry.trace import RoundTrace


class ResumableRun(NamedTuple):
    """One ``run_scanned_resumable`` call's outcome.  ``completed_rounds``
    below ``n_rounds`` means the call stopped at ``max_segments``: call
    again with the same directory to go on from the last snapshot."""
    state: Any               # the carry after the last completed segment
    metrics: Any             # RoundMetrics on the host, (completed, ...)
    trace: Any               # RoundTrace ditto, or None (telemetry off)
    completed_rounds: int
    n_rounds: int

    @property
    def done(self) -> bool:
        return self.completed_rounds >= self.n_rounds


def _template(nt_cls) -> Any:
    """A structure-only tree for ``load_checkpoint``: the outputs live on
    the host, and the loader reads no value or shape of the template."""
    return nt_cls(*([torch.empty(0)] * len(nt_cls._fields)))


def _out_template(spec: engine.EngineSpec) -> Any:
    mt = _template(engine.RoundMetrics)
    return (mt, _template(RoundTrace)) if spec.telemetry else mt


def _host(tree):
    """Every tensor leaf of an output tree on the host (ints stay)."""
    return engine._map(lambda t: t.detach().cpu(), tree)


def _concat(acc, new):
    new = _host(new)
    if acc is None:
        return new
    return engine._map(lambda a, b: torch.cat([a, b], dim=0), acc, new)


def run_scanned_resumable(cfg, spec: engine.EngineSpec, state, bundle,
                          n_rounds: int, generator: torch.Generator, *,
                          directory: str, segment_rounds: int = 8,
                          actor_params=None,
                          max_segments: Optional[int] = None
                          ) -> ResumableRun:
    """``engine.run_scanned`` in checkpointed segments, resume-safe.

    If ``directory`` holds a snapshot, ``state`` gives only the carry's
    structure and devices (it must be the same experiment's start), the
    snapshot's generator state is loaded into ``generator``, and the run
    goes on from the snapshot's round count."""
    state = engine.ensure_carry(cfg, spec, state)
    seg_len = max(1, int(segment_rounds))
    done, out_accum = 0, None

    last = store.latest_step(directory)
    if last is not None:
        template = {"carry": state, "out": _out_template(spec),
                    "generator": generator.get_state()}
        tree, done, _ = store.load_checkpoint(directory, template, last)
        state, out_accum = tree["carry"], tree["out"]
        generator.set_state(tree["generator"])

    segments = 0
    while done < n_rounds and (max_segments is None
                               or segments < max_segments):
        seg = min(seg_len, n_rounds - done)
        state, out = engine.run_scanned(cfg, spec, state, bundle, seg,
                                        generator, actor_params)
        out_accum = _concat(out_accum, out)
        done += seg
        segments += 1
        store.save_checkpoint(directory, done,
                              {"carry": state, "out": out_accum,
                               "generator": generator.get_state()},
                              extra={"n_rounds": int(n_rounds),
                                     "segment_rounds": seg_len})

    if out_accum is None:
        ms, tr = None, None
    elif spec.telemetry:
        ms, tr = out_accum
    else:
        ms, tr = out_accum, None
    return ResumableRun(state=state, metrics=ms, trace=tr,
                        completed_rounds=done, n_rounds=int(n_rounds))

"""Named profiler ranges for the paper's stages (the reference's
``repro.telemetry.spans``).

``stage(name, device)`` wraps a round stage in a
``torch.profiler.record_function`` range named ``hfl/<name>`` (seen by a
``torch.profiler`` capture on every device) and, when the round's tensors
are on CUDA, an NVTX range of the same name (seen by CUDA tools).  Outside
a capture both cost a few microseconds of host time and change no result.

``profile_scanned`` captures one steady ``run_scanned`` call, warmed
outside the capture, into a Chrome trace (``trace_capture``).
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

from repro_torch.device import resolve_device

STAGES = ("associate", "allocate", "schedule", "train", "eval")
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def stage(name: str, device: "torch.device | str | None" = None):
    """Span one paper stage: a profiler range, and an NVTX range on CUDA
    (never called on the CPU build)."""
    label = f"hfl/{name}"
    with torch.profiler.record_function(label):
        if device is not None and torch.device(device).type == "cuda":
            with torch.cuda.nvtx.range(label):
                yield
        else:
            yield


@contextlib.contextmanager
def trace_capture(out_dir: str, device: "torch.device | str" = "cuda"):
    """A ``torch.profiler`` capture of host activity and, on CUDA (the
    default; ``device="cpu"`` for the host alone), of the card's kernels;
    on exit it writes a Chrome trace to ``out_dir/trace.json``.  Yields
    the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(out_dir, TRACE_FILE))


def profile_scanned(cfg, spec, state, bundle, n_rounds: int, out_dir: str,
                    generator: torch.Generator,
                    actor_params: Optional[dict] = None) -> str:
    """A stage-annotated profile of ``engine.run_scanned``: one call from
    a copy of ``generator`` warms the path outside the capture, then one
    call, bracketed by an ``hfl/run_scanned`` range, is captured.  Returns
    the Chrome trace's path."""
    from repro_torch.core import engine        # the engine imports spans
    dev = bundle.dist.device

    def run(gen):
        out = engine.run_scanned(cfg, spec, state, bundle, n_rounds, gen,
                                 actor_params)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    warm = torch.Generator(device=generator.device)
    run(warm.set_state(generator.get_state()))
    with trace_capture(out_dir, dev):
        with stage("run_scanned", dev):
            run(generator)
    return os.path.join(out_dir, TRACE_FILE)

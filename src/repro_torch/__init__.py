"""PyTorch + CUDA port of the NOMA-enabled hierarchical federated learning
round engine (the ``repro`` JAX package is the reference).

The port runs the paper's semi-synchronous global round -- fading, fuzzy
competency scoring, deferred-acceptance association, allocation, the
Eq. 23a cost with NOMA SIC rates, the PDD edge schedule, compact-cohort
local SGD with edge/cloud aggregation, staleness and evaluation -- on an
NVIDIA H100.  Its three hot kernels (fuzzy scoring, SIC rates, fused local
SGD) are hand-written CUDA for ``sm_90a`` in ``kernels/csrc/hfl_ops.cu``;
on CPU tensors every kernel wrapper runs its plain PyTorch version.

Entry points: ``repro_torch.core.hfl.HFLSimulation`` and
``repro_torch.core.engine`` (``init_simulation``, ``sample_draws``,
``round_step``, ``run_scanned``, ``run_fleet``; the buffered engine with
``EngineSpec(engine_mode="buffered")``), and ``repro_torch.telemetry``
(the round trace, stage ranges and sinks).  They default to
``device="cuda"``.
"""

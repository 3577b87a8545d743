"""Stateful wrapper around the round engine: the paper's simulation object.

``HFLSimulation`` holds one ``RoundState``, its ``RoundBundle`` and the
``torch.Generator`` every round's draws come from, in a static or dynamic
scenario (``scenario``: a preset name, kind string or ``ScenarioSpec``):

* ``run_round()``    -- one round,
* ``run(n)``         -- n rounds, metrics read back every round,
* ``run_scanned(n)`` -- n rounds, metrics read back once at the end.

Both drivers advance the same state through the same ``round_step`` with
the same draws, so they give the same trajectory.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch import scenarios
from repro_torch.core import engine
from repro_torch.core.engine import EngineSpec, RoundState
from repro_torch.device import resolve_device

__all__ = ["HFLSimulation", "RoundMetrics"]


@dataclasses.dataclass
class RoundMetrics:
    """Host-side (float/ndarray) view of one round."""
    round: int
    accuracy: float
    loss: float
    avg_staleness: float
    total_time_s: float
    total_energy_j: float
    cost: float
    n_associated: int
    n_available: int
    z: np.ndarray
    sweeps: int

    @classmethod
    def from_engine(cls, m: engine.RoundMetrics, i=None) -> "RoundMetrics":
        return cls(**engine.metrics_row(m, i))


class HFLSimulation:
    """The paper's simulation: 64 clients, 4 edges, NOMA uplink, MNIST-like
    classification, on ``device`` (default: the GPU).  ``spec.scenario``
    is the scenario's engine kind, ``scenario_spec`` its full spec."""

    def __init__(self, cfg, *, seed: int = 0, iid: bool = True,
                 policy: str = "fcea", noma_enabled: bool = True,
                 allocator: str = "mid", scheduler: str = "pdd",
                 fading_rho: float = 0.9, oma_quota_factor: float = 0.5,
                 scenario=None,
                 device: "str | torch.device" = "cuda"):
        self.cfg = cfg
        sspec = scenarios.preset(scenario)
        self.scenario_spec = sspec
        self.spec = EngineSpec(policy=policy, allocator=allocator,
                               scheduler=scheduler,
                               noma_enabled=noma_enabled,
                               fading_rho=fading_rho,
                               oma_quota_factor=oma_quota_factor,
                               scenario=sspec.engine_kind())
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._state, self.bundle, aux = engine.init_simulation(
            cfg, seed=seed, iid=iid, device=self.device,
            generator=self.generator, scenario=sspec)
        self.topo = aux["topo"]
        self.data = aux["data"]
        self.coverage_m = engine.coverage_radius(cfg)

    @property
    def state(self) -> RoundState:
        return self._state

    @property
    def round(self) -> int:
        return self._state.round_idx

    def run_round(self, *, timer=None) -> RoundMetrics:
        draws = engine.sample_draws(self.cfg, self.bundle, self.generator,
                                    self.spec)
        self._state, m = engine.round_step(self.cfg, self.spec, self._state,
                                           self.bundle, draws, timer=timer)
        return RoundMetrics.from_engine(m)

    def run(self, n_rounds: int) -> List[RoundMetrics]:
        return [self.run_round() for _ in range(n_rounds)]

    def run_scanned(self, n_rounds: int, *, timer=None
                    ) -> List[RoundMetrics]:
        """Same trajectory as ``run``, with one read-back at the end."""
        self._state, ms = engine.run_scanned(
            self.cfg, self.spec, self._state, self.bundle, n_rounds,
            self.generator, timer=timer)
        ms_host = engine.RoundMetrics(*(v.cpu() for v in ms))
        return [RoundMetrics.from_engine(ms_host, i)
                for i in range(n_rounds)]

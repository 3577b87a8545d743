"""Stateful wrapper around the round engine: the paper's simulation object.

``HFLSimulation`` holds one ``RoundState``, its ``RoundBundle`` and the
``torch.Generator`` every round's draws come from, in a static or dynamic
scenario (``scenario``: a preset name, kind string or ``ScenarioSpec``):

* ``run_round()``    -- one round,
* ``run(n)``         -- n rounds, metrics read back every round,
* ``run_scanned(n)`` -- n rounds, metrics read back once at the end,
* ``train_ddpg(...)``-- the paper's Algorithm 2: train the DDPG allocator
  on the MDP of the current association; with ``allocator="ddpg"`` the
  rounds after it deploy the trained actor.

Both drivers advance the same state through the same ``round_step`` with
the same draws, so they give the same trajectory.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import scenarios
from repro_torch.core import ddpg, engine
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
        # the DDPG allocator, once ``train_ddpg`` has run
        self.agent: Optional[ddpg.DDPGState] = None
        self.agent_cfg: Optional[ddpg.DDPGConfig] = None

    @property
    def state(self) -> RoundState:
        return self._state

    @property
    def policy(self) -> str:
        return self.spec.policy

    @property
    def noma_enabled(self) -> bool:
        return self.spec.noma_enabled

    @property
    def allocator(self) -> str:
        return self.spec.allocator

    @property
    def scheduler(self) -> str:
        return self.spec.scheduler

    @property
    def gains(self) -> torch.Tensor:
        return self._state.gains

    @property
    def staleness(self) -> torch.Tensor:
        return self._state.staleness

    @property
    def global_params(self):
        return self._state.global_params

    @property
    def client_params(self):
        return self._state.client_params

    @property
    def round(self) -> int:
        return self._state.round_idx

    def _actor_params(self):
        return self.agent.actor if self.agent is not None else None

    def _assoc_u(self, generator: torch.Generator
                 ) -> Optional[torch.Tensor]:
        """rcea's snapshot uniforms (None for the other policies)."""
        if self.spec.policy != "rcea":
            return None
        return torch.rand(self.bundle.dist.shape, generator=generator,
                          device=self.device)

    def _associate(self) -> np.ndarray:
        """The association the current state gives; neither the state nor
        the generator is advanced (rcea draws from a copy)."""
        peek = torch.Generator(device=self.device).set_state(
            self.generator.get_state())
        return engine.associate_snapshot(
            self.cfg, self.spec, self._state, self.bundle,
            self._assoc_u(peek)).cpu().numpy()

    def run_round(self, *, timer=None) -> RoundMetrics:
        draws = engine.sample_draws(self.cfg, self.bundle, self.generator,
                                    self.spec)
        self._state, m = engine.round_step(self.cfg, self.spec, self._state,
                                           self.bundle, draws,
                                           self._actor_params(), timer=timer)
        return RoundMetrics.from_engine(m)

    def run(self, n_rounds: int) -> List[RoundMetrics]:
        return [self.run_round() for _ in range(n_rounds)]

    def run_scanned(self, n_rounds: int, *, timer=None
                    ) -> List[RoundMetrics]:
        """Same trajectory as ``run``, with one read-back at the end."""
        self._state, ms = engine.run_scanned(
            self.cfg, self.spec, self._state, self.bundle, n_rounds,
            self.generator, self._actor_params(), timer=timer)
        ms_host = engine.RoundMetrics(*(v.cpu() for v in ms))
        return [RoundMetrics.from_engine(ms_host, i)
                for i in range(n_rounds)]

    def train_ddpg(self, *, episodes: int = 20, steps_per_episode: int = 50,
                   warmup: int = 64, hidden: int = 128
                   ) -> Dict[str, List[float]]:
        """Train the DDPG allocator (``ddpg.train_allocator``) on the MDP of
        the current association, its weights and draws from the
        simulation's generator.  Returns the per-episode mean reward and
        losses as lists of floats."""
        dcfg = ddpg.allocator_config(self.cfg, self.spec, hidden=hidden)
        agent = ddpg.init_ddpg(self.generator, dcfg)
        draws = ddpg.sample_ddpg_draws(self.cfg, dcfg, [self.generator],
                                       episodes, steps_per_episode).seed(0)
        agent, history = ddpg.train_allocator(
            self.cfg, self.spec, self._state, self.bundle, dcfg, agent,
            draws, warmup=warmup, assoc_u=self._assoc_u(self.generator))
        self.agent, self.agent_cfg = agent, dcfg
        return {k: v.tolist() for k, v in history.items()}

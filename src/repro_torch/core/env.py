"""The resource-allocation surface of the paper's MDP (§IV-C), as far as
the grid allocators need it.

Action A_j = {p_n, f_n} per client, in [0, 1]² and decoded into Table II's
bounds (clamped to a scenario's per-device caps); the cost an action earns
is the engine's Eq. 23a bill (``cost.round_cost``).  ``grid_best_action``
is the paper's FPA/FCA benchmarks (§V-D): one action axis pinned, the
other grid-optimised against that bill -- the engine's ``fpa``/``fca``
allocators.

The decoders take any leading axes; ``grid_best_action`` takes a leading
fleet axis S, and the grid's G points fold onto it (G·S), so one cost
evaluation -- one SIC call -- bills the whole grid of every seed.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import cost


class EnvParams(NamedTuple):
    """What the grid bills an action against (``None`` caps and κ switch
    them off)."""
    assoc: torch.Tensor                 # (S, N, M) one-hot association
    z: torch.Tensor                     # (S, M) edge-selection mask
    n_samples: torch.Tensor             # (S, N) D_n
    kappa: Optional[torch.Tensor]       # (S, N) per-device κ
    p_max_w: Optional[torch.Tensor]     # (S, N) per-device power cap
    f_max_hz: Optional[torch.Tensor]    # (S, N) per-device frequency cap


def decode_action(cfg, action: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…, 2, N) action in [0, 1] -> (p (…, N) W, f (…, N) Hz) within the
    paper's Table II bounds."""
    p = cfg.p_min_w + action[..., 0, :] * (cfg.p_max_w - cfg.p_min_w)
    f = cfg.f_min_hz + action[..., 1, :] * (cfg.f_max_hz - cfg.f_min_hz)
    return p, f


def make_env_params(cfg, assoc: torch.Tensor, z: torch.Tensor,
                    n_samples: torch.Tensor, *,
                    kappa: Optional[torch.Tensor] = None,
                    p_max_w: Optional[torch.Tensor] = None,
                    f_max_hz: Optional[torch.Tensor] = None) -> EnvParams:
    """Gather the round's association and the scenario's caps and κ into
    an ``EnvParams``."""
    del cfg
    return EnvParams(assoc=assoc, z=z, n_samples=n_samples, kappa=kappa,
                     p_max_w=p_max_w, f_max_hz=f_max_hz)


def env_decode_action(cfg, params: EnvParams, action: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Action -> (p, f), clamped to the per-device scenario caps."""
    p, f = decode_action(cfg, action)
    if params.p_max_w is not None:
        p = torch.minimum(p, params.p_max_w)
    if params.f_max_hz is not None:
        f = torch.minimum(f, params.f_max_hz)
    return p, f


def grid_fractions(n_grid: int, device: "str | torch.device") -> torch.Tensor:
    """The ``n_grid`` points of [0, 1], as ``jnp.linspace(0, 1, n_grid)``
    gives them in float32: point i is i · fl(1 / (n_grid − 1)), one
    float32 product (its compiler turns the division into that multiply),
    and the last is 1 exactly."""
    if n_grid == 1:
        fr = np.zeros((1,), np.float32)
    else:
        step = np.float32(1.0) / np.float32(n_grid - 1)
        fr = np.append(np.arange(n_grid - 1, dtype=np.float32) * step,
                       np.float32(1.0))
    return torch.tensor(fr, device=device)


def grid_best_action(cfg, params: EnvParams, gains: torch.Tensor, *,
                     fixed_axis: int, fixed_frac: float = 0.5,
                     n_grid: int = 16, noma_enabled: bool = True
                     ) -> torch.Tensor:
    """Grid-optimise the free (shared) action fraction while the other axis
    stays at ``fixed_frac``: the paper's FPA/FCA benchmarks.  Every grid
    point is billed with the engine's Eq. 23a (NOMA switch, per-device κ,
    caps) in one batched ``cost.round_cost``, and the first minimum wins,
    as ``jnp.argmin`` picks it.  ``params`` and ``gains`` (S, N, M) carry
    the fleet axis; returns the (S, 2, N) action."""
    assoc = params.assoc
    seeds, n, m = assoc.shape
    dev = assoc.device
    fracs = grid_fractions(n_grid, dev)

    def action_of(frac):                       # (…,) -> (…, 2, N)
        a = torch.full(frac.shape + (2, n), fixed_frac, dtype=torch.float32,
                       device=dev)
        a[..., 1 - fixed_axis, :] = frac[..., None]
        return a

    def fold(t):                    # (S, …) -> (G·S, …), as the kernels
        if t is None:               # take it: contiguous
            return None
        return t.expand((n_grid,) + t.shape).reshape(
            (-1,) + t.shape[1:]).contiguous()

    grid = fracs[:, None].expand(n_grid, seeds)                  # (G, S)
    p, f = env_decode_action(cfg, params, action_of(grid))       # (G, S, N)
    rc = cost.round_cost(cfg, power_w=p.reshape(-1, n),
                         f_hz=f.reshape(-1, n), gains=fold(gains),
                         assoc=fold(assoc), z=fold(params.z),
                         n_samples=fold(params.n_samples),
                         noma_enabled=noma_enabled,
                         capacitance=fold(params.kappa))
    best = torch.argmin(rc.cost.reshape(n_grid, seeds), dim=0)   # (S,)
    return action_of(fracs[best])

"""The NOMA-HFL resource-allocation MDP (paper §IV-C).

State  S_j = {h_{n,m}^j, D_n} of the associated clients, log-scaled and
             normalised (``observe``), plus the availability mask in a
             dynamic scenario.
Action A_j = {p_n, f_n} per client, in [0, 1]², decoded into the paper's
             Table II bounds and clamped to a scenario's per-device caps.
Reward R_j = −(λt·T + λe·E), the engine's Eq. 23a bill (Eq. 37).

The channel follows first-order Gauss-Markov fading between slots and, in
a dropout world, each client's availability a two-state Markov chain.
The randomness is explicit: ``env_reset`` takes the ``Exp(1)`` fading
field of the first gains, ``env_step`` the next slot's field and, where
clients drop, the (N,) uniforms of the chain.

Every function takes any leading axes: the trainer (``core.ddpg``) runs
S worlds at once on (S, N, M) fields, so one slot's bill is one
``cost.round_cost`` -- one SIC kernel call -- for every seed, and
``NomaHflEnv`` is a thin shell holding one world's unbatched
``EnvParams``.  ``grid_best_action`` (the paper's FPA/FCA benchmarks,
the engine's ``fpa``/``fca`` allocators) takes a leading fleet axis and
folds its G grid points onto it (G·S), so one cost evaluation bills the
whole grid of every seed.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import cost, noma


class EnvState(NamedTuple):
    gains: torch.Tensor                 # (…, N, M) current |h|²
    avail: Optional[torch.Tensor] = None    # (…, N) evolving availability


class EnvParams(NamedTuple):
    """Everything the MDP needs besides the evolving ``EnvState``; a
    ``None`` leaf switches its feature off."""
    assoc: torch.Tensor                 # (…, N, M) one-hot association
    z: torch.Tensor                     # (…, M) edge-selection mask
    dist: torch.Tensor                  # (…, N, M) client-edge distances
    n_samples: torch.Tensor             # (…, N) D_n
    fading_rho: torch.Tensor            # () float32 Gauss-Markov coefficient
    avail0: Optional[torch.Tensor]      # (…, N) initial availability
    kappa: Optional[torch.Tensor]       # (…, N) per-device κ
    p_max_w: Optional[torch.Tensor]     # (…, N) per-device power cap
    f_max_hz: Optional[torch.Tensor]    # (…, N) per-device frequency cap
    p_drop: Optional[torch.Tensor]      # (…, N) P(up -> down) between slots
    p_return: Optional[torch.Tensor]    # (…, N) P(down -> up) between slots


# ---------------------------------------------------------------------------
# Observation and action, shared by the trainer and the engine's ddpg
# allocator, so both see the world through the same function
# ---------------------------------------------------------------------------

def observe(assoc: torch.Tensor, gains: torch.Tensor,
            n_samples: torch.Tensor,
            avail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """S_j: per client (log-gain to its own edge, data share), zero for
    unassociated clients, as (…, 2N); a dynamic scenario appends the
    availability mask, giving (…, 3N)."""
    associated = torch.sum(assoc, dim=-1) > 0
    own_gain = torch.sum(gains * assoc, dim=-1)
    return _observe_from(associated, own_gain, n_samples, avail)


def observe_assigned(assigned: torch.Tensor, own_gain: torch.Tensor,
                     n_samples: torch.Tensor,
                     avail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``observe`` from the compact association: the (…, N) assigned edge
    (−1 = unmatched) and the gains to it.  A gathered gain is the float
    the one-hot masked sum gives, so the two observations are equal bit
    for bit."""
    return _observe_from(assigned >= 0, own_gain, n_samples, avail)


def _observe_from(associated: torch.Tensor, own_gain: torch.Tensor,
                  n_samples: torch.Tensor,
                  avail: Optional[torch.Tensor]) -> torch.Tensor:
    # the reference's log10 is log(x) · fl(log10(e)) in float32; divide by
    # a tensor: CUDA turns ``x / 10.0`` into a multiply by the reciprocal,
    # which is not the reference's quotient
    log10e = own_gain.new_full((), 0.4342944920063019)
    g = torch.log(torch.clamp_min(own_gain, 1e-20)) * log10e \
        / own_gain.new_full((), 10.0) + 1.0
    d = n_samples / torch.clamp_min(
        torch.amax(n_samples, dim=-1, keepdim=True), 1.0)
    parts = [torch.where(associated, g, 0.0), torch.where(associated, d, 0.0)]
    if avail is not None:
        parts.append(avail.to(g.dtype))
    return torch.cat(parts, dim=-1)


def decode_action(cfg, action: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…, 2, N) action in [0, 1] -> (p (…, N) W, f (…, N) Hz) within the
    paper's Table II bounds.  A flat (…, 2N) action, as the actor emits
    it, is ``action.unflatten(-1, (2, N))``."""
    p = cfg.p_min_w + action[..., 0, :] * (cfg.p_max_w - cfg.p_min_w)
    f = cfg.f_min_hz + action[..., 1, :] * (cfg.f_max_hz - cfg.f_min_hz)
    return p, f


def make_env_params(cfg, assoc: torch.Tensor, z: torch.Tensor,
                    dist: torch.Tensor, n_samples: torch.Tensor, *,
                    fading_rho: float = 0.9,
                    avail: Optional[torch.Tensor] = None,
                    kappa: Optional[torch.Tensor] = None,
                    p_max_w: Optional[torch.Tensor] = None,
                    f_max_hz: Optional[torch.Tensor] = None,
                    p_drop: Optional[torch.Tensor] = None,
                    p_return: Optional[torch.Tensor] = None) -> EnvParams:
    """Gather an association and a scenario's slices into an ``EnvParams``.

    An availability block exists iff the caller gives an initial mask or
    a dropout chain; that fixes the observation at 2N or 3N.  The fading
    coefficient is a float32 tensor, as the reference's is, so the
    Gauss-Markov weights ρ and 1 − ρ round as its do."""
    del cfg
    has_avail = avail is not None or p_drop is not None
    avail0 = None
    if has_avail:
        avail0 = avail if avail is not None else torch.ones(
            assoc.shape[:-1], dtype=torch.float32, device=assoc.device)
    rho = torch.full((), fading_rho, dtype=torch.float32, device=assoc.device)
    return EnvParams(assoc=assoc, z=z, dist=dist, n_samples=n_samples,
                     fading_rho=rho, avail0=avail0, kappa=kappa,
                     p_max_w=p_max_w, f_max_hz=f_max_hz, p_drop=p_drop,
                     p_return=p_return)


def env_dims(params: EnvParams) -> Tuple[int, int]:
    """(state_dim, action_dim) of the MDP an ``EnvParams`` defines."""
    n = params.assoc.shape[-2]
    return (2 + (params.avail0 is not None)) * n, 2 * n


def _masked_assoc(params: EnvParams,
                  avail: Optional[torch.Tensor]) -> torch.Tensor:
    """A dropped client is out of the association, for the observation
    and for the bill, as in the engine."""
    return params.assoc if avail is None else params.assoc * avail[..., None]


def env_observe(params: EnvParams, gains: torch.Tensor,
                avail: Optional[torch.Tensor]) -> torch.Tensor:
    return observe(_masked_assoc(params, avail), gains, params.n_samples,
                   avail)


def env_decode_action(cfg, params: EnvParams, action: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(…, 2, N) action -> (p, f), clamped to the per-device scenario
    caps."""
    p, f = decode_action(cfg, action)
    if params.p_max_w is not None:
        p = torch.minimum(p, params.p_max_w)
    if params.f_max_hz is not None:
        f = torch.minimum(f, params.f_max_hz)
    return p, f


def env_reset(cfg, params: EnvParams, fading: torch.Tensor
              ) -> Tuple[EnvState, torch.Tensor]:
    """The first slot: gains from the ``Exp(1)`` field ``fading`` (shaped
    like ``params.dist``), the initial availability, the observation."""
    gains = noma.rayleigh_gains(fading, params.dist,
                                path_loss_exponent=cfg.path_loss_exponent)
    state = EnvState(gains, params.avail0)
    return state, env_observe(params, gains, state.avail)


def env_step(cfg, params: EnvParams, state: EnvState, action: torch.Tensor,
             fading: torch.Tensor, drop_u: Optional[torch.Tensor] = None, *,
             noma_enabled: bool
             ) -> Tuple[EnvState, torch.Tensor, torch.Tensor, cost.RoundCost]:
    """One MDP slot: bill the flat (…, 2N) ``action`` on the availability
    the agent observed when acting, then evolve the dropout chain (with
    the (…, N) uniforms ``drop_u``, needed iff ``params.p_drop`` is set)
    and the Gauss-Markov channel (with the ``Exp(1)`` field ``fading``)
    for the next observation.  Returns (state', obs', reward, bill)."""
    n = params.assoc.shape[-2]
    p, f = env_decode_action(cfg, params, action.unflatten(-1, (2, n)))
    rc = cost.round_cost(cfg, power_w=p, f_hz=f, gains=state.gains,
                         assoc=_masked_assoc(params, state.avail),
                         z=params.z, n_samples=params.n_samples,
                         noma_enabled=noma_enabled,
                         capacitance=params.kappa)
    reward = -rc.cost                                            # Eq. 37
    avail = state.avail
    if params.p_drop is not None:
        if drop_u is None:
            raise ValueError("env_step: this world drops clients; pass "
                             "the chain's (N,) uniforms as drop_u")
        avail = torch.where(state.avail > 0, drop_u >= params.p_drop,
                            drop_u < params.p_return).to(torch.float32)
    gains = noma.evolve_gains(fading, state.gains, params.dist,
                              path_loss_exponent=cfg.path_loss_exponent,
                              rho=params.fading_rho)
    return (EnvState(gains, avail), env_observe(params, gains, avail),
            reward, rc)


class NomaHflEnv:
    """The MDP over one fixed association: a shell over ``env_reset`` /
    ``env_step`` holding one world's ``EnvParams`` and nothing else, so
    the class and the functions give the same trajectory."""

    def __init__(self, cfg, assoc: torch.Tensor, z: torch.Tensor,
                 dist: torch.Tensor, n_samples: torch.Tensor,
                 fading_rho: float = 0.9,
                 avail: Optional[torch.Tensor] = None,
                 kappa: Optional[torch.Tensor] = None,
                 p_max_w: Optional[torch.Tensor] = None,
                 f_max_hz: Optional[torch.Tensor] = None,
                 noma_enabled: bool = True,
                 p_drop: Optional[torch.Tensor] = None,
                 p_return: Optional[torch.Tensor] = None):
        self.cfg = cfg
        self.noma_enabled = noma_enabled
        self.params = make_env_params(cfg, assoc, z, dist, n_samples,
                                      fading_rho=fading_rho, avail=avail,
                                      kappa=kappa, p_max_w=p_max_w,
                                      f_max_hz=f_max_hz, p_drop=p_drop,
                                      p_return=p_return)
        self.n_clients = assoc.shape[-2]
        self.state_dim, self.action_dim = env_dims(self.params)

    def decode_action(self, action: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat (2N,) action -> (p, f) within the caps."""
        return env_decode_action(self.cfg, self.params,
                                 action.unflatten(-1, (2, self.n_clients)))

    def reset(self, fading: torch.Tensor) -> Tuple[EnvState, torch.Tensor]:
        return env_reset(self.cfg, self.params, fading)

    def step(self, state: EnvState, action: torch.Tensor,
             fading: torch.Tensor, drop_u: Optional[torch.Tensor] = None
             ) -> Tuple[EnvState, torch.Tensor, torch.Tensor, cost.RoundCost]:
        return env_step(self.cfg, self.params, state, action, fading, drop_u,
                        noma_enabled=self.noma_enabled)


# ---------------------------------------------------------------------------
# Baseline allocators (paper §V-D)
# ---------------------------------------------------------------------------

def rra_action(u: torch.Tensor) -> torch.Tensor:
    """Random resource allocation: the (…, 2N) action is the caller's
    Uniform[0, 1) draw itself."""
    return u


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
                     n_grid: int = 16, noma_enabled: bool = True,
                     avail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grid-optimise the free (shared) action fraction while the other axis
    stays at ``fixed_frac``: the paper's FPA/FCA benchmarks.  Every grid
    point is billed with the engine's Eq. 23a (NOMA switch, per-device κ,
    caps, the availability mask ``avail``) in one batched
    ``cost.round_cost``, and the first minimum wins, as ``jnp.argmin``
    picks it.  ``params``, ``gains`` (S, N, M) and ``avail`` (S, N) carry
    the fleet axis; returns the (S, 2, N) action."""
    assoc = _masked_assoc(params, avail)
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


def _grid_best(e: NomaHflEnv, gains: torch.Tensor, fixed_axis: int,
               avail: Optional[torch.Tensor]) -> torch.Tensor:
    """``grid_best_action`` on an env's one world (lifted to a fleet of
    one), the fixed axis at its maximum, as the flat (2N,) action.  Pass
    the slot's ``EnvState.avail`` in a dropout world, so the baseline
    optimises the masked bill ``step`` charges."""
    lift = lambda t: None if t is None or t.dim() == 0 else t[None]
    params = EnvParams(*(lift(v) for v in e.params))
    a = grid_best_action(e.cfg, params, gains[None], fixed_axis=fixed_axis,
                         fixed_frac=1.0, noma_enabled=e.noma_enabled,
                         avail=lift(avail))
    return a[0].reshape(-1)


def fpa_best_action(e: NomaHflEnv, gains: torch.Tensor,
                    avail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fixed power at p_max (the conventional FPA choice [18]); the
    shared CPU frequency grid-optimised."""
    return _grid_best(e, gains, 0, avail)


def fca_best_action(e: NomaHflEnv, gains: torch.Tensor,
                    avail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fixed CPU frequency at f_max (the conventional FCA choice [19]);
    the shared power grid-optimised."""
    return _grid_best(e, gains, 1, avail)


def fpa_action(n_clients: int, f_frac: torch.Tensor) -> torch.Tensor:
    """Fixed power (midpoint), computation frequency from ``f_frac``."""
    return torch.cat([torch.full((n_clients,), 0.5, device=f_frac.device),
                      f_frac])


def fca_action(n_clients: int, p_frac: torch.Tensor) -> torch.Tensor:
    """Fixed computation (midpoint), power from ``p_frac``."""
    return torch.cat([p_frac, torch.full((n_clients,), 0.5,
                                         device=p_frac.device)])

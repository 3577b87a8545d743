"""Penalty-dual-decomposition edge-server scheduling (paper §IV-B, Alg. 1).

Solves problem (24): min over z ∈ {0,1}^M of  λt·W + λe·Σ z_m E_m  with
W = max_m z_m (T_m^cloud + U), by the paper's double loop -- inner
block-coordinate closed forms (Eqs. 26-33) plus a projected-subgradient
step on γ, outer dual updates (Eqs. 34-35) and the penalty shrink v ← c·v
-- with the reference's quota equality Σ z_m = M_c as one more penalised
constraint (``quota=None`` is the paper's literal formulation).

Every value in the iteration, the scalars v, μ and W included, is a
float32 tensor on the inputs' device: Python floats would compute in
float64 and 1200 steps of that drift from the float32 reference.  On the
card each iteration is a handful of tiny launches (30 × 40 of them a
call), so this stage is launch-bound.

Every input may carry a leading fleet axis S ((S, M)): the iterates, W,
μ and the residual are then per seed, the penalty v one scalar (it
shrinks the same way for every seed), and the launches of the loop do
not grow with S.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class PDDResult(NamedTuple):
    z: torch.Tensor             # (M,) relaxed solution in [0, 1]
    z_binary: torch.Tensor      # (M,) rounded {0, 1}
    objective: torch.Tensor     # λt·W + λe·Σ z E at the binary point
    W: torch.Tensor
    residual: torch.Tensor      # max |z - z̃| + max |z(1-z̃)|
    iterations: int


def _objective(z, U, edge_energy, t_cloud, lam_t, lam_e):
    W = torch.amax(z * (t_cloud + U), dim=-1)
    return lam_t * W + lam_e * torch.sum(z * edge_energy, dim=-1)


def pdd_schedule(edge_energy: torch.Tensor, t_cloud: torch.Tensor,
                 U: torch.Tensor, *, lam_t: float, lam_e: float,
                 quota: Optional[int] = None, outer_iters: int = 30,
                 inner_iters: int = 40, v0: float = 1.0,
                 v_shrink: float = 0.8) -> PDDResult:
    """edge_energy (M,) = E_m^cloud + E^edge; t_cloud (M,); U (M,) the
    per-edge edge-iteration time (τ₂ · slowest client); or (S, M) each
    over a fleet."""
    m = edge_energy.shape[-1]
    f32 = dict(dtype=torch.float32, device=edge_energy.device)
    lam_t_t = torch.tensor(lam_t, **f32)
    lam_e_t = torch.tensor(lam_e, **f32)
    shrink = torch.tensor(v_shrink, **f32)
    tu = t_cloud + U
    lam_e_energy = lam_e_t * edge_energy
    # views, no launch; ``torch.broadcast_shapes`` would import sympy on
    # its first call (seconds)
    shape = torch.broadcast_tensors(edge_energy, tu)[0].shape
    z = torch.full(shape, 0.5, **f32)
    zt = z.clone()
    q, qt, gamma = (torch.zeros(shape, **f32) for _ in range(3))
    mu = torch.zeros(shape[:-1] + (1,), **f32)
    W = torch.amax(tu, dim=-1, keepdim=True)
    v = torch.tensor(v0, **f32)
    quota_t = None if quota is None else torch.tensor(float(quota), **f32)

    for _ in range(outer_iters):
        for _ in range(inner_iters):
            # z̃ update, Eqs. 26-27 (closed form, then clip)
            zz = z ** 2
            zt = torch.clamp((zz + q * z * v + z + qt * v) / (zz + 1.0),
                             0.0, 1.0)
            # z update, Lemma 1 / Eq. 29
            I_m = (zt / v - qt - q * (1.0 - zt) - lam_e_energy - gamma * tu)
            if quota_t is not None:
                I_m = I_m - mu - (torch.sum(z, dim=-1, keepdim=True)
                                  - quota_t) / v
            z = torch.clamp(I_m * v / (1.0 + (1.0 - zt) ** 2), 0.0, 1.0)
            # W update, Eq. 33
            W = torch.amax(z * tu, dim=-1, keepdim=True)
            # γ projected subgradient on constraint (28b)
            gamma = torch.clamp_min(
                gamma + (z * tu - W) / torch.clamp_min(v, 1e-6) * 0.1, 0.0)
        # dual updates, Eqs. 34-35
        q = q + (z * (1.0 - zt)) / v
        qt = qt + (z - zt) / v
        if quota_t is not None:
            mu = mu + (torch.sum(z, dim=-1, keepdim=True) - quota_t) / v
        v = v * shrink

    if quota is not None:
        # deterministic rounding to exactly M_c servers (largest z first)
        thresh = torch.sort(z, dim=-1).values[..., m - quota, None]
        z_bin = (z >= thresh).float()
        excess = torch.cumsum(z_bin, dim=-1) > quota  # keep exactly `quota`
        z_bin = torch.where(excess, 0.0, z_bin)
    else:
        z_bin = (z > 0.5).float()

    residual = torch.amax(torch.abs(z - zt), dim=-1) + \
        torch.amax(torch.abs(z * (1.0 - zt)), dim=-1)
    obj = _objective(z_bin, U, edge_energy, t_cloud, lam_t_t, lam_e_t)
    return PDDResult(z, z_bin, obj, torch.amax(z_bin * tu, dim=-1),
                     residual, outer_iters * inner_iters)


def semi_sync_fastest(per_edge_time: torch.Tensor, quota: int
                      ) -> torch.Tensor:
    """Paper §II-B2 baseline selector: the M_c fastest edge servers (of
    each seed's, over a fleet's (S, M))."""
    order = torch.argsort(per_edge_time, dim=-1, stable=True)
    z = torch.zeros_like(per_edge_time, dtype=torch.float32)
    return z.scatter_(-1, order[..., :quota], 1.0)

"""Time/energy cost model for one HFL global round (paper Eqs. 3-5, 9-19).

Vectorised over all clients and edge servers.  ``assoc`` (N, M) is the
one-hot client-edge association, ``z`` (M,) the semi-synchronous
edge-selection mask.  Every input may carry a leading fleet axis S
(``assoc`` (S, N, M), ``z`` (S, M), …): each reduction is over its own
seed's clients or edges.  NOMA uplink rates come from the SIC kernel
(``kernels.hfl_ops.sic_rates``); the OMA benchmark is plain torch.  On the
candidate path the uplink is billed from the compact assigned vector
(``uplink_assigned``: the sorted SIC of ``noma.sic_rates_assigned``, plain
torch on every device, as the reference has no kernel for it).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import candidates, noma
from repro_torch.kernels import hfl_ops


class RoundCost(NamedTuple):
    total_time_s: torch.Tensor        # T  (Eq. 18)
    total_energy_j: torch.Tensor      # E  (Eq. 19)
    cost: torch.Tensor                # λt·T + λe·E  (Eq. 23a)
    per_edge_time_s: torch.Tensor     # (M,) T_m^cloud + T^edge_{N_m}
    per_edge_energy_j: torch.Tensor   # (M,) E_m^cloud + E^edge_{N_m}
    client_time_s: torch.Tensor       # (N,) per-edge-iteration t_cmp + t_com
    rates_bps: torch.Tensor           # (N,) uplink rates
    client_energy_j: torch.Tensor     # (N,) per-edge-iteration e_cmp + e_com


def _rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """The IEEE quotient c / x (``float / Tensor`` in torch multiplies by
    the reciprocal instead)."""
    return x.new_full((), c) / x


def local_compute(cfg, f_hz: torch.Tensor, n_samples: torch.Tensor,
                  capacitance: torch.Tensor | None = None):
    """Eqs. 4-5: per-client local training time and energy for τ₁
    iterations.  ``capacitance`` (N,), or (S, N) over a fleet, replaces the
    homogeneous ``cfg.capacitance`` with a scenario's per-device κ."""
    tau1 = cfg.tau1
    kappa = cfg.capacitance if capacitance is None else capacitance
    t_cmp = tau1 * cfg.cycles_per_sample * n_samples / f_hz
    e_cmp = tau1 * (kappa / 2.0) * (f_hz ** 2) \
        * cfg.cycles_per_sample * n_samples
    return t_cmp, e_cmp


def uplink(cfg, power_w: torch.Tensor, gains: torch.Tensor,
           assoc: torch.Tensor, *, noma_enabled: bool = True):
    """Eqs. 7-10 per edge server: uplink rates, then t_com / e_com.

    gains: (N, M) |h|² to every edge; assoc: (N, M) one-hot.  NOMA runs the
    SIC kernel over all edges; ``noma_enabled=False`` models the OMA
    benchmark, where each edge splits its band equally among its K_m
    clients.  Returns (t_com (N,), e_com (N,), rates (N,)).
    """
    noise = noma.noise_power_w(cfg.noise_dbm_per_hz, cfg.bandwidth_hz)
    if noma_enabled:
        rates_nm = hfl_ops.sic_rates(power_w, gains, assoc > 0,
                                     bandwidth_hz=cfg.bandwidth_hz,
                                     noise_w=noise)
        rates = torch.sum(rates_nm * assoc, dim=-1)
    else:
        k_m = torch.clamp_min(torch.sum(assoc, dim=-2), 1.0)         # (M,)
        share = torch.sum(assoc / k_m[..., None, :], dim=-1)         # (N,)
        own_gain = torch.sum(gains * assoc, dim=-1)
        band = cfg.bandwidth_hz * share
        snr = power_w * own_gain / torch.clamp_min(noise * share, 1e-30)
        rates = band * torch.log2(1.0 + snr)
    associated = torch.sum(assoc, dim=-1) > 0
    safe_rates = torch.where(associated, torch.clamp_min(rates, 1.0), 1.0)
    t_com = torch.where(associated, _rdiv(cfg.model_size_bits, safe_rates),
                        0.0)
    e_com = power_w * t_com
    return t_com, e_com, rates


def uplink_assigned(cfg, power_w: torch.Tensor, own_gain: torch.Tensor,
                    assigned: torch.Tensor, *, n_edges: int,
                    max_per_edge: int, noma_enabled: bool = True):
    """``uplink`` over the compact association: (N,) power, (N,) gain to
    the assigned edge, (N,) assigned edge (−1 = unmatched).  NOMA rates
    come from ``noma.sic_rates_assigned``; OMA reads each edge's
    occupancy off one exact scatter-add (a fleet's seeds folded into its
    index).  Returns (t_com (N,), e_com (N,), rates (N,))."""
    noise = noma.noise_power_w(cfg.noise_dbm_per_hz, cfg.bandwidth_hz)
    matched = assigned >= 0
    if noma_enabled:
        rates = noma.sic_rates_assigned(
            power_w, own_gain, assigned, n_edges=n_edges,
            max_per_edge=max_per_edge, bandwidth_hz=cfg.bandwidth_hz,
            noise_w=noise)
    else:
        n = assigned.shape[-1]
        seeds = assigned.numel() // max(n, 1)
        base = torch.arange(seeds, device=assigned.device)[:, None] * n_edges
        safe = (torch.clamp_min(assigned, 0).reshape(seeds, n) + base
                ).reshape(assigned.shape).long()
        k_m = torch.zeros((seeds * n_edges,), dtype=torch.float32,
                          device=power_w.device)
        k_m = torch.clamp_min(k_m.index_add(0, safe.reshape(-1),
                                            matched.float().reshape(-1)),
                              1.0)
        share = torch.where(matched, _rdiv(1.0, k_m[safe]), 0.0)
        band = cfg.bandwidth_hz * share
        snr = power_w * torch.where(matched, own_gain, 0.0) \
            / torch.clamp_min(noise * share, 1e-30)
        rates = band * torch.log2(1.0 + snr)
    safe_rates = torch.where(matched, torch.clamp_min(rates, 1.0), 1.0)
    t_com = torch.where(matched, _rdiv(cfg.model_size_bits, safe_rates), 0.0)
    e_com = power_w * t_com
    return t_com, e_com, rates


def apply_schedule(cfg, rc: RoundCost, z: torch.Tensor) -> RoundCost:
    """Re-mask a ``round_cost`` evaluated at z = 1 with the actual edge
    selection: Eqs. 18-19 + 23a are a masked reduction over the per-edge
    totals, so the scheduler needs one cost evaluation."""
    total_time = torch.amax(z * rc.per_edge_time_s, dim=-1)
    total_energy = torch.sum(z * rc.per_edge_energy_j, dim=-1)
    c = cfg.lambda_t * total_time + cfg.lambda_e * total_energy
    return rc._replace(total_time_s=total_time, total_energy_j=total_energy,
                       cost=c)


def cohort_cost(cfg, rc: RoundCost, cohort: torch.Tensor,
                dt_s: torch.Tensor, fired: torch.Tensor) -> RoundCost:
    """The buffered engine's bill of one micro-step: no barrier, so the
    time charge is the virtual clock's advance ``dt_s``; the energy is the
    admitted ``cohort``'s τ₂-scaled per-client Eq. 5/10 energy plus one
    Eq. 16 edge→cloud hop when the merge ``fired`` (the buffered merge is
    one cloud exchange).  ``cohort`` (…, N) bool, ``dt_s`` and ``fired``
    (…,), in float32."""
    f32 = torch.float32
    e_cloud = cfg.edge_power_w * cfg.edge_model_size_bits / cfg.edge_rate_bps
    energy = cfg.tau2 * torch.sum(cohort.to(f32) * rc.client_energy_j,
                                  dim=-1) + fired.to(f32) * e_cloud
    c = cfg.lambda_t * dt_s + cfg.lambda_e * energy
    return rc._replace(total_time_s=dt_s, total_energy_j=energy, cost=c)


def round_cost(cfg, *, power_w: torch.Tensor, f_hz: torch.Tensor,
               gains: torch.Tensor, assoc: torch.Tensor, z: torch.Tensor,
               n_samples: torch.Tensor, noma_enabled: bool = True,
               capacitance: torch.Tensor | None = None,
               sic_max_per_edge: int | None = None,
               assigned: torch.Tensor | None = None) -> RoundCost:
    """Full Eq. 23a cost for one global round.

    ``capacitance``: a scenario's per-device κ (``local_compute``).
    ``assigned`` (N,): the candidate path's compact association.  The
    uplink then runs on (N,) and (M, k) tensors (``uplink_assigned``),
    with ``sic_max_per_edge`` (the admission quota) bounding each edge's
    decode table; the per-edge reductions below still use the one-hot
    ``assoc``."""
    t_cmp, e_cmp = local_compute(cfg, f_hz, n_samples, capacitance)
    if assigned is not None:
        if sic_max_per_edge is None:
            raise ValueError("round_cost(assigned=...) needs the "
                             "sic_max_per_edge admission bound")
        t_com, e_com, rates = uplink_assigned(
            cfg, power_w, candidates.own_edge_gather(assigned, gains),
            assigned, n_edges=assoc.shape[-1],
            max_per_edge=sic_max_per_edge, noma_enabled=noma_enabled)
    else:
        t_com, e_com, rates = uplink(cfg, power_w, gains, assoc,
                                     noma_enabled=noma_enabled)
    associated = torch.sum(assoc, dim=-1) > 0
    client_time = torch.where(associated, t_cmp + t_com, 0.0)
    client_energy = torch.where(associated, e_cmp + e_com, 0.0)

    tau2 = cfg.tau2
    in_edge = assoc > 0
    # Eq. 13: synchronous edge round = slowest associated client, × τ₂
    per_edge_time = tau2 * torch.amax(
        torch.where(in_edge, client_time[..., None], 0.0), dim=-2)  # (M,)
    # Eq. 14
    per_edge_energy = tau2 * torch.sum(
        torch.where(in_edge, client_energy[..., None], 0.0), dim=-2)

    # Eqs. 15-16: OFDMA edge->cloud
    t_cloud = cfg.edge_model_size_bits / cfg.edge_rate_bps
    e_cloud = cfg.edge_power_w * t_cloud
    edge_total_time = per_edge_time + t_cloud
    edge_total_energy = per_edge_energy + e_cloud

    # Eqs. 18-19 with the semi-sync mask z
    total_time = torch.amax(z * edge_total_time, dim=-1)
    total_energy = torch.sum(z * edge_total_energy, dim=-1)
    c = cfg.lambda_t * total_time + cfg.lambda_e * total_energy
    return RoundCost(total_time, total_energy, c, edge_total_time,
                     edge_total_energy, client_time, rates, client_energy)

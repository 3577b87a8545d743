"""The per-round trace (the reference's ``repro.telemetry.trace``).

``RoundTrace`` carries what ``RoundMetrics`` collapses to two scalars --
the Eq. 23a time/energy bill split by term, the deferred-acceptance and
PDD counters, the candidate frontier's health, the NOMA SIC decode depth,
a staleness histogram, and the buffered engine's trigger state -- as
tensor leaves with the reference's 25 names and dtypes.  Every leaf
carries the round's leading fleet axis S (``fleet_step`` builds one trace
for all seeds); ``round_step`` selects seed 0.

Building it is an elementwise epilogue over tensors the round already
computed: it re-runs no stage and launches no kernel of ``hfl_ops``.  The
decomposition identity holds by construction::

    energy_local_j + energy_uplink_j + energy_cloud_j == total_energy_j
    max over selected edges <= time_local_s + time_uplink_s + time_cloud_s
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import cost
from repro_torch.core.candidates import CandidateSet

# Staleness histogram bucket LOWER edges: bucket b counts clients with
# A_n in [edge_b, edge_{b+1}) (A_n >= 1 by Eq. 20; the last bucket is
# open-ended).
STALE_BIN_EDGES = (1, 2, 3, 4, 5, 6, 8, 12)


class RoundTrace(NamedTuple):
    """Per-round, per-stage observables, each with a leading seed axis
    (none after ``round_step``'s seed selection).

    Cost decomposition (restricted to the billed set: clients on
    z-selected edges): ``time_local_s`` τ₂ · max billed t_cmp,
    ``time_uplink_s`` τ₂ · max billed t_com, ``time_cloud_s`` the Eq. 15
    edge→cloud hop, and the matching Σ-shaped ``energy_*_j``, which sum
    to ``RoundMetrics.total_energy_j``.

    Association: ``assoc_sweeps`` (the resolver's sweeps; warm-started,
    the warm sweeps plus any cold fallback's), ``edge_load``
    (M,) admitted clients per edge, ``frontier_valid_frac`` (valid share
    of the (N, K) frontier, or of the (N, M) coverage mask when dense),
    ``frontier_saturation`` (share of matched clients admitted through
    their last frontier slot).

    Scheduler, NOMA, staleness: ``pdd_iters``/``pdd_residual`` (zeros for
    "fastest" and the buffered engine), ``z_relaxed`` (M,) PDD's
    continuous z, ``sic_depth`` the longest SIC decode chain (max edge
    occupancy), ``stale_hist`` (8,) of the post-update A_n.

    Buffered engine (zeros on the sync engine): ``buffer_fill`` (updates
    in the buffer at the trigger, before any reset), ``trigger_cause``
    (0 none, 1 fill, 2 timeout), ``tier_active``, ``tier_occupancy``.

    Fault layer (zeros with ``EngineSpec.faults`` off): ``dead_edges``
    (edges down after the churn step), ``orphaned_clients`` (available
    clients whose in-coverage edges are all dead), ``uplink_retries``
    (lost uploads re-sent with backoff: buffered engine only),
    ``uplink_dropped`` (updates lost for good, crashes included),
    ``quarantined`` (deltas the guard rejected).
    """
    round: torch.Tensor               # () int32
    time_local_s: torch.Tensor        # () float32
    time_uplink_s: torch.Tensor       # () float32
    time_cloud_s: torch.Tensor        # () float32
    energy_local_j: torch.Tensor      # () float32
    energy_uplink_j: torch.Tensor     # () float32
    energy_cloud_j: torch.Tensor      # () float32
    assoc_sweeps: torch.Tensor        # () int32
    edge_load: torch.Tensor           # (M,) int32
    frontier_valid_frac: torch.Tensor  # () float32
    frontier_saturation: torch.Tensor  # () float32
    pdd_iters: torch.Tensor           # () int32
    pdd_residual: torch.Tensor        # () float32
    z_relaxed: torch.Tensor           # (M,) float32
    sic_depth: torch.Tensor           # () int32
    stale_hist: torch.Tensor          # (8,) int32
    buffer_fill: torch.Tensor         # () int32
    trigger_cause: torch.Tensor       # () int32
    tier_active: torch.Tensor         # () int32
    tier_occupancy: torch.Tensor      # () int32
    dead_edges: torch.Tensor          # () int32
    orphaned_clients: torch.Tensor    # () int32
    uplink_retries: torch.Tensor      # () int32
    uplink_dropped: torch.Tensor      # () int32
    quarantined: torch.Tensor         # () int32


def staleness_histogram(staleness: torch.Tensor) -> torch.Tensor:
    """(…, N) int staleness -> (…, len(STALE_BIN_EDGES)) int32 counts: a
    client's bucket is the sum of its comparisons with the edges above
    the first (the reference's clipped count), so the histogram is exact
    on every device (no scatter-add) and copies no edge table to the
    card."""
    bucket = torch.sum(torch.stack([staleness >= e
                                    for e in STALE_BIN_EDGES[1:]], dim=-1),
                       dim=-1)
    bins = torch.arange(len(STALE_BIN_EDGES), device=staleness.device)
    return torch.sum(bucket[..., None] == bins, dim=-2, dtype=torch.int32)


def _share(mask: torch.Tensor, dims) -> torch.Tensor:
    """The float32 share of true entries of ``mask`` over ``dims``: the
    count over a 0-d tensor filled on the mask's device (a division by a
    Python number multiplies by its reciprocal on CUDA, and
    ``torch.tensor(v, device=...)`` is a blocking copy)."""
    count = 1
    for d in dims:
        count *= mask.shape[d]
    return torch.sum(mask, dim=dims, dtype=torch.float32) / torch.full(
        (), float(count), device=mask.device)


def round_trace(cfg, spec, *, round_idx: int, rc_all: cost.RoundCost,
                z: torch.Tensor, assoc: torch.Tensor, power_w: torch.Tensor,
                f_hz: torch.Tensor, counts: torch.Tensor,
                staleness: torch.Tensor,
                capacitance: Optional[torch.Tensor],
                sweeps: torch.Tensor,
                sched: Optional[Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]],
                cand: Optional[CandidateSet],
                assigned: Optional[torch.Tensor],
                dist: torch.Tensor, avail: Optional[torch.Tensor],
                coverage_radius_m: float,
                buffer: Optional[Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]] = None,
                faults: Optional[Tuple[torch.Tensor, ...]] = None
                ) -> RoundTrace:
    """One round's trace of every seed (leading axis S on every input)
    from tensors the round already computed.

    ``rc_all`` is the z = 1 cost surface; ``sched`` the scheduler's
    (iterations (S,) int32, residual (S,), z_relaxed (S, M)), ``None`` on
    the buffered engine (the PDD leaves read 0); ``staleness`` the
    post-update A_n; ``sweeps`` (S,) int32; ``buffer`` the buffered
    engine's (fill, trigger_cause, tier_active, tier_occupancy), each (S,)
    (``None`` on sync: those leaves read 0); ``faults`` the fault layer's
    (dead_edges, orphaned_clients, uplink_retries, uplink_dropped,
    quarantined), each (S,) (``None`` with faults off: those leaves read
    0)."""
    f32, i32 = torch.float32, torch.int32
    seeds = assoc.shape[:-2]
    dev = assoc.device
    associated = torch.sum(assoc, dim=-1) > 0
    billed = torch.sum(assoc * z[..., None, :], dim=-1) > 0      # (S, N)

    # the Eq. 23a decomposition: the per-client stage terms recovered from
    # the cached client_time (= t_cmp + t_com on associated clients)
    t_cmp, e_cmp = cost.local_compute(cfg, f_hz, counts, capacitance)
    t_com = torch.where(associated, rc_all.client_time_s - t_cmp, 0.0)
    e_com = power_w * t_com
    tau2 = cfg.tau2
    any_edge = torch.sum(z, dim=-1) > 0
    t_cloud = cfg.edge_model_size_bits / cfg.edge_rate_bps
    e_cloud = cfg.edge_power_w * t_cloud
    bm = billed.to(f32)

    # association and frontier health
    edge_load = torch.sum(assoc, dim=-2).to(i32)                  # (S, M)
    if cand is not None:
        valid_frac = _share(cand.valid, (-2, -1))
        matched = assigned >= 0
        # the first matching slot: ``argmax`` of the int cast (the first
        # maximum wins; CUDA's argmax takes no bools)
        slot = torch.argmax(
            (cand.idx == torch.clamp_min(assigned, 0)[..., None]).to(i32),
            dim=-1)
        last = matched & (slot == cand.idx.shape[-1] - 1)
        frontier_sat = torch.sum(last, dim=-1, dtype=f32) / torch.clamp_min(
            torch.sum(matched, dim=-1, dtype=f32), 1.0)
    else:
        cov = dist <= coverage_radius_m
        if avail is not None:
            cov = cov & (avail > 0)[..., None]
        valid_frac = _share(cov, (-2, -1))
        frontier_sat = torch.zeros(seeds, dtype=f32, device=dev)

    zero_i = torch.zeros(seeds, dtype=i32, device=dev)
    if sched is None:
        sched = (zero_i, torch.zeros(seeds, dtype=f32, device=dev),
                 torch.zeros(z.shape, dtype=f32, device=dev))
    iters, residual, z_relaxed = sched
    if buffer is None:
        buffer = (zero_i,) * 4
    b_fill, b_cause, b_tier, b_occ = buffer
    if faults is None:
        faults = (zero_i,) * 5
    f_dead, f_orph, f_retry, f_drop, f_quar = faults
    return RoundTrace(
        round=torch.full(seeds, round_idx, dtype=i32, device=dev),
        time_local_s=tau2 * torch.amax(bm * t_cmp, dim=-1),
        time_uplink_s=tau2 * torch.amax(bm * t_com, dim=-1),
        time_cloud_s=t_cloud * any_edge.to(f32),
        energy_local_j=tau2 * torch.sum(bm * e_cmp, dim=-1),
        energy_uplink_j=tau2 * torch.sum(bm * e_com, dim=-1),
        energy_cloud_j=e_cloud * torch.sum(z, dim=-1),
        assoc_sweeps=sweeps.to(i32),
        edge_load=edge_load,
        frontier_valid_frac=valid_frac,
        frontier_saturation=frontier_sat,
        pdd_iters=iters.to(i32),
        pdd_residual=residual.to(f32),
        z_relaxed=z_relaxed.to(f32),
        sic_depth=torch.amax(edge_load, dim=-1),
        stale_hist=staleness_histogram(staleness),
        buffer_fill=b_fill.to(i32),
        trigger_cause=b_cause.to(i32),
        tier_active=b_tier.to(i32),
        tier_occupancy=b_occ.to(i32),
        dead_edges=f_dead.to(i32), orphaned_clients=f_orph.to(i32),
        uplink_retries=f_retry.to(i32), uplink_dropped=f_drop.to(i32),
        quarantined=f_quar.to(i32))

"""The per-round fault processes (the reference's ``repro.faults.inject``).

Each function maps the spec's constants, the round's uniforms and state
tensors to new tensors, over any leading axes (a fleet's seed axis S
first).  They take uniforms, not keys: the engine draws them
(``engine.FaultDraws``), last in the round and only when
``EngineSpec.faults`` is set, so a no-fault stream is unchanged.

Nothing here reads a value back to the host, and the veto is a
``torch.where``.  A probability or scale beside a float32 tensor is a
Python number, which the comparison, product or sum applies in float32,
as the reference's weak-typed constants are (a kernel argument, no
launch); the power's base is a float32 0-d tensor filled on the device.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.faults.spec import FaultSpec

# distance pushed far past any coverage radius: a dead edge is simply
# unreachable, so the unchanged association routes around it
DEAD_EDGE_DIST = 1e9


def advance_edges(fspec: FaultSpec, u: torch.Tensor, edge_up: torch.Tensor
                  ) -> torch.Tensor:
    """One Markov churn step over the live-edge mask (…, M) from the
    uniforms ``u`` (…, M): live edges die where u < ``edge_p_kill``, dead
    ones respawn where u < ``edge_p_respawn``.  A seed whose step would
    leave fewer than ``min_edges_up`` live edges keeps its previous mask
    (the veto, per seed)."""
    up = edge_up > 0
    nxt = torch.where(up, u >= fspec.edge_p_kill, u < fspec.edge_p_respawn)
    ok = torch.sum(nxt, dim=-1) >= min(int(fspec.min_edges_up),
                                       edge_up.shape[-1])
    return torch.where(ok[..., None], nxt, up).to(torch.float32)


def masked_dist(dist: torch.Tensor, edge_up: torch.Tensor) -> torch.Tensor:
    """The association view of the (…, N, M) distance field: dead edges
    pushed out of every coverage disk."""
    return torch.where(edge_up[..., None, :] > 0, dist, DEAD_EDGE_DIST)


def uplink_loss_prob(fspec: FaultSpec, gains: torch.Tensor,
                     edge_up: torch.Tensor) -> torch.Tensor:
    """(…, N) upload-loss probability tied to the channel: a client's best
    live-edge gain over the best of its seed's N clients, q in (0, 1];
    ``uplink_p_loss + uplink_loss_slope · (1 − q)`` clipped to [0, 0.95]."""
    live = torch.where(edge_up[..., None, :] > 0, gains, 0.0)
    best = torch.amax(live, dim=-1)                                # (…, N)
    q = best / torch.clamp_min(torch.amax(best, dim=-1, keepdim=True),
                               1e-30)
    p = fspec.uplink_p_loss + fspec.uplink_loss_slope * (1.0 - q)
    return torch.clamp(p, 0.0, 0.95)


def draw_losses(fspec: FaultSpec, u: torch.Tensor, gains: torch.Tensor,
                edge_up: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """(…, N) bool: which of the ``active`` uploads are lost (u (…, N))."""
    return active & (u < uplink_loss_prob(fspec, gains, edge_up))


def draw_crashes(fspec: FaultSpec, u: torch.Tensor, admitted: torch.Tensor
                 ) -> torch.Tensor:
    """(…, N) bool: which ``admitted`` clients crash mid-round."""
    return admitted & (u < fspec.client_p_crash)


def poison_deltas(fspec: FaultSpec, u: torch.Tensor,
                  deltas: Dict[str, torch.Tensor], produced: torch.Tensor
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Corrupt the ``produced`` deltas where u < ``p_poison``: ``leaf +
    nan`` with ``poison_nan``, else ``leaf · poison_scale``.  Deltas are
    leaves (…, N, …) over ``produced`` (…, N).  Returns (deltas',
    poisoned)."""
    poisoned = produced & (u < fspec.p_poison)
    out = {}
    for k, leaf in deltas.items():
        m = poisoned.reshape(poisoned.shape
                             + (1,) * (leaf.dim() - poisoned.dim()))
        bad = (leaf + float("nan") if fspec.poison_nan
               else leaf * fspec.poison_scale)
        out[k] = torch.where(m, bad, leaf)
    return out, poisoned


def backoff_s(fspec: FaultSpec, attempts: torch.Tensor) -> torch.Tensor:
    """The backoff delay of retry number ``attempts`` (0-based):
    ``backoff_base_s · backoff_factor^attempts`` in float32."""
    return fspec.backoff_base_s * torch.pow(
        torch.full((), fspec.backoff_factor, dtype=torch.float32,
                   device=attempts.device), attempts.to(torch.float32))


def orphan_count(dist: torch.Tensor, edge_up: torch.Tensor,
                 coverage_radius_m: float, avail: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """(…) int32: available clients with an in-coverage edge but no live
    one -- the clients the churn cut off this round.  ``dist`` is the
    physical (…, N, M) field."""
    cov = dist <= coverage_radius_m
    live = cov & (edge_up[..., None, :] > 0)
    orphaned = torch.any(cov, dim=-1) & ~torch.any(live, dim=-1)
    if avail is not None:
        orphaned = orphaned & (avail > 0)
    return torch.sum(orphaned, dim=-1, dtype=torch.int32)

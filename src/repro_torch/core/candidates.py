"""The (N, K) candidate edge frontier.

A client can only ever associate with the few edge servers whose coverage
disk it sits in, yet the dense round scores, ranks and bills all (N, M)
client-edge pairs.  A ``CandidateSet`` is the pruned frontier the
candidate round consumes instead:

* ``idx``   (N, K) int32 -- each client's K nearest edges, row-sorted by
  (distance ascending, edge index ascending).  The candidate resolver's
  first-minimum ``argmin`` over slots relies on that order: it is the
  dense resolvers' (distance, edge) tie-break.
* ``valid`` (N, K) bool -- in coverage (dist ≤ radius) and, in a dynamic
  scenario, available this round.  Coverage is a distance threshold, so
  the in-coverage edges are a prefix of the row;
  K ≥ the maximum coverage degree loses nothing, and the candidate round
  then makes the dense round's decisions.
* ``dist``  (N, K) float32 -- the gathered distances.

``lexsort`` and ``segment_starts`` are the grouping steps of the compact
candidate stages: the resolver's rank order and the sorted SIC's decode
table.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CandidateSet(NamedTuple):
    """Per-client pruned edge frontier."""
    idx: torch.Tensor     # (N, K) int32 edge indices, (dist, edge)-sorted
    valid: torch.Tensor   # (N, K) bool -- in coverage (and available)
    dist: torch.Tensor    # (N, K) gathered client-edge distances


def build_candidates(dist: torch.Tensor, k: int, *,
                     coverage_radius_m: float,
                     avail: torch.Tensor | None = None) -> CandidateSet:
    """The ``k`` nearest edges per client from the (N, M) distance field
    (or a fleet's (S, N, M): every step is per row).  ``avail`` (N,) marks
    a dropped client's whole row invalid: it is out of every edge's
    coverage this round.

    A stable ascending sort keeps exact distance ties in edge-index order,
    as the reference's ``top_k`` of the negated distances does
    (``torch.topk`` promises no order among ties)."""
    k = min(int(k), dist.shape[-1])
    dk, idx = torch.sort(dist, dim=-1, stable=True)
    dk, idx = dk[..., :k], idx[..., :k]
    valid = dk <= coverage_radius_m
    if avail is not None:
        valid = valid & (avail > 0)[..., None]
    return CandidateSet(idx=idx.to(torch.int32), valid=valid, dist=dk)


def gather(cand: CandidateSet, field: torch.Tensor) -> torch.Tensor:
    """An (N, M) per-pair field gathered down to the (N, K) frontier
    (each with a leading fleet axis, or none)."""
    return torch.gather(field, -1, cand.idx.long())


def assigned_one_hot(assigned: torch.Tensor, n_edges: int) -> torch.Tensor:
    """(…, N) assigned edge (−1 = unmatched) -> (…, N, M) one-hot int32."""
    col = torch.arange(n_edges, dtype=assigned.dtype, device=assigned.device)
    return ((assigned[..., None] == col)
            & (assigned[..., None] >= 0)).to(torch.int32)


def own_edge_gather(assigned: torch.Tensor, field: torch.Tensor
                    ) -> torch.Tensor:
    """(…, N) values of an (…, N, M) field at each client's assigned edge,
    0.0 for unmatched clients."""
    safe = torch.clamp_min(assigned, 0).long()
    got = torch.gather(field, -1, safe[..., None])[..., 0]
    return torch.where(assigned >= 0, got, 0.0)


def lexsort(minor: torch.Tensor, major: torch.Tensor) -> torch.Tensor:
    """The permutation sorting by ``major``, then ``minor``, then position
    (``jnp.lexsort((minor, major))``): two stable argsorts."""
    by_minor = torch.argsort(minor, stable=True)
    return by_minor[torch.argsort(major[by_minor], stable=True)]


def segment_starts(keys: torch.Tensor) -> torch.Tensor:
    """For sorted ``keys`` (R,), the position where each element's run of
    equal keys starts."""
    iota = torch.arange(keys.shape[0], device=keys.device)
    is_start = torch.ones_like(keys, dtype=torch.bool)
    is_start[1:] = keys[1:] != keys[:-1]
    return torch.cummax(torch.where(is_start, iota, 0), dim=0).values


def max_coverage_degree(dist, coverage_radius_m: float, avail=None) -> int:
    """The smallest K that loses nothing: the most in-coverage edges of
    any (available) client (host-side)."""
    cov = np.asarray(torch.as_tensor(dist).cpu()) <= coverage_radius_m
    if avail is not None:
        cov = cov & (np.asarray(torch.as_tensor(avail).cpu()) > 0)[..., None]
    return int(cov.sum(axis=-1).max()) if cov.size else 0

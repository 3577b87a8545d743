"""Client-edge association (paper §III + the §V greedy benchmark).

* FCEA -- each edge ranks its in-coverage clients by fuzzy competency NO*
  and admits its top N_m; a client wanted by several edges goes to the
  nearest one and the losing edges take the next client in their queue.
* GCEA -- the greedy benchmark: rank by channel gain alone.

The greedy admission is edge-proposing deferred acceptance (Gale–Shapley
with quotas).  ``resolve_parallel`` plays it as batched sweeps: every
edge proposes to its top ``quota - held`` not-yet-rejected in-coverage
clients at once, every client keeps its best offer by the strict
(distance, edge index) order, and losing offers are rejected for good.
The loop ends at the first sweep with no proposal -- a data-dependent exit,
so each sweep reads one flag back to the host.

RCEA (uniform random preferences) is not ported yet (ROADMAP A13).
"""
from __future__ import annotations

import torch

POLICIES = ("fcea", "gcea")


def resolve_parallel(order: torch.Tensor, dist: torch.Tensor, quota: int,
                     coverage: torch.Tensor, return_sweeps: bool = False):
    """Vectorised quota-round deferred acceptance.

    order: (M, N) -- per-edge client indices by descending preference;
    dist: (N, M) client-edge distances; coverage: (N, M) bool.
    Returns assoc (N, M) one-hot int32; with ``return_sweeps`` also the
    number of sweeps run.
    """
    m_edges, n_clients = order.shape
    dev = order.device
    # rank[m, c] = position of client c in edge m's queue
    rank = torch.empty((m_edges, n_clients), dtype=torch.int64, device=dev)
    rank.scatter_(1, order.long(), torch.arange(
        n_clients, device=dev).expand(m_edges, n_clients).contiguous())
    big = n_clients + 1
    col = torch.arange(m_edges, dtype=torch.int32, device=dev)
    k_top = min(quota, n_clients)
    max_sweeps = n_clients * m_edges + 2

    assigned = torch.full((n_clients,), -1, dtype=torch.int32, device=dev)
    rejected = ~coverage
    sweeps = 0
    while sweeps < max_sweeps:
        held = assigned[None, :] == col[:, None]                  # (M, N)
        deficit = quota - torch.sum(held, dim=1)                  # (M,)
        elig = (~rejected.T) & (~held)
        keys = torch.where(elig, rank, big)
        # the deficit-th smallest eligible rank is the proposal cut-off;
        # ranks are distinct, so exactly min(deficit, #eligible) propose
        kth = torch.topk(keys, k_top, dim=1, largest=False).values  # (M, k)
        thr_idx = torch.clamp(deficit - 1, 0, k_top - 1)
        thr = torch.gather(kth, 1, thr_idx[:, None])[:, 0]
        propose = elig & (keys <= thr[:, None]) & (deficit > 0)[:, None]
        # candidates per client: the incumbent plus incoming proposals
        cand = propose.T | (assigned[:, None] == col[None, :])    # (N, M)
        ckey = torch.where(cand, dist, torch.inf)
        # argmin keeps the first minimum: the (distance, edge) tie-break
        best = torch.argmin(ckey, dim=1).to(torch.int32)
        has = torch.any(cand, dim=1)
        assigned = torch.where(has, best, -1).to(torch.int32)
        rejected = rejected | (cand & (col[None, :] != best[:, None]))
        sweeps += 1
        if not bool(torch.any(propose)):
            break
    assoc = ((assigned[:, None] == col[None, :])
             & (assigned[:, None] >= 0)).to(torch.int32)
    if return_sweeps:
        return assoc, sweeps
    return assoc


def associate(policy: str, *, scores: torch.Tensor | None,
              gains: torch.Tensor, dist: torch.Tensor, quota: int,
              coverage_radius_m: float, return_sweeps: bool = False):
    """Dense (N, M) one-hot association for ``policy`` (fcea or gcea)."""
    if policy == "fcea":
        pref = scores
    elif policy == "gcea":
        pref = gains
    elif policy == "rcea":
        raise NotImplementedError(
            "rcea draws uniform preferences; not ported yet (ROADMAP A13)")
    else:
        raise ValueError(f"unknown association policy {policy!r}")
    if pref.dim() == 1:
        pref = pref[:, None].expand(dist.shape)
    coverage = dist <= coverage_radius_m
    pref = torch.where(coverage, pref, -torch.inf)
    # stable: exact preference ties go to the lower client index
    order = torch.argsort(-pref, dim=0, stable=True).T          # (M, N)
    return resolve_parallel(order, dist, quota, coverage,
                            return_sweeps=return_sweeps)

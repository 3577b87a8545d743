"""Client-edge association (paper §III + the §V greedy benchmark).

* FCEA -- each edge ranks its in-coverage clients by fuzzy competency NO*
  and admits its top N_m; a client wanted by several edges goes to the
  nearest one and the losing edges take the next client in their queue.
* GCEA -- the greedy benchmark: rank by channel gain alone.
* RCEA -- the random benchmark: rank by a drawn Uniform[0, 1) (N, M)
  preference (``RoundDraws.assoc_u``).

The greedy admission is edge-proposing deferred acceptance (Gale–Shapley
with quotas).  ``resolve_parallel`` plays it as batched sweeps: every
edge proposes to its top ``quota - held`` not-yet-rejected in-coverage
clients at once, every client keeps its best offer by the strict
(distance, edge index) order, and losing offers are rejected for good.
The loop ends at the first sweep with no proposal -- a data-dependent exit,
so each sweep reads one flag back to the host.  Over a fleet (a leading
seed axis on every input) each seed stops at its own first sweep with no
proposal, and one read a sweep brings back every seed's flag.

``resolve_candidates`` plays the same sweeps on the (N, K) candidate
frontier (``core.candidates``), with every per-sweep tensor O(N·K).

Both resolvers take a ``seed`` (N,) -- a previous round's assigned
vector -- that warm-starts the sweeps: the seeds still valid today are
the initial holds, the unchanged sweeps run to their fixed point, and a
seed whose result admits a blocking pair (``_blocking_pair_dense``,
``_blocking_pair_frontier``) is resolved cold as well, its sweep count
billing both phases.  The warm result is therefore a stable matching of
today's market, and over a fleet the fallback is decided seed by seed:
one read brings back every seed's flag, and one cold resolution, run only
if some seed blocks, is selected per seed.

``resolve_serial`` is the reference's serial resolver (``resolve_jax``):
one queue pop a step, the same matching, its pop count for a sweep
count.  Nothing on the round's path calls it.
"""
from __future__ import annotations

import torch

from repro_torch.core import candidates

POLICIES = ("fcea", "gcea", "rcea")


def _sweep_done(propose: torch.Tensor, active: list, sweeps: list) -> None:
    """Close one sweep of every seed still running: count it, and stop the
    seeds that proposed nothing in it -- one flag a seed, read back in one
    transfer.  A stopped seed's sweeps are no-ops: with no proposal, every
    client keeps its incumbent (its only offer) and no new rejection is
    made, so the next sweep sees the same state and again proposes
    nothing.  So the later sweeps of the seeds still running leave it as
    it is, as ``vmap`` of the reference's ``while_loop`` freezes a lane
    that has finished."""
    more = propose.reshape(propose.shape[0], -1).any(dim=1).tolist()
    for s, run in enumerate(active):
        if run:
            sweeps[s] += 1
            active[s] = more[s]


def _blocking_pair_dense(assigned: torch.Tensor, rank: torch.Tensor,
                         dist: torch.Tensor, coverage: torch.Tensor,
                         quota: int) -> torch.Tensor:
    """(S,) bool: does each seed's ``assigned`` (S, N) admit a blocking
    pair under today's market?  Pair (c, m) blocks when the edge wants c
    -- in coverage, not held, and m has a free slot or ranks c above its
    worst-held client -- and the client wants m: unmatched, or m beats its
    current edge by the strict (distance, edge index) order.  The cold
    resolver's matching never has one (deferred acceptance is stable), so
    this is the warm start's acceptance test.  ``rank`` (S, M, N) is each
    client's position in each edge's queue."""
    m_edges = rank.shape[-2]
    col = torch.arange(m_edges, dtype=torch.int32, device=rank.device)
    held = assigned[:, None, :] == col[:, None]                  # (S, M, N)
    deficit = quota - torch.sum(held, dim=-1)                    # (S, M)
    worst = torch.amax(torch.where(held, rank, -1), dim=-1)      # (S, M)
    edge_wants = (coverage.transpose(-1, -2) & ~held
                  & ((deficit > 0)[..., None] | (rank < worst[..., None])))
    cur_dist = torch.gather(dist, -1,
                            torch.clamp_min(assigned, 0).long()[..., None])
    nearer = (dist < cur_dist) | ((dist == cur_dist)
                                  & (col < assigned[..., None]))
    client_wants = (assigned < 0)[..., None] | nearer            # (S, N, M)
    return torch.any((edge_wants & client_wants.transpose(-1, -2))
                     .flatten(1), dim=1)


def _warm_then_cold(run, seed_ok, seed, blocking, seeds: int, n: int,
                    dev: torch.device):
    """A seeded resolution over a fleet: ``run(assigned0)`` -> (assigned
    (S, N), sweeps list) from the kept seeds, then ``blocking(assigned)``
    (S,) read back in one transfer; if some seed blocks, one cold
    ``run`` of the whole fleet, whose result replaces the blocking seeds'
    (``torch.where``) and whose sweeps are billed on top of theirs."""
    warm, sweeps = run(torch.where(seed_ok, seed.to(torch.int32), -1))
    block = blocking(warm)
    flags = block.tolist()
    if not any(flags):
        return warm, sweeps
    cold, cold_sweeps = run(torch.full((seeds, n), -1, dtype=torch.int32,
                                       device=dev))
    return (torch.where(block[:, None], cold, warm),
            [w + (c if f else 0)
             for w, c, f in zip(sweeps, cold_sweeps, flags)])


def resolve_parallel(order: torch.Tensor, dist: torch.Tensor, quota: int,
                     coverage: torch.Tensor, return_sweeps: bool = False,
                     seed: torch.Tensor | None = None):
    """Vectorised quota-round deferred acceptance.

    order: (M, N) -- per-edge client indices by descending preference;
    dist: (N, M) client-edge distances; coverage: (N, M) bool; or each
    with a leading fleet axis S, resolved at once.
    Returns assoc (N, M) one-hot int32 ((S, N, M)); with ``return_sweeps``
    also the number of sweeps run (a list of S, one a seed, over a fleet):
    each seed's count runs up to and including its first sweep with no
    proposal.

    ``seed`` (N,) int32 ((S, N)), a previous round's assigned vector,
    warm-starts the sweeps: a seed that is ≥ 0 and whose edge is still in
    ``coverage`` is an initial hold (a previous matching holds at most
    ``quota`` an edge, and coverage loss only shrinks it), the unchanged
    sweeps run to their fixed point, and where the result has a blocking
    pair one cold resolution runs, its sweeps billed on top.  ``None``
    resolves cold.
    """
    if order.dim() == 2:
        assoc, sweeps = resolve_parallel(
            order[None], dist[None], quota, coverage[None], True,
            None if seed is None else seed[None])
        return (assoc[0], sweeps[0]) if return_sweeps else assoc[0]
    seeds, m_edges, n_clients = order.shape
    dev = order.device
    # rank[s, m, c] = position of client c in edge m's queue
    rank = torch.empty(order.shape, dtype=torch.int64, device=dev)
    rank.scatter_(-1, order.long(), torch.arange(
        n_clients, device=dev).expand(order.shape).contiguous())
    big = n_clients + 1
    col = torch.arange(m_edges, dtype=torch.int32, device=dev)
    k_top = min(quota, n_clients)
    max_sweeps = n_clients * m_edges + 2

    def run(assigned):
        rejected = ~coverage
        active, sweeps = [True] * seeds, [0] * seeds
        while any(active) and max(sweeps) < max_sweeps:
            held = assigned[:, None, :] == col[:, None]           # (S, M, N)
            deficit = quota - torch.sum(held, dim=-1)             # (S, M)
            elig = (~rejected.transpose(-1, -2)) & (~held)
            keys = torch.where(elig, rank, big)
            # the deficit-th smallest eligible rank is the proposal
            # cut-off; ranks are distinct, so exactly min(deficit,
            # #eligible) propose
            kth = torch.topk(keys, k_top, dim=-1, largest=False).values
            thr_idx = torch.clamp(deficit - 1, 0, k_top - 1)
            thr = torch.gather(kth, -1, thr_idx[..., None])       # (S, M, 1)
            propose = elig & (keys <= thr) & (deficit > 0)[..., None]
            # candidates per client: the incumbent plus incoming proposals
            cand = propose.transpose(-1, -2) | (assigned[..., None] == col)
            ckey = torch.where(cand, dist, torch.inf)
            # argmin keeps the first minimum: the (distance, edge) tie-break
            best = torch.argmin(ckey, dim=-1).to(torch.int32)
            has = torch.any(cand, dim=-1)
            assigned = torch.where(has, best, -1).to(torch.int32)
            rejected = rejected | (cand & (col != best[..., None]))
            _sweep_done(propose, active, sweeps)
        return assigned, sweeps

    if seed is None:
        assigned, sweeps = run(torch.full((seeds, n_clients), -1,
                                          dtype=torch.int32, device=dev))
    else:
        ok = (seed >= 0) & torch.gather(
            coverage, -1, torch.clamp_min(seed, 0).long()[..., None])[..., 0]
        assigned, sweeps = _warm_then_cold(
            run, ok, seed,
            lambda a: _blocking_pair_dense(a, rank, dist, coverage, quota),
            seeds, n_clients, dev)
    assoc = ((assigned[..., None] == col)
             & (assigned[..., None] >= 0)).to(torch.int32)
    if return_sweeps:
        return assoc, sweeps
    return assoc


def resolve_serial(order: torch.Tensor, dist: torch.Tensor, quota: int,
                   coverage: torch.Tensor, return_sweeps: bool = False):
    """Serial deferred acceptance, one queue pop attempt a step: the
    reference's ``resolve_jax``, step for step (the same bound of
    N·M + M·(N·M + 2) + 2 steps, the same strict (distance, edge index)
    preference of a client), so its matching is bit-identical to
    ``resolve_parallel``'s; only the counter differs.

    order: (M, N) per-edge client indices by descending preference; dist,
    coverage: (N, M).  Returns assoc (N, M) one-hot int32 on ``order``'s
    device; with ``return_sweeps`` also the pop-attempt count (an int).

    Each step is integer bookkeeping with one data-dependent branch, so
    the loop runs on the host over copies of ``order``, ``dist`` and
    ``coverage`` taken once (one device-to-host copy each), not as a
    device launch a step."""
    m_edges, n_clients = order.shape
    ords = order.cpu().tolist()
    dists = dist.float().cpu().tolist()    # float32 values, exact as floats
    cov = coverage.cpu().tolist()
    max_iter = n_clients * m_edges + m_edges * (n_clients * m_edges + 2) + 2
    taken = [-1] * n_clients
    ptr, filled = [0] * m_edges, [0] * m_edges
    m, progress, done, it = 0, False, False, 0
    while not done and it < max_iter:
        can_pop = filled[m] < quota and ptr[m] < n_clients
        c = ords[m][min(ptr[m], n_clients - 1)]
        t = taken[c]
        vacant = t < 0
        here, there = dists[c][m], dists[c][max(t, 0)]
        nearer = here < there or (here == there and m < t)
        admit = can_pop and cov[c][m] and (vacant or (t != m and nearer))
        if can_pop:
            ptr[m] += 1
        if admit:
            taken[c] = m
            filled[m] += 1
            if not vacant:
                filled[t] -= 1
        progress = progress or admit
        m += 1 if (not can_pop) or admit else 0     # the inner loop ends
        if m >= m_edges:                            # a pass ends
            done = not progress
            m, progress = 0, False
        it += 1
    assigned = torch.tensor(taken, dtype=torch.int32, device=order.device)
    col = torch.arange(m_edges, dtype=torch.int32, device=order.device)
    assoc = ((assigned[:, None] == col) & (assigned[:, None] >= 0)) \
        .to(torch.int32)
    return (assoc, it) if return_sweeps else assoc


def _preference(policy: str, scores, gains, uniform):
    if policy == "fcea":
        return scores
    if policy == "gcea":
        return gains
    if policy == "rcea":
        if uniform is None:
            raise ValueError("rcea ranks by a drawn (N, M) uniform: pass "
                             "uniform= (RoundDraws.assoc_u)")
        return uniform
    raise ValueError(f"unknown association policy {policy!r}")


def associate(policy: str, *, scores: torch.Tensor | None,
              gains: torch.Tensor, dist: torch.Tensor, quota: int,
              coverage_radius_m: float, uniform: torch.Tensor | None = None,
              avail: torch.Tensor | None = None,
              return_sweeps: bool = False,
              seed: torch.Tensor | None = None):
    """Dense (N, M) one-hot association for ``policy``: fcea ranks by
    ``scores``, gcea by ``gains``, rcea by ``uniform`` (N, M).  ``avail``
    (N,) is a scenario's availability mask: an unavailable client is out
    of every edge's coverage, so no policy admits it (nor keeps its warm
    ``seed``, see ``resolve_parallel``).  Every argument may carry a
    leading fleet axis S."""
    pref = _preference(policy, scores, gains, uniform)
    if pref.dim() == dist.dim() - 1:
        pref = pref[..., None].expand(dist.shape)
    coverage = dist <= coverage_radius_m
    if avail is not None:
        coverage = coverage & (avail > 0)[..., None]
    pref = torch.where(coverage, pref, -torch.inf)
    # stable: exact preference ties go to the lower client index
    order = torch.argsort(-pref, dim=-2, stable=True).transpose(-1, -2)
    return resolve_parallel(order, dist, quota, coverage,
                            return_sweeps=return_sweeps, seed=seed)


def resolve_candidates(pref: torch.Tensor, cand, quota: int, n_edges: int,
                       return_sweeps: bool = False, seed=None):
    """``resolve_parallel`` over the (N, K) candidate frontier ``cand``.

    One rank order for the whole resolution -- the N·K pairs by (edge asc,
    preference desc, client asc) -- and each sweep's proposals read off one
    segmented cumulative count of the eligible pairs in that order: a
    pair proposes when fewer than its edge's deficit eligible pairs rank
    above it.  Each client keeps the first minimum of the offered slots'
    distances, which the (distance, edge)-sorted rows make the dense
    resolvers' (distance, edge) choice.  With K ≥ the maximum coverage
    degree the sweeps equal the dense resolver's one for one.

    pref: (N, K) preference, higher better (invalid slots may hold
    anything).  Returns assigned (N,) int32 (edge or −1); with
    ``return_sweeps`` also the number of sweeps run.  Over a fleet (pref
    and ``cand`` with a leading axis S) the S·N·K pairs are ranked at once
    by the folded segment key s·M + edge -- each seed's edges their own
    segments, client-major inside them as for one seed -- and the sweeps
    are a list of S, as in ``resolve_parallel``.

    ``seed`` (N,) ((S, N)) warm-starts the sweeps as in
    ``resolve_parallel``: a seed whose edge sits on one of the client's
    valid slots is an initial hold, and ``_blocking_pair_frontier`` gates
    the cold fallback.
    """
    idx, valid, dist = cand.idx, cand.valid, cand.dist
    if idx.dim() == 2:
        assigned, sweeps = resolve_candidates(
            pref[None], type(cand)(*(f[None] for f in cand)), quota,
            n_edges, True, None if seed is None else seed[None])
        return (assigned[0], sweeps[0]) if return_sweeps else assigned[0]
    seeds, n, k = idx.shape
    dev = idx.device
    base = (torch.arange(seeds, device=dev) * n_edges)[:, None]   # (S, 1)
    flat_e = (idx.long() + base[..., None]).reshape(-1)
    flat_s = torch.where(valid, pref, -torch.inf).reshape(-1)
    # invalid pairs (−inf) sort last within their edge, flat (client-major)
    # order breaking every tie
    perm = candidates.lexsort(-flat_s, flat_e)                  # (SNK,)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=dev)
    sorted_e = flat_e[perm]
    seg_start = candidates.segment_starts(sorted_e)
    prev = torch.clamp_min(seg_start - 1, 0)
    col_k = torch.arange(k, device=dev)
    max_sweeps = n * k + 2

    def run(assigned):
        rejected = ~valid
        active, sweeps = [True] * seeds, [0] * seeds
        while any(active) and max(sweeps) < max_sweeps:
            matched = assigned >= 0
            held = (assigned[..., None] == idx) & matched[..., None]
            # per-(seed, edge) held count: an exact int32 scatter-add
            filled = torch.zeros((seeds * n_edges,), dtype=torch.int32,
                                 device=dev)
            filled.index_add_(0, (torch.clamp_min(assigned, 0) + base)
                              .reshape(-1).long(),
                              matched.to(torch.int32).reshape(-1))
            deficit = quota - filled
            elig = valid & (~rejected) & (~held)                # (S, N, K)
            es = elig.reshape(-1)[perm].to(torch.int32)         # rank order
            c = torch.cumsum(es, dim=0)
            before = torch.where(seg_start > 0, c[prev], 0)
            n_better = c - es - before
            prop_sorted = (es > 0) & (n_better < deficit[sorted_e])
            propose = prop_sorted[inv].reshape(seeds, n, k)
            offer = propose | held
            # first minimum over (distance, edge)-sorted slots
            ckey = torch.where(offer, dist, torch.inf)
            best = torch.argmin(ckey, dim=-1)
            has = torch.any(offer, dim=-1)
            assigned = torch.where(
                has, torch.gather(idx, -1, best[..., None])[..., 0], -1
            ).to(torch.int32)
            rejected = rejected | (offer & (col_k != best[..., None]))
            _sweep_done(propose, active, sweeps)
        return assigned, sweeps

    if seed is None:
        assigned, sweeps = run(torch.full((seeds, n), -1, dtype=torch.int32,
                                          device=dev))
    else:
        ok = (seed >= 0) & torch.any((idx == seed[..., None]) & valid,
                                     dim=-1)
        assigned, sweeps = _warm_then_cold(
            run, ok, seed,
            lambda a: _blocking_pair_frontier(a, idx, valid, inv, base,
                                              quota, n_edges),
            seeds, n, dev)
    if return_sweeps:
        return assigned, sweeps
    return assigned


def _blocking_pair_frontier(assigned: torch.Tensor, idx: torch.Tensor,
                            valid: torch.Tensor, inv: torch.Tensor,
                            base: torch.Tensor, quota: int, n_edges: int
                            ) -> torch.Tensor:
    """``_blocking_pair_dense`` on the (S, N, K) frontier: the edge side
    compares pair ranks from the resolver's one rank order ``inv`` (within
    one (seed, edge) segment, at the folded key ``idx + base``), and the
    client side is the slot order itself -- rows are (distance,
    edge)-sorted, so a client strictly prefers slot j to its held slot hj
    iff j < hj."""
    seeds, n, k = idx.shape
    dev = idx.device
    flat_e = (idx.long() + base[..., None]).reshape(-1)
    held = ((assigned[..., None] == idx) & (assigned >= 0)[..., None]
            & valid)
    held_f = held.reshape(-1)
    filled = torch.zeros((seeds * n_edges,), dtype=torch.int32, device=dev)
    filled.index_add_(0, flat_e, held_f.to(torch.int32))
    pair_rank = inv.reshape(seeds, n, k)
    worst = torch.full((seeds * n_edges,), -1, dtype=inv.dtype, device=dev)
    worst.scatter_reduce_(0, flat_e, torch.where(held_f, inv, -1),
                          reduce="amax")
    edge_wants = valid & ~held & (
        ((quota - filled) > 0)[flat_e].reshape(seeds, n, k)
        | (pair_rank < worst[flat_e].reshape(seeds, n, k)))
    col_k = torch.arange(k, device=dev)
    held_slot = torch.amin(torch.where(held, col_k, k), dim=-1)
    client_wants = col_k < held_slot[..., None]                  # (S, N, K)
    return torch.any((edge_wants & client_wants).flatten(1), dim=1)


def associate_candidates(policy: str, *, scores: torch.Tensor | None,
                         gains: torch.Tensor, cand, quota: int, n_edges: int,
                         uniform: torch.Tensor | None = None,
                         return_sweeps: bool = False,
                         seed: torch.Tensor | None = None):
    """Association on the frontier: the compact assigned vector (N,),
    warm-started from ``seed`` when given (``resolve_candidates``).

    ``scores``: fcea competency already on the frontier, (N, K) from
    ``score_candidates``, or per client (N,).  gcea gathers the (N, M)
    gains and rcea the (N, M) ``uniform``, so rcea ranks by the same
    draw as on the dense path.  Every argument may carry a leading fleet
    axis S."""
    if policy == "fcea":
        pref = scores
        if pref.dim() == cand.idx.dim() - 1:
            pref = pref[..., None].expand(cand.idx.shape)
        if pref.shape != cand.idx.shape:
            raise ValueError(
                f"fcea candidate scores must be (N, K) "
                f"{tuple(cand.idx.shape)} (frontier layout), got "
                f"{tuple(pref.shape)}")
    else:
        pref = torch.gather(_preference(policy, scores, gains, uniform), -1,
                            cand.idx.long())
    return resolve_candidates(pref, cand, quota, n_edges,
                              return_sweeps=return_sweeps, seed=seed)

"""Fuzzy-logic client competency scoring (paper §III).

Three normalised inputs in [0, 100] -- channel quality (CQ), data quantity
(DQ), model staleness (MS) -- pass through triangular membership functions
(paper Fig. 4), the 27-rule Mamdani table (paper Table I) with Max–Min
inference, and centre-of-gravity defuzzification (Eq. 22).

``score_rows`` is the vectorised plain pipeline over flat rows -- the CPU
path of the scoring kernel's wrapper (``kernels.hfl_ops.score_rows``) and
the version the kernel is held to on the card.  Its CoG sums run in the
kernel's fixed order g = 0..200, so the two agree bit for bit.
``score_clients`` scores raw per-client criteria end to end through the
kernel's wrapper.
"""
from __future__ import annotations

import numpy as np
import torch

# Fuzzy set indices
POOR, FAIR, AVG, GOOD, EXCELLENT = 0, 1, 2, 3, 4

# Paper Table I: RULES[cq, dq, ms] -> output set index.
RULES = np.array([
    # CQ = weak (rules 19-27)
    [[POOR, POOR, FAIR],        # DQ shortage: MS fresh/medium/stale
     [POOR, FAIR, AVG],         # DQ average
     [FAIR, AVG, GOOD]],        # DQ sufficient
    # CQ = medium (rules 10-18)
    [[POOR, FAIR, AVG],
     [FAIR, AVG, GOOD],
     [AVG, GOOD, EXCELLENT]],
    # CQ = strong (rules 1-9)
    [[FAIR, AVG, GOOD],
     [AVG, GOOD, EXCELLENT],
     [GOOD, EXCELLENT, EXCELLENT]],
], dtype=np.int32)

# Triangular membership (a, b, c): peak at b, support [a, c].
IN_TRIS = np.array([        # the three input sets share one geometry
    [-50.0, 0.0, 50.0],     # weak / shortage / fresh
    [0.0, 50.0, 100.0],     # medium / average / medium
    [50.0, 100.0, 150.0],   # strong / sufficient / stale
], dtype=np.float32)

OUT_TRIS = np.array([
    [-25.0, 0.0, 25.0],     # poor
    [0.0, 25.0, 50.0],      # fair
    [25.0, 50.0, 75.0],     # average
    [50.0, 75.0, 100.0],    # good
    [75.0, 100.0, 125.0],   # excellent
], dtype=np.float32)

# the 201-point CoG grid, i·0.5 -- exact in float32
COG_GRID = (np.arange(201, dtype=np.float32) * np.float32(0.5))


def tri(x: torch.Tensor, abc) -> torch.Tensor:
    """Membership of ``x`` in one (a, b, c) triangle, in float32.

    The widths divide as 0-d tensors on ``x``'s device: CUDA turns a
    division by a Python scalar into a multiply by its reciprocal, which
    is not the IEEE quotient the kernel and the reference compute."""
    a, b, c = (float(v) for v in abc)
    up = (x - a) / x.new_full((), max(b - a, 1e-9))
    down = (c - x) / x.new_full((), max(c - b, 1e-9))
    return torch.clamp(torch.minimum(up, down), 0.0, 1.0)


def _out_memberships() -> np.ndarray:
    """(5, 201) float32 output-set memberships on the CoG grid: ``tri`` in
    host numpy float32 (the same IEEE operations)."""
    f32 = np.float32
    rows = []
    for a, b, c in OUT_TRIS:
        up = (COG_GRID - a) / f32(max(b - a, 1e-9))
        down = (c - COG_GRID) / f32(max(c - b, 1e-9))
        rows.append(np.clip(np.minimum(up, down), f32(0.0), f32(1.0)))
    return np.stack(rows).astype(np.float32)


OUT_MU = _out_memberships()


def normalize(v: torch.Tensor, max_value) -> torch.Tensor:
    """Paper Eq. (21): NV = V / MV × 100%."""
    if isinstance(max_value, torch.Tensor):
        denom = torch.clamp_min(max_value, 1e-12)
    else:
        denom = v.new_full((), max(float(max_value), 1e-12))
    return torch.clamp(v / denom, 0.0, 1.0) * 100.0


def normalized_inputs(gains: torch.Tensor, counts: torch.Tensor,
                      staleness: torch.Tensor, *, data_max: float):
    """The Eq. 21 normalisation: (cq (N, M), dq (N,), ms (N,)) in [0, 100].

    CQ is the per-edge channel quality normalised in dB over the min/max
    of the whole (N, M) gain field; DQ and MS are shared across edges.
    With a leading fleet axis -- gains (S, N, M), counts and staleness
    (S, N) -- the min/max of the gains and the max staleness are each seed's
    own, as under the reference's ``vmap``.
    """
    db = 10.0 * torch.log10(torch.clamp_min(gains, 1e-30))
    lo = torch.amin(db, dim=(-2, -1), keepdim=True)
    hi = torch.amax(db, dim=(-2, -1), keepdim=True)
    cq = normalize(db - lo, torch.clamp_min(hi - lo, 1e-9))
    dq = normalize(counts.float(), data_max)
    ms = normalize(staleness.float(), torch.clamp_min(
        torch.amax(staleness, dim=-1, keepdim=True), 1).float())
    return cq, dq, ms


def score_rows(cq: torch.Tensor, dq: torch.Tensor, ms: torch.Tensor
               ) -> torch.Tensor:
    """(R,) cq/dq/ms -> (R,) NO* scores: memberships, the 27-rule Max–Min
    table folded to 5 output strengths, Mamdani clip + max over the CoG
    grid, centroid."""
    dev = cq.device
    m_cq = [tri(cq, t) for t in IN_TRIS]
    m_dq = [tri(dq, t) for t in IN_TRIS]
    m_ms = [tri(ms, t) for t in IN_TRIS]
    deg = torch.stack([torch.minimum(torch.minimum(m_cq[i], m_dq[j]), m_ms[k])
                       for i in range(3) for j in range(3) for k in range(3)],
                      dim=1)                                     # (R, 27)
    rules = torch.from_numpy(RULES.reshape(-1).astype(np.int64)).to(dev)
    strengths = torch.zeros((cq.shape[0], 5), dtype=torch.float32,
                            device=dev).scatter_reduce(
        1, rules.expand(cq.shape[0], 27), deg, reduce="amax")    # (R, 5)
    mu = torch.from_numpy(OUT_MU).to(dev)                        # (5, G)
    agg = torch.amax(torch.minimum(mu[None], strengths[:, :, None]),
                     dim=1)                                      # (R, G)
    num = torch.zeros_like(cq, dtype=torch.float32)
    den = torch.zeros_like(cq, dtype=torch.float32)
    for g in range(COG_GRID.size):                # the kernel's sum order
        col = agg[:, g]
        num = num + float(COG_GRID[g]) * col
        den = den + col
    return num / torch.clamp_min(den, 1e-9)


def score_matrix(gains: torch.Tensor, counts: torch.Tensor,
                 staleness: torch.Tensor, *, data_max: float,
                 rows=score_rows) -> torch.Tensor:
    """(N, M) competency matrix -- (S, N, M) over a fleet: the Eq. 21
    normalisation, then ``rows`` (the plain pipeline, or the scoring
    kernel's wrapper) over the flattened (client, edge) rows."""
    cq, dq, ms = normalized_inputs(gains, counts, staleness,
                                   data_max=data_max)
    return rows(cq.reshape(-1), dq[..., None].expand(cq.shape).reshape(-1),
                ms[..., None].expand(cq.shape).reshape(-1)
                ).reshape(cq.shape)


def candidate_inputs(gains: torch.Tensor, cand_idx: torch.Tensor,
                     counts: torch.Tensor, staleness: torch.Tensor, *,
                     data_max: float):
    """The N·K frontier rows' (cq, dq, ms), flat (N·K,) -- (S·N·K,) over
    a fleet: the Eq. 21 normalisation over the full (N, M) field (its dB
    min/max), then cq gathered at ``cand_idx`` (N, K) -- so each row
    equals the dense row of the same (client, edge) pair."""
    cq, dq, ms = normalized_inputs(gains, counts, staleness,
                                   data_max=data_max)
    cq_k = torch.gather(cq, -1, cand_idx.long())
    return (cq_k.reshape(-1), dq[..., None].expand(cq_k.shape).reshape(-1),
            ms[..., None].expand(cq_k.shape).reshape(-1))


def score_candidates(gains: torch.Tensor, cand, counts: torch.Tensor,
                     staleness: torch.Tensor, *, data_max: float,
                     rows=score_rows) -> torch.Tensor:
    """(N, K) competency scores on the frontier ``cand``
    (``core.candidates.CandidateSet``): ``rows`` over the N·K rows of
    ``candidate_inputs``; each score equals the dense matrix entry at the
    same pair."""
    return rows(*candidate_inputs(gains, cand.idx, counts, staleness,
                                  data_max=data_max)
                ).reshape(cand.idx.shape)


def score_clients(channel_gain: torch.Tensor, data_quantity: torch.Tensor,
                  staleness: torch.Tensor, *, gain_max, data_max,
                  staleness_max) -> torch.Tensor:
    """End to end: raw per-client criteria (N,) -> NO* scores (N,), each
    normalised by its own maximum (Eq. 21, a float or a 0-d tensor).  The
    rows go through ``kernels.hfl_ops.score_rows``: its kernel on a CUDA
    tensor, ``score_rows`` above on the CPU."""
    from repro_torch.kernels import hfl_ops    # hfl_ops imports this module
    cq = normalize(channel_gain.float(), gain_max)
    dq = normalize(data_quantity.float(), data_max)
    ms = normalize(staleness.float(), staleness_max)
    return hfl_ops.score_rows(cq, dq, ms)

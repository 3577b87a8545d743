"""NOMA uplink model (paper §II-A2): fading, SIC decoding order, SINR, rates.

Clients associated with one edge server transmit on the same channel.  The
receiver decodes in descending received power p_n·|h_{n,m}|², so client
n's interference is the sum of the received powers decoded after it
(Eq. 7); rates follow Shannon (Eq. 8).

The random field of the fading model is an argument: the caller draws the
``Exp(1)`` field (``engine.sample_draws`` from a ``torch.Generator``, or a
test replaying the reference's own draw).
"""
from __future__ import annotations

import torch

from repro_torch.core import candidates


def rayleigh_gains(fading: torch.Tensor, dist_m: torch.Tensor, *,
                   path_loss_exponent: float) -> torch.Tensor:
    """|h|² gains: distance path loss × the unit-mean Rayleigh fading power
    ``fading`` (an ``Exp(1)`` field shaped like ``dist_m``)."""
    pl = torch.clamp_min(dist_m, 1.0) ** (-path_loss_exponent)
    return pl * fading


def evolve_gains(fading: torch.Tensor, gains: torch.Tensor,
                 dist_m: torch.Tensor, *, path_loss_exponent: float,
                 rho: float = 0.9) -> torch.Tensor:
    """First-order Gauss-Markov fading: keeps the channel time-varying."""
    fresh = rayleigh_gains(fading, dist_m,
                           path_loss_exponent=path_loss_exponent)
    return rho * gains + (1.0 - rho) * fresh


def sic_sinr(power_w: torch.Tensor, gain: torch.Tensor, noise_w: float,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-client SINR under SIC (Eq. 7), in the input order.

    power_w, gain: (K,); mask: (K,) bool -- False entries are absent
    clients.  Client i's interference is the received power of every
    strictly weaker client j, an exact tie decoded by the lower index
    first (so the tied j > i interferes with i).
    """
    rx = power_w * gain
    if mask is not None:
        rx = torch.where(mask, rx, 0.0)
    k = rx.shape[-1]
    idx = torch.arange(k, device=rx.device)
    weaker = (rx[None, :] < rx[:, None]) | \
        ((rx[None, :] == rx[:, None]) & (idx[None, :] > idx[:, None]))
    interference = torch.sum(torch.where(weaker, rx[None, :], 0.0), dim=-1)
    sinr = rx / (interference + noise_w)
    if mask is not None:
        sinr = torch.where(mask, sinr, 0.0)
    return sinr


def achievable_rates(power_w: torch.Tensor, gain: torch.Tensor, *,
                     bandwidth_hz: float, noise_w: float,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """Eq. 8: R = B log2(1 + SINR), in bits/s."""
    sinr = sic_sinr(power_w, gain, noise_w, mask)
    return bandwidth_hz * torch.log2(1.0 + sinr)


def sic_rates_assigned(power_w: torch.Tensor, own_gain: torch.Tensor,
                       assigned: torch.Tensor, *, n_edges: int,
                       max_per_edge: int, bandwidth_hz: float,
                       noise_w: float) -> torch.Tensor:
    """SIC rates from the compact association: (N,) power, (N,) gain to
    the assigned edge, (N,) assigned edge (−1 = unmatched) -> (N,) rates
    at each client's own edge, 0.0 for unmatched clients.  With a leading
    fleet axis every argument is (S, N), and so is the result.

    The sorted form of Eqs. 7-8: the clients are sorted by (edge asc,
    received power desc, client asc) -- the pairwise form's decode order
    -- into an (M, k) per-edge decode table (k = ``max_per_edge``, which
    must bound every edge's occupancy), and each client's interference is
    its row's total minus its prefix sum, as in the reference.  No (N, M)
    tensor is touched.  A fleet sorts once, by the folded key
    s·(M + 1) + edge, so each seed keeps its own sentinel segment M and
    fills its own (M, k) table.  That difference cancels in float32:
    where a much stronger client shares the edge, a weak client's rate
    parts from the pairwise form's by up to a few percent (PERF.md).
    """
    lead, n = power_w.shape[:-1], power_w.shape[-1]
    seeds = power_w.numel() // max(n, 1)
    k = min(int(max_per_edge), n)
    dev = power_w.device
    matched = assigned >= 0
    rx = torch.where(matched, power_w * own_gain, 0.0).reshape(-1)
    rows = n_edges + 1                                   # + the sentinel
    seed = torch.arange(seeds, device=dev)[:, None].expand(seeds, n)
    key = (seed * rows + torch.where(matched, assigned, n_edges)
           .reshape(seeds, n)).reshape(-1).long()
    perm = candidates.lexsort(-rx, key)
    sk = key[perm]
    se, ss = sk % rows, sk // rows                       # edge, seed
    pos = torch.arange(sk.shape[0], device=dev) - \
        candidates.segment_starts(sk)
    in_tbl = (se < n_edges) & (pos < k)
    # rows past the table go to their seed's sentinel row M, dropped
    tbl_r = torch.where(in_tbl, sk, ss * rows + n_edges)
    tbl_p = torch.clamp_max(pos, k - 1)
    srx = torch.zeros((seeds * rows, k), dtype=rx.dtype, device=dev)
    srx[tbl_r, tbl_p] = rx[perm]
    srx = srx.reshape(seeds, rows, k)[:, :n_edges]
    csum = _running_sum(srx)
    interference = torch.clamp_min(csum[..., -1:] - csum, 0.0)
    sinr = srx / (interference + noise_w)
    rate = (bandwidth_hz * torch.log2(1.0 + sinr)).reshape(-1, k)
    rate_sorted = torch.where(
        in_tbl, rate[ss * n_edges + torch.clamp_max(se, n_edges - 1),
                     tbl_p], 0.0)
    out = torch.empty_like(rate_sorted)
    out[perm] = rate_sorted
    return torch.where(matched, out.reshape(lead + (n,)), 0.0)


def _running_sum(x: torch.Tensor) -> torch.Tensor:
    """Running sums along the last axis, one float32 add after another, as
    the reference's ``jnp.cumsum`` adds them.  ``torch.cumsum`` on the CPU
    accumulates float32 in float64, and the interference above is a
    difference of these sums, which cancels: its rounding shows."""
    sums = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        sums.append(sums[-1] + x[..., j])
    return torch.stack(sums, dim=-1)


def noise_power_w(noise_dbm_per_hz: float, bandwidth_hz: float) -> float:
    """AWGN power over the band: σ² = N0 · B."""
    return 10.0 ** (noise_dbm_per_hz / 10.0) / 1000.0 * bandwidth_hz

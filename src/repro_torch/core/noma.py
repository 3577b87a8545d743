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


def noise_power_w(noise_dbm_per_hz: float, bandwidth_hz: float) -> float:
    """AWGN power over the band: σ² = N0 · B."""
    return 10.0 ** (noise_dbm_per_hz / 10.0) / 1000.0 * bandwidth_hz

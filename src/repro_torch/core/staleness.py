"""Model staleness tracking (paper Eq. 20) and the buffered engine's
update weighting.

A_n^i = A_n^{i-1} + 1 if client n was not orchestrated at round i-1, else
1, saturating at ``STALENESS_MAX`` as in the reference.
"""
from __future__ import annotations

import torch

STALENESS_MAX = 1 << 20


def update_staleness(staleness: torch.Tensor, selected: torch.Tensor
                     ) -> torch.Tensor:
    """staleness (N,) int32; selected (N,) bool -- selected reset to 1."""
    return torch.where(selected, 1, torch.clamp_max(staleness + 1,
                                                    STALENESS_MAX)
                       ).to(torch.int32)


def init_staleness(n_clients: int, device: torch.device) -> torch.Tensor:
    return torch.ones((n_clients,), dtype=torch.int32, device=device)


def buffer_age(version: torch.Tensor, pulled_version: torch.Tensor
               ) -> torch.Tensor:
    """FedBuff update age: the cloud aggregations between a client's pull
    and its update landing, plus 1 (a fresh update has age 1), saturating
    at ``STALENESS_MAX``."""
    age = torch.clamp_min(version - pulled_version, 0) + 1
    return torch.clamp_max(age, STALENESS_MAX).to(torch.int32)


def buffer_weight(age: torch.Tensor) -> torch.Tensor:
    """FedBuff's polynomial staleness discount w(a) = a^(-1/2), in (0, 1]
    for a >= 1 (the reference's default exponent), with the exponent a
    float32 tensor as the reference's ``jnp.float32`` (a Python exponent
    would take torch's rsqrt path), filled on the device (``torch.tensor``
    would be a blocking copy)."""
    a = torch.clamp_min(age.to(torch.float32), 1.0)
    return a ** a.new_full((), -0.5)

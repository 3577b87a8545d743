"""Model staleness tracking (paper Eq. 20).

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

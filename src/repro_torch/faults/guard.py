"""The update quarantine, the last gate before aggregation (the
reference's ``repro.faults.guard``).

Every client delta that reaches ``buffer_accumulate`` or the sync cloud
epilogue first passes ``quarantine``: a finite delta whose global L2 norm
exceeds the clip is rescaled onto the clip sphere, and a delta with any
non-finite element is zeroed and its client masked out of the merge.

Zeroing is a ``torch.where`` before any product: the aggregations are
weighted sums, and 0 · NaN is NaN, so a poisoned row left in place would
reach the sum even at zero weight.  Callers must use the cleaned tree.

Deltas are dicts of leaves (…, N, …) over a ``produced`` mask (…, N): a
fleet's seed axis leads.  The norm sums the leaves in sorted key order
(b1, b2, b3, w1, w2, w3), the order the reference's pytree flattening
gives a dict, so the clip scale rounds as the reference's does.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


def _rows(leaf: torch.Tensor, lead: int) -> torch.Tensor:
    return leaf.reshape(leaf.shape[:lead] + (-1,))


def delta_norms(deltas: Params, lead: int = 1) -> torch.Tensor:
    """(…, N) global L2 norm of each client's delta across all leaves;
    ``lead`` counts the leading axes of the mask (N's included)."""
    sq = None
    for k in sorted(deltas):
        s = torch.sum(_rows(deltas[k], lead) ** 2, dim=-1)
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def delta_finite(deltas: Params, lead: int = 1) -> torch.Tensor:
    """(…, N) bool: every element of the client's delta is finite."""
    fin = None
    for k in sorted(deltas):
        f = torch.all(torch.isfinite(_rows(deltas[k], lead)), dim=-1)
        fin = f if fin is None else fin & f
    return fin


def quarantine(deltas: Params, produced: torch.Tensor, clip: float
               ) -> Tuple[Params, torch.Tensor, torch.Tensor]:
    """Clip finite deltas to ``clip`` and zero non-finite ones.

    Returns ``(deltas', ok, n_rejected)``: ``ok`` (…, N) the ``produced``
    clients whose delta survived (the rejected ones must also leave the
    merge weights) and ``n_rejected`` (…) int32 the produced deltas
    rejected."""
    lead = produced.dim()
    finite = delta_finite(deltas, lead)
    norms = delta_norms(deltas, lead)
    one = torch.ones((), dtype=norms.dtype, device=norms.device)
    # a non-finite norm would poison the scale; its row is zeroed anyway
    safe_norm = torch.where(finite, norms, one)
    scale = torch.clamp_max(
        torch.full((), clip, dtype=norms.dtype, device=norms.device)
        / torch.clamp_min(safe_norm, 1e-30), 1.0)
    keep = (finite & produced).to(norms.dtype) * scale
    clean = {}
    for k, leaf in deltas.items():
        kc = keep.reshape(keep.shape + (1,) * (leaf.dim() - lead))
        # select first, then multiply: 0 · NaN never forms
        clean[k] = torch.where(torch.isfinite(leaf), leaf, 0.0) * kc
    ok = produced & finite
    n_rejected = torch.sum(produced & ~finite, dim=-1, dtype=torch.int32)
    return clean, ok, n_rejected

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

On the engine's client axis a rank holds rows [lo, lo + R) of the N-row
stack; ``rows=(n, lo)`` says so, and each leaf's row sums then run inside
a zero-padded n-row stack: a reduction's order on the card follows its
shape, so a row's norm rounds as it does in the whole stack.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


def _rows(leaf: torch.Tensor, lead: int) -> torch.Tensor:
    return leaf.reshape(leaf.shape[:lead] + (-1,))


def _within(leaf: torch.Tensor, lead: int, n: int, lo: int) -> torch.Tensor:
    """``leaf``'s R rows (axis ``lead - 1``) at rows [lo, lo + R) of an
    n-row stack of zeros."""
    shape = leaf.shape[:lead - 1] + (n,) + leaf.shape[lead:]
    out = leaf.new_zeros(shape)
    out.narrow(lead - 1, lo, leaf.shape[lead - 1]).copy_(leaf)
    return out


def delta_norms(deltas: Params, lead: int = 1,
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(…, N) global L2 norm of each client's delta across all leaves;
    ``lead`` counts the leading axes of the mask (N's included).
    ``rows=(n, lo)``: the deltas are rows [lo, lo + R) of an n-row stack,
    each leaf's sums taken inside it (one leaf's stack at a time)."""
    sq = None
    for k in sorted(deltas):
        leaf = deltas[k]
        if rows is None:
            s = torch.sum(_rows(leaf, lead) ** 2, dim=-1)
        else:
            s = torch.sum(_rows(_within(leaf, lead, *rows), lead) ** 2,
                          dim=-1).narrow(-1, rows[1], leaf.shape[lead - 1])
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def delta_finite(deltas: Params, lead: int = 1) -> torch.Tensor:
    """(…, N) bool: every element of the client's delta is finite."""
    fin = None
    for k in sorted(deltas):
        f = torch.all(torch.isfinite(_rows(deltas[k], lead)), dim=-1)
        fin = f if fin is None else fin & f
    return fin


def quarantine(deltas: Params, produced: torch.Tensor, clip: float,
               rows: Optional[Tuple[int, int]] = None
               ) -> Tuple[Params, torch.Tensor, torch.Tensor]:
    """Clip finite deltas to ``clip`` and zero non-finite ones.

    Returns ``(deltas', ok, n_rejected)``: ``ok`` (…, N) the ``produced``
    clients whose delta survived (the rejected ones must also leave the
    merge weights) and ``n_rejected`` (…) int32 the produced deltas
    rejected.  ``rows``: a client-axis share, as ``delta_norms`` takes
    it (``produced`` then holds the share's R rows)."""
    lead = produced.dim()
    finite = delta_finite(deltas, lead)
    norms = delta_norms(deltas, lead, rows)
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

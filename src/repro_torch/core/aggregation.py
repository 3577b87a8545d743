"""Hierarchical model aggregation (paper Eqs. 11, 17).

Client models live stacked along a leading client (or lane) axis, so edge
aggregation is a data-weighted reduction over association groups and the
semi-synchronous cloud aggregation a masked reduction over edges.  Params
are dicts of float32 tensors.
"""
from __future__ import annotations

from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


def _col(w: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """(…, L) weights shaped to broadcast over an (…, L, ...) leaf."""
    return w.reshape(w.shape + (1,) * (leaf.dim() - w.dim())).to(leaf.dtype)


def weighted_mean(stacked: Params, weights: torch.Tensor) -> Params:
    """Σ w_i · leaf_i / Σ w_i over the stacked axis: weights (L,) over
    leaves (L, ...), or (S, L) over (S, L, ...) for a fleet."""
    ax = weights.dim() - 1
    total = torch.clamp_min(torch.sum(weights, dim=-1), 1e-12)
    out = {}
    for k, leaf in stacked.items():
        agg = torch.sum(leaf * _col(weights, leaf), dim=ax)
        out[k] = agg / _col(total, agg)
    return out


def edge_aggregate(client_params: Params, assoc: torch.Tensor,
                   n_samples: torch.Tensor) -> Params:
    """Eq. 11 for every edge at once: leaves (N, ...), assoc (N, M),
    n_samples (N,) -> leaves (M, ...), each edge's data-weighted average.
    Over a fleet each argument has a leading axis S."""
    lead = assoc.dim() - 2
    w = assoc * n_samples[..., None]                   # (N, M)
    denom = torch.clamp_min(torch.sum(w, dim=-2), 1e-12)
    out = {}
    for k, leaf in client_params.items():
        flat = leaf.reshape(leaf.shape[:lead + 1] + (-1,))
        agg = (w.to(leaf.dtype).transpose(-1, -2) @ flat).reshape(
            w.shape[:lead] + (w.shape[-1],) + leaf.shape[lead + 1:])
        out[k] = agg / _col(denom, agg)
    return out


def cloud_aggregate(edge_params: Params, z: torch.Tensor,
                    edge_data: torch.Tensor) -> Params:
    """Eq. 17: semi-synchronous masked aggregation over edges."""
    return weighted_mean(edge_params, z * edge_data)


def faulted_cloud_aggregate(global_params: Params, client_deltas: Params,
                            assoc_eff: torch.Tensor, n_samples: torch.Tensor,
                            z: torch.Tensor) -> Params:
    """The sync round's cloud epilogue under faults, in delta space: Eq. 11
    over the guard-cleaned client deltas (leaves (S, N, ...)) of the
    surviving clients (``assoc_eff`` (S, N, M), the association masked to
    them), Eq. 17 over the selected edges that kept data (``z_eff``), and
    the global model plus that mean delta.  A seed with no surviving data
    on a selected edge keeps its global model bit for bit."""
    edge_delta = edge_aggregate(client_deltas, assoc_eff, n_samples)
    edge_data = torch.sum(assoc_eff * n_samples[..., None], dim=-2)  # (S, M)
    z_eff = z * (edge_data > 0).to(z.dtype)
    agg = cloud_aggregate(edge_delta, z_eff, edge_data)
    has_data = torch.sum(z_eff * edge_data, dim=-1) > 0              # (S,)
    return {k: torch.where(_col(has_data, g).bool(), g + agg[k].to(g.dtype),
                           g)
            for k, g in global_params.items()}


def broadcast_to_clients(assoc: torch.Tensor, edge_params: Params,
                         client_params: Params) -> Params:
    """Edge model broadcast: associated clients adopt their edge's model,
    the others keep their own params.  Over a fleet each argument has a
    leading axis S."""
    lead = assoc.dim() - 2
    is_assoc = torch.sum(assoc, dim=-1) > 0            # (N,)
    out = {}
    for k, edge_leaf in edge_params.items():
        flat = edge_leaf.reshape(edge_leaf.shape[:lead + 1] + (-1,))
        from_edge = (assoc.to(edge_leaf.dtype) @ flat).reshape(
            assoc.shape[:-1] + edge_leaf.shape[lead + 1:])
        out[k] = torch.where(_col(is_assoc, from_edge).bool(), from_edge,
                             client_params[k])
    return out


def replicate(params: Params, n: int, lead: int = 0) -> Params:
    """Tile a single model into a stacked (n, ...) dict (a copy); with
    ``lead`` leading fleet axes, (S, ...) leaves become (S, n, ...)."""
    return {k: leaf.unsqueeze(lead).expand(
        leaf.shape[:lead] + (n,) + leaf.shape[lead:]).clone()
        for k, leaf in params.items()}


def buffer_zeros(params: Params) -> Params:
    """A zeroed delta accumulator shaped like ``params``."""
    return {k: torch.zeros_like(v) for k, v in params.items()}


def buffer_accumulate(delta_sum: Params, weight_sum: torch.Tensor,
                      deltas: Params, weights: torch.Tensor):
    """Fold per-client deltas into the buffer: deltas leaves (S, N, ...),
    weights (S, N) (zero for a client that did not land), delta_sum
    leaves (S, ...), weight_sum (S,).  Returns (delta_sum', weight_sum')."""
    out = {k: acc + torch.sum(deltas[k] * _col(weights, deltas[k]), dim=1)
           for k, acc in delta_sum.items()}
    return out, weight_sum + torch.sum(weights, dim=-1)


def buffer_apply(global_params: Params, delta_sum: Params,
                 weight_sum: torch.Tensor, apply_mask: torch.Tensor,
                 lr: float = 1.0) -> Params:
    """The merge: global + lr · Σw·Δ / Σw, rounded as the reference's
    ``g + lr * d / denom`` (the product first, ``lr`` in the leaf's
    dtype), for each seed whose ``apply_mask`` (S,) is set and whose
    buffer is not empty, else its global model unchanged.  The division
    makes the effective weights w_n / Σw sum to 1; at ``lr`` 1 the
    product is exact, so the merge is bit-equal to global + Σw·Δ / Σw."""
    ok = apply_mask & (weight_sum > 0)
    denom = torch.clamp_min(weight_sum, 1e-12)
    out = {}
    for k, g in global_params.items():
        d = delta_sum[k]
        out[k] = torch.where(_col(ok, g).bool(),
                             g + (d * lr) / _col(denom, d), g)
    return out

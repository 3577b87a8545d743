"""Mixture-of-experts FFN with grouped, capacity-based routing.

The port of the reference's ``models/moe.py``.  Tokens are routed within
groups of ``MOE_GROUP`` tokens; each expert takes at most ``capacity``
(token, choice) pairs of a group, filled in token-major, choice-minor
order, and the pairs past it are dropped (their gate zeroed).  The
reference writes dispatch and combine as one-hot einsums over a
(G, g, E, C) tensor; here they are an index scatter into the (E, G·C, d)
expert buffer and a gather back -- the same function, since each buffer
slot holds at most one (token, choice) and dispatch is 0 or 1.  The expert
products are batched matrix products over the expert axis (the reference
leaves them to XLA too: it has no Pallas kernel for MoE).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers

MOE_GROUP = 512  # tokens per routing group


class MoE(nn.Module):
    """``router`` (d, E) -- float32 whatever ``param_dtype`` --, then
    ``w_gate``, ``w_in`` (E, d, ff) and ``w_out`` (E, ff, d) in
    ``param_dtype``, drawn in that order as the reference's ``moe_init``
    splits its key, when a generator is given."""

    def __init__(self, cfg, *, device, generator: Optional[torch.Generator]):
        super().__init__()
        d, ff, e, dt = cfg.d_model, cfg.moe_d_ff, cfg.moe_experts, \
            cfg.param_dtype
        for name, shape, dtype, fan_in in (
                ("router", (d, e), torch.float32, d),
                ("w_gate", (e, d, ff), dt, d),
                ("w_in", (e, d, ff), dt, d),
                ("w_out", (e, ff, d), dt, ff)):
            self.register_parameter(name, layers.param(
                shape, dtype, device, generator,
                lambda shape=shape, dtype=dtype, fan_in=fan_in:
                    layers.scaled_init(shape, generator, dtype,
                                       fan_in=fan_in)))

    def forward(self, x: torch.Tensor, cfg
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe_apply(self, x, cfg)


def capacity(group: int, experts: int, top_k: int, factor: float) -> int:
    """Slots an expert has in a group: group·top_k·factor / experts, at
    least 4, rounded up to a multiple of 4."""
    cap = int(group * top_k * factor / experts)
    cap = max(cap, 4)
    return cap + (-cap) % 4


def router_probs(router: torch.Tensor, x: torch.Tensor, top_k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (G, g, d) -> gate (G, g, k) float32, expert index (G, g, k) int64,
    the Switch load-balancing aux (a 0-d float32): fp32 logits, softmax,
    the top k (ties to the lower expert, as ``lax.top_k``: a stable sort,
    the same on the card and the CPU), gates renormalised to sum 1."""
    logits = torch.einsum("gsd,de->gse", x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[..., :top_k], idx[..., :top_k]
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    e = logits.shape[-1]
    me = probs.mean(dim=(0, 1))                                 # router prob
    ce = F.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))     # top-1 load
    return gate, idx, e * torch.sum(me * ce)


class Routing(NamedTuple):
    """Where each (token, choice) of the groups goes: all (G, g, k)."""
    gate: torch.Tensor      # float32, zero where dropped
    idx: torch.Tensor       # the expert
    pos: torch.Tensor       # its slot in the expert's buffer (may be >= cap)
    keep: torch.Tensor      # pos < capacity
    capacity: int
    aux: torch.Tensor


def route(router: torch.Tensor, x: torch.Tensor, cfg) -> Routing:
    """x (B, S, d) routed in groups of ``min(MOE_GROUP, B·S)`` tokens; a
    token count that the group does not divide raises, as the reference
    asserts."""
    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    tokens = b * s
    g = min(MOE_GROUP, tokens)
    if tokens % g:
        raise ValueError(f"MoE: {tokens} tokens are not a multiple of the "
                         f"routing group of {g}")
    cap = capacity(g, e, k, cfg.moe_capacity_factor)
    gate, idx, aux = router_probs(router, x.reshape(tokens // g, g, d), k)
    # each (token, choice)'s place in its expert's buffer: the count of
    # earlier pairs of the group routed to that expert, token-major
    flat = idx.reshape(tokens // g, g * k)
    onehot = F.one_hot(flat, e)
    before = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.gather(before, 2, flat[..., None])[..., 0].reshape(idx.shape)
    keep = pos < cap
    return Routing(gate * keep, idx, pos, keep, cap, aux)


def moe_apply(p: MoE, x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d) in x's dtype, aux 0-d float32).  A kept
    pair with a gate of exactly 0 is not dispatched, as the reference's
    ``dispatch = combine > 0``; the combine weights are cast to x's dtype
    before the product, as the reference's."""
    b, s, d = x.shape
    dt = x.dtype
    r = route(p.router, x, cfg)
    n_groups, g, k = r.idx.shape
    e, cap = cfg.moe_experts, r.capacity
    # slot of each (token, choice) in the (E, G, C) buffer, flattened; the
    # pairs not sent write to one spare row past it (no host sync to count
    # them), which is dropped
    group = torch.arange(n_groups, device=x.device)[:, None, None]
    slot = (r.idx * n_groups + group) * cap + r.pos
    send = r.keep & (r.gate > 0)
    spare = e * n_groups * cap
    xe = x.new_zeros((spare + 1, d))
    xe[torch.where(send, slot, spare).reshape(-1)] = \
        x.reshape(n_groups * g, 1, d).expand(-1, k, -1).reshape(-1, d)
    xe = xe[:spare].reshape(e, n_groups * cap, d)
    hg = torch.bmm(xe, p.w_gate.to(dt))
    hi = torch.bmm(xe, p.w_in.to(dt))
    ye = torch.bmm(F.silu(hg) * hi, p.w_out.to(dt)).reshape(-1, d)
    # combine: the choices' gates (cast to x's dtype) times their experts'
    # outputs, summed in float32 and rounded once, as one product would
    picked = ye[torch.where(send, slot, 0).reshape(-1)].reshape(
        n_groups, g, k, d)
    terms = r.gate.to(dt).float()[..., None] * picked.float()
    y = torch.where(send[..., None], terms, 0.0).sum(dim=2).to(dt)
    return y.reshape(b, s, d), r.aux

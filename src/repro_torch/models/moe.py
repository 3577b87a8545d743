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

Across a ``launch.mesh.Mesh2D``: the router has no partition rule, so it
is whole on every rank, and every rank routes every token of the whole
batch -- each data rank's router logits (tokens x E, float32) are
gathered over ``data`` -- with the same bits (every rank holds the same
x: the collectives before leave identical bits on each), so the routing,
the dropped pairs and the aux are the unsharded model's.  On the model
axis, where W divides E (``_MOE_RULES``), rank r holds experts [r·E/W,
(r+1)·E/W) of ``w_gate``, ``w_in`` and ``w_out`` and dispatches only the
pairs sent to them; otherwise (the rule's chain falls to ``moe_d_ff``: the
reference's expert-tensor hybrid) it holds its ``moe_d_ff`` block of
every expert and its outputs are partial sums.  Either way a rank
combines its terms in float32 and the sum over ``model`` is rounded once
to x's dtype, as the unsharded combine rounds once.  A rank's expert
buffer holds the routing groups its own tokens fall in.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers, parallel

MOE_GROUP = 512  # tokens per routing group


class MoE(nn.Module):
    """``router`` (d, E) -- float32 whatever ``param_dtype`` --, then
    ``w_gate``, ``w_in`` (E, d, ff) and ``w_out`` (E, ff, d) in
    ``param_dtype``, drawn in that order as the reference's ``moe_init``
    splits its key, when a generator is given."""

    def __init__(self, cfg, *, device, generator: Optional[torch.Generator],
                 mesh=None):
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
                                       fan_in=fan_in),
                name=name, mesh=mesh))
        self.mesh = mesh if parallel.active(mesh) else None
        # the model axis's split of the experts: (0, lo, hi) experts
        # [lo, hi), (2, lo, hi) moe_d_ff [lo, hi), or (None, 0, 0) whole
        self.split = parallel.local_block("w_in", (e, d, ff), mesh)

    def forward(self, x: torch.Tensor, cfg, batch: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, S, d): the rows this rank serves of a batch of ``batch``
        rows (default B: the whole batch)."""
        return moe_apply(self, x, cfg, batch)


def capacity(group: int, experts: int, top_k: int, factor: float) -> int:
    """Slots an expert has in a group: group·top_k·factor / experts, at
    least 4, rounded up to a multiple of 4."""
    cap = int(group * top_k * factor / experts)
    cap = max(cap, 4)
    return cap + (-cap) % 4


def router_probs(logits: torch.Tensor, top_k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router's fp32 logits (G, g, E) -> gate (G, g, k) float32, expert
    index (G, g, k) int64, the Switch load-balancing aux (a 0-d float32):
    softmax, the top k (ties to the lower expert, as ``lax.top_k``: a
    stable sort, the same on the card and the CPU), gates renormalised to
    sum 1."""
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


def route(router: torch.Tensor, x: torch.Tensor, cfg, mesh=None,
          batch: Optional[int] = None) -> Routing:
    """The routing of a batch of ``batch`` rows (default: x's B) in groups
    of ``min(MOE_GROUP, batch·S)`` tokens, from x (B, S, d): the whole
    batch, or on a mesh this rank's rows of it, whose router logits are
    gathered over ``data`` where it splits the batch -- the same routing
    on every rank.  A token count that the group does not divide raises,
    as the reference asserts."""
    b, s, _ = x.shape
    batch = b if batch is None else batch
    e, k = cfg.moe_experts, cfg.moe_top_k
    tokens = batch * s
    g = min(MOE_GROUP, tokens)
    if tokens % g:
        raise ValueError(f"MoE: {tokens} tokens are not a multiple of the "
                         f"routing group of {g}")
    cap = capacity(g, e, k, cfg.moe_capacity_factor)
    logits = torch.einsum("bsd,de->bse", x.float(), router.float())
    logits = parallel.unrows(mesh, logits, batch)
    gate, idx, aux = router_probs(logits.reshape(tokens // g, g, e), k)
    # each (token, choice)'s place in its expert's buffer: the count of
    # earlier pairs of the group routed to that expert, token-major
    flat = idx.reshape(tokens // g, g * k)
    onehot = F.one_hot(flat, e)
    before = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.gather(before, 2, flat[..., None])[..., 0].reshape(idx.shape)
    keep = pos < cap
    return Routing(gate * keep, idx, pos, keep, cap, aux)


def moe_apply(p: MoE, x: torch.Tensor, cfg, batch: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d), the rows this rank serves of a batch of ``batch`` rows
    (default B: the whole batch) -> (y (B, S, d) in x's dtype, the whole
    batch's aux, 0-d float32).  The whole batch is routed (``route``); the
    pairs of x's tokens sent to this rank's experts (every expert without
    a mesh, or split over ``moe_d_ff``) are dispatched into a buffer of
    the routing groups those tokens fall in.  A kept pair with a gate of
    exactly 0 is not dispatched, as the reference's ``dispatch = combine >
    0``; the combine weights are cast to x's dtype before the product, as
    the reference's; the gated terms are summed in float32, over
    ``model`` too on a mesh, and rounded once to x's dtype."""
    mesh = p.mesh
    b, s, d = x.shape
    dt = x.dtype
    batch = b if batch is None else batch
    lo, hi = parallel.data_rows(mesh, batch)
    if hi - lo != b:
        raise ValueError(f"MoE: {b} rows are not this rank's rows of a "
                         f"batch of {batch}")
    r = route(p.router, x, cfg, mesh, batch)
    _, g, k = r.idx.shape
    cap = r.capacity
    # x's tokens, [lo·S, hi·S) of the whole batch's, and the routing
    # groups they fall in
    t0, t1 = lo * s, hi * s
    g0 = t0 // g
    n_local = (t1 - 1) // g + 1 - g0
    tok = torch.arange(t0, t1, device=x.device)
    idx = r.idx.reshape(-1, k)[t0:t1]
    pos = r.pos.reshape(-1, k)[t0:t1]
    gate = r.gate.reshape(-1, k)[t0:t1]
    send = (r.keep & (r.gate > 0)).reshape(-1, k)[t0:t1]
    dim, e_lo, e_hi = p.split
    n_exp = cfg.moe_experts
    if dim == 0:                       # expert-parallel: experts [lo, hi)
        send = send & (idx >= e_lo) & (idx < e_hi)
        idx = idx - e_lo
        n_exp = e_hi - e_lo
    # slot of each (token, choice) in the (E, G, C) buffer, flattened; the
    # pairs not sent write to one spare row past it (no host sync to count
    # them), which is dropped
    slot = (idx * n_local + (tok // g - g0)[:, None]) * cap + pos
    spare = n_exp * n_local * cap
    xe = x.new_zeros((spare + 1, d))
    xe[torch.where(send, slot, spare).reshape(-1)] = \
        x.reshape(-1, 1, d).expand(-1, k, -1).reshape(-1, d)
    xe = xe[:spare].reshape(n_exp, n_local * cap, d)
    hg = torch.bmm(xe, p.w_gate.to(dt))
    hi_ = torch.bmm(xe, p.w_in.to(dt))
    ye = torch.bmm(F.silu(hg) * hi_, p.w_out.to(dt)).reshape(-1, d)
    # combine: the choices' gates (cast to x's dtype) times their experts'
    # outputs, summed in float32 and rounded once, as one product would
    picked = ye[torch.where(send, slot, 0).reshape(-1)].reshape(-1, k, d)
    terms = gate.to(dt).float()[..., None] * picked.float()
    y = torch.where(send[..., None], terms, 0.0).sum(dim=1)
    if dim is not None:
        y = parallel.all_reduce(mesh, y, "model")
    return y.to(dt).reshape(b, s, d), r.aux

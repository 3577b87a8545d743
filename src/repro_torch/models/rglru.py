"""Real-Gated Linear Recurrent Unit block (Griffin / RecurrentGemma).

The port of the reference's ``models/rglru.py`` (arXiv:2402.19427):

    r_t = sigmoid(W_a x_t + b_a)            # recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            # input gate
    a_t = a^(c * r_t)   with a = sigmoid(Λ) # per-channel decay, c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t²) * (i_t * x_t)

The full-sequence scan goes through the linear-recurrence kernel
(``kernels.seq_ops.linear_recurrence``); the one-token decode is a plain
update.

On a model axis of W ranks that divides the rnn width ``dr``
(``sharding.rules``: ``w_in``, ``w_gate_branch``, ``conv_w``, ``w_a`` and
``w_x`` split on their last dim, ``w_out`` on its first) rank r holds
channels [r·dr/W, (r+1)·dr/W): its branches and conv run on them; the
conv's output is all-gathered over ``model`` once a call, since ``w_a``
and ``w_x`` contract over every channel; the gates, the recurrence (one
kernel launch) and the state are the rank's channels; ``w_out`` is
row-parallel, its partials summed over ``model``.  ``b_a``, ``b_x``,
``lam`` and ``conv_b`` have no rule: whole, sliced at use.  Where W does
not divide ``dr`` every weight is whole and the layer runs unsharded on
every rank.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import seq_ops
from repro_torch.models import layers, parallel

_C = 8.0  # temperature of the decay exponent (Griffin appendix)
_CONV_WIDTH = 4


class RGLRU(nn.Module):
    """The block's parameters, named as the reference's pytree except Λ
    (``lam``: ``lambda`` is a Python keyword); with a ``mesh``, this
    rank's blocks (the module's docstring)."""

    def __init__(self, cfg, *, device, generator: Optional[torch.Generator],
                 mesh=None):
        super().__init__()
        d = cfg.d_model
        dr = cfg.rnn_width or d
        pd = cfg.param_dtype
        f32 = torch.float32
        shapes = {"w_in": ((d, dr), pd), "w_gate_branch": ((d, dr), pd),
                  "conv_w": ((_CONV_WIDTH, dr), pd), "conv_b": ((dr,), pd),
                  "w_a": ((dr, dr), pd), "b_a": ((dr,), f32),
                  "w_x": ((dr, dr), pd), "b_x": ((dr,), f32),
                  "lam": ((dr,), f32), "w_out": ((dr, d), pd)}

        def draw(name, shape, dtype):
            dev = generator.device
            if name in ("conv_b", "b_a", "b_x"):
                return torch.zeros(shape, dtype=dtype, device=dev)
            if name == "conv_w":
                return layers.normal_init(shape, generator, dtype)
            if name == "lam":
                # a = sigmoid(Λ)^(1/c) uniform in [0.9, 0.999]
                u = torch.rand(shape, generator=generator, device=dev,
                               dtype=f32)
                u = 0.9 + 0.099 * u
                return torch.log(u ** _C / (1.0 - u ** _C))
            return layers.scaled_init(shape, generator, dtype,
                                      fan_in=shape[0])
        for name, (shape, dtype) in shapes.items():
            self.register_parameter(name, layers.param(
                shape, dtype, device, generator,
                lambda name=name, shape=shape, dtype=dtype: draw(
                    name, shape, dtype),
                name=name, mesh=mesh))
        # this rank's channels where the model axis splits dr, else None
        self.channels = parallel.span("w_in", (d, dr), mesh)
        self.mesh = mesh if self.channels is not None else None


def _gates(p: RGLRU, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log_a, gated input), both (..., dr) -- the rank's channels on a
    model axis, whose conv output ``x`` is gathered here -- computed in
    fp32."""
    xs = x if p.mesh is None else parallel.all_gather(p.mesh, x, "model",
                                                      dim=-1)
    xf = x.float()
    xsf = xs.float()
    r = torch.sigmoid(xsf @ p.w_a.float() + parallel.part(p.channels, p.b_a))
    i = torch.sigmoid(xsf @ p.w_x.float() + parallel.part(p.channels, p.b_x))
    # log sigmoid(Λ)^(c·r), softplus as jax.nn.softplus: logaddexp(x, 0)
    lam = parallel.part(p.channels, p.lam)
    softplus = torch.logaddexp(-lam, torch.zeros_like(lam))
    log_a = -_C * r * softplus
    a_sq = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a_sq, min=1e-12)) * (i * xf)
    return log_a, gated


def _causal_conv(p: RGLRU, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of width 4 along axis 1."""
    w = p.conv_w.to(x.dtype)
    pad = torch.zeros((x.shape[0], _CONV_WIDTH - 1, x.shape[-1]),
                      dtype=x.dtype, device=x.device)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, _CONV_WIDTH):
        out = out + xp[:, i:i + s] * w[i]
    return out + parallel.part(p.channels, p.conv_b).to(x.dtype)


def _branches(p: RGLRU, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    dt = x.dtype
    main = x @ p.w_in.to(dt)
    gate_branch = layers.gelu(x @ p.w_gate_branch.to(dt))
    return main, gate_branch


def rglru_block_apply(p: RGLRU, x: torch.Tensor) -> torch.Tensor:
    """Training / prefill forward.  x (B, S, d) -> (B, S, d)."""
    main, gate_branch = _branches(p, x)
    log_a, gated = _gates(p, _causal_conv(p, main))
    h = seq_ops.linear_recurrence(log_a, gated).to(x.dtype)
    return parallel.sum_model(p.mesh, (h * gate_branch) @ p.w_out.to(x.dtype))


def init_cache(cfg, batch: int, device, mesh=None) -> Dict[str, torch.Tensor]:
    """The recurrent state ``h`` (B, dr) and the conv's last 3 inputs
    ``conv`` (B, 3, dr): on a model axis that splits ``dr``, the rank's
    channels (``sharding.cache_spec``'s split of ``h``; of ``conv`` too
    where W does not divide its 3 taps)."""
    dr = cfg.rnn_width or cfg.d_model
    channels = parallel.span("w_in", (cfg.d_model, dr), mesh)
    if channels is not None:
        dr = channels[1] - channels[0]
    return {"h": torch.zeros((batch, dr), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, _CONV_WIDTH - 1, dr),
                                dtype=cfg.compute_dtype, device=device)}


def rglru_block_decode(p: RGLRU, x: torch.Tensor,
                       cache: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step.  x (B, 1, d).  Returns the output and a new cache."""
    dt = x.dtype
    main, gate_branch = _branches(p, x)
    conv_in = torch.cat([cache["conv"].to(dt), main], dim=1)   # (B, W, dr)
    conv_out = torch.einsum("bwr,wr->br", conv_in, p.conv_w.to(dt))[:, None] \
        + parallel.part(p.channels, p.conv_b).to(dt)
    log_a, gated = _gates(p, conv_out)
    h = torch.exp(log_a[:, 0]) * cache["h"] + gated[:, 0]
    y = h[:, None, :].to(dt) * gate_branch
    out = parallel.sum_model(p.mesh, y @ p.w_out.to(dt))
    return out, {"h": h, "conv": conv_in[:, 1:].to(cache["conv"].dtype)}

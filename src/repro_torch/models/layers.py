"""Building blocks of the substrate's models, as plain tensor functions.

The port of the reference's ``models/layers.py``: initialisers drawn from
an explicit ``torch.Generator``, RMSNorm and LayerNorm computed in fp32,
split-half RoPE, the MLP (gated or not, with or without biases) and the
(tied or untied) embedding, and the token-level cross entropy of the
training loss.  Parameters are held by the modules in
``attention``, ``rglru``, ``xlstm``, ``moe``, ``transformer`` and
``encdec``, and by ``Norm`` here (a norm's scale and bias; the
blocks' norms and attention's q/k norms are each one); weights are cast
to the activation dtype at each use, as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------

# the most float32 draws a leaf of another dtype makes at once
DRAW_SLICE = 1 << 26


def normal_init(shape: Sequence[int], generator: torch.Generator,
                dtype: torch.dtype, stddev: float = 0.02) -> torch.Tensor:
    """stddev · N(0, 1), drawn in fp32 on the generator's device.  A leaf
    of another dtype above ``DRAW_SLICE`` elements is drawn in slices
    along its leading axis into the destination dtype, so no fp32 copy of
    it is ever whole (one llama4 expert stack would take 21.5 GB): the
    same distribution, other draws than one whole draw."""
    shape = tuple(shape)
    n = math.prod(shape)
    dev = generator.device
    if dtype == torch.float32 or n <= DRAW_SLICE or len(shape) < 2:
        x = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return x.mul_(stddev).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=dev)
    rows = max(1, DRAW_SLICE // (n // shape[0]))
    for i in range(0, shape[0], rows):
        part = out[i:i + rows]
        part.copy_(torch.randn(part.shape, generator=generator, device=dev,
                               dtype=torch.float32).mul_(stddev))
    return out


def scaled_init(shape: Sequence[int], generator: torch.Generator,
                dtype: torch.dtype, fan_in: Optional[int] = None
                ) -> torch.Tensor:
    """N(0, 1) / sqrt(fan_in); fan_in defaults to shape[-2]."""
    if fan_in is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return normal_init(shape, generator, dtype,
                       stddev=1.0 / math.sqrt(max(fan_in, 1)))


def param(shape: Sequence[int], dtype: torch.dtype, device,
          generator: Optional[torch.Generator], init, *,
          name: Optional[str] = None, mesh=None) -> nn.Parameter:
    """A frozen parameter: ``init()`` (on the generator's device) when a
    generator is given, else left unset on ``device`` for a loader.
    Serving builds no graph; ``launch.steps.make_train_step`` turns the
    model's parameters trainable (``requires_grad_``).

    With a ``mesh`` whose model axis splits the weight ``name`` (its rule
    in ``sharding.rules``), the parameter is this rank's block of it, and
    on a training mesh (``parallel.placed(mesh, fsdp=True)``) its data
    rank's block of that along the rule's FSDP dim: the whole leaf drawn
    (the unsharded model's draws), the block kept and the rest freed;
    unset, the block's shape."""
    from repro_torch.models import parallel
    shape = tuple(shape)
    whole = (None, 0, 0)
    model_b, data_b = (parallel.local_block(name, shape, mesh),
                       parallel.data_block(name, shape, mesh)) \
        if name is not None else (whole, whole)
    blocks = [b for b in (model_b, data_b) if b[0] is not None]
    if not blocks:
        w = init() if generator is not None else \
            torch.empty(shape, dtype=dtype, device=device)
    elif generator is not None:
        w = init()
        for dim, lo, hi in blocks:
            w = w.narrow(dim, lo, hi - lo)
        w = w.clone()
    else:
        local = list(shape)
        for dim, lo, hi in blocks:
            local[dim] = hi - lo
        w = torch.empty(tuple(local), dtype=dtype, device=device)
    out = nn.Parameter(w, requires_grad=False)
    # the dims split over `model` and over `data` (FSDP), or None
    out.model_split, out.data_split = model_b[0], data_b[0]
    return out


# ---------------------------------------------------------------------------
# Normalisation, RoPE, MLP, embedding
# ---------------------------------------------------------------------------

def rmsnorm_apply(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm_apply(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """The reference's order in fp32: the mean, then the mean of
    (x - mean)², then rsqrt; scale and bias applied in fp32."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


NORM_KINDS = ("rmsnorm", "layernorm")


def norm_apply(kind: str, scale: torch.Tensor, bias: Optional[torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    """``rmsnorm`` (``bias`` unused, None) or ``layernorm``, each at the
    reference's epsilon."""
    if kind == "rmsnorm":
        return rmsnorm_apply(scale, x)
    if kind == "layernorm":
        return layernorm_apply(scale, bias, x)
    raise ValueError(f"unknown norm kind {kind!r}")


class Norm(nn.Module):
    """``scale`` (d,) -- ones -- and, for LayerNorm, ``bias`` (d,) --
    zeros -- as the reference's ``norm_init``: nothing is drawn, so the
    generator only says that the weights are to be set (on its device);
    ``None`` leaves them for a loader."""

    def __init__(self, kind: str, d: int, dtype: torch.dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        if kind not in NORM_KINDS:
            raise ValueError(f"unknown norm kind {kind!r}")
        self.kind = kind

        def const(fill):
            return param((d,), dtype, device, generator,
                         lambda: torch.full((d,), fill, dtype=dtype,
                                            device=generator.device))
        self.scale = const(1.0)
        self.bias = const(0.0) if kind == "layernorm" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return norm_apply(self.kind, self.scale, self.bias, x)


def rope_freqs(d_head: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies, shape (d_head // 2,)."""
    exponent = torch.arange(0, d_head, 2, dtype=torch.float32,
                            device=device) / d_head
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate ``x`` (..., S, H, Dh) by absolute ``positions`` (S,): the
    first and second halves of each head are the rotated pair."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions.float()[:, None] * freqs            # (S, Dh/2)
    cos = torch.cos(angles)[:, None, :]
    sin = torch.sin(angles)[:, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form, ``jax.nn.gelu``'s default."""
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {"silu": F.silu, "gelu": gelu, "relu": F.relu}


def mlp_apply(w_in: torch.Tensor, w_gate: Optional[torch.Tensor],
              w_out: torch.Tensor, x: torch.Tensor, *,
              activation: str = "silu", b_in: Optional[torch.Tensor] = None,
              b_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """act(x @ w_gate) * (x @ w_in + b_in) @ w_out + b_out, or
    act(x @ w_in + b_in) @ w_out + b_out without a gate, each bias only
    where given (the reference's order); weights cast to x's dtype."""
    act = _ACTIVATIONS[activation]
    dt = x.dtype
    h = x @ w_in.to(dt)
    if b_in is not None:
        h = h + b_in.to(dt)
    h = act(x @ w_gate.to(dt)) * h if w_gate is not None else act(h)
    out = h @ w_out.to(dt)
    return out + b_out.to(dt) if b_out is not None else out


def embed_apply(table: torch.Tensor, tokens: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
    return table[tokens].to(compute_dtype)


def unembed_apply(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (..., d) against the (V, d) table -> (..., V) in x's dtype."""
    return x @ table.to(x.dtype).t()


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's cross entropy in float32: ``logits`` (..., V)'s
    logsumexp minus the label's logit, (...,)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - ll


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean token-level cross entropy: ``logits`` (..., V) in float32,
    logsumexp minus the label's logit, ``labels`` (...,); with ``mask``
    (...,) the masked mean, over at least one token."""
    nll = token_nll(logits, labels)
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)

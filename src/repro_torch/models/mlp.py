"""The paper's MNIST-scale classifier: a 2-hidden-layer ReLU MLP.

Params are a plain dict of float32 tensors over ``PARAM_KEYS`` -- one model
as (D, H)/(H,)/... leaves, or a stack of client models with a leading
client axis, the layout the training kernel and the aggregation take.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

Params = Dict[str, torch.Tensor]

PARAM_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")


def scaled_init(shape, *, generator: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """Normal init scaled by 1/sqrt(fan_in) (fan_in = shape[-2])."""
    stddev = 1.0 / math.sqrt(max(shape[-2], 1))
    return stddev * torch.randn(shape, generator=generator, device=device,
                                dtype=torch.float32)


def init_params(input_dim: int, hidden: int, n_classes: int, *,
                generator: torch.Generator, device: torch.device) -> Params:
    """One model, drawn from ``generator`` (which must live on ``device``)."""
    z = lambda n: torch.zeros((n,), dtype=torch.float32, device=device)
    return {
        "w1": scaled_init((input_dim, hidden), generator=generator,
                          device=device),
        "b1": z(hidden),
        "w2": scaled_init((hidden, hidden), generator=generator,
                          device=device),
        "b2": z(hidden),
        "w3": scaled_init((hidden, n_classes), generator=generator,
                          device=device),
        "b3": z(n_classes),
    }


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """x @ w + b.  A fleet's weights (S, …) apply to its x (S, T, in) a
    seed at a time: a batched product's cuBLAS kernel, and with it the
    order of its sums, depends on the batch's size, so a seed's logits
    would differ from its own single run's in the last bits."""
    if w.dim() == 3:
        return (torch.stack([xs @ ws for xs, ws in zip(x, w)])
                + b[..., None, :])
    return x @ w + b


def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits of one model over x (T, D), or of a fleet's models -- leaves
    with a leading axis S -- each over its own x (S, T, D)."""
    h = torch.relu(_dense(x, params["w1"], params["b1"]))
    h = torch.relu(_dense(h, params["w2"], params["b2"]))
    return _dense(h, params["w3"], params["b3"])


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy as logsumexp minus the label logit -- the
    reference's formulation (``models/layers.py`` there).  A fleet's
    logits (S, T, V) give one mean a seed, each reduced alone: how the
    card splits a reduction over its blocks depends on how many rows it
    reduces, so a seed's loss would differ from its own single run's in
    the last bits."""
    if logits.dim() == 3:
        return torch.stack([softmax_cross_entropy(lg, lb)
                            for lg, lb in zip(logits, labels)])
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - ll, dim=-1)


def loss(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return softmax_cross_entropy(apply(params, x), y)


def accuracy(params: Params, x: torch.Tensor, y: torch.Tensor
             ) -> torch.Tensor:
    pred = torch.argmax(apply(params, x), dim=-1)
    return torch.mean((pred == y.long()).float(), dim=-1)

"""Optimizers on dicts of named tensors, in the init/update style.

The port of the reference's ``optim/optimizers.py``.  Each factory returns
an ``Optimizer`` with

  ``init(params) -> opt_state`` and
  ``update(grads, opt_state, params, step) -> (new_params, new_opt_state)``

where ``params``, ``grads`` and every moment are ``{name: tensor}`` dicts
(a model's ``named_parameters``) and ``step`` is a Python int (or a 0-d
integer tensor).  ``update`` returns new tensors and changes none it was
given; the train step copies them into the model.  The arithmetic is the
reference's, in its order: float32 for every moment update and every step,
moments stored in ``opt_dtype`` (bfloat16 for the ≥300B configs), Adam's
bias correction at ``t = step + 1`` with ``b ** t`` a float32 power (as
JAX computes it, not a float64 one), then ``mhat / (sqrt(vhat) + eps) +
wd · p``, then ``p - eta · upd`` in float32, cast back to the parameter's
dtype.  ``torch.optim.AdamW`` would decay first and place ``eps``
elsewhere, and keeps no bfloat16 moments.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Tuple

import torch

from repro_torch.optim.schedules import constant

Params = Dict[str, torch.Tensor]
Schedule = Callable[[int], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Mapping[str, torch.Tensor]], Dict[str, Params]]
    update: Callable[..., Tuple[Params, Dict[str, Params]]]


def _as_schedule(lr) -> Schedule:
    return lr if callable(lr) else constant(lr)


def _device(params: Mapping[str, torch.Tensor]) -> torch.device:
    return next(iter(params.values())).device


def _scalar(x, device) -> torch.Tensor:
    """A 0-d float32 tensor on ``device``: a Python number is filled there
    (no host-to-device copy); a CPU tensor (a schedule's value) is
    copied."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    total = None
    for leaf in tree.values():
        s = torch.sum(torch.square(leaf.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(tree: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Params:
    """Every leaf times min(1, max_norm / max(norm, 1e-12)), the scale cast
    to the leaf's dtype."""
    norm = global_norm(tree)
    scale = torch.clamp(_scalar(max_norm, norm.device)
                        / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: leaf * scale.to(leaf.dtype) for k, leaf in tree.items()}


def sgd(lr) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return {}

    def update(grads, state, params, step):
        eta = _scalar(sched(step), _device(params))
        new = {k: p - (eta * grads[k].float()).to(p.dtype)
               for k, p in params.items()}
        return new, state

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return {"m": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state, params, step):
        eta = _scalar(sched(step), _device(params))
        m = {k: beta * m_ + grads[k] for k, m_ in state["m"].items()}
        upd = {k: beta * m_ + grads[k] for k, m_ in m.items()} \
            if nesterov else m
        new = {k: p - (eta * upd[k].float()).to(p.dtype)
               for k, p in params.items()}
        return new, {"m": m}

    return Optimizer(init, update)


def _adam_core(lr, b1, b2, eps, weight_decay, opt_dtype) -> Optimizer:
    sched = _as_schedule(lr)
    dt = getattr(torch, opt_dtype)
    f32 = torch.float32

    def init(params):
        return {"m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                      for k, p in params.items()},
                "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                      for k, p in params.items()}}

    def update(grads, state, params, step):
        dev = _device(params)
        eta = _scalar(sched(step), dev)
        t = _scalar(int(step), dev) + 1.0
        # 1 - b ** t in float32; each moment divides by these 0-d tensors
        bc1 = 1.0 - torch.pow(_scalar(b1, dev), t)
        bc2 = 1.0 - torch.pow(_scalar(b2, dev), t)
        new, m, v = {}, {}, {}
        for k, p in params.items():
            g = grads[k].to(f32)
            m[k] = (b1 * state["m"][k].to(f32) + (1 - b1) * g).to(dt)
            v[k] = (b2 * state["v"][k].to(f32)
                    + (1 - b2) * torch.square(g)).to(dt)
            mhat = m[k].to(f32) / bc1
            vhat = v[k].to(f32) / bc2
            upd = mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.to(f32)
            new[k] = (p.to(f32) - eta * upd).to(p.dtype)
        return new, {"m": m, "v": v}

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         opt_dtype: str = "float32") -> Optimizer:
    return _adam_core(lr, b1, b2, eps, 0.0, opt_dtype)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01, opt_dtype: str = "float32"
          ) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay, opt_dtype)

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
elsewhere, and keeps no bfloat16 moments.  Adam and AdamW also have
``update_``, the same arithmetic leaf by leaf in place (the moments in
``opt_state`` and the parameters given), which ``make_train_step`` runs:
no second copy of the weights and moments is ever whole.

On a ``launch.mesh.Mesh2D`` the optimizers run on each rank's blocks (they
are elementwise), the moments placed like the weights; ``global_norm``
and ``clip_by_global_norm`` take the ``mesh`` and count each leaf's
squares once over it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.optim.schedules import constant

Params = Dict[str, torch.Tensor]
Schedule = Callable[[int], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Mapping[str, torch.Tensor]], Dict[str, Params]]
    update: Callable[..., Tuple[Params, Dict[str, Params]]]
    # update_(grads, opt_state, params, step): ``update``'s arithmetic
    # written into ``opt_state`` and ``params`` in place (None: not offered)
    update_: Optional[Callable[..., None]] = None


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


def global_norm(tree: Mapping[str, torch.Tensor], mesh=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares.

    With a ``mesh`` (a ``launch.mesh.Mesh2D``) each leaf is this rank's
    block of a leaf split over the axes its ``model_split``/``data_split``
    tags name (untagged: whole, the same on every rank): a rank adds its
    block's squares where it is the first rank of every axis on which the
    leaf is whole, and the total is summed over ``model``, then over
    ``data`` -- each leaf counted once, and every rank holds the same
    bits."""
    total = None
    if mesh is not None:
        from repro_torch.models.parallel import whole_axes
    for leaf in tree.values():
        if mesh is not None and any(mesh.coords[a]
                                    for a in whole_axes(leaf, mesh)):
            continue
        s = torch.sum(torch.square(leaf.float()))
        total = s if total is None else total + s
    if mesh is not None:
        dev = next(iter(tree.values())).device
        total = torch.zeros((), dtype=torch.float32, device=dev) \
            if total is None else total
        for axis in ("model", "data"):
            total = mesh.all_reduce(total, axis)
    return torch.sqrt(total)


def clip_scale(tree: Mapping[str, torch.Tensor], max_norm: float,
               mesh=None) -> torch.Tensor:
    """min(1, max_norm / max(global_norm, 1e-12)), a 0-d float32."""
    norm = global_norm(tree, mesh)
    return torch.clamp(_scalar(max_norm, norm.device)
                       / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(tree: Mapping[str, torch.Tensor], max_norm: float,
                        mesh=None) -> Params:
    """Every leaf times ``clip_scale`` (cast to the leaf's dtype); ``mesh``
    as ``global_norm`` takes it."""
    scale = clip_scale(tree, max_norm, mesh)
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

    def scalars(params, step):
        dev = _device(params)
        eta = _scalar(sched(step), dev)
        t = _scalar(int(step), dev) + 1.0
        # 1 - b ** t in float32; each moment divides by these 0-d tensors
        bc1 = 1.0 - torch.pow(_scalar(b1, dev), t)
        bc2 = 1.0 - torch.pow(_scalar(b2, dev), t)
        return eta, bc1, bc2

    def leaf(g, m, v, p, eta, bc1, bc2):
        g = g.to(f32)
        m = (b1 * m.to(f32) + (1 - b1) * g).to(dt)
        v = (b2 * v.to(f32) + (1 - b2) * torch.square(g)).to(dt)
        upd = (m.to(f32) / bc1) / (torch.sqrt(v.to(f32) / bc2) + eps)
        if weight_decay:
            upd = upd + weight_decay * p.to(f32)
        return (p.to(f32) - eta * upd).to(p.dtype), m, v

    def update(grads, state, params, step):
        s = scalars(params, step)
        new, m, v = {}, {}, {}
        for k, p in params.items():
            new[k], m[k], v[k] = leaf(grads[k], state["m"][k],
                                      state["v"][k], p, *s)
        return new, {"m": m, "v": v}

    def update_(grads, state, params, step):
        s = scalars(params, step)
        with torch.no_grad():
            for k, p in params.items():
                new, m, v = leaf(grads[k], state["m"][k], state["v"][k], p,
                                 *s)
                p.copy_(new)
                state["m"][k].copy_(m)
                state["v"][k].copy_(v)

    return Optimizer(init, update, update_)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         opt_dtype: str = "float32") -> Optimizer:
    return _adam_core(lr, b1, b2, eps, 0.0, opt_dtype)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01, opt_dtype: str = "float32"
          ) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay, opt_dtype)

"""Learning-rate schedules: functions of an integer step to a 0-d float32
tensor on the CPU, computed in float32 in the reference's order
(``optim/schedules.py``)."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr)


def linear_warmup(lr: float, warmup_steps: int):
    def sched(step):
        frac = torch.minimum(_f32(step) + 1.0, _f32(warmup_steps)) \
            / _f32(max(warmup_steps, 1))
        return lr * frac
    return sched


def cosine_decay(lr: float, decay_steps: int, final_frac: float = 0.1):
    def sched(step):
        t = torch.clamp(_f32(step) / _f32(max(decay_steps, 1)), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * (final_frac + (1.0 - final_frac) * cos)
    return sched


def warmup_cosine(lr: float, warmup_steps: int, decay_steps: int,
                  final_frac: float = 0.1):
    wu = linear_warmup(lr, warmup_steps)
    cd = cosine_decay(lr, decay_steps, final_frac)

    def sched(step):
        return torch.where(_f32(step) < warmup_steps, wu(step),
                           cd(_f32(step) - warmup_steps))
    return sched

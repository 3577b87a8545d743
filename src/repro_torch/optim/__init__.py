"""Optimizers and learning-rate schedules of the port (the reference's
``optim`` package, on dicts of named tensors)."""
from repro_torch.optim.optimizers import (Optimizer, adam, adamw,
                                          clip_by_global_norm, global_norm,
                                          momentum, sgd)
from repro_torch.optim.schedules import (constant, cosine_decay,
                                         linear_warmup, warmup_cosine)

__all__ = ["Optimizer", "sgd", "momentum", "adam", "adamw",
           "clip_by_global_norm", "global_norm", "constant", "cosine_decay",
           "linear_warmup", "warmup_cosine"]

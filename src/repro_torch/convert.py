"""Carry reference state and weights into the port.

``state_from_numpy`` takes the reference's ``RoundState``/``RoundBundle``
leaves as plain numpy arrays -- the caller converts them with
``np.asarray`` and drops the PRNG key and the scenario state -- and builds
the port's ``RoundState``/``RoundBundle`` on ``device``, so both sides can
start from the same params, gains, staleness and data.
``params_from_numpy`` does the same for a substrate model's weights.
"""
from __future__ import annotations

from typing import Any, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core.engine import RoundBundle, RoundState
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Transformer


def _fields(obj: Any) -> Mapping[str, Any]:
    return obj._asdict() if hasattr(obj, "_asdict") else dict(obj)


def state_from_numpy(state_np: Any, bundle_np: Any,
                     device: "str | torch.device" = "cuda"
                     ) -> Tuple[RoundState, RoundBundle]:
    """state_np: a mapping or named tuple with ``global_params`` and
    ``client_params`` (dicts of arrays), ``gains``, ``staleness`` and
    ``round_idx``; bundle_np: one with ``dist``, ``x``, ``y``, ``counts``,
    ``test_x`` and ``test_y``.  Every array is copied onto ``device``."""
    dev = resolve_device(device)
    s, b = _fields(state_np), _fields(bundle_np)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    def i32(a):
        return torch.tensor(np.asarray(a, np.int32), device=dev)

    state = RoundState(
        global_params={k: f32(v) for k, v in s["global_params"].items()},
        client_params={k: f32(v) for k, v in s["client_params"].items()},
        gains=f32(s["gains"]),
        staleness=i32(s["staleness"]),
        round_idx=int(np.asarray(s["round_idx"])))
    bundle = RoundBundle(dist=f32(b["dist"]), x=f32(b["x"]), y=i32(b["y"]),
                         counts=f32(b["counts"]), test_x=f32(b["test_x"]),
                         test_y=i32(b["test_y"]))
    return state, bundle


# the port's parameter names that differ from the reference pytree's keys
_JAX_NAME = {"lam": "lambda"}


def params_from_numpy(params_np: Mapping[str, Any], cfg,
                      device: "str | torch.device" = "cuda") -> Transformer:
    """A ``Transformer`` on ``device`` holding the weights of a reference
    ``Transformer.init`` pytree with numpy leaves: ``embed/embedding``,
    ``final_norm/scale`` and ``stage_<i>/<unit position>/<group>/<name>``
    stacked over the stage's repetitions.  Every parameter of the port is
    filled; a missing key or a shape mismatch raises."""
    model = Transformer(cfg, device=device)
    model.embedding.copy_(torch.tensor(
        np.asarray(params_np["embed"]["embedding"])))
    model.final_norm.scale.copy_(torch.tensor(
        np.asarray(params_np["final_norm"]["scale"])))
    for blk, (stage, r, pos) in zip(model.blocks, model.block_index):
        tree = params_np[stage][pos]
        for name, param in blk.named_parameters():
            group, leaf = name.split(".")
            src = np.asarray(tree[group][_JAX_NAME.get(leaf, leaf)])[r]
            if tuple(src.shape) != tuple(param.shape):
                raise ValueError(f"{stage}/{pos}/{group}/{leaf}[{r}]: shape "
                                 f"{src.shape} != {tuple(param.shape)}")
            param.copy_(torch.tensor(src))
    return model

"""Config registry of the port: ``get_config("<arch-id>")`` -> ArchConfig.

It is the reference's registry: every architecture, ``qwen3-8b-sw4k``
(the sliding-window serving variant) and ``hfl-mnist``, the paper's own
experiment config (a different dataclass: the HFL simulation's, which
builds no model).  ``list_models()`` names the architectures alone.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, InputShape,
                                      TensorSpec, input_specs,
                                      shape_applicable)

_REGISTRY: Dict[str, str] = {
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "qwen1.5-110b": "repro_torch.configs.qwen1_5_110b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "qwen3-8b-sw4k": "repro_torch.configs.qwen3_8b_sw4k",
    "llama4-maverick-400b-a17b":
        "repro_torch.configs.llama4_maverick_400b_a17b",
    "yi-34b": "repro_torch.configs.yi_34b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "hfl-mnist": "repro_torch.configs.hfl_mnist",
}

# the 10 assigned architectures, in the reference's order
ASSIGNED: List[str] = [
    "recurrentgemma-9b", "grok-1-314b", "paligemma-3b", "xlstm-125m",
    "stablelm-1.6b", "qwen1.5-110b", "qwen3-8b",
    "llama4-maverick-400b-a17b", "yi-34b", "whisper-large-v3",
]


def get_config(name: str):
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return importlib.import_module(_REGISTRY[name]).CONFIG


def list_archs() -> List[str]:
    return list(_REGISTRY)


def list_models() -> List[str]:
    """The registry's architectures, in its order: every name but
    ``hfl-mnist``."""
    return [a for a in _REGISTRY if a != "hfl-mnist"]

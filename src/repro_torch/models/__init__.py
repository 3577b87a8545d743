"""Models of the port: the paper's MLP (``mlp``) and the substrate's
decoder (``transformer``)."""
from __future__ import annotations

from typing import Optional

import torch


def build_model(cfg, *, device: "str | torch.device" = "cuda",
                generator: Optional[torch.Generator] = None):
    """The model for an architecture config, with its weights on
    ``device`` (drawn from ``generator``, or left for a loader)."""
    from repro_torch.models.transformer import Transformer

    if cfg.encoder_layers > 0:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            f"(ROADMAP A17)")
    return Transformer(cfg, device=device, generator=generator)

"""Models of the port: the paper's MLP (``mlp``), the substrate's decoder
(``transformer``) and encoder-decoder (``encdec``)."""
from __future__ import annotations

from typing import Optional

import torch


def build_model(cfg, *, device: "str | torch.device" = "cuda",
                generator: Optional[torch.Generator] = None, mesh=None,
                fsdp: bool = False):
    """The model for an architecture config -- an ``EncDecTransformer``
    when it has encoder layers, else a ``Transformer`` -- with its weights
    on ``device`` (drawn from ``generator``, or left for a loader); with a
    ``launch.mesh.Mesh2D``, this rank's blocks of them (with ``fsdp``, the
    training placement: FSDP over ``data`` too)."""
    from repro_torch.models.encdec import EncDecTransformer
    from repro_torch.models.transformer import Transformer

    if cfg.encoder_layers > 0:
        return EncDecTransformer(cfg, device=device, generator=generator,
                                 mesh=mesh, fsdp=fsdp)
    return Transformer(cfg, device=device, generator=generator, mesh=mesh,
                       fsdp=fsdp)

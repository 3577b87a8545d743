"""Serving steps of the substrate: prefill and greedy decode.

The port of the reference's ``launch/steps.py::make_prefill_step`` and
``make_serve_step``.  The model owns its weights, so a step closes over
the model instead of taking a params pytree.  ``make_train_step`` waits
for the training slice (ROADMAP A18).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.models import build_model
from repro_torch.models.encdec import EncDecTransformer
from repro_torch.models.transformer import Transformer

Model = Union[Transformer, EncDecTransformer]


def _model(cfg, model, device, generator) -> Model:
    return model if model is not None else build_model(
        cfg, device=device, generator=generator)


def make_prefill_step(cfg, *, model: Optional[Model] = None,
                      device: "str | torch.device" = "cuda",
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[Callable, Model]:
    """``prefill_step(batch)``: {"tokens": (B, S)[, "embeddings": a VLM's
    prefix (B, P, d), or an encoder-decoder's frames (B, F, d)]} -> the
    last position's logits (B, V), what a server samples from.  Only that
    position is unembedded; the reference slices it from the full
    logits."""
    model = _model(cfg, model, device, generator)

    @torch.no_grad()
    def prefill_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        hidden = model.hidden(batch["tokens"],
                              extra_embeddings=batch.get("embeddings"))
        return model.unembed(hidden[:, -1, :])

    return prefill_step, model


def make_serve_step(cfg, *, model: Optional[Model] = None,
                    device: "str | torch.device" = "cuda",
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[Callable, Model]:
    """``serve_step(token (B, 1), cache, index)`` -> (the greedy next token
    (B, 1) int32, cache): one decode step, with ``prefix_len`` the config's
    ``prefix_tokens`` as the reference's, and an argmax."""
    model = _model(cfg, model, device, generator)
    prefix = cfg.prefix_tokens

    @torch.no_grad()
    def serve_step(token: torch.Tensor, cache: dict, index: int
                   ) -> Tuple[torch.Tensor, dict]:
        logits, cache = model.decode_step(token, cache, index,
                                          prefix_len=prefix)
        next_token = torch.argmax(logits[:, -1, :], dim=-1, keepdim=True)
        return next_token.to(torch.int32), cache

    return serve_step, model

"""Train, prefill and serve steps of the substrate.

The port of the reference's ``launch/steps.py``.  The model owns its
weights, so a step closes over the model instead of taking a params
pytree: ``train_step(opt_state, step, batch) -> (opt_state, step + 1,
metrics)`` updates the model's weights in place, ``prefill_step(batch)``
and ``serve_step(token, cache, index)`` run under ``no_grad``.  Given a
``launch.mesh.Mesh2D`` (``mesh=``) the prefill and serve steps run the
model across its ranks (``models/transformer.py``); every rank takes and
returns the whole batch.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.models import build_model
from repro_torch.models.encdec import EncDecTransformer
from repro_torch.models.transformer import Transformer, loss_fn
from repro_torch.optim import Optimizer, adamw, clip_by_global_norm

Model = Union[Transformer, EncDecTransformer]


def _model(cfg, model, device, generator, mesh=None) -> Model:
    return model if model is not None else build_model(
        cfg, device=device, generator=generator, mesh=mesh)


def model_loss(model: Model, batch: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
    """The training loss of ``batch`` ({"tokens", "labels"} (B, S)
    [, "embeddings": a VLM's prefix or an encoder-decoder's frames]
    [, "loss_mask"]): ``transformer.loss_fn``.  The reference adds the MoE
    aux loss only where the config has experts; without them the aux is
    an exact 0, so the sum is the same."""
    return loss_fn(model, batch)


def loss_and_grads(model: Model, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, Optional[torch.Tensor]]]:
    """``model_loss`` (detached) and its gradient for every named parameter
    (None where the loss does not reach one), the model's weights made
    trainable first.  A model split over a mesh raises: gradients through
    its collectives are not ported yet (ROADMAP A23)."""
    _refuse_mesh(model)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    loss = model_loss(model, batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return loss.detach(), dict(zip(params, grads))


def _refuse_mesh(model: Model) -> None:
    mesh = getattr(model, "mesh", None)
    if mesh is not None:
        raise NotImplementedError(
            f"{model.cfg.name}: training a model split over a "
            f"{mesh.shape['data']} x {mesh.shape['model']} mesh is not "
            f"ported yet (ROADMAP A23)")


def make_train_step(cfg, *, lr: float = 3e-4, grad_clip: float = 1.0,
                    model: Optional[Model] = None,
                    device: "str | torch.device" = "cuda",
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[Callable, Model, Optimizer]:
    """``train_step(opt_state, step, batch) -> (opt_state, step + 1,
    {"loss": 0-d tensor})``, the model it trains (its weights made
    trainable) and the optimizer (``opt.init(dict(model.named_parameters()))``
    gives the first ``opt_state``); ``step`` is a Python int.  One step:
    the loss and gradients (with ``cfg.grad_accum`` > 1, the batch's rows
    cut into that many microbatches in order, their losses and float32
    gradients summed, then divided), ``clip_by_global_norm`` at
    ``grad_clip``, then ``adamw(lr)`` with moments in ``cfg.opt_dtype``,
    whose new weights are copied into the model under ``no_grad``."""
    model = _model(cfg, model, device, generator)
    _refuse_mesh(model)
    model.requires_grad_(True)
    opt = adamw(lr, opt_dtype=cfg.opt_dtype_str)
    params = dict(model.named_parameters())
    micro = cfg.grad_accum

    def grads_of(batch):
        loss, grads = loss_and_grads(model, batch)
        return loss, {k: torch.zeros_like(params[k]) if g is None else g
                      for k, g in grads.items()}

    def train_step(opt_state, step: int, batch: Dict[str, torch.Tensor]):
        if micro > 1:
            rows = batch["tokens"].shape[0]
            if rows % micro:
                raise ValueError(f"{cfg.name}: a batch of {rows} rows does "
                                 f"not split into {micro} microbatches")
            mb = rows // micro
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            for i in range(micro):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                part_loss, part_grads = grads_of(part)
                loss = loss + part_loss
                grads = {k: grads[k] + part_grads[k] for k in grads}
            n = torch.full((), float(micro), device=model.device)
            loss = loss / n
            grads = {k: g / n for k, g in grads.items()}
        else:
            loss, grads = grads_of(batch)
        grads = clip_by_global_norm(grads, grad_clip)
        with torch.no_grad():
            new, opt_state = opt.update(grads, opt_state, params, step)
            for k, p in params.items():
                p.copy_(new[k])
        return opt_state, step + 1, {"loss": loss}

    return train_step, model, opt


def make_prefill_step(cfg, *, model: Optional[Model] = None,
                      device: "str | torch.device" = "cuda",
                      generator: Optional[torch.Generator] = None,
                      mesh=None) -> Tuple[Callable, Model]:
    """``prefill_step(batch)``: {"tokens": (B, S)[, "embeddings": a VLM's
    prefix (B, P, d), or an encoder-decoder's frames (B, F, d)]} -> the
    last position's logits (B, V), what a server samples from.  Only that
    position is unembedded; the reference slices it from the full
    logits.  ``mesh``: build the model across it (unless ``model`` is
    given)."""
    model = _model(cfg, model, device, generator, mesh)

    @torch.no_grad()
    def prefill_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        hidden = model.hidden(batch["tokens"],
                              extra_embeddings=batch.get("embeddings"))
        return model.unembed(hidden[:, -1, :])

    return prefill_step, model


def make_serve_step(cfg, *, model: Optional[Model] = None,
                    device: "str | torch.device" = "cuda",
                    generator: Optional[torch.Generator] = None,
                    mesh=None) -> Tuple[Callable, Model]:
    """``serve_step(token (B, 1), cache, index)`` -> (the greedy next token
    (B, 1) int32, cache): one decode step, with ``prefix_len`` the config's
    ``prefix_tokens`` as the reference's, and an argmax over the whole
    vocabulary (on a mesh, the gathered logits), ties to the lowest index
    as ``jnp.argmax``'s.  ``mesh``: build the model across it (unless
    ``model`` is given)."""
    model = _model(cfg, model, device, generator, mesh)
    prefix = cfg.prefix_tokens

    @torch.no_grad()
    def serve_step(token: torch.Tensor, cache: dict, index: int
                   ) -> Tuple[torch.Tensor, dict]:
        logits, cache = model.decode_step(token, cache, index,
                                          prefix_len=prefix)
        next_token = torch.argmax(logits[:, -1, :], dim=-1, keepdim=True)
        return next_token.to(torch.int32), cache

    return serve_step, model

"""Train, prefill and serve steps of the substrate.

The port of the reference's ``launch/steps.py``.  The model owns its
weights, so a step closes over the model instead of taking a params
pytree: ``train_step(opt_state, step, batch) -> (opt_state, step + 1,
metrics)`` updates the model's weights in place, ``prefill_step(batch)``
and ``serve_step(token, cache, index)`` run under ``no_grad``.  Given a
``launch.mesh.Mesh2D`` (``mesh=``) each step runs the model across its
ranks (``models/transformer.py``): the prefill and serve steps on the
serving placement, the train step on the training one (FSDP over
``data``); every rank takes the whole batch and returns the whole
batch's outputs (the train step: the same loss on every rank).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.models import build_model, parallel
from repro_torch.models.encdec import EncDecTransformer
from repro_torch.models.transformer import Transformer, loss_fn
from repro_torch.optim import Optimizer, adamw
from repro_torch.optim.optimizers import clip_scale

Model = Union[Transformer, EncDecTransformer]


def _model(cfg, model, device, generator, mesh=None, fsdp=False) -> Model:
    return model if model is not None else build_model(
        cfg, device=device, generator=generator, mesh=mesh, fsdp=fsdp)


def model_loss(model: Model, batch: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
    """The training loss of ``batch`` ({"tokens", "labels"} (B, S)
    [, "embeddings": a VLM's prefix or an encoder-decoder's frames]
    [, "loss_mask"]): ``transformer.loss_fn``.  The reference adds the MoE
    aux loss only where the config has experts; without them the aux is
    an exact 0, so the sum is the same.  On a mesh every rank returns the
    whole batch's loss."""
    return loss_fn(model, batch)


def _local_grads(model: Model, params: Dict[str, torch.Tensor],
                 batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, Optional[torch.Tensor]]]:
    """``model_loss`` (detached) and this rank's gradients before the sums
    over the mesh: the backward seeded with 1 / the mesh's size (the
    adjoint convention, ``models.parallel``; 1 without a mesh)."""
    loss = model_loss(model, batch)
    mesh = model.mesh
    seed = None if mesh is None else torch.full_like(loss, 1.0 / mesh.size)
    grads = torch.autograd.grad(loss, list(params.values()),
                                grad_outputs=seed, allow_unused=True)
    return loss.detach(), dict(zip(params, grads))


def _reduced(model: Model, params, grads):
    """The sums of ``parallel.reduce_grads`` on a mesh, a gradient the loss
    does not reach a zero there (every rank takes part in every sum)."""
    mesh = model.mesh
    if mesh is None:
        return grads
    grads = {k: torch.zeros_like(params[k]) if g is None else g
             for k, g in grads.items()}
    return parallel.reduce_grads(mesh, params, grads)


def loss_and_grads(model: Model, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, Optional[torch.Tensor]]]:
    """``model_loss`` (detached) and its gradient for every named parameter
    (None where the loss does not reach one), the model's weights made
    trainable first.  On a mesh each rank returns the gradient of its
    blocks (the parameters' local shapes; a zero where the loss does not
    reach one): summed over the axes on which the leaf is whole, the FSDP
    leaves reduce-scattered over ``data`` (``models.parallel``)."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    loss, grads = _local_grads(model, params, batch)
    return loss, _reduced(model, params, grads)


def _check_batch(cfg, batch: Dict[str, torch.Tensor], micro: int) -> None:
    tokens = batch["tokens"]
    if tokens.dim() != 2 or tokens.is_floating_point():
        raise ValueError(f"tokens must be (B, S) integers, got "
                         f"{tuple(tokens.shape)} {tokens.dtype}")
    if tuple(batch["labels"].shape) != tuple(tokens.shape):
        raise ValueError(f"labels {tuple(batch['labels'].shape)} for tokens "
                         f"{tuple(tokens.shape)}")
    if tokens.shape[0] % micro:
        raise ValueError(f"{cfg.name}: a batch of {tokens.shape[0]} rows "
                         f"does not split into {micro} microbatches")


def make_train_step(cfg, *, lr: float = 3e-4, grad_clip: float = 1.0,
                    model: Optional[Model] = None,
                    device: "str | torch.device" = "cuda",
                    generator: Optional[torch.Generator] = None,
                    mesh=None) -> Tuple[Callable, Model, Optimizer]:
    """``train_step(opt_state, step, batch) -> (opt_state, step + 1,
    {"loss": 0-d tensor})``, the model it trains (its weights made
    trainable) and the optimizer (``opt.init(dict(model.named_parameters()))``
    gives the first ``opt_state``); ``step`` is a Python int.  One step:
    the loss and gradients (with ``cfg.grad_accum`` > 1, the batch's rows
    cut into that many microbatches in order, their losses and float32
    gradients summed, then divided), ``clip_by_global_norm`` at
    ``grad_clip``, then ``adamw(lr)`` with moments in ``cfg.opt_dtype``,
    written into the model's weights and ``opt_state`` in place
    (``update_``; ``opt_state`` is returned).

    ``mesh``: build the model across it (unless ``model`` is given) with
    the training placement -- ``spec_for_param(..., fsdp=True)``'s block of
    every weight, and so of both moments -- and every rank passes the
    whole batch: the batch is checked on every rank before a collective
    (``parallel.posted``), microbatch i is rows [i·mb, (i+1)·mb) of it and
    each data rank runs its rows of that; the gradients are each rank's
    blocks (``loss_and_grads``) and the clip reads the mesh-wide norm.
    Every rank returns the same loss."""
    model = _model(cfg, model, device, generator, mesh, fsdp=True)
    mesh = model.mesh
    model.requires_grad_(True)
    opt = adamw(lr, opt_dtype=cfg.opt_dtype_str)
    params = dict(model.named_parameters())
    micro = cfg.grad_accum

    def train_step(opt_state, step: int, batch: Dict[str, torch.Tensor]):
        def check():
            _check_batch(cfg, batch, micro)
        if mesh is None:
            check()
        parallel.posted(mesh, "train_step", check)
        if micro > 1:
            mb = batch["tokens"].shape[0] // micro
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            for i in range(micro):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                part_loss, part_grads = _local_grads(model, params, part)
                loss = loss + part_loss
                for k, g in part_grads.items():
                    if g is not None:
                        grads[k] += g
            n = torch.full((), float(micro), device=model.device)
            loss = loss / n
            grads = {k: g / n for k, g in grads.items()}
        else:
            loss, grads = _local_grads(model, params, batch)
        grads = _reduced(model, params, grads)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in grads.items()}
        scale = clip_scale(grads, grad_clip, mesh)
        for g in grads.values():
            g.mul_(scale.to(g.dtype))
        opt.update_(grads, opt_state, params, step)
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

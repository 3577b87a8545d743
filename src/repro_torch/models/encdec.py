"""Encoder-decoder transformer backbone (whisper-large-v3).

The port of the reference's ``models/encdec.py``.  The mel-spectrogram
and conv frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, F, d_model).  Sinusoidal positions
(length-agnostic) stand in for whisper's learned tables, in the encoder
and the decoder.

The encoder's bidirectional attention, the decoder's causal
self-attention and its cross-attention over the encoder output all go
through the flash kernel (the last with F keys); decode runs the plain
attention against its caches: per decoder layer the self-attention K/V
(``cache_len`` slots) and the cross-attention K/V, written once from the
encoder output by ``prefill_cross``.  The cache keeps the reference's
layout, ``{"decoder": {"k", "v", "cross_k", "cross_v"}}`` with each leaf
stacked over the decoder layers, and is updated in place.  The layers are
``nn.Module``s in order.  With ``cfg.remat`` and a gradient recorded,
each encoder layer and each decoder layer runs through a non-reentrant
``torch.utils.checkpoint``, as the reference's scan bodies run under
``jax.checkpoint`` (``transformer.run_unit``).  The reference's
``scan_layers`` (a compile-time device of XLA) means nothing in eager
PyTorch and is not read.  Across a ``launch.mesh.Mesh2D`` the data axis
splits the batch (each data rank runs its rows; ``hidden``, ``apply`` and
``decode_step`` return the whole batch); on the model axis each weight
is its rule's block (``sharding.rules``): every attention head-parallel
where the axis divides the heads, and where it does not the decoder's
self-attention context-parallel (``attn_seq_shard``, as the reference
applies it in ``attention_apply`` alone) and the encoder's and the
cross-attention whole on every rank (``models/attention.py``); the MLPs
column- and row-parallel over ``d_ff``; the tied table split by vocab
or by ``d_model`` (``parallel.embed``/``unembed``).  The self cache's
slots and the cross cache's frames split over ``model`` as
``sharding.cache_spec`` places them (whole where W divides neither them,
dh nor the heads: ``attention.cache_slots``); ``prefill_cross`` writes
the rank's block of the frames, and decode merges the ranks' partial
softmax over them.  Built for training (``fsdp=True``) each layer also
holds its weights' FSDP blocks and gathers them over ``data`` at its
entry (``parallel.gathered``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, parallel
from repro_torch.models.transformer import MLP, remat_active, run_unit

Cache = Dict[str, Dict[str, torch.Tensor]]


def sinusoid_positions(positions: torch.Tensor, d_model: int
                       ) -> torch.Tensor:
    """(S,) int positions -> (S, d_model) sinusoidal embeddings, fp32: sin
    then cos of position · 10000^(-i / max(d/2 - 1, 1))."""
    dev = positions.device
    half = d_model // 2
    log_base = torch.log(torch.tensor(10000.0, device=dev))
    freqs = torch.exp(-log_base * torch.arange(half, dtype=torch.float32,
                                               device=dev)
                      / torch.tensor(float(max(half - 1, 1)), device=dev))
    angles = positions.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def init_cache(cfg, batch: int, cache_len: int, n_frames: Optional[int],
               device, mesh=None) -> Cache:
    """``EncDecTransformer.init_cache`` for ``cfg`` on ``device`` (``meta``
    gives the shapes and dtypes alone); with a ``mesh``, this data rank's
    rows of the batch and this model rank's slots and frames
    (``attention.cache_slots``), each leaf tagged with its
    ``model_split``."""
    lo, hi = parallel.data_rows(mesh, batch)
    batch = hi - lo
    n_frames = n_frames or cfg.stub_frames
    lead = (cfg.n_layers, batch)
    tail = (cfg.n_kv_heads, cfg.d_head)

    def zeros(length, what):
        local = attention.cache_slots(cfg, length, mesh, what)
        return parallel.tagged(
            torch.zeros(lead + (local,) + tail, dtype=cfg.compute_dtype,
                        device=device), (length,), (local,), lead=2)
    return {"decoder": {"k": zeros(cache_len, "the self-attention cache"),
                        "v": zeros(cache_len, "the self-attention cache"),
                        "cross_k": zeros(n_frames, "the cross cache"),
                        "cross_v": zeros(n_frames, "the cross cache")}}


def _norm(cfg, device, generator) -> layers.Norm:
    return layers.Norm(cfg.norm, cfg.d_model, cfg.param_dtype, device,
                       generator)


class EncoderLayer(nn.Module):
    """norm1 → bidirectional attention → residual → norm2 → MLP →
    residual."""

    def __init__(self, cfg, device, generator, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.norm1 = _norm(cfg, device, generator)
        self.attn = attention.Attention(cfg, device=device,
                                        generator=generator, mesh=mesh)
        self.norm2 = _norm(cfg, device, generator)
        self.mlp = MLP(cfg, device, generator, mesh)

    def forward(self, x: torch.Tensor, cfg) -> torch.Tensor:
        with parallel.gathered(self.mesh, self):
            x = x + attention.bidirectional_attention_apply(
                self.attn, self.norm1(x), cfg, use_rope=False)
            return x + self.mlp(self.norm2(x))


class DecoderLayer(nn.Module):
    """norm1 → causal self-attention (NoPE) → residual → norm2 →
    cross-attention over the encoder output → residual → norm3 → MLP →
    residual."""

    def __init__(self, cfg, device, generator, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.norm1 = _norm(cfg, device, generator)
        self.self_attn = attention.Attention(cfg, device=device,
                                             generator=generator, mesh=mesh)
        self.norm2 = _norm(cfg, device, generator)
        self.cross_attn = attention.Attention(cfg, device=device,
                                              generator=generator, mesh=mesh)
        self.norm3 = _norm(cfg, device, generator)
        self.mlp = MLP(cfg, device, generator, mesh)

    def forward(self, x: torch.Tensor, enc: torch.Tensor,
                positions: torch.Tensor, cfg) -> torch.Tensor:
        with parallel.gathered(self.mesh, self):
            x = x + attention.attention_apply(
                self.self_attn, self.norm1(x), cfg, mask_kind="global",
                positions=positions, use_rope=False)
            x = x + attention.cross_attention_apply(self.cross_attn,
                                                    self.norm2(x), enc, cfg)
            return x + self.mlp(self.norm3(x))


class EncDecTransformer(nn.Module):
    """Encoder-decoder model with its weights on ``device``.

    ``generator``: draw the weights from it (on its device, which must be
    ``device``) with the reference's init distributions; ``None`` leaves
    them unset for ``convert.params_from_numpy`` or ``load_state_dict``.
    ``mesh``: a ``launch.mesh.Mesh2D`` to serve across (this rank's blocks
    of the weights; see the module's docstring); ``fsdp``: place them for
    training.
    """

    def __init__(self, cfg, *, device: "str | torch.device" = "cuda",
                 generator: Optional[torch.Generator] = None, mesh=None,
                 fsdp: bool = False):
        super().__init__()
        dev = resolve_device(device)
        if generator is not None and generator.device.type != dev.type:
            raise ValueError(f"generator is on {generator.device}, the model "
                             f"on {dev}")
        self.cfg = cfg
        self.device = dev
        mesh = parallel.placed(mesh if parallel.active(mesh) else None, fsdp)
        self.mesh = mesh
        shape = (cfg.vocab_size, cfg.d_model)
        self.embedding = layers.param(
            shape, cfg.param_dtype, dev, generator,
            lambda: layers.normal_init(shape, generator, cfg.param_dtype),
            name="embedding", mesh=mesh)
        self.unembedding = None if cfg.tie_embeddings else layers.param(
            shape, cfg.param_dtype, dev, generator,
            lambda: layers.normal_init(shape, generator, cfg.param_dtype),
            name="unembedding", mesh=mesh)
        # the tables' split over `model`: 0 by vocab, 1 by d_model
        self.table_split = parallel.split_dim("embedding", shape, mesh)
        self.encoder = nn.ModuleList(EncoderLayer(cfg, dev, generator, mesh)
                                     for _ in range(cfg.encoder_layers))
        self.enc_norm = _norm(cfg, dev, generator)
        self.decoder = nn.ModuleList(DecoderLayer(cfg, dev, generator, mesh)
                                     for _ in range(cfg.n_layers))
        self.final_norm = _norm(cfg, dev, generator)

    def _positions(self, x: torch.Tensor, positions: torch.Tensor
                   ) -> torch.Tensor:
        return x + sinusoid_positions(positions,
                                      self.cfg.d_model)[None].to(x.dtype)

    # -- encoder ---------------------------------------------------------------

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """Frame embeddings (B, F, d) -> the encoder output (B, F, d) in the
        compute dtype, after ``enc_norm``."""
        cfg = self.cfg
        x = frames.to(cfg.compute_dtype)
        x = self._positions(x, torch.arange(x.shape[1], device=x.device))
        remat = remat_active(self)
        for lyr in self.encoder:
            x = run_unit(lyr, remat, x, cfg)
        return self.enc_norm(x)

    # -- decoder (teacher forcing) ---------------------------------------------

    def hidden(self, tokens: torch.Tensor,
               extra_embeddings: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """Decoder tokens (B, S) and the frames (B, F, d) -> the
        final-normed decoder hidden states (B, S, d)."""
        x = self.local_hidden(tokens, extra_embeddings)[0]
        return parallel.unrows(self.mesh, x, tokens.shape[0])

    def _hidden(self, tokens: torch.Tensor,
                extra_embeddings: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        if extra_embeddings is None:
            raise ValueError(f"{cfg.name}: the encoder-decoder model needs "
                             f"the frames (extra_embeddings)")
        enc = self.encode(extra_embeddings)
        x = self._embed(tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        x = self._positions(x, positions)
        remat = remat_active(self)
        for lyr in self.decoder:
            x = run_unit(lyr, remat, x, enc, positions, cfg)
        return self.final_norm(x)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return parallel.embed(self.embedding, self.table_split, self.mesh,
                              tokens, self.cfg.compute_dtype)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., d) -> logits (..., V), every vocab entry on every rank
        (``parallel.unembed``)."""
        return parallel.unembed(self.output_table, self.table_split,
                                self.mesh, x)

    def apply(self, tokens: torch.Tensor,
              extra_embeddings: Optional[torch.Tensor] = None, *,
              with_aux: bool = False
              ) -> "torch.Tensor | Tuple[torch.Tensor, torch.Tensor]":
        """tokens (B, S) and frames (B, F, d) -> logits (B, S, V); with
        ``with_aux`` also a 0-d float32 zero, as the reference's ``apply``
        returns ``(logits, 0.0)``."""
        x, aux = self.local_hidden(tokens, extra_embeddings)
        logits = parallel.unrows(self.mesh, self.unembed(x), tokens.shape[0])
        return (logits, aux) if with_aux else logits

    def local_hidden(self, tokens: torch.Tensor,
                     extra_embeddings: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The final-normed decoder hidden states of this rank's rows of
        the batch (all of them without a mesh, or where the data axis does
        not divide it) and the aux, a 0-d float32 zero."""
        mesh = self.mesh
        x = self._hidden(parallel.rows(mesh, tokens),
                         parallel.rows(mesh, extra_embeddings))
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    @property
    def output_table(self) -> torch.Tensor:
        """The (V, d) table the logits are taken against: this rank's
        block."""
        return self.embedding if self.unembedding is None \
            else self.unembedding

    # -- decode ---------------------------------------------------------------

    def init_cache(self, batch: int, cache_len: int,
                   n_frames: Optional[int] = None) -> Cache:
        """Zero caches in the compute dtype, each stacked over the decoder
        layers: self-attention ``k``/``v`` (L, B, cache_len, KV, Dh) and
        ``cross_k``/``cross_v`` (L, B, n_frames, KV, Dh); ``n_frames``
        defaults to the config's ``stub_frames``."""
        return init_cache(self.cfg, batch, cache_len, n_frames, self.device,
                          self.mesh)

    def prefill_cross(self, cache: Cache, frames: torch.Tensor) -> Cache:
        """Encode the frames (B, F, d) and write each decoder layer's
        cross-attention K/V (with their biases) into the cache in place --
        on a model axis the rank's block of the frames, every KV head --;
        returns the cache."""
        enc = self.encode(parallel.rows(self.mesh, frames))
        dc = cache["decoder"]
        n = dc["cross_k"].shape[2]
        f0 = 0 if getattr(dc["cross_k"], "model_split", None) is None \
            else self.mesh.coords["model"] * n
        for i, lyr in enumerate(self.decoder):
            with parallel.gathered(self.mesh, lyr):
                k, v = attention.cross_kv(lyr.cross_attn, enc, enc.dtype)
            dc["cross_k"][i].copy_(k[:, f0:f0 + n])
            dc["cross_v"][i].copy_(v[:, f0:f0 + n])
        return cache

    def decode_step(self, token: torch.Tensor, cache: Cache,
                    index: "int | torch.Tensor", *, prefix_len: int = 0
                    ) -> Tuple[torch.Tensor, Cache]:
        """token (B, 1) at position ``index`` + cache -> (logits (B, 1, V),
        cache): causal self-attention over the cached tokens (NoPE), then
        cross-attention over the cached frames, both plain.  The cache is
        updated in place and returned; ``prefix_len`` is unused (the
        reference's signature)."""
        cfg = self.cfg
        index = int(index)
        batch = token.shape[0]
        token = parallel.rows(self.mesh, token)
        x = self._embed(token)
        x = self._positions(x, torch.full((1,), index, device=x.device))
        dc = {k: [parallel.layer_view(v, i) for i in range(v.shape[0])]
              for k, v in cache["decoder"].items()}
        for i, lyr in enumerate(self.decoder):
            with parallel.gathered(self.mesh, lyr):
                y, _ = attention.attention_decode(
                    lyr.self_attn, lyr.norm1(x), cfg,
                    {"k": dc["k"][i], "v": dc["v"][i]}, index,
                    mask_kind="global", use_rope=False)
                x = x + y
                x = x + attention.cross_decode(
                    lyr.cross_attn, lyr.norm2(x), dc["cross_k"][i],
                    dc["cross_v"][i])
                x = x + lyr.mlp(lyr.norm3(x))
        logits = self.unembed(self.final_norm(x))
        return parallel.unrows(self.mesh, logits, batch), cache

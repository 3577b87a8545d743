"""Block-assembly decoder of the substrate, as far as it is ported.

The port of the reference's ``models/transformer.py``: an architecture is a
pattern unit of (sequence mixer, ffn) pairs repeated over the layers
(``compute_stages``).  Ported mixers: ``attn`` (causal global), ``swa``
(sliding window) and ``rec`` (RG-LRU), each with a ``dense`` gated MLP;
RMSNorm or LayerNorm; a tied or untied embedding; attention with or
without QKV bias and per-head q/k RMSNorm -- what recurrentgemma-9b and
the dense decoders (yi-34b, qwen3-8b and its sliding-window variant,
qwen1.5-110b, stablelm-1.6b) run.  The layers are ``nn.Module``s in layer
order; the decode cache keeps the reference's dict layout (``stage_<i>`` →
unit position → leaves stacked over the stage's repetitions).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, rglru

Cache = Dict[str, Dict[str, Dict[str, torch.Tensor]]]

ATTENTION_KINDS = ("attn", "swa")
MASK_FOR_KIND = {"attn": "global", "swa": "sliding"}


def compute_stages(n_layers: int, pattern: Tuple
                   ) -> List[Tuple[Tuple, int]]:
    """Split ``n_layers`` into (unit, repetitions) stages."""
    u = len(pattern)
    reps, rem = divmod(n_layers, u)
    stages = []
    if reps:
        stages.append((pattern, reps))
    if rem:
        stages.append((pattern[:rem], 1))
    return stages


def _check_ported(cfg) -> None:
    unported = [k for k in cfg.block_pattern
                if k not in ATTENTION_KINDS + ("rec",)]
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: sequence mixers {unported} are not ported yet "
            f"(ROADMAP A17: chunked attention, xLSTM)")
    if any(f != "dense" for f in cfg.ffn_pattern):
        raise NotImplementedError(f"{cfg.name}: only dense FFNs are ported "
                                  f"(ROADMAP A17: MoE)")
    if cfg.mlp_bias or not cfg.gated_mlp:
        raise NotImplementedError(
            f"{cfg.name}: only a gated MLP without bias is ported "
            f"(ROADMAP A17)")
    if cfg.prefix_tokens:
        raise NotImplementedError(f"{cfg.name}: prefix-LM models are not "
                                  f"ported yet (ROADMAP A17)")


class MLP(nn.Module):
    def __init__(self, cfg, device, generator):
        super().__init__()
        d, ff, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
        for name, shape, fan_in in (("w_in", (d, ff), d),
                                    ("w_out", (ff, d), ff),
                                    ("w_gate", (d, ff), d)):
            self.register_parameter(name, layers.param(
                shape, dt, device, generator,
                lambda shape=shape, fan_in=fan_in: layers.scaled_init(
                    shape, generator, dt, fan_in=fan_in)))
        self.activation = cfg.activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layers.mlp_apply(self.w_in, self.w_gate, self.w_out, x,
                                activation=self.activation)


class Block(nn.Module):
    """norm1 → mixer (``attn`` or ``rec``) → residual → norm2 → MLP →
    residual."""

    def __init__(self, cfg, kind: str, device, generator):
        super().__init__()
        self.kind = kind
        self.norm1 = layers.Norm(cfg.norm, cfg.d_model, cfg.param_dtype,
                                 device, generator)
        if kind in ATTENTION_KINDS:
            self.attn = attention.Attention(cfg, device=device,
                                            generator=generator)
        else:
            self.rec = rglru.RGLRU(cfg, device=device, generator=generator)
        self.norm2 = layers.Norm(cfg.norm, cfg.d_model, cfg.param_dtype,
                                 device, generator)
        self.mlp = MLP(cfg, device, generator)


class Transformer(nn.Module):
    """Decoder-only model with its weights on ``device``.

    ``generator``: draw the weights from it (on its device, which must be
    ``device``) with the reference's init distributions; ``None`` leaves
    them unset for ``convert.params_from_numpy`` or ``load_state_dict``.
    """

    def __init__(self, cfg, *, device: "str | torch.device" = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        _check_ported(cfg)
        if generator is not None and generator.device.type != dev.type:
            raise ValueError(f"generator is on {generator.device}, the model "
                             f"on {dev}")
        self.cfg = cfg
        self.device = dev
        pat = tuple(zip(cfg.block_pattern, cfg.ffn_pattern))
        self.stages = compute_stages(cfg.n_layers, pat)
        self.embedding = layers.param(
            (cfg.vocab_size, cfg.d_model), cfg.param_dtype, dev, generator,
            lambda: layers.normal_init((cfg.vocab_size, cfg.d_model),
                                       generator, cfg.param_dtype))
        # an untied output table, drawn after the input one (the reference
        # draws it from the embedding key's second split)
        self.unembedding = None if cfg.tie_embeddings else layers.param(
            (cfg.vocab_size, cfg.d_model), cfg.param_dtype, dev, generator,
            lambda: layers.normal_init((cfg.vocab_size, cfg.d_model),
                                       generator, cfg.param_dtype))
        self.final_norm = layers.Norm(cfg.norm, cfg.d_model,
                                      cfg.param_dtype, dev, generator)
        blocks, where = [], []
        for si, (unit, reps) in enumerate(self.stages):
            for r in range(reps):
                for i, (kind, _) in enumerate(unit):
                    blocks.append(Block(cfg, kind, dev, generator))
                    where.append((f"stage_{si}", r, str(i)))
        self.blocks = nn.ModuleList(blocks)
        # (stage key, repetition, unit position) of each block, in order
        self.block_index = where

    # -- forward (train / prefill) -------------------------------------------

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = layers.embed_apply(self.embedding, tokens, self.cfg.compute_dtype)
        if self.cfg.embed_scale:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        return x

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> the final-normed hidden states (B, S, d)."""
        cfg = self.cfg
        x = self._embed(tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        for blk in self.blocks:
            h = blk.norm1(x)
            if blk.kind in ATTENTION_KINDS:
                y = attention.attention_apply(
                    blk.attn, h, cfg, mask_kind=MASK_FOR_KIND[blk.kind],
                    positions=positions,
                    use_rope=cfg.rope_on_global if blk.kind == "attn"
                    else True)
            else:
                y = rglru.rglru_block_apply(blk.rec, h)
            x = x + y
            x = x + blk.mlp(blk.norm2(x))
        return self.final_norm(x)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        table = self.embedding if self.unembedding is None \
            else self.unembedding
        return layers.unembed_apply(table, x)

    def apply(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V).  (The reference also returns
        the MoE aux loss, which the ported mixers do not have.)"""
        return self.unembed(self.hidden(tokens))

    # -- decode ---------------------------------------------------------------

    def init_cache(self, batch: int, cache_len: int) -> Cache:
        cfg, dev = self.cfg, self.device
        cache: Cache = {}
        for si, (unit, reps) in enumerate(self.stages):
            unit_cache = {}
            for i, (kind, _) in enumerate(unit):
                one = (attention.init_cache(cfg, batch, cache_len,
                                            MASK_FOR_KIND[kind], dev)
                       if kind in ATTENTION_KINDS
                       else rglru.init_cache(cfg, batch, dev))
                unit_cache[str(i)] = {
                    k: torch.zeros((reps,) + v.shape, dtype=v.dtype,
                                   device=dev) for k, v in one.items()}
            cache[f"stage_{si}"] = unit_cache
        return cache

    def decode_step(self, token: torch.Tensor, cache: Cache,
                    index: "int | torch.Tensor"
                    ) -> Tuple[torch.Tensor, Cache]:
        """token (B, 1) + cache + the token's position -> (logits (B, 1, V),
        cache).  The cache is updated in place (no copy a step) and
        returned."""
        cfg = self.cfg
        index = int(index)
        x = self._embed(token)
        for blk, (stage, r, pos) in zip(self.blocks, self.block_index):
            leaves = cache[stage][pos]
            layer_cache = {k: v[r] for k, v in leaves.items()}
            h = blk.norm1(x)
            if blk.kind in ATTENTION_KINDS:
                y, _ = attention.attention_decode(
                    blk.attn, h, cfg, layer_cache, index,
                    mask_kind=MASK_FOR_KIND[blk.kind],
                    use_rope=cfg.rope_on_global if blk.kind == "attn"
                    else True)
            else:
                y, new = rglru.rglru_block_decode(blk.rec, h, layer_cache)
                for k, v in new.items():
                    leaves[k][r].copy_(v)
            x = x + y
            x = x + blk.mlp(blk.norm2(x))
        return self.unembed(self.final_norm(x)), cache

"""Attention layer of the substrate: GQA / MQA / MHA with RoPE or NoPE,
optional QKV bias (qwen1.5, whisper) and per-head q/k RMSNorm (qwen3), and
the reference's four mask kinds: ``global`` (causal), ``sliding`` (causal,
window), ``chunked`` (causal within llama4's chunks) and ``prefix``
(paligemma's prefix-LM: causal, or key in the prefix); and whisper's two
unmasked forms, bidirectional self-attention (the encoder) and
cross-attention of decoder tokens over encoder frames.

The port of the reference's ``models/attention.py``.  The full-sequence
path (``attention_apply``: training shapes and prefill) goes through the
flash-attention kernel (``kernels.seq_ops.flash_attention``), which
replaces both of the reference's XLA routes (``_sdpa`` and the
query-chunked ``_chunked_sdpa``) -- they compute the same function.  The
one-token decode path (``attention_decode``) keeps the plain ``_sdpa``
against a KV cache, a ring for ``sliding`` and ``chunked`` layers.
``bidirectional_attention_apply`` and ``cross_attention_apply`` go through
the flash kernel without a mask, the latter with a key length of its own
(the frames); ``cross_decode`` is plain, over the frames' cached K/V.
``cfg.attn_seq_shard`` (the reference's context parallelism over a TPU
mesh) has no meaning on one card and is ignored.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import seq_ops
from repro_torch.models import layers

NEG_INF = -2.0e38
MASK_KINDS = ("global", "sliding", "chunked", "prefix")


def _check_kind(kind: str) -> None:
    if kind not in MASK_KINDS:
        raise ValueError(f"unknown mask kind {kind!r}")


class Attention(nn.Module):
    """wq (d, H, Dh), wk/wv (d, KV, Dh), wo (H, Dh, d) in ``param_dtype``;
    drawn as the reference's ``attention_init`` draws them when a
    generator is given, else left for a loader to fill.  With
    ``cfg.qkv_bias`` also bq (H, Dh), bk and bv (KV, Dh), zeros; with
    ``cfg.qk_norm`` also ``q_norm`` and ``k_norm``, RMSNorms over Dh with
    a scale of ones -- none of them drawn, as in the reference."""

    def __init__(self, cfg, *, device, generator: Optional[torch.Generator]):
        super().__init__()
        d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        shapes = {"wq": ((d, h, dh), d), "wk": ((d, kv, dh), d),
                  "wv": ((d, kv, dh), d), "wo": ((h, dh, d), h * dh)}
        for name, (shape, fan_in) in shapes.items():
            self.register_parameter(name, layers.param(
                shape, cfg.param_dtype, device, generator,
                lambda shape=shape, fan_in=fan_in: layers.scaled_init(
                    shape, generator, cfg.param_dtype, fan_in=fan_in)))
        self.qkv_bias, self.qk_norm = cfg.qkv_bias, cfg.qk_norm
        if cfg.qkv_bias:
            for name, n in (("bq", h), ("bk", kv), ("bv", kv)):
                self.register_parameter(name, layers.param(
                    (n, dh), cfg.param_dtype, device, generator,
                    lambda n=n: torch.zeros((n, dh), dtype=cfg.param_dtype,
                                            device=generator.device)))
        if cfg.qk_norm:
            self.q_norm = layers.Norm("rmsnorm", dh, cfg.param_dtype, device,
                                      generator)
            self.k_norm = layers.Norm("rmsnorm", dh, cfg.param_dtype, device,
                                      generator)


def _qkv(p: Attention, x: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> q (B, S, H, Dh), k, v (B, S, KV, Dh): the
    projections, then the bias, then the q/k norm, as the reference's
    ``_qkv`` (RoPE comes after, in the caller)."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p.wk.to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p.wv.to(dt))
    if p.qkv_bias:
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    if p.qk_norm:
        q = p.q_norm(q)
        k = p.k_norm(k)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          q_pos: torch.Tensor, k_pos: torch.Tensor,
          k_valid: torch.Tensor, prefix_len: int = 0) -> torch.Tensor:
    """q (B, Q, H, Dh), k/v (B, K, KV, Dh) -> (B, Q, H, Dh), plain: the
    scaled query in the activation dtype, fp32 logits and softmax over the
    valid keys at or before each query position or before ``prefix_len``
    (the reference's ``global`` mask, ``prefix`` with a prefix)."""
    b, qlen, h, dh = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, qlen, kv, h // kv, dh)
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg * dh ** -0.5, k).float()
    kp = k_pos[None, :]
    allowed = ((kp <= q_pos[:, None]) | (kp < prefix_len)) & k_valid[None, :]
    masked = torch.where(allowed, logits, NEG_INF)
    probs = torch.softmax(masked, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqs,bshk->bqhgk", probs, v)
    return out.reshape(b, qlen, h, dh)


def _out(p: Attention, out: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", out, p.wo.to(out.dtype))


def _rotated_qkv(p: Attention, x: torch.Tensor, cfg,
                 positions: Optional[torch.Tensor], use_rope: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_qkv``, then RoPE over ``positions`` (default 0..S-1) unless NoPE."""
    q, k, v = _qkv(p, x)
    if use_rope:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_apply(p: Attention, x: torch.Tensor, cfg, *, mask_kind: str,
                    positions: Optional[torch.Tensor] = None,
                    use_rope: bool = True, prefix_len: int = 0
                    ) -> torch.Tensor:
    """Full-sequence (training / prefill) attention through the flash
    kernel.  x (B, S, d) -> (B, S, d); ``prefix_len`` is read by the
    ``prefix`` mask only, ``cfg.window`` by ``sliding``, ``cfg.attn_chunk``
    by ``chunked``."""
    _check_kind(mask_kind)
    q, k, v = _rotated_qkv(p, x, cfg, positions, use_rope)
    out = seq_ops.flash_attention(
        q, k, v, causal=True,
        window=cfg.window if mask_kind == "sliding" else 0,
        prefix_len=prefix_len if mask_kind == "prefix" else 0,
        chunk=cfg.attn_chunk if mask_kind == "chunked" else 0)
    return _out(p, out)


def attention_prefill_cache(p: Attention, x: torch.Tensor, cfg,
                            cache: Dict[str, torch.Tensor], *,
                            use_rope: bool = True) -> torch.Tensor:
    """A multimodal prefix x (B, P, d) through the ``prefix`` mask over
    itself (full attention) in the flash kernel, its post-RoPE K/V written
    into cache slots [0, P) in place: the attention of the reference's
    ``Transformer.prefill_prefix``.  Returns (B, P, d)."""
    p_len = x.shape[1]
    q, k, v = _rotated_qkv(p, x, cfg, None, use_rope)
    cache["k"][:, :p_len] = k.to(cache["k"].dtype)
    cache["v"][:, :p_len] = v.to(cache["v"].dtype)
    out = seq_ops.flash_attention(q, k, v, causal=True, prefix_len=p_len)
    return _out(p, out)


def init_cache(cfg, batch: int, cache_len: int, mask_kind: str,
               device) -> Dict[str, torch.Tensor]:
    """A decode KV cache for one layer: a ring buffer of ``window`` slots
    for ``sliding`` layers and of ``attn_chunk`` for ``chunked`` ones (at
    most ``cache_len``), ``cache_len`` slots for ``global`` and ``prefix``
    ones."""
    _check_kind(mask_kind)
    if mask_kind == "sliding":
        size = min(cfg.window, cache_len)
    elif mask_kind == "chunked":
        size = min(cfg.attn_chunk, cache_len)
    else:
        size = cache_len
    shape = (batch, size, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.kv_cache_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.kv_cache_dtype, device=device)}


def attention_decode(p: Attention, x: torch.Tensor, cfg,
                     cache: Dict[str, torch.Tensor], index: int, *,
                     mask_kind: str, use_rope: bool = True,
                     prefix_len: int = 0
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode step.  x (B, 1, d); ``index`` the token's absolute
    position.  Writes the token's K/V into its ring slot of ``cache`` in
    place (saving a copy of the cache a step) and returns the cache.
    ``prefix_len`` is read by the ``prefix`` mask only."""
    _check_kind(mask_kind)
    dev = x.device
    q, k, v = _qkv(p, x)
    pos = torch.full((1,), index, dtype=torch.int64, device=dev)
    if use_rope:
        q = layers.apply_rope(q, pos, cfg.rope_theta)
        k = layers.apply_rope(k, pos, cfg.rope_theta)
    size = cache["k"].shape[1]
    slot = index % size
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    # keys are cached post-RoPE; each slot's absolute position
    slots = torch.arange(size, device=dev)
    k_valid = slots < min(index + 1, size)
    if mask_kind == "chunked":
        # a ring of the chunk's size: only the current chunk's slots are
        # visible (the reference takes the ring's size as the chunk)
        slot_pos = (index // size) * size + slots
        k_valid = k_valid & (slot_pos <= index)
        k_pos = slot_pos
    elif mask_kind == "sliding":
        # slot holds the absolute position p with p % size == slot, p <= index
        cand = (index // size) * size + slots
        k_pos = torch.where(cand <= index, cand, cand - size)
        k_valid = k_valid & (k_pos > index - cfg.window) & (k_pos >= 0)
    else:
        k_pos = slots
    out = _sdpa(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), pos,
                k_pos, k_valid,
                prefix_len if mask_kind == "prefix" else 0)
    return _out(p, out), cache


def bidirectional_attention_apply(p: Attention, x: torch.Tensor, cfg, *,
                                  use_rope: bool = True) -> torch.Tensor:
    """Unmasked self-attention (whisper's encoder, which passes
    ``use_rope=False``) through the flash kernel.  x (B, S, d) ->
    (B, S, d)."""
    q, k, v = _rotated_qkv(p, x, cfg, None, use_rope)
    return _out(p, seq_ops.flash_attention(q, k, v, causal=False))


def cross_kv(p: Attention, kv_src: torch.Tensor, dtype: torch.dtype
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output (B, F, d), in ``dtype``, projected to k and v (B,
    F, KV, Dh), each with its bias: what ``cross_attention_apply`` attends
    to and what a decode cache holds."""
    src = kv_src.to(dtype)
    k = torch.einsum("bsd,dhk->bshk", src, p.wk.to(dtype))
    v = torch.einsum("bsd,dhk->bshk", src, p.wv.to(dtype))
    if p.qkv_bias:
        k = k + p.bk.to(dtype)
        v = v + p.bv.to(dtype)
    return k, v


def _cross_q(p: Attention, x: torch.Tensor) -> torch.Tensor:
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(x.dtype))
    return q + p.bq.to(x.dtype) if p.qkv_bias else q


def cross_attention_apply(p: Attention, x: torch.Tensor,
                          kv_src: torch.Tensor, cfg) -> torch.Tensor:
    """Encoder-decoder cross-attention (whisper): queries from x (B, S, d),
    keys and values from the encoder output (B, F, d), no mask, no RoPE, no
    q/k norm, through the flash kernel with F keys.  -> (B, S, d); the
    output projection has no bias.  ``cfg`` is unread (the reference's
    signature)."""
    k, v = cross_kv(p, kv_src, x.dtype)
    out = seq_ops.flash_attention(_cross_q(p, x), k, v, causal=False)
    return _out(p, out)


def cross_decode(p: Attention, x: torch.Tensor, ck: torch.Tensor,
                 cv: torch.Tensor) -> torch.Tensor:
    """One decode step's cross-attention over the cached frames' K/V (B, F,
    KV, Dh), plain, as the reference's ``encdec._cross_decode``: x (B, 1,
    d) -> (B, 1, d)."""
    q = _cross_q(p, x)
    b, s, h, dh = q.shape
    kvh = ck.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, dh)
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg * dh ** -0.5,
                          ck.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhgqs,bshk->bqhgk", probs, cv.to(x.dtype))
    return _out(p, out.reshape(b, s, h, dh))

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

Across a ``launch.mesh.Mesh2D`` whose ``model`` axis has W > 1 ranks
(``sharding.rules``' placement):

* head-parallel where W divides the heads H: rank r holds q heads
  [r·H/W, (r+1)·H/W) of ``wq`` and ``wo`` and its KV heads of ``wk`` and
  ``wv`` where W divides them; else ``wk`` and ``wv`` stay whole and the
  rank projects the KV heads its q heads read (expanded to one a q head
  where its q heads straddle two groups, since flash maps q head h to KV
  head h // (H/KV) only for whole groups).  Biases and the q/k norms are
  whole; one flash launch a layer on the rank's heads; ``wo`` is
  row-parallel, its partials summed over ``model``.
* context-parallel (the reference's ``attn_seq_shard``, A21) where the
  config sets it and W does not divide H -- the case it is made for; where
  the heads divide, head-parallel is the rules' placement and computes
  the same function: every weight whole, each rank computes K/V for the
  whole sequence (the reference's "full-seq K/V per device") and q for
  its block [lo, hi) of ceil(S/W) positions, runs flash with
  ``q_offset=lo``, projects its block and the blocks are all-gathered
  along the sequence (ragged where W does not divide S).
* otherwise every weight is whole and every rank computes the whole
  attention.

The bidirectional and the cross-attention (whisper) are head-parallel
where W divides the heads and whole otherwise: the reference applies
context parallelism in ``attention_apply`` alone.

Decode places the cache as ``sharding.cache_spec`` does where W divides
its slots: rank r holds slots [r·size/W, (r+1)·size/W) of each layer's
cache (its ring too); ``attention_decode`` gathers the step's q and K/V
heads, writes K/V on the slot's rank, computes each rank's partial
softmax over its slots (each slot's position from its global index) and
merges the partials in float32 over ``model`` -- the all-reduced max,
then the rescaled sums of exp and exp·v -- before the row-parallel
``wo``.  Where W divides neither the slots, dh nor the KV heads, every
rank holds the whole cache and runs the unsharded decode attention (the
leaf's ``model_split`` tag is None); ``cache_spec``'s dh and heads
placements are not ported and raise.  ``cross_decode`` merges the ranks'
partial softmax over their blocks of the frames' cached K/V the same
way.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import seq_ops
from repro_torch.launch.mesh import block
from repro_torch.models import layers, parallel

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

    def __init__(self, cfg, *, device, generator: Optional[torch.Generator],
                 mesh=None):
        super().__init__()
        d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        shapes = {"wq": ((d, h, dh), d), "wk": ((d, kv, dh), d),
                  "wv": ((d, kv, dh), d), "wo": ((h, dh, d), h * dh)}
        for name, (shape, fan_in) in shapes.items():
            self.register_parameter(name, layers.param(
                shape, cfg.param_dtype, device, generator,
                lambda shape=shape, fan_in=fan_in: layers.scaled_init(
                    shape, generator, cfg.param_dtype, fan_in=fan_in),
                name=name, mesh=mesh))
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
        self.mesh = mesh if parallel.model_active(mesh) else None
        if self.mesh is not None:
            self._plan(cfg)

    def _plan(self, cfg) -> None:
        """This rank's heads on the model axis (``sharding.rules``' split
        of wq/wo over H and of wk/wv over KV, each where W divides it)."""
        h, kv = cfg.n_heads, cfg.n_kv_heads
        w, r = parallel.model_axis(self.mesh)
        group = h // kv
        self.head_parallel = h % w == 0
        self.kv_split = kv % w == 0
        self.seq_parallel = cfg.attn_seq_shard and not self.head_parallel
        if self.head_parallel:
            h0, h1 = r * h // w, (r + 1) * h // w
            kv0, kv1 = h0 // group, (h1 - 1) // group + 1
        else:
            h0, h1, kv0, kv1 = 0, h, 0, kv
        self.heads, self.kv_heads = (h0, h1), (kv0, kv1)
        n, m = h1 - h0, kv1 - kv0
        reads = [i // group - kv0 for i in range(h0, h1)]
        whole_groups = n % m == 0 and reads == [j // (n // m)
                                                for j in range(n)]
        # the KV head each q head reads where the rank's q heads straddle
        # two groups (K/V then expanded to one head a q head), else None
        self.kv_expand = None if whole_groups else reads


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


# -- the model axis -----------------------------------------------------------

def _heads(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]
           ) -> torch.Tensor:
    y = torch.einsum("bsd,dhk->bshk", x, w.to(x.dtype))
    return y if b is None else y + b.to(x.dtype)


def _rope(t: torch.Tensor, positions: torch.Tensor, cfg,
          use_rope: bool) -> torch.Tensor:
    return layers.apply_rope(t, positions, cfg.rope_theta) if use_rope \
        else t


def _q_local(p: Attention, x: torch.Tensor) -> torch.Tensor:
    """The rank's q heads of x (B, S, d), biased and normed."""
    h0, h1 = p.heads
    q = _heads(x, p.wq, p.bq[h0:h1] if p.qkv_bias else None)
    return p.q_norm(q) if p.qk_norm else q


def _kv_heads(p: Attention, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k and v of the KV heads [kv0, kv1) the rank's q heads read, with
    their biases: from its block of wk/wv where they are split, else from
    their columns of the whole weights."""
    kv0, kv1 = p.kv_heads
    wk, wv = (p.wk, p.wv) if p.kv_split else (p.wk[:, kv0:kv1],
                                              p.wv[:, kv0:kv1])
    return (_heads(x, wk, p.bk[kv0:kv1] if p.qkv_bias else None),
            _heads(x, wv, p.bv[kv0:kv1] if p.qkv_bias else None))


def _kv_local(p: Attention, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_kv_heads`` with the k norm."""
    k, v = _kv_heads(p, x)
    return (p.k_norm(k) if p.qk_norm else k), v


def _kv_all(p: Attention, x: torch.Tensor, positions: torch.Tensor, cfg,
            use_rope: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every KV head of x, post-RoPE, on every rank (what a cache holds):
    the ranks' blocks all-gathered where wk/wv are split, else projected
    from the whole weights."""
    if p.kv_split:
        k, v = _kv_local(p, x)
        k = _rope(k, positions, cfg, use_rope)
        return _gather_heads(p.mesh, k, v)
    k = _heads(x, p.wk, p.bk if p.qkv_bias else None)
    v = _heads(x, p.wv, p.bv if p.qkv_bias else None)
    k = p.k_norm(k) if p.qk_norm else k
    return _rope(k, positions, cfg, use_rope), v


def _gather_heads(mesh, *parts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each of ``parts`` (B, S, n_i, Dh), a rank's block of heads, gathered
    over ``model`` in one collective."""
    return parallel.gather_blocks(mesh, *parts, dim=2)


def _expanded(p: Attention, k: torch.Tensor, v: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    if p.kv_expand is None:
        return k, v
    return k[:, :, p.kv_expand], v[:, :, p.kv_expand]


def _out_sharded(p: Attention, out: torch.Tensor) -> torch.Tensor:
    """The rank's heads through its block of ``wo``, summed over
    ``model`` (row-parallel); a whole ``wo`` needs no sum."""
    y = _out(p, out)
    return parallel.sum_model(p.mesh, y) if p.head_parallel else y


def _mask_kw(mask_kind: str, cfg, prefix_len: int) -> dict:
    return dict(causal=True,
                window=cfg.window if mask_kind == "sliding" else 0,
                prefix_len=prefix_len if mask_kind == "prefix" else 0,
                chunk=cfg.attn_chunk if mask_kind == "chunked" else 0)


def _apply_sharded(p: Attention, x: torch.Tensor, cfg, mask: dict,
                   positions: Optional[torch.Tensor],
                   use_rope: bool) -> torch.Tensor:
    """``attention_apply`` on the model axis: head-parallel, or
    context-parallel (see the module's docstring).  One flash launch."""
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)
    if p.seq_parallel:
        w, _ = parallel.model_axis(p.mesh)
        blocks = [block(s, w, i) for i in range(w)]
        lo, hi = blocks[p.mesh.coords["model"]]
        q = _rope(_q_local(p, x[:, lo:hi]), positions[lo:hi], cfg, use_rope)
        k, v = _kv_local(p, x)
        k = _rope(k, positions, cfg, use_rope)
        out = seq_ops.flash_attention(q, k, v, q_offset=lo, **mask)
        return parallel.all_gather_ragged(p.mesh, _out(p, out),
                                          [b - a for a, b in blocks],
                                          "model", dim=1)
    q = _rope(_q_local(p, x), positions, cfg, use_rope)
    k, v = _kv_local(p, x)
    k, v = _expanded(p, _rope(k, positions, cfg, use_rope), v)
    return _out_sharded(p, seq_ops.flash_attention(q, k, v, **mask))


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
    if p.mesh is not None:
        return _apply_sharded(p, x, cfg, _mask_kw(mask_kind, cfg, prefix_len),
                              positions, use_rope)
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
    ``Transformer.prefill_prefix``.  Returns (B, P, d).  On the model axis
    a rank writes the part of [0, P) that lies in its slots and runs flash
    on its heads (every head where they stay whole)."""
    p_len = x.shape[1]
    if p.mesh is not None:
        return _prefill_cache_sharded(p, x, cfg, cache, use_rope)
    q, k, v = _rotated_qkv(p, x, cfg, None, use_rope)
    cache["k"][:, :p_len] = k.to(cache["k"].dtype)
    cache["v"][:, :p_len] = v.to(cache["v"].dtype)
    out = seq_ops.flash_attention(q, k, v, causal=True, prefix_len=p_len)
    return _out(p, out)


def _prefill_cache_sharded(p: Attention, x: torch.Tensor, cfg,
                           cache: Dict[str, torch.Tensor],
                           use_rope: bool) -> torch.Tensor:
    p_len = x.shape[1]
    positions = torch.arange(p_len, device=x.device)
    k_all, v_all = _kv_all(p, x, positions, cfg, use_rope)
    size_l = cache["k"].shape[1]
    c0 = 0 if _whole_slots(cache["k"]) else p.mesh.coords["model"] * size_l
    a, b = min(max(c0, 0), p_len), min(c0 + size_l, p_len)
    if b > a:
        cache["k"][:, a - c0:b - c0] = k_all[:, a:b].to(cache["k"].dtype)
        cache["v"][:, a - c0:b - c0] = v_all[:, a:b].to(cache["v"].dtype)
    q = _rope(_q_local(p, x), positions, cfg, use_rope)
    if p.head_parallel:
        k, v = _kv_local(p, x)
        k, v = _expanded(p, _rope(k, positions, cfg, use_rope), v)
    else:
        k, v = k_all, v_all
    out = seq_ops.flash_attention(q, k, v, causal=True, prefix_len=p_len)
    return _out_sharded(p, out)


def cache_slots(cfg, size: int, mesh, what: str) -> int:
    """This rank's slots of a K/V cache of ``size`` slots: size / W where
    the model axis of W ranks divides it (``sharding.cache_spec``'s
    sequence split), else all of them where W divides neither dh nor the
    KV heads (the placement ``cache_spec`` falls through to); its dh and
    heads placements raise, naming them."""
    w, _ = parallel.model_axis(mesh)
    if size % w == 0:
        return size // w
    for dim, n in (("dh", cfg.d_head), ("heads", cfg.n_kv_heads)):
        if n % w == 0:
            raise ValueError(
                f"{cfg.name}: {what} of {size} slots does not split over "
                f"the model axis of {w} ranks; sharding.cache_spec would "
                f"split its {dim} ({n}), which is not ported")
    return size


def init_cache(cfg, batch: int, cache_len: int, mask_kind: str,
               device, mesh=None) -> Dict[str, torch.Tensor]:
    """A decode KV cache for one layer: a ring buffer of ``window`` slots
    for ``sliding`` layers and of ``attn_chunk`` for ``chunked`` ones (at
    most ``cache_len``), ``cache_len`` slots for ``global`` and ``prefix``
    ones.  With a ``mesh`` whose model axis has W > 1 ranks, this rank's
    slots (``cache_slots``)."""
    _check_kind(mask_kind)
    if mask_kind == "sliding":
        size = min(cfg.window, cache_len)
    elif mask_kind == "chunked":
        size = min(cfg.attn_chunk, cache_len)
    else:
        size = cache_len
    shape = (batch, cache_slots(cfg, size, mesh, f"a {mask_kind} layer's "
                                "cache"), cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.kv_cache_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.kv_cache_dtype, device=device)}


def _whole_slots(leaf: torch.Tensor) -> bool:
    """Whether a layer's cache leaf is whole on every model rank (its
    ``model_split`` tag None; an untagged leaf is split by slots)."""
    return getattr(leaf, "model_split", 1) is None


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
    if p.mesh is not None:
        return _decode_sharded(p, x, cfg, cache, index, mask_kind, use_rope,
                               prefix_len)
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
    k_pos, k_valid = _slot_positions(torch.arange(size, device=dev), size,
                                     index, mask_kind, cfg)
    out = _sdpa(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), pos,
                k_pos, k_valid,
                prefix_len if mask_kind == "prefix" else 0)
    return _out(p, out), cache


def _slot_positions(slots: torch.Tensor, size: int, index: int,
                    mask_kind: str, cfg
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The absolute position each cache slot (a global slot index of a
    cache of ``size``) holds at step ``index``, and whether it is visible:
    keys are cached post-RoPE."""
    k_valid = slots < min(index + 1, size)
    if mask_kind == "chunked":
        # a ring of the chunk's size: only the current chunk's slots are
        # visible (the reference takes the ring's size as the chunk)
        slot_pos = (index // size) * size + slots
        return slot_pos, k_valid & (slot_pos <= index)
    if mask_kind == "sliding":
        # slot holds the absolute position p with p % size == slot, p <= index
        cand = (index // size) * size + slots
        k_pos = torch.where(cand <= index, cand, cand - size)
        return k_pos, k_valid & (k_pos > index - cfg.window) & (k_pos >= 0)
    return slots, k_valid


def _decode_sharded(p: Attention, x: torch.Tensor, cfg,
                    cache: Dict[str, torch.Tensor], index: int,
                    mask_kind: str, use_rope: bool, prefix_len: int
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``attention_decode`` on the model axis over this rank's slots."""
    mesh, dev = p.mesh, x.device
    w, r = parallel.model_axis(mesh)
    pos = torch.full((1,), index, dtype=torch.int64, device=dev)
    q = _rope(_q_local(p, x), pos, cfg, use_rope)
    if p.kv_split:        # (W divides KV, so it divides H): one gather
        k, v = _kv_local(p, x)
        q, k, v = _gather_heads(mesh, q, _rope(k, pos, cfg, use_rope), v)
    else:
        if p.head_parallel:
            q = mesh.all_gather(q, "model", dim=2)
        k, v = _kv_all(p, x, pos, cfg, use_rope)
    size_l = cache["k"].shape[1]
    whole = _whole_slots(cache["k"])
    size, c0 = (size_l, 0) if whole else (size_l * w, r * size_l)
    slot = index % size
    if c0 <= slot < c0 + size_l:
        cache["k"][:, slot - c0] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot - c0] = v[:, 0].to(cache["v"].dtype)
    k_pos, k_valid = _slot_positions(
        c0 + torch.arange(size_l, device=dev), size, index, mask_kind, cfg)
    plen = prefix_len if mask_kind == "prefix" else 0
    if whole:
        out = _sdpa(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), pos,
                    k_pos, k_valid, plen)
    else:
        allowed = ((k_pos[None, :] <= pos[:, None])
                   | (k_pos[None, :] < plen)) & k_valid[None, :]
        out = _merged(mesh, q, cache["k"], cache["v"], allowed)
    if p.head_parallel:
        out = out[:, :, p.heads[0]:p.heads[1]]
    return _out_sharded(p, out), cache


def _merged(mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            allowed: torch.Tensor) -> torch.Tensor:
    """q (B, Q, H, Dh) over this rank's block of slots k/v (B, n, KV, Dh)
    where ``allowed`` (Q, n): the partial softmax merged over `model` in
    float32 -- the all-reduced max, then the rescaled sums of exp and
    exp·v (a rank without a visible slot adds exact zeros)."""
    b, qlen, h, dh = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, qlen, kv, h // kv, dh)
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg * dh ** -0.5,
                          k.to(q.dtype)).float()
    masked = torch.where(allowed, logits, NEG_INF)
    m = mesh.all_reduce(masked.amax(dim=-1, keepdim=True), "model", "max")
    e = torch.where(allowed, torch.exp(masked - m), 0.0)
    o = torch.einsum("bhgqs,bshk->bhgqk", e, v.float())
    sums = mesh.all_reduce(torch.cat([o, e.sum(dim=-1, keepdim=True)], -1),
                           "model")
    out = (sums[..., :dh] / sums[..., dh:]).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, qlen, h, dh)


def bidirectional_attention_apply(p: Attention, x: torch.Tensor, cfg, *,
                                  use_rope: bool = True) -> torch.Tensor:
    """Unmasked self-attention (whisper's encoder, which passes
    ``use_rope=False``) through the flash kernel.  x (B, S, d) ->
    (B, S, d); head-parallel on a model axis that divides the heads."""
    if p.mesh is not None and p.head_parallel:
        return _apply_sharded(p, x, cfg, dict(causal=False), None, use_rope)
    q, k, v = _rotated_qkv(p, x, cfg, None, use_rope)
    return _out(p, seq_ops.flash_attention(q, k, v, causal=False))


def cross_kv(p: Attention, kv_src: torch.Tensor, dtype: torch.dtype
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output (B, F, d), in ``dtype``, projected to k and v (B,
    F, KV, Dh), each with its bias: what ``cross_attention_apply`` attends
    to and what a decode cache holds.  On a model axis every KV head on
    every rank (the ranks' heads gathered where wk/wv are split)."""
    src = kv_src.to(dtype)
    if p.mesh is not None and p.kv_split:
        return _gather_heads(p.mesh, *_kv_heads(p, src))
    return (_heads(src, p.wk, p.bk if p.qkv_bias else None),
            _heads(src, p.wv, p.bv if p.qkv_bias else None))


def _cross_q(p: Attention, x: torch.Tensor) -> torch.Tensor:
    """The q heads of x: the rank's on a head-parallel model axis."""
    if p.mesh is not None and p.head_parallel:
        h0, h1 = p.heads
        return _heads(x, p.wq, p.bq[h0:h1] if p.qkv_bias else None)
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(x.dtype))
    return q + p.bq.to(x.dtype) if p.qkv_bias else q


def cross_attention_apply(p: Attention, x: torch.Tensor,
                          kv_src: torch.Tensor, cfg) -> torch.Tensor:
    """Encoder-decoder cross-attention (whisper): queries from x (B, S, d),
    keys and values from the encoder output (B, F, d), no mask, no RoPE, no
    q/k norm, through the flash kernel with F keys.  -> (B, S, d); the
    output projection has no bias.  Head-parallel on a model axis that
    divides the heads (the rank's q and KV heads, ``wo`` row-parallel).
    ``cfg`` is unread (the reference's signature)."""
    if p.mesh is not None and p.head_parallel:
        k, v = _expanded(p, *_kv_heads(p, kv_src.to(x.dtype)))
        out = seq_ops.flash_attention(_cross_q(p, x), k, v, causal=False)
        return _out_sharded(p, out)
    k, v = cross_kv(p, kv_src, x.dtype)
    out = seq_ops.flash_attention(_cross_q(p, x), k, v, causal=False)
    return _out(p, out)


def cross_decode(p: Attention, x: torch.Tensor, ck: torch.Tensor,
                 cv: torch.Tensor) -> torch.Tensor:
    """One decode step's cross-attention over the cached frames' K/V (B, F,
    KV, Dh), plain, as the reference's ``encdec._cross_decode``: x (B, 1,
    d) -> (B, 1, d).  On a model axis the step's q heads are gathered and
    each rank's block of the frames (unless the cache is whole) gives a
    partial softmax merged over `model`; the rank's heads go through its
    block of ``wo``."""
    q = _cross_q(p, x)
    if p.mesh is not None:
        if p.head_parallel:
            q = p.mesh.all_gather(q, "model", dim=2)
        if _whole_slots(ck):
            out = _cross_sdpa(q, ck, cv)
        else:
            allowed = torch.ones((q.shape[1], ck.shape[1]), dtype=torch.bool,
                                 device=x.device)
            out = _merged(p.mesh, q, ck, cv, allowed)
        if p.head_parallel:
            out = out[:, :, p.heads[0]:p.heads[1]]
        return _out_sharded(p, out)
    return _out(p, _cross_sdpa(q, ck, cv))


def _cross_sdpa(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor
                ) -> torch.Tensor:
    """q (B, S, H, Dh) over every cached frame, unmasked, plain."""
    b, s, h, dh = q.shape
    kvh = ck.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, dh)
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg * dh ** -0.5,
                          ck.to(q.dtype)).float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqs,bshk->bqhgk", probs, cv.to(q.dtype))
    return out.reshape(b, s, h, dh)

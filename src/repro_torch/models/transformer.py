"""Block-assembly decoder of the substrate.

The port of the reference's ``models/transformer.py``: an architecture is a
pattern unit of (sequence mixer, ffn) pairs repeated over the layers
(``compute_stages``).  Mixers: ``attn`` (causal global, NoPE where
``rope_on_global`` is off, prefix-LM over a multimodal prefix), ``swa``
(sliding window), ``chunked`` (llama4's chunked local attention), ``rec``
(RG-LRU), ``mlstm`` and ``slstm`` (xLSTM, ``models/xlstm.py``); FFNs:
``dense`` (the MLP, gated or not, with or without biases), ``moe``
(``models/moe.py``) and ``none`` (no norm2, no FFN: xLSTM's blocks carry
their own projections); RMSNorm or LayerNorm; a tied or untied embedding;
attention with or without QKV bias and per-head q/k RMSNorm -- what every
decoder-only architecture of the reference runs.  The layers are
``nn.Module``s in layer order; the decode cache keeps the reference's dict
layout (``stage_<i>`` → unit position → leaves stacked over the stage's
repetitions), the xLSTM blocks' tuples as named leaves
(``models/xlstm.py``).

With ``cfg.remat`` (every full-size config; ``reduced()`` turns it off)
and autograd recording a weight's gradient, each unit -- one repetition
of a stage's pattern, the reference's scan body -- runs through a
non-reentrant ``torch.utils.checkpoint``, as the reference wraps it in
``jax.checkpoint(..., policy=nothing_saveable)``: only the unit
boundaries are kept, and the backward recomputes each unit's forward, so
a unit's kernel forwards launch twice a train step.  Serving (no
gradient) runs as without.

With a ``launch.mesh.Mesh2D`` (``mesh=``) the decoder serves across ranks
on the reference's ``("data", "model")`` partition (``sharding.rules``,
placed with ``fsdp=False``): on the model axis attention is head- or
context-parallel (``models/attention.py``), the MLP column-parallel over
``d_ff`` (``w_in``, ``w_gate``, ``b_in``) and row-parallel (``w_out``,
summed over ``model``, ``b_out`` added once after), the MoE
expert-parallel or split over ``moe_d_ff`` (``models/moe.py``), the
embedding and output tables split by vocab (a lookup's rows summed, the
logits gathered) or by ``d_model`` (gathered, partial logits summed);
norms are whole.  The data axis splits the batch: ``hidden``, ``apply``,
``decode_step`` and ``prefill_prefix`` take the whole batch and return
it, each data rank running its rows, and ``init_cache`` gives each rank
its rows and slots.  A model built for training (``fsdp=True``) holds
each weight's FSDP block too and gathers a block's weights over
``data`` at its entry (``parallel.gathered``); ``loss_fn`` reduces the
ranks' rows' cross entropy over ``data`` without gathering the logits.
The recurrent mixers split as ``models/rglru.py`` and
``models/xlstm.py`` say, and their caches hold what the mixer holds on
the rank.  No mesh, or a mesh of one, runs the unsharded bodies.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, moe, parallel, rglru, \
    xlstm

Cache = Dict[str, Dict[str, Dict[str, torch.Tensor]]]

ATTENTION_KINDS = ("attn", "swa", "chunked")
MASK_FOR_KIND = {"attn": "global", "swa": "sliding", "chunked": "chunked"}
RECURRENT = {"rec": (rglru.RGLRU, rglru.rglru_block_apply,
                     rglru.rglru_block_decode, rglru.init_cache),
             "mlstm": (xlstm.MLSTM, xlstm.mlstm_block_apply,
                       xlstm.mlstm_block_decode, xlstm.mlstm_init_cache),
             "slstm": (xlstm.SLSTM, xlstm.slstm_block_apply,
                       xlstm.slstm_block_decode, xlstm.slstm_init_cache)}
FFN_KINDS = ("dense", "moe", "none")


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


def remat_active(model: nn.Module) -> bool:
    """Whether ``model``'s forward checkpoints its units: ``cfg.remat`` set,
    autograd recording, and some weight requiring a gradient."""
    return (model.cfg.remat and torch.is_grad_enabled()
            and any(p.requires_grad for p in model.parameters()))


def run_unit(fn, remat: bool, *args):
    """``fn(*args)``; with ``remat`` through a non-reentrant
    ``torch.utils.checkpoint``, which keeps none of the unit's activations
    and recomputes its forward in the backward."""
    if remat:
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def init_cache(cfg, batch: int, cache_len: int, device, mesh=None) -> Cache:
    """Zero decode caches of a decoder for ``cfg`` on ``device`` (``meta``
    gives their shapes and dtypes alone): ``stage_<i>`` → unit position →
    leaves stacked over the stage's repetitions.  With a ``mesh``, this
    rank's block of each leaf: its data rank's rows of the batch, of an
    attention cache its model rank's slots (``sharding.cache_spec``), of
    a recurrent one what the mixer holds on the rank (its channels or
    heads).  Each leaf's ``model_split`` names the dim the model axis
    splits, or None."""
    if parallel.active(mesh):
        lo, hi = parallel.data_rows(mesh, batch)
        batch = hi - lo
    pat = tuple(zip(cfg.block_pattern, cfg.ffn_pattern))
    cache: Cache = {}
    for si, (unit, reps) in enumerate(compute_stages(cfg.n_layers, pat)):
        unit_cache = {}
        for i, (kind, _) in enumerate(unit):
            one = (attention.init_cache(cfg, batch, cache_len,
                                        MASK_FOR_KIND[kind], device, mesh)
                   if kind in ATTENTION_KINDS
                   else RECURRENT[kind][3](cfg, batch, device, mesh))
            whole = (attention.init_cache(cfg, batch, cache_len,
                                          MASK_FOR_KIND[kind], "meta")
                     if kind in ATTENTION_KINDS
                     else RECURRENT[kind][3](cfg, batch, "meta"))
            unit_cache[str(i)] = {
                k: parallel.tagged(torch.zeros(
                    (reps,) + v.shape, dtype=v.dtype, device=device),
                    whole[k].shape, v.shape, lead=1)
                for k, v in one.items()}
        cache[f"stage_{si}"] = unit_cache
    return cache


class MLP(nn.Module):
    """w_in (d, d_ff), w_out (d_ff, d), with ``cfg.gated_mlp`` w_gate (d,
    d_ff), and with ``cfg.mlp_bias`` the zero biases b_in (d_ff,) and b_out
    (d,): drawn in the reference's ``mlp_init`` order."""

    def __init__(self, cfg, device, generator, mesh=None):
        super().__init__()
        d, ff, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
        weights = [("w_in", (d, ff), d), ("w_out", (ff, d), ff)]
        if cfg.gated_mlp:
            weights.append(("w_gate", (d, ff), d))
        for name, shape, fan_in in weights:
            self.register_parameter(name, layers.param(
                shape, dt, device, generator,
                lambda shape=shape, fan_in=fan_in: layers.scaled_init(
                    shape, generator, dt, fan_in=fan_in),
                name=name, mesh=mesh))
        if not cfg.gated_mlp:
            self.w_gate = None
        for name, n in (("b_in", ff), ("b_out", d)):
            self.register_parameter(name, layers.param(
                (n,), dt, device, generator,
                lambda n=n: torch.zeros((n,), dtype=dt,
                                        device=generator.device))
                if cfg.mlp_bias else None)
        self.activation = cfg.activation
        # this rank's block of d_ff where the model axis splits it
        dim, lo, hi = parallel.local_block("w_in", (d, ff), mesh)
        self.mesh = mesh if dim is not None else None
        self.ff_block = (lo, hi)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh is not None:
            lo, hi = self.ff_block
            part = layers.mlp_apply(
                self.w_in, self.w_gate, self.w_out, x,
                activation=self.activation,
                b_in=None if self.b_in is None else self.b_in[lo:hi])
            out = parallel.sum_model(self.mesh, part)
            return out if self.b_out is None else \
                out + self.b_out.to(out.dtype)
        return layers.mlp_apply(self.w_in, self.w_gate, self.w_out, x,
                                activation=self.activation, b_in=self.b_in,
                                b_out=self.b_out)


class Block(nn.Module):
    """norm1 → mixer (attention, ``rec``, ``mlstm`` or ``slstm``) →
    residual → norm2 → FFN (the MLP, or the MoE for a ``moe`` ffn kind) →
    residual; a ``none`` ffn kind has neither norm2 nor FFN."""

    def __init__(self, cfg, kind: str, ffn_kind: str, device, generator,
                 mesh=None):
        super().__init__()
        if kind not in ATTENTION_KINDS and kind not in RECURRENT:
            raise ValueError(f"unknown sequence mixer {kind!r}")
        if ffn_kind not in FFN_KINDS:
            raise ValueError(f"unknown ffn kind {ffn_kind!r}")
        self.kind, self.ffn_kind = kind, ffn_kind
        self.norm1 = layers.Norm(cfg.norm, cfg.d_model, cfg.param_dtype,
                                 device, generator)
        if kind in ATTENTION_KINDS:
            self.attn = attention.Attention(cfg, device=device,
                                            generator=generator, mesh=mesh)
        else:
            # named as the reference's pytree: rec, mlstm or slstm
            self.add_module(kind, RECURRENT[kind][0](
                cfg, device=device, generator=generator, mesh=mesh))
        if ffn_kind == "none":
            return
        self.norm2 = layers.Norm(cfg.norm, cfg.d_model, cfg.param_dtype,
                                 device, generator)
        if ffn_kind == "moe":
            self.moe = moe.MoE(cfg, device=device, generator=generator,
                               mesh=mesh)
        else:
            self.mlp = MLP(cfg, device, generator, mesh)

    def mixer(self, h: torch.Tensor) -> torch.Tensor:
        """A recurrent mixer's full-sequence forward."""
        return RECURRENT[self.kind][1](getattr(self, self.kind), h)

    def mixer_decode(self, h: torch.Tensor, cache: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """A recurrent mixer's decode step: (y, its new cache leaves)."""
        return RECURRENT[self.kind][2](getattr(self, self.kind), h, cache)

    def ffn(self, x: torch.Tensor, cfg, batch: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x + FFN(norm2(x)), and the MoE aux (None for a dense FFN); x
        itself for a ``none`` FFN.  ``batch``: the whole batch's rows when
        x holds a data rank's (the MoE routes the whole batch)."""
        if self.ffn_kind == "none":
            return x, None
        h = self.norm2(x)
        if self.ffn_kind == "moe":
            y, aux = self.moe(h, cfg, batch)
            return x + y, aux
        return x + self.mlp(h), None

    def mask_kind(self, prefix_len: int) -> str:
        """The attention mask of this layer: a global layer takes the
        prefix-LM mask while there is a prefix, as the reference's."""
        if self.kind == "attn" and prefix_len > 0:
            return "prefix"
        return MASK_FOR_KIND[self.kind]

    def use_rope(self, cfg) -> bool:
        return cfg.rope_on_global if self.kind == "attn" else True


class Transformer(nn.Module):
    """Decoder-only model with its weights on ``device``.

    ``generator``: draw the weights from it (on its device, which must be
    ``device``) with the reference's init distributions; ``None`` leaves
    them unset for ``convert.params_from_numpy`` or ``load_state_dict``.
    ``mesh``: a ``launch.mesh.Mesh2D`` to serve across (this rank's blocks
    of the weights; see the module's docstring); None or a mesh of one is
    the unsharded model.  ``fsdp``: place the weights for training (each
    also split over ``data`` by its rule's FSDP dim).
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
        pat = tuple(zip(cfg.block_pattern, cfg.ffn_pattern))
        self.stages = compute_stages(cfg.n_layers, pat)
        table = (cfg.vocab_size, cfg.d_model)
        self.embedding = layers.param(
            table, cfg.param_dtype, dev, generator,
            lambda: layers.normal_init(table, generator, cfg.param_dtype),
            name="embedding", mesh=mesh)
        # an untied output table, drawn after the input one (the reference
        # draws it from the embedding key's second split)
        self.unembedding = None if cfg.tie_embeddings else layers.param(
            table, cfg.param_dtype, dev, generator,
            lambda: layers.normal_init(table, generator, cfg.param_dtype),
            name="unembedding", mesh=mesh)
        # the tables' split over `model` (both take the same rule): 0 by
        # vocab, 1 by d_model, None whole
        self.table_split = parallel.split_dim("embedding", table, mesh)
        self.final_norm = layers.Norm(cfg.norm, cfg.d_model,
                                      cfg.param_dtype, dev, generator)
        blocks, where, spans = [], [], []
        for si, (unit, reps) in enumerate(self.stages):
            for r in range(reps):
                spans.append((len(blocks), len(blocks) + len(unit)))
                for i, (kind, ffn_kind) in enumerate(unit):
                    blocks.append(Block(cfg, kind, ffn_kind, dev, generator,
                                        mesh))
                    where.append((f"stage_{si}", r, str(i)))
        self.blocks = nn.ModuleList(blocks)
        # (stage key, repetition, unit position) of each block, in order
        self.block_index = where
        # [start, end) of each unit's blocks, in order: what remat wraps
        self.unit_spans = spans
        # sqrt(d) rounded to the compute dtype, as the reference's
        # jnp.asarray(d ** 0.5, x.dtype): a product with it is bit-equal to
        # one with that 0-d tensor, without a host-to-device copy a call
        self.embed_scale = float(torch.tensor(
            cfg.d_model ** 0.5, dtype=cfg.compute_dtype)) \
            if cfg.embed_scale else None

    # -- forward (train / prefill) -------------------------------------------

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = parallel.embed(self.embedding, self.table_split, self.mesh,
                           tokens, self.cfg.compute_dtype)
        if self.embed_scale is not None:
            x = x * self.embed_scale
        return x

    def _forward(self, tokens: torch.Tensor,
                 extra_embeddings: Optional[torch.Tensor],
                 batch: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The final-normed hidden states of the text positions and the sum
        of the MoE layers' aux (0 without one); ``tokens`` this rank's
        rows of a batch of ``batch`` rows (default: all of them)."""
        cfg = self.cfg
        x = self._embed(tokens)
        prefix_len = 0
        if extra_embeddings is not None:
            # the (unscaled) prefix goes in front of the text
            prefix_len = extra_embeddings.shape[1]
            x = torch.cat([extra_embeddings.to(x.dtype), x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = remat_active(self)
        for start, end in self.unit_spans:
            x, aux = run_unit(self._unit_apply, remat, start, end, x, aux,
                              positions, prefix_len, batch)
        return self.final_norm(x)[:, prefix_len:], aux

    def _unit_apply(self, start: int, end: int, x: torch.Tensor,
                    aux: torch.Tensor, positions: torch.Tensor,
                    prefix_len: int, batch: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Blocks [start, end) over x, the MoE aux carried in and out as
        the reference's scan carry (x, aux)."""
        cfg = self.cfg
        for blk in self.blocks[start:end]:
            with parallel.gathered(self.mesh, blk):
                h = blk.norm1(x)
                if blk.kind in ATTENTION_KINDS:
                    y = attention.attention_apply(
                        blk.attn, h, cfg, mask_kind=blk.mask_kind(prefix_len),
                        positions=positions, use_rope=blk.use_rope(cfg),
                        prefix_len=prefix_len)
                else:
                    y = blk.mixer(h)
                x, inc = blk.ffn(x + y, cfg, batch)
            if inc is not None:
                aux = aux + inc
        return x, aux

    def hidden(self, tokens: torch.Tensor,
               extra_embeddings: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """tokens (B, S) [+ a prefix of embeddings (B, P, d)] -> the
        final-normed hidden states of the text positions (B, S, d)."""
        mesh, batch = self.mesh, tokens.shape[0]
        parallel.posted(mesh, "hidden", lambda: _check_tokens(tokens))
        x = self.local_hidden(tokens, extra_embeddings)[0]
        return parallel.unrows(mesh, x, batch)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., d) -> logits (..., V), every vocab entry on every rank
        (``parallel.unembed``)."""
        return parallel.unembed(self.output_table, self.table_split,
                                self.mesh, x)

    def apply(self, tokens: torch.Tensor,
              extra_embeddings: Optional[torch.Tensor] = None, *,
              with_aux: bool = False
              ) -> "torch.Tensor | Tuple[torch.Tensor, torch.Tensor]":
        """tokens (B, S) [+ prefix embeddings (B, P, d), attended with the
        prefix-LM mask] -> logits (B, S, V) of the text positions; with
        ``with_aux`` also the MoE aux loss (a 0-d float32), as the
        reference's ``apply`` returns it."""
        mesh, batch = self.mesh, tokens.shape[0]
        parallel.posted(mesh, "apply", lambda: _check_tokens(tokens))
        x, aux = self.local_hidden(tokens, extra_embeddings)
        logits = parallel.unrows(mesh, self.unembed(x), batch)
        return (logits, aux) if with_aux else logits

    def local_hidden(self, tokens: torch.Tensor,
                     extra_embeddings: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The final-normed hidden states of this rank's rows of the batch
        (all of them without a mesh, or where the data axis does not
        divide it) and the whole batch's MoE aux; the inputs are not
        checked."""
        mesh, batch = self.mesh, tokens.shape[0]
        return self._forward(parallel.rows(mesh, tokens),
                             parallel.rows(mesh, extra_embeddings), batch)

    @property
    def output_table(self) -> torch.Tensor:
        """The (V, d) table the logits are taken against (the tied
        embedding or the untied output table): this rank's block."""
        return self.embedding if self.unembedding is None \
            else self.unembedding

    # -- decode ---------------------------------------------------------------

    def init_cache(self, batch: int, cache_len: int) -> Cache:
        """Zero decode caches for ``batch`` requests of ``cache_len``
        positions; with a mesh, this rank's block of them."""
        return init_cache(self.cfg, batch, cache_len, self.device, self.mesh)

    def prefill_prefix(self, cache: Cache, embeddings: torch.Tensor
                       ) -> Cache:
        """The multimodal prefix (B, P, d) through the stack with the
        prefix-LM mask -- over the prefix alone, full attention, in the
        flash kernel -- each attention layer's post-RoPE K/V written into
        its cache slots [0, P) in place; decoding then starts at index P
        with ``prefix_len=P``.  Attention mixers only, as the reference's
        (the VLM config has no other)."""
        cfg = self.cfg
        batch = embeddings.shape[0]
        parallel.posted(self.mesh, "prefill_prefix",
                        lambda: _check_cache(self, cache, batch))
        x = parallel.rows(self.mesh, embeddings).to(cfg.compute_dtype)
        for blk, (stage, r, pos) in zip(self.blocks, self.block_index):
            if blk.kind not in ATTENTION_KINDS:
                raise ValueError(f"{cfg.name}: prefix prefill takes "
                                 f"attention mixers only, not {blk.kind!r}")
            leaves = cache[stage][pos]
            with parallel.gathered(self.mesh, blk):
                y = attention.attention_prefill_cache(
                    blk.attn, blk.norm1(x), cfg,
                    {k: parallel.layer_view(v, r) for k, v in leaves.items()},
                    use_rope=blk.use_rope(cfg))
                x, _ = blk.ffn(x + y, cfg, batch)
        return cache

    def decode_step(self, token: torch.Tensor, cache: Cache,
                    index: "int | torch.Tensor", *, prefix_len: int = 0
                    ) -> Tuple[torch.Tensor, Cache]:
        """token (B, 1) + cache + the token's position -> (logits (B, 1, V),
        cache); ``prefix_len`` the multimodal prefix's length (global layers
        take the prefix-LM mask).  The cache is updated in place (no copy a
        step) and returned."""
        cfg = self.cfg
        index = int(index)
        batch = token.shape[0]

        def check():
            _check_tokens(token)
            _check_cache(self, cache, batch)
        parallel.posted(self.mesh, "decode_step", check)
        x = self._embed(parallel.rows(self.mesh, token))
        for blk, (stage, r, pos) in zip(self.blocks, self.block_index):
            leaves = cache[stage][pos]
            layer_cache = {k: parallel.layer_view(v, r)
                           for k, v in leaves.items()}
            with parallel.gathered(self.mesh, blk):
                h = blk.norm1(x)
                if blk.kind in ATTENTION_KINDS:
                    y, _ = attention.attention_decode(
                        blk.attn, h, cfg, layer_cache, index,
                        mask_kind=blk.mask_kind(prefix_len),
                        use_rope=blk.use_rope(cfg), prefix_len=prefix_len)
                else:
                    y, new = blk.mixer_decode(h, layer_cache)
                    for k, v in new.items():
                        leaves[k][r].copy_(v)
                x, _ = blk.ffn(x + y, cfg, batch)
        logits = self.unembed(self.final_norm(x))
        return parallel.unrows(self.mesh, logits, batch), cache


def _check_tokens(tokens: torch.Tensor) -> None:
    if tokens.dim() != 2 or tokens.is_floating_point():
        raise ValueError(f"tokens must be (B, S) integers, got "
                         f"{tuple(tokens.shape)} {tokens.dtype}")


def _check_cache(model: "Transformer", cache: Cache, batch: int) -> None:
    """A cache of ``model.init_cache(batch, ...)``'s rows on this rank."""
    lo, hi = parallel.data_rows(model.mesh, batch)
    for stage in cache.values():
        for leaves in stage.values():
            for name, leaf in leaves.items():
                if leaf.shape[1] != hi - lo:
                    raise ValueError(f"a cache of {leaf.shape[1]} rows "
                                     f"({name}) for {hi - lo} of a batch of "
                                     f"{batch}")


def loss_fn(model: nn.Module, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """Next-token cross entropy + the MoE aux loss, weighted by
    ``cfg.moe_aux_weight`` (the reference's ``loss_fn``), of a
    ``Transformer`` or an ``EncDecTransformer`` (whose aux is 0): ``batch``
    holds ``tokens`` and ``labels`` (B, S), optionally ``embeddings`` (a
    VLM's prefix or an encoder-decoder's frames) and ``loss_mask`` (B, S).

    On a mesh each rank takes the cross entropy of its rows only, and of
    a table split by vocab without gathering the logits
    (``parallel.vocab_nll``): the masked sum of its rows' token losses is
    summed over ``data`` (where the data axis splits the batch;
    differentiable), then divided by the mask's count summed the same way
    (a constant); the whole batch's aux is added once.  Every rank
    returns the same loss, bit for bit."""
    mesh = model.mesh
    if mesh is None:
        logits, aux = model.apply(batch["tokens"], batch.get("embeddings"),
                                  with_aux=True)
        loss = layers.softmax_cross_entropy(logits, batch["labels"],
                                            batch.get("loss_mask"))
        return loss + model.cfg.moe_aux_weight * aux
    rows = batch["tokens"].shape[0]
    x, aux = model.local_hidden(batch["tokens"], batch.get("embeddings"))
    nll = parallel.vocab_nll(model.output_table, model.table_split, mesh, x,
                             parallel.rows(mesh, batch["labels"]))
    mask = parallel.rows(mesh, batch.get("loss_mask"))
    mask = torch.ones_like(nll) if mask is None else mask.float()
    total, count = torch.sum(nll * mask), torch.sum(mask)
    if parallel.data_rows(mesh, rows) != (0, rows):
        total = parallel.all_reduce(mesh, total, "data")
        count = mesh.all_reduce(count.detach(), "data")
    loss = total / torch.clamp(count, min=1.0)
    return loss + model.cfg.moe_aux_weight * aux

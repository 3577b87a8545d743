"""Architecture configs of the model substrate.

``ArchConfig`` is a frozen dataclass describing one architecture, field for
field the reference package's ``configs/base.py::ArchConfig``; dtypes stay
strings (hashable) and map to torch dtypes through the ``*_dtype``
properties.  ``reduced()`` is the same smoke-test cut as the reference's.
``input_specs`` gives the (shape, dtype) of every model input of an
(arch × input shape) pair without allocating (the reference's
``ShapeDtypeStruct`` stand-ins); ``param_count`` and
``active_param_count`` are the analytic counts of ``_counting``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                       # dense|moe|ssm|hybrid|vlm|audio
    source: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # layer pattern (repeating unit); ffn_pattern must match its length
    block_pattern: Tuple[str, ...] = ("attn",)
    ffn_pattern: Tuple[str, ...] = ("dense",)
    # attention details
    d_head: int = 0                      # 0 -> d_model // n_heads
    window: int = 0                      # sliding-window width ("swa" layers)
    attn_chunk: int = 0                  # chunk size ("chunked" layers)
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_seq_shard: bool = False
    rope_theta: float = 10_000.0
    rope_on_global: bool = True          # False => NoPE on "attn" layers
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # recurrent
    rnn_width: int = 0                   # 0 -> d_model
    # misc
    norm: str = "rmsnorm"
    activation: str = "silu"
    gated_mlp: bool = True
    mlp_bias: bool = False
    tie_embeddings: bool = True
    embed_scale: bool = False            # gemma-style sqrt(d) embed scaling
    # enc-dec / multimodal stubs
    encoder_layers: int = 0
    prefix_tokens: int = 0
    stub_frames: int = 0
    # numerics / memory policy
    param_dtype_str: str = "float32"
    compute_dtype_str: str = "bfloat16"
    opt_dtype_str: str = "float32"
    kv_cache_dtype_str: str = ""         # "" -> compute dtype
    remat: bool = True
    grad_accum: int = 1
    scan_layers: bool = True
    supports_long_context: bool = False
    long_context_note: str = ""

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if len(self.block_pattern) != len(self.ffn_pattern):
            raise ValueError(f"{self.name}: block and ffn patterns differ in "
                             f"length")
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"{self.name}: n_kv_heads must divide n_heads")

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype_str)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype_str)

    @property
    def opt_dtype(self) -> torch.dtype:
        return getattr(torch, self.opt_dtype_str)

    @property
    def kv_cache_dtype(self) -> torch.dtype:
        return getattr(torch, self.kv_cache_dtype_str
                       or self.compute_dtype_str)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: ≤2 pattern units, d_model≤256, ≤4 experts."""
        unit = len(self.block_pattern)
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = min(self.n_kv_heads, n_heads)
        kw: Dict[str, Any] = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, max(2, unit)),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=max(1, n_kv if n_heads % n_kv == 0 else 1),
            d_head=d_model // n_heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            window=min(self.window, 32) if self.window else 0,
            attn_chunk=min(self.attn_chunk, 32) if self.attn_chunk else 0,
            rnn_width=min(self.rnn_width, d_model) if self.rnn_width else 0,
            encoder_layers=min(self.encoder_layers, 2),
            prefix_tokens=min(self.prefix_tokens, 8),
            stub_frames=min(self.stub_frames, 16),
            remat=False,
            param_dtype_str="float32",
            compute_dtype_str="float32",
        )
        if self.moe_experts:
            kw.update(moe_experts=min(self.moe_experts, 4),
                      moe_top_k=min(self.moe_top_k, 2),
                      moe_d_ff=min(self.moe_d_ff, 256))
        return self.replace(**kw)

    # -- parameter accounting --------------------------------------------------

    def param_count(self) -> int:
        """Analytic total parameter count (matches the built model)."""
        from repro_torch.configs._counting import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        """Parameters a token passes through: a MoE layer's top-k experts."""
        from repro_torch.configs._counting import count_params
        return count_params(self, active_only=True)


class TensorSpec(NamedTuple):
    """A model input's shape and dtype, allocated nowhere."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, Any]:
    """Model inputs for one (arch × input shape) as ``TensorSpec``s.

    train/prefill: {"tokens", "labels"?, "embeddings"?}
    decode:        {"token", "cache", "index"}, the cache a tree of specs
    """
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        specs: Dict[str, Any] = {}
        text_len = s
        if cfg.prefix_tokens:                       # VLM: patches use positions
            text_len = s - cfg.prefix_tokens
            specs["embeddings"] = TensorSpec(
                (b, cfg.prefix_tokens, cfg.d_model), cfg.compute_dtype)
        if cfg.stub_frames:                         # audio: encoder frames
            specs["embeddings"] = TensorSpec(
                (b, cfg.stub_frames, cfg.d_model), cfg.compute_dtype)
        specs["tokens"] = TensorSpec((b, text_len), torch.int32)
        if shape.kind == "train":
            specs["labels"] = TensorSpec((b, text_len), torch.int32)
        return specs

    # decode: the cache built on the meta device, which allocates nothing
    from repro_torch.models import encdec, transformer
    if cfg.encoder_layers:
        cache = encdec.init_cache(cfg, b, s, cfg.stub_frames, "meta")
    else:
        cache = transformer.init_cache(cfg, b, s, "meta")
    return {"token": TensorSpec((b, 1), torch.int32),
            "cache": _specs(cache),
            "index": TensorSpec((), torch.int32)}


def _specs(tree):
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return TensorSpec(tuple(tree.shape), tree.dtype)


def shape_applicable(cfg: ArchConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether an (arch × shape) pair runs, and the skip reason if not."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, cfg.long_context_note or \
            "pure full-attention architecture: 500k context is quadratic"
    return True, ""

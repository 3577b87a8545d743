"""Qwen3-8B — dense GQA with per-head q/k RMSNorm.

[hf:Qwen/Qwen3-8B] 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936,
an untied output table.  The same numbers as the reference package's
``configs/qwen3_8b.py``; ``qwen3_8b_sw4k`` is its sliding-window variant.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b",
    arch_type="dense",
    source="hf:Qwen/Qwen3-8B",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=12_288,
    vocab_size=151_936,
    block_pattern=("attn",),
    ffn_pattern=("dense",),
    qk_norm=True,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    supports_long_context=False,
    long_context_note="faithful config is full attention; see qwen3-8b-sw4k",
)

"""Qwen1.5-110B — dense GQA with QKV bias.

[hf:Qwen/Qwen1.5-0.5B (family card)] 80L d_model=8192 64H (GQA kv=8)
d_ff=49152 vocab=152064, an untied output table.  The same numbers as the
reference package's ``configs/qwen1_5_110b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    arch_type="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=49_152,
    vocab_size=152_064,
    block_pattern=("attn",),
    ffn_pattern=("dense",),
    qkv_bias=True,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    supports_long_context=False,
    long_context_note="pure full attention; 500k decode skipped",
)

"""StableLM-2-1.6B — dense, full MHA, LayerNorm.

[hf:stabilityai/stablelm-2-1_6b] 24L d_model=2048 32H (kv=32, MHA)
d_ff=5632 vocab=100352, gated silu MLP, a tied embedding.  The same
numbers as the reference package's ``configs/stablelm_1_6b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    arch_type="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_head=64,
    d_ff=5632,
    vocab_size=100_352,
    block_pattern=("attn",),
    ffn_pattern=("dense",),
    norm="layernorm",
    tie_embeddings=True,
    supports_long_context=False,
    long_context_note="pure full attention; 500k decode skipped",
)

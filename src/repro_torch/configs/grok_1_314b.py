"""Grok-1 314B — MoE, 8 experts top-2 on every layer.

[hf:xai-org/grok-1] 64L d_model=6144 48H (GQA kv=8) d_head=128, expert
d_ff=32768, vocab=131072, an untied output table, bf16 parameters.  The
same numbers as the reference package's ``configs/grok_1_314b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    arch_type="moe",
    source="hf:xai-org/grok-1",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=0,
    vocab_size=131_072,
    block_pattern=("attn",),
    ffn_pattern=("moe",),
    moe_experts=8,
    moe_top_k=2,
    moe_d_ff=32_768,
    tie_embeddings=False,
    param_dtype_str="bfloat16",
    opt_dtype_str="bfloat16",
    supports_long_context=False,
    long_context_note="pure full attention; 500k decode skipped",
)

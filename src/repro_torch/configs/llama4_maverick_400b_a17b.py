"""Llama-4 Maverick 400B-A17B — MoE 128 experts top-1, iRoPE attention.

[hf:meta-llama/Llama-4-Scout-17B-16E (family card)] 48L d_model=5120 40H
(GQA kv=8) d_head=128 d_ff=8192 vocab=202048.  The pattern unit is 3
chunked-local layers (RoPE, chunk 8192) and 1 global layer without
positional encoding (NoPE); every other layer's FFN is routed (MoE,
expert d_ff 8192), the rest dense.  bf16 parameters, an untied output
table.  The same numbers as the reference package's
``configs/llama4_maverick_400b_a17b.py``.  ``attn_seq_shard`` makes its
attention context-parallel on a mesh whose model axis does not divide
its 40 heads (``models/attention.py``); where it divides them the heads
split instead.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab_size=202_048,
    block_pattern=("chunked", "chunked", "chunked", "attn"),
    ffn_pattern=("dense", "moe", "dense", "moe"),
    attn_chunk=8192,
    attn_seq_shard=True,
    rope_on_global=False,
    moe_experts=128,
    moe_top_k=1,
    moe_d_ff=8192,
    tie_embeddings=False,
    param_dtype_str="bfloat16",
    opt_dtype_str="bfloat16",
    supports_long_context=True,
    long_context_note="chunked-local layers bounded; global layers O(seq) "
                      "at decode with NoPE",
)

"""Yi-34B — llama-architecture dense GQA.

[arXiv:2403.04652] 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000,
an untied output table.  The same numbers as the reference package's
``configs/yi_34b.py``; ``attn_seq_shard`` makes its attention
context-parallel on a mesh whose model axis does not divide its 56 heads
(``models/attention.py``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    arch_type="dense",
    source="arXiv:2403.04652",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=20_480,
    vocab_size=64_000,
    attn_seq_shard=True,
    block_pattern=("attn",),
    ffn_pattern=("dense",),
    tie_embeddings=False,
    rope_theta=5_000_000.0,
    supports_long_context=False,
    long_context_note="pure full attention; 500k decode skipped",
)

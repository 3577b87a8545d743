"""RecurrentGemma-9B — Griffin hybrid: RG-LRU + local attention, 2:1.

[arXiv:2402.19427] 38L d_model=4096 16H (kv=1, MQA) d_head=256 d_ff=12288
vocab=256000.  Pattern unit: (rec, rec, swa) with sliding window 2048.
The same numbers as the reference package's ``configs/recurrentgemma_9b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    source="arXiv:2402.19427",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_head=256,
    d_ff=12288,
    vocab_size=256_000,
    block_pattern=("rec", "rec", "swa"),
    ffn_pattern=("dense", "dense", "dense"),
    window=2048,
    rnn_width=4096,
    activation="gelu",
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    supports_long_context=True,
    long_context_note="RG-LRU recurrence + bounded local-attention window",
)

"""Whisper-large-v3 — encoder-decoder audio backbone.

[arXiv:2212.04356] 32 encoder + 32 decoder layers, d_model=1280 20H
(kv=20: MHA) d_ff=5120 vocab=51866.  The mel-spectrogram and conv
frontend is a stub: the encoder takes 1500 precomputed frame embeddings.
LayerNorm, a non-gated GELU MLP with biases, QKV bias.  The same numbers
as the reference package's ``configs/whisper_large_v3.py``.
``attn_seq_shard`` (context parallelism over the mesh's model axis) is
not read yet: the encoder-decoder on a model axis is ROADMAP A22, and the
port serves it on one card or across the data axis.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    arch_type="audio",
    source="arXiv:2212.04356",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_head=64,
    d_ff=5120,
    vocab_size=51_866,
    attn_seq_shard=True,
    block_pattern=("attn",),
    ffn_pattern=("dense",),
    encoder_layers=32,
    stub_frames=1500,
    norm="layernorm",
    activation="gelu",
    gated_mlp=False,
    mlp_bias=True,
    qkv_bias=True,
    tie_embeddings=True,
    supports_long_context=False,
    long_context_note="full-attention decoder; 500k decode skipped",
)

"""PaliGemma-3B — VLM: a SigLIP vision encoder (stubbed) and a gemma decoder.

[arXiv:2407.07726] 18L d_model=2048 8H (kv=1, MQA) d_head=256 d_ff=16384
vocab=257216, gelu, embeddings scaled by sqrt(d) and tied.  The vision
encoder and projector are a stub: 256 precomputed patch embeddings are
prepended to the text and attended with the prefix-LM mask (bidirectional
over the prefix, causal after it).  The same numbers as the reference
package's ``configs/paligemma_3b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    arch_type="vlm",
    source="arXiv:2407.07726",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_head=256,
    d_ff=16_384,
    vocab_size=257_216,
    block_pattern=("attn",),
    ffn_pattern=("dense",),
    prefix_tokens=256,
    activation="gelu",
    embed_scale=True,
    tie_embeddings=True,
    supports_long_context=False,
    long_context_note="pure full attention; 500k decode skipped",
)

"""xLSTM-125M — sLSTM and mLSTM blocks, alternating 1:1.

[arXiv:2405.04517] 12L d_model=768 4H d_ff=0 vocab=50304.  d_ff=0: the
feed-forward capacity lives inside the blocks (the mLSTM's up-projection
by 2, the sLSTM's post-projection by 4/3), so no block has an FFN.  The
same numbers as the reference package's ``configs/xlstm_125m.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    arch_type="ssm",
    source="arXiv:2405.04517",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_head=192,
    d_ff=0,
    vocab_size=50_304,
    block_pattern=("mlstm", "slstm"),
    ffn_pattern=("none", "none"),
    tie_embeddings=True,
    supports_long_context=True,
    long_context_note="recurrent state only — O(1) memory per step",
)

"""Qwen3-8B sliding-window serve variant: qwen3-8b with every layer a
4096-token sliding window, which bounds the decode KV cache.  The same
numbers as the reference package's ``configs/qwen3_8b_sw4k.py``.
"""
from repro_torch.configs.qwen3_8b import CONFIG as _BASE

CONFIG = _BASE.replace(
    name="qwen3-8b-sw4k",
    block_pattern=("swa",),
    window=4096,
    supports_long_context=True,
    long_context_note="sliding-window variant: KV cache bounded at 4096",
)

"""Analytic parameter counting per ArchConfig (mirrors the built models).

The reference's ``configs/_counting.py``: model FLOPs are 6·N·D (dense)
and 6·N_active·D (MoE); the tests hold the counts against the built
models' parameters.
"""
from __future__ import annotations


def _attn_params(cfg) -> int:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    n = d * h * dh + 2 * d * kv * dh + h * dh * d
    if cfg.qkv_bias:
        n += (h + 2 * kv) * dh
    if cfg.qk_norm:
        n += 2 * dh
    return n


def _mlp_params(cfg) -> int:
    d, ff = cfg.d_model, cfg.d_ff
    n = d * ff * (3 if cfg.gated_mlp else 2)
    if cfg.mlp_bias:
        n += ff + d
    return n


def _moe_params(cfg, active_only: bool) -> int:
    d, ff, e, k = cfg.d_model, cfg.moe_d_ff, cfg.moe_experts, cfg.moe_top_k
    n_router = d * e
    n_experts = (k if active_only else e) * 3 * d * ff
    return n_router + n_experts


def _rec_params(cfg) -> int:
    d = cfg.d_model
    dr = cfg.rnn_width or d
    return (2 * d * dr            # w_in, w_gate_branch
            + 4 * dr + dr         # conv
            + 2 * dr * dr + 2 * dr  # w_a/b_a, w_x/b_x
            + dr                  # lambda
            + dr * d)             # w_out


def _slstm_params(cfg) -> int:
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    dff = int(4.0 / 3.0 * d)
    return (4 * d + d             # conv
            + d * 4 * d + 4 * d   # gates
            + 4 * nh * dh * dh    # recurrent block-diag
            + d                   # norm
            + 2 * d * dff + dff * d)


def _mlstm_params(cfg) -> int:
    d = cfg.d_model
    di = 2 * d
    nh = cfg.n_heads
    dh = di // nh
    return (2 * d * di            # up projections
            + 4 * di + di         # conv
            + 3 * di * nh * dh    # q, k, v
            + 2 * (di * nh + nh)  # gates
            + nh * dh             # norm
            + di * d)


def _norm_params(cfg) -> int:
    return cfg.d_model * (2 if cfg.norm == "layernorm" else 1)


def count_params(cfg, active_only: bool = False) -> int:
    d = cfg.d_model
    total = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    total += _norm_params(cfg)  # final norm

    mixer = {"attn": _attn_params, "swa": _attn_params,
             "chunked": _attn_params, "rec": _rec_params,
             "slstm": _slstm_params, "mlstm": _mlstm_params}
    unit = len(cfg.block_pattern)
    for i in range(cfg.n_layers):
        kind = cfg.block_pattern[i % unit]
        ffn = cfg.ffn_pattern[i % unit]
        total += mixer[kind](cfg) + _norm_params(cfg)
        if ffn == "dense":
            total += _mlp_params(cfg) + _norm_params(cfg)
        elif ffn == "moe":
            total += _moe_params(cfg, active_only) + _norm_params(cfg)

    # enc-dec: encoder layers + per-decoder-layer cross attention + norms
    if cfg.encoder_layers:
        enc_layer = _attn_params(cfg) + _mlp_params(cfg) + 2 * _norm_params(cfg)
        total += cfg.encoder_layers * enc_layer + _norm_params(cfg)
        total += cfg.n_layers * (_attn_params(cfg) + _norm_params(cfg))
    return total

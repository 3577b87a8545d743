"""xLSTM blocks (arXiv:2405.04517): the mLSTM (matrix memory) and the
sLSTM (scalar memory with recurrent hidden mixing).

The port of the reference's ``models/xlstm.py``.  Both use exponential
gating with the log-domain stabiliser ``m``:

    m_t = max(log f_t + m_{t-1}, log i_t)
    i'  = exp(log i_t - m_t),  f' = exp(log f_t + m_{t-1} - m_t)

mLSTM, per head:  C_t = f'·C_{t-1} + i'·k_t v_tᵀ,
                  n_t = f'·n_{t-1} + i'·k_t,
                  h_t = C_tᵀ q_t / max(|n_tᵀ q_t|, 1)
sLSTM: a scalar cell per unit whose gate pre-activations also take the
previous h through block-diagonal (per-head) recurrent weights.

The recurrences run one time step at a time in fp32 plain PyTorch, as the
reference's ``lax.scan`` runs them in XLA: neither scan is a Pallas
kernel, so no kernel of the port replaces them.  Prefill and decode share
one body (``_mlstm_inner``, ``_slstm_inner``); decode passes the cache, a
dict of named leaves where the reference keeps a tuple: ``c``, ``n``,
``m``, ``conv`` (mLSTM) and ``c``, ``n``, ``h``, ``m``, ``conv`` (sLSTM).
``conv`` holds the last 3 inputs of the causal conv before it is applied.

On a model axis of W > 1 ranks each weight is the block of its rule
(``sharding.rules``; the rule-less biases, ``w_igate``/``w_fgate`` and
the norm scales whole, sliced at use), each split independently where W
divides its dimension:

* mLSTM: ``w_up_main``, ``w_up_gate`` and the conv split ``di`` (the
  rank's channels); ``q``, ``k`` and ``v`` contract over all of ``di``, so
  the conv'd and the plain branch are all-gathered once a call (one
  collective) and projected onto the heads ``wq`` places on the rank (all
  of them where W does not divide the heads); ``log_i``/``log_f`` come
  from the whole gate weights, sliced to those heads; the cell runs on
  them; the norm spans all of ``di``, so the heads' ``h`` are gathered
  before it; then the rank's ``di`` block meets its ``gate`` and the
  row-parallel ``w_down`` (summed over ``model``).
* sLSTM: the conv runs on the rank's channels of x and is gathered;
  ``w_gates``' columns are gate-major (i, f, z, o), so a rank's block is
  whole gates, not its heads': the rank computes its block of ``pre``,
  which is all-gathered in fp32, and takes each gate's slice of its
  heads.  Where ``r_gates`` splits by heads the cell loop is the rank's
  heads, with no collective inside it; where it splits on ``dh`` (the
  output dim) it is gathered once a call and every rank runs the whole
  recurrence.  The norm spans all of ``d`` (the heads' ``h`` gathered);
  ``w_up``/``w_up_gate`` are column-parallel and ``w_down`` row-parallel
  where W divides their width, else whole.

The caches hold what the mixer holds: the conv's state the rank's
channels, the cell's state its heads (whole where the heads are).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers, parallel

Cache = Dict[str, torch.Tensor]

_CONV_WIDTH = 4
_PF_MLSTM = 2.0          # mLSTM up-projection factor
_PF_SLSTM = 4.0 / 3.0    # sLSTM post-projection factor
_F_BIAS = 3.0            # forget-gate bias at init: gates open


def _register(module: nn.Module, specs, device,
              generator: Optional[torch.Generator], mesh=None) -> None:
    """Register each (name, shape, dtype, init) of ``specs`` as a frozen
    parameter; ``init`` is ("scaled", fan_in), ("normal",) or ("fill",
    value), drawn in ``specs`` order from ``generator`` (None: left unset
    for a loader); with a ``mesh``, this rank's block of each."""
    for name, shape, dtype, init in specs:
        def draw(shape=shape, dtype=dtype, init=init):
            if init[0] == "scaled":
                return layers.scaled_init(shape, generator, dtype,
                                          fan_in=init[1])
            if init[0] == "normal":
                return layers.normal_init(shape, generator, dtype)
            return torch.full(shape, init[1], dtype=dtype,
                              device=generator.device)
        module.register_parameter(name, layers.param(
            shape, dtype, device, generator, draw, name=name, mesh=mesh))


class MLSTM(nn.Module):
    """The mLSTM block's parameters, named as the reference's pytree.  The
    head width is ``di // n_heads`` with ``di = 2 · d_model`` (384 at full
    size, not ``cfg.d_head``); the gate weights and biases and the norm
    scale are float32 under any ``param_dtype``, as in the reference."""

    def __init__(self, cfg, *, device, generator: Optional[torch.Generator],
                 mesh=None):
        super().__init__()
        d, nh, pd = cfg.d_model, cfg.n_heads, cfg.param_dtype
        di = int(_PF_MLSTM * d)
        dh = di // nh
        f32 = torch.float32
        self.n_heads = nh
        _register(self, (
            ("w_up_main", (d, di), pd, ("scaled", d)),
            ("w_up_gate", (d, di), pd, ("scaled", d)),
            ("conv_w", (_CONV_WIDTH, di), pd, ("normal",)),
            ("conv_b", (di,), pd, ("fill", 0.0)),
            ("wq", (di, nh, dh), pd, ("scaled", di)),
            ("wk", (di, nh, dh), pd, ("scaled", di)),
            ("wv", (di, nh, dh), pd, ("scaled", di)),
            ("w_igate", (di, nh), f32, ("normal",)),
            ("b_igate", (nh,), f32, ("fill", 0.0)),
            ("w_fgate", (di, nh), f32, ("normal",)),
            ("b_fgate", (nh,), f32, ("fill", _F_BIAS)),
            ("norm_scale", (nh, dh), f32, ("fill", 1.0)),
            ("w_down", (di, d), pd, ("scaled", di)),
        ), device, generator, mesh)
        self.mesh = mesh if parallel.model_active(mesh) else None
        # the rank's di channels (None: whole) and its heads
        self.channels = parallel.span("w_up_main", (d, di), mesh)
        heads = parallel.span("wq", (di, nh, dh), mesh)
        self.heads_split = heads is not None
        self.heads = heads or (0, nh)


class SLSTM(nn.Module):
    """The sLSTM block's parameters, named as the reference's pytree: the
    input weights of the four gates (i, f, z, o) side by side in
    ``w_gates``, their biases (the f slice at 3.0) and the per-head
    recurrent weights ``r_gates`` (4, H, dh, dh), float32; the
    post-projection is ``int(4/3 · d_model)`` wide (1024 at full size)."""

    def __init__(self, cfg, *, device, generator: Optional[torch.Generator],
                 mesh=None):
        super().__init__()
        d, nh, pd = cfg.d_model, cfg.n_heads, cfg.param_dtype
        dh = d // nh
        dff = int(_PF_SLSTM * d)
        f32 = torch.float32
        self.n_heads = nh
        _register(self, (
            ("conv_w", (_CONV_WIDTH, d), pd, ("normal",)),
            ("conv_b", (d,), pd, ("fill", 0.0)),
            ("w_gates", (d, 4 * d), pd, ("scaled", d)),
            ("b_gates", (4 * d,), f32, ("fill", 0.0)),
            ("r_gates", (4, nh, dh, dh), f32, ("scaled", dh)),
            ("norm_scale", (d,), f32, ("fill", 1.0)),
            ("w_up_gate", (d, dff), pd, ("scaled", d)),
            ("w_up", (d, dff), pd, ("scaled", d)),
            ("w_down", (dff, d), pd, ("scaled", dff)),
        ), device, generator, mesh)
        if generator is not None:
            with torch.no_grad():
                self.b_gates[d:2 * d] = _F_BIAS
        self.mesh = mesh if parallel.model_active(mesh) else None
        # the rank's conv channels, w_gates columns and post-projection
        # width (None: whole); r_gates' split dim: 1 its heads, 3 dh
        self.channels = parallel.span("conv_w", (_CONV_WIDTH, d), mesh)
        self.gate_cols = parallel.span("w_gates", (d, 4 * d), mesh)
        self.ff = parallel.span("w_up", (d, dff), mesh)
        self.r_split = parallel.split_dim("r_gates", (4, nh, dh, dh), mesh)
        h0, h1 = (0, nh) if self.r_split != 1 else \
            parallel.span("r_gates", (4, nh, dh, dh), mesh)
        self.units = (h0 * dh, h1 * dh)      # the cell's channels


def causal_conv(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv of width 4 along axis 1: x (B, S, C), after
    ``state`` (B, 3, C) -- the 3 inputs before x -- or zeros."""
    pad = torch.zeros((x.shape[0], _CONV_WIDTH - 1, x.shape[-1]),
                      dtype=x.dtype, device=x.device) \
        if state is None else state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    w = w.to(x.dtype)
    s = x.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, _CONV_WIDTH):
        out = out + xp[:, i:i + s] * w[i]
    return out + b.to(x.dtype)


def _conv_state(x: torch.Tensor, state: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """The conv's next state: the last 3 pre-conv inputs, after the old
    state's."""
    full = x if state is None else torch.cat([state.to(x.dtype), x], dim=1)
    return full[:, -(_CONV_WIDTH - 1):]


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_cell(c, n, m, q, k, v, log_i, log_f):
    """One stabilised mLSTM step, fp32: c (B, H, dk, dv), n (B, H, dk), m
    (B, H); q, k, v (B, H, dk); log_i, log_f (B, H)."""
    m_new = torch.maximum(log_f + m, log_i)
    i_p = torch.exp(log_i - m_new)[..., None]
    f_p = torch.exp(log_f + m - m_new)[..., None]
    n_new = f_p * n + i_p * k
    c_new = f_p[..., None] * c + i_p[..., None] * (k[..., :, None]
                                                    * v[..., None, :])
    num = torch.einsum("bhkv,bhk->bhv", c_new, q)
    den = torch.clamp_min(torch.abs(torch.einsum("bhk,bhk->bh", n_new, q)),
                          1.0)
    return c_new, n_new, m_new, num / den[..., None]


def _mlstm_inner(p: MLSTM, x: torch.Tensor, state: Optional[Cache] = None
                 ) -> Tuple[torch.Tensor, Cache]:
    """x (B, S, d) -> (y (B, S, d), the state after the last step)."""
    b, s, _ = x.shape
    dt = x.dtype
    main = x @ p.w_up_main.to(dt)
    gate = F.silu(x @ p.w_up_gate.to(dt))
    conv_state = None if state is None else state["conv"]
    cm = F.silu(causal_conv(p.conv_w, parallel.part(p.channels, p.conv_b),
                            main, conv_state))
    cm_all, main_all = (cm, main) if p.channels is None else \
        parallel.gather_blocks(p.mesh, cm, main)
    di = cm_all.shape[-1]
    dh = di // p.n_heads
    h0, h1 = p.heads
    nh = h1 - h0
    # q and k from the conv'd branch, k scaled after its projection; v from
    # the branch before the conv
    q = torch.einsum("bsi,ihk->bshk", cm_all, p.wq.to(dt))
    k = torch.einsum("bsi,ihk->bshk", cm_all, p.wk.to(dt)) * dh ** -0.5
    v = torch.einsum("bsi,ihk->bshk", main_all, p.wv.to(dt))
    cmf = cm_all.float()
    # the raw pre-activation
    log_i = (cmf @ p.w_igate + p.b_igate)[..., h0:h1]
    log_f = F.logsigmoid(cmf @ p.w_fgate + p.b_fgate)[..., h0:h1]
    if state is None:
        c = torch.zeros((b, nh, dh, dh), dtype=torch.float32, device=x.device)
        n = torch.zeros((b, nh, dh), dtype=torch.float32, device=x.device)
        m = torch.zeros((b, nh), dtype=torch.float32, device=x.device)
    else:
        c, n, m = state["c"], state["n"], state["m"]
    qf, kf, vf = q.float(), k.float(), v.float()
    hs = []
    for t in range(s):
        c, n, m, h = _mlstm_cell(c, n, m, qf[:, t], kf[:, t], vf[:, t],
                                 log_i[:, t], log_f[:, t])
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(b, s, nh * dh)   # (B, S, H·dh)
    if p.heads_split:
        h, = parallel.gather_blocks(p.mesh, h)
    h = layers.rmsnorm_apply(p.norm_scale.reshape(-1), h).to(dt)
    out = (parallel.part(p.channels, h) * gate) @ p.w_down.to(dt)
    if p.channels is not None:
        out = parallel.sum_model(p.mesh, out)
    return out, {"c": c, "n": n, "m": m, "conv": _conv_state(main,
                                                             conv_state)}


def mlstm_block_apply(p: MLSTM, x: torch.Tensor) -> torch.Tensor:
    """Training / prefill forward.  x (B, S, d) -> (B, S, d)."""
    return _mlstm_inner(p, x)[0]


def mlstm_init_cache(cfg, batch: int, device, mesh=None) -> Cache:
    """The cell's ``c``, ``n``, ``m`` over the heads the mixer runs on this
    rank and the conv's state over its channels."""
    d, nh = cfg.d_model, cfg.n_heads
    di = int(_PF_MLSTM * d)
    dh = di // nh
    f32 = torch.float32
    heads = parallel.span("wq", (di, nh, dh), mesh)
    channels = parallel.span("w_up_main", (d, di), mesh)
    nh = nh if heads is None else heads[1] - heads[0]
    di = di if channels is None else channels[1] - channels[0]
    return {"c": torch.zeros((batch, nh, dh, dh), dtype=f32, device=device),
            "n": torch.zeros((batch, nh, dh), dtype=f32, device=device),
            "m": torch.zeros((batch, nh), dtype=f32, device=device),
            "conv": torch.zeros((batch, _CONV_WIDTH - 1, di),
                                dtype=cfg.compute_dtype, device=device)}


def mlstm_block_decode(p: MLSTM, x: torch.Tensor, cache: Cache
                       ) -> Tuple[torch.Tensor, Cache]:
    """One step (or a few) from ``cache``: x (B, S, d) -> (y, new cache)."""
    return _mlstm_inner(p, x, cache)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_cell(r: torch.Tensor, c, n, h, m, pre):
    """One sLSTM step, fp32: c, n, h, m (B, d); pre (B, 4d) the input's
    gate pre-activations.  The recurrent product is laid out gate-major
    (i, f, z, o), each gate's heads side by side."""
    b, d = h.shape
    nh, dh = r.shape[1], r.shape[2]
    rec = torch.einsum("bhx,ghxy->bghy", h.reshape(b, nh, dh), r) \
        .reshape(b, 4 * d)
    zi, zf, zz, zo = torch.chunk(pre + rec, 4, dim=-1)
    log_i = zi
    log_f = F.logsigmoid(zf)
    m_new = torch.maximum(log_f + m, log_i)
    i_p = torch.exp(log_i - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c_new = f_p * c + i_p * torch.tanh(zz)
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(zo) * c_new / torch.clamp_min(n_new, 1.0)
    return c_new, n_new, h_new, m_new


def _slstm_inner(p: SLSTM, x: torch.Tensor, state: Optional[Cache] = None
                 ) -> Tuple[torch.Tensor, Cache]:
    """x (B, S, d) -> (y (B, S, d), the state after the last step)."""
    b, s, d = x.shape
    dt = x.dtype
    conv_state = None if state is None else state["conv"]
    xc = parallel.part(p.channels, x)
    cx = F.silu(causal_conv(p.conv_w, parallel.part(p.channels, p.conv_b),
                            xc, conv_state))
    if p.channels is not None:
        cx, = parallel.gather_blocks(p.mesh, cx)
    pre = (cx @ p.w_gates.to(dt)).float() \
        + parallel.part(p.gate_cols, p.b_gates)
    if p.gate_cols is not None:
        pre, = parallel.gather_blocks(p.mesh, pre)
    r = p.r_gates
    if p.r_split == 3:
        r, = parallel.gather_blocks(p.mesh, r)
    u0, u1 = p.units
    if u1 - u0 < d:
        # each gate's slice of the rank's heads, still gate-major
        pre = pre.reshape(b, s, 4, d)[..., u0:u1].reshape(b, s, 4 * (u1 - u0))
    if state is None:
        zeros = torch.zeros((b, u1 - u0), dtype=torch.float32,
                            device=x.device)
        c = n = h = m = zeros
    else:
        c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    hs = []
    for t in range(s):
        c, n, h, m = _slstm_cell(r, c, n, h, m, pre[:, t])
        hs.append(h)
    hs = torch.stack(hs, dim=1)
    if u1 - u0 < d:
        hs, = parallel.gather_blocks(p.mesh, hs)
    y = layers.rmsnorm_apply(p.norm_scale, hs).to(dt)
    up = y @ p.w_up.to(dt)
    gate = layers.gelu(y @ p.w_up_gate.to(dt))
    out = (up * gate) @ p.w_down.to(dt)
    if p.ff is not None:
        out = parallel.sum_model(p.mesh, out)
    return out, {"c": c, "n": n, "h": h, "m": m,
                 "conv": _conv_state(xc, conv_state)}


def slstm_block_apply(p: SLSTM, x: torch.Tensor) -> torch.Tensor:
    """Training / prefill forward.  x (B, S, d) -> (B, S, d)."""
    return _slstm_inner(p, x)[0]


def slstm_init_cache(cfg, batch: int, device, mesh=None) -> Cache:
    """The cell's ``c``, ``n``, ``h``, ``m`` over the units the mixer runs
    on this rank (its heads' where ``r_gates`` splits by heads, else all)
    and the conv's state over its channels."""
    d, nh = cfg.d_model, cfg.n_heads
    dh = d // nh
    units = d
    if parallel.split_dim("r_gates", (4, nh, dh, dh), mesh) == 1:
        units = d // parallel.model_axis(mesh)[0]
    channels = parallel.span("conv_w", (_CONV_WIDTH, d), mesh)
    cache = {k: torch.zeros((batch, units), dtype=torch.float32,
                            device=device)
             for k in ("c", "n", "h", "m")}
    d = d if channels is None else channels[1] - channels[0]
    cache["conv"] = torch.zeros((batch, _CONV_WIDTH - 1, d),
                                dtype=cfg.compute_dtype, device=device)
    return cache


def slstm_block_decode(p: SLSTM, x: torch.Tensor, cache: Cache
                       ) -> Tuple[torch.Tensor, Cache]:
    """One step (or a few) from ``cache``: x (B, S, d) -> (y, new cache)."""
    return _slstm_inner(p, x, cache)

"""The substrate's two sequence kernels: wrappers, plain versions, launch
counts.

Each kernel is hand-written CUDA for ``sm_90a`` (built by ``_build``) and
replaces one Pallas kernel of the reference:

* ``flash_attention`` -- GQA online-softmax attention forward
  (``kernels/flash_attention.py::_attn_kernel``) under every mask of the
  reference's ``models/attention.py::mask_logits``: causal, sliding
  window, prefix-LM and chunked (the Pallas kernel has only the first
  two; the reference computes the others in XLA), and full attention
  over a key length of its own (whisper's cross-attention), and a
  block of queries at an offset of the keys' sequence (``q_offset``: a
  rank's block of a context-parallel prefill, every mask reading the
  absolute position): for
  bf16 at d_head 64, 128 and 256 a tensor-core kernel (``wgmma``, a TMA
  K/V ring; ``csrc/flash_wgmma.cu``), otherwise a CUDA-core kernel
  (``csrc/seq_ops.cu``); ``flash_route`` says which;
* ``linear_recurrence`` -- the diagonal scan h_t = exp(log_a_t)·h_{t-1} +
  x_t with an fp32 carry (``kernels/linear_recurrence.py::_linrec_kernel``,
  ``csrc/seq_ops.cu``): a warp a 32-channel block, fed by a ring of
  ``cp.async`` tiles in shared memory.

The public layout is the reference's ``kernels/ops.py``: attention takes and
returns (B, S, H, D), the recurrence (B, S, C).  A wrapper given CPU
tensors runs the kernel's plain PyTorch version (``attention_plain``,
``linear_recurrence_plain``, the reference's ``kernels/ref.py`` oracles);
given CUDA tensors it launches the kernel or raises -- there is no
fallback.  ``LAUNCHES`` counts, per wrapper, the kernel launches it made
and nothing else; ``flash_attention_wgmma`` counts the flash launches that
went to the tensor-core kernel (``flash_attention`` counts them all).

Both wrappers are differentiable.  Given inputs that need a gradient
(with grad mode on) they go through a ``torch.autograd.Function``, on the
card and on the CPU alike; otherwise they launch as a server calls them,
saving nothing.  Flash's backward recomputes through ``attention_plain``
(one more forward's work, and the (B, KV, G, S, S_kv) float32 scores held
for the step), as the reference's ``kernels/ops.py`` ``custom_vjp``
recomputes through its oracle: the reference has no backward kernel.  The
recurrence's backward is itself a linear recurrence, run backwards in
time through the same kernel (a second launch); with a_t = exp(log_a_t)
and the upstream gradient g,

    λ_{S-1} = g_{S-1},  λ_t = g_t + a_{t+1}·λ_{t+1},
    ∂x_t = λ_t,  ∂log_a_t = λ_t·a_t·h_{t-1}  (h_{-1} = 0),

so a ``rec`` layer's train step launches it twice.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import _build

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_wgmma": 0,
                             "linear_recurrence": 0}

NEG_INF = -2.0e38
# the CUDA-core flash kernel's tiles (csrc/seq_ops.cu: kFlashBQ, kFlashBK,
# kFlashMaxD)
FLASH_BQ = 64
FLASH_BK = 64
FLASH_MAX_D = 256
# the tensor-core flash kernel (csrc/flash_wgmma.cu: kBQ, kBK, kStages, the
# barriers and the 1024-byte alignment slack) and the head dims it is built
# for
WGMMA_BQ = 128
WGMMA_BK = 64
WGMMA_STAGES = 2
WGMMA_HEAD_DIMS = (64, 128, 256)
# the linear-recurrence kernel's ring (csrc/seq_ops.cu: kLinrecChannels,
# kLinrecTile, kLinrecStages): channels a block, time steps a tile, tiles
LINREC_CHANNELS = 32
LINREC_TILE = 32
LINREC_STAGES = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

def check_mask(causal: bool, window: int, prefix_len: int, chunk: int,
               s_q: int = 0, s_kv: int = 0,
               q_offset: "int | None" = None) -> None:
    """The masks ``flash_attention`` computes are the reference's mask
    kinds: causal (``global``), causal with a window (``sliding``), causal
    or key < ``prefix_len`` (``prefix``), causal within a ``chunk``
    (``chunked``), and without ``causal`` full or windowed.  Queries and
    keys of two lengths (``s_q`` != ``s_kv``: cross-attention) take full
    attention alone -- no mask kind of the reference pairs a mask with a
    second length -- unless ``q_offset`` places the queries as a block of
    the keys' sequence, query i at the absolute position ``q_offset + i``
    (a rank's block of a context-parallel prefill): a masked block must
    lie inside the keys (``q_offset + s_q <= s_kv``).  Any other
    combination raises rather than compute something untested."""
    masked = causal or window or prefix_len or chunk
    if q_offset is None:
        if s_q != s_kv and masked:
            raise ValueError(f"flash_attention: {s_q} queries over {s_kv} "
                             f"keys take full attention only (causal "
                             f"{causal}, window {window}, prefix_len "
                             f"{prefix_len}, chunk {chunk}) unless q_offset "
                             f"places them as a block of the keys")
    elif not masked:
        raise ValueError(f"flash_attention: q_offset {q_offset} places "
                         f"queries for a mask; full attention takes none")
    elif q_offset < 0 or q_offset + s_q > s_kv:
        raise ValueError(f"flash_attention: a block of {s_q} queries from "
                         f"position {q_offset} must lie inside the {s_kv} "
                         f"keys (0 <= q_offset, q_offset + S <= S_kv)")
    if min(window, prefix_len, chunk) < 0:
        raise ValueError(f"flash_attention: window {window}, prefix_len "
                         f"{prefix_len} and chunk {chunk} must be >= 0")
    if sum(bool(x) for x in (window, prefix_len, chunk)) > 1:
        raise ValueError(f"flash_attention: window {window}, prefix_len "
                         f"{prefix_len} and chunk {chunk} do not combine "
                         f"(no mask kind of the reference takes two)")
    if (prefix_len or chunk) and not causal:
        raise ValueError("flash_attention: the prefix and chunked masks are "
                         "causal ones")


def attention_mask(s: int, device, *, causal: bool = True, window: int = 0,
                   prefix_len: int = 0, chunk: int = 0,
                   s_kv: "int | None" = None,
                   q_offset: "int | None" = None) -> torch.Tensor:
    """(S, S_kv) bool, query i may see key j: the reference's
    ``mask_logits`` over query positions q_offset..q_offset+S-1 (from 0
    without an offset) and key positions 0..S_kv-1 (``s_kv`` defaults to
    S)."""
    s_kv = s if s_kv is None else s_kv
    check_mask(causal, window, prefix_len, chunk, s, s_kv, q_offset)
    qp = (q_offset or 0) + torch.arange(s, device=device)[:, None]
    kp = torch.arange(s_kv, device=device)[None, :]
    allowed = torch.ones((s, s_kv), dtype=torch.bool, device=device)
    if causal:
        allowed &= (kp <= qp) | (kp < prefix_len)
    if window:
        allowed &= kp > qp - window
    if chunk:
        allowed &= (kp // chunk) == (qp // chunk)
    return allowed


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, prefix_len: int = 0,
                    chunk: int = 0, q_offset: "int | None" = None
                    ) -> torch.Tensor:
    """q (B, S, H, D), k/v (B, S_kv, KV, D) -> (B, S, H, D): the full
    score matrix, masked and soft-maxed, as the reference's
    ``attention_ref`` computes it (scores in q's dtype, then fp32;
    probabilities in v's), under ``attention_mask`` (query i at position
    ``q_offset + i``)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg * d ** -0.5,
                          k.to(q.dtype)).float()
    allowed = attention_mask(s, q.device, causal=causal, window=window,
                             prefix_len=prefix_len, chunk=chunk,
                             s_kv=k.shape[1], q_offset=q_offset)
    logits = torch.where(allowed, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, s, h, d)


def flash_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one flash block: the fp32 Q and K tiles
    (rows padded by one float), the V tile and the probabilities."""
    return 4 * (FLASH_BQ * (d + 1) + FLASH_BK * (d + 1) + FLASH_BK * d
                + FLASH_BQ * (FLASH_BK + 1))


def flash_wgmma_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one tensor-core flash block: the bf16 Q
    tile, ``WGMMA_STAGES`` K and V tiles, 128 bytes of barriers and 1024
    bytes to align the tiles to the 128-byte swizzle's atom."""
    return (2 * WGMMA_BQ * d + 2 * 2 * WGMMA_STAGES * WGMMA_BK * d
            + 128 + 1024)


def flash_route(dtype: torch.dtype, d: int) -> str:
    """The C entry point a CUDA call of ``flash_attention`` launches, from
    the dtype and the head dim alone: the tensor-core kernel for bfloat16
    at D in ``WGMMA_HEAD_DIMS``, the CUDA-core kernel otherwise (float32,
    which it holds at an fp32 tolerance, and bfloat16 at other D)."""
    if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS:
        return "seq_flash_attention_wgmma"
    return "seq_flash_attention"


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _FlashAttention(torch.autograd.Function):
    """The flash kernel forward (the plain version on the CPU); the
    backward recomputes the scores through ``attention_plain`` and takes
    its gradient, summed over each KV head's query group."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix_len, chunk, q_offset):
        ctx.mask = dict(causal=causal, window=window, prefix_len=prefix_len,
                        chunk=chunk, q_offset=q_offset)
        ctx.save_for_backward(q, k, v)
        return _flash_forward(q, k, v, **ctx.mask)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = attention_plain(*inputs, **ctx.mask)
            grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, prefix_len: int = 0,
                    chunk: int = 0, q_offset: "int | None" = None
                    ) -> torch.Tensor:
    """q (B, S, H, D), k/v (B, S_kv, KV, D) -> (B, S, H, D) in q's dtype.

    With ``q_offset`` query i sits at the absolute position ``q_offset +
    i`` and key j at j: a rank's block of queries of a context-parallel
    prefill against the whole sequence's keys (``q_offset + S <= S_kv``).
    Without it S_kv differs from S only under full attention
    (``causal=False``, no window, prefix or chunk: whisper's
    cross-attention).  ``window`` > 0
    lets query p see keys in (p - window, p] (with ``causal``) or
    (p - window, S) (without); ``prefix_len`` > 0 also lets
    every query see the keys before ``prefix_len`` (prefix-LM; a prefix of
    S is full attention); ``chunk`` > 0 keeps a query to the keys of its
    own chunk of ``chunk`` positions (``check_mask`` says which of these
    combine).  Any S; D a multiple of 16 up to 256; float32 or bfloat16.
    On the card the kernel is chosen by ``flash_route`` and never on
    failure: an error of either kernel raises.  Differentiable in q, k and
    v (``_FlashAttention``)."""
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, prefix_len,
                                     chunk, q_offset)
    return _flash_forward(q, k, v, causal=causal, window=window,
                          prefix_len=prefix_len, chunk=chunk,
                          q_offset=q_offset)


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window: int, prefix_len: int, chunk: int,
                   q_offset: "int | None" = None) -> torch.Tensor:
    """``flash_attention``'s forward: the kernel on the card, the plain
    version on the CPU."""
    mask = dict(causal=causal, window=window, prefix_len=prefix_len,
                chunk=chunk, q_offset=q_offset)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, **mask)
    dev = q.device
    b, s, h, d = q.shape
    s_kv, kv = k.shape[1], k.shape[2]
    check_mask(causal, window, prefix_len, chunk, s, s_kv, q_offset)
    if s_kv == 0:
        raise ValueError("flash_attention: no keys (S_kv = 0)")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if kv == 0 or h % kv:
        raise ValueError(f"flash_attention: {kv} KV heads do not divide "
                         f"{h} heads")
    if d % 16 or d > FLASH_MAX_D:
        raise ValueError(f"flash_attention: head dim {d} must be a multiple "
                         f"of 16 and at most {FLASH_MAX_D}")
    route = flash_route(q.dtype, d)
    wgmma = route == "seq_flash_attention_wgmma"
    q, k, v = (t.contiguous() for t in (q, k, v))
    if wgmma:   # TMA reads from 16-byte aligned addresses
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    _build.require(q, "q", dev, q.dtype, (b, s, h, d))
    _build.require(k, "k", dev, q.dtype, (b, s_kv, kv, d))
    _build.require(v, "v", dev, q.dtype, (b, s_kv, kv, d))
    smem = flash_wgmma_smem_bytes(d) if wgmma else flash_smem_bytes(d)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"flash_attention needs {smem} bytes of shared "
                         f"memory a block (D={d}); the H100 allows "
                         f"{_build.MAX_SMEM_BYTES}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.library()
    args = (_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            b, s, s_kv, h, kv, d, int(causal), int(window), int(prefix_len),
            int(chunk), int(q_offset or 0), float(d ** -0.5))
    with _build.on(dev):
        if wgmma:
            code = lib.seq_flash_attention_wgmma(*args, smem,
                                                 _build.stream(dev))
        else:
            code = lib.seq_flash_attention(*args, _DTYPE_CODE[q.dtype], smem,
                                           _build.stream(dev))
    _build.check(code, route)
    LAUNCHES["flash_attention"] += 1
    if wgmma:
        LAUNCHES["flash_attention_wgmma"] += 1
    return out


# ---------------------------------------------------------------------------
# Linear recurrence
# ---------------------------------------------------------------------------

def linear_recurrence_plain(log_a: torch.Tensor, x: torch.Tensor
                            ) -> torch.Tensor:
    """h_t = exp(log_a_t)·h_{t-1} + x_t along axis 1, h_{-1} = 0, one time
    step at a time in fp32.  (B, S, C) -> (B, S, C) float32."""
    la, xf = log_a.float(), x.float()
    out = torch.empty_like(xf)
    h = torch.zeros_like(xf[:, 0])
    for t in range(xf.shape[1]):
        h = torch.exp(la[:, t]) * h + xf[:, t]
        out[:, t] = h
    return out


def linrec_vector_bytes(c: int, itemsize: int, *ptrs: int) -> int:
    """Bytes of one copy into the recurrence kernel's ring: the widest of
    16, 8 and 4 that divides a row of C channels and every pointer's
    alignment, else the element itself (bfloat16 with an odd C)."""
    for vec in (16, 8, 4):
        if (c * itemsize) % vec == 0 and all(p % vec == 0 for p in ptrs):
            return vec
    return itemsize


class _LinearRecurrence(torch.autograd.Function):
    """The recurrence forward, and its adjoint as a second recurrence run
    backwards in time through the same wrapper (the kernel on the card,
    the plain version on the CPU), in float32; the gradients are cast to
    the inputs' dtype."""

    @staticmethod
    def forward(ctx, log_a, x):
        h = _linrec_forward(log_a, x)
        ctx.save_for_backward(log_a, h)
        ctx.x_dtype = x.dtype
        return h

    @staticmethod
    def backward(ctx, g):
        log_a, h = ctx.saved_tensors
        la = log_a.float()
        zero = torch.zeros_like(la[:, :1])
        # λ_t = g_t + a_{t+1}·λ_{t+1}: a recurrence over reversed time whose
        # decay at step t is log_a_{t+1} (0 past the end: λ_S = 0 anyway)
        la_next = torch.cat([la[:, 1:], zero], dim=1)
        lam = torch.flip(_linrec_forward(torch.flip(la_next, [1]),
                                         torch.flip(g.float(), [1])), [1])
        h_prev = torch.cat([zero, h[:, :-1]], dim=1)
        d_log_a = lam * torch.exp(la) * h_prev
        return d_log_a.to(log_a.dtype), lam.to(ctx.x_dtype)


def linear_recurrence(log_a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """log_a, x (B, S, C), both float32 or both bfloat16 -> h (B, S, C)
    float32.  Differentiable in both (``_LinearRecurrence``)."""
    if log_a.dtype != x.dtype:
        raise TypeError(f"linear_recurrence: log_a is {log_a.dtype}, x is "
                        f"{x.dtype}; they must match")
    if _needs_grad(log_a, x):
        return _LinearRecurrence.apply(log_a, x)
    return _linrec_forward(log_a, x)


def _linrec_forward(log_a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``linear_recurrence``'s forward: the kernel on the card, the plain
    version on the CPU."""
    if x.device.type == "cpu":
        return linear_recurrence_plain(log_a, x)
    dev = x.device
    b, s, c = x.shape
    dtype = x.dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"linear_recurrence takes float32 or bfloat16, got "
                        f"{x.dtype}")
    log_a, x = log_a.contiguous(), x.contiguous()
    _build.require(log_a, "log_a", dev, dtype, (b, s, c))
    _build.require(x, "x", dev, dtype, (b, s, c))
    out = torch.empty((b, s, c), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    vec = linrec_vector_bytes(c, x.element_size(), log_a.data_ptr(),
                              x.data_ptr())
    lib = _build.library()
    with _build.on(dev):
        code = lib.seq_linear_recurrence(
            _build.ptr(log_a), _build.ptr(x), _build.ptr(out), b, s, c,
            _DTYPE_CODE[dtype], vec, _build.stream(dev))
    _build.check(code, "linear_recurrence")
    LAUNCHES["linear_recurrence"] += 1
    return out

"""The substrate's two sequence kernels: wrappers, plain versions, launch
counts.

Each kernel is hand-written CUDA for ``sm_90a`` in ``csrc/seq_ops.cu``
(built by ``_build``) and replaces one Pallas kernel of the reference:

* ``flash_attention`` -- causal / sliding-window GQA online-softmax
  attention forward (``kernels/flash_attention.py::_attn_kernel``);
* ``linear_recurrence`` -- the diagonal scan h_t = exp(log_a_t)·h_{t-1} +
  x_t with an fp32 carry (``kernels/linear_recurrence.py::_linrec_kernel``).

The public layout is the reference's ``kernels/ops.py``: attention takes and
returns (B, S, H, D), the recurrence (B, S, C).  A wrapper given CPU
tensors runs the kernel's plain PyTorch version (``attention_plain``,
``linear_recurrence_plain``, the reference's ``kernels/ref.py`` oracles);
given CUDA tensors it launches the kernel or raises -- there is no
fallback.  ``LAUNCHES`` counts, per wrapper, the kernel launches it made
and nothing else.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import _build

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "linear_recurrence": 0}

NEG_INF = -2.0e38
# the flash kernel's tiles (csrc/seq_ops.cu: kFlashBQ, kFlashBK, kFlashMaxD)
FLASH_BQ = 64
FLASH_BK = 64
FLASH_MAX_D = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, S, H, D), k/v (B, S, KV, D) -> (B, S, H, D): the full score
    matrix, masked and soft-maxed, as the reference's ``attention_ref``
    computes it (scores in q's dtype, then fp32; probabilities in v's)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg * d ** -0.5,
                          k.to(q.dtype)).float()
    pos = torch.arange(s, device=q.device)
    qp, kp = pos[:, None], pos[None, :]
    allowed = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        allowed &= kp <= qp
    if window:
        allowed &= kp > qp - window
    logits = torch.where(allowed, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, s, h, d)


def flash_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one flash block: the fp32 Q and K tiles
    (rows padded by one float), the V tile and the probabilities."""
    return 4 * (FLASH_BQ * (d + 1) + FLASH_BK * (d + 1) + FLASH_BK * d
                + FLASH_BQ * (FLASH_BK + 1))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, S, H, D), k/v (B, S, KV, D) -> (B, S, H, D) in q's dtype.

    ``window`` > 0 lets query p see keys in (p - window, p] (with
    ``causal``) or (p - window, S) (without).  Any S; D a multiple of 16
    up to 256; float32 or bfloat16."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window)
    dev = q.device
    b, s, h, d = q.shape
    kv = k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if kv == 0 or h % kv:
        raise ValueError(f"flash_attention: {kv} KV heads do not divide "
                         f"{h} heads")
    if d % 16 or d > FLASH_MAX_D:
        raise ValueError(f"flash_attention: head dim {d} must be a multiple "
                         f"of 16 and at most {FLASH_MAX_D}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    _build.require(q, "q", dev, q.dtype, (b, s, h, d))
    _build.require(k, "k", dev, q.dtype, (b, s, kv, d))
    _build.require(v, "v", dev, q.dtype, (b, s, kv, d))
    smem = flash_smem_bytes(d)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"flash_attention needs {smem} bytes of shared "
                         f"memory a block (D={d}); the H100 allows "
                         f"{_build.MAX_SMEM_BYTES}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.seq_flash_attention(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            b, s, h, kv, d, int(causal), int(window), float(d ** -0.5),
            _DTYPE_CODE[q.dtype], smem, _build.stream(dev))
    _build.check(code, "flash_attention")
    LAUNCHES["flash_attention"] += 1
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


def linear_recurrence(log_a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """log_a, x (B, S, C), both float32 or both bfloat16 -> h (B, S, C)
    float32."""
    if log_a.dtype != x.dtype:
        raise TypeError(f"linear_recurrence: log_a is {log_a.dtype}, x is "
                        f"{x.dtype}; they must match")
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
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.seq_linear_recurrence(
            _build.ptr(log_a), _build.ptr(x), _build.ptr(out), b, s, c,
            _DTYPE_CODE[dtype], _build.stream(dev))
    _build.check(code, "linear_recurrence")
    LAUNCHES["linear_recurrence"] += 1
    return out

"""The port's two sequence kernels, held to the JAX reference on the CPU.

On CPU tensors ``repro_torch.kernels.seq_ops.flash_attention`` and
``linear_recurrence`` run their plain versions; these tests hold those to
the reference's Pallas kernels in interpret mode
(``ops.flash_attention`` / ``ops.linear_recurrence``) and to its jnp
oracles (``ref.attention_ref``, ``rglru_scan``), on the same numpy inputs.
Tolerances are those of the reference's ``tests/test_kernels.py``: float32
attention atol = rtol = 2e-5; the recurrence atol 1e-5, rtol 1e-4 (the
associative scan sums in another order); bfloat16 attention 0.05 against
the float32 oracle.  The CUDA kernels are held to the plain versions on
the card by ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models.rglru import rglru_scan
from repro_torch.kernels import _build, seq_ops
from _torch_threads import one_torch_thread  # noqa: F401

ATTN_TOL = dict(atol=2e-5, rtol=2e-5)
LINREC_TOL = dict(atol=1e-5, rtol=1e-4)


def _qkv(seed, b, s, h, kv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, s, kv, d)).astype(np.float32),
            rng.normal(size=(b, s, kv, d)).astype(np.float32))


def _ref_bshd(q, k, v, **kw):
    """The reference's oracle on (B, S, H, D) inputs."""
    t = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)     # noqa: E731
    return np.asarray(ref.attention_ref(t(q), t(k), t(v), **kw)
                      .transpose(0, 2, 1, 3), np.float32)


@pytest.mark.parametrize("b,s,h,kv,d,causal,window", [
    (1, 128, 2, 2, 32, True, 0),       # MHA, causal
    (2, 128, 4, 2, 64, True, 16),      # GQA, window smaller than a tile
    (1, 128, 4, 1, 64, True, 64),      # MQA, window 64
    (1, 128, 4, 1, 32, False, 0),      # MQA, non-causal
    (2, 128, 4, 2, 32, False, 48),     # GQA, non-causal window
])
def test_flash_plain_matches_pallas_and_oracle(b, s, h, kv, d, causal,
                                               window):
    q, k, v = _qkv(s + d + window, b, s, h, kv, d)
    got = seq_ops.flash_attention(torch.tensor(q), torch.tensor(k),
                                  torch.tensor(v), causal=causal,
                                  window=window).numpy()
    want_pallas = ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want_pallas), **ATTN_TOL)
    np.testing.assert_allclose(got, _ref_bshd(q, k, v, causal=causal,
                                              window=window), **ATTN_TOL)
    assert seq_ops.LAUNCHES["flash_attention"] == 0     # CPU: no launch


def test_flash_plain_ragged_length():
    """S not a multiple of any tile (the CUDA kernel masks it; the Pallas
    kernel requires multiples, so the oracle is the reference)."""
    q, k, v = _qkv(3, 1, 100, 4, 1, 32)
    got = seq_ops.flash_attention(torch.tensor(q), torch.tensor(k),
                                  torch.tensor(v), causal=True, window=30)
    np.testing.assert_allclose(got.numpy(),
                               _ref_bshd(q, k, v, causal=True, window=30),
                               **ATTN_TOL)


def test_flash_plain_bf16():
    q, k, v = _qkv(4, 1, 128, 2, 2, 32)
    bf = [torch.tensor(a).to(torch.bfloat16) for a in (q, k, v)]
    got = seq_ops.flash_attention(*bf, causal=True)
    assert got.dtype == torch.bfloat16
    want = _ref_bshd(*(t.float().numpy() for t in bf), causal=True)
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.05,
                               rtol=0.05)


@pytest.mark.parametrize("b,s,c", [(1, 64, 128), (2, 128, 256)])
def test_linear_recurrence_plain_matches_pallas_and_scan(b, s, c):
    rng = np.random.default_rng(b * s + c)
    log_a = -rng.uniform(0.001, 2.0, (b, s, c)).astype(np.float32)
    x = rng.normal(size=(b, s, c)).astype(np.float32)
    got = seq_ops.linear_recurrence(torch.tensor(log_a),
                                    torch.tensor(x)).numpy()
    want_pallas = ops.linear_recurrence(jnp.asarray(log_a), jnp.asarray(x),
                                        block_t=64, interpret=True)
    want_scan = jax.jit(rglru_scan)(jnp.asarray(log_a), jnp.asarray(x))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want_pallas), **LINREC_TOL)
    np.testing.assert_allclose(got, np.asarray(want_scan), **LINREC_TOL)
    assert seq_ops.LAUNCHES["linear_recurrence"] == 0


def test_linear_recurrence_plain_bf16_inputs():
    rng = np.random.default_rng(7)
    log_a = torch.tensor(-rng.uniform(0.01, 1.0, (1, 64, 32))
                         .astype(np.float32)).to(torch.bfloat16)
    x = torch.tensor(rng.normal(size=(1, 64, 32)).astype(np.float32)) \
        .to(torch.bfloat16)
    got = seq_ops.linear_recurrence(log_a, x)
    assert got.dtype == torch.float32                  # fp32 carry
    want = jax.jit(ref.linear_recurrence_ref)(
        jnp.asarray(log_a.float().numpy()), jnp.asarray(x.float().numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LINREC_TOL)


@pytest.mark.parametrize("la_dtype,x_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_linear_recurrence_rejects_mixed_dtypes(la_dtype, x_dtype):
    """No silent upcast: the two inputs come in one dtype."""
    log_a = torch.zeros((1, 4, 8), dtype=la_dtype)
    x = torch.zeros((1, 4, 8), dtype=x_dtype)
    with pytest.raises(TypeError, match="must match"):
        seq_ops.linear_recurrence(log_a, x)


def test_flash_shared_memory_fits_d256():
    """recurrentgemma's d_head = 256 fits one block's shared memory; the
    wrapper's size check is the one the launch relies on."""
    assert seq_ops.flash_smem_bytes(256) == 213_760
    assert seq_ops.flash_smem_bytes(256) <= _build.MAX_SMEM_BYTES
    assert seq_ops.flash_smem_bytes(288) > _build.MAX_SMEM_BYTES


def test_build_covers_every_source():
    """One library from every csrc/*.cu, and every entry point of the
    sources has its ctypes signature."""
    names = {p.name for p in _build.sources()}
    assert {"hfl_ops.cu", "seq_ops.cu", "flash_wgmma.cu"} <= names
    for name in ("seq_flash_attention", "seq_flash_attention_wgmma",
                 "seq_linear_recurrence", "hfl_local_sgd",
                 "hfl_local_sgd_cluster", "hfl_sgd_max_active_clusters"):
        assert name in _build._SIGNATURES
        assert any(f"int {name}(" in p.read_text() for p in _build.sources())


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 256, "seq_flash_attention_wgmma"),
    (torch.bfloat16, 128, "seq_flash_attention_wgmma"),
    (torch.bfloat16, 64, "seq_flash_attention_wgmma"),
    (torch.float32, 256, "seq_flash_attention"),    # fp32 tolerance: no bf16 P
    (torch.float32, 64, "seq_flash_attention"),
    (torch.bfloat16, 80, "seq_flash_attention"),    # not a multiple of 64
    (torch.bfloat16, 32, "seq_flash_attention"),
])
def test_flash_route_is_a_function_of_dtype_and_head_dim(dtype, d, route):
    """The card's flash kernel is chosen by (dtype, D) alone, and each
    choice is an entry point of the library."""
    assert seq_ops.flash_route(dtype, d) == route
    assert route in _build._SIGNATURES


def test_flash_wgmma_shared_memory_fits_every_head_dim():
    """The tensor-core kernel's block at D = 256: the bf16 Q tile (64 KB),
    two stages of K and V (128 KB), barriers and alignment slack."""
    assert seq_ops.flash_wgmma_smem_bytes(256) == 197_760
    for d in seq_ops.WGMMA_HEAD_DIMS:
        assert seq_ops.flash_wgmma_smem_bytes(d) <= _build.MAX_SMEM_BYTES


def test_flash_wgmma_tiles_match_the_source():
    """The wrapper's copy of the kernel's tile constants (from which it
    sizes the shared memory it asks for) equals the source's."""
    src = (_build.CSRC / "flash_wgmma.cu").read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kBQ"] == seq_ops.WGMMA_BQ
    assert consts["kBK"] == seq_ops.WGMMA_BK
    assert consts["kStages"] == seq_ops.WGMMA_STAGES
    assert (consts["kBarBytes"], consts["kAlign"]) == (128, 1024)
    for d in seq_ops.WGMMA_HEAD_DIMS:
        assert f"case {d}:" in src


@pytest.mark.parametrize("d,causal,window", [(64, True, 32),
                                             (128, False, 48)])
def test_flash_plain_bf16_at_tensor_core_head_dims(d, causal, window):
    """bf16 at the head dims the card sends to the tensor-core kernel: the
    CPU path (the plain version, no launch) against the reference's Pallas
    kernel in interpret mode on the same bf16 values, at the bf16
    tolerance above."""
    q, k, v = _qkv(d + window, 1, 128, 4, 2, d)
    bf = [torch.tensor(a).to(torch.bfloat16) for a in (q, k, v)]
    before = dict(seq_ops.LAUNCHES)
    got = seq_ops.flash_attention(*bf, causal=causal, window=window)
    assert seq_ops.LAUNCHES == before
    want = ops.flash_attention(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in bf),
        causal=causal, window=window, block_q=64, block_k=64,
        interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=0.05,
                               rtol=0.05)


def test_linrec_ring_matches_the_source():
    """The wrapper's copy of the recurrence kernel's ring constants equals
    the source's; the fp32 ring (log_a and x) is 64 KB a block."""
    src = (_build.CSRC / "seq_ops.cu").read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kLinrecChannels"] == seq_ops.LINREC_CHANNELS
    assert consts["kLinrecTile"] == seq_ops.LINREC_TILE
    assert consts["kLinrecStages"] == seq_ops.LINREC_STAGES
    ring = 2 * 4 * seq_ops.LINREC_STAGES * seq_ops.LINREC_TILE \
        * seq_ops.LINREC_CHANNELS
    assert ring == 65_536 <= _build.MAX_SMEM_BYTES


@pytest.mark.parametrize("c,itemsize,ptrs,vec", [
    (4096, 4, (0, 512), 16),    # the main shape
    (130, 4, (0, 0), 8),        # 520-byte rows
    (64, 4, (4, 0), 4),         # an input 4 bytes past a 16-byte boundary
    (4096, 2, (0, 0), 16),
    (130, 2, (0, 0), 4),        # 260-byte rows
    (13, 2, (0, 0), 2),         # odd C in bf16: 2-byte copies
])
def test_linrec_copy_width(c, itemsize, ptrs, vec):
    assert seq_ops.linrec_vector_bytes(c, itemsize, *ptrs) == vec


# -- a block of queries at an offset (context parallelism) -----------------

# (mask kind, its keyword, the block [lo, hi) of S = 300 positions): a
# rank-0 block, blocks at multiples of both kernels' tiles (64, 128), at a
# multiple of 64 alone and at neither, the last one through the end, and a
# window block whose first rows' windows start before position 0
OFFSET_MASKS = {"global": dict(causal=True),
                "sliding": dict(causal=True, window=100),
                "chunked": dict(causal=True, chunk=96),
                "prefix": dict(causal=True, prefix_len=150)}
OFFSET_BLOCKS = [(0, 75), (128, 256), (64, 200), (77, 300), (30, 97)]
OFFSET_CASES = [(m, lo, hi) for m in OFFSET_MASKS
                for lo, hi in OFFSET_BLOCKS]


@pytest.mark.parametrize("kind,lo,hi", OFFSET_CASES,
                         ids=[f"{m}-{lo}-{hi}" for m, lo, hi in OFFSET_CASES])
def test_flash_plain_query_block_at_offset(kind, lo, hi):
    """``attention_plain(q[:, lo:hi], k, v, q_offset=lo)`` is rows [lo, hi)
    of the whole sequence's plain attention (bit for bit: the same scores
    of the same rows), and the reference's ``_sdpa`` with ``q_pos = lo +
    arange``; the wrapper on the CPU runs it without a launch."""
    from repro.models import attention as jattention
    s, mask = 300, OFFSET_MASKS[kind]
    q, k, v = _qkv(lo + hi, 2, s, 6, 2, 32)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    whole = seq_ops.attention_plain(tq, tk, tv, **mask)
    got = seq_ops.attention_plain(tq[:, lo:hi], tk, tv, q_offset=lo, **mask)
    np.testing.assert_array_equal(got.numpy(), whole[:, lo:hi].numpy())
    before = dict(seq_ops.LAUNCHES)
    np.testing.assert_array_equal(
        seq_ops.flash_attention(tq[:, lo:hi], tk, tv, q_offset=lo,
                                **mask).numpy(), got.numpy())
    assert seq_ops.LAUNCHES == before
    want = jattention._sdpa(jnp.asarray(q[:, lo:hi]), jnp.asarray(k),
                            jnp.asarray(v), jnp.arange(lo, hi),
                            jnp.arange(s), kind,
                            window=mask.get("window", 0),
                            chunk=mask.get("chunk", 0),
                            prefix_len=mask.get("prefix_len", 0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def test_flash_query_offset_refusals():
    """A block must lie inside the keys and take a mask; without an offset
    two lengths still take full attention only; the backward recomputes
    the block through the plain version."""
    q = torch.zeros((1, 8, 2, 16))
    k = torch.zeros((1, 20, 2, 16))
    for off in (-1, 13):
        with pytest.raises(ValueError, match="must lie inside"):
            seq_ops.flash_attention(q, k, k, q_offset=off)
    with pytest.raises(ValueError, match="full attention takes none"):
        seq_ops.flash_attention(q, k, k, causal=False, q_offset=4)
    with pytest.raises(ValueError, match="full attention only"):
        seq_ops.flash_attention(q, k, k)
    seq_ops.check_mask(True, 0, 0, 0, 8, 20, 12)
    rng = np.random.default_rng(5)
    tq, tk, tv = (torch.tensor(rng.normal(size=(1, n, 2, 16)),
                               dtype=torch.float32, requires_grad=True)
                  for n in (8, 20, 20))
    out = seq_ops.flash_attention(tq, tk, tv, window=6, q_offset=7)
    grads = torch.autograd.grad(out.sum(), (tq, tk, tv))
    leaves = [t.detach().requires_grad_() for t in (tq, tk, tv)]
    want = torch.autograd.grad(seq_ops.attention_plain(
        *leaves, window=6, q_offset=7).sum(), leaves)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)

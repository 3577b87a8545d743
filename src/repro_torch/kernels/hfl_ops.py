"""The HFL round's kernels: wrappers, plain versions, launch counts.

Each kernel is hand-written CUDA for ``sm_90a`` in ``csrc/hfl_ops.cu``
(built by ``_build``), and replaces one Pallas kernel of the reference's
``kernels/hfl_ops.py``:

* ``score_matrix`` / ``score_candidates`` -- the fused fuzzy score
  (``_score_kernel``) from the raw gains: the Eq. 21 normalisation, the
  frontier's gather and the Mamdani pipeline in one C call, over the dense
  N·M rows or the candidate frontier's N·K rows; ``score_rows`` -- the
  pipeline alone on normalised rows (the reference's ``_score_rows``);
* ``sic_rates`` -- NOMA SIC rates for every edge (``_sic_kernel``), one
  thread-block cluster an edge over the edge's own clients;
* ``local_sgd_step`` -- τ₁ fused local-SGD steps per lane (``_sgd_kernel``):
  one thread-block cluster per lane wherever its slices fit shared
  memory, one block per lane otherwise; ``sgd_route`` says which.

The score and SIC wrappers also take a fleet's inputs, with a leading seed
axis: one call for the fleet, a grid row a seed, and each seed's result
the bits of its own call.  A fleet's SGD lanes are simply more lanes.

A wrapper given CPU tensors runs the kernel's plain PyTorch version
(``fuzzy.score_matrix``/``score_candidates`` over ``score_rows_plain``,
``sic_rates_plain``, ``local_sgd_step_plain``); given CUDA tensors it
launches the kernel or raises -- there is no fallback.  ``LAUNCHES``
counts, per entry point, the kernel calls it made and nothing else, so a
run can show that its path went through the kernels: ``score_matrix`` and
``score_candidates`` count the fused calls, ``score_rows`` the rows-only
one; ``local_sgd_step_cluster`` counts the SGD launches that went to the
cluster kernel (``local_sgd_step`` counts them all).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import fuzzy, noma
from repro_torch.kernels import _build
from repro_torch.kernels._build import MAX_SMEM_BYTES
from repro_torch.kernels._build import on as _on
from repro_torch.kernels._build import ptr as _ptr
from repro_torch.kernels._build import require as _require
from repro_torch.kernels._build import stream as _stream
from repro_torch.models.mlp import PARAM_KEYS

LAUNCHES: Dict[str, int] = {"score_rows": 0, "score_matrix": 0,
                            "score_candidates": 0, "sic_rates": 0,
                            "local_sgd_step": 0,
                            "local_sgd_step_cluster": 0}


# the card's SMs (H100 SXM), which the SGD lanes' clusters should not far
# exceed
N_SMS = 132


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Fused fuzzy scoring
# ---------------------------------------------------------------------------

score_rows_plain = fuzzy.score_rows


@functools.cache
def _score_tables(device: torch.device):
    """[3 input triangles | 5 × 201 output memberships] float32 and the
    flattened 27-rule table int32, on ``device``."""
    tables = np.concatenate([fuzzy.IN_TRIS.reshape(-1),
                             fuzzy.OUT_MU.reshape(-1)]).astype(np.float32)
    rules = fuzzy.RULES.reshape(-1).astype(np.int32)
    return (torch.from_numpy(tables).to(device),
            torch.from_numpy(rules).to(device))


def score_rows(cq: torch.Tensor, dq: torch.Tensor, ms: torch.Tensor
               ) -> torch.Tensor:
    """(R,) normalised cq/dq/ms -> (R,) NO* scores."""
    if cq.device.type == "cpu":
        return score_rows_plain(cq, dq, ms)
    dev = cq.device
    rows = cq.shape[0]
    cq, dq, ms = (v.float().contiguous() for v in (cq, dq, ms))
    for name, v in (("cq", cq), ("dq", dq), ("ms", ms)):
        _require(v, name, dev, torch.float32, (rows,))
    out = torch.empty_like(cq)
    if rows == 0:
        return out
    tables, rules = _score_tables(dev)
    lib = _build.library()
    with _on(dev):
        code = lib.hfl_score_rows(_ptr(cq), _ptr(dq), _ptr(ms), _ptr(tables),
                                  _ptr(rules), _ptr(out), rows, _stream(dev))
    _build.check(code, "score_rows")
    LAUNCHES["score_rows"] += 1
    return out


# the fused score's pass 1 (csrc/hfl_ops.cu: kNormBlocksMax, kNormItems,
# kScoreBlock): at most this many partials, a thread taking at least
# SCORE_NORM_ITEMS gains before another block is added
SCORE_NORM_BLOCKS_MAX = 256
SCORE_NORM_ITEMS = 4
SCORE_BLOCK = 256


def score_partials(n: int, m: int) -> int:
    """Blocks of the fused score's reduction over the (N, M) field, and so
    the (min dB, max dB, max staleness) partials its scratch holds."""
    per_block = SCORE_BLOCK * SCORE_NORM_ITEMS
    return max(1, min(SCORE_NORM_BLOCKS_MAX, -(-n * m // per_block)))


# the fused score's and the SIC's grids take one seed a y index
MAX_SEEDS = 65535


def _seeds(lead) -> int:
    """Seeds of a leading fleet shape (1 for none), checked against the
    kernels' y grid dimension."""
    seeds = int(np.prod(lead, dtype=np.int64))
    if seeds > MAX_SEEDS:
        raise ValueError(f"{seeds} seeds exceed the kernels' {MAX_SEEDS} "
                         f"grid rows")
    return seeds


def _score_fused(gains: torch.Tensor, counts: torch.Tensor,
                 staleness: torch.Tensor, cand_idx, data_max: float,
                 counter: str) -> torch.Tensor:
    """One C call, two launches: the Eq. 21 reduction over the raw (N, M)
    gains and the staleness into a scratch of partials, then the rows --
    (N, K) on the frontier ``cand_idx``, (N, M) dense when it is None --
    normalised, gathered and scored.  Over a fleet every input has a
    leading seed axis (or axes) and both launches a grid row a seed: each
    seed's partials and its rows are its own.  The inputs are taken as the
    engine keeps them (gains and counts float32, staleness and
    ``cand_idx`` int32), with no cast or copy: one ``torch.empty`` for
    the output, one for the scratch."""
    dev = gains.device
    lead, (n, m) = gains.shape[:-2], gains.shape[-2:]
    k = 0 if cand_idx is None else cand_idx.shape[-1]
    _require(gains, "gains", dev, torch.float32, lead + (n, m))
    _require(counts, "counts", dev, torch.float32, lead + (n,))
    _require(staleness, "staleness", dev, torch.int32, lead + (n,))
    if cand_idx is not None:
        _require(cand_idx, "cand_idx", dev, torch.int32, lead + (n, k))
    if n * m >= 2 ** 31:
        raise ValueError(f"score: {n} x {m} gains exceed the kernel's int32 "
                         f"row index")
    seeds = _seeds(lead)
    out = torch.empty(lead + (n, k if cand_idx is not None else m),
                      dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    parts = score_partials(n, m)
    scratch = torch.empty((seeds * 3 * parts,), dtype=torch.float32,
                          device=dev)
    tables, rules = _score_tables(dev)
    lib = _build.library()
    with _on(dev):
        code = lib.hfl_score_fused(
            _ptr(gains), _ptr(counts), _ptr(staleness),
            None if cand_idx is None else _ptr(cand_idx), _ptr(tables),
            _ptr(rules), _ptr(scratch), parts, _ptr(out), n, m, k, seeds,
            max(float(data_max), 1e-12), _stream(dev))
    _build.check(code, counter)
    LAUNCHES[counter] += 1
    return out


def score_matrix(gains: torch.Tensor, counts: torch.Tensor,
                 staleness: torch.Tensor, *, data_max: float) -> torch.Tensor:
    """(N, M) competency scores (replaces the reference's
    ``hfl_ops.score_matrix``), or (S, N, M) over a fleet's (S, N, M)
    gains and (S, N) counts and staleness: on the card one fused call
    from the raw gains (``_score_fused``); on the CPU the plain
    ``fuzzy.score_matrix``."""
    if gains.device.type == "cpu":
        return fuzzy.score_matrix(gains, counts, staleness, data_max=data_max,
                                  rows=score_rows_plain)
    return _score_fused(gains, counts, staleness, None, data_max,
                        "score_matrix")


def score_candidates(gains: torch.Tensor, cand_idx: torch.Tensor,
                     counts: torch.Tensor, staleness: torch.Tensor, *,
                     data_max: float) -> torch.Tensor:
    """(N, K) competency scores on the candidate frontier ``cand_idx``
    (replaces the reference's ``hfl_ops.score_candidates``), or (S, N, K)
    over a fleet: the dense Eq. 21 normalisation over the whole (N, M)
    field, then the N·K gathered rows only -- on the card in one fused
    call (``_score_fused``), on the CPU through the plain
    ``fuzzy.candidate_inputs`` and rows."""
    if gains.device.type == "cpu":
        return score_rows_plain(*fuzzy.candidate_inputs(
            gains, cand_idx, counts, staleness, data_max=data_max)
        ).reshape(cand_idx.shape)
    return _score_fused(gains, counts, staleness, cand_idx, data_max,
                        "score_candidates")


# ---------------------------------------------------------------------------
# NOMA SIC rates
# ---------------------------------------------------------------------------

def sic_rates_plain(power_w: torch.Tensor, gains: torch.Tensor,
                    mask: torch.Tensor, *, bandwidth_hz: float,
                    noise_w: float) -> torch.Tensor:
    """The pairwise SIC of ``noma.achievable_rates``, one edge at a time:
    (N,) power, (N, M) gains, (N, M) bool mask -> (N, M) rates; over a
    fleet ((S, N), (S, N, M)), one (seed, edge) column at a time."""
    lead, (n, m) = gains.shape[:-2], gains.shape[-2:]
    p, g, msk = (power_w.reshape(-1, n), gains.reshape(-1, n, m),
                 mask.reshape(-1, n, m))
    return torch.stack(
        [torch.stack([noma.achievable_rates(
            p[s], g[s, :, e], bandwidth_hz=bandwidth_hz, noise_w=noise_w,
            mask=msk[s, :, e]) for e in range(m)], dim=1)
         for s in range(g.shape[0])]).reshape(lead + (n, m))


# the SIC kernel's CTA (csrc/hfl_ops.cu: kSicThreads, kSicChunk), its
# static shared memory (the j loop's staging chunk, the ballot counts and
# the cluster's offsets, rounded up) and the cluster sizes it takes
# (kSicMaxCluster, a power of two)
SIC_THREADS = 256
SIC_CHUNK = 2048
SIC_STATIC_SMEM_BYTES = 4 * SIC_CHUNK + 256
SIC_CLUSTER_SIZES = (1, 2, 4, 8)


def sic_smem_bytes(n: int, cluster: int) -> int:
    """Dynamic shared memory of one CTA of the SIC kernel: its slice of
    ⌈N/c⌉ clients' compacted (rx, client) pairs, 8 bytes each."""
    return 8 * -(-n // cluster)


def _sic_fits(n: int, cluster: int) -> bool:
    return sic_smem_bytes(n, cluster) + SIC_STATIC_SMEM_BYTES \
        <= MAX_SMEM_BYTES


@functools.lru_cache(maxsize=256)
def sic_cluster_size(n: int) -> int:
    """CTAs an edge's cluster gets, from N: of the sizes in
    ``SIC_CLUSTER_SIZES`` whose slice fits shared memory, the largest that
    still gives each CTA at least a block's worth (``SIC_THREADS``) of
    clients, else the smallest that fits; 0 when none fits (N beyond
    what 8 CTAs hold)."""
    fits = [c for c in SIC_CLUSTER_SIZES if _sic_fits(n, c)]
    if not fits:
        return 0
    spread = [c for c in fits if -(-n // c) >= SIC_THREADS]
    return max(spread) if spread else fits[0]


def sic_rates(power_w: torch.Tensor, gains: torch.Tensor, mask: torch.Tensor,
              *, bandwidth_hz: float, noise_w: float) -> torch.Tensor:
    """(N,) power, (N, M) gains, (N, M) bool mask -> (N, M) SIC rates;
    masked entries are zero.  Over a fleet: (S, N), (S, N, M) and
    (S, N, M) -> (S, N, M).  On the card one launch covers every edge of
    every seed, one thread-block cluster an edge of
    ``sic_cluster_size(N)`` CTAs (so each seed's rates are the bits it
    gets alone), reading the caller's tensors as they are: no cast,
    transpose or copy; the result is the kernel's own output."""
    if power_w.device.type == "cpu":
        return sic_rates_plain(power_w, gains, mask.bool(),
                               bandwidth_hz=bandwidth_hz, noise_w=noise_w)
    return _sic_launch(power_w, gains, mask, sic_cluster_size(gains.shape[-2]),
                       bandwidth_hz=bandwidth_hz, noise_w=noise_w)


def _sic_launch(power_w: torch.Tensor, gains: torch.Tensor,
                mask: torch.Tensor, cluster: int, *, bandwidth_hz: float,
                noise_w: float) -> torch.Tensor:
    """The SIC kernel on the card with ``cluster`` CTAs an edge, a grid
    row a seed."""
    dev = power_w.device
    lead, (n, m) = gains.shape[:-2], gains.shape[-2:]
    _require(power_w, "power_w", dev, torch.float32, lead + (n,))
    _require(gains, "gains", dev, torch.float32, lead + (n, m))
    _require(mask, "mask", dev, torch.bool, lead + (n, m))
    if cluster not in SIC_CLUSTER_SIZES or not _sic_fits(n, cluster):
        raise ValueError(f"sic_rates: no cluster of {cluster} CTAs holds "
                         f"N={n} (sizes {SIC_CLUSTER_SIZES}, "
                         f"{MAX_SMEM_BYTES} bytes of shared memory a CTA)")
    seeds = _seeds(lead)
    out = torch.empty(lead + (n, m), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with _on(dev):
        code = lib.hfl_sic_rates(_ptr(power_w), _ptr(gains), _ptr(mask),
                                 _ptr(out), n, m, seeds, cluster,
                                 float(bandwidth_hz), float(noise_w),
                                 _stream(dev))
    _build.check(code, "sic_rates")
    LAUNCHES["sic_rates"] += 1
    return out


# ---------------------------------------------------------------------------
# Fused local SGD
# ---------------------------------------------------------------------------

def local_sgd_step_plain(params: Dict[str, torch.Tensor], bx: torch.Tensor,
                         by: torch.Tensor, *, lr: float
                         ) -> Dict[str, torch.Tensor]:
    """τ₁ SGD steps of every lane by the hand chain: forward, dlogits =
    (softmax − onehot)/B, two transposed batched GEMMs per layer, update."""
    tau1, _, batch, _ = bx.shape
    w1, b1, w2, b2, w3, b3 = (params[k].float() for k in PARAM_KEYS)
    inv_b = 1.0 / float(batch)
    for t in range(tau1):
        x, y = bx[t].float(), by[t].long()
        h1p = torch.bmm(x, w1) + b1[:, None, :]
        h1 = torch.relu(h1p)
        h2p = torch.bmm(h1, w2) + b2[:, None, :]
        h2 = torch.relu(h2p)
        logits = torch.bmm(h2, w3) + b3[:, None, :]             # (K, B, V)
        zmax = torch.amax(logits, dim=-1, keepdim=True)
        ez = torch.exp(logits - zmax)
        probs = ez / torch.sum(ez, dim=-1, keepdim=True)
        onehot = torch.nn.functional.one_hot(y, logits.shape[-1]).float()
        dl = (probs - onehot) * inv_b
        dw3 = torch.bmm(h2.transpose(1, 2), dl)
        db3 = torch.sum(dl, dim=1)
        dh2 = torch.bmm(dl, w3.transpose(1, 2)) * (h2p > 0.0)
        dw2 = torch.bmm(h1.transpose(1, 2), dh2)
        db2 = torch.sum(dh2, dim=1)
        dh1 = torch.bmm(dh2, w2.transpose(1, 2)) * (h1p > 0.0)
        dw1 = torch.bmm(x.transpose(1, 2), dh1)
        db1 = torch.sum(dh1, dim=1)
        w1, b1 = w1 - lr * dw1, b1 - lr * db1
        w2, b2 = w2 - lr * dw2, b2 - lr * db2
        w3, b3 = w3 - lr * dw3, b3 - lr * db3
    return dict(zip(PARAM_KEYS, (w1, b1, w2, b2, w3, b3)))


# the cluster sizes the SGD kernel takes (csrc/hfl_ops.cu: kMaxCluster, a
# power of two)
SGD_CLUSTER_SIZES = (1, 2, 4, 8)


def _round4(n: int) -> int:
    return (n + 3) & ~3


def sgd_smem_bytes(batch: int, d_in: int, hidden: int, n_classes: int,
                   cluster: int) -> int:
    """Dynamic shared memory of one CTA of the cluster kernel
    (csrc/hfl_ops.cu: sgd_cluster_smem_floats), fp32, each buffer rounded
    up to 16 bytes: one region for x's columns of the CTA's ⌈D/c⌉ rows of
    W1 (transposed, ⌈D/c⌉ × B, stride rounded to 4), relu(h2) and the
    partial dh1
    (B × H); those W1 rows (⌈D/c⌉ × H); b1, b2 and W2's columns on its H/c
    hidden units; the full W3 and b3; one B × H buffer (partial h1p,
    relu(h1), dh1); its slices of h1p, h2p, dh2 and dh1 (B × H/c) and the
    logits (B × V)."""
    r4 = _round4
    rows, hc = -(-d_in // cluster), hidden // cluster
    region = r4(max(batch * hidden, r4(batch) * rows))
    return 4 * (region + r4(rows * hidden) + 2 * r4(hc) + r4(hidden * hc)
                + r4(hidden * n_classes) + r4(n_classes)
                + r4(batch * hidden) + 4 * r4(batch * hc)
                + r4(batch * n_classes))


def sgd_block_smem_bytes(batch: int, hidden: int, n_classes: int) -> int:
    """Dynamic shared memory of the block-per-lane kernel: h1p, h2p, dh2,
    dh1 (B × H each) and the logits (B × V), float32."""
    return 4 * (4 * batch * hidden + batch * n_classes)


@functools.lru_cache(maxsize=64)
def sgd_cluster_size(k: int, batch: int, d_in: int, hidden: int,
                     n_classes: int) -> int:
    """CTAs a lane's cluster gets: of the sizes in ``SGD_CLUSTER_SIZES``
    that divide ``hidden`` and whose CTA fits shared memory, the largest
    with k·c ≤ ``N_SMS`` (the most SMs without a second wave), else the
    smallest; 0 when none fits."""
    fits = [c for c in SGD_CLUSTER_SIZES if hidden % c == 0
            and sgd_smem_bytes(batch, d_in, hidden, n_classes, c)
            <= MAX_SMEM_BYTES]
    if not fits:
        return 0
    under = [c for c in fits if k * c <= N_SMS]
    return max(under) if under else min(fits)


def sgd_route(k: int, batch: int, d_in: int, hidden: int,
              n_classes: int) -> str:
    """The C entry point a CUDA call of ``local_sgd_step`` launches, from
    the shape alone: the cluster kernel wherever a cluster size fits, the
    block-per-lane kernel otherwise (a layer too wide for any CTA's
    slice)."""
    if sgd_cluster_size(k, batch, d_in, hidden, n_classes):
        return "hfl_local_sgd_cluster"
    return "hfl_local_sgd"


def sgd_max_active_clusters(k: int, batch: int, d_in: int, hidden: int,
                            n_classes: int) -> int:
    """How many of the cluster kernel's clusters the current card holds at
    once at this shape (``cudaOccupancyMaxActiveClusters``)."""
    c = sgd_cluster_size(k, batch, d_in, hidden, n_classes)
    if not c:
        raise ValueError("local_sgd_step: no cluster size fits this shape")
    out = ctypes.c_int(0)
    code = _build.library().hfl_sgd_max_active_clusters(
        k, batch, d_in, hidden, n_classes, c,
        sgd_smem_bytes(batch, d_in, hidden, n_classes, c), ctypes.byref(out))
    _build.check(code, "sgd_max_active_clusters")
    return out.value


def local_sgd_step(params: Dict[str, torch.Tensor], bx: torch.Tensor,
                   by: torch.Tensor, *, lr: float, seeds: int = 1,
                   cluster_lanes: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
    """τ₁ minibatch-SGD steps for every lane of the stacked K-lane cohort.

    params: leaves (K, …) over ``PARAM_KEYS``; bx (τ₁, K, B, D) gathered
    minibatches; by (τ₁, K, B) int labels.  Returns the updated params in
    new tensors; ``params`` is left as it is.  On the card the kernel is
    chosen by ``sgd_route`` and never on failure: an error raises.

    ``seeds``: the K lanes are a fleet's, ``seeds`` cohorts of K / seeds
    lanes.  The cluster kernel takes the cluster size that one cohort
    takes alone: a lane's sums run in an order set by the cluster size, so
    this keeps each seed's result bit-equal to its own single run,
    whatever fleet shares the launch.  ``cluster_lanes`` overrides that
    cohort size: a rank of a client mesh trains a share of one cohort's
    lanes at the cluster size of all of them.
    """
    if seeds < 1 or bx.shape[1] % seeds:
        raise ValueError(f"local_sgd_step: {bx.shape[1]} lanes are not "
                         f"{seeds} equal cohorts")
    if bx.device.type == "cpu":
        return local_sgd_step_plain(params, bx, by, lr=lr)
    dev = bx.device
    tau1, k, batch, d_in = bx.shape
    hidden, n_classes = params["w1"].shape[2], params["w3"].shape[2]
    shapes = {"w1": (k, d_in, hidden), "b1": (k, hidden),
              "w2": (k, hidden, hidden), "b2": (k, hidden),
              "w3": (k, hidden, n_classes), "b3": (k, n_classes)}
    route = sgd_route(k, batch, d_in, hidden, n_classes)
    cluster = route == "hfl_local_sgd_cluster"
    leaves = {}
    for name in PARAM_KEYS:
        leaf = params[name].float().contiguous()
        _require(leaf, name, dev, torch.float32, shapes[name])
        leaves[name] = leaf
    bx = bx.float().contiguous()
    by = by.to(torch.int32).contiguous()
    _require(by, "by", dev, torch.int32, (tau1, k, batch))
    if cluster:
        c = sgd_cluster_size(cluster_lanes or k // seeds, batch, d_in,
                             hidden, n_classes)
        smem = sgd_smem_bytes(batch, d_in, hidden, n_classes, c)
    else:
        smem = sgd_block_smem_bytes(batch, hidden, n_classes)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"local_sgd_step needs {smem} bytes of shared memory "
                         f"a block at every cluster size (B={batch}, "
                         f"D={d_in}, H={hidden}, V={n_classes}); the H100 "
                         f"allows {MAX_SMEM_BYTES}")
    if k == 0 or tau1 == 0:
        return {n: leaves[n].clone() for n in PARAM_KEYS}
    lib = _build.library()
    if cluster:
        out = {n: torch.empty_like(leaves[n]) for n in PARAM_KEYS}
        with _on(dev):
            code = lib.hfl_local_sgd_cluster(
                *(_ptr(leaves[n]) for n in PARAM_KEYS),
                *(_ptr(out[n]) for n in PARAM_KEYS), _ptr(bx), _ptr(by),
                k, tau1, batch, d_in, hidden, n_classes, c, float(lr),
                1.0 / float(batch), smem, _stream(dev))
    else:   # updates in place: the outputs start as copies of the inputs
        out = {n: leaves[n].clone() for n in PARAM_KEYS}
        with _on(dev):
            code = lib.hfl_local_sgd(
                *(_ptr(out[n]) for n in PARAM_KEYS), _ptr(bx), _ptr(by),
                k, tau1, batch, d_in, hidden, n_classes, float(lr),
                1.0 / float(batch), smem, _stream(dev))
    _build.check(code, route)
    LAUNCHES["local_sgd_step"] += 1
    if cluster:
        LAUNCHES["local_sgd_step_cluster"] += 1
    return out

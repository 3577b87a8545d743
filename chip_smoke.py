#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH] [--profile]

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. print the card's ``nvidia-smi`` name and power limit; TF32 off;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. hold each HFL kernel against its plain PyTorch version on the card, at
   the main path's shapes (``CONFIG``) and at the reference bench scale
   (4096 clients × 32 edges), with the tolerances the tests use, and time
   both: the fused dense score (``score_matrix``: the Eq. 21
   normalisation inside the launch) bit for bit, against the unfused
   chain it replaced (the torch normalisation around the rows kernel) in
   turns old, new, new, old, each with its wrapper and device time, and
   on edge gains; the rows kernel; the SIC kernel (a thread-block cluster
   per edge over the edge's own clients) at ``CONFIG``'s quota mask, a
   4096 × 32 one-hot mask and a 4097 × 32 50% mask with exact ties, there
   at every cluster size, each beside its bound counted from the mask;
   the SGD kernel (a thread-block cluster per lane) also at its edge
   shapes (every cluster size, ragged tiles, the block-per-lane route),
   with its cluster size, shared memory and the clusters the card holds
   at once, and its time from a CUDA-graph replay (its wrapper's host
   time exceeds the kernel's);
4. run the HFL main path -- ``HFLSimulation(CONFIG, device="cuda")``: 5
   rounds of fcea + PDD, then 2 rounds of gcea + fastest -- with every
   launch counter zeroed just before and read just after; check the
   counts, the metrics and the per-stage times;
5. run one round on the card and the same state and draws through the
   plain versions on the CPU, and compare;
6. with ``--profile``, profile one more steady fcea round (kernel count
   and the device's busy share);
6b. the candidate path -- ``EngineSpec(candidates_k=k)`` through
   ``engine.round_step``, each run with the launch counters zeroed just
   before and read just after: at ``CONFIG``, K = M = 4 against the dense
   round (same decisions), K = 2 on the card against the CPU, then gcea +
   fastest and rcea + rra + fastest; at the reference bench scale (4096
   clients × 32 edges), dense, K = 8 and K = 4 timed by stage and one K = 4
   round card against CPU; the fused score on the frontier (4096 × 32 at
   K = 8 and 4, 4095 clients at K = 3) bit for bit against its plain
   version, old against new in turns;
6c. the fleet -- ``engine.run_fleet`` over seeds stacked by
   ``stack_fleet``, one batched round for all seeds, with the launch
   counters zeroed just before and read just after (one fused-score call,
   one SIC call and τ₂ SGD launches a round, whatever the number of
   seeds): ``CONFIG`` fcea + PDD, 5 rounds at S = 1 and at S = 8 (seeds
   0-7) in turns S = 1, 8, 8, 1, each timed by round and stage with its
   seed-rounds per second;
   with ``--profile``, one steady S = 8 round profiled; every seed against
   its own ``run_scanned`` (decisions exact, bill rtol 1e-5, loss rtol
   1e-4); the fused score and the SIC at S = 8 against S = 1 in turns,
   each seed of the fleet's call bit-equal to its own call, and the SGD
   kernel at the fleet's 128 lanes against its plain version; one S = 2
   round card against CPU; the bench scale (4096 × 32, K = 8) at S = 4, 3
   rounds, seed 0 against its own run;
6d. dynamic scenarios and the fpa/fca allocators (``[scenario]``), each
   run with the launch counters zeroed just before and read just after:
   ``HFLSimulation(CONFIG, scenario="full_dynamic")``, 5 rounds of fcea +
   PDD beside the static ``[main]`` round, and one round card vs CPU
   (availability, n_available and the decisions exact, the moved
   positions and distances to rtol 1e-6 above 1e-6 of the area's side);
   the reference's static against
   ``full_dynamic`` overhead at 256 × 8 (gcea + fastest, 15 rounds a run,
   in turns static, dynamic, dynamic, static twice over:
   ``dynamic_overhead_pct`` from the medians); its
   sweep fleet of mixed worlds (random_waypoint, markov_dropout,
   hetero_devices × seeds 0-3, S = 12, one kind "dynamic") at 256 × 8, one
   member of each world against its own run; the sync half of its
   sync/buffered A/B at 1024 × 16 under flash_crowd and markov_dropout
   (simulated rounds a second); the frontier under mobility (1024 × 16,
   K = 4, some client's frontier changing every round, card vs CPU); fpa
   and fca at ``CONFIG`` on hetero_devices (two SIC calls a round, the
   grid's (16, N, M) call against its plain version, the action each
   timed round's grid chose exact card vs CPU on that round's own inputs,
   also with time weighted 100:1, and some pick inside the grid); and a
   round with every client dropped (the global
   model bit-equal, the bill finite);
7. hold the sequence kernels (flash attention: the tensor-core kernel for
   bf16 at d_head 64/128/256, the CUDA-core kernel otherwise; linear
   recurrence) against their plain versions at recurrentgemma-9b's
   prefill shapes, at the tensor-core kernel's edge shapes (ragged S,
   S below one q-tile, small and ragged windows, GQA groups 1/2/16,
   d_head 64/128, non-causal, B = 2) and at fp32 shapes, checking which
   kernel each call launched, and the recurrence bit for bit at its main
   shape in fp32 and bf16 and at its edge shapes (ragged S and C, B·C
   below one block, S = 1, odd C in bf16); time the main shapes beside
   their bound and, for attention, PyTorch's
   ``scaled_dot_product_attention``;
8. serve recurrentgemma-9b at full width and depth (random weights from
   a seeded generator): one prefill of 2 × 4096 tokens with the launch
   counters zeroed just before and read just after (12 flash launches,
   all of them to the tensor-core kernel; 26 recurrence launches), timed
   prefills, a token-by-token decode of 2 64-token prompts and 16 greedy
   tokens, and the prefill's last logits against the decode's;
9. the reduced recurrentgemma config (d_head 64, window 32) on the card
   (kernels) against the CPU (plain versions) from the same weights, and
   its prefill's logits at every position of a 300-token prompt (several
   flash tiles, the window skip) against a token-by-token decode on the
   card: in float32 (the CUDA-core flash kernel) and in bfloat16 (the
   tensor-core one);
10. print the per-kernel JSON line (six entries, the kernels the paths
    launch: ``score_matrix`` and ``score_candidates`` are the fused score
    on the two paths; the rows-only ``score_rows``, which only the unfused
    chain launches, has its ``[compare]`` lines alone; ``launches`` counts
    the main path's run and ``scenario_launches`` the ``CONFIG``
    full_dynamic run's) and, last, the device line.

It needs one CUDA device and imports nothing of the JAX reference.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, bf16
# dense tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

TOL = {  # the CPU tests' tolerances (tests/test_torch_kernels.py)
    "score_rows": dict(rtol=1e-5, atol=2e-4),
    "sic_rates": dict(rtol=1e-5, atol_frac=1e-6),
    "local_sgd_step": dict(rtol=2e-5, atol=2e-6),
}
SOURCE = {"score_matrix": "src/repro_torch/kernels/csrc/hfl_ops.cu",
          "score_candidates": "src/repro_torch/kernels/csrc/hfl_ops.cu",
          "sic_rates": "src/repro_torch/kernels/csrc/hfl_ops.cu",
          "local_sgd_step": "src/repro_torch/kernels/csrc/hfl_ops.cu",
          "flash_attention": "src/repro_torch/kernels/csrc/flash_wgmma.cu",
          "linear_recurrence": "src/repro_torch/kernels/csrc/seq_ops.cu"}
REPLACES = {
    "score_matrix": "src/repro/kernels/hfl_ops.py:133",
    "score_candidates": "src/repro/kernels/hfl_ops.py:156",
    "sic_rates": "src/repro/kernels/hfl_ops.py:185",
    "local_sgd_step": "src/repro/kernels/hfl_ops.py:259",
    "flash_attention": "src/repro/kernels/flash_attention.py:34",
    "linear_recurrence": "src/repro/kernels/linear_recurrence.py:29",
}
# the sequence kernels against their plain versions (tests/test_torch_cuda.py):
# float32 -- the kernel and the plain einsum sum in other orders; bfloat16
# inputs -- the plain version in float32 rounded to bf16 once, as the
# kernels compute in float32 (the tensor-core kernel feeds P to its second
# product as two bf16 terms, exact to 2^-17) and round only their output:
# one bf16 ulp (2^-7 relative at most) apart where the two float32 results
# straddle a rounding boundary
FLASH_TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
             "bfloat16": dict(atol=1e-3, rtol=8e-3)}
# bf16 shapes at the tensor-core flash kernel's edges (128 query rows a
# block, 64 keys a K/V tile): (B, S, H, KV, D, causal, window)
WGMMA_EDGES = [
    (1, 100, 4, 1, 256, True, 0),        # S below one q-tile
    (1, 1000, 16, 1, 256, True, 300),    # S and window not multiples of 64
    (2, 300, 4, 2, 128, True, 40),       # window below one tile, group 2
    (1, 200, 4, 4, 64, True, 0),         # MHA (group 1), D = 64
    (1, 333, 4, 2, 128, False, 100),     # non-causal with a window
    (2, 512, 16, 1, 256, False, 0),      # non-causal, MQA (group 16)
]
# prefill (kernels) against token-by-token decode (plain), full config and
# the reduced config in bfloat16: bf16 activations round at 2^-8 in every
# op, at other places on the two paths, so the logits agree to a few
# percent, not to ulps.  The full config's 64-token prompt is one flash
# tile; the reduced config's checks below cover several tiles and the
# window skip, in float32 at a float32 tolerance and in bfloat16 at this one
PREFILL_DECODE_REL_RMS = 5e-2
# card (kernels) against CPU (plain), and prefill (kernels) against
# token-by-token decode (plain) on the card, reduced config in float32: the
# reference's decode-parity tolerance (tests/test_decode_parity.py)
SUBSTRATE_TOL = dict(atol=2e-4, rtol=1e-3)


def log(*a):
    print(*a, flush=True)


def time_ms(fn, *, min_iters=3, budget_s=0.5):
    """Mean device time of ``fn()`` in ms over CUDA events, after warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = max(time.perf_counter() - t0, 1e-6)
    iters = max(min_iters, min(200, int(budget_s / one)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps=20):
    """Device time of one ``fn()`` in ms with no host time in it: ``reps``
    calls captured in one CUDA graph, replayed and timed by ``time_ms``.
    For a kernel whose wrapper takes longer on the host than the kernel on
    the card."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay) / reps


def bound_ms(n_bytes: float, n_ops: float,
             peak_flops: float = PEAK_FP32_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# Kernel inputs and work counts
# ---------------------------------------------------------------------------

SCORE_OPS_PER_ROW = 9 * 7 + 27 * 3 + 201 * 12 + 2
# the Eq. 21 normalisation's elementwise operations per (client, edge)
# pair: clamp, log10, ×10, the min and max, −lo, ÷, clamp, ×100
SCORE_NORM_OPS_PER_PAIR = 9


def score_inputs(rows: int, seed: int, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0.0, 100.0, (3, rows)).astype(np.float32)
    vals[:, ::17] = np.round(vals[:, ::17])          # exact set boundaries
    return [torch.tensor(v, device=dev) for v in vals]


def score_work(rows: int):
    return 4 * rows * 4 + 4 * (9 + 5 * 201 + 27), rows * SCORE_OPS_PER_ROW


def sic_inputs(n: int, m: int, per_edge: int, seed: int, dev, ties: bool):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.01, 0.1, n).astype(np.float32)
    g = (rng.uniform(0.1, 10.0, (n, m)) * 1e-9).astype(np.float32)
    mask = np.zeros((n, m), bool)
    if per_edge:
        owner = rng.integers(0, m, n)
        for e in range(m):
            mask[np.flatnonzero(owner == e)[:per_edge], e] = True
    else:
        mask = rng.random((n, m)) < 0.5
    if ties:   # exact-tie rows: equal received power at every edge
        p[1::5] = p[0::5][:len(p[1::5])]
        g[1::5] = g[0::5][:len(g[1::5])]
    return (torch.tensor(p, device=dev), torch.tensor(g, device=dev),
            torch.tensor(mask, device=dev))


def sic_work(mask):
    """Bytes and operations the SIC rates need at this (N, M) bool
    ``mask`` (numpy or torch): the N·M fp32 gains, the N·M one-byte mask
    and the N powers read once, the N·M rates written once; the weaker-than
    test over each edge's own n_e masked clients (a compare and an add a
    pair, 2·Σₑ nₑ²) and 8 operations a (client, edge) for rx, the SINR and
    the rate."""
    n, m = mask.shape
    per_edge = [int(v) for v in mask.sum(0).tolist()]
    n_bytes = 4 * n * m + n * m + 4 * n + 4 * n * m
    return n_bytes, 2 * sum(v * v for v in per_edge) + 8 * m * n


def sgd_inputs(k, tau1, batch, d_in, hidden, n_classes, seed, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    shapes = {"w1": (k, d_in, hidden), "b1": (k, hidden),
              "w2": (k, hidden, hidden), "b2": (k, hidden),
              "w3": (k, hidden, n_classes), "b3": (k, n_classes)}
    params = {}
    for name, shape in shapes.items():
        scale = 1.0 / math.sqrt(shape[1]) if len(shape) == 3 else 0.1
        params[name] = torch.tensor(
            (scale * rng.normal(size=shape)).astype(np.float32), device=dev)
    bx = torch.tensor(rng.uniform(0.0, 1.0, (tau1, k, batch, d_in))
                      .astype(np.float32), device=dev)
    by = torch.tensor(rng.integers(0, n_classes, (tau1, k, batch))
                      .astype(np.int32), device=dev)
    return params, bx, by


def sgd_work(k, tau1, batch, d_in, hidden, n_classes):
    n_params = d_in * hidden + hidden + hidden * hidden + hidden \
        + hidden * n_classes + n_classes
    mats = d_in * hidden + hidden * hidden + hidden * n_classes
    per_step = (2 * batch * mats                      # forward
                + 2 * batch * mats                    # weight gradients
                + 2 * batch * (hidden * hidden + hidden * n_classes)  # dh
                + 5 * batch * n_classes               # softmax + dl
                + 2 * n_params)                       # update
    n_bytes = 2 * 4 * k * n_params + tau1 * k * batch * (4 * d_in + 4)
    return n_bytes, tau1 * k * per_step


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    info = _build.build()
    _build.library()
    log(f"[build] {info.path.name}: nvcc {info.seconds:.2f} s, "
        f"load {time.perf_counter() - t0:.2f} s")
    for line in info.log.splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line:
            log("[build]   " + line.strip())


def _max_err(got, want):
    return float((got.float() - want.float()).abs().max()) \
        if got.numel() else 0.0


def _check_close(name, got, want, rtol, atol):
    import torch
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version "
            f"(max abs err {_max_err(got, want):.3e}, rtol {rtol}, "
            f"atol {atol})")


def compare_score(rows, seed, dev):
    from repro_torch.kernels import hfl_ops
    cq, dq, ms = score_inputs(rows, seed, dev)
    got = hfl_ops.score_rows(cq, dq, ms)
    want = hfl_ops.score_rows_plain(cq, dq, ms)
    _check_close(f"score_rows R={rows}", got, want, **TOL["score_rows"])
    ms_k = time_ms(lambda: hfl_ops.score_rows(cq, dq, ms))
    ms_p = time_ms(lambda: hfl_ops.score_rows_plain(cq, dq, ms))
    return _max_err(got, want), ms_k, ms_p, score_work(rows)


def score_fused_work(n, m, k=None):
    """Bytes (the gains, counts and staleness read once, the frontier's
    int32 indices where there are, the scores written once, the tables)
    and operations (the Eq. 21 normalisation over the whole N·M field,
    the fuzzy pipeline over the N·K or N·M rows) of one fused score."""
    w = m if k is None else k
    idx = 0 if k is None else n * k
    n_bytes = 4 * (n * m + 2 * n + idx + n * w) + 4 * (9 + 5 * 201 + 27)
    return n_bytes, n * m * SCORE_NORM_OPS_PER_PAIR + n * w * SCORE_OPS_PER_ROW


def score_old_vs_new(name, new, old, plain, work):
    """The fused score (``new``: one C call from the raw inputs) against
    the unfused chain it replaced (``old``: the torch normalisation and
    gather around the rows kernel), in turns old, new, new, old, each with
    its wrapper time (CUDA events around the call, host time included)
    and its device time (a CUDA-graph replay); ``new`` held to the plain
    version bit for bit, and to exactly one launch of its own counter and
    none of the rows kernel.  Returns err, new ms, plain ms, bound."""
    import torch
    from repro_torch.kernels import hfl_ops
    counter = "score_matrix" if name.startswith("score_matrix") \
        else "score_candidates"
    before = dict(hfl_ops.LAUNCHES)
    got = new()
    torch.cuda.synchronize()
    if (hfl_ops.LAUNCHES[counter] - before[counter],
            hfl_ops.LAUNCHES["score_rows"] - before["score_rows"]) != (1, 0):
        raise AssertionError(f"{name}: expected one {counter} call and no "
                             f"score_rows launch")
    want = plain()
    err = _max_err(got, want)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: the fused score is not bit-equal to "
                             f"its plain version (max abs err {err:.3e})")
    if not torch.equal(old(), want):
        raise AssertionError(f"{name}: the unfused chain is not bit-equal "
                             f"to the plain version")
    times = {"old": [], "new": []}
    for who in ("old", "new", "new", "old"):
        fn = new if who == "new" else old
        times[who].append((time_ms(fn), graph_ms(fn)))
    ms_p = time_ms(plain, min_iters=2, budget_s=0.2)
    b_ms, b_by = bound_ms(*work)
    fmt = "; ".join
    log(f"[compare] {name}: bit-equal to plain; new (fused) "
        + fmt(f"{c:.4f} ms (device {d:.4f})" for c, d in times["new"])
        + "; old (torch normalisation + rows kernel) "
        + fmt(f"{c:.4f} ms (device {d:.4f})" for c, d in times["old"])
        + f"; plain {ms_p:.4f} ms; bound {b_ms:.6f} ms ({b_by})")
    ms_new = sum(c for c, _ in times["new"]) / 2
    return err, ms_new, ms_p, b_ms, b_by


def edge_gains(n, m, seed):
    """Gains with exact dB ties, values under the 1e-30 clamp and zeros."""
    import numpy as np
    rng = np.random.default_rng(seed)
    g = rng.uniform(1e-12, 1e-8, (n, m)).astype(np.float32)
    g[::5] = g[0]                       # exact ties across clients
    g[1::7, 0] = 1e-35
    g[2::11, -1] = 0.0
    return g


def compare_score_matrix(cfg, dev):
    """The dense fused score at ``CONFIG`` on the engine's first-round
    inputs with random staleness, old vs new in turns (the entry of the
    JSON line), then untimed on edge gains and all-zero staleness; the
    unfused chain's rows-kernel launch, logged."""
    import numpy as np
    import torch
    from repro_torch.core import engine, fuzzy
    from repro_torch.kernels import hfl_ops
    state, bundle, _ = engine.init_simulation(cfg, seed=0, device=dev)
    rng = np.random.default_rng(8)
    stale = torch.tensor(rng.integers(1, 9, cfg.n_clients).astype(np.int32),
                         device=dev)
    dm = float(cfg.max_samples)

    def call(g, c, st):
        return (lambda: hfl_ops.score_matrix(g, c, st, data_max=dm),
                lambda: fuzzy.score_matrix(g, c, st, data_max=dm,
                                           rows=hfl_ops.score_rows),
                lambda: fuzzy.score_matrix(g, c, st, data_max=dm,
                                           rows=hfl_ops.score_rows_plain))
    n, m = cfg.n_clients, cfg.n_edges
    res = score_old_vs_new(f"score_matrix N={n} M={m}",
                           *call(state.gains, bundle.counts, stale),
                           score_fused_work(n, m))
    for g, st in ((edge_gains(n, m, 9), stale),
                  (edge_gains(4097, 32, 10), None)):
        gt = torch.tensor(g, device=dev)
        nn = gt.shape[0]
        counts = torch.tensor(rng.integers(60, 1200, nn).astype(np.float32),
                              device=dev)
        st = torch.zeros(nn, dtype=torch.int32, device=dev) \
            if st is None else st
        new, _, plain = call(gt, counts, st)
        got, want = new(), plain()
        if not torch.equal(got, want):
            raise AssertionError(f"score_matrix N={nn}: edge gains not "
                                 f"bit-equal (max abs err "
                                 f"{_max_err(got, want):.3e})")
        log(f"[compare] score_matrix N={nn} M={g.shape[1]} edge gains (ties, "
            f"< 1e-30, zeros; staleness {'all 0' if nn > n else 'random'}):"
            f" bit-equal")
    # the unfused chain, which no engine path runs now, launches the rows
    # kernel once (a log line; not the JSON line's)
    before = hfl_ops.LAUNCHES["score_rows"]
    call(state.gains, bundle.counts, stale)[1]()
    torch.cuda.synchronize()
    log(f"[compare] score_matrix N={n} M={m} unfused chain: "
        f"{hfl_ops.LAUNCHES['score_rows'] - before} score_rows launch")
    err, ms_new, ms_p, b_ms, b_by = res
    return err, ms_new, ms_p, score_fused_work(n, m)


def compare_sic(n, m, per_edge, seed, dev, ties, clusters=()):
    """The SIC kernel against its plain version at the default cluster
    size and, untimed, at each of ``clusters``; the wrapper call's time
    (CUDA events, host time included) and its device time (graph
    replay), beside the bound counted from the mask."""
    import torch
    from repro_torch.core import noma
    from repro_torch.kernels import hfl_ops
    p, g, mask = sic_inputs(n, m, per_edge, seed, dev, ties)
    kw = dict(bandwidth_hz=1e6, noise_w=noma.noise_power_w(-174.0, 1e6))
    want = hfl_ops.sic_rates_plain(p, g, mask, **kw)
    tol = TOL["sic_rates"]
    c0 = hfl_ops.sic_cluster_size(n)
    name = (f"sic_rates N={n} M={m} "
            f"{'one-hot ' + str(per_edge) if per_edge else '50% mask'}")
    before = hfl_ops.LAUNCHES["sic_rates"]
    got = hfl_ops.sic_rates(p, g, mask, **kw)
    torch.cuda.synchronize()
    if hfl_ops.LAUNCHES["sic_rates"] != before + 1:
        raise AssertionError(f"{name}: expected one sic_rates launch")
    for c in (c0, *clusters):
        out = got if c == c0 else hfl_ops._sic_launch(p, g, mask, c, **kw)
        _check_close(f"{name} cluster {c}", out, want, tol["rtol"],
                     float(want.abs().max()) * tol["atol_frac"])
        if c != c0:
            ms_c = graph_ms(lambda: hfl_ops._sic_launch(p, g, mask, c,
                                                        **kw))
            log(f"[compare] {name} cluster {c}: max_abs_err "
                f"{_max_err(out, want):.3e}  device {ms_c:.4f} ms")
    ms_k = time_ms(lambda: hfl_ops.sic_rates(p, g, mask, **kw))
    ms_dev = graph_ms(lambda: hfl_ops.sic_rates(p, g, mask, **kw))
    ms_p = time_ms(lambda: hfl_ops.sic_rates_plain(p, g, mask, **kw))
    work = sic_work(mask)
    b_ms, b_by = bound_ms(*work)
    log(f"[compare] {name} cluster {c0} (default): max_abs_err "
        f"{_max_err(got, want):.3e}  kernel {ms_k:.4f} ms (device "
        f"{ms_dev:.4f} ms by graph replay)  plain {ms_p:.4f} ms  bound "
        f"{b_ms:.6f} ms ({b_by}; {work[1] - 8 * m * n} pair ops over "
        f"{int(mask.sum())} masked pairs)")
    return _max_err(got, want), ms_k, ms_p, work


def compare_sgd(k, tau1, batch, d_in, hidden, n_classes, seed, dev,
                timed=True):
    """Kernel vs plain through the wrapper, checking the route it took;
    with ``timed``, the kernel's device time (CUDA-graph replay: the
    wrapper's host time exceeds the kernel's), the wrapper call's time and
    the plain version's."""
    import ctypes
    import torch
    from repro_torch.kernels import hfl_ops
    from repro_torch.kernels._build import check as _build_check
    from repro_torch.kernels._build import library as _build_lib
    from repro_torch.models.mlp import PARAM_KEYS
    params, bx, by = sgd_inputs(k, tau1, batch, d_in, hidden, n_classes,
                                seed, dev)
    shape = (k, batch, d_in, hidden, n_classes)
    route = hfl_ops.sgd_route(*shape)
    c = hfl_ops.sgd_cluster_size(*shape)
    before = dict(hfl_ops.LAUNCHES)
    got = hfl_ops.local_sgd_step(params, bx, by, lr=0.01)
    torch.cuda.synchronize()
    cluster = int(route == "hfl_local_sgd_cluster")
    if (hfl_ops.LAUNCHES["local_sgd_step_cluster"]
            - before["local_sgd_step_cluster"]) != cluster:
        raise AssertionError(f"local_sgd_step K={k}: expected {route}")
    want = hfl_ops.local_sgd_step_plain(params, bx, by, lr=0.01)
    err = 0.0
    name = (f"local_sgd_step K={k} tau1={tau1} B={batch} D={d_in} "
            f"H={hidden} ({route}, cluster {c})")
    for leaf in PARAM_KEYS:
        _check_close(f"{name} {leaf}", got[leaf], want[leaf],
                     **TOL["local_sgd_step"])
        err = max(err, _max_err(got[leaf], want[leaf]))
    if not timed:
        log(f"[compare] {name}: max_abs_err {err:.3e}")
        return err

    def call():
        return hfl_ops.local_sgd_step(params, bx, by, lr=0.01)
    ms_k = graph_ms(call)
    ms_call = time_ms(call)
    ms_p = time_ms(lambda: hfl_ops.local_sgd_step_plain(params, bx, by,
                                                        lr=0.01))
    smem = hfl_ops.sgd_smem_bytes(batch, d_in, hidden, n_classes, c)
    active = hfl_ops.sgd_max_active_clusters(*shape)
    # the same launch asking for more than half an SM's shared memory: one
    # CTA an SM, the layout the kernel's 2-CTA budget avoids
    alone = ctypes.c_int(0)
    _build_check(_build_lib().hfl_sgd_max_active_clusters(
        *shape, c, max(smem, 116_000), ctypes.byref(alone)), "occupancy")
    log(f"[compare] {name}: kernel {ms_k:.4f} ms (graph replay), wrapper "
        f"call {ms_call:.4f} ms; {k * c} CTAs, {smem} bytes of shared "
        f"memory a CTA, {active} clusters active at once ({alone.value} at "
        f"one CTA an SM)")
    return err, ms_k, ms_p, sgd_work(k, tau1, batch, d_in, hidden,
                                     n_classes)


# the SGD kernels' edge shapes (tests/test_torch_cuda.py): (K, τ₁, B, D, H)
# -- every cluster size, K = 1, τ₁ = 4, ragged tiles and W1 row slices, a
# CTA without rows of W1, and a layer too wide for any cluster (the
# block-per-lane kernel)
SGD_EDGES = [(3, 2, 5, 7, 6), (2, 2, 6, 30, 12), (1, 4, 8, 30, 16),
             (1, 1, 32, 783, 128), (40, 2, 9, 50, 20), (1, 2, 4, 7, 16),
             (1, 1, 4, 70_000, 8)]


def phase_compare(cfg, dev):
    """Kernel vs plain at the CONFIG shapes (returned for the JSON line)
    and at the reference bench scale (printed)."""
    quota = cfg.clients_per_edge
    # the rows-only kernel, on no engine path now: printed, not in the
    # JSON line
    rows = {"score_rows": compare_score(cfg.n_clients * cfg.n_edges, 1, dev)}
    main = {
        "score_matrix": compare_score_matrix(cfg, dev),
        "sic_rates": compare_sic(cfg.n_clients, cfg.n_edges, quota, 2, dev,
                                 ties=True),
        "local_sgd_step": compare_sgd(
            quota * cfg.n_edges, cfg.tau1, cfg.local_batch, cfg.input_dim,
            cfg.hidden, cfg.n_classes, 3, dev),
    }
    # the reference bench scale: the engine's one-hot association (4
    # clients an edge) and a dense 50% mask with exact ties, every cluster
    # size
    bench = {
        "score_rows": compare_score(4096 * 32 + 37, 4, dev),
        "sic_rates one-hot": compare_sic(4096, 32, 4, 7, dev, ties=True),
        "sic_rates": compare_sic(4097, 32, 0, 5, dev, ties=True,
                                 clusters=(1, 2, 4, 8)),
        "local_sgd_step": compare_sgd(4 * 32, 3, 16, 32, 16, 10, 6, dev),
    }
    for i, (k, tau1, batch, d_in, hidden) in enumerate(SGD_EDGES):
        compare_sgd(k, tau1, batch, d_in, hidden, 10, 20 + i, dev,
                    timed=False)
    for label, res in (("CONFIG", {**rows, **main}),
                       ("bench 4096x32", bench)):
        for name, (err, ms_k, ms_p, work) in res.items():
            b_ms, b_by = bound_ms(*work)
            log(f"[compare] {label:>13} {name:<17} max_abs_err {err:.3e}  "
                f"kernel {ms_k:.4f} ms  plain {ms_p:.4f} ms  "
                f"bound {b_ms:.6f} ms ({b_by})")
    return main


class StageTimer:
    """CUDA-event spans around each engine stage (``round_step``'s
    ``timer`` hook)."""

    def __init__(self):
        import torch
        self._torch = torch
        self.spans = {}

    @contextlib.contextmanager
    def __call__(self, name):
        ev = self._torch.cuda.Event
        start, end = ev(enable_timing=True), ev(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self.spans.setdefault(name, []).append((start, end))

    def ms(self):
        self._torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e in v]
                for k, v in self.spans.items()}


def _check_metrics(cfg, spec_quota, rows, m_c):
    for r in rows:
        vals = [r.accuracy, r.loss, r.avg_staleness, r.total_time_s,
                r.total_energy_j, r.cost]
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"round {r.round}: non-finite metrics {r}")
        if r.n_associated > spec_quota * cfg.n_edges:
            raise AssertionError(f"round {r.round}: {r.n_associated} "
                                 f"associated > quota·M")
        if r.n_associated > r.n_available:
            raise AssertionError(f"round {r.round}: {r.n_associated} "
                                 f"associated > {r.n_available} available")
        if int(r.z.sum()) != m_c:
            raise AssertionError(f"round {r.round}: Σz = {r.z.sum()} != "
                                 f"M_c = {m_c}")


def _drive(cfg, policy, scheduler, rounds, dev, **kw):
    import torch
    from repro_torch.core.hfl import HFLSimulation
    from repro_torch.kernels import hfl_ops
    sim = HFLSimulation(cfg, seed=0, policy=policy, scheduler=scheduler,
                        device=dev, **kw)
    timer = StageTimer()
    torch.cuda.synchronize()
    hfl_ops.reset_launches()
    rows, walls = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        rows.append(sim.run_round(timer=timer))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = dict(hfl_ops.LAUNCHES)
    return sim, rows, walls, timer.ms(), launches


def phase_main_path(cfg, dev):
    m_c = max(1, int(round(cfg.semi_sync_fraction * cfg.n_edges)))
    quota = cfg.clients_per_edge
    runs = {}
    for policy, scheduler, rounds in (("fcea", "pdd", 5),
                                      ("gcea", "fastest", 2)):
        sim, rows, walls, stages, launches = _drive(cfg, policy, scheduler,
                                                    rounds, dev)
        want = _want_launches(cfg, sim.spec, rounds)
        if launches != want:
            raise AssertionError(f"{policy}-{scheduler}: launches {launches} "
                                 f"!= expected {want}")
        _check_metrics(cfg, quota, rows, m_c)
        steady = _report("main", f"{policy}-{scheduler}", rows, walls,
                         stages, launches)
        runs[policy] = (sim, launches, steady)
    return runs


def _report(tag, label, rows, walls, stages, launches, per_round=True):
    """Print each round (unless ``per_round`` is off), the steady s/round
    and the stage spans; return the steady s/round (rounds 2.., or round
    1 alone)."""
    rounds = len(rows)
    for r, w in zip(rows, walls if per_round else ()):
        log(f"[{tag}] {label} round {r.round}: {w:.4f} s  "
            f"acc {r.accuracy:.4f} loss {r.loss:.5f} cost {r.cost:.5f} "
            f"n_avail {r.n_available} n_assoc {r.n_associated} "
            f"z {r.z.tolist()} sweeps {r.sweeps}")
    steady = walls[1:] or walls
    log(f"[{tag}] {label}: launches {launches}; "
        f"s/round {sum(steady) / len(steady):.4f} "
        f"(rounds 2..{rounds}; round 1 {walls[0]:.4f})")
    for name, spans in stages.items():
        tail = spans[1:] or spans
        log(f"[stage] {label} {name:<9} "
            f"{sum(tail) / len(tail):.4f} ms/round "
            f"(rounds 2..{rounds}; round 1 {spans[0]:.4f})")
    return sum(steady) / len(steady)


def profile_device(fn, label, steady_s):
    """Device busy share of one call of ``fn``: the time of the CUDA
    kernels ``torch.profiler`` records, over the profiled call's wall time
    and over ``steady_s``, the unprofiled steady time of the same call;
    and the kernels that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue          # host ops: their kernels are counted below
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        rows.append((us, ev.count, ev.key))
    busy_s = sum(us for us, _, _ in rows) / 1e6
    launches = sum(count for _, count, _ in rows)
    log(f"[profile] {label}: {launches} kernels, device busy "
        f"{busy_s * 1e3:.3f} ms; profiled wall {wall_s * 1e3:.3f} ms "
        f"(busy {100.0 * busy_s / wall_s:.2f}%); unprofiled steady "
        f"{steady_s * 1e3:.3f} ms (busy {100.0 * busy_s / steady_s:.2f}%, "
        f"idle {100.0 * (1.0 - busy_s / steady_s):.2f}%)")
    for us, count, key in sorted(rows, reverse=True)[:16]:
        log(f"[profile]   {us / 1e3:9.3f} ms  x{count:<6} {key[:90]}")


def _to(obj, device):
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to(v, device) for v in obj))
    return obj


def _check_bill(tag, g, c, n_test):
    """A round's ``metrics_row`` ``g`` against ``c``: cost, time and energy
    to rtol 1e-5, the loss to rtol 1e-4, the accuracy to 2 test samples.
    Returns the largest relative difference of each."""
    worst = {}
    for key, rtol in (("cost", 1e-5), ("total_time_s", 1e-5),
                      ("total_energy_j", 1e-5), ("loss", 1e-4)):
        worst[key] = abs(g[key] - c[key]) / abs(c[key])
        if not math.isclose(g[key], c[key], rel_tol=rtol):
            raise AssertionError(f"{tag} {key}: {g[key]} vs {c[key]} "
                                 f"(rtol {rtol})")
    if abs(g["accuracy"] - c["accuracy"]) > 2.0 / n_test:
        raise AssertionError(f"{tag} accuracy: {g['accuracy']} vs "
                             f"{c['accuracy']}")
    return worst


def card_vs_cpu(cfg, spec, state, bundle, generator, label=""):
    """One round of ``spec`` from ``state`` with fresh draws from
    ``generator``, on the card and, from the same state and draws, on the
    CPU: ``z``, ``n_associated``, sweeps and staleness exact, the bill to
    rtol 1e-5, the loss to rtol 1e-4, the accuracy to 2 test samples; on
    a dynamic scenario also ``n_available`` and the availability exactly,
    the moved positions and distances as ``_check_world`` holds them."""
    import torch
    from repro_torch import scenarios
    from repro_torch.core import engine, noma
    from repro_torch.kernels import hfl_ops
    cpu = torch.device("cpu")
    draws = engine.sample_draws(cfg, bundle, generator, spec)
    s_gpu, m_gpu = engine.round_step(cfg, spec, state, bundle, draws)
    s_cpu, m_cpu = engine.round_step(cfg, spec, _to(state, cpu),
                                     _to(bundle, cpu), _to(draws, cpu))
    g, c = engine.metrics_row(m_gpu), engine.metrics_row(m_cpu)
    tag = f"[card-vs-cpu]{' ' + label if label else ''}"
    if cfg.n_clients <= 256:
        log(f"{tag} card {g}")
        log(f"{tag} cpu  {c}")
    exact_ok = (g["z"].tolist() == c["z"].tolist()
                and g["n_associated"] == c["n_associated"]
                and g["n_available"] == c["n_available"]
                and g["sweeps"] == c["sweeps"]
                and torch.equal(s_gpu.staleness.cpu(), s_cpu.staleness))
    dynamic = spec.scenario != "static"
    if dynamic:
        _check_world(tag, s_gpu.scenario, s_cpu.scenario, cfg.area_side_m)
    if not exact_ok:
        # print the competing scores: a gap below the score tolerance is a
        # near-tie (reported, and still a failure)
        dist = bundle.dist
        if dynamic:
            dist = scenarios.advance(cfg, spec.scenario, draws.scenario,
                                     state.scenario).dist
        gains = noma.evolve_gains(
            draws.fading, state.gains, dist,
            path_loss_exponent=cfg.path_loss_exponent,
            rho=spec.fading_rho)
        sc_g = hfl_ops.score_matrix(gains, bundle.counts, state.staleness,
                                    data_max=float(cfg.max_samples)).cpu()
        sc_c = hfl_ops.score_matrix(_to(gains, cpu), _to(bundle.counts, cpu),
                                    _to(state.staleness, cpu),
                                    data_max=float(cfg.max_samples))
        diff = (sc_g - sc_c).abs()
        srt = torch.sort(sc_c, dim=0, descending=True).values
        gaps = (srt[:-1] - srt[1:]).abs()
        log(f"{tag} score max |card - cpu| {float(diff.max()):.3e}; "
            f"smallest per-edge adjacent score gap "
            f"{float(gaps[gaps > 0].min()):.3e}; near-tie if below 2e-4")
        raise AssertionError(f"{tag} card and CPU rounds disagree on z, "
                             f"n_associated, sweeps or staleness: {g} {c}")
    _check_bill(tag, g, c, bundle.test_y.shape[0])
    world = ("availability exact; positions/distances rtol 1e-6, atol "
             "1e-6 of the side; " if dynamic else "")
    log(f"{tag} z, n_available {g['n_available']}, n_associated "
        f"{g['n_associated']}, sweeps {g['sweeps']}, staleness exact; "
        f"{world}cost/time/energy rtol 1e-5, loss rtol 1e-4, accuracy "
        f"atol 2/T: ok")


# a scenario's moved positions and distances, card against CPU: the card's
# norm rounds the waypoint step an ulp apart, and a position an ulp off
# (3e-5 m at 500 m) is more than 1e-6 of a distance of a few metres to an
# edge; so rtol 1e-6 above a floor of 1e-6 of the area's side (0.5 mm of a
# 500 m cell, ~16 ulps of a coordinate)
WORLD_RTOL = 1e-6


def _check_world(tag, got, want, area_side_m):
    """A scenario state on the card against the CPU's: the availability
    and the fixed leaves exactly, positions, waypoints and distances to
    ``WORLD_RTOL`` above a floor of ``WORLD_RTOL`` of the area's side."""
    import torch
    for field in got._fields:
        g, w = getattr(got, field).cpu(), getattr(want, field)
        if field in ("pos", "waypoint", "dist"):
            ok = torch.allclose(g, w, rtol=WORLD_RTOL,
                                atol=WORLD_RTOL * area_side_m)
        else:
            ok = torch.equal(g, w)
        if not ok:
            raise AssertionError(f"{tag} scenario {field}: card and CPU "
                                 f"disagree (max abs err "
                                 f"{_max_err(g, w):.3e})")


# ---------------------------------------------------------------------------
# The candidate path
# ---------------------------------------------------------------------------

# the dense SIC is the pairwise kernel; the candidate path bills with the
# reference's sorted SIC (``noma.sic_rates_assigned``), whose interference
# is a total minus a prefix sum: in float32 that loses up to ~2% of a weak
# client's rate, and the two bills of one association part by up to
# ~1e-3 (rtol, PERF.md)
SORTED_SIC_RTOL = 2e-3


def bench_config(cfg, n=4096, m=32):
    """The reference's ``benchmarks/bench_rounds.py::_cfg(n, m)`` (also
    ``bench_sweeps.py::_cfg()`` at 256 × 8)."""
    import dataclasses
    return dataclasses.replace(cfg, n_clients=n, n_edges=m,
                               clients_per_edge=4, min_samples=60,
                               max_samples=120, hidden=16, input_dim=32,
                               local_batch=16)


def _drive_spec(cfg, spec, rounds, dev, seed=0, scenario=None,
                on_round=None):
    """``rounds`` rounds of ``engine.round_step`` from
    ``engine.init_simulation`` (in ``scenario``), fresh draws each round,
    with every launch counter zeroed just before and read just after;
    ``on_round(state)``, if given, sees the state before the first round
    and after each.  Returns the host rows, walls, stage spans, launches
    and the final (state, bundle, generator)."""
    import torch
    from repro_torch.core import engine
    from repro_torch.core.hfl import RoundMetrics
    from repro_torch.kernels import hfl_ops
    state, bundle, aux = engine.init_simulation(cfg, seed=seed, device=dev,
                                                scenario=scenario)
    if on_round:
        on_round(state)
    gen = aux["generator"]
    timer = StageTimer()
    torch.cuda.synchronize()
    hfl_ops.reset_launches()
    rows, walls = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        draws = engine.sample_draws(cfg, bundle, gen, spec)
        state, m = engine.round_step(cfg, spec, state, bundle, draws,
                                     timer=timer)
        rows.append(RoundMetrics.from_engine(m))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if on_round:
            on_round(state)
    launches = dict(hfl_ops.LAUNCHES)
    return rows, walls, timer.ms(), launches, (state, bundle, gen)


def _want_launches(cfg, spec, rounds, seeds=1):
    """The kernel launches ``rounds`` rounds of ``spec`` make, of one
    simulation or of a fleet of ``seeds``: one score call and one SIC call a
    round whatever the fleet's size (and one more SIC call for the fpa/fca
    grid), τ₂ SGD launches over its S·K lanes."""
    from repro_torch.core import engine
    from repro_torch.kernels import hfl_ops
    fcea = spec.policy == "fcea"
    dense = spec.candidates_k is None
    grid = spec.allocator in ("fpa", "fca")
    lanes = seeds * min(cfg.n_clients,
                        engine.quota_for(cfg, spec) * cfg.n_edges)
    cluster = hfl_ops.sgd_route(lanes, cfg.local_batch, cfg.input_dim,
                                cfg.hidden, cfg.n_classes) \
        == "hfl_local_sgd_cluster"
    return {"score_rows": 0,
            "score_matrix": rounds * (fcea and dense),
            "score_candidates": rounds * (fcea and not dense),
            "sic_rates": rounds * ((dense + grid) * spec.noma_enabled),
            "local_sgd_step": cfg.tau2 * rounds,
            "local_sgd_step_cluster": cfg.tau2 * rounds * cluster}


def _run_spec(cfg, spec, rounds, dev, label, tag="cand", scenario=None,
              per_round=True, on_round=None):
    """Drive ``spec`` (in ``scenario``), check its launches and metrics,
    print its rounds and stages.  Returns (rows, steady s/round, stages,
    launches, final)."""
    from repro_torch.core import engine
    rows, walls, stages, launches, final = _drive_spec(
        cfg, spec, rounds, dev, scenario=scenario, on_round=on_round)
    want = _want_launches(cfg, spec, rounds)
    if launches != want:
        raise AssertionError(f"{label}: launches {launches} != expected "
                             f"{want}")
    m_c = max(1, int(round(cfg.semi_sync_fraction * cfg.n_edges)))
    _check_metrics(cfg, engine.quota_for(cfg, spec), rows, m_c)
    steady = _report(tag, label, rows, walls, stages, launches, per_round)
    return rows, steady, stages, launches, final


def _same_decisions(label, dense_rows, cand_rows):
    """K ≥ the maximum coverage degree loses nothing: the candidate round
    makes the dense round's decisions (z, n_associated, sweeps, staleness;
    the same training, so the same loss and accuracy); its bill differs
    only by the sorted SIC's float32 rounding (``SORTED_SIC_RTOL``)."""
    worst = {}
    for d, c in zip(dense_rows, cand_rows):
        same = (d.z.tolist() == c.z.tolist()
                and (d.n_associated, d.sweeps, d.avg_staleness)
                == (c.n_associated, c.sweeps, c.avg_staleness))
        if not same:
            raise AssertionError(f"{label} round {d.round}: candidate "
                                 f"decisions differ from dense: {d} {c}")
        if not (math.isclose(d.loss, c.loss, rel_tol=1e-6)
                and d.accuracy == c.accuracy):
            raise AssertionError(f"{label} round {d.round}: training "
                                 f"differs: {d} {c}")
        for key in ("cost", "total_time_s", "total_energy_j"):
            a, b = getattr(d, key), getattr(c, key)
            worst[key] = max(worst.get(key, 0.0), abs(a - b) / abs(a))
            if not math.isclose(a, b, rel_tol=SORTED_SIC_RTOL):
                raise AssertionError(f"{label} round {d.round} {key}: "
                                     f"dense {a} vs candidate {b}")
    log(f"[cand] {label}: z, n_associated, sweeps, staleness exact; loss "
        f"rtol 1e-6, accuracy equal; bill max rel diff (pairwise vs sorted "
        f"SIC) " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" (limit {SORTED_SIC_RTOL}): ok")


def compare_score_candidates(state, bundle, cfg, k, n_rows=None):
    """The fused score on the frontier of the bench state's gains (the
    first ``n_rows`` clients), old vs new in turns, beside its bound."""
    from repro_torch.core import candidates, engine, fuzzy
    from repro_torch.kernels import hfl_ops
    n = n_rows or cfg.n_clients
    gains, counts, stale = (state.gains[:n], bundle.counts[:n],
                            state.staleness[:n])
    cand = candidates.build_candidates(
        bundle.dist[:n], k, coverage_radius_m=engine.coverage_radius(cfg))
    dm = float(cfg.max_samples)

    def unfused(rows):
        return lambda: fuzzy.score_candidates(gains, cand, counts, stale,
                                              data_max=dm, rows=rows)
    return score_old_vs_new(
        f"score_candidates N={n} M={cfg.n_edges} K={k} ({n * k} rows)",
        lambda: hfl_ops.score_candidates(gains, cand.idx, counts, stale,
                                         data_max=dm),
        unfused(hfl_ops.score_rows), unfused(hfl_ops.score_rows_plain),
        score_fused_work(n, cfg.n_edges, k)) + (None,)


def phase_candidates(cfg, dev):
    """The candidate path at ``CONFIG`` and at the bench scale.  Returns
    the ``score_candidates`` entry of the kernel line: its launches on the
    bench K = 8 run and its comparison at 4096 × 8 rows."""
    import dataclasses
    from repro_torch.core import candidates, engine
    # 1. CONFIG: K = M against dense, fcea + PDD
    m = cfg.n_edges
    deg = candidates.max_coverage_degree(
        engine.init_simulation(cfg, seed=0, device=dev)[1].dist,
        engine.coverage_radius(cfg))
    if deg > m:
        raise AssertionError(f"coverage degree {deg} > M")
    dense = engine.EngineSpec()
    rows_d = _run_spec(cfg, dense, 3, dev, "CONFIG dense fcea-pdd")[0]
    rows_m = _run_spec(cfg, dataclasses.replace(dense, candidates_k=m), 3,
                       dev, f"CONFIG K={m} fcea-pdd")[0]
    _same_decisions(f"CONFIG K={m} vs dense", rows_d, rows_m)
    # 2. CONFIG, K = 2: card against CPU, then gcea and rcea + rra
    k2 = dataclasses.replace(dense, candidates_k=2)
    state, bundle, gen = _run_spec(cfg, k2, 2, dev, "CONFIG K=2 fcea-pdd")[4]
    card_vs_cpu(cfg, k2, state, bundle, gen, "CONFIG K=2")
    for kw in (dict(policy="gcea", scheduler="fastest"),
               dict(policy="rcea", allocator="rra", scheduler="fastest")):
        spec = dataclasses.replace(k2, **kw)
        _run_spec(cfg, spec, 2, dev, f"CONFIG K=2 {spec.policy}-"
                  f"{spec.allocator}-{spec.scheduler}")
    # 3. the bench scale: dense, K = 8, K = 4, by stage
    big = bench_config(cfg)
    runs = {}
    for k in (None, 8, 4):
        spec = dataclasses.replace(dense, candidates_k=k)
        runs[k] = _run_spec(big, spec, 3, dev,
                            f"4096x32 {'dense' if k is None else f'K={k}'} "
                            f"fcea-pdd", tag="bench")
    log("[bench] 4096x32 s/round (rounds 2..3): "
        + ", ".join(f"{'dense' if k is None else f'K={k}'} {r[1]:.4f}"
                    for k, r in runs.items()))
    state, bundle, gen = runs[4][4]
    card_vs_cpu(big, dataclasses.replace(dense, candidates_k=4), state,
                bundle, gen, "4096x32 K=4")
    # 4. the score kernel at the frontier's rows
    out = compare_score_candidates(state, bundle, big, 8)
    compare_score_candidates(state, bundle, big, 4)
    compare_score_candidates(state, bundle, big, 3, n_rows=4095)
    return {"score_candidates": (runs[8][3]["score_candidates"], out)}


# ---------------------------------------------------------------------------
# The fleet: run_fleet, one batched round over a leading seed axis
# ---------------------------------------------------------------------------

# the fleets the reference runs: 4 seeds below N = 1024 and 2 from there
# on (benchmarks/bench_rounds.py:467; 4 in benchmarks/bench_sweeps.py:102,
# 2 in src/repro/sweeps/grid.py:372,385); and S = 8, twice the largest,
# at CONFIG, at which one round's 128 SGD lanes take a smaller cluster,
# and 4 at the bench scale: the CONFIG and bench-scale sizes driven
REF_FLEET_SEEDS = (4, 2)
FLEET_SEEDS = (8, 4)


def _fleet(cfg, seeds, dev, worlds=None):
    """``stack_fleet`` of ``init_simulation`` at each seed (in its scenario
    of ``worlds``, if given), and the seeds' generators."""
    from repro_torch.core import engine
    pairs, gens = [], []
    for i, s in enumerate(seeds):
        state, bundle, aux = engine.init_simulation(
            cfg, seed=s, device=dev, scenario=worlds[i] if worlds else None)
        pairs.append((state, bundle))
        gens.append(aux["generator"])
    return (*engine.stack_fleet(pairs), gens)


def _drive_fleet(cfg, spec, seeds, rounds, dev, label, worlds=None):
    """``run_fleet`` of ``seeds`` for ``rounds`` rounds, one round a call
    (the trajectory of one call of ``rounds``) so that each round's wall is
    read, with every launch counter zeroed just before and read just after;
    check the launches and each seed's metrics, print the rounds and the
    stage spans.  Returns the fleet metrics (S, rounds, …), the steady s a
    round, the final (states, bundles, generators) and the stage spans.
    ``worlds``: each seed's scenario, for a fleet of mixed worlds."""
    import torch
    from repro_torch.core import engine
    from repro_torch.core.hfl import RoundMetrics
    from repro_torch.kernels import hfl_ops
    states, bundles, gens = _fleet(cfg, seeds, dev, worlds)
    timer = StageTimer()
    torch.cuda.synchronize()
    hfl_ops.reset_launches()
    rows, walls = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        states, m = engine.run_fleet(cfg, spec, states, bundles, 1, gens,
                                     timer=timer)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        rows.append(m)
    launches = dict(hfl_ops.LAUNCHES)
    fm = engine.RoundMetrics(*(torch.cat([f.cpu() for f in field], dim=1)
                               for field in zip(*rows)))
    want = _want_launches(cfg, spec, rounds, len(seeds))
    if launches != want:
        raise AssertionError(f"[fleet] {label}: launches {launches} != "
                             f"expected {want}")
    m_c = max(1, int(round(cfg.semi_sync_fraction * cfg.n_edges)))
    for s in range(len(seeds)):
        sm = engine.select_seed(fm, s)
        _check_metrics(cfg, engine.quota_for(cfg, spec),
                       [RoundMetrics.from_engine(sm, i)
                        for i in range(rounds)], m_c)
    stages = timer.ms()
    for r, w in enumerate(walls):
        log(f"[fleet] {label} round {r + 1}: {w:.4f} s; sweeps "
            f"{fm.sweeps[:, r].tolist()}; n_avail "
            f"{fm.n_available[:, r].tolist()}; n_assoc "
            f"{fm.n_associated[:, r].tolist()}; cost "
            + " ".join(f"{v:.5f}" for v in fm.cost[:, r].tolist()))
    steady = walls[1:] or walls
    steady_s = sum(steady) / len(steady)
    log(f"[fleet] {label}: launches {launches}; s/round {steady_s:.4f} "
        f"(rounds 2..{rounds}; round 1 {walls[0]:.4f}); "
        f"{len(seeds) / steady_s:.2f} seed-rounds/s")
    for name, spans in stages.items():
        tail = spans[1:] or spans
        log(f"[stage] fleet {label} {name:<9} "
            f"{sum(tail) / len(tail):.4f} ms/round "
            f"(rounds 2..{rounds}; round 1 {spans[0]:.4f})")
    return fm, steady_s, (states, bundles, gens), stages


def _fleet_vs_own(cfg, spec, seeds, members, fm, final, dev, label,
                  own=None, worlds=None):
    """Each of ``members`` (indices into ``seeds``) against its own
    ``run_scanned`` from ``init_simulation(seed)`` (in its scenario of
    ``worlds``) and its generator, on the card: z, n_available,
    n_associated, sweeps, the mean staleness each round and the final
    staleness exactly; cost, time and energy to rtol 1e-5; the loss to
    rtol 1e-4 (the fleet's S·K lanes may take another SGD cluster size,
    whose sums are not bit-equal); the accuracy to 2 test samples.  The
    own runs are kept in ``own`` (by seed and world) for a later fleet of
    the same seeds."""
    import torch
    from repro_torch.core import engine
    rounds = fm.accuracy.shape[1]
    own = {} if own is None else own
    worst = {}
    for s in members:
        world = worlds[s] if worlds else None
        if (seeds[s], world) not in own:
            state, bundle, aux = engine.init_simulation(
                cfg, seed=seeds[s], device=dev, scenario=world)
            o_state, om = engine.run_scanned(cfg, spec, state, bundle,
                                             rounds, aux["generator"])
            own[seeds[s], world] = (o_state, engine.RoundMetrics(
                *(v.cpu() for v in om)), bundle.test_y.shape[0])
        o_state, om, n_test = own[seeds[s], world]
        sm = engine.select_seed(fm, s)
        for i in range(rounds):
            g, w = engine.metrics_row(sm, i), engine.metrics_row(om, i)
            msg = f"[fleet] {label} seed {seeds[s]} round {i + 1}"
            if not (g["z"].tolist() == w["z"].tolist()
                    and all(g[k] == w[k] for k in (
                        "n_available", "n_associated", "sweeps",
                        "avg_staleness"))):
                raise AssertionError(f"{msg}: decisions differ from its own "
                                     f"run: {g} {w}")
            for key, v in _check_bill(msg, g, w, n_test).items():
                worst[key] = max(worst.get(key, 0.0), v)
        if not torch.equal(final.staleness[s].cpu(), o_state.staleness.cpu()):
            raise AssertionError(f"[fleet] {label} seed {seeds[s]}: final "
                                 f"staleness differs from its own run")
    who = [seeds[s] if not worlds else f"{worlds[s]}/{seeds[s]}"
           for s in members]
    log(f"[fleet] {label}: seeds {who} each equal their own run_scanned: "
        f"z, n_available, n_associated, sweeps, staleness exact; "
        f"max rel diff " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + " (limits cost/time/energy 1e-5, loss 1e-4): ok")


def _fleet_card_vs_cpu(cfg, spec, states, bundles, gens, label):
    """One fleet round from ``states`` with fresh draws, on the card and,
    from the same states and draws, on the CPU, to ``card_vs_cpu``'s
    tolerances for every seed."""
    import torch
    from repro_torch.core import engine
    cpu = torch.device("cpu")
    draws = engine.fleet_draws(cfg, bundles, gens, spec)
    s_gpu, m_gpu = engine.fleet_step(cfg, spec, states, bundles, draws)
    s_cpu, m_cpu = engine.fleet_step(cfg, spec, _to(states, cpu),
                                     _to(bundles, cpu), _to(draws, cpu))
    n_test = bundles.test_y.shape[1]
    for s in range(bundles.dist.shape[0]):
        g = engine.metrics_row(_to(engine.select_seed(m_gpu, s), cpu))
        c = engine.metrics_row(engine.select_seed(m_cpu, s))
        tag = f"[card-vs-cpu] fleet {label} seed {s}"
        if not (g["z"].tolist() == c["z"].tolist()
                and (g["n_associated"], g["sweeps"])
                == (c["n_associated"], c["sweeps"])
                and torch.equal(s_gpu.staleness[s].cpu(), s_cpu.staleness[s])):
            raise AssertionError(f"{tag}: decisions differ: {g} {c}")
        _check_bill(tag, g, c, n_test)
    log(f"[card-vs-cpu] fleet {label}: every seed's z, n_associated, sweeps, "
        f"staleness exact; cost/time/energy rtol 1e-5, loss rtol 1e-4, "
        f"accuracy atol 2/T: ok")


def _seed_axis_call(label, call, seeds, plain, work):
    """A seed-axis kernel call ``call(sl)`` over the seeds ``sl`` of a
    fleet: the whole fleet's call held to its plain version on the same
    inputs (``plain(got)`` raises on a disagreement and returns the max abs
    error), each seed's rows bit-equal to its own single-seed call; then
    S = 1 and S in turns S = 1, S, S, S = 1, wrapper and device time (graph
    replay) of one call, beside the fleet's bound (``work``)."""
    import torch
    fleet = call(slice(None))
    err = plain(fleet)
    for s in range(seeds):
        if not torch.equal(fleet[s], call(slice(s, s + 1))[0]):
            raise AssertionError(f"[fleet] {label}: seed {s} of the fleet's "
                                 f"call differs from its own")
    times = {1: [], seeds: []}
    for size in (1, seeds, seeds, 1):
        sl = slice(0, size)
        times[size].append((time_ms(lambda: call(sl)),
                            graph_ms(lambda: call(sl))))
    b_ms, b_by = bound_ms(*work)
    log(f"[fleet] {label}: S={seeds} against plain max_abs_err {err:.3e}; "
        f"each seed bit-equal to its own call; " + "; ".join(
            f"S={size} " + ", ".join(f"{c:.4f} ms (device {d:.4f})"
                                     for c, d in t)
            for size, t in times.items())
        + f"; bound at S={seeds} {b_ms:.6f} ms ({b_by})")


def _fleet_kernel_times(cfg, states, bundles, dev):
    """The fused score (on the fleet's own gains, counts and staleness)
    and the SIC over a ``CONFIG`` fleet of S seeds: the score bit-equal to
    the plain torch chain, the SIC to ``sic_rates_plain`` at
    ``TOL["sic_rates"]``, each seed to its own call, timed against S = 1
    (``_seed_axis_call``).  Then the SGD kernel at the fleet's S·K lanes
    against its plain version, beside its bound."""
    import torch
    from repro_torch.core import fuzzy, noma
    from repro_torch.kernels import hfl_ops
    seeds = bundles.dist.shape[0]
    dm = float(cfg.max_samples)
    n, m = cfg.n_clients, cfg.n_edges

    def score(sl):
        return hfl_ops.score_matrix(states.gains[sl], bundles.counts[sl],
                                    states.staleness[sl], data_max=dm)

    def score_plain(got):
        want = fuzzy.score_matrix(states.gains, bundles.counts,
                                  states.staleness, data_max=dm,
                                  rows=hfl_ops.score_rows_plain)
        if not torch.equal(got, want):
            raise AssertionError(f"[fleet] score_matrix S={seeds}: not "
                                 f"bit-equal to the plain chain (max abs "
                                 f"err {_max_err(got, want):.3e})")
        return _max_err(got, want)
    _seed_axis_call("score_matrix CONFIG", score, seeds, score_plain,
                    [seeds * v for v in score_fused_work(n, m)])
    sic_in = [sic_inputs(n, m, cfg.clients_per_edge, 20 + s, dev, False)
              for s in range(seeds)]
    p, g, mask = (torch.stack(f) for f in zip(*sic_in))
    kw = dict(bandwidth_hz=1e6, noise_w=noma.noise_power_w(-174.0, 1e6))
    tol = TOL["sic_rates"]

    def sic_plain(got):
        want = hfl_ops.sic_rates_plain(p, g, mask, **kw)
        for s in range(seeds):
            _check_close(f"[fleet] sic_rates S={seeds} seed {s}", got[s],
                         want[s], tol["rtol"],
                         float(want[s].abs().max()) * tol["atol_frac"])
        return _max_err(got, want)
    _seed_axis_call("sic_rates CONFIG", lambda sl: hfl_ops.sic_rates(
        p[sl], g[sl], mask[sl], **kw), seeds, sic_plain,
        [sum(v) for v in zip(*(sic_work(mask[s]) for s in range(seeds)))])
    lanes = seeds * min(n, cfg.clients_per_edge * m)
    _, ms_k, _, work = compare_sgd(lanes, cfg.tau1, cfg.local_batch,
                                   cfg.input_dim, cfg.hidden, cfg.n_classes,
                                   31, dev)
    b_ms, b_by = bound_ms(*work)
    log(f"[fleet] local_sgd_step CONFIG S={seeds} ({lanes} lanes, one "
        f"launch): {ms_k:.4f} ms (graph replay), bound {b_ms:.6f} ms "
        f"({b_by})")


def _fleet_frontier_score(cfg, states, bundles, k):
    """The fused score on a fleet's own frontier (its gains, K nearest
    candidates, counts and staleness): bit-equal to the plain chain
    (``fuzzy.candidate_inputs`` + ``score_rows_plain``), each seed to its
    own call, timed against S = 1 (``_seed_axis_call``)."""
    import torch
    from repro_torch.core import candidates, engine, fuzzy
    from repro_torch.kernels import hfl_ops
    seeds = bundles.dist.shape[0]
    n, m = cfg.n_clients, cfg.n_edges
    dm = float(cfg.max_samples)
    idx = candidates.build_candidates(
        bundles.dist, k, coverage_radius_m=engine.coverage_radius(cfg)).idx

    def call(sl):
        return hfl_ops.score_candidates(states.gains[sl], idx[sl],
                                        bundles.counts[sl],
                                        states.staleness[sl], data_max=dm)

    def plain(got):
        want = hfl_ops.score_rows_plain(*fuzzy.candidate_inputs(
            states.gains, idx, bundles.counts, states.staleness,
            data_max=dm)).reshape(idx.shape)
        if not torch.equal(got, want):
            raise AssertionError(f"[fleet] score_candidates S={seeds}: not "
                                 f"bit-equal to the plain chain (max abs "
                                 f"err {_max_err(got, want):.3e})")
        return _max_err(got, want)
    _seed_axis_call(f"score_candidates {n}x{m} K={k}", call, seeds, plain,
                    [seeds * v for v in score_fused_work(n, m, k)])


def phase_fleet(cfg, dev, profile=False):
    """The fleet path.  ``CONFIG`` fcea + PDD, 5 rounds of ``run_fleet``
    at S = 1, the reference's S = 4 and S = 8 (seeds 0-7) in turns 1, 4,
    8, 8, 4, 1; every seed of the S = 8 and S = 4 fleets against its own
    ``run_scanned``; the score and SIC calls at S = 8 against their plain
    versions and S = 1; a round at S = 2 card against CPU.  Then the bench
    scale (4096 × 32, K = 8), 3 rounds at the reference's S = 2 and at
    S = 4, a seed of each against its own run, and the frontier score at
    S = 4 against its plain version and S = 1."""
    import dataclasses
    from repro_torch.core import engine
    spec = engine.EngineSpec()
    seeds = tuple(range(max(FLEET_SEEDS)))
    sizes = (1, REF_FLEET_SEEDS[0], FLEET_SEEDS[0])
    # the sizes in turns (the host's pace drifts within a run)
    runs = {size: [] for size in sizes}
    for size in sizes + sizes[::-1]:
        runs[size].append(_drive_fleet(cfg, spec, seeds[:size], 5, dev,
                                       f"CONFIG S={size}"))
    steady = {size: [r[1] for r in rs] for size, rs in runs.items()}
    log("[fleet] CONFIG fcea-pdd s/round in turns "
        + ", ".join(f"S={z}" for z in sizes + sizes[::-1]) + ": "
        + "; ".join(f"S={z} " + ", ".join(f"{v:.4f}" for v in steady[z])
                    for z in sizes)
        + "; seed-rounds/s " + ", ".join(
            f"S={z} {2 * z / sum(steady[z]):.2f}" for z in sizes)
        + f"; S={sizes[-1]}/S=1 "
        f"{sum(steady[sizes[-1]]) / sum(steady[1]):.3f}x")
    fm, steady_s, final, _ = runs[len(seeds)][0]
    if profile:
        states, bundles, gens = final
        profile_device(lambda: engine.run_fleet(cfg, spec, states, bundles,
                                                1, gens),
                       f"one steady CONFIG fleet round S={len(seeds)}",
                       steady_s)
    own = {}
    _fleet_vs_own(cfg, spec, seeds, range(len(seeds)), fm, final[0], dev,
                  f"CONFIG S={len(seeds)}", own)
    fm4, _, final4, _ = runs[REF_FLEET_SEEDS[0]][0]
    _fleet_vs_own(cfg, spec, seeds, range(REF_FLEET_SEEDS[0]), fm4,
                  final4[0], dev, f"CONFIG S={REF_FLEET_SEEDS[0]}", own)
    states, bundles, gens = final
    _fleet_kernel_times(cfg, states, bundles, dev)
    two = slice(0, 2)
    _fleet_card_vs_cpu(cfg, spec, engine.select_seed(states, two),
                       engine.select_seed(bundles, two), gens[:2],
                       "CONFIG S=2")
    big = bench_config(cfg)
    k8 = dataclasses.replace(spec, candidates_k=8)
    for size, member in ((REF_FLEET_SEEDS[1], 1), (FLEET_SEEDS[1], 0)):
        label = f"4096x32 K=8 S={size}"
        fm, _, final, _ = _drive_fleet(big, k8, seeds[:size], 3, dev, label)
        _fleet_vs_own(big, k8, seeds[:size], [member], fm, final[0], dev,
                      label)
    _fleet_frontier_score(big, final[0], final[1], 8)


# ---------------------------------------------------------------------------
# Dynamic scenarios and the fpa/fca allocators
# ---------------------------------------------------------------------------

# the reference's sweep worlds (src/repro/sweeps/grid.py's defaults,
# benchmarks/bench_sweeps.py::bench_sweep_fleet) and the churny worlds of
# its sync/buffered A/B (benchmarks/bench_rounds.py::AB_SCENARIOS)
SWEEP_WORLDS = ("random_waypoint", "markov_dropout", "hetero_devices")
AB_WORLDS = ("flash_crowd", "markov_dropout")


def _scenario_config_round(cfg, dev, static_steady):
    """``HFLSimulation(CONFIG, scenario="full_dynamic")``, fcea + PDD, 5
    rounds beside the static ``[main]`` round; one round card vs CPU.
    Returns the run's launches (the scenario path's counts)."""
    m_c = max(1, int(round(cfg.semi_sync_fraction * cfg.n_edges)))
    sim, rows, walls, stages, launches = _drive(
        cfg, "fcea", "pdd", 5, dev, scenario="full_dynamic")
    want = _want_launches(cfg, sim.spec, 5)
    if launches != want:
        raise AssertionError(f"[scenario] full_dynamic: launches {launches} "
                             f"!= expected {want}")
    _check_metrics(cfg, cfg.clients_per_edge, rows, m_c)
    steady = _report("scenario", "CONFIG full_dynamic fcea-pdd", rows, walls,
                     stages, launches)
    log(f"[scenario] CONFIG full_dynamic s/round {steady:.4f} against the "
        f"static [main] round {static_steady:.4f} in this run "
        f"({steady / static_steady:.3f}x)")
    card_vs_cpu(cfg, sim.spec, sim.state, sim.bundle, sim.generator,
                "CONFIG full_dynamic")
    return launches


OVERHEAD_TURNS = ("static", "dynamic", "dynamic", "static") * 2


def _scenario_overhead(cfg, dev):
    """The reference's ``bench_sweeps.bench_engine_overhead``: 256 × 8,
    gcea + fastest, static against ``full_dynamic``, 15 rounds a run, in
    ``OVERHEAD_TURNS``; ``dynamic_overhead_pct`` from each label's median
    steady s a round (the reference takes the median of 5 runs: its host
    jitter once gave a negative overhead)."""
    from repro_torch.core import engine
    big = bench_config(cfg, 256, 8)
    runs = {"static": (engine.EngineSpec(policy="gcea", scheduler="fastest"),
                       None),
            "dynamic": (engine.EngineSpec(policy="gcea", scheduler="fastest",
                                          scenario="dynamic"),
                        "full_dynamic")}
    steady = {label: [] for label in runs}
    for label in OVERHEAD_TURNS:
        spec, world = runs[label]
        steady[label].append(_run_spec(
            big, spec, 15, dev, f"256x8 {label} gcea-fastest",
            tag="scenario", scenario=world, per_round=False)[1])
    med = {k: statistics.median(v) for k, v in steady.items()}
    pct = 100.0 * (med["dynamic"] / med["static"] - 1.0)
    log(f"[scenario] 256x8 gcea-fastest s/round (rounds 2..15) in turns "
        f"{', '.join(OVERHEAD_TURNS)}: static "
        + ", ".join(f"{v:.5f}" for v in steady["static"]) + "; dynamic "
        + ", ".join(f"{v:.5f}" for v in steady["dynamic"])
        + f"; medians {med['static']:.5f}, {med['dynamic']:.5f}; "
        f"dynamic_overhead_pct {pct:.2f}")


def _scenario_fleet(cfg, dev):
    """The reference's sweep fleet: 256 × 8, fcea + PDD, kind "dynamic",
    the three sweep worlds × seeds 0-3 (S = 12) for 5 rounds, beside one
    seed's 5 rounds; one member of each world against its own run on the
    card."""
    from repro_torch.core import engine
    big = bench_config(cfg, 256, 8)
    spec = engine.EngineSpec(scenario="dynamic")
    one = _run_spec(big, spec, 5, dev, "256x8 random_waypoint S=1 fcea-pdd",
                    tag="scenario", scenario="random_waypoint",
                    per_round=False)[1]
    worlds = [w for w in SWEEP_WORLDS for _ in range(4)]
    seeds = [s for _ in SWEEP_WORLDS for s in range(4)]
    label = f"256x8 mixed worlds S={len(seeds)}"
    fm, steady_s, final, _ = _drive_fleet(big, spec, seeds, 5, dev, label,
                                          worlds)
    _fleet_vs_own(big, spec, seeds, [0, 5, 10], fm, final[0], dev, label,
                  worlds=worlds)
    log(f"[scenario] {label}: {steady_s:.4f} s/round, "
        f"{len(seeds) / steady_s:.2f} seed-rounds/s; one seed's round "
        f"(random_waypoint S=1) {one:.4f} s, {1.0 / one:.2f} seed-rounds/s; "
        f"S={len(seeds)}/S=1 round {steady_s / one:.3f}x")


def _scenario_sync_ab(cfg, dev):
    """The sync half of the reference's ``bench_rounds.async_ab``: 1024 ×
    16, gcea + fastest, 8 rounds of each churny world: wall s a round,
    simulated rounds a second (rounds / Σ total_time_s), n_available."""
    from repro_torch.core import engine
    big = bench_config(cfg, 1024, 16)
    for world in AB_WORLDS:
        spec = engine.EngineSpec(policy="gcea", scheduler="fastest",
                                 scenario="dynamic")
        rows, steady, _, _, _ = _run_spec(
            big, spec, 8, dev, f"1024x16 {world} gcea-fastest",
            tag="scenario", scenario=world, per_round=False)
        sim_s = sum(r.total_time_s for r in rows)
        log(f"[scenario] 1024x16 {world} sync: wall {steady:.4f} s/round; "
            f"{len(rows) / sim_s:.4f} simulated rounds/s "
            f"({len(rows)} rounds / {sim_s:.4f} s of Eq. 18 time); "
            f"n_available {[r.n_available for r in rows]}")


def _scenario_frontier(cfg, dev):
    """The frontier under mobility: 1024 × 16, K = 4, random_waypoint,
    fcea + PDD, 3 rounds; some client's frontier must change between
    rounds; one round card vs CPU."""
    from repro_torch.core import candidates, engine
    big = bench_config(cfg, 1024, 16)
    spec = engine.EngineSpec(candidates_k=4, scenario="dynamic")
    fronts = []

    def frontier(state):
        fronts.append(candidates.build_candidates(
            state.scenario.dist, 4,
            coverage_radius_m=engine.coverage_radius(big)).idx.cpu())
    state, bundle, gen = _run_spec(big, spec, 3, dev,
                                   "1024x16 K=4 random_waypoint fcea-pdd",
                                   tag="scenario",
                                   scenario="random_waypoint",
                                   on_round=frontier)[4]
    moved = [int((a != b).any(dim=-1).sum())
             for a, b in zip(fronts, fronts[1:])]
    if not all(moved):
        raise AssertionError(f"[scenario] 1024x16 K=4: no client's frontier "
                             f"changed in some round ({moved} changed)")
    log(f"[scenario] 1024x16 K=4 random_waypoint: clients whose frontier "
        f"changed, rounds 1..3: {moved}")
    card_vs_cpu(big, spec, state, bundle, gen, "1024x16 K=4 random_waypoint")


@contextlib.contextmanager
def _recording_grid():
    """Record every ``env.grid_best_action`` call the engine makes while
    the block runs: its inputs and the action it chose (no copy, no
    sync)."""
    from repro_torch.core import env
    calls, real = [], env.grid_best_action

    def record(cfg, params, gains, **kw):
        action = real(cfg, params, gains, **kw)
        calls.append((params, gains, kw, action))
        return action
    env.grid_best_action = record
    try:
        yield calls
    finally:
        env.grid_best_action = real


def _scenario_grid(cfg, dev):
    """fpa and fca at ``CONFIG`` on hetero_devices, fcea + PDD, 3 rounds
    each (two SIC calls a round: the grid's and the bill's).  The action
    each timed round's grid chose is held against the same grid on the
    CPU, on that round's own inputs, exactly; so are those inputs billed
    with time weighted 100:1 over energy, where the best point lies inside
    the grid.  The fca grid's (16, N, M) SIC call goes against its plain
    version; one round card vs CPU."""
    import dataclasses
    import torch
    from repro_torch.core import engine, env, noma
    from repro_torch.kernels import hfl_ops
    cpu = torch.device("cpu")
    timed = dataclasses.replace(cfg, lambda_t=1.0, lambda_e=0.01)
    fracs = env.grid_fractions(16, cpu).tolist()
    for allocator in ("fpa", "fca"):
        spec = engine.EngineSpec(allocator=allocator, scenario="dynamic")
        label = f"CONFIG hetero_devices {allocator} fcea-pdd"
        with _recording_grid() as calls:
            _, _, _, launches, final = _run_spec(cfg, spec, 3, dev, label,
                                                 tag="scenario",
                                                 scenario="hetero_devices")
        log(f"[scenario] {label}: {launches['sic_rates'] / 3:.0f} sic_rates "
            f"launches a round (the grid's G = 16 points folded into one "
            f"call, and the bill's)")
        if len(calls) != 3:
            raise AssertionError(f"[scenario] {label}: {len(calls)} grid "
                                 f"calls in 3 rounds")
        axis = 0 if allocator == "fpa" else 1
        picks = {}
        for weights, c in (("paper", cfg), ("time 100:1", timed)):
            idx = []
            for r, (params, gains, kw, chosen) in enumerate(calls, 1):
                a_gpu = chosen if c is cfg else env.grid_best_action(
                    c, params, gains, **kw)
                a_cpu = env.grid_best_action(c, _to(params, cpu),
                                             _to(gains, cpu), **kw)
                if not torch.equal(a_gpu.cpu(), a_cpu):
                    raise AssertionError(
                        f"[scenario] {label} round {r} ({weights} "
                        f"weights): the grid's action differs on the card "
                        f"and the CPU")
                idx.append(fracs.index(float(a_cpu[0, 1 - axis, 0])))
            picks[weights] = idx
        if not any(i > 0 for v in picks.values() for i in v):
            raise AssertionError(f"[scenario] {label}: every grid pick is "
                                 f"point 0 ({picks}); the grid's fold and "
                                 f"argmin are not exercised")
        log(f"[card-vs-cpu] {label}: each timed round's grid action exact "
            f"on its own inputs; grid point chosen, rounds 1..3: "
            + "; ".join(f"{k} weights {v}" for k, v in picks.items()))
        state, bundle, gen = final
        card_vs_cpu(cfg, spec, state, bundle, gen, label)
        if allocator == "fca":
            # the last timed round's own grid SIC call: 16 power rows at
            # the caps, on that round's association and gains
            params, gains, _, _ = calls[-1]
            g = env.grid_fractions(16, dev)
            act = torch.ones((16, 2, cfg.n_clients), device=dev)
            act[:, 0, :] = g[:, None]
            p, _ = env.env_decode_action(cfg, params, act)
            gains = gains.expand(16, -1, -1).contiguous()
            mask = (params.assoc > 0).expand(16, -1, -1).contiguous()
            kw = dict(bandwidth_hz=cfg.bandwidth_hz,
                      noise_w=noma.noise_power_w(cfg.noise_dbm_per_hz,
                                                 cfg.bandwidth_hz))
            got = hfl_ops.sic_rates(p, gains, mask, **kw)
            want = hfl_ops.sic_rates_plain(p, gains, mask, **kw)
            tol = TOL["sic_rates"]
            _check_close(f"[scenario] fca grid sic_rates (16, "
                         f"{cfg.n_clients}, {cfg.n_edges})", got, want,
                         tol["rtol"], float(want.abs().max())
                         * tol["atol_frac"])
            ms_k = time_ms(lambda: hfl_ops.sic_rates(p, gains, mask, **kw))
            ms_dev = graph_ms(lambda: hfl_ops.sic_rates(p, gains, mask, **kw))
            ms_p = time_ms(lambda: hfl_ops.sic_rates_plain(p, gains, mask,
                                                           **kw))
            work = [sum(v) for v in zip(*(sic_work(mask[i])
                                          for i in range(16)))]
            b_ms, b_by = bound_ms(*work)
            log(f"[scenario] fca grid sic_rates (16, {cfg.n_clients}, "
                f"{cfg.n_edges}) against plain: max_abs_err "
                f"{_max_err(got, want):.3e}; kernel {ms_k:.4f} ms (device "
                f"{ms_dev:.4f} ms by graph replay), plain {ms_p:.4f} ms, "
                f"bound {b_ms:.6f} ms ({b_by})")


def _scenario_all_dropped(cfg, dev):
    """Every client dropped (p_drop 1, p_return 0) at ``CONFIG``, gcea +
    fastest, one round on the card: nothing available or associated, the
    global model unchanged bit for bit, a finite bill."""
    import torch
    from repro_torch import scenarios
    from repro_torch.core.hfl import HFLSimulation
    from repro_torch.kernels import hfl_ops
    sim = HFLSimulation(cfg, seed=0, policy="gcea", scheduler="fastest",
                        scenario=scenarios.ScenarioSpec(
                            kind="markov_dropout", p_drop=1.0,
                            p_return=0.0), device=dev)
    before = {k: v.clone() for k, v in sim.state.global_params.items()}
    torch.cuda.synchronize()
    hfl_ops.reset_launches()
    m = sim.run_round()
    torch.cuda.synchronize()
    launches = dict(hfl_ops.LAUNCHES)
    want = _want_launches(cfg, sim.spec, 1)
    if launches != want:
        raise AssertionError(f"[scenario] all dropped: launches {launches} "
                             f"!= expected {want}")
    same = all(torch.equal(sim.state.global_params[k], v)
               for k, v in before.items())
    if not (m.n_available == m.n_associated == 0 and same
            and math.isfinite(m.cost)):
        raise AssertionError(f"[scenario] all dropped: {m}; global model "
                             f"unchanged: {same}")
    log(f"[scenario] CONFIG all clients dropped, gcea-fastest: n_available "
        f"0, n_associated 0, global model bit-equal, cost {m.cost:.5f} "
        f"finite; launches {launches}: ok")


def phase_scenario(cfg, dev, static_steady):
    """The dynamic-scenario path and the fpa/fca allocators, each run with
    the launch counters zeroed just before and read just after.  Returns
    the ``CONFIG`` full_dynamic run's launches."""
    launches = _scenario_config_round(cfg, dev, static_steady)
    _scenario_overhead(cfg, dev)
    _scenario_fleet(cfg, dev)
    _scenario_sync_ab(cfg, dev)
    _scenario_frontier(cfg, dev)
    _scenario_grid(cfg, dev)
    _scenario_all_dropped(cfg, dev)
    return launches


# ---------------------------------------------------------------------------
# The substrate: sequence kernels and recurrentgemma-9b serving
# ---------------------------------------------------------------------------

def attention_mask(s, causal, window, dev):
    """(S, S) bool: query p may see key j -- the function's own mask."""
    import torch
    pos = torch.arange(s, device=dev)
    mask = torch.ones((s, s), dtype=torch.bool, device=dev)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    return mask


def flash_work(b, s, h, kv, d, itemsize, mask):
    """Bytes (q, k, v read once, o written once) and flops (QK^T and PV,
    4 · D per allowed (query, key) pair and head) the function needs --
    counted from the mask, not from the kernel's tiles."""
    pairs = int(mask.sum())
    n_bytes = itemsize * b * s * d * (2 * h + 2 * kv)
    return n_bytes, 4.0 * b * h * pairs * d


def _seq_inputs(shape, dtype, seed, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.normal(size=shape).astype(np.float32),
                        device=dev).to(dtype)


def compare_flash(b, s, h, kv, d, causal, window, dtype, seed, dev,
                  library=False, timed=True):
    """Kernel vs plain, checking that the call launched the kernel
    ``seq_ops.flash_route`` names; with ``timed``, the times of both
    beside the bound and, with ``library``, the time of PyTorch's
    scaled_dot_product_attention with the same boolean mask -- a yardstick
    the port never calls.  Returns err, ms, plain ms, bound, library ms."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import seq_ops
    q = _seq_inputs((b, s, h, d), dtype, seed, dev)
    k = _seq_inputs((b, s, kv, d), dtype, seed + 1, dev)
    v = _seq_inputs((b, s, kv, d), dtype, seed + 2, dev)
    kw = dict(causal=causal, window=window)
    route = seq_ops.flash_route(dtype, d)
    before = seq_ops.LAUNCHES["flash_attention_wgmma"]
    got = seq_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    name = f"flash_attention B={b} S={s} H={h} KV={kv} D={d} " \
           f"causal={causal} window={window} {str(dtype)[6:]} ({route})"
    wgmma = int(route == "seq_flash_attention_wgmma")
    if seq_ops.LAUNCHES["flash_attention_wgmma"] - before != wgmma:
        raise AssertionError(f"{name}: the tensor-core kernel was launched "
                             f"{seq_ops.LAUNCHES['flash_attention_wgmma'] - before}"
                             f" times, expected {wgmma}")
    if dtype == torch.bfloat16:
        # held to the plain version in fp32 on the same (bf16) inputs,
        # rounded to bf16 once, as the kernel rounds only its output; the
        # bf16 plain version, which rounds at every step, is printed only
        info = _max_err(got, seq_ops.attention_plain(q, k, v, **kw))
        log(f"[seq] {name}: bf16 plain vs kernel max abs {info:.3e} "
            f"(information)")
        want = seq_ops.attention_plain(q.float(), k.float(), v.float(),
                                       **kw).to(dtype)
    else:
        want = seq_ops.attention_plain(q, k, v, **kw)
    _check_close(name, got.float(), want.float(),
                 **FLASH_TOL[str(dtype)[6:]])
    err = _max_err(got, want)
    del want
    if not timed:
        log(f"[seq] {name}: max_abs_err {err:.3e}")
        return err
    ms_k = time_ms(lambda: seq_ops.flash_attention(q, k, v, **kw))
    ms_p = time_ms(lambda: seq_ops.attention_plain(q, k, v, **kw))
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    mask = attention_mask(s, causal, window, dev)
    b_ms, b_by = bound_ms(*flash_work(b, s, h, kv, d, q.element_size(),
                                      mask), peak)
    lib_ms = None
    if library:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        lib_err = _max_err(sdpa().transpose(1, 2), got)
        lib_ms = time_ms(sdpa)
        log(f"[seq] {name}: sdpa vs kernel max abs {lib_err:.3e}")
    log(f"[seq] {name}: max_abs_err {err:.3e}  kernel {ms_k:.4f} ms  "
        f"plain {ms_p:.4f} ms  bound {b_ms:.6f} ms ({b_by}; kernel "
        f"{ms_k / b_ms:.2f}x)"
        + (f"  sdpa {lib_ms:.4f} ms" if lib_ms is not None else ""))
    return err, ms_k, ms_p, b_ms, b_by, lib_ms


def compare_linrec(b, s, c, dtype, seed, dev, timed=True):
    """Kernel vs plain, bit for bit (the kernel does the plain version's
    exp, IEEE multiply and add in the same order); with ``timed``, both
    times beside the bound."""
    import torch
    from repro_torch.kernels import seq_ops
    log_a = -_seq_inputs((b, s, c), torch.float32, seed, dev).abs() \
        .mul_(0.1).to(dtype)
    x = _seq_inputs((b, s, c), dtype, seed + 1, dev)
    got = seq_ops.linear_recurrence(log_a, x)
    want = seq_ops.linear_recurrence_plain(log_a, x)
    torch.cuda.synchronize()
    vec = seq_ops.linrec_vector_bytes(c, x.element_size(), log_a.data_ptr(),
                                      x.data_ptr())
    name = (f"linear_recurrence B={b} S={s} C={c} {str(dtype)[6:]} (ring "
            f"{seq_ops.LINREC_STAGES} x {seq_ops.LINREC_TILE} steps x "
            f"{seq_ops.LINREC_CHANNELS} channels, {vec}-byte copies)")
    err = _max_err(got, want)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: not bit-equal to its plain version "
                             f"(max abs err {err:.3e})")
    if not timed:
        log(f"[seq] {name}: bit-equal")
        return err
    ms_k = time_ms(lambda: seq_ops.linear_recurrence(log_a, x))
    ms_p = time_ms(lambda: seq_ops.linear_recurrence_plain(log_a, x),
                   min_iters=2, budget_s=0.2)
    n = b * s * c
    b_ms, b_by = bound_ms(2 * n * log_a.element_size() + 4 * n, 3 * n)
    # a yardstick of what the card streams: one elementwise pass that
    # reads log_a and x and writes a float32 tensor of the same size
    sink = torch.empty((b, s, c), dtype=torch.float32, device=dev)
    ms_s = time_ms(lambda: torch.add(log_a, x, out=sink))
    log(f"[seq] {name}: bit-equal  kernel {ms_k:.4f} ms  plain {ms_p:.4f} "
        f"ms  bound {b_ms:.6f} ms ({b_by}; kernel at "
        f"{100.0 * b_ms / ms_k:.1f}% of it; a streaming add over the same "
        f"bytes {ms_s:.4f} ms, {100.0 * b_ms / ms_s:.1f}%)")
    return err, ms_k, ms_p, b_ms, b_by, None


# the recurrence kernel's edge shapes (tests/test_torch_cuda.py): S not a
# multiple of the ring's tile, C not a multiple of the block's channels,
# B·C below one block, S = 1, bf16 rows of odd C (2-byte copies)
LINREC_EDGES = [(1, 77, 130), (1, 300, 20), (2, 1, 96), (1, 33, 13),
                (4, 129, 8)]


def phase_seq_compare(dev):
    """The sequence kernels vs their plain versions: recurrentgemma-9b's
    prefill shapes (returned for the JSON line), then ragged and
    non-causal shapes (printed)."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    main = {
        "flash_attention": compare_flash(2, 4096, 16, 1, 256, True, 2048,
                                         bf16, 11, dev, library=True),
        "linear_recurrence": compare_linrec(2, 4096, 4096, f32, 14, dev),
    }
    for i, shape in enumerate(WGMMA_EDGES):
        compare_flash(*shape, bf16, 40 + 3 * i, dev, timed=False)
    compare_flash(1, 130, 2, 1, 80, True, 50, bf16, 24, dev, timed=False)
    compare_flash(1, 1000, 4, 2, 64, True, 300, f32, 21, dev)
    compare_flash(1, 300, 4, 1, 256, False, 100, f32, 27, dev, timed=False)
    compare_linrec(1, 1000, 130, bf16, 31, dev)
    compare_linrec(2, 4096, 4096, bf16, 33, dev)
    for i, shape in enumerate(LINREC_EDGES):
        for dtype in (f32, bf16):
            compare_linrec(*shape, dtype, 50 + i, dev, timed=False)
    torch.cuda.empty_cache()
    return main


def _launch_counts():
    from repro_torch.kernels import hfl_ops, seq_ops
    return {**hfl_ops.LAUNCHES, **seq_ops.LAUNCHES}


def _reset_launches():
    from repro_torch.kernels import hfl_ops, seq_ops
    hfl_ops.reset_launches()
    seq_ops.reset_launches()


def _rel_rms(got, want):
    d = (got.float() - want.float())
    return float(d.square().mean().sqrt() / want.float().square().mean()
                 .sqrt())


def phase_serve(dev, profile=False, batch=2, seq=4096, prompt_len=64,
                new_tokens=16):
    """recurrentgemma-9b at full width and depth on the card; with
    ``profile``, also the device busy share and top kernels of one
    prefill and one decode step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, steps
    cfg = get_config("recurrentgemma-9b")
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    prefill, model = steps.make_prefill_step(cfg, device=dev, generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers {cfg.block_pattern}, "
        f"{n_params} params ({n_params * 4 / 1e9:.2f} GB fp32) drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=dev)

    # the main path: one prefill with every launch counter zeroed
    _reset_launches()
    t0 = time.perf_counter()
    logits = prefill({"tokens": tokens})
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _launch_counts()
    want = {"score_rows": 0, "score_matrix": 0, "score_candidates": 0,
            "sic_rates": 0,
            "local_sgd_step": 0, "local_sgd_step_cluster": 0,
            "flash_attention": 12,
            "flash_attention_wgmma": 12, "linear_recurrence": 26}
    if launches != want:
        raise AssertionError(f"prefill launches {launches} != {want}")
    if tuple(logits.shape) != (batch, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits: shape {tuple(logits.shape)}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        prefill({"tokens": tokens})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    pre_s = sum(walls) / len(walls)
    peak_prefill = torch.cuda.max_memory_allocated(dev)
    log(f"[serve] prefill {batch} x {seq}: launches {launches}; "
        f"{pre_s * 1e3:.2f} ms ({batch * seq / pre_s:.1f} tokens/s; runs "
        f"{', '.join(f'{w * 1e3:.2f}' for w in walls)} ms; first "
        f"{first_s * 1e3:.2f} ms); peak memory {peak_prefill / 1e9:.2f} GB")

    # the serve path: token-by-token prompt feed, then greedy decode
    serve_step, _ = steps.make_serve_step(cfg, model=model)
    prompt = tokens[:, :prompt_len]
    cache = model.init_cache(batch, cfg.window)
    before = _launch_counts()
    t0 = time.perf_counter()
    feed_logits, cache = serve.prefill_into_cache(model, prompt, cache)
    torch.cuda.synchronize()
    feed_s = time.perf_counter() - t0
    tok = torch.argmax(feed_logits[:, -1, :], dim=-1,
                       keepdim=True).to(torch.int32)
    out, step_ms = [], []
    for i in range(new_tokens):
        t0 = time.perf_counter()
        tok, cache = serve_step(tok, cache, prompt_len + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(tok[:, 0])
    if _launch_counts() != before:
        raise AssertionError("the decode path launched a kernel")
    gen_tokens = torch.stack(out, dim=1)
    if not bool(((gen_tokens >= 0) & (gen_tokens < cfg.vocab_size)).all()):
        raise AssertionError("generated tokens outside the vocabulary")
    steady = step_ms[1:]
    decode_ms = sum(steady) / len(steady)
    log(f"[serve] decode {batch} requests: prompt of {prompt_len} fed token "
        f"by token in {feed_s * 1e3:.2f} ms ({feed_s * 1e3 / prompt_len:.2f} "
        f"ms/token); {new_tokens} greedy tokens at {decode_ms:.3f} ms/token "
        f"(steps 2..{new_tokens}; first {step_ms[0]:.3f}); "
        f"sample {gen_tokens[0, :8].tolist()}")

    if profile:
        profile_device(lambda: prefill({"tokens": tokens}),
                       f"one prefill {batch} x {seq}", pre_s)
        index = prompt_len + new_tokens
        profile_device(lambda: serve_step(tok, cache, index),
                       "one decode step", decode_ms / 1e3)

    # the kernel path against the token-by-token decode
    pre_logits = prefill({"tokens": prompt})
    rel = _rel_rms(pre_logits, feed_logits[:, 0])
    err = _max_err(pre_logits, feed_logits[:, 0])
    agree = float((pre_logits.argmax(-1) == feed_logits[:, 0].argmax(-1))
                  .float().mean())
    log(f"[serve] prefill vs decode, last logits of the {prompt_len}-token "
        f"prompt: rel rms {rel:.3e} (limit {PREFILL_DECODE_REL_RMS}), max abs "
        f"{err:.3e}, argmax agreement {agree:.2f}")
    if not rel <= PREFILL_DECODE_REL_RMS:
        raise AssertionError(f"prefill and decode logits disagree: rel rms "
                             f"{rel:.3e}")
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[serve] peak device memory {peak / 1e9:.2f} GB")
    del model, cache, prefill, serve_step
    torch.cuda.empty_cache()
    return launches


def phase_substrate(dev, seq=300):
    """The reduced config (float32, window 32) from the same weights: the
    prefill's last logits and every position's logits on the card
    (kernels) against the CPU (plain versions), and against a token-by-
    token decode on the card through a ``window``-slot ring.  ``seq`` is
    ragged and spans several flash q-tiles, so tiles left of the window
    are skipped."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models.transformer import Transformer
    cfg = get_config("recurrentgemma-9b").reduced()
    gen = torch.Generator(device="cpu").manual_seed(1)
    cpu_model = Transformer(cfg, device="cpu", generator=gen)
    card_model = Transformer(cfg, device=dev)
    card_model.load_state_dict(cpu_model.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, seq), generator=gen)
    pre_cpu, _ = steps.make_prefill_step(cfg, model=cpu_model)
    pre_card, _ = steps.make_prefill_step(cfg, model=card_model)
    _reset_launches()
    last_card = pre_card({"tokens": tokens.to(dev)})
    full_card = card_model.apply(tokens.to(dev))
    torch.cuda.synchronize()
    launches = _launch_counts()
    if (launches["flash_attention"], launches["flash_attention_wgmma"],
            launches["linear_recurrence"]) != (2, 0, 4):
        raise AssertionError(f"reduced card launches {launches}")
    cache = card_model.init_cache(2, cfg.window)
    with torch.no_grad():
        decoded = torch.cat([
            card_model.decode_step(tokens[:, i:i + 1].to(dev), cache, i)[0]
            for i in range(seq)], dim=1)
    if _launch_counts() != launches:
        raise AssertionError("the decode path launched a kernel")
    for name, got, want in (
            ("card vs cpu, last logits", last_card.cpu(),
             pre_cpu({"tokens": tokens})),
            ("card vs cpu, all logits", full_card.cpu(),
             cpu_model.apply(tokens)),
            ("card prefill vs card decode, all logits", full_card, decoded)):
        _check_close(f"reduced {name}", got, want, **SUBSTRATE_TOL)
        log(f"[substrate] {cfg.name} S={seq} window {cfg.window}: {name} "
            f"max abs {_max_err(got, want):.3e} (atol "
            f"{SUBSTRATE_TOL['atol']}, rtol {SUBSTRATE_TOL['rtol']}): ok")


def phase_substrate_bf16(dev, seq=300):
    """The reduced config in bfloat16 (d_head 64, window 32): the prefill's
    logits at every position on the card (through the tensor-core flash
    kernel, over several q-tiles and the window skip) against a token-by-
    token decode on the card (plain attention)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Transformer
    cfg = get_config("recurrentgemma-9b").reduced().replace(
        compute_dtype_str="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(2)
    model = Transformer(cfg, device=dev, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, seq), generator=gen,
                           device=dev)
    _reset_launches()
    with torch.no_grad():
        full = model.apply(tokens)
    torch.cuda.synchronize()
    launches = _launch_counts()
    if (launches["flash_attention"], launches["flash_attention_wgmma"],
            launches["linear_recurrence"]) != (1, 1, 2):
        raise AssertionError(f"reduced bf16 card launches {launches}")
    cache = model.init_cache(2, cfg.window)
    with torch.no_grad():
        decoded = torch.cat([model.decode_step(tokens[:, i:i + 1], cache, i)[0]
                             for i in range(seq)], dim=1)
    if _launch_counts() != launches:
        raise AssertionError("the decode path launched a kernel")
    rel = _rel_rms(full, decoded)
    agree = float((full.argmax(-1) == decoded.argmax(-1)).float().mean())
    log(f"[substrate] {cfg.name} bf16 S={seq} window {cfg.window}: card "
        f"prefill (tensor-core flash, launches {launches['flash_attention_wgmma']}) "
        f"vs card decode, all logits: rel rms {rel:.3e} (limit "
        f"{PREFILL_DECODE_REL_RMS}), max abs {_max_err(full, decoded):.3e}, "
        f"argmax agreement {agree:.3f}")
    if not rel <= PREFILL_DECODE_REL_RMS:
        raise AssertionError(f"reduced bf16 prefill and decode logits "
                             f"disagree: rel rms {rel:.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the kernel results as JSON")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one steady fcea round (device idle "
                         "share)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.configs.hfl_mnist import CONFIG

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
        return out

    phase("build", phase_build)
    main_cmp = phase("hfl kernels vs plain", phase_compare, CONFIG, dev)
    runs = phase("hfl main path", phase_main_path, CONFIG, dev)
    sim = runs["fcea"][0]
    phase("hfl card vs cpu", card_vs_cpu, CONFIG, sim.spec, sim.state,
          sim.bundle, sim.generator)
    if args.profile:
        phase("hfl profile", profile_device, runs["fcea"][0].run_round,
              "one steady fcea round", runs["fcea"][2])
    cand = phase("hfl candidate path", phase_candidates, CONFIG, dev)
    phase("hfl fleet", phase_fleet, CONFIG, dev, args.profile)
    scen_launches = phase("hfl scenarios and fpa/fca", phase_scenario,
                          CONFIG, dev, runs["fcea"][2])
    seq_cmp = phase("seq kernels vs plain", phase_seq_compare, dev)
    seq_launches = phase("serve recurrentgemma-9b", phase_serve, dev,
                         args.profile)
    phase("substrate card vs cpu, prefill vs decode", phase_substrate, dev)
    phase("substrate bf16 prefill vs decode", phase_substrate_bf16, dev)

    # the entries of local_sgd_step and flash_attention are the cluster
    # kernel and the tensor-core kernel
    launches = {**runs["fcea"][1],
                "local_sgd_step": runs["fcea"][1]["local_sgd_step_cluster"],
                "flash_attention": seq_launches["flash_attention_wgmma"],
                "linear_recurrence": seq_launches["linear_recurrence"]}
    # the dynamic-scenario path's own counts (CONFIG full_dynamic, 5 rounds)
    scen_launches = {**scen_launches, "local_sgd_step":
                     scen_launches["local_sgd_step_cluster"]}
    kernels = []
    for name, (err, ms_k, ms_p, work) in main_cmp.items():
        b_ms, b_by = bound_ms(*work)
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCE[name], "replaces": REPLACES[name],
                        "launches": launches[name], "max_abs_err": err,
                        "ms": ms_k, "plain_ms": ms_p, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None,
                        "scenario_launches": scen_launches.get(name, 0)})
    for name, (err, ms_k, ms_p, b_ms, b_by, lib_ms) in seq_cmp.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCE[name], "replaces": REPLACES[name],
                        "launches": launches[name], "max_abs_err": err,
                        "ms": ms_k, "plain_ms": ms_p, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib_ms,
                        "scenario_launches": scen_launches.get(name, 0)})
    for name, (n_launch, (err, ms_k, ms_p, b_ms, b_by, lib_ms)) in \
            cand.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCE[name], "replaces": REPLACES[name],
                        "launches": n_launch, "max_abs_err": err,
                        "ms": ms_k, "plain_ms": ms_p, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib_ms,
                        "scenario_launches": scen_launches.get(name, 0)})
    log(f"[done] {time.perf_counter() - t_start:.1f} s; card: {card}")
    result = {"kernels": kernels}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, **result},
                                             indent=1))
    print(json.dumps(result), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

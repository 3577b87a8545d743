#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH] [--profile]

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. print the card's ``nvidia-smi`` name and power limit; TF32 off;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes (``CONFIG``) and at the reference bench scale
   (4096 clients × 32 edges), with the tolerances the tests use, and time
   both;
4. run the main path -- ``HFLSimulation(CONFIG, device="cuda")``: 5 rounds
   of fcea + PDD, then 2 rounds of gcea + fastest -- with every launch
   counter zeroed just before and read just after; check the counts, the
   metrics and the per-stage times;
5. run one round on the card and the same state and draws through the
   plain versions on the CPU, and compare;
6. with ``--profile``, profile one more steady fcea round (kernel count
   and the device's busy share);
7. print the per-kernel JSON line and, last, the device line.

It needs one CUDA device and imports nothing of the JAX reference.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

TOL = {  # the CPU tests' tolerances (tests/test_torch_kernels.py)
    "score_rows": dict(rtol=1e-5, atol=2e-4),
    "sic_rates": dict(rtol=1e-5, atol_frac=1e-6),
    "local_sgd_step": dict(rtol=2e-5, atol=2e-6),
}
SOURCE = "src/repro_torch/kernels/csrc/hfl_ops.cu"
REPLACES = {
    "score_rows": "src/repro/kernels/hfl_ops.py:78",
    "sic_rates": "src/repro/kernels/hfl_ops.py:185",
    "local_sgd_step": "src/repro/kernels/hfl_ops.py:259",
}


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


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# Kernel inputs and work counts
# ---------------------------------------------------------------------------

SCORE_OPS_PER_ROW = 9 * 7 + 27 * 3 + 201 * 12 + 2


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


def sic_work(n: int, m: int):
    return 4 * n + 3 * 4 * n * m, 2 * m * n * n + 8 * m * n


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


def compare_sic(n, m, per_edge, seed, dev, ties):
    from repro_torch.core import noma
    from repro_torch.kernels import hfl_ops
    p, g, mask = sic_inputs(n, m, per_edge, seed, dev, ties)
    kw = dict(bandwidth_hz=1e6, noise_w=noma.noise_power_w(-174.0, 1e6))
    got = hfl_ops.sic_rates(p, g, mask, **kw)
    want = hfl_ops.sic_rates_plain(p, g, mask, **kw)
    tol = TOL["sic_rates"]
    _check_close(f"sic_rates N={n} M={m}", got, want, tol["rtol"],
                 float(want.abs().max()) * tol["atol_frac"])
    ms_k = time_ms(lambda: hfl_ops.sic_rates(p, g, mask, **kw))
    ms_p = time_ms(lambda: hfl_ops.sic_rates_plain(p, g, mask, **kw))
    return _max_err(got, want), ms_k, ms_p, sic_work(n, m)


def compare_sgd(k, tau1, batch, d_in, hidden, n_classes, seed, dev):
    from repro_torch.kernels import hfl_ops
    from repro_torch.models.mlp import PARAM_KEYS
    params, bx, by = sgd_inputs(k, tau1, batch, d_in, hidden, n_classes,
                                seed, dev)
    got = hfl_ops.local_sgd_step(params, bx, by, lr=0.01)
    want = hfl_ops.local_sgd_step_plain(params, bx, by, lr=0.01)
    err = 0.0
    for name in PARAM_KEYS:
        _check_close(f"local_sgd_step {name} K={k} tau1={tau1}", got[name],
                     want[name], **TOL["local_sgd_step"])
        err = max(err, _max_err(got[name], want[name]))
    ms_k = time_ms(lambda: hfl_ops.local_sgd_step(params, bx, by, lr=0.01))
    ms_p = time_ms(lambda: hfl_ops.local_sgd_step_plain(params, bx, by,
                                                        lr=0.01))
    return err, ms_k, ms_p, sgd_work(k, tau1, batch, d_in, hidden,
                                     n_classes)


def phase_compare(cfg, dev):
    """Kernel vs plain at the CONFIG shapes (returned for the JSON line)
    and at the reference bench scale (printed)."""
    quota = cfg.clients_per_edge
    main = {
        "score_rows": compare_score(cfg.n_clients * cfg.n_edges, 1, dev),
        "sic_rates": compare_sic(cfg.n_clients, cfg.n_edges, quota, 2, dev,
                                 ties=True),
        "local_sgd_step": compare_sgd(
            quota * cfg.n_edges, cfg.tau1, cfg.local_batch, cfg.input_dim,
            cfg.hidden, cfg.n_classes, 3, dev),
    }
    bench = {
        "score_rows": compare_score(4096 * 32 + 37, 4, dev),
        "sic_rates": compare_sic(4097, 32, 0, 5, dev, ties=True),
        "local_sgd_step": compare_sgd(4 * 32, 3, 16, 32, 16, 10, 6, dev),
    }
    for label, res in (("CONFIG", main), ("bench 4096x32", bench)):
        for name, (err, ms_k, ms_p, work) in res.items():
            b_ms, b_by = bound_ms(*work)
            log(f"[compare] {label:>13} {name:<15} max_abs_err {err:.3e}  "
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
        if int(r.z.sum()) != m_c:
            raise AssertionError(f"round {r.round}: Σz = {r.z.sum()} != "
                                 f"M_c = {m_c}")


def _drive(cfg, policy, scheduler, rounds, dev):
    import torch
    from repro_torch.core.hfl import HFLSimulation
    from repro_torch.kernels import hfl_ops
    sim = HFLSimulation(cfg, seed=0, policy=policy, scheduler=scheduler,
                        device=dev)
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
    for policy, scheduler, rounds, want_score in (("fcea", "pdd", 5, 1),
                                                  ("gcea", "fastest", 2, 0)):
        sim, rows, walls, stages, launches = _drive(cfg, policy, scheduler,
                                                    rounds, dev)
        want = {"score_rows": want_score * rounds, "sic_rates": rounds,
                "local_sgd_step": cfg.tau2 * rounds}
        if launches != want:
            raise AssertionError(f"{policy}-{scheduler}: launches {launches} "
                                 f"!= expected {want}")
        _check_metrics(cfg, quota, rows, m_c)
        for r, w in zip(rows, walls):
            log(f"[main] {policy}-{scheduler} round {r.round}: {w:.4f} s  "
                f"acc {r.accuracy:.4f} loss {r.loss:.5f} cost {r.cost:.5f} "
                f"n_assoc {r.n_associated} z {r.z.tolist()} "
                f"sweeps {r.sweeps}")
        steady = walls[1:] or walls
        log(f"[main] {policy}-{scheduler}: launches {launches}; "
            f"s/round {sum(steady) / len(steady):.4f} "
            f"(rounds 2..{rounds}; round 1 {walls[0]:.4f})")
        for name, spans in stages.items():
            tail = spans[1:] or spans
            log(f"[stage] {policy}-{scheduler} {name:<9} "
                f"{sum(tail) / len(tail):.4f} ms/round "
                f"(rounds 2..{rounds}; round 1 {spans[0]:.4f})")
        runs[policy] = (sim, launches, sum(steady) / len(steady))
    return runs


def profile_round(sim, steady_s):
    """Device busy share of one steady round: the time of the CUDA kernels
    ``torch.profiler`` records, over the profiled round's wall time and
    over ``steady_s``, the unprofiled steady round time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run_round()
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
    log(f"[profile] one round: {launches} kernels, device busy "
        f"{busy_s * 1e3:.3f} ms; profiled wall {wall_s * 1e3:.3f} ms "
        f"(busy {100.0 * busy_s / wall_s:.2f}%); unprofiled steady round "
        f"{steady_s * 1e3:.3f} ms (busy {100.0 * busy_s / steady_s:.2f}%, "
        f"idle {100.0 * (1.0 - busy_s / steady_s):.2f}%)")
    for us, count, key in sorted(rows, reverse=True)[:12]:
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


def phase_card_vs_cpu(cfg, sim):
    """One round of the same state and draws on the card (kernels) and on
    the CPU (plain versions)."""
    import torch
    from repro_torch.core import engine, noma
    from repro_torch.kernels import hfl_ops
    cpu = torch.device("cpu")
    draws = engine.sample_draws(cfg, sim.bundle, sim.generator)
    state, bundle = sim.state, sim.bundle
    s_gpu, m_gpu = engine.round_step(cfg, sim.spec, state, bundle, draws)
    s_cpu, m_cpu = engine.round_step(cfg, sim.spec, _to(state, cpu),
                                     _to(bundle, cpu), _to(draws, cpu))
    g, c = engine.metrics_row(m_gpu), engine.metrics_row(m_cpu)
    log(f"[card-vs-cpu] card {g}")
    log(f"[card-vs-cpu] cpu  {c}")
    exact_ok = (g["z"].tolist() == c["z"].tolist()
                and g["n_associated"] == c["n_associated"]
                and torch.equal(s_gpu.staleness.cpu(), s_cpu.staleness))
    if not exact_ok:
        # print the competing scores: a gap below the score tolerance is a
        # near-tie (reported, and still a failure)
        gains = noma.evolve_gains(
            draws.fading, state.gains, bundle.dist,
            path_loss_exponent=cfg.path_loss_exponent,
            rho=sim.spec.fading_rho)
        sc_g = hfl_ops.score_matrix(gains, bundle.counts, state.staleness,
                                    data_max=float(cfg.max_samples)).cpu()
        sc_c = hfl_ops.score_matrix(_to(gains, cpu), _to(bundle.counts, cpu),
                                    _to(state.staleness, cpu),
                                    data_max=float(cfg.max_samples))
        diff = (sc_g - sc_c).abs()
        srt = torch.sort(sc_c, dim=0, descending=True).values
        gaps = (srt[:-1] - srt[1:]).abs()
        log(f"[card-vs-cpu] score max |card - cpu| {float(diff.max()):.3e}; "
            f"smallest per-edge adjacent score gap "
            f"{float(gaps[gaps > 0].min()):.3e}; near-tie if below 2e-4")
        raise AssertionError("card and CPU rounds disagree on z, "
                             "n_associated or staleness")
    for key, rtol in (("cost", 1e-5), ("total_time_s", 1e-5),
                      ("total_energy_j", 1e-5), ("loss", 1e-4)):
        if not math.isclose(g[key], c[key], rel_tol=rtol):
            raise AssertionError(f"card-vs-cpu {key}: {g[key]} vs {c[key]} "
                                 f"(rtol {rtol})")
    if abs(g["accuracy"] - c["accuracy"]) > 2.0 / bundle.test_y.shape[0]:
        raise AssertionError(f"card-vs-cpu accuracy: {g['accuracy']} vs "
                             f"{c['accuracy']}")
    log("[card-vs-cpu] z, n_associated, staleness exact; cost/time/energy "
        "rtol 1e-5, loss rtol 1e-4, accuracy atol 2/T: ok")


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

    phase_build()
    main_cmp = phase_compare(CONFIG, dev)
    runs = phase_main_path(CONFIG, dev)
    phase_card_vs_cpu(CONFIG, runs["fcea"][0])
    if args.profile:
        profile_round(runs["fcea"][0], runs["fcea"][2])

    launches = runs["fcea"][1]
    kernels = []
    for name, (err, ms_k, ms_p, work) in main_cmp.items():
        b_ms, b_by = bound_ms(*work)
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name],
                        "launches": launches[name], "max_abs_err": err,
                        "ms": ms_k, "plain_ms": ms_p, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None})
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

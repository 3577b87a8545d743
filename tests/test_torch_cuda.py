"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the reference package, so it also runs on a GPU
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.hfl_mnist import CONFIG
from repro_torch.core import candidates, engine, fuzzy, noma
from repro_torch.kernels import _build, hfl_ops, seq_ops
from repro_torch.models.mlp import PARAM_KEYS

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.tensor(a, device=dev) for a in arrays]


@pytest.mark.parametrize("rows", [1, 256, 4096 * 32 + 37])
def test_score_kernel_bit_equal_to_plain(cuda, rows):
    rng = np.random.default_rng(rows)
    v = rng.uniform(0.0, 100.0, (3, rows)).astype(np.float32)
    v[:, ::7] = np.round(v[:, ::7] / 25.0) * 25.0       # set breakpoints
    cq, dq, ms = _on(cuda, *v)
    before = hfl_ops.LAUNCHES["score_rows"]
    got = hfl_ops.score_rows(cq, dq, ms)
    assert hfl_ops.LAUNCHES["score_rows"] == before + 1
    torch.testing.assert_close(got, hfl_ops.score_rows_plain(cq, dq, ms),
                               rtol=0.0, atol=0.0)


def _edge_gains(rng, n, m):
    """Exact dB ties across clients, values under the 1e-30 clamp, zeros."""
    g = rng.uniform(1e-12, 1e-8, (n, m)).astype(np.float32)
    g[::5] = g[0]
    g[1::7, 0] = 1e-35
    g[2::11, -1] = 0.0
    return g


def _one_score_call(counter):
    """Assert that the wrapped call made one ``counter`` launch and launched
    the rows-only kernel no time."""
    before = dict(hfl_ops.LAUNCHES)

    def check():
        torch.cuda.synchronize()
        assert hfl_ops.LAUNCHES[counter] == before[counter] + 1
        assert hfl_ops.LAUNCHES["score_rows"] == before["score_rows"]
    return check


# the fused dense score: CONFIG, the bench field, and edge gains (exact dB
# ties, values under 1e-30, zeros) with all-zero staleness, whose max
# clamps to 1
@pytest.mark.parametrize("n,m,edge", [(64, 4, False), (4096, 32, False),
                                      (64, 4, True), (1001, 7, True)])
def test_score_matrix_fused_bit_equal_to_plain(cuda, n, m, edge):
    rng = np.random.default_rng(n + m + edge)
    g = _edge_gains(rng, n, m) if edge \
        else rng.uniform(1e-12, 1e-8, (n, m)).astype(np.float32)
    stale = np.zeros(n, np.int32) if edge \
        else rng.integers(1, 9, n).astype(np.int32)
    gains, counts, st = _on(cuda, g,
                            rng.integers(60, 1200, n).astype(np.float32),
                            stale)
    check = _one_score_call("score_matrix")
    got = hfl_ops.score_matrix(gains, counts, st, data_max=1200.0)
    check()
    want = fuzzy.score_matrix(gains, counts, st, data_max=1200.0,
                              rows=hfl_ops.score_rows_plain)
    assert got.shape == (n, m)
    torch.testing.assert_close(got, want, rtol=0.0, atol=0.0)


def test_score_fused_rejects_casts_it_would_need(cuda):
    """The fused score takes the engine's dtypes as they are: no host cast
    of the staleness (int32) or the gains (float32)."""
    gains = torch.ones((8, 2), device=cuda)
    counts = torch.ones(8, device=cuda)
    with pytest.raises(TypeError, match="staleness"):
        hfl_ops.score_matrix(gains, counts, torch.ones(8, device=cuda),
                             data_max=1.0)
    with pytest.raises(TypeError, match="gains"):
        hfl_ops.score_matrix(gains.double(), counts,
                             torch.ones(8, dtype=torch.int32, device=cuda),
                             data_max=1.0)


@pytest.mark.parametrize("n,m,dense", [(12, 3, True), (64, 4, False),
                                       (4097, 32, True)])
def test_sic_kernel_matches_plain(cuda, n, m, dense):
    rng = np.random.default_rng(n + m)
    p = rng.uniform(0.01, 0.1, n).astype(np.float32)
    g = (rng.uniform(0.1, 10.0, (n, m)) * 1e-9).astype(np.float32)
    p[1::3], g[1::3] = p[0::3][:len(p[1::3])], g[0::3][:len(g[1::3])]
    mask = rng.random((n, m)) < (0.5 if dense else 0.1)
    pt, gt, mt = _on(cuda, p, g, mask)
    kw = dict(bandwidth_hz=1e6, noise_w=noma.noise_power_w(-174.0, 1e6))
    got = hfl_ops.sic_rates(pt, gt, mt, **kw)
    want = hfl_ops.sic_rates_plain(pt, gt, mt, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=float(want.max()) * 1e-6)
    assert bool((got[~mt] == 0.0).all())


def _sic_case(rng, n, m, kind):
    """(N,) power, (N, M) gains with exact ties (every third client repeats
    the one before it), and a mask: the engine's one-hot association (at
    most 4 clients an edge, the last edge without a client where M > 1),
    all true, all false, or 50% at random."""
    p = rng.uniform(0.01, 0.1, n).astype(np.float32)
    g = (rng.uniform(0.1, 10.0, (n, m)) * 1e-9).astype(np.float32)
    p[1::3], g[1::3] = p[0::3][:len(p[1::3])], g[0::3][:len(g[1::3])]
    if kind == "one-hot":
        owner = rng.integers(0, max(m - 1, 1), n)
        mask = np.zeros((n, m), bool)
        for e in range(max(m - 1, 1)):
            mask[np.flatnonzero(owner == e)[:4], e] = True
    elif kind == "random":
        mask = rng.random((n, m)) < 0.5
    else:
        mask = np.full((n, m), kind == "all")
    return p, g, mask


# every cluster size at each shape: N of one client, below and at one
# CONFIG, and the ragged bench N; one edge, CONFIG's 4 and the bench's 32
@pytest.mark.parametrize("kind", ["one-hot", "all", "none", "random"])
@pytest.mark.parametrize("m", [1, 4, 32])
@pytest.mark.parametrize("n", [1, 63, 64, 4097])
def test_sic_kernel_every_cluster_size(cuda, n, m, kind):
    rng = np.random.default_rng(n * 7 + m)
    pt, gt, mt = _on(cuda, *_sic_case(rng, n, m, kind))
    kw = dict(bandwidth_hz=1e6, noise_w=noma.noise_power_w(-174.0, 1e6))
    want = hfl_ops.sic_rates_plain(pt, gt, mt, **kw)
    outs = []
    for c in hfl_ops.SIC_CLUSTER_SIZES:
        before = hfl_ops.LAUNCHES["sic_rates"]
        got = hfl_ops._sic_launch(pt, gt, mt, c, **kw)
        torch.cuda.synchronize()
        assert hfl_ops.LAUNCHES["sic_rates"] == before + 1
        assert got.shape == (n, m) and got.is_contiguous()
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=float(want.max()) * 1e-6,
                                   msg=f"cluster {c}")
        assert bool((got[~mt] == 0.0).all())
        outs.append(got)
    # the sums run over the same list in the same order at every size
    for got in outs[1:]:
        assert torch.equal(got, outs[0])


def test_sic_kernel_exact_tie_order(cuda):
    """Equal received powers: the lower client index decodes first, so it
    still hears its equal-power twin and rates strictly lower."""
    pt, gt, mt = _on(cuda, np.asarray([0.1, 0.1, 0.1], np.float32),
                     np.asarray([[1e-9], [1e-9], [2e-9]], np.float32),
                     np.ones((3, 1), bool))
    kw = dict(bandwidth_hz=1e6, noise_w=noma.noise_power_w(-174.0, 1e6))
    want = hfl_ops.sic_rates_plain(pt, gt, mt, **kw)
    for c in hfl_ops.SIC_CLUSTER_SIZES:
        got = hfl_ops._sic_launch(pt, gt, mt, c, **kw)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
        assert float(got[0, 0]) < float(got[1, 0])


def test_sic_kernel_takes_the_callers_tensors(cuda):
    """No cast, transpose or copy: a float mask, a float64 power and a
    non-contiguous gains view are refused, and an N beyond what any
    cluster holds raises."""
    n, m = 8, 2
    p = torch.ones(n, device=cuda)
    g = torch.ones((n, m), device=cuda)
    mask = torch.ones((n, m), dtype=torch.bool, device=cuda)
    kw = dict(bandwidth_hz=1e6, noise_w=1e-12)
    with pytest.raises(TypeError, match="mask"):
        hfl_ops.sic_rates(p, g, mask.float(), **kw)
    with pytest.raises(TypeError, match="power_w"):
        hfl_ops.sic_rates(p.double(), g, mask, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        hfl_ops.sic_rates(p, torch.ones((m, n), device=cuda).t(), mask, **kw)
    with pytest.raises(ValueError, match="cluster"):
        hfl_ops._sic_launch(p, g, mask, 3, **kw)
    big = hfl_ops.SIC_CLUSTER_SIZES[-1] * (
        (hfl_ops.MAX_SMEM_BYTES - hfl_ops.SIC_STATIC_SMEM_BYTES) // 8) + 1
    assert hfl_ops.sic_cluster_size(big) == 0
    with pytest.raises(ValueError, match="cluster"):
        hfl_ops.sic_rates(torch.ones(big, device=cuda),
                          torch.ones((big, 1), device=cuda),
                          torch.ones((big, 1), dtype=torch.bool, device=cuda),
                          **kw)


def test_raw_stream_handle_is_the_current_stream(cuda):
    """``_build.stream`` (a private torch binding) gives the handle of
    ``torch.cuda.current_stream`` on the default stream and a side one."""
    def handle(d):
        return _build.stream(d).value or 0
    devices = (cuda, torch.device("cuda", torch.cuda.current_device()))
    for d in devices:
        assert handle(d) == torch.cuda.current_stream(cuda).cuda_stream
    side = torch.cuda.Stream(device=cuda)
    with torch.cuda.stream(side):
        for d in devices:
            assert handle(d) == side.cuda_stream != 0
            assert handle(d) == torch.cuda.current_stream(cuda).cuda_stream


# N whose slice needs more dynamic shared memory than a launch gets without
# opting in (48 KB less the static part), yet no more than 48 KB: 45,000 at
# the 8 CTAs ``sic_cluster_size`` gives it, 5,500 at one CTA
@pytest.mark.parametrize("n,c", [(45_000, 8), (5_500, 1)])
def test_sic_kernel_opts_in_to_its_shared_memory(cuda, n, c):
    assert 48 * 1024 - hfl_ops.SIC_STATIC_SMEM_BYTES \
        < hfl_ops.sic_smem_bytes(n, c) <= 48 * 1024
    assert n < 40_000 or hfl_ops.sic_cluster_size(n) == c
    rng = np.random.default_rng(n)
    pt, gt, mt = _on(cuda, *_sic_case(rng, n, 2, "one-hot"))
    kw = dict(bandwidth_hz=1e6, noise_w=noma.noise_power_w(-174.0, 1e6))
    got = hfl_ops._sic_launch(pt, gt, mt, c, **kw)
    # the plain version over each edge's masked clients alone: every other
    # client's term is an exact zero
    want = torch.zeros_like(gt)
    for e in range(gt.shape[1]):
        idx = torch.nonzero(mt[:, e])[:, 0]
        if idx.numel():
            want[idx, e] = hfl_ops.sic_rates_plain(
                pt[idx], gt[idx, e:e + 1], mt[idx, e:e + 1], **kw)[:, 0]
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=float(want.max()) * 1e-6)
    assert int(mt.sum()) > 0 and bool((got[~mt] == 0.0).all())


# the candidate frontier's rows: the reference bench scale at K = 4 and
# K = 8, a ragged N·K, and N = 4095 at K = 3
@pytest.mark.parametrize("n,m,k", [(4096, 32, 4), (4096, 32, 8),
                                   (1001, 7, 3), (4095, 32, 3)])
def test_score_candidates_kernel_bit_equal_to_plain(cuda, n, m, k):
    rng = np.random.default_rng(n + k)
    gains, counts, stale, dist = _on(
        cuda, rng.uniform(1e-12, 1e-8, (n, m)).astype(np.float32),
        rng.integers(60, 120, n).astype(np.float32),
        rng.integers(1, 9, n).astype(np.int32),
        rng.uniform(10.0, 400.0, (n, m)).astype(np.float32))
    cand = candidates.build_candidates(dist, k, coverage_radius_m=300.0)
    check = _one_score_call("score_candidates")
    got = hfl_ops.score_candidates(gains, cand.idx, counts, stale,
                                   data_max=120.0)
    check()
    want = fuzzy.score_candidates(gains, cand, counts, stale, data_max=120.0,
                                  rows=hfl_ops.score_rows_plain)
    assert got.shape == (n, k)
    torch.testing.assert_close(got, want, rtol=0.0, atol=0.0)


# a fleet's fused score: seeds whose gain ranges (orders of magnitude
# apart) and staleness differ, dense at CONFIG (S = 8, and S = 1 against
# the single-seed call), on the bench frontier (K = 8, S = 4) and ragged
@pytest.mark.parametrize("n,m,k,seeds", [(64, 4, None, 8), (64, 4, None, 1),
                                         (4096, 32, 8, 4), (1001, 7, 3, 3),
                                         (1001, 7, None, 3)])
def test_score_fleet_equals_each_seeds_call(cuda, n, m, k, seeds):
    rng = np.random.default_rng(n + seeds)
    scale = 10.0 ** rng.integers(-6, 7, seeds).astype(np.float32)
    g = (rng.uniform(1e-12, 1e-8, (seeds, n, m))
         * scale[:, None, None]).astype(np.float32)
    stale = (rng.integers(1, 9, (seeds, n))
             * (1 + np.arange(seeds))[:, None]).astype(np.int32)
    gains, counts, st, dist = _on(
        cuda, g, rng.integers(60, 121, (seeds, n)).astype(np.float32), stale,
        rng.uniform(10.0, 400.0, (seeds, n, m)).astype(np.float32))
    if k is None:
        call = lambda *a: hfl_ops.score_matrix(*a, data_max=120.0)
        args = (gains, counts, st)
        check = _one_score_call("score_matrix")
    else:
        idx = candidates.build_candidates(dist, k,
                                          coverage_radius_m=300.0).idx
        call = lambda g_, i_, c_, s_: hfl_ops.score_candidates(
            g_, i_, c_, s_, data_max=120.0)
        args = (gains, idx, counts, st)
        check = _one_score_call("score_candidates")
    got = call(*args)
    check()
    assert got.shape == (seeds, n, k or m)
    for s in range(seeds):
        assert torch.equal(got[s], call(*(a[s] for a in args))), s
    if k is None:
        want = fuzzy.score_matrix(gains, counts, st, data_max=120.0,
                                  rows=hfl_ops.score_rows_plain)
        assert torch.equal(got, want)


# a fleet's SIC at every cluster size: CONFIG at S = 8, the ragged bench N
# at S = 8, and 300 seeds of 63 clients over 32 edges -- at 8 CTAs an edge,
# 76,800 CTAs, many waves of the card
@pytest.mark.parametrize("n,m,seeds", [(64, 4, 8), (4097, 32, 8),
                                       (63, 32, 300)])
def test_sic_fleet_equals_each_seeds_call(cuda, n, m, seeds):
    rng = np.random.default_rng(n * 3 + seeds)
    kinds = ("one-hot", "random", "all", "none")
    cases = [_sic_case(rng, n, m, kinds[s % len(kinds)])
             for s in range(seeds)]
    pt, gt, mt = _on(cuda, *(np.stack(f) for f in zip(*cases)))
    kw = dict(bandwidth_hz=1e6, noise_w=noma.noise_power_w(-174.0, 1e6))
    before = hfl_ops.LAUNCHES["sic_rates"]
    got = hfl_ops.sic_rates(pt, gt, mt, **kw)
    torch.cuda.synchronize()
    assert hfl_ops.LAUNCHES["sic_rates"] == before + 1
    assert got.shape == (seeds, n, m)
    for c in hfl_ops.SIC_CLUSTER_SIZES:
        fleet = got if c == hfl_ops.sic_cluster_size(n) \
            else hfl_ops._sic_launch(pt, gt, mt, c, **kw)
        for s in range(seeds):
            assert torch.equal(fleet[s], hfl_ops._sic_launch(
                pt[s], gt[s], mt[s], c, **kw)), (c, s)
    if seeds <= 8:
        want = hfl_ops.sic_rates_plain(pt, gt, mt, **kw)
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=float(want.max()) * 1e-6)


def _to(obj, dev):
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {k: _to(v, dev) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to(v, dev) for v in obj))
    return obj


def test_candidate_round_card_matches_cpu(cuda):
    """One ``CONFIG`` round on the K = 2 frontier on the card (kernels)
    and from the same state and draws on the CPU (plain versions):
    integers exact, the bill to rtol 1e-5, the loss to rtol 1e-4."""
    cfg = CONFIG
    spec = engine.EngineSpec(candidates_k=2)
    state, bundle, aux = engine.init_simulation(cfg, seed=0, device=cuda)
    draws = engine.sample_draws(cfg, bundle, aux["generator"], spec)
    before = dict(hfl_ops.LAUNCHES)
    s_card, m_card = engine.round_step(cfg, spec, state, bundle, draws)
    torch.cuda.synchronize()
    assert hfl_ops.LAUNCHES["score_candidates"] == \
        before["score_candidates"] + 1
    assert hfl_ops.LAUNCHES["score_rows"] == before["score_rows"]
    assert hfl_ops.LAUNCHES["sic_rates"] == before["sic_rates"]
    cpu = torch.device("cpu")
    s_cpu, m_cpu = engine.round_step(cfg, spec, _to(state, cpu),
                                     _to(bundle, cpu), _to(draws, cpu))
    g, c = engine.metrics_row(m_card), engine.metrics_row(m_cpu)
    assert g["z"].tolist() == c["z"].tolist()
    assert (g["n_associated"], g["sweeps"]) == (c["n_associated"],
                                                c["sweeps"])
    assert torch.equal(s_card.staleness.cpu(), s_cpu.staleness)
    for key in ("cost", "total_time_s", "total_energy_j"):
        assert g[key] == pytest.approx(c[key], rel=1e-5), key
    assert g["loss"] == pytest.approx(c["loss"], rel=1e-4)


def test_config_fleet_round_card_matches_cpu(cuda):
    """One ``CONFIG`` round of a fleet of two seeds on the card (one fused
    score call, one SIC call, τ₂ SGD launches) and from the same states and
    draws on the CPU: integers exact, the bill to rtol 1e-5, the loss to
    rtol 1e-4, the accuracy to 2 test samples, for each seed."""
    cfg, spec = CONFIG, engine.EngineSpec()
    pairs, gens = [], []
    for s in (0, 1):
        state, bundle, aux = engine.init_simulation(cfg, seed=s, device=cuda)
        pairs.append((state, bundle))
        gens.append(aux["generator"])
    states, bundles = engine.stack_fleet(pairs)
    draws = engine.fleet_draws(cfg, bundles, gens, spec)
    before = dict(hfl_ops.LAUNCHES)
    s_card, m_card = engine.fleet_step(cfg, spec, states, bundles, draws)
    torch.cuda.synchronize()
    grew = {k: hfl_ops.LAUNCHES[k] - before[k] for k in before}
    assert (grew["score_matrix"], grew["sic_rates"], grew["local_sgd_step"],
            grew["score_rows"]) == (1, 1, cfg.tau2, 0)
    cpu = torch.device("cpu")
    s_cpu, m_cpu = engine.fleet_step(cfg, spec, _to(states, cpu),
                                     _to(bundles, cpu), _to(draws, cpu))
    assert torch.equal(m_card.z.cpu(), m_cpu.z)
    assert torch.equal(m_card.n_associated.cpu(), m_cpu.n_associated)
    assert torch.equal(m_card.sweeps, m_cpu.sweeps)
    assert torch.equal(s_card.staleness.cpu(), s_cpu.staleness)
    for key in ("cost", "total_time_s", "total_energy_j"):
        torch.testing.assert_close(getattr(m_card, key).cpu(),
                                   getattr(m_cpu, key), rtol=1e-5, atol=0.0)
    torch.testing.assert_close(m_card.loss.cpu(), m_cpu.loss, rtol=1e-4,
                               atol=0.0)
    n_test = bundles.test_y.shape[1]
    assert float((m_card.accuracy.cpu() - m_cpu.accuracy).abs().max()) \
        <= 2.0 / n_test


# the fpa/fca grid's SIC call: G = 16 power rows of each of S seeds folded
# onto the leading axis (S·16), one-hot masks, one seed with every client
# dropped (an all-false mask)
@pytest.mark.parametrize("seeds", [1, 3])
def test_sic_grid_lead_axis_matches_plain(cuda, seeds):
    rng = np.random.default_rng(16 + seeds)
    n, m, grid = 64, 4, 16
    cases = [_sic_case(rng, n, m, "one-hot") for _ in range(seeds)]
    if seeds > 1:
        cases[-1] = (cases[-1][0], cases[-1][1], np.zeros((n, m), bool))
    frac = np.arange(grid, dtype=np.float32)[:, None, None] / 15.0
    p = np.stack([c[0] for c in cases])[None] * (0.1 + frac)   # (G, S, N)
    g = np.broadcast_to(np.stack([c[1] for c in cases])[None],
                        (grid, seeds, n, m))
    mask = np.broadcast_to(np.stack([c[2] for c in cases])[None],
                           (grid, seeds, n, m))
    pt, gt, mt = _on(cuda, p.reshape(-1, n).astype(np.float32),
                     np.ascontiguousarray(g).reshape(-1, n, m),
                     np.ascontiguousarray(mask).reshape(-1, n, m))
    kw = dict(bandwidth_hz=1e6, noise_w=noma.noise_power_w(-174.0, 1e6))
    before = hfl_ops.LAUNCHES["sic_rates"]
    got = hfl_ops.sic_rates(pt, gt, mt, **kw)
    torch.cuda.synchronize()
    assert hfl_ops.LAUNCHES["sic_rates"] == before + 1
    want = hfl_ops.sic_rates_plain(pt, gt, mt, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=float(want.max()) * 1e-6)
    for row in range(grid * seeds):
        assert torch.equal(got[row], hfl_ops.sic_rates(pt[row], gt[row],
                                                       mt[row], **kw)), row
    if seeds > 1:
        dropped = got.reshape(grid, seeds, n, m)[:, -1]
        assert torch.equal(dropped, torch.zeros_like(dropped))


@pytest.mark.parametrize("scenario,kw,sic_calls", [
    ("full_dynamic", dict(), 1),
    ("hetero_devices", dict(allocator="fca"), 2),
    ("hetero_devices", dict(allocator="fpa", candidates_k=2), 1)])
def test_scenario_round_card_matches_cpu(cuda, scenario, kw, sic_calls):
    """One dynamic ``CONFIG`` round of fcea + PDD on the card and from the
    same state and draws on the CPU: the availability, n_available and the
    decisions exact, the moved positions and distances to rtol 1e-6 above
    a floor of 1e-6 of the area's side (the card's norm rounds the
    waypoint step an ulp apart, which is more than 1e-6 of a short
    distance), the bill to rtol 1e-5, the loss to rtol 1e-4; the fpa/fca
    grid's SIC call is one more launch."""
    cfg = CONFIG
    spec = engine.EngineSpec(scenario="dynamic", **kw)
    state, bundle, aux = engine.init_simulation(cfg, seed=0, device=cuda,
                                                scenario=scenario)
    draws = engine.sample_draws(cfg, bundle, aux["generator"], spec)
    before = dict(hfl_ops.LAUNCHES)
    s_card, m_card = engine.round_step(cfg, spec, state, bundle, draws)
    torch.cuda.synchronize()
    grew = {k: hfl_ops.LAUNCHES[k] - before[k] for k in before}
    dense = spec.candidates_k is None
    assert (grew["score_matrix"], grew["score_candidates"],
            grew["sic_rates"], grew["local_sgd_step"]) == \
        (int(dense), int(not dense), sic_calls, cfg.tau2)
    cpu = torch.device("cpu")
    s_cpu, m_cpu = engine.round_step(cfg, spec, _to(state, cpu),
                                     _to(bundle, cpu), _to(draws, cpu))
    g, c = engine.metrics_row(m_card), engine.metrics_row(m_cpu)
    assert g["z"].tolist() == c["z"].tolist()
    for key in ("n_available", "n_associated", "sweeps"):
        assert g[key] == c[key], key
    assert torch.equal(s_card.staleness.cpu(), s_cpu.staleness)
    for field in s_cpu.scenario._fields:
        got, want = getattr(s_card.scenario, field).cpu(), \
            getattr(s_cpu.scenario, field)
        if field in ("pos", "waypoint", "dist"):
            torch.testing.assert_close(got, want, rtol=1e-6,
                                       atol=1e-6 * cfg.area_side_m)
        else:
            assert torch.equal(got, want), field
    for key in ("cost", "total_time_s", "total_energy_j"):
        assert g[key] == pytest.approx(c[key], rel=1e-5), key
    assert g["loss"] == pytest.approx(c["loss"], rel=1e-4)


def test_all_dropped_round_on_the_card(cuda):
    """Every client dropped: the SIC kernel sees an all-false mask, every
    SGD lane is a pad lane, PDD's edges carry only the cloud hop; the
    global model rides through bit for bit and the bill is finite."""
    from repro_torch import scenarios
    cfg = CONFIG
    spec = engine.EngineSpec(policy="gcea", scheduler="fastest",
                             scenario="dynamic")
    state, bundle, aux = engine.init_simulation(
        cfg, seed=0, device=cuda, scenario=scenarios.ScenarioSpec(
            kind="markov_dropout", p_drop=1.0, p_return=0.0))
    draws = engine.sample_draws(cfg, bundle, aux["generator"], spec)
    s1, m = engine.round_step(cfg, spec, state, bundle, draws)
    assert int(m.n_available) == 0 and int(m.n_associated) == 0
    for k, v in state.global_params.items():
        assert torch.equal(s1.global_params[k], v), k
    assert np.isfinite(float(m.cost))


def _sgd_case(k, tau1, batch, d_in, hidden, dev, n_classes=10, scale=None):
    """Weights 0.3·N(0, 1), or ``scale``/√fan-in for the matrices."""
    rng = np.random.default_rng(k + d_in)
    shapes = {"w1": (k, d_in, hidden), "b1": (k, hidden),
              "w2": (k, hidden, hidden), "b2": (k, hidden),
              "w3": (k, hidden, n_classes), "b3": (k, n_classes)}
    params = {n: torch.tensor(
        ((0.3 if scale is None or len(s) == 2 else scale / np.sqrt(s[1]))
         * rng.normal(size=s)).astype(np.float32), device=dev)
        for n, s in shapes.items()}
    bx, by = _on(dev, rng.uniform(0, 1, (tau1, k, batch, d_in))
                 .astype(np.float32),
                 rng.integers(0, n_classes, (tau1, k, batch)).astype(np.int32))
    return params, bx, by


# (K, τ₁, B, D, H) and the cluster size the wrapper gives it: the paper
# config, the reference bench shape, every cluster size, K = 1, τ₁ = 4, D,
# B, H not multiples of the kernel's 4 x 4 thread tile, D not a multiple of
# c (the last CTA's rows of W1 ragged) and D = 7 over 8 CTAs (one without
# rows)
@pytest.mark.parametrize("k,tau1,batch,d_in,hidden,cluster", [
    (16, 1, 32, 784, 128, 8), (128, 3, 16, 32, 16, 1), (3, 2, 5, 7, 6, 2),
    (2, 2, 6, 30, 12, 4), (1, 4, 8, 30, 16, 8), (1, 1, 32, 783, 128, 8),
    (40, 2, 9, 50, 20, 2), (1, 2, 4, 7, 16, 8)])
def test_sgd_kernel_matches_plain(cuda, k, tau1, batch, d_in, hidden,
                                  cluster):
    assert hfl_ops.sgd_cluster_size(k, batch, d_in, hidden, 10) == cluster
    params, bx, by = _sgd_case(k, tau1, batch, d_in, hidden, cuda)
    before = {n: v.clone() for n, v in params.items()}
    launches = dict(hfl_ops.LAUNCHES)
    got = hfl_ops.local_sgd_step(params, bx, by, lr=0.05)
    torch.cuda.synchronize()
    assert hfl_ops.LAUNCHES["local_sgd_step_cluster"] == \
        launches["local_sgd_step_cluster"] + 1
    want = hfl_ops.local_sgd_step_plain(params, bx, by, lr=0.05)
    for name in PARAM_KEYS:
        torch.testing.assert_close(got[name], want[name], rtol=2e-5,
                                   atol=2e-6, msg=name)
        assert torch.equal(params[name], before[name])


def test_sgd_block_kernel_takes_layers_too_wide_for_a_cluster(cuda):
    """A 70,000-wide input: W1's slice does not fit a CTA at any cluster
    size, so the block-per-lane kernel runs it.  Weights at the usual
    1/√fan-in init: at 0.3·N(0, 1) the 70,000-long sums reach ~50 and the
    two summation orders part by more than the tolerance's 2e-6."""
    k, tau1, batch, d_in, hidden = 1, 1, 4, 70_000, 8
    assert hfl_ops.sgd_route(k, batch, d_in, hidden, 10) == "hfl_local_sgd"
    params, bx, by = _sgd_case(k, tau1, batch, d_in, hidden, cuda, scale=1.0)
    launches = dict(hfl_ops.LAUNCHES)
    got = hfl_ops.local_sgd_step(params, bx, by, lr=0.05)
    torch.cuda.synchronize()
    assert hfl_ops.LAUNCHES["local_sgd_step"] == \
        launches["local_sgd_step"] + 1
    assert hfl_ops.LAUNCHES["local_sgd_step_cluster"] == \
        launches["local_sgd_step_cluster"]
    want = hfl_ops.local_sgd_step_plain(params, bx, by, lr=0.05)
    for name in PARAM_KEYS:
        torch.testing.assert_close(got[name], want[name], rtol=2e-5,
                                   atol=2e-6, msg=name)


def test_sgd_kernel_rejects_oversized_blocks(cuda):
    """B = 128, H = 256: relu(h1) and relu(h2) alone (2 × B × H fp32) pass
    the shared memory of a CTA at every cluster size, and the block kernel's
    four B × H buffers too."""
    k, batch, hidden = 1, 128, 256
    params = {"w1": torch.zeros((k, 8, hidden), device=cuda),
              "b1": torch.zeros((k, hidden), device=cuda),
              "w2": torch.zeros((k, hidden, hidden), device=cuda),
              "b2": torch.zeros((k, hidden), device=cuda),
              "w3": torch.zeros((k, hidden, 10), device=cuda),
              "b3": torch.zeros((k, 10), device=cuda)}
    bx = torch.zeros((1, k, batch, 8), device=cuda)
    by = torch.zeros((1, k, batch), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        hfl_ops.local_sgd_step(params, bx, by, lr=0.1)


# -- the substrate's sequence kernels ------------------------------------------

# float32: the kernel and the plain einsum sum in other orders.  bfloat16
# inputs: the kernel computes in float32 and rounds only its output, so it
# is held to the plain version in float32 rounded to bfloat16 once -- one
# bf16 ulp (2^-7 relative at most) apart where the two float32 results
# straddle a rounding boundary.
FLASH_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
             torch.bfloat16: dict(atol=1e-3, rtol=8e-3)}


@pytest.mark.parametrize("b,s,h,kv,d,causal,window,dtype", [
    (1, 128, 2, 2, 32, True, 0, torch.float32),
    (2, 200, 4, 2, 64, True, 16, torch.float32),      # ragged S, tiny window
    (1, 1000, 4, 1, 64, True, 300, torch.float32),    # ragged S
    (2, 256, 16, 1, 256, True, 128, torch.bfloat16),  # MQA, D = 256
    (1, 190, 4, 1, 256, False, 0, torch.bfloat16),    # non-causal, ragged
    (1, 130, 2, 1, 256, False, 40, torch.float32),    # non-causal window
])
def test_flash_kernel_matches_plain(cuda, b, s, h, kv, d, causal, window,
                                    dtype):
    rng = np.random.default_rng(s + d)
    q, k, v = (torch.tensor(rng.normal(size=(b, s, n, d)).astype(np.float32),
                            device=cuda).to(dtype) for n in (h, kv, kv))
    before = seq_ops.LAUNCHES["flash_attention"]
    got = seq_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert seq_ops.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = seq_ops.attention_plain(q.float(), k.float(), v.float(),
                                   causal=causal, window=window).to(dtype)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


# The tensor-core kernel (csrc/flash_wgmma.cu: 128 query rows a block in two
# warpgroups of 64, 64 keys a K/V tile) at its edges, bf16, held like the
# bf16 cases above: it feeds P to its second product as two bf16 terms
# (exact to 2^-17), so it too computes in float32 and rounds only its
# output.
WGMMA_EDGES = [
    (1, 100, 4, 1, 256, True, 0),        # S below one q-tile
    (1, 64, 2, 1, 64, True, 0),          # S of exactly one K/V tile
    (1, 1000, 16, 1, 256, True, 300),    # S and window not multiples of 64
    (2, 300, 4, 2, 128, True, 40),       # window below one tile, group 2
    (1, 200, 4, 4, 64, True, 0),         # MHA (group 1), D = 64
    (1, 333, 4, 2, 128, False, 100),     # non-causal with a window
    (2, 512, 16, 1, 256, False, 0),      # non-causal, MQA (group 16)
]


@pytest.mark.parametrize("b,s,h,kv,d,causal,window", WGMMA_EDGES)
def test_flash_wgmma_kernel_matches_plain(cuda, b, s, h, kv, d, causal,
                                          window):
    rng = np.random.default_rng(s + d + window)
    q, k, v = (torch.tensor(rng.normal(size=(b, s, n, d)).astype(np.float32),
                            device=cuda).to(torch.bfloat16) for n in (h, kv, kv))
    before = dict(seq_ops.LAUNCHES)
    got = seq_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert seq_ops.LAUNCHES["flash_attention_wgmma"] == \
        before["flash_attention_wgmma"] + 1
    assert seq_ops.LAUNCHES["flash_attention"] == \
        before["flash_attention"] + 1
    want = seq_ops.attention_plain(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.to(torch.bfloat16).float(),
                               **FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("d,dtype", [(256, torch.float32),
                                     (80, torch.bfloat16)])
def test_flash_other_dtypes_and_dims_keep_the_cuda_core_kernel(cuda, d,
                                                               dtype):
    rng = np.random.default_rng(d)
    q, k, v = (torch.tensor(rng.normal(size=(1, 130, 2, d)).astype(np.float32),
                            device=cuda).to(dtype) for _ in range(3))
    before = dict(seq_ops.LAUNCHES)
    got = seq_ops.flash_attention(q, k, v, causal=True, window=50)
    torch.cuda.synchronize()
    assert seq_ops.LAUNCHES["flash_attention_wgmma"] == \
        before["flash_attention_wgmma"]
    assert seq_ops.LAUNCHES["flash_attention"] == \
        before["flash_attention"] + 1
    want = seq_ops.attention_plain(q.float(), k.float(), v.float(),
                                   causal=True, window=50).to(dtype)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


def test_flash_kernel_rejects_unsupported_head_dims(cuda):
    q = torch.zeros((1, 8, 2, 24), device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        seq_ops.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 272), device=cuda)
    with pytest.raises(ValueError, match="at most 256"):
        seq_ops.flash_attention(q, q, q)


# the main shape's channel count, S not a multiple of the ring's 32-step
# tile, C not a multiple of the 32-channel block, B·C below one block,
# S = 1, and bf16 rows of odd C (copied 2 bytes at a time)
@pytest.mark.parametrize("b,s,c", [
    (2, 4096, 256), (1, 77, 130), (3, 64, 32), (2, 1000, 4096),
    (1, 300, 20), (2, 1, 96), (1, 33, 13), (4, 129, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linrec_kernel_matches_plain(cuda, b, s, c, dtype):
    """Bit-equal: the kernel does the plain version's exp, IEEE multiply
    and add in the same order."""
    rng = np.random.default_rng(s + c)
    log_a = torch.tensor(-rng.uniform(0.001, 1.0, (b, s, c))
                         .astype(np.float32), device=cuda).to(dtype)
    x = torch.tensor(rng.normal(size=(b, s, c)).astype(np.float32),
                     device=cuda).to(dtype)
    before = seq_ops.LAUNCHES["linear_recurrence"]
    got = seq_ops.linear_recurrence(log_a, x)
    torch.cuda.synchronize()
    assert seq_ops.LAUNCHES["linear_recurrence"] == before + 1
    assert got.dtype == torch.float32
    assert torch.equal(got, seq_ops.linear_recurrence_plain(log_a, x))


def test_linrec_kernel_takes_unaligned_rows(cuda):
    """Inputs that start 4 bytes past an allocation (a contiguous view at
    an offset): the ring copies 4 bytes at a time, still bit-equal."""
    rng = np.random.default_rng(7)
    raw = torch.tensor(rng.normal(size=(2 * 50 * 64 + 1,)).astype(np.float32),
                       device=cuda)
    x = raw[1:].view(2, 50, 64)
    log_a = -x.abs()
    log_a = torch.cat([log_a.new_zeros(1), log_a.reshape(-1)])[1:] \
        .view(2, 50, 64)
    assert seq_ops.linrec_vector_bytes(64, 4, log_a.data_ptr(),
                                       x.data_ptr()) == 4
    got = seq_ops.linear_recurrence(log_a, x)
    assert torch.equal(got, seq_ops.linear_recurrence_plain(log_a, x))


def test_linrec_kernel_rejects_mixed_dtypes(cuda):
    log_a = torch.zeros((1, 4, 8), device=cuda)
    with pytest.raises(TypeError, match="must match"):
        seq_ops.linear_recurrence(log_a, log_a.to(torch.bfloat16))

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


# one DDPG update on the card against the CPU from the same state and
# minibatch: the card's GEMMs and autograd sum in other orders, so the
# networks and Adam moments agree to float32 rounding, not bit for bit
DDPG_STEP_TOL = dict(rtol=1e-5, atol=1e-6)


def test_ddpg_train_step_card_matches_cpu(cuda):
    """One ``train_step`` at ``CONFIG``'s MDP widths (the (2N,)
    observation, hidden 64, batch 64) on the card and from the same state
    and minibatch on the CPU: every leaf of the new state and both losses
    at ``DDPG_STEP_TOL``."""
    from repro_torch.core import ddpg
    n = CONFIG.n_clients
    dcfg = ddpg.DDPGConfig(state_dim=2 * n, action_dim=2 * n, hidden=64,
                           buffer_size=256, batch_size=64)
    gen = torch.Generator().manual_seed(0)
    agent = ddpg.stack_agents([ddpg.init_ddpg(gen, dcfg)])
    for _ in range(100):
        s = torch.rand((1, 2 * n), generator=gen)
        a = torch.rand((1, 2 * n), generator=gen)
        agent = ddpg.store(agent, dcfg, s, a, -torch.sum(a * a, dim=-1), s)
    idx = torch.randint(0, 100, (1, 64), generator=gen)
    cpu_agent, cpu_loss = ddpg.train_step(agent, dcfg, idx)
    card_agent, card_loss = ddpg.train_step(_to(agent, cuda), dcfg,
                                            idx.to(cuda))
    for name, want in cpu_loss.items():
        torch.testing.assert_close(card_loss[name].cpu(), want,
                                   **DDPG_STEP_TOL)
    for name in ("actor", "critic", "target_actor", "target_critic"):
        for k, want in getattr(cpu_agent, name).items():
            torch.testing.assert_close(getattr(card_agent, name)[k].cpu(),
                                       want, **DDPG_STEP_TOL, msg=name + k)
    assert torch.equal(card_agent.step.cpu(), cpu_agent.step)


@pytest.mark.parametrize("seeds", [1, 4])
def test_ddpg_makes_one_sic_launch_a_slot(cuda, seeds):
    """Training S agents on S ``CONFIG`` full_dynamic worlds: one SIC call
    a slot (the env's bill of every seed), whatever S; no SGD launch; one
    score call, the fcea association snapshot the MDP starts from."""
    from repro_torch.core import ddpg
    pairs = []
    for s in range(seeds):
        state, bundle, _ = engine.init_simulation(
            CONFIG, seed=s, device=cuda, scenario="full_dynamic")
        pairs.append((state, bundle))
    states, bundles = engine.stack_fleet(pairs)
    spec = engine.EngineSpec(scenario="dynamic", allocator="ddpg")
    dcfg = ddpg.allocator_config(CONFIG, spec, hidden=16, buffer_size=64,
                                 batch_size=8)
    gens = [torch.Generator(device=cuda).manual_seed(s)
            for s in range(seeds)]
    agents = ddpg.stack_agents([ddpg.init_ddpg(g, dcfg) for g in gens])
    draws = ddpg.sample_ddpg_draws(CONFIG, dcfg, gens, 2, 3)
    torch.cuda.synchronize()
    before = dict(hfl_ops.LAUNCHES)
    agents, hist = ddpg.train_allocator_fleet(CONFIG, spec, states, bundles,
                                              dcfg, agents, draws, warmup=2)
    torch.cuda.synchronize()
    grew = {k: hfl_ops.LAUNCHES[k] - before[k] for k in before}
    assert grew == {"score_rows": 0, "score_matrix": 1,
                    "score_candidates": 0, "sic_rates": 6,
                    "local_sgd_step": 0, "local_sgd_step_cluster": 0}
    assert hist["episode_reward"].shape == (seeds, 2)
    assert bool(torch.isfinite(hist["episode_reward"]).all())


def test_ddpg_round_launches_as_a_mid_round(cuda):
    """A round billed by an actor makes the launches of a ``mid`` round
    from the same state and draws: the actor is plain products."""
    from repro_torch.core import ddpg
    state, bundle, aux = engine.init_simulation(CONFIG, seed=0, device=cuda)
    spec = engine.EngineSpec(allocator="ddpg")
    actor = ddpg.init_ddpg(torch.Generator(device=cuda).manual_seed(1),
                           ddpg.allocator_config(CONFIG, spec)).actor
    draws = engine.sample_draws(CONFIG, bundle, aux["generator"], spec)
    grew = []
    for sp, a in ((engine.EngineSpec(), None), (spec, actor)):
        torch.cuda.synchronize()
        before = dict(hfl_ops.LAUNCHES)
        _, m = engine.round_step(CONFIG, sp, state, bundle, draws, a)
        torch.cuda.synchronize()
        grew.append({k: hfl_ops.LAUNCHES[k] - before[k] for k in before})
        assert np.isfinite(float(m.cost))
    assert grew[0] == grew[1]
    assert (grew[1]["score_matrix"], grew[1]["sic_rates"]) == (1, 1)


@pytest.mark.parametrize("kw", [dict(), dict(candidates_k=2)])
def test_telemetry_changes_no_launch_and_no_metric(cuda, kw):
    """Two ``CONFIG`` rounds with and without the trace from one state and
    the same draws: the same kernel launches, the metrics and the state
    bit-equal; the trace's leaves on the card."""
    state, bundle, aux = engine.init_simulation(CONFIG, seed=0, device=cuda)
    off, on = engine.EngineSpec(**kw), engine.EngineSpec(telemetry=True,
                                                         **kw)
    draws = [engine.sample_draws(CONFIG, bundle, aux["generator"], off)
             for _ in range(2)]
    runs = []
    for spec in (off, on):
        torch.cuda.synchronize()
        before = dict(hfl_ops.LAUNCHES)
        st = state
        for d in draws:
            st, out = engine.round_step(CONFIG, spec, st, bundle, d)
        torch.cuda.synchronize()
        runs.append((st, out, {k: hfl_ops.LAUNCHES[k] - before[k]
                               for k in before}))
    (s_off, m_off, l_off), (s_on, (m_on, tr), l_on) = runs
    assert l_off == l_on
    for a, b in zip(m_off, m_on):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    for k, v in s_off.global_params.items():
        assert torch.equal(s_on.global_params[k], v), k
    assert torch.equal(s_off.staleness, s_on.staleness)
    assert tr.edge_load.device == s_on.gains.device
    assert int(tr.stale_hist.sum()) == CONFIG.n_clients


@pytest.mark.parametrize("kw", [dict(), dict(candidates_k=2)])
def test_buffered_micro_step_card_matches_cpu(cuda, kw):
    """One buffered ``CONFIG`` micro-step (a mid-run state: four steps
    taken on the card first) on the card and from the same state and
    draws on the CPU: the buffer's integers and the decisions exact, the
    clock, finish times and EMA rtol 1e-5, the bill rtol 1e-5 (and 1e-5
    of the clock), the deltas and params rtol 1e-4, atol 1e-5; one score
    call, the dense SIC call and τ₂ SGD launches."""
    spec = engine.EngineSpec(engine_mode="buffered", **kw)
    state, bundle, aux = engine.init_simulation(CONFIG, seed=0, device=cuda)
    for _ in range(4):
        state, _ = engine.round_step(
            CONFIG, spec, state, bundle,
            engine.sample_draws(CONFIG, bundle, aux["generator"], spec))
    draws = engine.sample_draws(CONFIG, bundle, aux["generator"], spec)
    torch.cuda.synchronize()
    before = dict(hfl_ops.LAUNCHES)
    s_card, m_card = engine.round_step(CONFIG, spec, state, bundle, draws)
    torch.cuda.synchronize()
    grew = {k: hfl_ops.LAUNCHES[k] - before[k] for k in before}
    dense = "candidates_k" not in kw
    assert (grew["score_matrix"], grew["score_candidates"],
            grew["sic_rates"], grew["local_sgd_step"]) == (
        int(dense), int(not dense), int(dense), CONFIG.tau2)
    cpu = torch.device("cpu")
    s_cpu, m_cpu = engine.round_step(CONFIG, spec, _to(state, cpu),
                                     _to(bundle, cpu), _to(draws, cpu))
    g, c = engine.metrics_row(m_card), engine.metrics_row(m_cpu)
    assert g["z"].tolist() == c["z"].tolist()
    for key in ("n_associated", "n_available", "sweeps", "round"):
        assert g[key] == c[key], key
    assert torch.equal(s_card.staleness.cpu(), s_cpu.staleness)
    bg, bc = _to(s_card.buffer, cpu), s_cpu.buffer
    for name in ("in_flight", "tier", "pulled_ver", "fill", "version",
                 "step"):
        assert torch.equal(getattr(bg, name), getattr(bc, name)), name
    for name in ("finish_s", "obs_s", "clock_s", "last_agg_s", "weight_sum"):
        torch.testing.assert_close(getattr(bg, name), getattr(bc, name),
                                   rtol=1e-5, atol=0.0, msg=name)
    clock = float(bc.clock_s)
    assert g["total_energy_j"] == pytest.approx(c["total_energy_j"],
                                                rel=1e-5)
    assert abs(g["total_time_s"] - c["total_time_s"]) <= 1e-5 * clock
    assert g["loss"] == pytest.approx(c["loss"], rel=1e-4)
    for tree in ("pending_delta", "delta_sum"):
        for k, v in getattr(bc, tree).items():
            scale = max(float(bc.weight_sum), 1.0) if tree == "delta_sum" \
                else 1.0
            torch.testing.assert_close(getattr(bg, tree)[k], v, rtol=1e-4,
                                       atol=1e-5 * scale, msg=tree + k)
    for k, v in s_cpu.client_params.items():
        torch.testing.assert_close(s_card.client_params[k].cpu(), v,
                                   rtol=1e-4, atol=1e-5, msg=k)


def test_buffered_all_pad_cohort_on_the_card(cuda):
    """A micro-step whose tier holds no idle client: every SGD lane is a
    pad lane, yet τ₂ SGD launches run; no client's params or pending delta
    moves, and nothing is in flight."""
    spec = engine.EngineSpec(engine_mode="buffered", n_tiers=2)
    state, bundle, aux = engine.init_simulation(CONFIG, seed=0, device=cuda)
    state = engine.ensure_buffer(CONFIG, spec, state)
    buf = state.buffer
    noise = {k: torch.randn(v.shape, device=cuda,
                            generator=torch.Generator(device=cuda)
                            .manual_seed(3))
             for k, v in buf.pending_delta.items()}
    state = state._replace(buffer=buf._replace(
        tier=torch.ones_like(buf.tier), pending_delta=noise))
    draws = engine.sample_draws(CONFIG, bundle, aux["generator"], spec)
    torch.cuda.synchronize()
    before = dict(hfl_ops.LAUNCHES)
    new, m = engine.round_step(CONFIG, spec, state, bundle, draws)
    torch.cuda.synchronize()
    assert hfl_ops.LAUNCHES["local_sgd_step"] - \
        before["local_sgd_step"] == CONFIG.tau2
    assert int(m.n_associated) == 0 and int(m.n_available) == 0
    for k, v in noise.items():
        assert torch.equal(new.buffer.pending_delta[k], v), k
        assert torch.equal(new.client_params[k], state.client_params[k]), k
    assert not bool(new.buffer.in_flight.any())
    assert np.isfinite(float(m.cost))


# the reference's chaos sweep cell plus crashes and NaN poisoning
CHAOS = dict(edge_p_kill=0.2, edge_p_respawn=0.5, uplink_p_loss=0.1,
             uplink_loss_slope=0.2, client_p_crash=0.05, p_poison=0.1,
             poison_nan=True)


@pytest.mark.parametrize("mode", ["sync", "buffered"])
def test_faulted_round_card_matches_cpu(cuda, mode):
    """A ``CONFIG`` round (or micro-step) under chaos, from a mid-run state
    (three steps on the card first), on the card and from the same state
    and draws on the CPU: every ``FaultState`` leaf, the decisions and the
    staleness exact, the bill rtol 1e-5 (and 1e-5 of the clock on the
    buffered engine), the loss rtol 1e-4; the kernels launch as in an
    unfaulted step."""
    from repro_torch.faults import FaultSpec
    spec = engine.EngineSpec(engine_mode=mode, faults=FaultSpec(**CHAOS))
    state, bundle, aux = engine.init_simulation(CONFIG, seed=0, device=cuda)
    for _ in range(3):
        state, _ = engine.round_step(
            CONFIG, spec, state, bundle,
            engine.sample_draws(CONFIG, bundle, aux["generator"], spec))
    draws = engine.sample_draws(CONFIG, bundle, aux["generator"], spec)
    torch.cuda.synchronize()
    before = dict(hfl_ops.LAUNCHES)
    s_card, m_card = engine.round_step(CONFIG, spec, state, bundle, draws)
    torch.cuda.synchronize()
    grew = {k: hfl_ops.LAUNCHES[k] - before[k] for k in before}
    assert (grew["score_matrix"], grew["sic_rates"],
            grew["local_sgd_step"]) == (1, 1, CONFIG.tau2)
    cpu = torch.device("cpu")
    s_cpu, m_cpu = engine.round_step(CONFIG, spec, _to(state, cpu),
                                     _to(bundle, cpu), _to(draws, cpu))
    for name, leaf in s_cpu.faults._asdict().items():
        assert torch.equal(getattr(s_card.faults, name).cpu(), leaf), name
    g, c = engine.metrics_row(m_card), engine.metrics_row(m_cpu)
    assert g["z"].tolist() == c["z"].tolist()
    for key in ("n_associated", "n_available", "sweeps"):
        assert g[key] == c[key], key
    assert torch.equal(s_card.staleness.cpu(), s_cpu.staleness)
    clock = float(s_cpu.buffer.clock_s) if mode == "buffered" else 0.0
    for key in ("total_energy_j", "total_time_s"):
        assert abs(g[key] - c[key]) <= 1e-5 * (abs(c[key]) + clock), key
    assert g["loss"] == pytest.approx(c["loss"], rel=1e-4)


def test_all_nan_poison_keeps_the_global_model_on_the_card(cuda):
    """Every delivered delta NaN-poisoned: two sync ``CONFIG`` rounds on
    the card leave the global model bit for bit unchanged."""
    from repro_torch.faults import FaultSpec
    spec = engine.EngineSpec(faults=FaultSpec(
        edge_p_kill=0.0, edge_p_respawn=0.0, p_poison=1.0, poison_nan=True))
    state, bundle, aux = engine.init_simulation(CONFIG, seed=0, device=cuda)
    final, ms = engine.run_scanned(CONFIG, spec, state, bundle, 2,
                                   aux["generator"])
    for k, v in state.global_params.items():
        assert torch.equal(final.global_params[k], v), k
    assert int(final.faults.n_quarantined) > 0
    assert bool(torch.isfinite(ms.loss).all())


def test_resumable_run_on_the_card_is_bit_identical(cuda, tmp_path):
    from repro_torch.faults import FaultSpec, run_scanned_resumable
    spec = engine.EngineSpec(engine_mode="buffered", telemetry=True,
                             faults=FaultSpec(**CHAOS))
    state, bundle, _ = engine.init_simulation(CONFIG, seed=0, device=cuda)
    state = engine.ensure_carry(CONFIG, spec, state)
    gen_ref = torch.Generator(device=cuda).manual_seed(4)
    ref, (ms, tr) = engine.run_scanned(CONFIG, spec, state, bundle, 4,
                                       gen_ref)
    run_scanned_resumable(CONFIG, spec, state, bundle, 4,
                          torch.Generator(device=cuda).manual_seed(4),
                          directory=str(tmp_path), segment_rounds=2,
                          max_segments=1)
    gen = torch.Generator(device=cuda)
    res = run_scanned_resumable(CONFIG, spec, state, bundle, 4, gen,
                                directory=str(tmp_path), segment_rounds=2)
    def bits(t):    # NaN-poisoned deltas ride the carry: compare bits
        t = t.cpu()
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    for got, want in ((res.metrics, ms), (res.trace, tr),
                      (res.state, ref)):
        engine._map(lambda a, b: torch.equal(bits(a), bits(b))
                    or pytest.fail("resumed run diverged"), got, want)
    assert torch.equal(gen.get_state(), gen_ref.get_state())
    assert res.state.gains.device.type == "cuda"


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


def test_sgd_fleet_launch_is_each_cohorts_own(cuda):
    """S = 4 cohorts of K = 16 lanes at the sweep grid's shape in one
    launch with ``seeds=4``: one cohort's cluster size (8; the 64 lanes
    alone would take 2), each cohort bit-equal to its own launch."""
    k, seeds, tau1, batch, d_in, hidden = 16, 4, 2, 32, 64, 32
    assert hfl_ops.sgd_cluster_size(k, batch, d_in, hidden, 10) == 8
    assert hfl_ops.sgd_cluster_size(seeds * k, batch, d_in, hidden, 10) == 2
    params, bx, by = _sgd_case(seeds * k, tau1, batch, d_in, hidden, cuda)
    got = hfl_ops.local_sgd_step(params, bx, by, lr=0.05, seeds=seeds)
    for i in range(seeds):
        lanes = slice(i * k, (i + 1) * k)
        own = hfl_ops.local_sgd_step({n: v[lanes] for n, v in params.items()},
                                     bx[:, lanes], by[:, lanes], lr=0.05)
        for name in PARAM_KEYS:
            assert torch.equal(got[name][lanes], own[name]), (i, name)


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
    (1, 300, 14, 2, 128, True, 0),       # odd group 7 (yi-34b's), ragged S
    (1, 257, 16, 2, 128, True, 100),     # group 8 (qwen1.5-110b's), window
    # the dense decoders' prefill shapes
    (2, 4096, 32, 8, 128, True, 0),      # qwen3-8b, group 4
    (2, 4096, 56, 8, 128, True, 0),      # yi-34b, group 7
    (2, 4096, 64, 8, 128, True, 0),      # qwen1.5-110b, group 8
    (2, 4096, 32, 32, 64, True, 0),      # stablelm-1.6b, MHA at D = 64
    (1, 8192, 32, 8, 128, True, 4096),   # qwen3-8b-sw4k, window 4096
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


def _plain_by_kv_head(q, k, v, **mask):
    """The plain version one KV head (and its group of query heads) at a
    time: the same function, with a (S, S) score matrix a head group
    instead of all heads' (llama4's 1 × 16384 at 40 heads would take 43 GB
    of fp32 scores at once)."""
    group = q.shape[2] // k.shape[2]
    return torch.cat([
        seq_ops.attention_plain(q[:, :, i * group:(i + 1) * group],
                                k[:, :, i:i + 1], v[:, :, i:i + 1], **mask)
        for i in range(k.shape[2])], dim=2)


# The prefix-LM and chunked masks at both kernels' edges (the tensor-core
# kernel: 128 query rows a block, 64 keys a tile; the CUDA-core kernel: 64
# and 64): (B, S, H, KV, D, prefix_len, chunk)
MASK_EDGES = [
    (1, 300, 4, 1, 256, 1, 0),           # prefix 1 (= causal)
    (2, 333, 8, 1, 256, 100, 0),         # ragged prefix, MQA, ragged S
    (1, 200, 4, 2, 128, 200, 0),         # prefix = S: full attention
    (1, 100, 4, 2, 64, 300, 0),          # prefix past S, S below a q-tile
    (1, 300, 4, 4, 64, 0, 32),           # chunk below a tile: a q-tile
                                         # straddles four chunks
    (1, 333, 10, 2, 128, 0, 100),        # chunk not a tile multiple, group 5
    (2, 400, 4, 2, 128, 0, 128),         # chunk = the q-tile
    (1, 300, 12, 2, 128, 0, 300),        # chunk = S (causal), group 6
    (1, 130, 6, 1, 128, 0, 1000),        # chunk past S, MQA
    # the full-width prefill shapes: paligemma-3b, llama4's chunked layers
    (2, 4352, 8, 1, 256, 256, 0),
    (1, 16384, 40, 8, 128, 0, 8192),
]


@pytest.mark.parametrize("b,s,h,kv,d,prefix,chunk", MASK_EDGES)
def test_flash_wgmma_prefix_and_chunk_match_plain(cuda, b, s, h, kv, d,
                                                  prefix, chunk):
    rng = np.random.default_rng(s + d + prefix + chunk)
    q, k, v = (torch.tensor(rng.normal(size=(b, s, n, d)).astype(np.float32),
                            device=cuda).to(torch.bfloat16) for n in (h, kv, kv))
    mask = dict(causal=True, prefix_len=prefix, chunk=chunk)
    before = dict(seq_ops.LAUNCHES)
    got = seq_ops.flash_attention(q, k, v, **mask)
    torch.cuda.synchronize()
    assert seq_ops.LAUNCHES["flash_attention_wgmma"] == \
        before["flash_attention_wgmma"] + 1
    want = _plain_by_kv_head(q.float(), k.float(), v.float(), **mask)
    torch.testing.assert_close(got.float(), want.to(torch.bfloat16).float(),
                               **FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("b,s,h,kv,d,prefix,chunk", [
    e for e in MASK_EDGES if e[1] <= 400])
def test_flash_cuda_core_prefix_and_chunk_match_plain(cuda, b, s, h, kv, d,
                                                      prefix, chunk):
    """The float32 route (the CUDA-core kernel) under the same masks."""
    rng = np.random.default_rng(s + d + prefix + chunk + 1)
    q, k, v = (torch.tensor(rng.normal(size=(b, s, n, d)).astype(np.float32),
                            device=cuda) for n in (h, kv, kv))
    mask = dict(causal=True, prefix_len=prefix, chunk=chunk)
    before = dict(seq_ops.LAUNCHES)
    got = seq_ops.flash_attention(q, k, v, **mask)
    torch.cuda.synchronize()
    assert seq_ops.LAUNCHES["flash_attention"] == \
        before["flash_attention"] + 1
    assert seq_ops.LAUNCHES["flash_attention_wgmma"] == \
        before["flash_attention_wgmma"]
    torch.testing.assert_close(got, seq_ops.attention_plain(q, k, v, **mask),
                               **FLASH_TOL[torch.float32])


# A block of queries at an offset (a rank's block of a context-parallel
# prefill) against the whole sequence's keys, on both kernels: (S, the
# block [lo, hi), H, KV, D, mask) -- offsets that are and are not
# multiples of the tiles (64; 128 for the tensor-core kernel's q-tile), a
# rank-0 block, a block through the end, a window whose first rows' start
# before 0, every mask kind, and yi-34b's context-parallel shape
OFFSET_EDGES = [
    (300, 0, 75, 6, 2, 128, dict(causal=True)),
    (300, 128, 256, 6, 2, 128, dict(causal=True)),
    (300, 64, 200, 4, 1, 256, dict(causal=True, window=100)),
    (300, 30, 97, 4, 4, 64, dict(causal=True, window=100)),
    (400, 77, 400, 10, 2, 128, dict(causal=True, chunk=96)),
    (333, 100, 333, 8, 1, 256, dict(causal=True, prefix_len=150)),
    (333, 200, 260, 8, 1, 64, dict(causal=True, prefix_len=150)),
    (3072, 1024, 2048, 56, 8, 128, dict(causal=True)),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("s,lo,hi,h,kv,d,mask", OFFSET_EDGES)
def test_flash_query_offset_matches_plain(cuda, s, lo, hi, h, kv, d, mask,
                                          dtype):
    """bf16 on the tensor-core kernel, fp32 on the CUDA-core one, each at
    the forward's tolerance against the plain version's block."""
    rng = np.random.default_rng(s + lo + hi + d)
    q, k, v = (torch.tensor(rng.normal(size=(1, n, m, d)).astype(np.float32),
                            device=cuda).to(dtype)
               for n, m in ((hi - lo, h), (s, kv), (s, kv)))
    before = dict(seq_ops.LAUNCHES)
    got = seq_ops.flash_attention(q, k, v, q_offset=lo, **mask)
    torch.cuda.synchronize()
    assert seq_ops.LAUNCHES["flash_attention"] == \
        before["flash_attention"] + 1
    assert seq_ops.LAUNCHES["flash_attention_wgmma"] == \
        before["flash_attention_wgmma"] + int(dtype == torch.bfloat16)
    want = _plain_by_kv_head(q.float(), k.float(), v.float(), q_offset=lo,
                             **mask)
    torch.testing.assert_close(got.float(), want.to(dtype).float(),
                               **FLASH_TOL[dtype])


def test_flash_rejects_mask_combinations_on_the_card(cuda):
    q = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.bfloat16)
    before = dict(seq_ops.LAUNCHES)
    for kw in (dict(window=4, chunk=8), dict(causal=False, prefix_len=2)):
        with pytest.raises(ValueError, match="flash_attention"):
            seq_ops.flash_attention(q, q, q, **kw)
    assert seq_ops.LAUNCHES == before


# Full attention over a key length of its own (whisper's cross-attention)
# at both kernels' edges: (B, S_q, S_kv, H, KV, D) -- one query, whisper's
# 448 decoder tokens over 1500 frames (1500 = 23 · 64 + 28), fewer keys than
# queries, ragged both ways with MQA, fewer keys than one tile; and
# whisper's encoder shape (non-causal MHA at D = 64, S = 1500)
KV_LENGTH_EDGES = [
    (1, 1, 1500, 4, 4, 64),
    (2, 448, 1500, 20, 20, 64),
    (1, 100, 64, 4, 2, 128),
    (1, 300, 333, 8, 1, 256),
    (1, 1500, 7, 4, 4, 64),
    (2, 1500, 1500, 20, 20, 64),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,s_q,s_kv,h,kv,d", KV_LENGTH_EDGES)
def test_flash_own_key_length_matches_plain(cuda, b, s_q, s_kv, h, kv, d,
                                            dtype):
    """bf16 goes to the tensor-core kernel, fp32 to the CUDA-core one; each
    held to the plain version as the same-length cases are."""
    rng = np.random.default_rng(s_q + s_kv + d)
    q = torch.tensor(rng.normal(size=(b, s_q, h, d)).astype(np.float32),
                     device=cuda).to(dtype)
    k, v = (torch.tensor(rng.normal(size=(b, s_kv, kv, d)).astype(np.float32),
                         device=cuda).to(dtype) for _ in range(2))
    before = dict(seq_ops.LAUNCHES)
    got = seq_ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert seq_ops.LAUNCHES["flash_attention"] == \
        before["flash_attention"] + 1
    assert seq_ops.LAUNCHES["flash_attention_wgmma"] == \
        before["flash_attention_wgmma"] + int(dtype == torch.bfloat16)
    assert got.shape == q.shape and got.dtype == dtype
    want = seq_ops.attention_plain(q.float(), k.float(), v.float(),
                                   causal=False).to(dtype)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


def test_flash_two_lengths_refuse_masks_on_the_card(cuda):
    q = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((1, 12, 2, 64), device=cuda, dtype=torch.bfloat16)
    before = dict(seq_ops.LAUNCHES)
    for kw in (dict(causal=True), dict(causal=False, window=4)):
        with pytest.raises(ValueError, match="full attention only"):
            seq_ops.flash_attention(q, k, k, **kw)
    with pytest.raises(ValueError, match="no keys"):
        seq_ops.flash_attention(q, k[:, :0], k[:, :0], causal=False)
    assert seq_ops.LAUNCHES == before


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


@pytest.mark.parametrize("arch", ["yi-34b", "qwen3-8b", "qwen3-8b-sw4k",
                                  "qwen1.5-110b", "stablelm-1.6b"])
def test_dense_reduced_card_matches_cpu(cuda, arch):
    """A reduced dense decoder with 2 KV heads (GQA, the per-KV-head biases,
    the q/k norm over a shared head) and its constant-initialised leaves
    redrawn: the card's logits (flash kernel, one launch a layer) against
    the CPU's (plain) from the same weights, at the reference's
    decode-parity tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Transformer
    cfg = get_config(arch).reduced().replace(n_kv_heads=2)
    gen = torch.Generator().manual_seed(0)
    cpu_model = Transformer(cfg, device="cpu", generator=gen)
    with torch.no_grad():
        for name, p in cpu_model.named_parameters():
            if name.rsplit(".", 1)[-1] in ("scale", "bias", "bq", "bk", "bv"):
                p.add_(0.3 * torch.randn(p.shape, generator=gen))
    card_model = Transformer(cfg, device=cuda)
    card_model.load_state_dict(cpu_model.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, 150), generator=gen)
    before = seq_ops.LAUNCHES["flash_attention"]
    with torch.no_grad():
        got = card_model.apply(tokens.to(cuda))
        want = cpu_model.apply(tokens)
    assert seq_ops.LAUNCHES["flash_attention"] == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("arch", ["paligemma-3b", "grok-1-314b",
                                  "llama4-maverick-400b-a17b"])
def test_vlm_moe_reduced_card_matches_cpu(cuda, arch):
    """A reduced prefix-LM or MoE decoder with 2 KV heads, its norm scales
    redrawn: the card's logits (the flash kernel with the prefix or chunked
    mask, one launch a layer) against the CPU's from the same weights, and
    the MoE aux, at the reference's decode-parity tolerance.  paligemma
    takes 8 patch embeddings; llama4's chunk of 32 cuts 2 × 150 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Transformer
    cfg = get_config(arch).reduced().replace(n_kv_heads=2)
    gen = torch.Generator().manual_seed(0)
    cpu_model = Transformer(cfg, device="cpu", generator=gen)
    with torch.no_grad():
        for name, p in cpu_model.named_parameters():
            if name.endswith("scale"):
                p.add_(0.3 * torch.randn(p.shape, generator=gen))
    card_model = Transformer(cfg, device=cuda)
    card_model.load_state_dict(cpu_model.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, 150), generator=gen)
    extra = torch.randn((2, cfg.prefix_tokens, cfg.d_model), generator=gen) \
        if cfg.prefix_tokens else None
    before = seq_ops.LAUNCHES["flash_attention"]
    with torch.no_grad():
        got, aux = card_model.apply(
            tokens.to(cuda), None if extra is None else extra.to(cuda),
            with_aux=True)
        want, want_aux = cpu_model.apply(tokens, extra, with_aux=True)
    assert seq_ops.LAUNCHES["flash_attention"] == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("arch,kv", [("xlstm-125m", None),
                                     ("whisper-large-v3", None),
                                     ("whisper-large-v3", 2)])
def test_xlstm_encdec_reduced_card_matches_cpu(cuda, arch, kv):
    """The reduced xLSTM (no kernel: its scans are plain) and whisper (MHA
    and 2 KV heads; per layer one encoder, one causal and one
    cross-attention flash launch, 16 frames under 40 tokens) with their
    constant-initialised leaves redrawn: the card's logits against the
    CPU's from the same weights, at the reference's decode-parity
    tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch).reduced()
    if kv is not None:
        cfg = cfg.replace(n_kv_heads=kv)
    gen = torch.Generator().manual_seed(0)
    cpu_model = build_model(cfg, device="cpu", generator=gen)
    with torch.no_grad():
        for name, p in cpu_model.named_parameters():
            if name.rsplit(".", 1)[-1] in ("scale", "bias", "bq", "bk", "bv",
                                           "b_in", "b_out", "norm_scale",
                                           "b_fgate", "b_gates"):
                p.add_(0.3 * torch.randn(p.shape, generator=gen))
    card_model = build_model(cfg, device=cuda)
    card_model.load_state_dict(cpu_model.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen)
    frames = torch.randn((2, cfg.stub_frames, cfg.d_model), generator=gen) \
        if cfg.encoder_layers else None
    before = seq_ops.LAUNCHES["flash_attention"]
    with torch.no_grad():
        got = card_model.apply(tokens.to(cuda),
                               None if frames is None else frames.to(cuda))
        want = cpu_model.apply(tokens, frames)
    assert seq_ops.LAUNCHES["flash_attention"] == \
        before + (cfg.encoder_layers + 2 * cfg.n_layers
                  if cfg.encoder_layers else 0)
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=1e-3)


# -- training: the wrappers' Functions and the train step on the card ---------------

def _cuda_normal(shape, seed, dev, dtype=torch.float32):
    return torch.tensor(np.random.default_rng(seed).normal(size=shape)
                        .astype(np.float32), device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,s,s_kv,h,kv,d,mask", [
    (2, 300, 300, 8, 2, 64, dict(causal=True)),
    (1, 333, 333, 4, 1, 256, dict(causal=True, window=100)),
    (1, 200, 200, 4, 4, 64, dict(causal=False, window=50)),
    (2, 300, 300, 8, 1, 128, dict(causal=True, prefix_len=77)),
    (1, 333, 333, 10, 2, 128, dict(causal=True, chunk=100)),
    (2, 448, 1500, 4, 4, 64, dict(causal=False))])
def test_flash_function_gradient_matches_plain_autograd(cuda, b, s, s_kv, h,
                                                        kv, d, mask, dtype):
    """flash's Function on the card: one kernel launch forward, its output
    against ``attention_plain`` at the forward's tolerance (fp32 2e-5;
    bf16 one bf16 ulp from the plain version in fp32), and dq, dk, dv from the recompute through
    ``attention_plain`` bit-equal to autograd of the plain version (the
    same computation)."""
    q = _cuda_normal((b, s, h, d), 1, cuda, dtype)
    k = _cuda_normal((b, s_kv, kv, d), 2, cuda, dtype)
    v = _cuda_normal((b, s_kv, kv, d), 3, cuda, dtype)
    g = _cuda_normal((b, s, h, d), 4, cuda, dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = seq_ops.LAUNCHES["flash_attention"]
    out = seq_ops.flash_attention(*leaves, **mask)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert seq_ops.LAUNCHES["flash_attention"] == before + 1
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want_out = seq_ops.attention_plain(*plain, **mask)
    want = torch.autograd.grad(want_out, plain, g)
    if dtype == torch.bfloat16:     # as the forward tests hold the kernel
        want_out = seq_ops.attention_plain(q.float(), k.float(), v.float(),
                                           **mask).to(dtype)
    torch.testing.assert_close(out.float(), want_out.float(),
                               **FLASH_TOL[dtype])
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.parametrize("b,s,c,dtype", [
    (1, 77, 130, torch.float32), (2, 33, 13, torch.bfloat16),
    (1, 300, 20, torch.float32), (3, 45, 7, torch.float32),
    (2, 1, 96, torch.float32)])
def test_linrec_adjoint_kernel_matches_plain_autograd(cuda, b, s, c, dtype):
    """The recurrence's Function on the card launches the kernel twice (the
    forward, then the adjoint over reversed time) and matches autograd
    through the plain step loop: C odd and not a multiple of the block's
    32 channels, S not a multiple of the 32-step tile, bf16, S = 1."""
    log_a = (-0.1 * _cuda_normal((b, s, c), 5, cuda).abs()).to(dtype)
    x = _cuda_normal((b, s, c), 6, cuda, dtype)
    g = _cuda_normal((b, s, c), 7, cuda)
    leaves = [log_a.clone().requires_grad_(), x.clone().requires_grad_()]
    before = seq_ops.LAUNCHES["linear_recurrence"]
    got = torch.autograd.grad(seq_ops.linear_recurrence(*leaves), leaves, g)
    torch.cuda.synchronize()
    assert seq_ops.LAUNCHES["linear_recurrence"] == before + 2
    plain = [log_a.clone().requires_grad_(), x.clone().requires_grad_()]
    want = torch.autograd.grad(seq_ops.linear_recurrence_plain(*plain),
                               plain, g)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 \
        else dict(rtol=2.0 ** -7, atol=1e-6)
    for a, w in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), w.float(), **tol)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "recurrentgemma-9b",
                                  "xlstm-125m", "grok-1-314b",
                                  "paligemma-3b", "whisper-large-v3"])
def test_reduced_train_step_card_matches_cpu(cuda, arch):
    """One reduced config per mixer kind in fp32, its constant leaves
    redrawn: the card's loss and every gradient (the flash and recurrence
    Functions, one flash forward an attention layer, two recurrence
    launches a ``rec`` layer) against the CPU's at the CPU tests' bounds
    (loss rtol 1e-5, a leaf 1e-4·max|g| + 1e-6), then one train step's
    weights at lr 1e-2 within the reference's Adam-sign bound."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(0)
    cpu_model = build_model(cfg, device="cpu", generator=gen)
    with torch.no_grad():
        for name, p in cpu_model.named_parameters():
            if name.rsplit(".", 1)[-1] in ("scale", "bias", "bq", "bk", "bv",
                                           "b_in", "b_out", "norm_scale",
                                           "b_fgate", "b_gates"):
                p.add_(0.3 * torch.randn(p.shape, generator=gen))
    card_model = build_model(cfg, device=cuda)
    card_model.load_state_dict(cpu_model.state_dict())
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 96),
                                     generator=gen, dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab_size, (2, 96),
                                     generator=gen, dtype=torch.int32)}
    n = cfg.prefix_tokens or cfg.stub_frames
    if n:
        batch["embeddings"] = torch.randn((2, n, cfg.d_model), generator=gen)
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    kinds = [cfg.block_pattern[i % len(cfg.block_pattern)]
             for i in range(cfg.n_layers)]
    flash = cfg.encoder_layers + 2 * cfg.n_layers if cfg.encoder_layers \
        else sum(k in ("attn", "swa", "chunked") for k in kinds)
    before = dict(seq_ops.LAUNCHES)
    loss_card, g_card = steps.loss_and_grads(card_model, on_card)
    torch.cuda.synchronize()
    assert seq_ops.LAUNCHES["flash_attention"] - \
        before["flash_attention"] == flash
    assert seq_ops.LAUNCHES["linear_recurrence"] - \
        before["linear_recurrence"] == 2 * kinds.count("rec")
    loss_cpu, g_cpu = steps.loss_and_grads(cpu_model, batch)
    torch.testing.assert_close(loss_card.cpu(), loss_cpu, rtol=1e-5, atol=0.0)
    for name, gc in g_cpu.items():
        assert g_card[name] is not None, name
        bound = 1e-4 * float(gc.abs().max()) + 1e-6
        assert float((g_card[name].cpu() - gc).abs().max()) <= bound, name
    for model, data in ((card_model, on_card), (cpu_model, batch)):
        step_fn, _, opt = steps.make_train_step(cfg, lr=1e-2, model=model)
        _, count, _ = step_fn(opt.init(dict(model.named_parameters())), 0,
                              data)
        assert count == 1
    for pc, pg in zip(cpu_model.parameters(), card_model.parameters()):
        d = (pg.detach().cpu() - pc.detach()).abs()
        assert float(d.max()) <= 2.5e-2 and float(d.mean()) < 2e-3


def test_remat_train_step_bit_equal_on_the_card(cuda):
    """A reduced attention model (stablelm-1.6b, fp32, two layers) with
    ``remat`` on and off from the same weights: one ``loss_and_grads``
    each, remat launching flash twice a layer (forward and the backward's
    recompute) and off once, the loss and every gradient bit-equal; then
    one train step each, the weights bit-equal."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    cfg = get_config("stablelm-1.6b").reduced()
    gen = torch.Generator(device=cuda).manual_seed(0)
    on = build_model(cfg.replace(remat=True), device=cuda, generator=gen)
    off = build_model(cfg, device=cuda)
    off.load_state_dict(on.state_dict())
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 96),
                                     generator=gen, device=cuda,
                                     dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab_size, (2, 96),
                                     generator=gen, device=cuda,
                                     dtype=torch.int32)}
    results = []
    for model, per_layer in ((on, 2), (off, 1)):
        before = seq_ops.LAUNCHES["flash_attention"]
        results.append(steps.loss_and_grads(model, batch))
        torch.cuda.synchronize()
        assert seq_ops.LAUNCHES["flash_attention"] - before == \
            per_layer * cfg.n_layers
    (loss_on, g_on), (loss_off, g_off) = results
    assert torch.equal(loss_on, loss_off)
    for name, g in g_on.items():
        assert torch.equal(g, g_off[name]), name
    for model in (on, off):
        step_fn, _, opt = steps.make_train_step(model.cfg, lr=1e-2,
                                                model=model)
        step_fn(opt.init(dict(model.named_parameters())), 0, batch)
    for (name, a), b in zip(on.named_parameters(), off.parameters()):
        assert torch.equal(a, b), name

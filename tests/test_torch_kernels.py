"""The port's three kernels, held to the JAX reference on the CPU.

On CPU tensors every wrapper of ``repro_torch.kernels.hfl_ops`` runs its
plain PyTorch version, so these tests hold the plain versions -- the
fuzzy pipeline, the pairwise SIC and the hand-chain SGD -- against the
reference's Pallas kernels in interpret mode and against its jnp paths,
at the shapes and tolerances of ``test_kernels.py`` / ``test_train_impl.py``.
The CUDA kernels themselves are held to the plain versions on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fuzzy as jfuzzy
from repro.core import noma as jnoma
from repro.kernels import hfl_ops as jops
from repro.models.mlp import MLPClassifier
from repro_torch.core import fuzzy, noma
from repro_torch.kernels import hfl_ops
from repro_torch.models.mlp import PARAM_KEYS
from _torch_threads import one_torch_thread  # noqa: F401

SCORE_TOL = dict(atol=2e-4, rtol=1e-5)
SGD_TOL = dict(rtol=2e-5, atol=2e-6)


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


# -- fuzzy scoring -------------------------------------------------------------

def test_fuzzy_tables_match_reference():
    """Rule table, triangles, CoG grid and the host-made output memberships
    the kernel stages are the reference's, bit for bit."""
    np.testing.assert_array_equal(fuzzy.RULES, np.asarray(jfuzzy.RULES))
    np.testing.assert_array_equal(fuzzy.IN_TRIS, np.asarray(jfuzzy._IN_TRIS))
    np.testing.assert_array_equal(fuzzy.OUT_TRIS,
                                  np.asarray(jfuzzy._OUT_TRIS))
    np.testing.assert_array_equal(fuzzy.COG_GRID,
                                  np.asarray(jfuzzy._COG_GRID, np.float32))
    want_mu = np.asarray(jfuzzy.tri(jfuzzy._COG_GRID[:, None],
                                    jfuzzy._OUT_TRIS[None, :, :])).T
    np.testing.assert_array_equal(fuzzy.OUT_MU, want_mu)


def edge_case_gains(gains):
    """Exact dB ties across clients, values under the 1e-30 clamp, zeros."""
    gains = gains.copy()
    gains[::5] = gains[0]
    gains[1::7, 0] = 1e-35
    gains[2::11, -1] = 0.0
    return gains


# ``edge``: the gains of ``edge_case_gains`` and all-zero staleness (its max
# clamps to 1), int32 as the engine keeps it
@pytest.mark.parametrize("n,m,block_r,edge", [
    pytest.param(10, 3, 8, False, id="10-3-8"),
    pytest.param(64, 8, 512, False, id="64-8-512"),
    pytest.param(33, 5, 32, False, id="33-5-32"),
    pytest.param(128, 4, 128, False, id="128-4-128"),
    pytest.param(64, 4, 64, True, id="64-4-64-edge"),
    pytest.param(37, 6, 32, True, id="37-6-32-edge")])
def test_score_matrix_matches_pallas_and_jnp(n, m, block_r, edge):
    rng = np.random.default_rng(n * m)
    gains = rng.uniform(1e-12, 1e-8, (n, m)).astype(np.float32)
    counts = rng.integers(60, 120, n).astype(np.float32)
    stale = rng.integers(1, 9, n).astype(np.int32)
    if edge:
        gains, stale = edge_case_gains(gains), np.zeros(n, np.int32)
    got = hfl_ops.score_matrix(_t(gains), _t(counts), _t(stale),
                               data_max=120.0).numpy()
    want_jnp = jfuzzy.score_matrix(jnp.asarray(gains), jnp.asarray(counts),
                                   jnp.asarray(stale), data_max=120.0)
    want_pallas = jops.score_matrix(jnp.asarray(gains), jnp.asarray(counts),
                                    jnp.asarray(stale), data_max=120.0,
                                    block_r=block_r, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want_jnp), **SCORE_TOL)
    np.testing.assert_allclose(got, np.asarray(want_pallas), **SCORE_TOL)
    assert hfl_ops.LAUNCHES["score_rows"] == 0      # CPU: no kernel launch
    assert hfl_ops.LAUNCHES["score_matrix"] == 0


@pytest.mark.parametrize("rows", [1, 37, 300])
def test_score_rows_matches_reference_rows(rows):
    """Flat rows, with inputs on the membership breakpoints (0, 50, 100)
    and the CoG grid, against the reference's row function and the Pallas
    row kernel."""
    rng = np.random.default_rng(rows)
    v = rng.uniform(0.0, 100.0, (3, rows)).astype(np.float32)
    v[:, ::3] = rng.choice([0.0, 25.0, 50.0, 75.0, 100.0], (3, v[:, ::3]
                                                             .shape[1]))
    got = hfl_ops.score_rows(*(_t(x) for x in v)).numpy()
    want = np.asarray(jfuzzy.fuzzy_scores(*(jnp.asarray(x) for x in v)))
    want_pallas = jops._score_rows(*(jnp.asarray(x) for x in v),
                                   block_r=64, interp=True)
    np.testing.assert_allclose(got, want, **SCORE_TOL)
    np.testing.assert_allclose(got, np.asarray(want_pallas), **SCORE_TOL)


def test_normalized_inputs_match_reference():
    rng = np.random.default_rng(11)
    gains = rng.uniform(1e-13, 1e-7, (40, 6)).astype(np.float32)
    counts = rng.integers(200, 1200, 40).astype(np.float32)
    stale = rng.integers(1, 12, 40).astype(np.int32)
    got = fuzzy.normalized_inputs(_t(gains), _t(counts), _t(stale),
                                  data_max=1200.0)
    want = jfuzzy.normalized_inputs(jnp.asarray(gains), jnp.asarray(counts),
                                    jnp.asarray(stale), data_max=1200.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-4)


# -- SIC rates -----------------------------------------------------------------

def _pairwise_rates(p, g, mask, bandwidth_hz, noise_w):
    return np.stack(
        [np.asarray(jnoma.achievable_rates(p, g[:, j],
                                           bandwidth_hz=bandwidth_hz,
                                           noise_w=noise_w, mask=mask[:, j]))
         for j in range(g.shape[1])], axis=1)


def sic_mask(rng, n, m, kind):
    """A random 50% mask; or the engine's one-hot association (at most 4
    clients an edge) with the last edge left without a client."""
    if kind == "random":
        return rng.random((n, m)) < 0.5
    owner = rng.integers(0, m - 1, n)
    mask = np.zeros((n, m), bool)
    for e in range(m - 1):
        mask[np.flatnonzero(owner == e)[:4], e] = True
    return mask


# ``kind``: the mask of ``sic_mask``; ``ties``: every fifth client repeats
# the received power of the one before it at every edge (exact ties)
@pytest.mark.parametrize("n,m,block_n,kind,ties", [
    pytest.param(12, 3, 8, "random", False, id="12-3-8"),
    pytest.param(64, 4, 32, "random", False, id="64-4-32"),
    pytest.param(100, 7, 64, "random", False, id="100-7-64"),
    pytest.param(64, 4, 32, "one-hot", True, id="64-4-32-one-hot-ties"),
    pytest.param(40, 5, 16, "random", True, id="40-5-16-ties")])
def test_sic_rates_match_pallas_and_pairwise(n, m, block_n, kind, ties):
    rng = np.random.default_rng(n + m)
    p = rng.uniform(0.01, 0.1, n).astype(np.float32)
    g = (rng.uniform(0.1, 10.0, (n, m)) * 1e-9).astype(np.float32)
    if ties:
        p[1::5], g[1::5] = p[0::5][:len(p[1::5])], g[0::5][:len(g[1::5])]
    mask = sic_mask(rng, n, m, kind)
    noise = noma.noise_power_w(-174.0, 1e6)
    assert noise == jnoma.noise_power_w(-174.0, 1e6)
    got = hfl_ops.sic_rates(_t(p), _t(g), _t(mask), bandwidth_hz=1e6,
                            noise_w=noise).numpy()
    want = _pairwise_rates(jnp.asarray(p), jnp.asarray(g), jnp.asarray(mask),
                           1e6, noise)
    want_pallas = jops.sic_rates(jnp.asarray(p), jnp.asarray(g),
                                 jnp.asarray(mask), bandwidth_hz=1e6,
                                 noise_w=noise, block_n=block_n,
                                 interpret=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=want.max() * 1e-6)
    np.testing.assert_allclose(got, np.asarray(want_pallas), rtol=1e-5,
                               atol=want.max() * 1e-6)
    assert (got[~mask] == 0.0).all()
    assert hfl_ops.LAUNCHES["sic_rates"] == 0          # CPU: no kernel


def test_sic_rates_exact_tie_order():
    """Equal received powers: the lower client index decodes first, so it
    still hears its equal-power twin and rates strictly lower."""
    p = np.asarray([0.1, 0.1, 0.1], np.float32)
    g = np.asarray([[1e-9], [1e-9], [2e-9]], np.float32)
    mask = np.ones((3, 1), bool)
    noise = noma.noise_power_w(-174.0, 1e6)
    got = hfl_ops.sic_rates(_t(p), _t(g), _t(mask), bandwidth_hz=1e6,
                            noise_w=noise).numpy()
    want = np.asarray(jops.sic_rates(jnp.asarray(p), jnp.asarray(g),
                                     jnp.asarray(mask), bandwidth_hz=1e6,
                                     noise_w=noise, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0, 0] < got[1, 0]


# N -> the edges' cluster size: CONFIG, the reference bench's N (8 CTAs of
# 512 clients), N = 1 and 63, 600 clients (2 CTAs of 300), and N large
# enough that only 4 or 8 CTAs hold a slice
@pytest.mark.parametrize("n,cluster", [
    (64, 1), (4096, 8), (4097, 8), (1, 1), (63, 1), (600, 2), (1100, 4),
    (100_000, 8), (200_000, 8)])
def test_sic_cluster_size_is_a_function_of_n(n, cluster):
    assert hfl_ops.sic_cluster_size(n) == cluster
    assert hfl_ops.sic_smem_bytes(n, cluster) \
        + hfl_ops.SIC_STATIC_SMEM_BYTES <= hfl_ops.MAX_SMEM_BYTES


def test_sic_cluster_sizes_fit_shared_memory():
    """Every size the helper returns fits a CTA's shared memory, at every
    N up to what 8 CTAs hold; beyond that it returns 0 (the wrapper
    raises)."""
    for n in [1, 2, 31, 255, 256, 257, 1023, 4097, 27_000, 29_000, 60_000,
              150_000, 224_000]:
        c = hfl_ops.sic_cluster_size(n)
        assert c in hfl_ops.SIC_CLUSTER_SIZES, n
        assert hfl_ops.sic_smem_bytes(n, c) \
            + hfl_ops.SIC_STATIC_SMEM_BYTES <= hfl_ops.MAX_SMEM_BYTES
    assert hfl_ops.sic_cluster_size(224_001) == 0
    assert hfl_ops.sic_cluster_size(300_000) == 0


@pytest.mark.parametrize("n,m,parts", [(64, 4, 1), (4096, 32, 128),
                                       (1, 1, 1), (100_000, 32, 256),
                                       (1025, 1, 2)])
def test_score_partials_are_a_function_of_the_shape(n, m, parts):
    assert hfl_ops.score_partials(n, m) == parts


def test_score_and_sic_constants_match_the_source():
    """The wrappers' copies of the kernels' block, chunk and cluster
    constants, the SIC kernel's static shared memory within the budget
    the wrapper reserves, and both entry points' ctypes signatures."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "hfl_ops.cu").read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kScoreBlock"] == hfl_ops.SCORE_BLOCK
    assert consts["kNormBlocksMax"] == hfl_ops.SCORE_NORM_BLOCKS_MAX
    assert consts["kNormItems"] == hfl_ops.SCORE_NORM_ITEMS
    assert consts["kSicThreads"] == hfl_ops.SIC_THREADS
    assert consts["kSicChunk"] == hfl_ops.SIC_CHUNK
    assert hfl_ops.SIC_CLUSTER_SIZES == tuple(
        2 ** i for i in range(consts["kSicMaxCluster"].bit_length()))
    static = 4 * (consts["kSicChunk"]
                  + consts["kSicItems"] * consts["kSicThreads"] // 32
                  + 1 + consts["kSicMaxCluster"] + 1)
    assert static <= hfl_ops.SIC_STATIC_SMEM_BYTES
    for name in ("hfl_score_rows", "hfl_score_fused", "hfl_sic_rates"):
        assert name in _build._SIGNATURES
        assert f"int {name}(" in src


# -- the work counts behind chip_smoke.py's bounds ------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("as_torch", [False, True])
def test_sic_work_counts_each_edges_own_clients(as_torch):
    """5 clients, 3 edges with 3, 1 and 0 masked clients: 2·(9 + 1 + 0)
    pair operations and 8 a (client, edge); the gains, the 1-byte mask and
    the powers read once, the rates written once."""
    mask = np.zeros((5, 3), bool)
    mask[[0, 2, 4], 0] = True
    mask[1, 1] = True
    n_bytes, ops = _chip_smoke().sic_work(_t(mask) if as_torch else mask)
    assert ops == 2 * (9 + 1 + 0) + 8 * 3 * 5
    assert n_bytes == 4 * 15 + 15 + 4 * 5 + 4 * 15


def test_score_work_counts_the_whole_field_and_the_scored_rows():
    cs = _chip_smoke()
    tables = 4 * (9 + 5 * 201 + 27)
    norm, row = cs.SCORE_NORM_OPS_PER_PAIR, cs.SCORE_OPS_PER_ROW
    assert cs.score_fused_work(10, 4) == (
        4 * (40 + 20 + 40) + tables, 40 * norm + 40 * row)
    assert cs.score_fused_work(10, 4, 2) == (
        4 * (40 + 20 + 20 + 20) + tables, 40 * norm + 20 * row)


# -- fused local SGD -----------------------------------------------------------

def _sgd_problem(seed=3, k=4, tau1=3, batch=8, dim=16, hid=12, ncls=5):
    rng = np.random.default_rng(seed)
    model = MLPClassifier(dim, hid, ncls)
    p0 = model.init(jax.random.key(1))
    params = jax.tree.map(
        lambda l: jnp.stack([l + 0.01 * i for i in range(k)]), p0)
    bx = jnp.asarray(rng.normal(size=(tau1, k, batch, dim)), jnp.float32)
    by = jnp.asarray(rng.integers(0, ncls, size=(tau1, k, batch)), jnp.int32)
    return model, params, bx, by


def test_local_sgd_step_matches_pallas_and_autodiff():
    model, params, bx, by = _sgd_problem()
    got = hfl_ops.local_sgd_step({k: _t(v) for k, v in params.items()},
                                 _t(bx), _t(by), lr=0.1)
    want_pallas = jops.local_sgd_step(params, bx, by, lr=0.1,
                                      interpret=True)

    def one(p, xs, ys):
        def step(p, xy):
            g = jax.grad(model.loss)(p, xy)
            return jax.tree.map(lambda a, b: a - 0.1 * b, p, g), None
        return jax.lax.scan(step, p, (xs, ys))[0]
    want_grad = jax.vmap(one, in_axes=(0, 1, 1))(params, bx, by)
    for k in PARAM_KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want_pallas[k]),
                                   err_msg=k, **SGD_TOL)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want_grad[k]),
                                   err_msg=k, **SGD_TOL)


def test_local_sgd_step_leaves_inputs_untouched():
    _, params, bx, by = _sgd_problem(k=2, tau1=2)
    tp = {k: _t(v) for k, v in params.items()}
    before = {k: v.clone() for k, v in tp.items()}
    hfl_ops.local_sgd_step(tp, _t(bx), _t(by), lr=0.1)
    for k in PARAM_KEYS:
        assert torch.equal(tp[k], before[k])


def test_local_sgd_step_takes_a_fleet_of_equal_cohorts():
    """``seeds`` splits the K lanes into equal cohorts (a fleet's); it
    sets only the card's launch geometry, so on the CPU the result is the
    one-cohort call's."""
    _, params, bx, by = _sgd_problem(k=4, tau1=1)
    tp = {k: _t(v) for k, v in params.items()}
    with pytest.raises(ValueError, match="equal cohorts"):
        hfl_ops.local_sgd_step(tp, _t(bx), _t(by), lr=0.1, seeds=3)
    got = hfl_ops.local_sgd_step(tp, _t(bx), _t(by), lr=0.1, seeds=2)
    want = hfl_ops.local_sgd_step(tp, _t(bx), _t(by), lr=0.1)
    for k in PARAM_KEYS:
        assert torch.equal(got[k], want[k]), k


def test_sgd_shared_memory_fits_config():
    """A CTA of the paper config's cluster of 8 fits shared memory -- and
    under half an SM's 228 KB, so two CTAs share an SM; the wrapper's size
    check is the one the kernel launch relies on."""
    assert hfl_ops.sgd_smem_bytes(32, 784, 128, 10, 8) == 105_904
    assert hfl_ops.sgd_smem_bytes(32, 784, 128, 10, 8) \
        <= hfl_ops.MAX_SMEM_BYTES
    assert hfl_ops.sgd_smem_bytes(128, 8, 256, 10, 8) \
        > hfl_ops.MAX_SMEM_BYTES


# (K, B, D, H) -> the lanes' cluster size: the paper config (16 x 8 = 128
# CTAs), the reference bench shape (128 lanes already fill the card), H = 6
# and 12 (H % c), a lone lane of H = 16
@pytest.mark.parametrize("k,batch,d_in,hidden,cluster", [
    (16, 32, 784, 128, 8), (128, 16, 32, 16, 1), (3, 5, 7, 6, 2),
    (2, 6, 30, 12, 4), (1, 8, 30, 16, 8), (40, 9, 50, 20, 2)])
def test_sgd_cluster_size_is_a_function_of_the_shape(k, batch, d_in, hidden,
                                                     cluster):
    assert hfl_ops.sgd_cluster_size(k, batch, d_in, hidden, 10) == cluster
    assert hfl_ops.sgd_route(k, batch, d_in, hidden, 10) == \
        "hfl_local_sgd_cluster"
    assert hfl_ops.sgd_smem_bytes(batch, d_in, hidden, 10, cluster) \
        <= hfl_ops.MAX_SMEM_BYTES


def test_sgd_route_keeps_the_block_kernel_for_layers_too_wide():
    """A 70,000-wide input fits no CTA's rows of W1 at any cluster size:
    the block-per-lane kernel (weights in global memory) takes it.  A shape
    neither kernel fits raises on the card."""
    assert hfl_ops.sgd_cluster_size(1, 4, 70_000, 8, 10) == 0
    assert hfl_ops.sgd_route(1, 4, 70_000, 8, 10) == "hfl_local_sgd"
    assert hfl_ops.sgd_block_smem_bytes(4, 8, 10) <= hfl_ops.MAX_SMEM_BYTES
    assert hfl_ops.sgd_route(1, 128, 8, 256, 10) == "hfl_local_sgd"
    assert hfl_ops.sgd_block_smem_bytes(128, 256, 10) \
        > hfl_ops.MAX_SMEM_BYTES


def test_sgd_cluster_constants_match_the_source():
    """The wrapper's cluster sizes are the powers of two up to the kernel's
    kMaxCluster, and both entry points have ctypes signatures."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "hfl_ops.cu").read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert hfl_ops.SGD_CLUSTER_SIZES == tuple(
        2 ** i for i in range(consts["kMaxCluster"].bit_length()))
    for name in ("hfl_local_sgd", "hfl_local_sgd_cluster",
                 "hfl_sgd_max_active_clusters"):
        assert name in _build._SIGNATURES
        assert f"int {name}(" in src

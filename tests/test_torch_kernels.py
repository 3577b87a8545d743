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


@pytest.mark.parametrize("n,m,block_r", [
    (10, 3, 8), (64, 8, 512), (33, 5, 32), (128, 4, 128)])
def test_score_matrix_matches_pallas_and_jnp(n, m, block_r):
    rng = np.random.default_rng(n * m)
    gains = rng.uniform(1e-12, 1e-8, (n, m)).astype(np.float32)
    counts = rng.integers(60, 120, n).astype(np.float32)
    stale = rng.integers(1, 9, n).astype(np.int32)
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


@pytest.mark.parametrize("n,m,block_n", [(12, 3, 8), (64, 4, 32),
                                         (100, 7, 64)])
def test_sic_rates_match_pallas_and_pairwise(n, m, block_n):
    rng = np.random.default_rng(n + m)
    p = rng.uniform(0.01, 0.1, n).astype(np.float32)
    g = (rng.uniform(0.1, 10.0, (n, m)) * 1e-9).astype(np.float32)
    mask = rng.random((n, m)) < 0.5
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

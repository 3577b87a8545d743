"""The port's small HFL remainders held to the JAX reference on the CPU:
``fuzzy.score_clients``, ``noma.sum_rate_upper_bound`` and the serial
resolver ``association.resolve_serial``.

Tolerances: the score's Eq. 21 normalisation bit for bit (the same IEEE
division and clip), and the score at the row score's own tolerance,
atol 2e-4 / rtol 1e-5 (``tests/test_torch_kernels.py``: the port's CoG
sums run one grid point after another, as the kernel's do, where the
reference's ``jnp.sum`` sums pairwise; the port's score is bit-equal to
``score_rows`` on the same normalised inputs); the sum-rate bound
rtol 1e-6 against the reference and rtol 1e-5 against the port's SIC
sum rate (the reference's own property test,
``tests/test_noma.py``); matchings and pop counts exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import association as jassociation
from repro.core import fuzzy as jfuzzy
from repro.core import noma as jnoma
from repro_torch.core import association, fuzzy, noma
from repro_torch.kernels import hfl_ops
from _torch_threads import one_torch_thread  # noqa: F401

SCORE_TOL = dict(atol=2e-4, rtol=1e-5)
B = 1e6
NOISE = noma.noise_power_w(-174.0, B)


# -- score_clients ------------------------------------------------------------

@pytest.mark.parametrize("n,seed", [(3, 0), (64, 1), (257, 2)])
def test_score_clients_matches_reference(n, seed):
    rng = np.random.default_rng(seed)
    g = (rng.uniform(0.05, 1.2, n) * 1e-8).astype(np.float32)  # some > max
    d = rng.integers(0, 1500, n).astype(np.float32)
    s = rng.integers(0, 12, n).astype(np.float32)
    maxima = (1e-8, 1200.0, 9.0)
    kw = dict(zip(("gain_max", "data_max", "staleness_max"), maxima))
    got = fuzzy.score_clients(torch.tensor(g), torch.tensor(d),
                              torch.tensor(s), **kw)
    want = jfuzzy.score_clients(jnp.asarray(g), jnp.asarray(d),
                                jnp.asarray(s), **kw)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)
    normed = [fuzzy.normalize(torch.tensor(v), mx)
              for v, mx in zip((g, d, s), maxima)]
    for v, mx, mine in zip((g, d, s), maxima, normed):
        np.testing.assert_array_equal(
            mine.numpy(), np.asarray(jfuzzy.normalize(jnp.asarray(v), mx)))
    assert torch.equal(got, fuzzy.score_rows(*normed))
    assert hfl_ops.LAUNCHES["score_rows"] == 0          # CPU: plain rows


def test_score_clients_tensor_maxima_and_int_inputs():
    """Maxima as 0-d tensors (the data's own maxima) and integer counts,
    as the reference takes them."""
    rng = np.random.default_rng(5)
    g = (rng.uniform(0.01, 1.0, 40) * 1e-8).astype(np.float32)
    d = rng.integers(1, 1200, 40).astype(np.int32)
    s = rng.integers(0, 7, 40).astype(np.int32)
    got = fuzzy.score_clients(
        torch.tensor(g), torch.tensor(d), torch.tensor(s),
        gain_max=torch.tensor(g).max(), data_max=torch.tensor(d).max(),
        staleness_max=torch.tensor(s).max())
    want = jfuzzy.score_clients(
        jnp.asarray(g), jnp.asarray(d), jnp.asarray(s),
        gain_max=jnp.asarray(g).max(), data_max=jnp.asarray(d).max(),
        staleness_max=jnp.asarray(s).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)


# -- sum_rate_upper_bound -----------------------------------------------------

@pytest.mark.parametrize("k,seed", [(1, 0), (2, 1), (4, 2), (6, 3), (6, 4)])
def test_sum_rate_upper_bound_matches_reference_and_sic(k, seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.01, 0.1, k).astype(np.float32)
    g = (rng.uniform(0.1, 10.0, k) * 1e-9).astype(np.float32)
    got = noma.sum_rate_upper_bound(torch.tensor(p), torch.tensor(g),
                                    bandwidth_hz=B, noise_w=NOISE)
    want = jnoma.sum_rate_upper_bound(jnp.asarray(p), jnp.asarray(g),
                                      bandwidth_hz=B, noise_w=NOISE)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    rates = noma.achievable_rates(torch.tensor(p), torch.tensor(g),
                                  bandwidth_hz=B, noise_w=NOISE)
    np.testing.assert_allclose(float(rates.sum()), float(got), rtol=1e-5)


# -- resolve_serial -----------------------------------------------------------

_resolve_jax = jax.jit(jassociation.resolve_jax, static_argnums=(2, 4))


def _market(n, m, seed, ties):
    """Distances, coverage (some pairs out) and the per-edge order from a
    preference; with ``ties``, distances and preferences on a coarse grid
    so that both break ties."""
    rng = np.random.default_rng(seed)
    dist = rng.uniform(10.0, 400.0, (n, m)).astype(np.float32)
    pref = rng.uniform(0.0, 100.0, (n, m)).astype(np.float32)
    if ties:
        dist = np.round(dist / 100.0).astype(np.float32) * 100.0 + 10.0
        pref = np.round(pref / 25.0).astype(np.float32)
    cov = dist <= rng.uniform(150.0, 350.0)
    order = np.argsort(-np.where(cov, pref, -np.inf), axis=0,
                       kind="stable").T.astype(np.int32)
    return order, dist, cov


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n,m,quota", [(12, 3, 2), (20, 4, 3), (7, 5, 1),
                                       (16, 4, 16)])
def test_resolve_serial_matches_resolve_jax_and_oracle(n, m, quota, ties):
    for seed in range(4):
        order, dist, cov = _market(n, m, 100 * n + seed, ties)
        assoc, pops = association.resolve_serial(
            torch.tensor(order), torch.tensor(dist), quota,
            torch.tensor(cov), return_sweeps=True)
        want, want_pops = _resolve_jax(jnp.asarray(order), jnp.asarray(dist),
                                       quota, jnp.asarray(cov), True)
        oracle = jassociation._resolve(order, dist, quota, cov)
        msg = f"seed {seed}"
        assert assoc.dtype == torch.int32 and isinstance(pops, int)
        np.testing.assert_array_equal(assoc.numpy(), np.asarray(want),
                                      err_msg=msg)
        np.testing.assert_array_equal(assoc.numpy(), oracle, err_msg=msg)
        assert pops == int(want_pops), msg
        # the same matching as the round's parallel resolver
        np.testing.assert_array_equal(
            assoc.numpy(),
            association.resolve_parallel(torch.tensor(order),
                                         torch.tensor(dist), quota,
                                         torch.tensor(cov)).numpy(),
            err_msg=msg)
        assert torch.equal(association.resolve_serial(
            torch.tensor(order), torch.tensor(dist), quota,
            torch.tensor(cov)), assoc)


def test_resolve_serial_nobody_covered():
    order, dist, _ = _market(6, 2, 9, False)
    cov = np.zeros_like(dist, dtype=bool)
    assoc, pops = association.resolve_serial(
        torch.tensor(order), torch.tensor(dist), 2, torch.tensor(cov),
        return_sweeps=True)
    _, want_pops = _resolve_jax(jnp.asarray(order), jnp.asarray(dist), 2,
                                jnp.asarray(cov), True)
    assert int(assoc.sum()) == 0
    assert pops == int(want_pops)

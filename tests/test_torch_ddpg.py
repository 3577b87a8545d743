"""The port's DDPG allocator (paper §IV-C, Algorithm 2) on the CPU, held to
the live JAX reference.

Every random number is replayed from the reference's own key chain into
the port's explicit draws: the trainer splits ``key, k_agent`` once,
``key, k_reset`` per episode and ``key, ka, kt`` per slot (``ka`` the
exploration noise, ``kt`` the minibatch ``randint(kt, (B,), 0, size)``),
and the env splits ``k1, k2`` in ``env_reset`` and ``k1, k2(, k3)`` in
``env_step`` (``k1`` the fading field, ``k2`` the next state key, ``k3``
the dropout chain's uniforms).

* ``observe``/``observe_assigned`` bit for bit (the log-gain block within
  the ulp by which the two sides' float32 ``log`` can round apart); ``env_reset``/``env_step``
  at 8 × 2, static and with a dropout chain, at rtol 1e-6 (availability
  exactly); one ``CONFIG`` slot's bill against the reference's default
  (sorted SIC from N = 64) at rtol 1e-3 and against its pairwise SIC at
  rtol 1e-5.
* The networks, ``select_action``, the replay ring, one ``train_step``
  (every leaf at rtol 1e-5, atol 1e-6), ``train_allocator`` and the fleet
  trainer at the reference's ``_sim_setup`` (``tests/test_ddpg_env.py``),
  with the measured gaps beside the tolerances below.
* The engine: ``associate_snapshot`` exactly, ``round_step`` with a
  reference-trained actor (decisions exact, the bill at rtol 1e-5),
  ``run_fleet_actors``, and ``HFLSimulation.train_ddpg``.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.hfl_mnist import CONFIG as JCONFIG
from repro.core import cost as jcost
from repro.core import ddpg as jddpg
from repro.core import engine as jengine
from repro.core import env as jenv
from repro_torch import convert
from repro_torch.configs.hfl_mnist import CONFIG
from repro_torch.core import ddpg, engine, env
from repro_torch.core.hfl import HFLSimulation
from test_torch_scenarios import _round_draws, _start
from _torch_threads import one_torch_thread  # noqa: F401

# the reference's ``_sim_setup`` (tests/test_ddpg_env.py): 8 × 2
SIM_KW = dict(n_clients=8, n_edges=2, clients_per_edge=3, min_samples=60,
              max_samples=120, hidden=16, input_dim=32)
JSIM, SIM = (dataclasses.replace(c, **SIM_KW) for c in (JCONFIG, CONFIG))
# the engine's rounds: 16 clients on 4 edges, so K = 2 is a real frontier
ROUND_KW = dict(SIM_KW, n_clients=16, n_edges=4)
JROUND, ROUND = (dataclasses.replace(c, **ROUND_KW) for c in (JCONFIG, CONFIG))
TRAIN_KW = dict(episodes=2, steps_per_episode=8, warmup=4)
WORLDS = [pytest.param(None, "static", id="static"),
          pytest.param("full_dynamic", "dynamic", id="full_dynamic")]

# trainer against the reference from replayed draws (13 updates), measured
# on the CPU: the networks part by at most 3.6e-7 and the Adam moments by
# 9.5e-7 (abs), the episode means by 1.4e-7 (rel), from ulp-level
# differences of the two sides' products (XLA's fused program against
# torch's GEMMs) that Adam carries along
TRAIN_RTOL, TRAIN_ATOL = 1e-5, 2e-6


def _t(a):
    return None if a is None else torch.tensor(np.asarray(a))


def _spec(mod, kind="static", **kw):
    return mod.EngineSpec(policy="gcea", scheduler="fastest", scenario=kind,
                          **kw)


def _agent(jagent):
    return convert.ddpg_from_numpy(jax.tree.map(np.asarray, jagent), "cpu")


def _replay(key, dcfg, n, m, episodes, steps, drops):
    """The reference trainer's key chain as (k_agent, the port's one-world
    ``DDPGDraws``)."""
    key, k_agent = jax.random.split(key)
    resets, fading, drop_u, noise, idx = [], [], [], [], []
    t = 0
    for _ in range(episodes):
        key, k_reset = jax.random.split(key)
        k1, k_env = jax.random.split(k_reset)
        resets.append(jax.random.exponential(k1, (n, m)))
        rows = ([], [], [], [])
        for _ in range(steps):
            key, ka, kt = jax.random.split(key, 3)
            rows[2].append(jax.random.normal(ka, (dcfg.action_dim,)))
            if drops:
                k1, k_env, k3 = jax.random.split(k_env, 3)
                rows[1].append(jax.random.uniform(k3, (n,)))
            else:
                k1, k_env = jax.random.split(k_env)
            rows[0].append(jax.random.exponential(k1, (n, m)))
            t += 1
            rows[3].append(jax.random.randint(
                kt, (dcfg.batch_size,), 0, min(t, dcfg.buffer_size)))
        for out, row in zip((fading, drop_u, noise, idx), rows):
            out.append(np.stack([np.asarray(r) for r in row]) if row
                       else None)
    stack = lambda rows: None if rows[0] is None else _t(np.stack(rows))
    return k_agent, ddpg.DDPGDraws(stack([np.asarray(r) for r in resets]),
                                   stack(fading), stack(drop_u),
                                   stack(noise), stack(idx))


def _close_tree(got, want, rtol, atol, msg):
    if isinstance(want, dict):
        for k in want:
            _close_tree(got[k], want[k], rtol, atol, f"{msg}/{k}")
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


# -- the MDP -------------------------------------------------------------------

def _assoc_fields(rng, n, m):
    assigned = rng.integers(-1, m, n).astype(np.int32)
    assoc = np.zeros((n, m), np.float32)
    assoc[assigned >= 0, assigned[assigned >= 0]] = 1.0
    gains = rng.uniform(1e-14, 1e-8, (n, m)).astype(np.float32)
    gains[1] = 1e-25                          # under the 1e-20 clamp
    counts = rng.integers(60, 1200, n).astype(np.float32)
    return assigned, assoc, gains, counts


def _assert_observation(got, want, n):
    """The data-share and availability blocks bit for bit; the log-gain
    block within one ulp: it is the reference's log(x) · fl(log10(e)) / 10
    + 1 op for op, but XLA's float32 ``log`` and torch's round one ulp
    apart on 0.44% of inputs (measured over 10^5 gains, CPU)."""
    np.testing.assert_array_equal(got[n:], want[n:])
    np.testing.assert_array_max_ulp(got[:n], want[:n], maxulp=1)


@pytest.mark.parametrize("with_avail", [False, True])
def test_observe_matches_reference(with_avail):
    rng = np.random.default_rng(11)
    n, m = 12, 3
    assigned, assoc, gains, counts = _assoc_fields(rng, n, m)
    avail = ((rng.uniform(size=n) > 0.3).astype(np.float32) if with_avail
             else None)
    jav = None if avail is None else jnp.asarray(avail)
    want = np.asarray(jenv.observe(jnp.asarray(assoc), jnp.asarray(gains),
                                   jnp.asarray(counts), jav))
    got = env.observe(_t(assoc), _t(gains), _t(counts), _t(avail))
    assert got.shape == ((3 if with_avail else 2) * n,)
    _assert_observation(got.numpy(), want, n)
    own = np.take_along_axis(gains, np.maximum(assigned, 0)[:, None], 1)[:, 0]
    own = np.where(assigned >= 0, own, 0.0).astype(np.float32)
    want_c = np.asarray(jenv.observe_assigned(
        jnp.asarray(assigned), jnp.asarray(own), jnp.asarray(counts), jav))
    got_c = env.observe_assigned(_t(assigned), _t(own), _t(counts), _t(avail))
    _assert_observation(got_c.numpy(), want_c, n)
    np.testing.assert_array_equal(got_c.numpy(), got.numpy())
    # a fleet: each seed's observation is its own (a per-seed data max)
    _, assoc2, gains2, counts2 = _assoc_fields(rng, n, m)
    av2 = None if avail is None else np.ones(n, np.float32)
    fleet = env.observe(_t(np.stack([assoc, assoc2])),
                        _t(np.stack([gains, gains2])),
                        _t(np.stack([counts, counts2 * 3])),
                        None if avail is None else _t(np.stack([avail, av2])))
    assert torch.equal(fleet[0], got)
    assert torch.equal(fleet[1], env.observe(_t(assoc2), _t(gains2),
                                             _t(counts2 * 3), _t(av2)))


def _env_pair(n=8, m=2, seed=0, drops=False, noma=True, cfg=CONFIG,
              jcfg=JCONFIG, per_edge=None):
    """The reference's ``_env`` (tests/test_ddpg_env.py) and the port's
    from the same arrays; ``per_edge`` caps the clients an edge holds."""
    rng = np.random.default_rng(seed)
    assoc = np.zeros((n, m), np.float32)
    for i in range(n if per_edge is None else per_edge * m):
        assoc[i, i % m] = 1.0
    dist = jnp.asarray(rng.uniform(50.0, 300.0, (n, m)))
    counts = jnp.asarray(rng.integers(200, 1200, n).astype(np.float32))
    kw = {}
    if drops:
        kw = dict(p_drop=jnp.full((n,), 0.5), p_return=jnp.full((n,), 0.5))
    je = jenv.NomaHflEnv(jcfg, jnp.asarray(assoc), jnp.ones((m,)), dist,
                         counts, noma_enabled=noma, **kw)
    e = env.NomaHflEnv(cfg, _t(assoc), torch.ones(m), _t(dist), _t(counts),
                       noma_enabled=noma,
                       **{k: _t(v) for k, v in kw.items()})
    return je, e


@pytest.mark.parametrize("drops", [False, True], ids=["static", "dropout"])
def test_env_trajectory_matches_reference(drops):
    """Six slots from the reference's key chain: gains, observation and
    reward at rtol 1e-6, the availability exactly; the class equals the
    functions bit for bit."""
    je, e = _env_pair(drops=drops)
    n, m = 8, 2
    assert (e.state_dim, e.action_dim) == (je.state_dim, je.action_dim) \
        == ((3 if drops else 2) * n, 2 * n)
    key = jax.random.key(4)
    jst, jobs = je.reset(key)
    st, obs = e.reset(_t(jax.random.exponential(jax.random.split(key)[0],
                                                (n, m))))
    rng = np.random.default_rng(5)
    seen = set()
    for slot in range(6):
        np.testing.assert_allclose(st.gains.numpy(), np.asarray(jst.gains),
                                   rtol=1e-6, err_msg=f"slot {slot}")
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=1e-6,
                                   atol=1e-7, err_msg=f"slot {slot}")
        act = rng.uniform(size=2 * n).astype(np.float32)
        if drops:
            k1, _, k3 = jax.random.split(jst.key, 3)
            drop_u = _t(jax.random.uniform(k3, (n,)))
        else:
            k1, _ = jax.random.split(jst.key)
            drop_u = None
        fading = _t(jax.random.exponential(k1, (n, m)))
        jst, jobs, jr, _ = je.step(jst, jnp.asarray(act))
        fn = env.env_step(CONFIG, e.params, st, _t(act), fading, drop_u,
                          noma_enabled=True)
        st, obs, r, rc = e.step(st, _t(act), fading, drop_u)
        assert torch.equal(fn[1], obs) and torch.equal(fn[2], r)
        assert torch.equal(fn[0].gains, st.gains)
        assert float(r) == -float(rc.cost)
        np.testing.assert_allclose(float(r), float(jr), rtol=1e-6)
        if drops:
            np.testing.assert_array_equal(st.avail.numpy(),
                                          np.asarray(jst.avail))
            seen.add(tuple(st.avail.tolist()))
            # a dropped client leaves every observation block
            o = obs.numpy().reshape(3, n)
            assert (o[:, st.avail.numpy() == 0.0] == 0.0).all()
    assert len(seen) > 1 or not drops        # the chain really moves


def test_env_step_without_dropout_uniforms_raises():
    _, e = _env_pair(drops=True)
    st, _ = e.reset(torch.ones(8, 2))
    with pytest.raises(ValueError, match="drop_u"):
        e.step(st, torch.full((16,), 0.5), torch.ones(8, 2))


@pytest.mark.parametrize("noma", [True, False])
def test_env_bills_the_noma_switch_as_reference(noma):
    """The env bills the simulation's NOMA or OMA uplink (a port of
    ``tests/test_scenarios.py::test_env_respects_noma_switch``)."""
    je, e = _env_pair(n=SIM.n_clients, m=SIM.n_edges, seed=1, noma=noma)
    je_other, e_other = _env_pair(n=SIM.n_clients, m=SIM.n_edges, seed=1,
                                  noma=not noma)
    key = jax.random.key(0)
    fading = _t(jax.random.exponential(jax.random.split(key)[0], (8, 2)))
    act = torch.full((16,), 0.5)
    r = e.step(e.reset(fading)[0], act, fading)[2]
    r_other = e_other.step(e_other.reset(fading)[0], act, fading)[2]
    jr = je.step(je.reset(key)[0], jnp.full((16,), 0.5))[2]
    np.testing.assert_allclose(float(r), float(jr), rtol=1e-6)
    assert float(r) != float(r_other)


def test_config_slot_bill_against_both_reference_sics():
    """At ``CONFIG`` (N = 64) the reference's env bills with its sorted SIC
    (``sic_impl="auto"``), the port with the pairwise SIC (ROADMAP C1,
    C2): one slot's reward at rtol 1e-3 against the default and at rtol
    1e-5 against ``cost.round_cost(..., sic_impl="pairwise")`` on the
    reference's own env inputs (measured: equal, with four clients an
    edge)."""
    n, m = CONFIG.n_clients, CONFIG.n_edges
    je, e = _env_pair(n=n, m=m, seed=2, per_edge=CONFIG.clients_per_edge)
    key = jax.random.key(9)
    jst, _ = je.reset(key)
    st, _ = e.reset(_t(jax.random.exponential(jax.random.split(key)[0],
                                              (n, m))))
    act = np.random.default_rng(3).uniform(size=2 * n).astype(np.float32)
    _, _, jr, _ = je.step(jst, jnp.asarray(act))
    k1, _ = jax.random.split(jst.key)
    r = e.step(st, _t(act), _t(jax.random.exponential(k1, (n, m))))[2]
    np.testing.assert_allclose(float(r), float(jr), rtol=1e-3)
    p, f = je.decode_action(jnp.asarray(act))
    rc = jcost.round_cost(JCONFIG, power_w=p, f_hz=f, gains=jst.gains,
                          assoc=je.assoc, z=je.z, n_samples=je.n_samples,
                          sic_impl="pairwise")
    np.testing.assert_allclose(float(r), -float(rc.cost), rtol=1e-5)


@pytest.mark.parametrize("drops", [False, True], ids=["static", "dropout"])
def test_env_baselines_match_reference(drops):
    """fpa/fca's best actions on an env (masked by the slot's availability
    in a dropout world) exactly; rra's, fpa's and fca's fixed actions."""
    je, e = _env_pair(n=8, m=2, seed=6, drops=drops)
    gains = jax.random.gamma(jax.random.key(2), 1.0, (8, 2)) * 1e-10
    avail = np.array([1, 0, 1, 1, 0, 1, 1, 1], np.float32) if drops else None
    for fn_j, fn in ((jenv.fpa_best_action, env.fpa_best_action),
                     (jenv.fca_best_action, env.fca_best_action)):
        want = fn_j(je, gains, None if avail is None else jnp.asarray(avail))
        got = fn(e, _t(gains), _t(avail))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    u = torch.rand(8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(env.rra_action(u), u)
    a = env.fpa_action(4, torch.full((4,), 0.3))
    assert torch.equal(a[:4], torch.full((4,), 0.5))
    a = env.fca_action(4, torch.full((4,), 0.3))
    assert torch.equal(a[4:], torch.full((4,), 0.5))


# -- networks, replay, updates -------------------------------------------------

def _small_dcfg(mod, **kw):
    return mod.DDPGConfig(**{**dict(state_dim=12, action_dim=6, hidden=32,
                                    buffer_size=64, batch_size=16), **kw})


def test_networks_match_reference():
    dcfg = _small_dcfg(jddpg)
    jst = jddpg.init_ddpg(jax.random.key(1), dcfg)
    jst2 = jddpg.init_ddpg(jax.random.key(2), dcfg)
    st, st2 = _agent(jst), _agent(jst2)
    x = np.random.default_rng(0).normal(size=(5, 12)).astype(np.float32)
    a = jddpg.actor_apply(jst.actor, jnp.asarray(x))
    got = ddpg.actor_apply(st.actor, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(a), rtol=1e-6,
                               atol=1e-7)
    q = jddpg.critic_apply(jst.critic, jnp.asarray(x), a)
    got_q = ddpg.critic_apply(st.critic, _t(x), _t(a))
    assert got_q.shape == (5,)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(q), rtol=1e-5,
                               atol=1e-6)
    # a fleet of two: (S, B, in) through (S, in, out), each seed its own
    fleet = ddpg.stack_agents([st, st2])
    xs = _t(np.stack([x, x[::-1].copy()]))
    fa = ddpg.actor_apply(fleet.actor, xs)
    np.testing.assert_allclose(fa[1].numpy(), ddpg.actor_apply(
        st2.actor, xs[1]).numpy(), rtol=1e-6, atol=1e-7)
    one = ddpg.actor_apply(fleet.actor, xs[:, 0])          # one row a seed
    np.testing.assert_allclose(one.numpy(), fa[:, 0].numpy(), rtol=1e-6,
                               atol=1e-7)


def test_select_action_with_replayed_noise():
    dcfg = _small_dcfg(jddpg)
    jst = jddpg.init_ddpg(jax.random.key(3), dcfg)
    jst = jst._replace(noise_sigma=jnp.asarray(0.5))          # some clip
    obs = np.random.default_rng(1).normal(size=12).astype(np.float32)
    k = jax.random.key(7)
    want = np.asarray(jddpg.select_action(k, jst, jnp.asarray(obs)))
    got = ddpg.select_action(ddpg.stack_agents([_agent(jst)]), _t(obs)[None],
                             _t(jax.random.normal(k, (6,)))[None])[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert (want == 0.0).any() or (want == 1.0).any()


def _store_both(jst, st, dcfg, pdcfg, rows):
    for s, a, r, s2 in rows:
        jst = jddpg.store(jst, dcfg, jnp.asarray(s), jnp.asarray(a),
                          jnp.asarray(r), jnp.asarray(s2))
        st = ddpg.store(st, pdcfg, _t(s)[None], _t(a)[None],
                        torch.tensor([r]), _t(s2)[None])
    return jst, st


def test_replay_ring_wraps_as_reference():
    dcfg = jddpg.DDPGConfig(state_dim=2, action_dim=2, buffer_size=4,
                            batch_size=2)
    pdcfg = ddpg.DDPGConfig(*dcfg)
    jst = jddpg.init_ddpg(jax.random.key(0), dcfg)
    st = ddpg.stack_agents([_agent(jst)])
    rows = [(np.full(2, float(i), np.float32), np.zeros(2, np.float32),
             np.float32(i), np.zeros(2, np.float32)) for i in range(6)]
    jst, st = _store_both(jst, st, dcfg, pdcfg, rows)
    assert bool(st.buffer_full[0]) and int(st.buffer_idx[0]) == 2
    assert sorted(st.buffer["r"][0].tolist()) == [2.0, 3.0, 4.0, 5.0]
    for k in ("s", "a", "r", "s2"):
        np.testing.assert_array_equal(st.buffer[k][0].numpy(),
                                      np.asarray(jst.buffer[k]))


def test_train_step_on_empty_ring_is_a_no_op_and_wrapped_ring_trains():
    """A port of ``tests/test_ddpg_env.py::
    test_train_step_before_store_is_masked``."""
    dcfg = ddpg.DDPGConfig(state_dim=4, action_dim=2, hidden=16,
                           buffer_size=32, batch_size=8)
    st = ddpg.stack_agents([ddpg.init_ddpg(torch.Generator().manual_seed(0),
                                           dcfg)])
    idx = torch.zeros((1, 8), dtype=torch.int64)
    st2, losses = ddpg.train_step(st, dcfg, idx)
    assert st2 is st
    assert float(losses["critic_loss"][0]) == 0.0
    assert float(losses["actor_loss"][0]) == 0.0
    row = (torch.ones(1, 4), torch.full((1, 2), 0.5), torch.tensor([-1.0]),
           torch.ones(1, 4))
    st3 = ddpg.store(st, dcfg, *row)
    st4, _ = ddpg.train_step(st3, dcfg, idx)
    assert not torch.allclose(st3.actor["w0"], st4.actor["w0"])
    assert int(st4.step[0]) == 1
    for _ in range(dcfg.buffer_size):
        st3 = ddpg.store(st3, dcfg, *row)
    st3 = st3._replace(buffer_idx=torch.zeros(1, dtype=torch.int32))
    assert bool(st3.buffer_full[0])
    st5, _ = ddpg.train_step(st3, dcfg, idx)
    assert not torch.allclose(st3.critic["w0"], st5.critic["w0"])
    mixed = ddpg.stack_agents([engine.select_seed(st, 0),
                               engine.select_seed(st3, 0)])
    with pytest.raises(ValueError, match="some seeds"):
        ddpg.train_step(mixed, dcfg, idx.expand(2, 8))


def test_train_step_matches_reference():
    """One update from one converted state and the reference's own
    minibatch: every leaf of the state at rtol 1e-5, atol 1e-6 (measured:
    up to 6e-8 abs), the losses at rtol 1e-6."""
    dcfg = jddpg.DDPGConfig(state_dim=4, action_dim=2, hidden=32,
                            buffer_size=64, batch_size=16, tau=0.5)
    pdcfg = ddpg.DDPGConfig(*dcfg)
    key = jax.random.key(0)
    jst = jddpg.init_ddpg(key, dcfg)
    rng = np.random.default_rng(0)
    rows = []
    for _ in range(32):
        s = rng.normal(size=4).astype(np.float32)
        a = rng.uniform(size=2).astype(np.float32)
        rows.append((s, a, np.float32(-np.sum(a ** 2)), s))
    jst, _ = _store_both(jst, ddpg.stack_agents([_agent(jst)]), dcfg, pdcfg,
                         rows)
    st = ddpg.stack_agents([_agent(jst)])
    # two updates: the second's Adam step has t = 2 and moved moments
    for k in jax.random.split(jax.random.key(5), 2):
        idx = jax.random.randint(k, (dcfg.batch_size,), 0, 32)
        jst, jl = jddpg.train_step(k, jst, dcfg)
        st, losses = ddpg.train_step(st, pdcfg, _t(idx)[None])
        for name in ("critic_loss", "actor_loss"):
            np.testing.assert_allclose(float(losses[name][0]),
                                       float(jl[name]), rtol=1e-6)
    for name, want in jst._asdict().items():
        _close_tree(engine.select_seed(getattr(st, name), 0), want,
                    1e-5, 1e-6, name)
    assert int(st.step[0]) == 2


def test_allocator_config_matches_reference():
    for kind, dim in (("static", 2), ("dynamic", 3)):
        got = ddpg.allocator_config(SIM, _spec(engine, kind), hidden=16)
        assert tuple(got) == tuple(jddpg.allocator_config(
            JSIM, _spec(jengine, kind), hidden=16))
        assert (got.state_dim, got.action_dim) == (dim * 8, 16)


def test_ddpg_learns_simple_env():
    """Reward −(a − 0.7)²: the actor's mean action moves to 0.7 (a port of
    ``tests/test_ddpg_env.py::test_ddpg_learns_simple_env``)."""
    dcfg = ddpg.DDPGConfig(state_dim=2, action_dim=1, hidden=32,
                           actor_lr=3e-3, critic_lr=3e-3, buffer_size=512,
                           batch_size=32, noise_sigma=0.3)
    gen = torch.Generator().manual_seed(0)
    st = ddpg.stack_agents([ddpg.init_ddpg(gen, dcfg)])
    obs = torch.zeros(1, 2)
    for i in range(400):
        a = ddpg.select_action(st, obs, torch.randn((1, 1), generator=gen))
        r = -(a[:, 0] - 0.7) ** 2
        st = ddpg.store(st, dcfg, obs, a, r, obs)
        idx = torch.randint(0, min(i + 1, 512), (1, 32), generator=gen)
        if i > 64:
            st, _ = ddpg.train_step(st, dcfg, idx)
    assert abs(float(ddpg.actor_apply(st.actor, obs)[0, 0]) - 0.7) < 0.2


# -- the trainer ---------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_runs():
    """The reference's ``train_allocator`` at ``_sim_setup``, per world."""
    out = {}
    for scenario, kind in (p.values for p in WORLDS):
        jstate, jbundle, state, bundle = _start(JSIM, 0, scenario)
        jspec = _spec(jengine, kind)
        dcfg = jddpg.allocator_config(JSIM, jspec, hidden=16, buffer_size=64,
                                      batch_size=8)
        key = jax.random.key(3)
        jagent, jh = jddpg.train_allocator(JSIM, jspec, jstate, jbundle, dcfg,
                                           key, **TRAIN_KW)
        out[kind] = (jstate, jbundle, state, bundle, dcfg, key, jagent, jh)
    return out


def _assert_trained(agent, history, jagent, jh, msg):
    for k in ("episode_reward", "critic_loss", "actor_loss"):
        assert history[k].shape == np.asarray(jh[k]).shape, (msg, k)
        np.testing.assert_allclose(history[k].numpy(), np.asarray(jh[k]),
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
                                   err_msg=f"{msg} {k}")
    for name in ("actor", "critic", "target_actor", "target_critic",
                 "actor_opt", "critic_opt"):
        _close_tree(getattr(agent, name), getattr(jagent, name), TRAIN_RTOL,
                    TRAIN_ATOL, f"{msg} {name}")
    np.testing.assert_array_equal(agent.step.numpy(), np.asarray(jagent.step))
    np.testing.assert_array_equal(agent.buffer_idx.numpy(),
                                  np.asarray(jagent.buffer_idx))
    np.testing.assert_allclose(agent.noise_sigma.numpy(),
                               np.asarray(jagent.noise_sigma), rtol=1e-6)


@pytest.mark.parametrize("scenario,kind", WORLDS)
def test_train_allocator_matches_reference(reference_runs, scenario, kind):
    jstate, jbundle, state, bundle, dcfg, key, jagent, jh = \
        reference_runs[kind]
    k_agent, draws = _replay(key, dcfg, 8, 2, 2, 8, kind != "static")
    assert (draws.drop_u is not None) == (kind != "static")
    agent, history = ddpg.train_allocator(
        SIM, _spec(engine, kind), state, bundle, ddpg.DDPGConfig(*dcfg),
        _agent(jddpg.init_ddpg(k_agent, dcfg)), draws, warmup=4)
    assert int(agent.step) == 13                     # slots 4..16 trained
    _assert_trained(agent, history, jagent, jh, kind)


def test_train_allocator_fleet_matches_reference_and_each_member():
    """S = 2 worlds (full_dynamic, seeds 0 and 1) against the reference's
    ``train_allocator_fleet``, each lane's draws from its own key; every
    member also against its own ``train_allocator`` on its own slice of
    the draws, at the trainer's tolerance: the networks' products run a
    seed at a time, but on the CPU some elementwise steps
    (``env_reset``, ``select_action``) give a fleet's rows other last
    bits than one seed's row on the same inputs.  On the card a member
    is bit-equal to its own run (``chip_smoke.py``'s ``[ddpg]`` and
    ``[sweep]`` phases hold it)."""
    kind = "dynamic"
    starts = [_start(JSIM, s, "full_dynamic") for s in (0, 1)]
    jstates, jbundles = jengine.stack_fleet([(a, b) for a, b, _, _ in starts])
    states, bundles = engine.stack_fleet([(c, d) for _, _, c, d in starts])
    jspec = _spec(jengine, kind)
    dcfg = jddpg.allocator_config(JSIM, jspec, hidden=16, buffer_size=64,
                                  batch_size=8)
    keys = jax.random.split(jax.random.key(8), 2)
    jagents, jh = jddpg.train_allocator_fleet(JSIM, jspec, jstates, jbundles,
                                              dcfg, keys, **TRAIN_KW)
    replays = [_replay(keys[s], dcfg, 8, 2, 2, 8, True) for s in (0, 1)]
    draws = ddpg.DDPGDraws(*(None if f[0] is None else
                             torch.stack(f, 1 if i == 0 else 2)
                             for i, f in enumerate(zip(*(d for _, d in
                                                         replays)))))
    agents0 = ddpg.stack_agents([_agent(jddpg.init_ddpg(k, dcfg))
                                 for k, _ in replays])
    pdcfg = ddpg.DDPGConfig(*dcfg)
    agents, history = ddpg.train_allocator_fleet(
        SIM, _spec(engine, kind), states, bundles, pdcfg, agents0, draws,
        warmup=4)
    assert history["episode_reward"].shape == (2, 2)
    _assert_trained(agents, history, jagents, jh, "fleet")
    for s in (0, 1):
        own, own_h = ddpg.train_allocator(
            SIM, _spec(engine, kind), engine.select_seed(states, s),
            engine.select_seed(bundles, s), pdcfg,
            engine.select_seed(agents0, s), draws.seed(s), warmup=4)
        for k in own_h:
            np.testing.assert_allclose(history[k][s].numpy(),
                                       own_h[k].numpy(), rtol=TRAIN_RTOL,
                                       atol=TRAIN_ATOL)
        _close_tree(engine.select_seed(agents.actor, s), own.actor,
                    TRAIN_RTOL, TRAIN_ATOL, f"member {s}")


def test_sample_ddpg_draws_shapes_and_ranges():
    dcfg = ddpg.allocator_config(SIM, _spec(engine, "dynamic"), hidden=16,
                                 buffer_size=10, batch_size=4)
    gens = [torch.Generator().manual_seed(s) for s in (0, 1, 2)]
    d = ddpg.sample_ddpg_draws(SIM, dcfg, gens, 3, 5)
    assert d.reset_fading.shape == (3, 3, 8, 2)
    assert d.fading.shape == (3, 5, 3, 8, 2)
    assert d.drop_u.shape == (3, 5, 3, 8)
    assert d.noise.shape == (3, 5, 3, 16)
    assert d.batch_idx.shape == (3, 5, 3, 4)
    t = torch.arange(1, 16).reshape(3, 5)[..., None, None]
    assert bool((d.batch_idx < torch.clamp_max(t, 10)).all())
    assert bool((d.batch_idx >= 0).all())
    # each seed's draws are its own generator's, whatever the fleet
    one = ddpg.sample_ddpg_draws(SIM, dcfg, [torch.Generator().manual_seed(1)],
                                 3, 5).seed(0)
    for a, b in zip(d.seed(1), one):
        assert torch.equal(a, b)
    static = ddpg.allocator_config(SIM, _spec(engine), hidden=16)
    assert ddpg.sample_ddpg_draws(SIM, static, gens[:1], 1, 2).drop_u is None


# -- the engine ------------------------------------------------------------------

@pytest.fixture(scope="module")
def advanced_worlds():
    """The reference's state at ``ROUND`` (16 × 4) after two gcea rounds,
    static and full_dynamic, with the port's copy of it."""
    out = {}
    for scenario, kind in (p.values for p in WORLDS):
        jstate, jbundle, _, _ = _start(JROUND, 0, scenario)
        for _ in range(2):
            jstate, _ = jengine.round_step_jit(JROUND, _spec(jengine, kind),
                                               jstate, jbundle)
        snp = jax.tree.map(np.asarray, jstate._replace(key=None))
        state, bundle = convert.state_from_numpy(
            snp, jax.tree.map(np.asarray, jbundle), "cpu")
        out[kind] = (jstate, jbundle, state, bundle)
    return out


@pytest.mark.parametrize("scenario,kind", WORLDS)
@pytest.mark.parametrize("k", [None, 2], ids=["dense", "k2"])
@pytest.mark.parametrize("policy", ["fcea", "gcea", "rcea"])
def test_associate_snapshot_matches_reference(advanced_worlds, scenario,
                                              kind, k, policy):
    jstate, jbundle, state, bundle = advanced_worlds[kind]
    kw = dict(policy=policy, scheduler="fastest", scenario=kind,
              candidates_k=k)
    jspec, spec = jengine.EngineSpec(**kw), engine.EngineSpec(**kw)
    want = np.asarray(jengine.associate_snapshot(JROUND, jspec, jstate,
                                                 jbundle), np.float32)
    assoc_u = None
    if policy == "rcea":
        k_assoc = jengine.round_keys(jspec, jstate.key)[3]
        assoc_u = _t(jax.random.uniform(k_assoc, (16, 4)))
    got = engine.associate_snapshot(ROUND, spec, state, bundle, assoc_u)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


@pytest.fixture(scope="module")
def trained_actors(advanced_worlds):
    """A reference actor trained (1 × 8 slots) on each advanced world."""
    out = {}
    for kind, (jstate, jbundle, _, _) in advanced_worlds.items():
        jspec = _spec(jengine, kind, allocator="ddpg")
        agent, _ = jddpg.train_allocator(JROUND, jspec, jstate, jbundle,
                                         None, jax.random.key(1),
                                         episodes=1, steps_per_episode=8,
                                         warmup=4, hidden=16)
        out[kind] = agent.actor
    return out


def _assert_round(got, want, msg, n_test):
    np.testing.assert_array_equal(got["z"], want["z"], msg)
    for key in ("round", "n_associated", "n_available", "avg_staleness"):
        assert got[key] == want[key], (msg, key)
    for key in ("cost", "total_time_s", "total_energy_j"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=f"{msg} {key}")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4,
                               err_msg=msg)
    assert abs(got["accuracy"] - want["accuracy"]) <= 2.0 / n_test, msg


@pytest.mark.parametrize("scenario,kind", WORLDS)
@pytest.mark.parametrize("k", [None, 2], ids=["dense", "k2"])
def test_ddpg_round_matches_reference(advanced_worlds, trained_actors,
                                      scenario, kind, k):
    """Two ``round_step`` rounds billed by a reference-trained actor
    against ``round_step_jit``: decisions exact, the bill at rtol 1e-5;
    the actor really moved the bill off the ``mid`` one."""
    jstate, jbundle, state, bundle = advanced_worlds[kind]
    kw = dict(policy="gcea", scheduler="fastest", scenario=kind,
              candidates_k=k)
    jspec = jengine.EngineSpec(allocator="ddpg", **kw)
    spec = engine.EngineSpec(allocator="ddpg", **kw)
    jactor = trained_actors[kind]
    actor = convert.actor_from_numpy(jax.tree.map(np.asarray, jactor), "cpu")
    n_test = int(jbundle.test_y.shape[0])
    for r in range(2):
        draws = _round_draws(JROUND, jspec, jstate, jbundle)
        _, mid = engine.round_step(ROUND, engine.EngineSpec(**kw), state,
                                   bundle, draws)
        jstate, jm = jengine.round_step_jit(JROUND, jspec, jstate, jbundle,
                                            jactor)
        state, m = engine.round_step(ROUND, spec, state, bundle, draws, actor)
        want, got = jengine.metrics_row(jm), engine.metrics_row(m)
        _assert_round(got, want, f"{kind} k={k} round {r}", n_test)
        assert got["cost"] != engine.metrics_row(mid)["cost"]
    np.testing.assert_array_equal(state.staleness.numpy(),
                                  np.asarray(jstate.staleness))


@pytest.mark.parametrize("k", [None, 2], ids=["dense", "k2"])
def test_ddpg_without_actor_is_mid_bit_for_bit(k):
    state, bundle, aux = engine.init_simulation(ROUND, seed=1, device="cpu",
                                                scenario="full_dynamic")
    kw = dict(scenario="dynamic", candidates_k=k)
    out = []
    for allocator in ("mid", "ddpg"):
        spec = engine.EngineSpec(allocator=allocator, **kw)
        out.append(engine.run_scanned(ROUND, spec, state, bundle, 2,
                                      torch.Generator().manual_seed(4)))
    (s_mid, m_mid), (s_ddpg, m_ddpg) = out
    for a, b in zip(m_mid, m_ddpg):
        assert torch.equal(a, b)
    for k_, leaf in s_mid.global_params.items():
        assert torch.equal(leaf, s_ddpg.global_params[k_])


def test_run_fleet_actors_matches_reference():
    """S = 3 seeds, one actor each, against the reference's
    ``run_fleet_actors``: each lane's draws from its own key chain into
    ``fleet_step``, decisions exact, the bill at rtol 1e-5."""
    rounds, seeds = 2, (0, 1, 2)
    jspec = _spec(jengine, allocator="ddpg")
    spec = _spec(engine, allocator="ddpg")
    starts = [_start(JROUND, s, None) for s in seeds]
    jstates, jbundles = jengine.stack_fleet([(a, b) for a, b, _, _ in starts])
    states, bundles = engine.stack_fleet([(c, d) for _, _, c, d in starts])
    dcfg = jddpg.allocator_config(JROUND, jspec, hidden=16)
    jactors = jax.tree.map(lambda *l: jnp.stack(l), *(
        jddpg.init_ddpg(jax.random.key(20 + s), dcfg).actor for s in seeds))
    jfinal, jm = jengine.run_fleet_actors(JROUND, jspec, jstates, jbundles,
                                          rounds, jactors)
    actors = convert.actor_from_numpy(jax.tree.map(np.asarray, jactors),
                                      "cpu")
    assert actors["w0"].shape == (3, 32, 16)
    keys = [jstates.key[s] for s in range(len(seeds))]
    n_test = int(jbundles.test_y.shape[1])
    for r in range(rounds):
        rows = [_round_draws(JROUND, jspec, SimpleNamespace(key=keys[s]),
                             jax.tree.map(lambda a: a[s], jbundles))
                for s in range(len(seeds))]
        draws = engine._map(lambda *t: torch.stack(t), *rows)
        keys = [jengine.round_keys(jspec, k)[0] for k in keys]
        states, m = engine.fleet_step(ROUND, spec, states, bundles, draws,
                                      actors)
        for s in range(len(seeds)):
            want = jengine.metrics_row(jax.tree.map(lambda a: a[s], jm), r)
            _assert_round(engine.metrics_row(engine.select_seed(m, s)), want,
                          f"seed {s} round {r}", n_test)
    np.testing.assert_array_equal(states.staleness.numpy(),
                                  np.asarray(jfinal.staleness))


def test_run_fleet_actors_members_follow_their_own_runs():
    """Each member of ``run_fleet_actors`` follows its own ``run_scanned``
    with its own actor from the same generator; ``run_fleet`` with one
    shared actor is ``run_fleet_actors`` with that actor in every lane."""
    spec = _spec(engine, allocator="ddpg")
    dcfg = ddpg.allocator_config(ROUND, spec, hidden=16)
    seeds = (0, 3)
    actors = [ddpg.init_ddpg(torch.Generator().manual_seed(30 + s),
                             dcfg).actor for s in seeds]
    pairs, own = [], []
    for s, actor in zip(seeds, actors):
        state, bundle, _ = engine.init_simulation(ROUND, seed=s, device="cpu")
        pairs.append((state, bundle))
        own.append(engine.run_scanned(ROUND, spec, state, bundle, 2,
                                      torch.Generator().manual_seed(s),
                                      actor))
    states, bundles = engine.stack_fleet(pairs)
    gens = lambda: [torch.Generator().manual_seed(s) for s in seeds]
    _, fm = engine.run_fleet_actors(ROUND, spec, states, bundles, 2, gens(),
                                    ddpg.stack_agents(actors))
    for s, (_, om) in enumerate(own):
        for i in range(2):
            got = engine.metrics_row(engine.select_seed(fm, s), i)
            want = engine.metrics_row(om, i)
            np.testing.assert_array_equal(got["z"], want["z"])
            for key in ("cost", "total_time_s", "total_energy_j", "loss"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    _, shared = engine.run_fleet(ROUND, spec, states, bundles, 2, gens(),
                                 actors[0])
    _, lanes = engine.run_fleet_actors(ROUND, spec, states, bundles, 2,
                                       gens(),
                                       ddpg.stack_agents([actors[0]] * 2))
    for a, b in zip(shared, lanes):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


# -- the wrapper ---------------------------------------------------------------

@pytest.mark.parametrize("scenario", [None, "full_dynamic"])
def test_hfl_train_ddpg_then_rounds_bill_the_actor(scenario):
    """``train_ddpg`` returns the reference's list-of-floats history; the
    next round is billed by the trained actor (its bill is the engine's
    round with that actor, not the ``mid`` one)."""
    sim = HFLSimulation(SIM, seed=6, policy="gcea", scheduler="fastest",
                        allocator="ddpg", scenario=scenario, device="cpu")
    assert (sim.policy, sim.allocator, sim.scheduler, sim.noma_enabled) == \
        ("gcea", "ddpg", "fastest", True)
    hist = sim.train_ddpg(episodes=3, steps_per_episode=10, warmup=16,
                          hidden=32)
    assert set(hist) == {"episode_reward", "critic_loss", "actor_loss"}
    assert all(len(v) == 3 and all(np.isfinite(v)) for v in hist.values())
    assert isinstance(hist["episode_reward"][0], float)
    assert sim.agent_cfg.state_dim == (3 if scenario else 2) * 8
    assert int(sim.agent.step) == 3 * 10 - 16 + 1
    state, gen_state = sim.state, sim.generator.get_state()
    m = sim.run_round()
    gen = torch.Generator().set_state(gen_state)
    draws = engine.sample_draws(SIM, sim.bundle, gen, sim.spec)
    _, m_actor = engine.round_step(SIM, sim.spec, state, sim.bundle, draws,
                                   sim.agent.actor)
    _, m_mid = engine.round_step(SIM, sim.spec, state, sim.bundle, draws)
    assert m.cost == float(m_actor.cost) != float(m_mid.cost)
    assert sim.gains is sim.state.gains
    assert sim.staleness is sim.state.staleness
    assert sim.global_params is sim.state.global_params
    assert sim.client_params is sim.state.client_params
    assert sim._associate().shape == (8, 2)


def test_hfl_train_ddpg_bills_oma():
    """``train_ddpg``'s env bills the simulation's NOMA or OMA uplink: the
    same seed and draws earn other rewards."""
    rewards = {}
    for noma in (True, False):
        sim = HFLSimulation(SIM, seed=2, policy="rcea", scheduler="fastest",
                            allocator="ddpg", noma_enabled=noma,
                            device="cpu")
        rewards[noma] = sim.train_ddpg(episodes=1, steps_per_episode=4,
                                       warmup=2, hidden=16)["episode_reward"]
        # rcea's snapshot draws from a copy of the generator
        before = sim.generator.get_state()
        assert sim._associate().sum() > 0
        assert torch.equal(sim.generator.get_state(), before)
    assert rewards[True] != rewards[False]

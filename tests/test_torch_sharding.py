"""The HFL engine across processes: the seed axis (``run_fleet_sharded``)
and the client axis (``pad_clients``, ``shard_clients``,
``run_scanned_client_sharded``) over ``torch.distributed``, with the
streaming drivers and the sharded sweep runner, on the CPU.

* A world of one (no process group): each sharded driver is its
  unsharded driver, bit for bit, sync, buffered and under chaos.
* ``shard_clients``'s placement: a rank holds N / W rows of
  ``client_params`` and of the buffer's ``pending_delta``, every other
  buffer and fault leaf whole; the quarantine of a rank's rows and the
  landing's zero rows are bit-equal to the whole stack's.
* ``pad_clients`` against the live reference's, every leaf exact
  (``SMALL`` 16 → multiple 5 → 20, and 18 → multiple 4 → 20, with the
  buffer, the fault ledger and the warm seed attached); the pads never
  associate and the padded world runs dense and at K = 2; one padded
  round of the port against the reference's ``round_step`` with its
  draws replayed, at ``tests/test_torch_engine.py``'s tolerances.
* Four gloo ranks (``core.mesh.spawn``, one spawn for the module): every
  case's metrics, trace, stream, final state (the client axis's rows of
  ``client_params`` and ``pending_delta`` gathered) and generator states
  on every rank bit-equal to the port's unsharded run of the same
  (padded) world from the same generator state; the buffered and chaos
  cases show the merges, retiers and fault events they claim.  No
  tolerance is needed: each lane is trained by one batched call whatever
  the number of lanes beside it (the plain SGD's batched matmuls, on one
  thread, give each lane the same bits), every reduction over clients
  runs on the unsharded stack's shape, and everything else is replicated
  from the same inputs.
* The same four ranks against the reference's own sharded drivers
  (``run_scanned_client_sharded`` and ``run_fleet_sharded`` on a forced
  4-device CPU mesh, in a child process as ``tests/test_client_sharding.py``
  runs them): the port's sharded stages on the reference's world, each
  round's draws replayed from the reference's key chain (the fault
  uniforms as ``tests/test_torch_faults.py`` replays them), at
  ``tests/test_torch_engine.py``'s tolerances, integers, the buffer's
  integers and every ``FaultState`` leaf exactly.

The ranks run ``tests/_torch_sharding_ranks.py``'s ``rank_main``.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.faults import FaultSpec as JFaultSpec
from repro.faults import inject as jinject
from repro_torch import convert
from repro_torch.core import aggregation, engine
from repro_torch.core.mesh import (Mesh, client_mesh, fleet_mesh, make_mesh,
                                   spawn)
from repro_torch.faults import FaultSpec, FaultState, guard
from repro_torch.launch import sharded
from repro_torch.sweeps import SweepGrid, run_sweep
from test_torch_engine import JSMALL, SMALL, _replayed_draws
from _torch_sharding_ranks import landed_inputs, rank_main
from _torch_threads import one_torch_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

RANKS = 4
ROUNDS = 2
BUF_KW = dict(policy="gcea", scheduler="fastest", engine_mode="buffered",
              n_tiers=2, retier_every=3, timeout_s=5.0)
SPEC_BUF = engine.EngineSpec(**BUF_KW, telemetry=True)
RAGGED = dataclasses.replace(SMALL, n_clients=18)
FLEET = tuple(range(6))          # ragged over 4 ranks: blocks of 2
# chaos (``tests/test_torch_faults.py``'s) with NaN poisoning at 0.3, so
# that the sync round's quarantine rejects some delta within 3 rounds
CHAOS = dict(edge_p_kill=0.2, edge_p_respawn=0.5, uplink_p_loss=0.1,
             uplink_loss_slope=0.2, client_p_crash=0.05, p_poison=0.3,
             poison_nan=True)
SPEC_CHAOS = engine.EngineSpec(policy="fcea", scheduler="fastest",
                               faults=FaultSpec(**CHAOS), telemetry=True)

JOBS = {
    "fleet-gcea-fastest": sharded.Job(
        "fleet", SMALL, engine.EngineSpec(policy="gcea",
                                          scheduler="fastest"),
        ROUNDS, FLEET),
    "fleet-fcea-pdd": sharded.Job(
        "fleet", SMALL, engine.EngineSpec(), ROUNDS, FLEET),
    "fleet-buffered-streamed": sharded.Job(
        "fleet", SMALL, SPEC_BUF, 4, FLEET, stream=True),
    "clients-fcea-fastest-k2": sharded.Job(
        "clients", SMALL, engine.EngineSpec(scheduler="fastest",
                                            candidates_k=2), ROUNDS),
    "clients-gcea-dense": sharded.Job(
        "clients", SMALL, engine.EngineSpec(policy="gcea"), ROUNDS),
    "clients-rcea-rra": sharded.Job(
        "clients", SMALL, engine.EngineSpec(policy="rcea", allocator="rra",
                                            scheduler="fastest"), ROUNDS),
    "clients-random-waypoint": sharded.Job(
        "clients", SMALL, engine.EngineSpec(scenario="dynamic"), ROUNDS,
        (1,), "random_waypoint"),
    "clients-warm-k2": sharded.Job(
        "clients", SMALL, engine.EngineSpec(scenario="dynamic",
                                            candidates_k=2, warm_start=True),
        3, (0,), "random_waypoint"),
    "clients-telemetry-streamed": sharded.Job(
        "clients", SMALL, engine.EngineSpec(telemetry=True), ROUNDS,
        stream=True),
    "clients-ragged-18": sharded.Job(
        "clients", RAGGED, engine.EngineSpec(scheduler="fastest"), ROUNDS),
    "clients-ragged-ddpg-oma": sharded.Job(
        "clients", RAGGED, engine.EngineSpec(allocator="ddpg",
                                             noma_enabled=False), ROUNDS,
        actor_hidden=16),
    "clients-buffered-streamed": sharded.Job(
        "clients", SMALL, SPEC_BUF, 6, stream=True),
    "clients-buffered-k2-markov-dropout": sharded.Job(
        "clients", SMALL, engine.EngineSpec(
            candidates_k=2, engine_mode="buffered", scenario="dynamic",
            retier_every=3, telemetry=True), 6, (0,), "markov_dropout"),
    "clients-chaos-sync": sharded.Job("clients", SMALL, SPEC_CHAOS, 3),
    "clients-ragged-buffered-chaos": sharded.Job(
        "clients", RAGGED, dataclasses.replace(SPEC_BUF,
                                               faults=FaultSpec(**CHAOS)), 8),
}
# what each buffered or faulted job must show it ran: merges and retiers
# (buffered), fault events (faults)
EXERCISED = [name for name, job in JOBS.items()
             if job.axis == "clients" and (job.spec.faults is not None
                                           or job.spec.engine_mode
                                           == "buffered")]
SWEEP = dict(name="t", scenarios=("static", "markov_dropout"),
             policies=("gcea",), schedulers=("fastest",),
             allocators=("mid", "ddpg"), seeds=(0, 1, 2), n_rounds=2,
             telemetry=True, ddpg_episodes=1, ddpg_steps=4, ddpg_warmup=2,
             ddpg_hidden=16)


# the reference's sharded drivers against the port's sharded stages, on
# the reference's world (16 clients, 18 → 20, and a fleet of FLEET seeds),
# each round's draws replayed: axis, N, the spec's options
REPLAY_ROUNDS = 2
REPLAY_STEPS = {"clients-buffered": 6}      # others: REPLAY_ROUNDS
REPLAYS = {
    "clients-fcea-fastest-k2": ("clients", 16, dict(scheduler="fastest",
                                                    candidates_k=2)),
    "clients-gcea-dense": ("clients", 16, dict(policy="gcea")),
    "clients-rcea-rra": ("clients", 16, dict(policy="rcea", allocator="rra",
                                             scheduler="fastest")),
    "clients-ragged-18-oma": ("clients", 18, dict(noma_enabled=False)),
    "fleet-gcea-fastest": ("fleet", 16, dict(policy="gcea",
                                             scheduler="fastest")),
    "fleet-fcea-pdd": ("fleet", 16, {}),
    "clients-buffered": ("clients", 16, BUF_KW),
    "clients-chaos-sync": ("clients", 16, dict(scheduler="fastest",
                                               faults=CHAOS)),
}
# the buffer's leaves held exactly, as ``tests/test_torch_buffered.py``
# holds them
BUFFER_EXACT = ("in_flight", "tier", "pulled_ver", "fill", "version", "step")
# the buffered landing's sums on four ranks (``landed_sums``)
LANDED_CASE = dict(n=16, seed=5)

# run in a child process: the placeholder devices' XLA_FLAGS must be set
# before jax imports and must not reach this process
_REFERENCE_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json, pickle, sys
import jax
import numpy as np
from repro.configs.hfl_mnist import CONFIG
from repro.core import engine
from repro.faults import FaultSpec

assert len(jax.devices()) == 4
args = json.loads(sys.argv[1])
small = dataclasses.replace(CONFIG, **args["small"])
out = {}
for name, (axis, n, kw) in args["cases"].items():
    cfg = dataclasses.replace(small, n_clients=n)
    if "faults" in kw:
        kw = dict(kw, faults=FaultSpec(**kw["faults"]))
    spec = engine.EngineSpec(**kw)
    rounds = args["rounds"].get(name, args["default_rounds"])
    if axis == "clients":
        state, bundle, _ = engine.init_simulation(cfg, seed=0)
        final, ms = engine.run_scanned_client_sharded(cfg, spec, state,
                                                      bundle, rounds)
        rows = [engine.metrics_row(ms, r) for r in range(rounds)]
    else:
        starts = [engine.init_simulation(cfg, seed=s)[:2]
                  for s in args["seeds"]]
        states, bundles = engine.stack_fleet(starts)
        final, ms = engine.run_fleet_sharded(cfg, spec, states, bundles,
                                             rounds)
        rows = [[engine.metrics_row(jax.tree.map(lambda a: a[s], ms), r)
                 for s in range(len(args["seeds"]))] for r in range(rounds)]
        bundle = bundles
    extra = {}
    if axis == "clients" and final.buffer is not None:
        extra.update({f"buffer.{k}": np.asarray(getattr(final.buffer, k))
                      for k in args["buffer_exact"]})
    if axis == "clients" and final.faults is not None:
        extra.update({f"faults.{k}": np.asarray(v) for k, v in
                      zip(final.faults._fields, final.faults)})
    out[name] = (rows, {k: np.asarray(v)
                        for k, v in final.global_params.items()},
                 np.asarray(final.staleness), int(bundle.test_y.shape[-1]),
                 extra)
with open(args["out"], "wb") as fh:
    pickle.dump(out, fh)
"""


def _port_world(jstate, jbundle):
    return convert.state_from_numpy(
        jax.tree.map(np.asarray, jstate._replace(key=None, scenario=None)),
        jax.tree.map(np.asarray, jbundle), "cpu")


def _ref_fault_draws(jspec, key, n, m):
    """The reference round's fault uniforms from its round key, as
    ``tests/test_torch_faults.py`` replays them: ``split(fault_key(
    k_fade), 4)``, each ``uniform(k, shape)``."""
    k_fade = jengine.round_keys(jspec, key)[2]
    ks = jax.random.split(jinject.fault_key(k_fade), 4)
    return engine.FaultDraws(*(torch.tensor(np.asarray(
        jax.random.uniform(k, (size,)))) for k, size in zip(ks,
                                                            (m, n, n, n))))


def _specs(kw):
    """The reference's and the port's EngineSpec of a ``REPLAYS`` case
    (its ``faults`` a dict of ``FaultSpec`` fields)."""
    if "faults" not in kw:
        return jengine.EngineSpec(**kw), engine.EngineSpec(**kw)
    return (jengine.EngineSpec(**dict(kw, faults=JFaultSpec(**kw["faults"]))),
            engine.EngineSpec(**dict(kw, faults=FaultSpec(**kw["faults"]))))


def _replay_case(name, axis, n, kw):
    """The port's inputs of one ``REPLAYS`` case: the reference's world
    (a fleet's stacked) and each round's draws from its key chain (the
    client axis's for the world padded to a multiple of the ranks, as the
    reference's ``run_scanned_client_sharded`` pads it)."""
    jcfg = dataclasses.replace(JSMALL, n_clients=n)
    jspec, spec = _specs(kw)
    starts = [jengine.init_simulation(jcfg, seed=s)[:2]
              for s in (FLEET if axis == "fleet" else (0,))]
    ports = [_port_world(*start) for start in starts]
    if axis == "clients":
        jcfg, jstate, jbundle = jengine.pad_clients(jcfg, *starts[0], RANKS)
        starts = [(jstate, jbundle)]
    keys = [jstate.key for jstate, _ in starts]
    draws = []
    for _ in range(REPLAY_STEPS.get(name, REPLAY_ROUNDS)):
        rows = [_replayed_draws(jcfg, jspec, SimpleNamespace(key=k), jb)
                for k, (_, jb) in zip(keys, starts)]
        if jspec.faults is not None:
            rows = [d._replace(faults=_ref_fault_draws(
                jspec, k, jcfg.n_clients, jcfg.n_edges))
                for d, k in zip(rows, keys)]
        keys = [jengine.round_keys(jspec, k)[0] for k in keys]
        draws.append(rows[0] if axis == "clients" else engine.RoundDraws(
            *(None if f[0] is None else torch.stack(f) for f in zip(*rows))))
    state, bundle = (ports[0] if axis == "clients"
                     else engine.stack_fleet(ports))
    return dict(axis=axis, cfg=dataclasses.replace(SMALL, n_clients=n),
                spec=spec, state=state, bundle=bundle, draws=draws)


@pytest.fixture(scope="module", autouse=True)
def _ranks_started(tmp_path_factory):
    """Every job, the sweep and the replays in one spawn of four gloo
    ranks, and the reference's sharded runs in a child process, both
    started when the module starts, so that they run while this process
    runs the other tests."""
    out = tmp_path_factory.mktemp("sweep")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    small = {k: getattr(JSMALL, k) for k in (
        "n_clients", "n_edges", "clients_per_edge", "min_samples",
        "max_samples", "hidden", "input_dim")}
    references = []
    for axis in ("clients", "fleet"):      # one child an axis, side by side
        path = out / f"reference-{axis}.pkl"
        references.append((subprocess.Popen(
            [sys.executable, "-c", _REFERENCE_SCRIPT, json.dumps(dict(
                small=small, default_rounds=REPLAY_ROUNDS,
                rounds=REPLAY_STEPS, buffer_exact=BUFFER_EXACT, seeds=FLEET,
                out=str(path), cases={k: v for k, v in REPLAYS.items()
                                      if v[0] == axis}))],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), path))
    replays = [_replay_case(name, *case) for name, case in REPLAYS.items()]
    box = {}

    def run():
        try:
            box["results"] = spawn(
                rank_main, RANKS, backend="gloo", device="cpu",
                args=(list(JOBS.values()),
                      (SMALL, SweepGrid(**SWEEP), str(out / "sharded")),
                      replays, LANDED_CASE),
                timeout_s=240)
        except BaseException as exc:  # noqa: BLE001 -- re-raised below
            box["error"] = exc

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    yield thread, box, out, references
    thread.join()
    for reference, _ in references:
        if reference.poll() is None:
            reference.kill()
        reference.communicate()


@pytest.fixture(scope="module")
def four_ranks(_ranks_started):
    thread, box, out, _ = _ranks_started
    thread.join()
    if "error" in box:
        raise box["error"]
    return box["results"], out


@pytest.fixture(scope="module")
def reference_sharded(_ranks_started):
    runs = {}
    for reference, path in _ranks_started[3]:
        _, err = reference.communicate(timeout=300)
        assert reference.returncode == 0, err[-3000:]
        with open(path, "rb") as fh:
            runs.update(pickle.load(fh))
    return runs


def _assert_outputs_equal(got, want, msg):
    assert sorted(got) == sorted(want), msg
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], f"{msg}: {k}")


# ---------------------------------------------------------------------------
# a world of one
# ---------------------------------------------------------------------------

def test_meshes_of_one_process():
    for make, axis in ((fleet_mesh, "fleet"), (client_mesh, "clients")):
        mesh = make("cpu")
        assert (mesh.axis, mesh.rank, mesh.world, mesh.group) == \
            (axis, 0, 1, None)
        assert mesh.device == torch.device("cpu")
        t = torch.arange(6.0).reshape(3, 2)
        assert mesh.all_gather(t) is t and mesh.all_ok(True)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        make_mesh("seeds", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fleet_mesh()             # the card unless the CPU is asked for


def _fleet_inputs(seeds=(0, 1, 2)):
    built = [engine.init_simulation(SMALL, seed=s, device="cpu")
             for s in seeds]
    states, bundles = engine.stack_fleet([(s, b) for s, b, _ in built])
    return states, bundles, [aux["generator"] for _, _, aux in built]


def test_world_of_one_fleet_is_run_fleet():
    spec = engine.EngineSpec(telemetry=True)
    states, bundles, gens = _fleet_inputs()
    want_gens = [torch.Generator().set_state(g.get_state()) for g in gens]
    final, out = engine.run_fleet_sharded(SMALL, spec, states, bundles,
                                          ROUNDS, gens,
                                          mesh=fleet_mesh("cpu"))
    want_final, want_out = engine.run_fleet(SMALL, spec, states, bundles,
                                            ROUNDS, want_gens)
    got = sharded._outputs(spec, final, out, gens, None, False)
    want = sharded._outputs(spec, want_final, want_out, want_gens, None,
                            False)
    _assert_outputs_equal(got, want, "world of one, fleet")


def test_world_of_one_clients_is_run_scanned():
    spec = engine.EngineSpec(scheduler="fastest", candidates_k=2)
    state, bundle, aux = engine.init_simulation(SMALL, seed=0, device="cpu")
    gen = aux["generator"]
    want_gen = torch.Generator().set_state(gen.get_state())
    final, out = engine.run_scanned_client_sharded(
        SMALL, spec, state, bundle, ROUNDS, gen, mesh=client_mesh("cpu"))
    want_final, want_out = engine.run_scanned(SMALL, spec, state, bundle,
                                              ROUNDS, want_gen)
    got = sharded._outputs(spec, final, out, [gen], None, False)
    want = sharded._outputs(spec, want_final, want_out, [want_gen], None,
                            False)
    _assert_outputs_equal(got, want, "world of one, clients")


def test_a_rank_generator_draws_the_round_of_its_source():
    """A rank's generator, set to the source's state on the rank's
    device, draws the same ``RoundDraws`` (every field of a dynamic rcea
    + rra round)."""
    spec = engine.EngineSpec(policy="rcea", allocator="rra",
                             scenario="dynamic")
    _, bundle, aux = engine.init_simulation(SMALL, seed=2, device="cpu",
                                            scenario="full_dynamic")
    gen = aux["generator"]
    twin = engine._rank_generator(gen, torch.device("cpu"))
    want = engine.sample_draws(SMALL, bundle, gen, spec)
    got = engine.sample_draws(SMALL, bundle, twin, spec)
    for field, a, b in zip(want._fields, got, want):
        if b is not None:
            assert torch.equal(a, b), field
    with pytest.raises(ValueError, match="generator cannot draw"):
        engine._rank_generator(gen, torch.device("meta"))


@pytest.mark.parametrize("spec", [
    SPEC_BUF, SPEC_CHAOS,
    dataclasses.replace(SPEC_BUF, faults=FaultSpec(**CHAOS))],
    ids=["buffered", "chaos", "buffered-chaos"])
def test_world_of_one_clients_buffered_and_chaos_are_run_scanned(spec):
    state, bundle, aux = engine.init_simulation(SMALL, seed=0, device="cpu")
    gen = aux["generator"]
    want_gen = torch.Generator().set_state(gen.get_state())
    final, out = engine.run_scanned_client_sharded(
        SMALL, spec, state, bundle, 6, gen, mesh=client_mesh("cpu"))
    want_final, want_out = engine.run_scanned(SMALL, spec, state, bundle, 6,
                                              want_gen)
    got = sharded._outputs(spec, final, out, [gen], None, False)
    want = sharded._outputs(spec, want_final, want_out, [want_gen], None,
                            False)
    _assert_outputs_equal(got, want, f"world of one, clients, {spec}")


def _rank_mesh(rank, world):
    """Rank ``rank`` of a client mesh of ``world`` without a process
    group: ``shard_clients`` reads only its rank, world and device."""
    return Mesh("clients", None, rank, world, torch.device("cpu"))


def test_shard_clients_places_pending_delta_rows():
    """A rank holds N / W rows of ``client_params`` and of the buffer's
    ``pending_delta`` (its own block), every other buffer and fault leaf
    whole; a buffer attached after the split shapes its ``pending_delta``
    from the rank's rows."""
    spec = dataclasses.replace(SPEC_BUF, faults=FaultSpec(**CHAOS))
    state, bundle, _ = engine.init_simulation(SMALL, seed=0, device="cpu")
    state = engine.ensure_carry(SMALL, spec, state)
    pending = {k: torch.randn(v.shape, generator=torch.Generator()
                              .manual_seed(i))
               for i, (k, v) in enumerate(state.buffer.pending_delta.items())}
    state = state._replace(buffer=state.buffer._replace(
        pending_delta=pending))
    n, world = SMALL.n_clients, 4
    rows = n // world
    for rank in range(world):
        mine, _ = engine.shard_clients(state, bundle,
                                       _rank_mesh(rank, world))
        own = slice(rank * rows, (rank + 1) * rows)
        for k, v in pending.items():
            assert torch.equal(mine.buffer.pending_delta[k], v[own]), k
            assert torch.equal(mine.client_params[k],
                               state.client_params[k][own]), k
        for name in engine.BufferState._fields:
            if name != "pending_delta":
                got, want = getattr(mine.buffer, name), \
                    getattr(state.buffer, name)
                for g, w in zip(engine._leaves(got), engine._leaves(want)):
                    assert torch.equal(g, w), name
        for name, g, w in zip(FaultState._fields, mine.faults, state.faults):
            assert torch.equal(g, w), name
        assert mine.buffer.finish_s.shape == (n,)
        assert mine.faults.attempts.shape == (n,)
        fresh = engine.ensure_carry(SMALL, spec, engine.shard_clients(
            state._replace(buffer=None), bundle, _rank_mesh(rank, world))[0])
        for v in fresh.buffer.pending_delta.values():
            assert v.shape[0] == rows


def test_quarantine_of_a_row_share_is_the_whole_stacks_rows():
    """``guard.quarantine(rows=(n, lo))`` on rows [lo, lo + R) gives those
    rows of the whole stack's quarantine, bit for bit (a NaN, an inf and
    a clipped row among them)."""
    rng = np.random.default_rng(3)
    n, r = 12, 4
    deltas = {"w": torch.tensor(rng.normal(0, 2, (1, n, 5, 3))
                                .astype(np.float32)),
              "b": torch.tensor(rng.normal(0, 2, (1, n, 7))
                                .astype(np.float32))}
    deltas["w"][0, 5, 2, 1] = float("nan")
    deltas["b"][0, 9, 0] = float("-inf")
    produced = torch.tensor(rng.uniform(size=(1, n)) < 0.7)
    produced[0, 5] = produced[0, 9] = True
    clean, ok, n_rej = guard.quarantine(deltas, produced, 2.0)
    assert int(n_rej) == 2 and bool((clean["w"] != 0).any())
    for lo in range(0, n, r):
        own = slice(lo, lo + r)
        got, got_ok, _ = guard.quarantine(
            {k: v[:, own] for k, v in deltas.items()}, produced[:, own], 2.0,
            (n, lo))
        assert torch.equal(got_ok, ok[:, own])
        for k in deltas:
            assert got[k].numpy().tobytes() == \
                clean[k][:, own].numpy().tobytes(), (lo, k)


def test_left_out_rows_cannot_change_a_bit():
    """The client axis's stacks put +0.0 where the whole stack has a row
    that never lands or is never delivered: ``buffer_accumulate`` (from a
    +0.0 accumulator and a drawn one) and ``faulted_cloud_aggregate`` give
    the same bits as with the whole stack's rows, whose products with a
    zero weight are -0.0 for a negative entry."""
    rng = np.random.default_rng(11)
    n, m = 10, 3
    f32 = np.float32
    rows = {"w": torch.tensor(-np.abs(rng.normal(size=(1, n, 4, 2)))
                              .astype(f32)),
            "b": torch.tensor(rng.normal(size=(1, n, 6)).astype(f32))}
    keep = torch.tensor(rng.uniform(size=(1, n)) < 0.5)
    keep[0, :2] = True
    keep[0, 2:4] = False
    zeroed = {k: torch.where(keep.reshape(keep.shape + (1,) * (v.dim() - 2)),
                             v, 0.0) for k, v in rows.items()}
    w = torch.where(keep, torch.tensor(rng.uniform(1, 2, (1, n))
                                       .astype(f32)), 0.0)
    for acc in ({k: torch.zeros_like(v[:, 0]) for k, v in rows.items()},
                {k: torch.tensor(rng.normal(size=v[:, 0].shape).astype(f32))
                 for k, v in rows.items()}):
        want = aggregation.buffer_accumulate(acc, torch.zeros(1), rows, w)
        got = aggregation.buffer_accumulate(acc, torch.zeros(1), zeroed, w)
        for k in rows:
            assert got[0][k].numpy().tobytes() == \
                want[0][k].numpy().tobytes(), k
    assoc = torch.nn.functional.one_hot(
        torch.tensor(rng.integers(0, m, n)), m).float()[None]
    glob = {k: torch.tensor(rng.normal(size=v[:, 0].shape).astype(f32))
            for k, v in rows.items()}
    counts = torch.tensor(rng.uniform(10, 20, (1, n)).astype(f32))
    z = torch.ones((1, m))
    clean, ok, _ = guard.quarantine(rows, keep, 5.0)
    clean_z, _, _ = guard.quarantine(zeroed, keep, 5.0)
    assoc_eff = assoc * ok.float()[..., None]
    want = aggregation.faulted_cloud_aggregate(glob, clean, assoc_eff, counts,
                                               z)
    got = aggregation.faulted_cloud_aggregate(glob, clean_z, assoc_eff,
                                              counts, z)
    for k in rows:
        assert got[k].numpy().tobytes() == want[k].numpy().tobytes(), k


# ---------------------------------------------------------------------------
# pad_clients against the reference
# ---------------------------------------------------------------------------

def _carried_start(jcfg, cfg):
    """The reference's world with the buffer, the fault ledger and the
    warm seed attached, and the port's copy of it."""
    jspec = jengine.EngineSpec(engine_mode="buffered", warm_start=True,
                               faults=JFaultSpec(edge_p_kill=0.1))
    jstate, jbundle, _ = jengine.init_simulation(jcfg, seed=0)
    jstate = jengine.ensure_carry(jcfg, jspec, jstate)
    state, bundle = convert.state_from_numpy(
        jax.tree.map(np.asarray, jstate._replace(key=None)),
        jax.tree.map(np.asarray, jbundle), "cpu")
    return jstate, jbundle, state, bundle


@pytest.mark.parametrize("n,multiple", [(16, 5), (18, 4)])
def test_pad_clients_matches_reference_leaf_for_leaf(n, multiple):
    jcfg = dataclasses.replace(JSMALL, n_clients=n)
    cfg = dataclasses.replace(SMALL, n_clients=n)
    jstate, jbundle, state, bundle = _carried_start(jcfg, cfg)
    jcfg2, jstate2, jbundle2 = jengine.pad_clients(jcfg, jstate, jbundle,
                                                   multiple)
    cfg2, state2, bundle2 = engine.pad_clients(cfg, state, bundle, multiple)
    assert cfg2.n_clients == jcfg2.n_clients == 20
    want, got = {}, {}
    sharded._flatten("world", convert.state_from_numpy(
        jax.tree.map(np.asarray, jstate2._replace(key=None)),
        jax.tree.map(np.asarray, jbundle2), "cpu"), want)
    sharded._flatten("world", (state2, bundle2), got)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)
    # a multiple that divides N is a no-op
    assert engine.pad_clients(cfg2, state2, bundle2, 4)[1] is state2


def test_pads_are_inert_and_the_padded_world_runs():
    cfg2, state2, bundle2 = engine.pad_clients(
        SMALL, *engine.init_simulation(SMALL, seed=0, device="cpu")[:2], 5)
    for k in (2, None):
        spec = engine.EngineSpec(scheduler="fastest", candidates_k=k)
        assoc = engine.associate_snapshot(cfg2, spec, state2, bundle2)
        assert assoc[SMALL.n_clients:].sum() == 0       # never associated
        assert (assoc.sum(dim=1) <= 1).all()
        assert (assoc.sum(dim=0) <= SMALL.clients_per_edge).all()
        final, ms = engine.run_scanned(cfg2, spec, state2, bundle2, 2,
                                       torch.Generator().manual_seed(3))
        assert torch.isfinite(ms.cost).all()
        for leaf in final.client_params.values():       # pads never train
            np.testing.assert_array_equal(leaf[SMALL.n_clients:].numpy(),
                                          leaf[-1:].expand_as(
                                              leaf[SMALL.n_clients:]).numpy())


def test_padded_round_matches_reference_round_step():
    """One round of the world padded 16 → 20, the reference's own draws
    replayed: integers exactly, the bill at rtol 1e-5, the loss at rtol
    1e-4, the accuracy within 2 test samples."""
    spec = engine.EngineSpec()
    jspec = jengine.EngineSpec()
    jstate, jbundle, _ = jengine.init_simulation(JSMALL, seed=0)
    jcfg2, jstate2, jbundle2 = jengine.pad_clients(JSMALL, jstate, jbundle,
                                                   5)
    state, bundle = convert.state_from_numpy(
        jax.tree.map(np.asarray, jstate._replace(key=None)),
        jax.tree.map(np.asarray, jbundle), "cpu")
    cfg2, state2, bundle2 = engine.pad_clients(SMALL, state, bundle, 5)
    draws = _replayed_draws(jcfg2, jspec, jstate2, jbundle2)
    jstate3, jm = jengine.round_step_jit(jcfg2, jspec, jstate2, jbundle2)
    state3, m = engine.round_step(cfg2, spec, state2, bundle2, draws)
    want, got = jengine.metrics_row(jm), engine.metrics_row(m)
    np.testing.assert_array_equal(got["z"], want["z"])
    for k in ("round", "n_associated", "n_available", "avg_staleness"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(state3.staleness.numpy(),
                                  np.asarray(jstate3.staleness))
    for k in ("cost", "total_time_s", "total_energy_j"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    n_test = int(jbundle.test_y.shape[0])
    assert abs(got["accuracy"] - want["accuracy"]) <= 2.0 / n_test


# ---------------------------------------------------------------------------
# four gloo ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(JOBS))
def test_four_ranks_bit_equal_to_unsharded(four_ranks, name):
    results, _ = four_ranks
    i = list(JOBS).index(name)
    job = JOBS[name]
    want, _ = sharded.run_unsharded(job, RANKS, "cpu")
    n_pad = -(-job.cfg.n_clients // RANKS) * RANKS
    for rank in range(RANKS):
        got, stats = results[rank][i]
        # only rank 0 emits to the sink
        _assert_outputs_equal(got, {k: v for k, v in want.items()
                                    if rank == 0
                                    or not k.startswith("stream.")},
                              f"{name} rank {rank}")
        if job.axis == "clients":
            # each rank held its own rows only
            assert stats["client_rows"] == n_pad // RANKS, (name, rank)
            if job.spec.engine_mode == "buffered":
                assert stats["pending_rows"] == n_pad // RANKS, (name, rank)
    if name.startswith("clients-ragged"):
        assert want["state.gains"].shape[0] == 20
    if job.stream:
        assert want["stream.round"].shape[0] == \
            job.rounds * (len(job.seeds) if job.axis == "fleet" else 1)


@pytest.mark.parametrize("name", EXERCISED)
def test_four_ranks_exercise_the_buffer_and_the_faults(four_ranks, name):
    """What each buffered or faulted client-axis job claims to run, on
    rank 0's outputs (every rank's are bit-equal to the unsharded run's):
    a merge that changed the model and a retier (the tiers are no longer
    the round-robin start), and at least one crash, drop, retry or
    quarantined delta under faults."""
    results, _ = four_ranks
    got = results[0][list(JOBS).index(name)][0]
    job = JOBS[name]
    if job.spec.engine_mode == "buffered":
        assert got["metrics.z"].sum() >= 1 and got["state.buffer.version"] \
            >= 1, name
        start = np.arange(got["state.buffer.tier"].shape[0]) \
            % job.spec.n_tiers
        assert job.rounds >= job.spec.retier_every and \
            (got["state.buffer.tier"] != start).any(), name
    if job.spec.faults is not None:
        events = sum(int(got[f"state.faults.{k}"]) for k in (
            "n_crashed", "n_dropped", "n_retries", "n_quarantined"))
        assert events > 0, name
    if name == "clients-chaos-sync":
        assert int(got["state.faults.n_quarantined"]) > 0


def test_four_ranks_landed_sums_are_the_whole_stacks(four_ranks):
    """``engine._landed_sum`` on each rank's rows against
    ``buffer_accumulate`` on the whole stack, bit for bit: the NaN and the
    inf of two rows that did not land reach the sums as the whole
    stack's zero-weight products do."""
    results, _ = four_ranks
    tree, landed, w, accs = landed_inputs(**LANDED_CASE)
    wants = [aggregation.buffer_accumulate(acc, torch.ones(1), tree, w)
             for acc in accs]
    assert np.isnan(wants[0][0]["w"].numpy()).any()
    assert np.isnan(wants[0][0]["b"].numpy()).any()
    for rank in range(RANKS):
        for (got, total), (want, want_total) in zip(results[rank][-1],
                                                    wants):
            assert total.tobytes() == want_total.numpy().tobytes()
            for k in tree:
                assert got[k].tobytes() == want[k].numpy().tobytes(), \
                    (rank, k)


def test_four_ranks_sweep_writes_the_unsharded_files(four_ranks, tmp_path):
    results, out = four_ranks
    plain = run_sweep(SMALL, SweepGrid(**SWEEP), out_dir=str(tmp_path),
                      device="cpu")
    for rank in range(RANKS):
        got = results[rank][len(JOBS)]
        assert not got["failed"] and not plain["failed_cells"]
        assert got["cells"] == plain["cells"], rank
    ref, shd = tmp_path / "sweep_t", out / "sharded" / "sweep_t"
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(shd)) == names and len(names) == 2 * 12 + 1
    for name in names:
        want = json.loads((ref / name).read_text())
        got = json.loads((shd / name).read_text())
        if name == "summary.json":
            for g in got["groups"] + want["groups"]:
                for k in ("wall_s", "ddpg_train_s"):
                    if k in g:
                        g[k] = 0.0
        assert got == want, name


def _assert_row_close(got, want, n_test, msg):
    """One round's metrics at ``tests/test_torch_engine.py``'s
    tolerances: integers exactly, the bill at rtol 1e-5, the loss at rtol
    1e-4, the accuracy within 2 test samples."""
    np.testing.assert_array_equal(got["z"], want["z"], msg)
    for k in ("round", "n_associated", "n_available"):
        assert got[k] == want[k], (msg, k)
    np.testing.assert_allclose(got["avg_staleness"], want["avg_staleness"],
                               rtol=1e-6, err_msg=msg)
    for k in ("cost", "total_time_s", "total_energy_j"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   err_msg=f"{msg} {k}")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4,
                               err_msg=msg)
    assert abs(got["accuracy"] - want["accuracy"]) <= 2.0 / n_test, msg


@pytest.mark.parametrize("name", list(REPLAYS))
def test_four_ranks_match_reference_sharded_drivers(four_ranks,
                                                    reference_sharded, name):
    """Every rank's rounds on the reference's world and draws against the
    reference's ``run_scanned_client_sharded`` / ``run_fleet_sharded``
    on four devices: each round's metrics (each seed's), the final global
    model at rtol 1e-4, atol 1e-5, the staleness, the buffer's integers
    and every ``FaultState`` leaf exactly."""
    results, _ = four_ranks
    i = len(JOBS) + 1 + list(REPLAYS).index(name)
    want_rows, want_params, want_stale, n_test, want_extra = \
        reference_sharded[name]
    for rank in range(RANKS):
        rows, params, stale, extra = results[rank][i]
        assert len(rows) == REPLAY_STEPS.get(name, REPLAY_ROUNDS)
        assert sorted(extra) == sorted(want_extra), name
        for k, leaf in want_extra.items():
            assert extra[k].dtype == leaf.dtype, (name, k)
            np.testing.assert_array_equal(extra[k], leaf, f"{name} {k}")
        for r, (got, want) in enumerate(zip(rows, want_rows)):
            pairs = zip(got, want) if REPLAYS[name][0] == "fleet" \
                else [(got, want)]
            for s, (g, w) in enumerate(pairs):
                _assert_row_close(g, w, n_test,
                                  f"{name} rank {rank} round {r} seed {s}")
        np.testing.assert_array_equal(stale, want_stale, name)
        for k, leaf in want_params.items():
            np.testing.assert_allclose(params[k], leaf, rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name} {k}")

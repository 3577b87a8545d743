"""The port's round telemetry (``repro_torch.telemetry``) held to a live
run of the JAX reference (``repro.telemetry``).

Both sides start from the reference's ``init_simulation`` state and the
port replays the reference's own draws each round (``round_keys``, as in
``tests/test_torch_engine.py``).  Every ``RoundTrace`` field is compared
each round: the integer leaves exactly, the float leaves at
``FLOAT_RTOL`` except the PDD internals at ``PDD_RTOL``/``PDD_ATOL``.
Then the reference's invariants on the port alone, the JSONL files
across the two packages in both directions, the profiler ranges, and
telemetry off as today's round.
"""
import dataclasses
import json
import os
import jax
import numpy as np
import pytest
import torch

from repro.configs.hfl_mnist import CONFIG as JCONFIG
from repro.core import engine as jengine
from repro.telemetry import sink as jsink
from repro_torch.configs.hfl_mnist import CONFIG
from repro_torch.core import engine
from repro_torch.telemetry import RoundTrace, STALE_BIN_EDGES, sink, spans
from repro_torch.telemetry import trace
from test_torch_engine import JSMALL, SMALL, _start
from test_torch_scenarios import _lane_draws, _round_draws
from test_torch_scenarios import _start as _scenario_start
from _torch_threads import one_torch_thread  # noqa: F401

ROUNDS = 3
INT_LEAVES = sink.INT_FIELDS
# the bill's terms: the reference's own cost tolerance in these tests
FLOAT_RTOL = 1e-5
# PDD's continuous z and its residual: 1,200 float32 iterations carry the
# ~1e-7 relative gap of their inputs (the two bills) to 2.0e-4 (z_relaxed)
# and 2.9e-4 (residual ~0.48) at CONFIG's third round, where the rounded z
# still agrees; at SMALL both are bit-equal
PDD_RTOL, PDD_ATOL = 1e-5, 1e-3


def _assert_trace(got, want, msg):
    """A port trace (tensors) against a reference trace (arrays) of the
    same shape: integer leaves exact, float leaves at the tolerances."""
    assert isinstance(got, RoundTrace)
    for name in RoundTrace._fields:
        g = np.asarray(getattr(got, name))
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, (msg, name, g.shape, w.shape)
        if name in INT_LEAVES:
            assert g.dtype == np.int32, (msg, name)
            np.testing.assert_array_equal(g, w, f"{msg} {name}")
        else:
            assert g.dtype == np.float32, (msg, name)
            tol = (dict(rtol=PDD_RTOL, atol=PDD_ATOL)
                   if name in ("pdd_residual", "z_relaxed")
                   else dict(rtol=FLOAT_RTOL))
            np.testing.assert_allclose(g, w, err_msg=f"{msg} {name}", **tol)


TRACE_CASES = [
    pytest.param("static", dict(policy="fcea", scheduler="pdd"),
                 id="fcea-pdd"),
    pytest.param("static", dict(policy="gcea", scheduler="fastest"),
                 id="gcea-fastest"),
    pytest.param("static", dict(policy="fcea", scheduler="pdd",
                                candidates_k=2), id="fcea-pdd-k2"),
    pytest.param("markov_dropout", dict(policy="fcea", scheduler="pdd"),
                 id="markov_dropout-fcea-pdd"),
]


@pytest.mark.parametrize("world,kw", TRACE_CASES)
def test_trace_matches_reference(world, kw):
    """Every trace field of ``ROUNDS`` rounds, each round's draws replayed
    (the scenario's from slot 1 on a dynamic kind)."""
    kind = "static" if world == "static" else "dynamic"
    jspec = jengine.EngineSpec(scenario=kind, telemetry=True, **kw)
    spec = engine.EngineSpec(scenario=kind, telemetry=True, **kw)
    jstate, jbundle, state, bundle = _scenario_start(
        JSMALL, 0, None if world == "static" else world)
    seen_valid = set()
    for r in range(ROUNDS):
        draws = _round_draws(JSMALL, jspec, jstate, jbundle)
        jstate, (jm, jtr) = jengine.round_step_jit(JSMALL, jspec, jstate,
                                                   jbundle)
        state, (m, tr) = engine.round_step(SMALL, spec, state, bundle, draws)
        _assert_trace(tr, jtr, f"{world} {kw} round {r}")
        assert int(tr.assoc_sweeps) == m.sweeps
        seen_valid.add(float(tr.frontier_valid_frac))
    if kw.get("candidates_k"):
        assert 0.0 < float(tr.frontier_valid_frac) <= 1.0
    if world != "static":
        assert len(seen_valid) > 1, "availability never moved the trace"


def test_config_trace_matches_reference():
    """Three ``CONFIG`` (N = 64) fcea + PDD rounds against the reference
    billed with ``sic_impl="pairwise"``, the port's SIC (the default
    switches to the sorted SIC from N = 64)."""
    jspec = jengine.EngineSpec(telemetry=True, sic_impl="pairwise")
    spec = engine.EngineSpec(telemetry=True)
    jstate, jbundle, state, bundle = _start(seed=0, jcfg=JCONFIG)
    for r in range(3):
        draws = _round_draws(JCONFIG, jspec, jstate, jbundle)
        jstate, (_, jtr) = jengine.round_step_jit(JCONFIG, jspec, jstate,
                                                  jbundle)
        state, (_, tr) = engine.round_step(CONFIG, spec, state, bundle, draws)
        _assert_trace(tr, jtr, f"CONFIG round {r}")


def test_fleet_trace_matches_reference_collect_fleet():
    """A fleet of 2 (seeds 0, 1): the reference's ``collect_fleet`` trace
    (S, rounds, …) against the port's batched ``fleet_step`` traces, each
    lane's draws replayed from its own key chain; then the port's own
    ``collect_fleet`` shapes."""
    jspec = jengine.EngineSpec(telemetry=True)
    spec = engine.EngineSpec(telemetry=True)
    starts = [_start(seed=s) for s in (0, 1)]
    jstates, jbundles = jengine.stack_fleet([(a, b) for a, b, _, _ in starts])
    states, bundles = engine.stack_fleet([(c, d) for _, _, c, d in starts])
    _, _, jtr = jsink.collect_fleet(JSMALL, jspec, jstates, jbundles, ROUNDS)
    keys = [jstates.key[s] for s in range(2)]
    rows = []
    for r in range(ROUNDS):
        draws = _lane_draws(jspec, keys, jbundles)
        keys = [jengine.round_keys(jspec, k)[0] for k in keys]
        states, out = engine.fleet_step(SMALL, spec, states, bundles, draws)
        rows.append(out)
    _, tr = engine.stack_metrics(rows)
    _assert_trace(tr, jtr, "fleet of 2")
    gens = [torch.Generator().manual_seed(s) for s in (0, 1)]
    _, ms, tr2 = sink.collect_fleet(SMALL, spec, states, bundles, 2, gens)
    assert tr2.edge_load.shape == (2, 2, SMALL.n_edges)
    assert tr2.stale_hist.shape == (2, 2, len(STALE_BIN_EDGES))
    assert ms.accuracy.shape == (2, 2)


# -- the reference's invariants, on the port --------------------------------

def _collect(spec, rounds=4, seed=0):
    state, bundle, aux = engine.init_simulation(SMALL, seed=seed,
                                                device="cpu")
    return sink.collect_scanned(SMALL, spec, state, bundle, rounds,
                                aux["generator"])


@pytest.mark.parametrize("policy,scheduler", [("fcea", "pdd"),
                                              ("gcea", "fastest")])
def test_cost_decomposition_identity(policy, scheduler):
    spec = engine.EngineSpec(policy=policy, scheduler=scheduler,
                             telemetry=True)
    _, ms, tr = _collect(spec)
    energy = tr.energy_local_j + tr.energy_uplink_j + tr.energy_cloud_j
    np.testing.assert_allclose(energy.numpy(), ms.total_energy_j.numpy(),
                               rtol=1e-5)
    tsum = tr.time_local_s + tr.time_uplink_s + tr.time_cloud_s
    assert bool(torch.all(tsum >= ms.total_time_s - 1e-5))
    # the SIC decode depth is the max edge occupancy, capped by the quota
    assert torch.equal(tr.sic_depth, tr.edge_load.amax(dim=-1))
    assert bool(torch.all(tr.sic_depth <= SMALL.clients_per_edge))
    if scheduler == "pdd":
        assert bool(torch.all(tr.pdd_iters > 0))
    else:
        assert bool(torch.all(tr.pdd_iters == 0))
    # the histogram counts every client every round
    assert bool(torch.all(tr.stale_hist.sum(dim=-1) == SMALL.n_clients))


def test_staleness_histogram_counts_every_client():
    stale = torch.tensor([1, 1, 2, 3, 5, 7, 9, 20], dtype=torch.int32)
    hist = trace.staleness_histogram(stale)
    assert int(hist.sum()) == stale.numel()
    assert int(hist[0]) == 2 and int(hist[-1]) == 1
    assert hist.tolist() == [2, 1, 1, 0, 1, 1, 1, 1]
    # over a leading axis, and beyond the last edge
    big = torch.tensor([[1, 12, 1 << 20], [6, 7, 8]], dtype=torch.int32)
    assert trace.staleness_histogram(big).tolist() == [
        [1, 0, 0, 0, 0, 0, 0, 2], [0, 0, 0, 0, 0, 2, 1, 0]]


def test_stream_requires_telemetry():
    spec = engine.EngineSpec(policy="gcea", scheduler="fastest")
    state, bundle, aux = engine.init_simulation(SMALL, seed=0, device="cpu")
    with pytest.raises(ValueError, match="telemetry"):
        sink.stream_scanned(SMALL, spec, state, bundle, 1, sink.MemorySink(),
                            aux["generator"])
    states, bundles = engine.stack_fleet([(state, bundle)])
    with pytest.raises(ValueError, match="telemetry"):
        sink.stream_fleet(SMALL, spec, states, bundles, 1, sink.MemorySink(),
                          [aux["generator"]])


def test_emit_stacked_and_stream_fleet_on_a_fleet_trace():
    spec = engine.EngineSpec(policy="fcea", scheduler="pdd", telemetry=True)
    pairs = [engine.init_simulation(SMALL, seed=s, device="cpu")[:2]
             for s in (0, 1)]
    states, bundles = engine.stack_fleet(pairs)
    gens = lambda: [torch.Generator().manual_seed(s) for s in (0, 1)]
    _, ms, tr = sink.collect_fleet(SMALL, spec, states, bundles, 2, gens())
    mem = sink.MemorySink()
    sink.emit_stacked(tr, mem, fleet_axes=1)
    assert len(mem.records) == 2 * 2               # (seed, round) pairs
    assert all(r.edge_load.shape == (SMALL.n_edges,) for r in mem.records)
    assert [int(r.round) for r in mem.records] == [1, 2, 1, 2]
    # the stream is a tee: the same trace, seed by seed within a round
    streamed = sink.MemorySink()
    _, ms2, tr2 = sink.stream_fleet(SMALL, spec, states, bundles, 2,
                                    streamed, gens())
    for a, b in zip(tr, tr2):
        assert torch.equal(a, b)
    assert torch.equal(ms.cost, ms2.cost)
    assert [int(r.round) for r in streamed.records] == [1, 1, 2, 2]
    for name in RoundTrace._fields:
        want = getattr(tr, name).transpose(0, 1).reshape(
            (4,) + getattr(tr, name).shape[2:]).numpy()
        got = np.stack([getattr(r, name) for r in streamed.records])
        np.testing.assert_array_equal(got, want, name)


# -- JSONL across the two packages --------------------------------------------

class _Tee:
    def __init__(self, *sinks):
        self.sinks = sinks

    def emit(self, tr):
        for s in self.sinks:
            s.emit(tr)


def _same_loaded(a, b):
    assert set(a) == set(b) == set(RoundTrace._fields)
    for name in RoundTrace._fields:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], name)


def test_jsonl_roundtrip_and_cross_reads(tmp_path):
    """The port's ``stream_scanned`` tee writes a JSONL file that both
    packages' ``load_jsonl`` read alike and that equals the returned
    trace; a file the reference's ``JsonlSink`` wrote from its own stream
    reads alike in both packages, and field for field as the port's own
    sink writes the same trace."""
    spec = engine.EngineSpec(policy="gcea", scheduler="fastest",
                             candidates_k=2, telemetry=True)
    state, bundle, aux = engine.init_simulation(SMALL, seed=0, device="cpu")
    path = str(tmp_path / "port.jsonl")
    mem = sink.MemorySink()
    with sink.JsonlSink(path) as js:
        _, ms, tr = sink.stream_scanned(SMALL, spec, state, bundle, 4,
                                        _Tee(mem, js), aux["generator"])
    assert len(mem.records) == 4
    stacked = mem.stacked()
    for name in RoundTrace._fields:
        np.testing.assert_array_equal(getattr(stacked, name),
                                      getattr(tr, name).numpy(), name)
    port_loaded = sink.load_jsonl(path)
    _same_loaded(port_loaded, jsink.load_jsonl(path))
    for name in RoundTrace._fields:
        np.testing.assert_array_equal(port_loaded[name],
                                      getattr(tr, name).numpy(), name)

    jspec = jengine.EngineSpec(policy="gcea", scheduler="fastest",
                               candidates_k=2, telemetry=True)
    jstate, jbundle, _ = jengine.init_simulation(JSMALL, seed=0)
    jpath = str(tmp_path / "reference.jsonl")
    with jsink.JsonlSink(jpath) as js:
        _, _, jtr = jsink.stream_scanned(JSMALL, jspec, jstate, jbundle, 3,
                                         js)
    ref_loaded = jsink.load_jsonl(jpath)
    _same_loaded(sink.load_jsonl(jpath), ref_loaded)
    # the port's sink writes the reference's trace as the reference's does
    again = str(tmp_path / "rewritten.jsonl")
    with sink.JsonlSink(again) as js:
        sink.emit_stacked(RoundTrace(*(np.asarray(l) for l in jtr)), js)
    with open(jpath) as a, open(again) as b:
        assert [json.loads(l) for l in a] == [json.loads(l) for l in b]


def test_jsonl_sink_close_is_idempotent(tmp_path):
    path = str(tmp_path / "x.jsonl")
    js = sink.JsonlSink(path)
    rec = RoundTrace(*(np.zeros((2,) if n in ("edge_load", "z_relaxed")
                                else (), np.float32)
                       for n in RoundTrace._fields))
    js.emit(rec)
    js.close()
    js.close()
    js.emit(rec)                                   # after close: a no-op
    with js:
        pass
    assert len(sink.load_jsonl(path)["round"]) == 1


# -- spans --------------------------------------------------------------------

def test_profile_scanned_names_every_stage(tmp_path):
    spec = engine.EngineSpec(policy="gcea", scheduler="fastest")
    state, bundle, aux = engine.init_simulation(SMALL, seed=0, device="cpu")
    path = spans.profile_scanned(SMALL, spec, state, bundle, 1,
                                 str(tmp_path / "prof"), aux["generator"])
    assert os.path.dirname(path) == str(tmp_path / "prof")
    with open(path) as fh:
        names = {ev.get("name") for ev in json.load(fh)["traceEvents"]}
    for name in spans.STAGES + ("run_scanned",):
        assert f"hfl/{name}" in names, name


def test_stage_timer_nests_inside_the_span():
    """The ``timer=`` hook still sees every stage, inside its range."""
    seen = []

    class Timer:
        def __call__(self, name):
            seen.append(name)
            return torch.autograd.profiler.record_function(f"timer/{name}")

    spec = engine.EngineSpec(policy="gcea", scheduler="fastest")
    state, bundle, aux = engine.init_simulation(SMALL, seed=0, device="cpu")
    engine.run_scanned(SMALL, spec, state, bundle, 1, aux["generator"],
                       timer=Timer())
    assert seen == list(spans.STAGES)


# -- telemetry off ------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(policy="fcea", scheduler="pdd"),
                                dict(policy="gcea", scheduler="fastest",
                                     candidates_k=2)])
def test_telemetry_off_is_todays_round(kw):
    """Off, a round returns a plain ``RoundMetrics`` and a state without a
    buffer; on, the metrics half and the state are bit-equal to it."""
    off = engine.EngineSpec(**kw)
    on = engine.EngineSpec(telemetry=True, **kw)
    state, bundle, aux = engine.init_simulation(SMALL, seed=3, device="cpu")
    draws = engine.sample_draws(SMALL, bundle, aux["generator"], off)
    s_off, m_off = engine.round_step(SMALL, off, state, bundle, draws)
    s_on, out = engine.round_step(SMALL, on, state, bundle, draws)
    assert isinstance(m_off, engine.RoundMetrics)
    assert engine.split_output(off, m_off) == (m_off, None)
    m_on, tr = engine.split_output(on, out)
    assert isinstance(tr, RoundTrace)
    assert s_off.buffer is None and s_on.buffer is None
    for a, b in zip(m_off, m_on):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
    engine._map(lambda a, b: torch.equal(a, b) or pytest.fail("state"),
                s_off, s_on)
    _, ms = engine.run_scanned(SMALL, off, state, bundle, 2,
                               torch.Generator().manual_seed(1))
    assert isinstance(ms, engine.RoundMetrics)

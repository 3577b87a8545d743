"""The port's checkpoints (``repro_torch.checkpoint.store``) and its
resumable driver (``repro_torch.faults.resume.run_scanned_resumable``),
the reference's cases (``tests/test_faults.py`` (d)) on the port.

The reference's carry holds its PRNG key; the port's draws come from a
``torch.Generator`` outside the carry, so a snapshot holds the
generator's state beside the carry, and a resumed run must still be
bit-identical to an uninterrupted one: metrics, trace, final carry and
the generator's state.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import store
from repro_torch.core import engine
from repro_torch.faults import FaultSpec, FaultState, run_scanned_resumable
from test_torch_engine import SMALL
from _torch_threads import one_torch_thread  # noqa: F401

ROUNDS = 4
SPEC_SYNC = engine.EngineSpec(policy="gcea", scheduler="fastest")
SPEC_BUF = engine.EngineSpec(policy="gcea", scheduler="fastest",
                             engine_mode="buffered", n_tiers=2,
                             retier_every=3, timeout_s=5.0)
CHURN = dict(edge_p_kill=0.2, edge_p_respawn=0.5, uplink_p_loss=0.2,
             uplink_loss_slope=0.2)
# with NaN poisoning of the in-flight copies, so NaN rides the carry
POISONED = dict(CHURN, client_p_crash=0.05, p_poison=0.3, poison_nan=True)


def _bits(t):
    """A tensor's bits: NaN-poisoned deltas ride the carry, NaN != NaN."""
    if t.dtype.is_floating_point:
        return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])
    return t


def _equal(a, b, msg):
    """Two trees of one structure bit for bit (tensors with their dtype;
    other leaves equal)."""
    def eq(x, y):
        assert x.dtype == y.dtype and x.shape == y.shape, msg
        assert torch.equal(_bits(x), _bits(y)), msg
        return x
    engine._map(eq, a, b)


def _init():
    return engine.init_simulation(SMALL, seed=0, device="cpu")


def test_checkpoint_roundtrips_full_faulted_carry(tmp_path):
    """The whole buffered and faulted carry (``BufferState`` with
    NaN-poisoned in-flight deltas, ``FaultState``, the scenario,
    ``round_idx``) and the generator's
    state survive save and load bit for bit; the restored generator draws
    what the original draws."""
    spec = dataclasses.replace(SPEC_BUF, faults=FaultSpec(**POISONED))
    state, bundle, aux = _init()
    gen = aux["generator"]
    state, _ = engine.run_scanned(SMALL, spec, state, bundle, 3, gen)
    assert bool(torch.isnan(state.buffer.pending_delta["w1"]).any())
    tree = {"carry": state, "generator": gen.get_state()}
    store.save_checkpoint(str(tmp_path), 3, tree, extra={"why": "test"})
    back, step, extra = store.load_checkpoint(str(tmp_path), tree)
    assert step == 3 and extra == {"why": "test"}
    assert isinstance(back["carry"].faults, FaultState)
    assert isinstance(back["carry"].buffer, engine.BufferState)
    assert back["carry"].round_idx == 3
    assert type(back["carry"].round_idx) is int
    _equal(back, tree, "carry round-trip")
    other = torch.Generator()
    other.set_state(back["generator"])
    assert torch.equal(torch.rand(5, generator=other),
                       torch.rand(5, generator=gen))
    manifest = json.loads((tmp_path / "step_3.json").read_text())
    assert manifest["keys"]["carry/faults/edge_up"] == {
        "dtype": "float32", "shape": [SMALL.n_edges]}
    assert manifest["keys"]["carry/round_idx"]["dtype"] == "py:int"
    assert "carry/warm" not in manifest["keys"]   # None leaves are absent


def test_checkpoint_roundtrips_bf16_bool_and_int_leaves(tmp_path):
    t = torch.randn(4, 3).to(torch.bfloat16)
    tree = {"w": t, "mask": torch.tensor([True, False]), "n": 7,
            "nested": (torch.arange(3, dtype=torch.int32), None)}
    store.save_checkpoint(str(tmp_path), 0, tree)
    back, _, _ = store.load_checkpoint(str(tmp_path), tree)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), t.view(torch.int16))
    assert back["mask"].dtype == torch.bool
    assert torch.equal(back["mask"], tree["mask"])
    assert back["n"] == 7 and type(back["n"]) is int
    with pytest.raises(TypeError, match="float"):
        store.save_checkpoint(str(tmp_path), 1, {"x": 0.25})
    assert torch.equal(back["nested"][0], tree["nested"][0])
    assert back["nested"][1] is None


def test_load_checkpoint_checks_leaves(tmp_path):
    store.save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2)})
    with pytest.raises(KeyError, match="b"):
        store.load_checkpoint(str(tmp_path), {"a": torch.zeros(2),
                                              "b": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        store.load_checkpoint(str(tmp_path / "nowhere"), {})


def test_latest_step_empty_and_garbage_dirs(tmp_path):
    assert store.latest_step(str(tmp_path / "never_created")) is None
    assert store.latest_step(str(tmp_path)) is None          # empty
    (tmp_path / "not_a_checkpoint.npz").write_bytes(b"junk")
    (tmp_path / "step_x.npz").write_bytes(b"junk")
    (tmp_path / "step_7.json").write_text("{}")              # manifest only
    assert store.latest_step(str(tmp_path)) is None
    (tmp_path / "step_4.npz").write_bytes(b"junk")
    (tmp_path / "step_11.npz").write_bytes(b"junk")
    assert store.latest_step(str(tmp_path)) == 11


def test_resumable_interrupted_run_resumes_bit_identical(tmp_path):
    """An interruption after one segment (``max_segments=1``) and a resume
    reproduce the uninterrupted run bit for bit: metrics, trace, the final
    carry and the generator's state."""
    spec = dataclasses.replace(SPEC_BUF, faults=FaultSpec(**POISONED),
                               telemetry=True)
    state, bundle, _ = _init()
    state = engine.ensure_carry(SMALL, spec, state)
    n_rounds = 6
    gen_ref = torch.Generator().manual_seed(11)
    ref_final, (ref_ms, ref_tr) = engine.run_scanned(SMALL, spec, state,
                                                     bundle, n_rounds,
                                                     gen_ref)

    first = run_scanned_resumable(SMALL, spec, state, bundle, n_rounds,
                                  torch.Generator().manual_seed(11),
                                  directory=str(tmp_path), segment_rounds=2,
                                  max_segments=1)
    assert first.completed_rounds == 2 and not first.done
    assert store.latest_step(str(tmp_path)) == 2
    # a new process: a fresh generator, whatever its seed
    gen = torch.Generator().manual_seed(999)
    res = run_scanned_resumable(SMALL, spec, state, bundle, n_rounds, gen,
                                directory=str(tmp_path), segment_rounds=2)
    assert res.done and res.completed_rounds == n_rounds
    _equal(res.metrics, ref_ms, "metrics diverged across resume")
    _equal(res.trace, ref_tr, "trace diverged across resume")
    _equal(res.state, ref_final, "final carry diverged across resume")
    assert torch.equal(gen.get_state(), gen_ref.get_state())
    assert int(res.state.faults.n_retries) > 0


def test_resumable_host_death_mid_save_resumes_from_previous_step(
        tmp_path, monkeypatch):
    """A host that dies between the two renames of step 4's files leaves
    step 2 as the latest, and the resume goes on from there,
    bit-identical to an uninterrupted run."""
    spec = dataclasses.replace(SPEC_SYNC, faults=FaultSpec(**CHURN))
    state, bundle, _ = _init()
    ref_final, ref_ms = engine.run_scanned(SMALL, spec, state, bundle,
                                           ROUNDS,
                                           torch.Generator().manual_seed(5))
    replace, renamed = store.os.replace, []

    def dies_between_step_4_renames(src, dst):
        if "step_4." in str(dst):
            if renamed:
                raise OSError("host died mid-save")
            renamed.append(dst)
        replace(src, dst)
    monkeypatch.setattr(store.os, "replace", dies_between_step_4_renames)
    with pytest.raises(OSError, match="mid-save"):
        run_scanned_resumable(SMALL, spec, state, bundle, ROUNDS,
                              torch.Generator().manual_seed(5),
                              directory=str(tmp_path), segment_rounds=2)
    monkeypatch.undo()
    assert store.latest_step(str(tmp_path)) == 2
    gen = torch.Generator().manual_seed(999)
    res = run_scanned_resumable(SMALL, spec, state, bundle, ROUNDS, gen,
                                directory=str(tmp_path), segment_rounds=2)
    assert res.done and res.completed_rounds == ROUNDS
    _equal(res.metrics, ref_ms, "metrics diverged across the failed save")
    _equal(res.state, ref_final, "final carry diverged across the failed "
                                 "save")
    assert store.latest_step(str(tmp_path)) == ROUNDS


def test_resumable_without_interruption_matches_scan(tmp_path):
    """Segmented but uninterrupted equals one run (no faults, no
    telemetry: the plain sync engine through the same driver)."""
    state, bundle, _ = _init()
    ref_final, ref_ms = engine.run_scanned(SMALL, SPEC_SYNC, state, bundle,
                                           ROUNDS,
                                           torch.Generator().manual_seed(2))
    res = run_scanned_resumable(SMALL, SPEC_SYNC, state, bundle, ROUNDS,
                                torch.Generator().manual_seed(2),
                                directory=str(tmp_path), segment_rounds=3)
    assert res.done and res.trace is None
    _equal(res.metrics, ref_ms, "metrics")
    _equal(res.state, ref_final, "final carry")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_3.json", "step_3.npz", "step_4.json", "step_4.npz"]
    # a finished run asked again does no work and returns the same outputs
    again = run_scanned_resumable(SMALL, SPEC_SYNC, state, bundle, ROUNDS,
                                  torch.Generator(), directory=str(tmp_path),
                                  segment_rounds=3)
    assert again.done
    _equal(again.metrics, ref_ms, "metrics after a finished run")



@pytest.mark.parametrize("candidates_k", [None, 2])
def test_resumable_warm_run_resumes_bit_identical(tmp_path, candidates_k):
    """A warm-started random_waypoint run stopped after one segment and
    resumed: the ``warm`` leaf travels in the snapshot, so the resumed
    rounds start from last round's matching, and the sweep counts, metrics,
    final carry (seed included) and generator state equal the
    uninterrupted run's.  Resumed from the same snapshot with the seed
    reset, the run makes the same decisions in other sweep counts."""
    spec = engine.EngineSpec(policy="gcea", scheduler="fastest",
                             scenario="dynamic", warm_start=True,
                             candidates_k=candidates_k)
    state, bundle, _ = engine.init_simulation(SMALL, seed=0, device="cpu",
                                              scenario="random_waypoint")
    n_rounds = 6
    gen_ref = torch.Generator().manual_seed(4)
    ref_final, ref_ms = engine.run_scanned(SMALL, spec, state, bundle,
                                           n_rounds, gen_ref)
    gen_first = torch.Generator().manual_seed(4)
    first = run_scanned_resumable(SMALL, spec, state, bundle, n_rounds,
                                  gen_first, directory=str(tmp_path),
                                  segment_rounds=2, max_segments=1)
    assert first.completed_rounds == 2
    gen = torch.Generator().manual_seed(999)
    res = run_scanned_resumable(SMALL, spec, state, bundle, n_rounds, gen,
                                directory=str(tmp_path), segment_rounds=2)
    assert res.done
    assert res.metrics.sweeps.tolist() == ref_ms.sweeps.tolist()
    _equal(res.metrics, ref_ms, "metrics diverged across resume")
    _equal(res.state, ref_final, "final carry diverged across resume")
    assert res.state.warm.dtype == torch.int32
    assert bool((res.state.warm >= 0).any())
    assert torch.equal(gen.get_state(), gen_ref.get_state())
    _, cold = engine.run_scanned(
        SMALL, spec,
        first.state._replace(warm=engine.init_warm(SMALL, device="cpu")),
        bundle, n_rounds - 2, gen_first)
    for name in ("n_associated", "z", "cost"):
        assert torch.equal(getattr(cold, name),
                           getattr(res.metrics, name)[2:]), name
    assert cold.sweeps.tolist() != res.metrics.sweeps[2:].tolist()

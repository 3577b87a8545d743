"""Fault-injection spec and state (the reference's ``repro.faults.spec``).

* ``FaultSpec`` -- a frozen (hashable) dataclass hanging off
  ``EngineSpec.faults``.  ``None`` (the default) keeps every fault path
  absent: no ``FaultState`` rides the carry, no fault uniform is drawn
  and no fault op runs, so a no-fault round is today's.
* ``FaultState`` -- the carry in ``RoundState.faults`` when faults are
  on: the live-edge mask the churn evolves, the per-client retry ledger
  the buffered engine's backoff reads, and cumulative counters of the
  degradation events, so a run's fault history survives in its final
  state even without telemetry.  In a fleet every leaf has the leading
  seed axis S.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Fault-injection and graceful-degradation knobs, with the
    reference's defaults.

    Injection, per round (or buffered micro-step), from the round's fault
    uniforms (``engine.FaultDraws``):

    * **edge churn** -- each live edge dies with ``edge_p_kill``, each
      dead edge respawns with ``edge_p_respawn`` (a two-state Markov chain
      over ``FaultState.edge_up``); a step that would leave fewer than
      ``min_edges_up`` live edges is vetoed (the previous mask is kept);
    * **uplink loss** -- a finished upload is lost with probability
      ``uplink_p_loss`` at the best observed channel, rising by
      ``uplink_loss_slope`` toward the worst;
    * **client crash** -- an admitted client crashes mid-round with
      ``client_p_crash``: its compute is billed, its delta is lost;
    * **poisoning** -- with ``p_poison`` a produced delta is scaled by
      ``poison_scale``, or NaN-filled when ``poison_nan``.

    Degradation: a lost buffered upload re-enters flight at ``clock +
    backoff_base_s · backoff_factor^attempt`` for up to ``max_attempts``
    attempts, then is dropped; every delta reaching aggregation is
    L2-clipped to ``quarantine_clip`` and NaN/Inf-rejected
    (``faults.guard``); a buffered merge applies only when the buffer
    holds at least ``min_participation`` updates."""
    # edge-server churn (Markov kill/respawn over FaultState.edge_up)
    edge_p_kill: float = 0.0
    edge_p_respawn: float = 0.25
    min_edges_up: int = 1
    # SINR-tied Bernoulli uplink loss
    uplink_p_loss: float = 0.0
    uplink_loss_slope: float = 0.0
    # mid-round client crash (compute billed, delta lost)
    client_p_crash: float = 0.0
    # delta poisoning (the quarantine's stress input)
    p_poison: float = 0.0
    poison_scale: float = 1e6
    poison_nan: bool = False
    # retry/backoff (the buffered engine's uplink re-entry)
    max_attempts: int = 3
    backoff_base_s: float = 2.0
    backoff_factor: float = 2.0
    # graceful degradation
    quarantine_clip: float = 100.0
    min_participation: int = 1


class FaultState(NamedTuple):
    """The fault layer's carry.  ``edge_up`` is float (1.0 / 0.0) so it
    multiplies masks directly; ``attempts`` is the in-flight upload's
    retry count (reset on each new admission); the ``n_*`` counters are
    cumulative over the run."""
    edge_up: torch.Tensor        # (…, M) float32 live-edge mask
    attempts: torch.Tensor       # (…, N) int32 retries of the upload
    n_retries: torch.Tensor      # (…) int32 cumulative uplink retries
    n_dropped: torch.Tensor      # (…) int32 uploads lost for good
    n_quarantined: torch.Tensor  # (…) int32 deltas the guard rejected
    n_crashed: torch.Tensor      # (…) int32 mid-round client crashes


def init_faults(cfg, device: "str | torch.device",
                lead: Tuple[int, ...] = ()) -> FaultState:
    """All edges up, no retries, counters zero; ``lead`` the leading
    axes (a fleet's (S,))."""
    lead = tuple(lead)
    i32 = dict(dtype=torch.int32, device=device)
    return FaultState(
        edge_up=torch.ones(lead + (cfg.n_edges,), dtype=torch.float32,
                           device=device),
        attempts=torch.zeros(lead + (cfg.n_clients,), **i32),
        n_retries=torch.zeros(lead, **i32),
        n_dropped=torch.zeros(lead, **i32),
        n_quarantined=torch.zeros(lead, **i32),
        n_crashed=torch.zeros(lead, **i32))

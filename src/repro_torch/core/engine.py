"""The HFL global round as one function over explicit state (paper §II-§IV).

    round_step(cfg, spec, state, bundle, draws) -> (state', RoundMetrics)

chains the paper's semi-synchronous round: Gauss-Markov fading → fuzzy
competency scoring (kernel) → deferred-acceptance association →
allocation → one Eq. 23a cost evaluation with NOMA SIC rates (kernel) →
the PDD edge schedule → τ₂ × τ₁ compact-cohort local SGD (kernel) with
edge and cloud aggregation → the staleness update and evaluation.

With ``EngineSpec(candidates_k=k)`` the round runs on the (N, K)
candidate frontier (``core.candidates``): scoring (the same kernel, over
N·K rows), the resolver sweeps and the uplink bill (sorted SIC on the
compact assignment) touch only the k nearest edges of each client, and
the one-hot (N, M) association is rebuilt for training and aggregation.

* ``RoundState``  -- what evolves across rounds: global and stacked client
  params, channel gains, staleness, the round index and the scenario's
  world state (``scenarios.ScenarioState``).
* ``RoundBundle`` -- what is fixed for one simulation: distances and data.
* ``RoundDraws``  -- the round's random numbers, an explicit argument:
  the ``Exp(1)`` fading field, the minibatch index lattice for all N
  clients and, where the spec needs them, rcea's and rra's uniforms and
  the scenario transition's.  ``sample_draws`` makes them from a
  ``torch.Generator``; the tests replay the reference's own draws through
  the same argument.

With a dynamic ``EngineSpec.scenario`` the round first advances the world
(``scenarios.advance``): the moved distances feed fading, coverage and
association, an unavailable client is out of every edge's coverage and
the association, the allocation is clamped to each device's caps, and the
bill charges each device's κ.

Two drivers run it, as in the reference: ``run_scanned`` over rounds,
and ``run_fleet`` over a fleet of seeds stacked along a leading axis
(``stack_fleet``).  Every stage is written once, over that leading axis:
``fleet_step`` runs one round of all S simulations in one batched pass,
and ``round_step`` is ``fleet_step`` of a fleet of one.

The ``ddpg`` allocator deploys a trained actor (``core.ddpg``): the
drivers take ``actor_params``, one actor for every seed, or one per seed
(``run_fleet_actors``); with none it takes the ``mid`` midpoints.  Its
trainer's MDP starts from ``associate_snapshot``, the association the
next round would make, taken without advancing the state.

With ``EngineSpec(engine_mode="buffered")`` a step is the semi-async
engine's micro-step (``fleet_buffered_step``): one TiFL speed tier's idle
clients enter the unchanged association and allocation stages, train,
and land their staleness-weighted deltas in a FedBuff buffer at their
virtual finish times; the cloud merges on fill or timeout.  Its carry is
``RoundState.buffer`` (a ``BufferState``), absent on the sync engine.

With ``EngineSpec(telemetry=True)`` a step returns ``(state',
(RoundMetrics, telemetry.RoundTrace))``; off, it returns today's
``(state', RoundMetrics)`` and builds no trace (``split_output``
normalises the two).  Every stage runs inside a ``telemetry.spans``
range.

With ``EngineSpec(faults=FaultSpec(...))`` (``repro_torch.faults``) the
round runs under injected faults: edge churn (dead edges leave the
association's view of the distance field, or the frontier's valid slots,
and the schedule), mid-round crashes, SINR-tied uplink loss (dropped on
the sync engine, retried with exponential backoff on the buffered one),
poisoned deltas and the quarantine every delta passes before it is
merged; the buffered merge waits for ``min_participation`` updates.  Its
carry is ``RoundState.faults`` (a ``FaultState``) and its random numbers
are ``RoundDraws.faults`` (a ``FaultDraws``), both absent with faults
off, when the round is today's.

With ``EngineSpec(warm_start=True)`` the association is warm-started:
``RoundState.warm`` carries the previous round's assigned vector (N,)
int32 (−1 unassigned), and the resolver's sweeps start from the seeds
still valid today, falling back to a cold resolution wherever the warm
result admits a blocking pair (``core.association``).  The matching is
the cold one; only the sweep counts differ.  Off, the leaf is absent.

Across processes (``core.mesh``, one a card): ``run_fleet_sharded``
splits a fleet's seed axis over the ranks, each seed bit-equal to
``run_fleet``'s; ``run_scanned_client_sharded`` splits one simulation's
client rows (``pad_clients``, ``shard_clients``; the buffered engine's
pending deltas too), the control plane replicated and the trained lanes
and landed deltas gathered, bit-equal to ``run_scanned`` on the same
padded world, sync or buffered, with or without faults.

The port covers the sync and the buffered engine on every scenario kind,
dense or on the candidate frontier, with fcea, gcea or rcea, the
``mid``, ``rra``, ``fpa``, ``fca`` or ``ddpg`` allocator, PDD or fastest
scheduling (the sync engine's), NOMA or OMA, with or without telemetry,
faults and the warm start.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import scenarios
from repro_torch.core import (aggregation, association, candidates, cost,
                              env, noma, pdd, staleness)
from repro_torch.core.mesh import Mesh, PeerFailed, client_mesh, fleet_mesh
from repro_torch.data import federated
from repro_torch.device import resolve_device
from repro_torch.faults import guard as fault_guard
from repro_torch.faults import inject as fault_inject
from repro_torch.faults.spec import FaultSpec, FaultState, init_faults
from repro_torch.kernels import hfl_ops
from repro_torch.models import mlp
from repro_torch.telemetry import spans
from repro_torch.telemetry import trace as telemetry_trace

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Spec + state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Per-simulation switches, with the reference's defaults.

    ``engine_mode`` "sync" is the paper's semi-synchronous round,
    "buffered" the semi-async micro-step, whose own switches follow it:
    ``buffer_fill`` (the updates that fire a merge; 0, the default, is
    half the admission capacity, quota·M // 2), ``timeout_s`` (virtual
    seconds between forced merges), ``n_tiers`` (TiFL speed tiers),
    ``retier_every`` (micro-steps between quantile retiers) and
    ``buffer_lr`` (the server step on the merged mean delta).  The sync
    round reads none of them.
    ``telemetry`` adds the ``RoundTrace`` to each step's output.
    ``faults`` (a ``FaultSpec``, or None for none) turns on the fault
    layer.  ``warm_start`` carries the previous round's matching in
    ``RoundState.warm`` and seeds the resolver with it."""
    policy: str = "fcea"            # fcea | gcea | rcea
    allocator: str = "mid"          # mid | rra | fpa | fca | ddpg
    scheduler: str = "pdd"          # pdd | fastest
    noma_enabled: bool = True
    fading_rho: float = 0.9
    oma_quota_factor: float = 0.5
    # the transition kind (a key of ``scenarios.TRANSITIONS``); the
    # scenario's numbers live in ``RoundState.scenario``
    scenario: str = "static"
    candidates_k: Optional[int] = None
    telemetry: bool = False
    engine_mode: str = "sync"       # sync | buffered
    buffer_fill: int = 0            # 0 = auto: (quota · M) // 2
    timeout_s: float = 10.0
    n_tiers: int = 4
    retier_every: int = 8
    buffer_lr: float = 1.0
    faults: Optional[FaultSpec] = None
    warm_start: bool = False

    def __post_init__(self):
        if self.policy not in association.POLICIES:
            raise ValueError(f"unknown association policy {self.policy!r}")
        if self.allocator not in ("mid", "rra", "fpa", "fca", "ddpg"):
            raise ValueError(f"unknown allocator {self.allocator!r}")
        if self.scheduler not in ("pdd", "fastest"):
            raise ValueError(f"unknown scheduler {self.scheduler!r}")
        if self.scenario not in scenarios.TRANSITIONS:
            raise ValueError(f"unknown scenario transition "
                             f"{self.scenario!r}; registered: "
                             f"{sorted(scenarios.TRANSITIONS)}")
        if self.engine_mode not in ("sync", "buffered"):
            raise ValueError(f"unknown engine_mode {self.engine_mode!r}; "
                             f"choose 'sync' or 'buffered'")
        if self.faults is not None and not isinstance(self.faults,
                                                      FaultSpec):
            raise TypeError(f"faults must be a FaultSpec or None, not "
                            f"{type(self.faults).__name__}")


class RoundBundle(NamedTuple):
    """Per-simulation constants.  In a fleet (``stack_fleet``) each of the
    state's, bundle's and draws' tensors has a leading seed axis S."""
    dist: torch.Tensor       # (N, M) float32 client-edge distances at init
    x: torch.Tensor          # (N, cap, dim) float32 padded client data
    y: torch.Tensor          # (N, cap) int32 labels
    counts: torch.Tensor     # (N,) float32 — D_n
    test_x: torch.Tensor     # (T, dim) float32
    test_y: torch.Tensor     # (T,) int32


class BufferState(NamedTuple):
    """The buffered engine's carry (the reference's ``BufferState``): the
    FedBuff aggregation buffer, the per-client in-flight bookkeeping and
    the TiFL tier table.  In a fleet every leaf has a leading seed axis
    S, so the scalars below are (S,): seeds may be at different steps."""
    pending_delta: Params    # (N, ...) trained-minus-pulled model deltas
    finish_s: torch.Tensor   # (N,) float32 absolute virtual finish times
    in_flight: torch.Tensor  # (N,) bool -- admitted, not yet landed
    pulled_ver: torch.Tensor  # (N,) int32 global version at admission
    obs_s: torch.Tensor      # (N,) float32 EMA of measured durations
    tier: torch.Tensor       # (N,) int32 TiFL speed tier (0 = fastest)
    delta_sum: Params        # global-shaped Σ w·Δ accumulator
    weight_sum: torch.Tensor  # () float32 Σ w over buffered updates
    fill: torch.Tensor       # () int32 updates landed since last trigger
    version: torch.Tensor    # () int32 cloud aggregation count
    clock_s: torch.Tensor    # () float32 virtual wall clock
    last_agg_s: torch.Tensor  # () float32 clock at the last trigger
    step: torch.Tensor       # () int32 micro-step counter


class RoundState(NamedTuple):
    """Everything that evolves across global rounds."""
    global_params: Params    # cloud model
    client_params: Params    # stacked (N, ...) client models
    gains: torch.Tensor      # (N, M) float32 current |h|²
    staleness: torch.Tensor  # (N,) int32 — A_n
    round_idx: int
    scenario: Any = None     # scenarios.ScenarioState (None: static only)
    buffer: Any = None       # BufferState (buffered engine) | None
    faults: Any = None       # FaultState (EngineSpec.faults set) | None
    warm: Any = None         # (N,) int32 previous assigned | None


class FaultDraws(NamedTuple):
    """The fault layer's uniforms of one round, Uniform[0, 1) (the
    reference's four ``split(fault_key(k_fade), 4)`` streams)."""
    edge_u: torch.Tensor     # (M,) the churn step
    loss_u: torch.Tensor     # (N,) uplink loss
    crash_u: torch.Tensor    # (N,) mid-round crashes
    poison_u: torch.Tensor   # (N,) delta poisoning


class RoundDraws(NamedTuple):
    """One round's random numbers."""
    fading: torch.Tensor     # (N, M) float32 Exp(1) fading field
    batch_idx: torch.Tensor  # (τ₂, τ₁, N, B) int32 in [0, max(D_n, 1))
    assoc_u: Optional[torch.Tensor] = None  # (N, M) Uniform[0, 1), rcea
    alloc_u: Optional[torch.Tensor] = None  # (2, N) Uniform[0, 1), rra
    # (U,) Uniform[0, 1): the scenario transition's uniforms, laid out as
    # ``scenarios.draw_shapes`` names them; empty on the static kind
    scenario: Optional[torch.Tensor] = None
    faults: Optional[FaultDraws] = None      # with EngineSpec.faults only


class RoundMetrics(NamedTuple):
    """Per-round observables (0-d tensors, or stacked along rounds); a
    fleet's have a leading seed axis: (S,) a round, (S, rounds, …) from
    ``run_fleet``."""
    round: Any
    accuracy: torch.Tensor
    loss: torch.Tensor
    avg_staleness: torch.Tensor
    total_time_s: torch.Tensor
    total_energy_j: torch.Tensor
    cost: torch.Tensor
    n_associated: torch.Tensor
    n_available: Any         # int N (static), or an int32 count a seed
    z: torch.Tensor          # (M,)
    sweeps: Any              # deferred-acceptance sweeps the resolver ran


# ---------------------------------------------------------------------------
# Topology (paper §V: 500 m square, cloud at centre, 4 edges at midpoints
# of the corner-to-centre lines, clients uniform)
# ---------------------------------------------------------------------------

def make_topology(rng: np.random.Generator, *, n_clients: int, n_edges: int,
                  area_side_m: float) -> Dict[str, np.ndarray]:
    half = area_side_m / 2.0
    cloud = np.array([half, half])
    corners = np.array([[0.0, 0.0], [0.0, area_side_m],
                        [area_side_m, 0.0], [area_side_m, area_side_m]])
    mids = (corners + cloud) / 2.0
    if n_edges <= 4:
        edges = mids[:n_edges]
    else:  # extra edges uniformly placed
        extra = rng.uniform(0.0, area_side_m, (n_edges - 4, 2))
        edges = np.concatenate([mids, extra], axis=0)
    clients = rng.uniform(0.0, area_side_m, (n_clients, 2))
    dist = np.linalg.norm(clients[:, None, :] - edges[None, :, :], axis=-1)
    return {"cloud": cloud, "edges": edges, "clients": clients, "dist": dist}


def coverage_radius(cfg) -> float:
    """Generous enough that every client can reach ≥ 1 edge."""
    return cfg.area_side_m * 0.75


def quota_for(cfg, spec: EngineSpec) -> int:
    """OMA admits fewer clients per edge: each needs an orthogonal slice."""
    if spec.noma_enabled:
        return cfg.clients_per_edge
    return max(1, int(cfg.clients_per_edge * spec.oma_quota_factor))


def buffer_fill_for(cfg, spec: EngineSpec) -> int:
    """The fill half of the fill-or-timeout trigger: ``spec.buffer_fill``
    when it is above 0, else half the per-micro-step admission capacity
    (quota · M)."""
    if spec.buffer_fill > 0:
        return int(spec.buffer_fill)
    return max(1, (quota_for(cfg, spec) * cfg.n_edges) // 2)


def init_buffer(cfg, spec: EngineSpec, state: "RoundState") -> BufferState:
    """An empty buffer shaped for ``state``'s models (one simulation, or a
    fleet: the leading axes of ``state.staleness``).  Tiers start
    round-robin over clients; the first retier replaces them with
    measured-speed tiers."""
    n = cfg.n_clients
    lead = tuple(state.staleness.shape[:-1])
    dev = state.staleness.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    tier = torch.arange(n, **i32) % max(1, int(spec.n_tiers))
    return BufferState(
        pending_delta=aggregation.buffer_zeros(state.client_params),
        finish_s=torch.zeros(lead + (n,), **f32),
        in_flight=torch.zeros(lead + (n,), dtype=torch.bool, device=dev),
        pulled_ver=torch.zeros(lead + (n,), **i32),
        obs_s=torch.zeros(lead + (n,), **f32),
        tier=tier.expand(lead + (n,)).clone(),
        delta_sum=aggregation.buffer_zeros(state.global_params),
        weight_sum=torch.zeros(lead, **f32),
        fill=torch.zeros(lead, **i32),
        version=torch.zeros(lead, **i32),
        clock_s=torch.zeros(lead, **f32),
        last_agg_s=torch.zeros(lead, **f32),
        step=torch.zeros(lead, **i32))


def ensure_buffer(cfg, spec: EngineSpec, state: "RoundState"
                  ) -> "RoundState":
    """``state.buffer`` normalised to the spec's engine: a fresh buffer
    attached for "buffered" (one already there is kept, e.g. mid-run),
    stripped for "sync" (whose carry is then today's).  A state that is
    already normalised comes back as the same object."""
    if spec.engine_mode == "buffered":
        if state.buffer is None:
            return state._replace(buffer=init_buffer(cfg, spec, state))
        return state
    if state.buffer is not None:
        return state._replace(buffer=None)
    return state


def ensure_faults(cfg, spec: EngineSpec, state: "RoundState"
                  ) -> "RoundState":
    """``state.faults`` normalised to the spec: a fresh ``FaultState``
    (shaped for the state's leading axes) attached when ``spec.faults`` is
    set (one already there is kept, e.g. mid-run or restored from a
    checkpoint), stripped when faults are off.  A state that is already
    normalised comes back as the same object."""
    if spec.faults is not None:
        if state.faults is None:
            return state._replace(faults=init_faults(
                cfg, state.staleness.device, state.staleness.shape[:-1]))
        return state
    if state.faults is not None:
        return state._replace(faults=None)
    return state


def init_warm(cfg, device: "str | torch.device" = "cuda",
              lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """A fresh warm-start seed, (*lead, N) int32: every client unassigned
    (−1), so the first warm round starts as the cold resolver does.  On
    the card unless ``device`` says otherwise."""
    return torch.full(tuple(lead) + (cfg.n_clients,), -1, dtype=torch.int32,
                      device=resolve_device(device))


def ensure_warm(cfg, spec: EngineSpec, state: "RoundState"
                ) -> "RoundState":
    """``state.warm`` normalised to the spec: the unassigned seed attached
    when ``spec.warm_start`` is on (one already there is kept, e.g. mid-run
    or restored from a checkpoint), stripped when it is off.  A state that
    is already normalised comes back as the same object."""
    if spec.warm_start:
        if state.warm is None:
            return state._replace(warm=init_warm(
                cfg, state.staleness.device, state.staleness.shape[:-1]))
        return state
    if state.warm is not None:
        return state._replace(warm=None)
    return state


def ensure_carry(cfg, spec: EngineSpec, state: "RoundState"
                 ) -> "RoundState":
    """The whole carry normalised to the spec's optional parts (the
    aggregation buffer, the fault state and the warm-start seed): the one
    normaliser the drivers and ``fleet_step`` call."""
    return ensure_warm(cfg, spec,
                       ensure_faults(cfg, spec, ensure_buffer(cfg, spec,
                                                              state)))


# ---------------------------------------------------------------------------
# Initialisation and draws
# ---------------------------------------------------------------------------

def _exp1(shape, generator: torch.Generator, device: torch.device
          ) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32,
                       device=device).exponential_(generator=generator)


def init_simulation(cfg, *, seed: int = 0, iid: bool = True,
                    device: "str | torch.device" = "cuda",
                    generator: Optional[torch.Generator] = None,
                    scenario: "scenarios.ScenarioSpec | str | None" = None
                    ) -> Tuple[RoundState, RoundBundle, Dict[str, Any]]:
    """Build one simulation: (state, bundle, aux).

    Topology and data come from ``numpy.random.default_rng(seed)`` in the
    reference's order, then the scenario's draws (``scenario``: a
    ``ScenarioSpec``, preset name or kind string), so ``dist``, ``x``,
    ``y``, ``counts``, ``test_x``, ``test_y`` and every leaf of
    ``state.scenario`` equal the reference's bit for bit.  The MLP init
    and the first gains come from ``generator`` (default: a generator on
    ``device`` seeded with ``seed``).  ``aux`` holds the topology, the
    host data, the numpy rng and the ``scenario_spec``.
    """
    sspec = scenarios.preset(scenario)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    topo = make_topology(rng, n_clients=cfg.n_clients, n_edges=cfg.n_edges,
                         area_side_m=cfg.area_side_m)
    data = federated.make_federated(
        rng, n_clients=cfg.n_clients, dim=cfg.input_dim,
        n_classes=cfg.n_classes, iid=iid,
        min_samples=cfg.min_samples, max_samples=cfg.max_samples,
        dirichlet_alpha=cfg.dirichlet_alpha,
        noise=getattr(cfg, "data_noise", 1.2))
    global_params = mlp.init_params(cfg.input_dim, cfg.hidden, cfg.n_classes,
                                    generator=generator, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dist = torch.tensor(topo["dist"], **f32)
    gains = noma.rayleigh_gains(_exp1(dist.shape, generator, dev), dist,
                                path_loss_exponent=cfg.path_loss_exponent)
    state = RoundState(
        global_params=global_params,
        client_params=aggregation.replicate(global_params, cfg.n_clients),
        gains=gains,
        staleness=staleness.init_staleness(cfg.n_clients, dev),
        round_idx=0,
        scenario=scenarios.init_scenario(cfg, sspec, rng, topo, dev))
    bundle = RoundBundle(
        dist=dist,
        x=torch.tensor(data.x, **f32),
        y=torch.tensor(data.y, dtype=torch.int32, device=dev),
        counts=torch.tensor(data.counts, **f32),
        test_x=torch.tensor(data.test_x, **f32),
        test_y=torch.tensor(data.test_y, dtype=torch.int32, device=dev))
    aux = {"topo": topo, "data": data, "rng": rng, "generator": generator,
           "scenario_spec": sspec}
    return state, bundle, aux


def sample_draws(cfg, bundle: RoundBundle, generator: torch.Generator,
                 spec: EngineSpec = EngineSpec()) -> RoundDraws:
    """One round's draws from ``generator`` (on the bundle's device): the
    ``Exp(1)`` fading field; for every client, τ₂ × τ₁ minibatches of
    ``local_batch`` indices uniform over its D_n samples; then, only when
    ``spec`` needs them, rcea's (N, M) and rra's (2, N) uniforms, the
    scenario transition's (U,) uniforms (none on the static kind) and,
    last, with ``spec.faults`` set, the fault layer's (``FaultDraws``) --
    so the static fcea/gcea + ``mid`` stream does not depend on any of
    them, and from one generator state a faulted round's fading and
    lattice are the unfaulted round's.  (The later rounds' draws of a run
    then shift by the extra uniforms: a generator has no counterpart of
    the reference's ``fold_in``, whose stream consumes no split.)"""
    dev = bundle.dist.device
    fading = _exp1(bundle.dist.shape, generator, dev)
    hi = torch.clamp_min(bundle.counts, 1.0)[None, None, :, None]
    u = torch.rand((cfg.tau2, cfg.tau1, cfg.n_clients, cfg.local_batch),
                   generator=generator, device=dev)
    idx = torch.minimum(torch.floor(u * hi), hi - 1.0).to(torch.int32)
    assoc_u = alloc_u = None
    if spec.policy == "rcea":
        assoc_u = torch.rand(bundle.dist.shape, generator=generator,
                             device=dev)
    if spec.allocator == "rra":
        alloc_u = torch.rand((2, cfg.n_clients), generator=generator,
                             device=dev)
    size = scenarios.draw_size(cfg, spec.scenario)
    scen_u = (torch.rand((size,), generator=generator, device=dev) if size
              else torch.empty((0,), device=dev))
    fault_u = None
    if spec.faults is not None:
        n, m = cfg.n_clients, cfg.n_edges
        fault_u = FaultDraws(*(torch.rand((k,), generator=generator,
                                          device=dev) for k in (m, n, n, n)))
    return RoundDraws(fading=fading, batch_idx=idx, assoc_u=assoc_u,
                      alloc_u=alloc_u, scenario=scen_u, faults=fault_u)


def _map(fn, *trees):
    """``fn`` over the tensor leaves of trees of one structure (dicts and
    named tuples: states, bundles, draws, metrics), leaf by leaf.  Other
    leaves (``round_idx``, a missing draw) must be equal across the trees,
    and are kept."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tuple):
        out = [_map(fn, *leaves) for leaves in zip(*trees)]
        return type(first)(*out) if hasattr(first, "_fields") else tuple(out)
    if any(t != first for t in trees[1:]):
        raise ValueError(f"the fleet's members differ in a shared field "
                         f"(round_idx): {list(trees)}")
    return first


def _lift(tree):
    """One simulation's state, bundle or draws as a fleet of one (views)."""
    return _map(lambda t: t[None], tree)


def select_seed(tree, s):
    """Seed ``s`` (an index, or a slice for a smaller fleet) of a fleet's
    state, bundle, draws or metrics: every tensor leaf indexed on its
    leading axis.  Of ``run_fleet``'s metrics, seed s's are shaped as
    ``run_scanned``'s: (n_rounds, …)."""
    return _map(lambda t: t[s], tree)


def stack_fleet(pairs) -> Tuple[RoundState, RoundBundle]:
    """Stack per-seed ``(state, bundle)`` pairs along a new leading fleet
    axis (the reference's ``stack_fleet``): every tensor leaf gains dim 0
    of size S; ``round_idx`` stays one int, which the seeds must share."""
    stack = lambda *leaves: torch.stack(leaves)
    return (_map(stack, *(st for st, _ in pairs)),
            _map(stack, *(b for _, b in pairs)))


def fleet_draws(cfg, bundles: RoundBundle, generators,
                spec: EngineSpec = EngineSpec()) -> RoundDraws:
    """One round's draws for a fleet: seed s's ``sample_draws`` from its
    own ``generators[s]``, stacked along a leading axis -- so each seed
    draws the numbers its own ``run_scanned`` would."""
    if len(generators) != bundles.dist.shape[0]:
        raise ValueError(f"fleet_draws: {len(generators)} generators for "
                         f"{bundles.dist.shape[0]} seeds")
    return _map(lambda *leaves: torch.stack(leaves),
                *(sample_draws(cfg, select_seed(bundles, s), gen, spec)
                  for s, gen in enumerate(generators)))


# ---------------------------------------------------------------------------
# Round pieces, each over a leading fleet axis S
# ---------------------------------------------------------------------------

def _grid_allocate(cfg, spec: EngineSpec, assoc, gains, counts, dist, scen,
                   fixed_axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paper's FPA/FCA benchmarks (§V-D): one action axis pinned at its
    maximum, the other grid-optimised (``env.grid_best_action``) against
    the Eq. 23a bill at z = 1, with the scenario's κ and caps; ``assoc``
    is already availability-masked."""
    params = env.make_env_params(
        cfg, assoc, torch.ones(assoc.shape[:-2] + (cfg.n_edges,),
                               device=assoc.device), dist, counts,
        kappa=scen.kappa if scen is not None else None,
        p_max_w=scen.p_max_w if scen is not None else None,
        f_max_hz=scen.f_max_hz if scen is not None else None)
    a = env.grid_best_action(cfg, params, gains, fixed_axis=fixed_axis,
                             fixed_frac=1.0, noma_enabled=spec.noma_enabled)
    return env.env_decode_action(cfg, params, a)


def _allocate(cfg, spec: EngineSpec, draws: RoundDraws, assoc, gains,
              counts, dist, scen, actor_params: Optional[Params] = None,
              assigned: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p_w (S, N), f_hz (S, N)): ``mid`` takes the midpoints, ``rra`` a
    uniform point of each range from ``draws.alloc_u`` (S, 2, N), ``fpa``
    (power at its maximum) and ``fca`` (frequency at its maximum) the
    grid's best point of the other axis, ``ddpg`` each seed's actor
    (``actor_params`` leaves (S, …)) on the observation of its
    association, or the midpoints with no actor.  ``scen`` is the dynamic
    scenario's state (None on the static path; its availability is then
    the observation's third block); on the frontier ``assigned`` (S, N)
    lets the observation gather each client's own-edge gain."""
    if spec.allocator == "ddpg" and actor_params is not None:
        from repro_torch.core import ddpg      # ddpg imports this module
        avail = None if scen is None else scen.avail
        if assigned is not None:
            obs = env.observe_assigned(
                assigned, candidates.own_edge_gather(assigned, gains),
                counts, avail=avail)
        else:
            obs = env.observe(assoc, gains, counts, avail=avail)
        act = ddpg.actor_apply(actor_params, obs)
        return env.decode_action(cfg, act.unflatten(-1, (2, cfg.n_clients)))
    if spec.allocator in ("fpa", "fca"):
        return _grid_allocate(cfg, spec, assoc, gains, counts, dist, scen,
                              fixed_axis=0 if spec.allocator == "fpa" else 1)
    if spec.allocator == "rra":
        return env.decode_action(cfg, draws.alloc_u)
    shape, dev = draws.fading.shape[:-1], draws.fading.device   # (S, N)
    return (torch.full(shape, 0.5 * (cfg.p_min_w + cfg.p_max_w),
                       device=dev),
            torch.full(shape, 0.5 * (cfg.f_min_hz + cfg.f_max_hz),
                       device=dev))


def _m_c(cfg) -> int:
    """M_c, the edges the semi-synchronous round selects."""
    return max(1, int(round(cfg.semi_sync_fraction * cfg.n_edges)))


def _pdd(cfg, rc_all: cost.RoundCost) -> pdd.PDDResult:
    """PDD over exactly the billed Eq. 23a surface: per-edge time
    ``t_cloud + U_m`` with ``U_m = τ₂ · max_{n∈N_m} t_n``.  All seeds run
    one PDD loop, whose launches do not grow with S."""
    t_cloud = torch.full((cfg.n_edges,),
                         cfg.edge_model_size_bits / cfg.edge_rate_bps,
                         dtype=torch.float32,
                         device=rc_all.per_edge_time_s.device)
    U = rc_all.per_edge_time_s - t_cloud
    return pdd.pdd_schedule(rc_all.per_edge_energy_j, t_cloud, U,
                            lam_t=cfg.lambda_t, lam_e=cfg.lambda_e,
                            quota=_m_c(cfg))


def _schedule(cfg, spec: EngineSpec, rc_all: cost.RoundCost
              ) -> torch.Tensor:
    """Semi-synchronous edge-selection mask z (S, M) from one cost eval:
    PDD's rounded z, or the M_c fastest edges."""
    if spec.scheduler == "pdd":
        return _pdd(cfg, rc_all).z_binary
    return pdd.semi_sync_fastest(rc_all.per_edge_time_s, _m_c(cfg))


def _schedule_traced(cfg, spec: EngineSpec, rc_all: cost.RoundCost
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """``_schedule``'s z and the scheduler internals the trace records:
    (iterations (S,) int32, residual (S,), z_relaxed (S, M)); zeros and
    the final z for "fastest"."""
    if spec.scheduler == "pdd":
        res = _pdd(cfg, rc_all)
        iters = torch.full(res.residual.shape, res.iterations,
                           dtype=torch.int32, device=res.residual.device)
        return res.z_binary, (iters, res.residual, res.z)
    z = _schedule(cfg, spec, rc_all)
    seeds = z.shape[:-1]
    return z, (torch.zeros(seeds, dtype=torch.int32, device=z.device),
               torch.zeros(seeds, dtype=torch.float32, device=z.device), z)


def _train_cohort(cfg, spec: EngineSpec, state: RoundState,
                  bundle: RoundBundle, assoc: torch.Tensor,
                  batch_idx: torch.Tensor, mesh: Optional[Mesh] = None
                  ) -> Tuple[Params, Params, Tuple[torch.Tensor, Params]]:
    """τ₂ × (τ₁ local SGD + edge aggregation) (Eqs. 11, 13) on a compact
    cohort, for every seed of the fleet.  Returns ``(client_params,
    edge_params, (sel_idx, lanes))``, (S, N, …) and (S, M, …), and the
    trained cohort: each lane's client (S, K), N for a pad lane, and
    every lane's model (S, K, …).

    At most K = min(N, quota·M) clients of each seed are admitted, so they
    are gathered once into K lanes (ascending client index, then pad
    lanes), trained and aggregated on the (S, K, …) stack, and scattered
    back once.  Pad lanes repeat client N−1's data and draws, carry zero
    aggregation weight and never scatter back; unadmitted clients keep
    their params.  The lane selection is sync-free: a stable sort of
    ``~selected``.  The S·K lanes are independent, so each τ₂ step trains
    them all in one ``local_sgd_step`` call, at the cluster size of one
    seed's K lanes: each seed's result is its own single run's, bit for
    bit.

    ``assoc`` (S, N, M); ``batch_idx`` (S, τ₂, τ₁, N, B).

    On a client mesh of more than one rank (``run_scanned_client_sharded``,
    S = 1) ``state.client_params``, ``bundle.x`` and ``bundle.y`` hold
    only this rank's rows (``_lane_share``) and every other input is the
    full, replicated one.  The rank trains its own lanes [a, b), still at
    the cluster size of all K, the trained lanes are all-gathered in lane
    order, and edge aggregation and the broadcast run replicated on the
    unsharded stage's inputs: every lane, edge model and row keeps its
    bits.  The rank scatters back only to its own rows; the trained lanes
    it returns are all K, gathered.
    """
    seeds, n = assoc.shape[:2]
    k_sel = min(n, quota_for(cfg, spec) * cfg.n_edges)
    dev = assoc.device
    selected = torch.sum(assoc, dim=-1) > 0                        # (S, N)
    first = torch.argsort((~selected).to(torch.int32), dim=-1,
                          stable=True)[:, :k_sel]
    sel_idx = torch.where(torch.gather(selected, 1, first), first, n)
    safe = torch.clamp_max(sel_idx, n - 1)                         # (S, K)
    lane_ok = (sel_idx < n).to(assoc.dtype)
    sd = torch.arange(seeds, device=dev)[:, None]                  # (S, 1)
    sel_counts = torch.gather(bundle.counts, 1, safe)
    sel_assoc = assoc[sd, safe] * lane_ok[..., None]               # (S,K,M)
    # the lattice is a pure function of the global client id, so the
    # lanes' draws are the full lattice gathered at ``safe``, laid out
    # (τ₂, τ₁, S, K, B) for the folded S·K lanes
    _, tau2, tau1, _, batch = batch_idx.shape
    idx = torch.gather(batch_idx, 3, safe[:, None, None, :, None].expand(
        seeds, tau2, tau1, k_sel, batch)).long().permute(1, 2, 0, 3, 4)
    n_rows = next(iter(state.client_params.values())).shape[1]
    a, b, lo, gather = _lane_share(mesh, safe, n, n_rows)
    k_own = b - a
    mine = safe[:, a:b] - lo if lo else safe[:, a:b]               # (S, k)
    sel_x, sel_y = bundle.x[sd, mine], bundle.y[sd, mine]          # (S,k,…)
    sd4 = sd[None, :, :, None]
    lane = torch.arange(k_own, device=dev)[None, None, :, None]

    # admitted lanes start from the global model (the broadcast is
    # lane-local: a one-hot row picks one edge model exactly)
    edge_params = aggregation.replicate(state.global_params, cfg.n_edges,
                                        lead=1)
    lane_params = {k: v[sd, mine] for k, v in state.client_params.items()}
    lane_params = aggregation.broadcast_to_clients(sel_assoc[:, a:b],
                                                   edge_params, lane_params)
    all_lanes = lane_params
    for t in range(cfg.tau2):
        if k_own:
            it = idx[t][:, :, a:b]
            bx = sel_x[sd4, lane, it]                          # (τ₁,S,k,B,D)
            by = sel_y[sd4, lane, it]                          # (τ₁,S,k,B)
            folded = hfl_ops.local_sgd_step(
                {k: v.reshape((seeds * k_own,) + v.shape[2:])
                 for k, v in lane_params.items()},
                bx.reshape((tau1, seeds * k_own) + bx.shape[3:]),
                by.reshape(tau1, seeds * k_own, batch), lr=cfg.lr,
                seeds=seeds, cluster_lanes=k_sel)
            lane_params = {k: v.reshape((seeds, k_own) + v.shape[1:])
                           for k, v in folded.items()}
        all_lanes = gather(lane_params)
        edge_params = aggregation.edge_aggregate(all_lanes, sel_assoc,
                                                 sel_counts)
        all_lanes = aggregation.broadcast_to_clients(sel_assoc, edge_params,
                                                     all_lanes)
        lane_params = (all_lanes if k_own == k_sel
                       else {k: v[:, a:b] for k, v in all_lanes.items()})
    # scatter back to the rank's rows (a pad lane's n_rows is dropped)
    dest = sel_idx[:, a:b]
    if n_rows != n:
        dest = torch.where(dest < n, dest - lo, n_rows)
    client_params = {k: _scatter_rows(old, dest, lane_params[k])
                     for k, old in state.client_params.items()}
    return client_params, edge_params, (sel_idx, all_lanes)


def _scatter_rows(base: torch.Tensor, dest: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """``base`` (S, n, …) with ``values`` (S, k, …) written at rows
    ``dest`` (S, k): a destination of n (a pad lane) goes to each seed's
    scratch row n, dropped."""
    seeds, n = base.shape[:2]
    sd = torch.arange(seeds, device=dest.device)[:, None]
    rows = (sd * (n + 1) + dest).reshape(-1)
    buf = torch.cat([base, base[:, :1]], dim=1)
    buf.reshape((seeds * (n + 1),) + base.shape[2:]).index_copy_(
        0, rows, values.reshape((rows.numel(),) + base.shape[2:]))
    return buf[:, :n]


def _lane_share(mesh: Optional[Mesh], safe: torch.Tensor, n: int,
                n_rows: int):
    """This rank's share of the K lanes: ``(a, b, lo, gather)``.  On a
    client mesh of W > 1 ranks the rank holds client rows [lo, lo + R),
    R = N / W; the lanes are in ascending client order, so its lanes are
    a contiguous range [a, b) (one host read a round finds the ranges),
    and ``gather`` takes every rank's trained lanes (1, b − a, …) to all
    K, (1, K, …), in lane order.  Otherwise every lane, lo = 0 and no
    gather."""
    k_sel = safe.shape[1]
    if not _client_split(mesh):
        return 0, k_sel, 0, lambda lanes: lanes
    if safe.shape[0] != 1:
        raise ValueError("the client axis shards one simulation, not a "
                         f"fleet of {safe.shape[0]}")
    if n_rows * mesh.world != n:
        raise ValueError(f"client_params hold {n_rows} rows a rank; {n} "
                         f"clients over {mesh.world} ranks need "
                         f"{n // mesh.world} (shard_clients)")
    edges = torch.arange(mesh.world + 1, device=safe.device) * n_rows
    bounds = torch.searchsorted(safe[0].contiguous(), edges).tolist()
    counts = [b - a for a, b in zip(bounds[:-1], bounds[1:])]

    def gather(lanes: Params) -> Params:
        full = _all_gather_rows(mesh, {k: v[0] for k, v in lanes.items()},
                                counts)
        return {k: v[None] for k, v in full.items()}

    return (bounds[mesh.rank], bounds[mesh.rank + 1], mesh.rank * n_rows,
            gather)


def _client_split(mesh: Optional[Mesh]) -> bool:
    """A client mesh of more than one rank: each holds a share of the
    client rows."""
    return mesh is not None and mesh.world > 1


def _row_share(mesh: Optional[Mesh], n: int) -> Tuple[int, int]:
    """``(lo, R)``: this rank's client rows [lo, lo + R) of N on a split
    client axis, else all N."""
    if not _client_split(mesh):
        return 0, n
    rows = n // mesh.world
    return mesh.rank * rows, rows


def _all_gather_rows(mesh: Mesh, rows: Params, counts) -> Params:
    """Every rank's rows (leaves (counts[rank], …)) gathered in rank order,
    leaves (Σ counts, …): the leaves packed into one flat gather, in one
    key order on every rank (a rank without rows may hold its dict in
    another order than one with)."""
    keys = sorted(rows)
    flat = torch.cat([rows[k].flatten(1) for k in keys], 1)
    full = mesh.all_gather_ragged(flat, counts)                    # (L, P)
    out, at = {}, 0
    for k in keys:
        shape = tuple(rows[k].shape[1:])
        size = int(np.prod(shape, dtype=np.int64))
        out[k] = full[:, at:at + size].reshape(
            (full.shape[0],) + shape).contiguous()
        at += size
    return {k: out[k] for k in rows}


def _trained_rows(global_params: Params, sel_idx: torch.Tensor,
                  lanes: Params, n: int) -> Params:
    """An (S, N, …) client stack with the trained ``lanes`` (S, K, …) at
    their clients' rows ``sel_idx`` (S, K; a pad lane's N is dropped) and
    the global model everywhere else."""
    seeds = sel_idx.shape[0]
    return {k: _scatter_rows(g[:, None].expand((seeds, n) + g.shape[1:]),
                             sel_idx, lanes[k])
            for k, g in global_params.items()}


def _landed_sum(mesh: Mesh, delta_sum: Params, weight_sum: torch.Tensor,
                land_tree: Params, w: torch.Tensor, landed: torch.Tensor,
                n: int, finite: bool) -> Tuple[Params, torch.Tensor]:
    """``aggregation.buffer_accumulate`` on a split client axis, bit-equal
    to the whole stack's.  ``land_tree`` holds this rank's rows (1, R, …),
    ``w`` and ``landed`` (1, N) are replicated.  The landed rows, and any
    other row that is not finite (its zero-weight product is NaN in the
    whole sum; the ranks' verdicts all-gathered, unless ``finite`` says
    the tree is, as the quarantine's is), are gathered from every rank in
    ascending client order, and each leaf's N-row stack -- those rows,
    zeros elsewhere -- runs the unchanged accumulate, one leaf's stack at
    a time.  A row left out enters the whole stack's sum as row · 0, ±0.0,
    and here as +0.0: the two sums differ at most in a zero's sign, and
    the accumulator (+0.0 at the start and after each merge, and never
    −0.0 after, since x + (−x) is +0.0) adds either to the same bits."""
    lo, rows = _row_share(mesh, n)
    take = landed
    if not finite:
        take = landed | ~mesh.all_gather(
            fault_guard.delta_finite(land_tree, 2)[0])[None]
    idx = torch.nonzero(take[0]).flatten()
    bounds = torch.searchsorted(idx, torch.arange(
        mesh.world + 1, device=idx.device) * rows).tolist()
    counts = [b - a for a, b in zip(bounds[:-1], bounds[1:])]
    mine = idx[bounds[mesh.rank]:bounds[mesh.rank + 1]] - lo
    full = _all_gather_rows(mesh, {k: v[0, mine]
                                   for k, v in land_tree.items()}, counts)
    out = {}
    for k, acc in delta_sum.items():
        stack = land_tree[k].new_zeros((1, n) + land_tree[k].shape[2:])
        stack[0, idx] = full[k]
        part, total = aggregation.buffer_accumulate(
            {k: acc}, weight_sum, {k: stack}, w)
        out[k] = part[k]
        del stack
    return out, total


def _train(cfg, spec: EngineSpec, state: RoundState, bundle: RoundBundle,
           assoc: torch.Tensor, z: torch.Tensor, batch_idx: torch.Tensor,
           mesh: Optional[Mesh] = None) -> Tuple[Params, Params]:
    """``_train_cohort`` followed by the semi-synchronous cloud aggregation
    (Eq. 17) of each seed.  Returns ``(global_params, client_params)``."""
    client_params, edge_params, _ = _train_cohort(cfg, spec, state, bundle,
                                                  assoc, batch_idx, mesh)
    edge_data = torch.sum(assoc * bundle.counts[..., None], dim=-2)  # (S,M)
    z_eff = z * (edge_data > 0).to(z.dtype)
    agg = aggregation.cloud_aggregate(edge_params, z_eff, edge_data)
    # keep a seed's old global model when none of its selected edges has
    # data
    has_data = torch.sum(z_eff * edge_data, dim=-1) > 0             # (S,)
    global_params = {
        k: torch.where(has_data.reshape((-1,) + (1,) * (g.dim() - 1)),
                       agg[k], g)
        for k, g in state.global_params.items()}
    return global_params, client_params


def _train_faulty(cfg, spec: EngineSpec, state: RoundState,
                  bundle: RoundBundle, assoc: torch.Tensor, z: torch.Tensor,
                  batch_idx: torch.Tensor, gains: torch.Tensor,
                  edge_up: torch.Tensor, fd: FaultDraws,
                  mesh: Optional[Mesh] = None):
    """The sync training stage under faults (the reference's
    ``_train_faulty``): ``_train_cohort`` unchanged, then the cloud
    epilogue in delta space.  Each selected client's update (its trained
    model minus the global it pulled) runs the gauntlet -- a mid-round
    crash, SINR-tied uplink loss (the sync engine has no buffer to retry
    from), poisoning of the transmitted copy, the quarantine -- and only
    the surviving, guard-cleaned deltas reach
    ``faulted_cloud_aggregate``.  Local params are never poisoned.
    Returns ``(global', client_params, (ok, crashed, lost, n_rejected))``,
    ``ok`` (S, N) the surviving clients.

    On a split client axis (``mesh``) a rank holds only its rows of
    ``client_params``, so every rank forms the (S, N, …) deltas from the
    K trained lanes ``_train_cohort`` gathered (``_trained_rows``; no
    other collective), and the epilogue runs replicated on the whole
    stack's shape.  Its rows differ from the unsharded stack's only where
    a client was not trained (a zero delta here), and those are never
    delivered: the quarantine turns them into zeros of weight 0, which
    move the aggregate's sums at most in a zero's sign."""
    fsp = spec.faults
    client_params, _, (sel_idx, lanes) = _train_cohort(
        cfg, spec, state, bundle, assoc, batch_idx, mesh)
    selected = torch.sum(assoc, dim=-1) > 0
    crashed = fault_inject.draw_crashes(fsp, fd.crash_u, selected)
    lost = fault_inject.draw_losses(fsp, fd.loss_u, gains, edge_up,
                                    selected & ~crashed)
    delivered = selected & ~crashed & ~lost
    trained = (_trained_rows(state.global_params, sel_idx, lanes,
                             cfg.n_clients)
               if _client_split(mesh) else client_params)
    deltas = {k: c - state.global_params[k][:, None]
              for k, c in trained.items()}
    deltas, _ = fault_inject.poison_deltas(fsp, fd.poison_u, deltas,
                                           delivered)
    clean, ok, n_rej = fault_guard.quarantine(deltas, delivered,
                                              fsp.quarantine_clip)
    assoc_eff = assoc * ok.to(assoc.dtype)[..., None]
    global_params = aggregation.faulted_cloud_aggregate(
        state.global_params, clean, assoc_eff, bundle.counts, z)
    return global_params, client_params, (ok, crashed, lost, n_rej)


def _fault_trace(cfg, edge_up, dist, avail, retries, dropped, rejected):
    """The trace's fault leaves (dead_edges, orphaned_clients,
    uplink_retries, uplink_dropped, quarantined), each (S,) int32;
    ``dist`` the physical field."""
    return (torch.sum(edge_up <= 0, dim=-1, dtype=torch.int32),
            fault_inject.orphan_count(dist, edge_up, coverage_radius(cfg),
                                      avail),
            retries, dropped, rejected)


def _associate(cfg, spec: EngineSpec, states: RoundState,
               bundles: RoundBundle, gains, dist, avail, assoc_u,
               edge_up=None):
    """Fuzzy scoring + association of every seed, dense or on the (N, K)
    frontier, from ``gains``, ``dist`` and the availability ``avail``
    (None on the static kind: every client available); an unavailable
    client is out of coverage.  ``edge_up`` (S, M), the fault layer's
    live edges (None: all live), routes around the dead ones: the dense
    path associates on ``fault_inject.masked_dist``, the frontier marks
    their slots invalid and keeps its distances physical.  Returns the
    float (S, N, M) one-hot, the frontier's (S, N) assigned edges and its
    ``CandidateSet`` (both None when dense) and the sweeps (a list, one a
    seed; with a warm seed in ``states.warm``, warm plus any cold
    fallback).  The one definition of the association: ``fleet_step``,
    ``fleet_buffered_step`` and ``fleet_snapshot`` call it."""
    assigned = cand = None
    data_max = float(cfg.max_samples)
    if spec.candidates_k is not None:
        cand = candidates.build_candidates(
            dist, spec.candidates_k,
            coverage_radius_m=coverage_radius(cfg), avail=avail,
            edge_up=edge_up)
        scores = None
        if spec.policy == "fcea":
            scores = hfl_ops.score_candidates(
                gains, cand.idx, bundles.counts, states.staleness,
                data_max=data_max)
        assigned, sweeps = association.associate_candidates(
            spec.policy, scores=scores, gains=gains, cand=cand,
            quota=quota_for(cfg, spec), n_edges=cfg.n_edges,
            uniform=assoc_u, return_sweeps=True, seed=states.warm)
        assoc = candidates.assigned_one_hot(assigned, cfg.n_edges)
    else:
        if edge_up is not None:
            dist = fault_inject.masked_dist(dist, edge_up)
        scores = None
        if spec.policy == "fcea":
            scores = hfl_ops.score_matrix(gains, bundles.counts,
                                          states.staleness,
                                          data_max=data_max)
        assoc, sweeps = association.associate(
            spec.policy, scores=scores, gains=gains, dist=dist,
            quota=quota_for(cfg, spec),
            coverage_radius_m=coverage_radius(cfg),
            uniform=assoc_u, avail=avail, return_sweeps=True,
            seed=states.warm)
    assoc = assoc.float()
    if avail is not None and assigned is None:
        # the explicit Eq. 11/17/23a mask: no policy trains on,
        # aggregates or bills a dropped client (the frontier's
        # ``valid`` already excludes it)
        assoc = assoc * avail[..., None]
    return assoc, assigned, cand, sweeps


def _next_warm(spec: EngineSpec, assoc: torch.Tensor,
               assigned: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The seed the next round's resolver starts from, (S, N) int32, or
    None with the warm start off: the frontier's compact assigned vector,
    or each dense row's edge (−1 for a row with no edge), read off the
    one-hot after the availability or tier mask."""
    if not spec.warm_start:
        return None
    if assigned is not None:
        return assigned.to(torch.int32)
    return torch.where(torch.sum(assoc, dim=-1) > 0,
                       torch.argmax(assoc, dim=-1).to(torch.int32),
                       -1).to(torch.int32)


def _device_sweeps(sweeps, dev: torch.device) -> torch.Tensor:
    """The resolver's host sweep counts as the trace's (S,) int32 leaf on
    ``dev``: an asynchronous copy (a blocking one would wait for the
    round's queued kernels)."""
    return torch.tensor(sweeps, dtype=torch.int32).to(dev, non_blocking=True)


@contextlib.contextmanager
def _stage(timer, name: str, device: torch.device):
    """A stage's ``spans.stage`` range, and inside it the caller's
    ``timer(name)`` span, if any."""
    with spans.stage(name, device):
        if timer is None:
            yield
        else:
            with timer(name):
                yield


def fleet_step(cfg, spec: EngineSpec, states: RoundState,
               bundles: RoundBundle, draws: RoundDraws,
               actor_params: Optional[Params] = None, *, timer=None,
               mesh: Optional[Mesh] = None
               ) -> Tuple[RoundState, RoundMetrics]:
    """One global round of S simulations at once: every leaf of
    ``states``, ``bundles`` and ``draws`` has a leading fleet axis S
    (``stack_fleet``, ``fleet_draws``); ``round_idx`` is shared.  Each
    stage runs once for the whole fleet -- one fused-score call, one
    resolver loop (each seed stopping at its own last sweep), one SIC
    call, one PDD loop, τ₂ SGD launches over the S·K lanes -- and each
    seed's result is the one its own ``round_step`` gives.  Metrics have a
    leading S axis (``round`` stays an int, and so does ``n_available`` on
    the static kind; ``sweeps`` is an (S,) host tensor).  On a dynamic
    kind the scenario advances first, each seed from its own state and
    uniforms, so a fleet of mixed worlds is one round.  ``actor_params``:
    the ``ddpg`` allocator's actors, leaves (S, …), one a seed.  Each
    stage (scenario, on a dynamic kind only; associate, allocate,
    schedule, train, eval) runs inside its ``spans.stage`` range and,
    when ``timer`` is given, inside ``timer(name)``, a context manager
    (the hook stage timings use).

    The carry is first normalised to the spec (``ensure_carry``); with
    ``engine_mode="buffered"`` the step is ``fleet_buffered_step``.  With
    ``telemetry`` the output is ``(metrics, trace)``, the trace's leaves
    (S, …).

    With ``spec.faults`` the churn advances after fading and association
    routes around the dead edges (allocation and the bill keep the
    physical distances); a dead edge is taken out of z after scheduling
    (the trace's ``z_relaxed`` stays PDD's); training runs the fault
    gauntlet (``_train_faulty``) and Eq. 20 resets only the surviving
    clients.

    ``mesh``: a client mesh (``run_scanned_client_sharded``), whose ranks
    each hold a block of the client rows of ``client_params``, ``x``, ``y``
    and the buffer's ``pending_delta``; the train stage reads it, and the
    fault epilogue and the buffered landing after it.  None: today's
    round."""
    states = ensure_carry(cfg, spec, states)
    if spec.engine_mode == "buffered":
        return fleet_buffered_step(cfg, spec, states, bundles, draws,
                                   actor_params, timer=timer, mesh=mesh)
    dev = bundles.dist.device
    stage = lambda name: _stage(timer, name, dev)        # noqa: E731
    seeds = bundles.dist.shape[0]
    n, m = cfg.n_clients, cfg.n_edges
    # 0. the scenario transition: the static kind keeps the bundle's
    #    distances and every client available
    dynamic = spec.scenario != "static"
    if dynamic:
        with stage("scenario"):
            scen = scenarios.advance(cfg, spec.scenario, draws.scenario,
                                     states.scenario)
        dist, avail = scen.dist, scen.avail
    else:
        scen = states.scenario
        dist, avail = bundles.dist, None
    # 1. channel fading (distances may have just moved)
    gains = noma.evolve_gains(draws.fading, states.gains, dist,
                              path_loss_exponent=cfg.path_loss_exponent,
                              rho=spec.fading_rho)
    # 1b. the fault layer: one churn step of the live-edge mask
    fsp = spec.faults
    edge_up = (fault_inject.advance_edges(fsp, draws.faults.edge_u,
                                          states.faults.edge_up)
               if fsp is not None else None)
    # 2. fuzzy scoring + association, dense or on the (N, K) frontier;
    #    unavailable clients and dead edges are out of coverage this round
    with stage("associate"):
        assoc, assigned, cand, sweeps = _associate(
            cfg, spec, states, bundles, gains, dist, avail, draws.assoc_u,
            edge_up)
    # 3. resource allocation, clamped to the device classes' caps
    with stage("allocate"):
        p, f = _allocate(cfg, spec, draws, assoc, gains, bundles.counts,
                         dist, scen if dynamic else None, actor_params,
                         assigned)
        if dynamic:
            p = torch.minimum(p, scen.p_max_w)
            f = torch.minimum(f, scen.f_max_hz)
    # 4. one cost evaluation at z = 1, reused by the scheduler and the
    #    final masked round cost
    with stage("schedule"):
        rc_all = cost.round_cost(cfg, power_w=p, f_hz=f, gains=gains,
                                 assoc=assoc,
                                 z=torch.ones((seeds, m), device=dev),
                                 n_samples=bundles.counts,
                                 noma_enabled=spec.noma_enabled,
                                 capacitance=scen.kappa if dynamic else None,
                                 sic_max_per_edge=quota_for(cfg, spec),
                                 assigned=assigned)
        if spec.telemetry:
            z, sched = _schedule_traced(cfg, spec, rc_all)
        else:
            z = _schedule(cfg, spec, rc_all)
        if fsp is not None:
            # a dead edge cannot be scheduled: out of the Eq. 18/19 bill
            z = z * (edge_up > 0).to(z.dtype)
        rc = cost.apply_schedule(cfg, rc_all, z)
    # 5. τ₂·τ₁ training + hierarchical aggregation
    with stage("train"):
        if fsp is not None:
            global_params, client_params, (ok, crashed, lost, n_rej) = \
                _train_faulty(cfg, spec, states, bundles, assoc, z,
                              draws.batch_idx, gains, edge_up, draws.faults,
                              mesh)
        else:
            global_params, client_params = _train(
                cfg, spec, states, bundles, assoc, z, draws.batch_idx, mesh)
    # 6. staleness (Eq. 20): reset only for clients whose edge was selected
    #    (and, under faults, whose update survived to aggregation)
    selected = torch.sum(assoc, dim=-1) > 0
    effective = (ok if fsp is not None else selected) & torch.gather(
        z > 0, -1, torch.argmax(assoc, dim=-1))
    new_stale = staleness.update_staleness(states.staleness, effective)
    round_idx = states.round_idx + 1
    with stage("eval"):
        accuracy = mlp.accuracy(global_params, bundles.test_x,
                                bundles.test_y)
        loss = mlp.loss(global_params, bundles.test_x, bundles.test_y)
    metrics = RoundMetrics(
        round=round_idx,
        accuracy=accuracy,
        loss=loss,
        avg_staleness=torch.mean(new_stale.float(), dim=-1),
        total_time_s=rc.total_time_s,
        total_energy_j=rc.total_energy_j,
        cost=rc.cost,
        n_associated=torch.sum(selected, dim=-1, dtype=torch.int32),
        n_available=(torch.sum(avail > 0, dim=-1, dtype=torch.int32)
                     if dynamic else n),
        z=z,
        sweeps=torch.tensor(sweeps))
    new_faults = fault_tr = None
    if fsp is not None:
        flt: FaultState = states.faults
        i32 = torch.int32
        n_crash = torch.sum(crashed, dim=-1, dtype=i32)
        n_drop = torch.sum(lost, dim=-1, dtype=i32) + n_crash
        # the sync engine has no buffer to retry from
        new_faults = FaultState(
            edge_up=edge_up, attempts=flt.attempts, n_retries=flt.n_retries,
            n_dropped=flt.n_dropped + n_drop,
            n_quarantined=flt.n_quarantined + n_rej,
            n_crashed=flt.n_crashed + n_crash)
        fault_tr = _fault_trace(cfg, edge_up, dist, avail,
                                torch.zeros_like(n_drop), n_drop, n_rej)
    new_state = RoundState(global_params, client_params, gains, new_stale,
                           round_idx, scen, None, new_faults,
                           _next_warm(spec, assoc, assigned))
    if spec.telemetry:
        tr = telemetry_trace.round_trace(
            cfg, spec, round_idx=round_idx, rc_all=rc_all, z=z,
            assoc=assoc, power_w=p, f_hz=f, counts=bundles.counts,
            staleness=new_stale, capacitance=scen.kappa if dynamic else None,
            sweeps=_device_sweeps(sweeps, dev), sched=sched, cand=cand,
            assigned=assigned, dist=dist, avail=avail,
            coverage_radius_m=coverage_radius(cfg), faults=fault_tr)
        return new_state, (metrics, tr)
    return new_state, metrics


def fleet_buffered_step(cfg, spec: EngineSpec, states: RoundState,
                        bundles: RoundBundle, draws: RoundDraws,
                        actor_params: Optional[Params] = None, *,
                        timer=None, mesh: Optional[Mesh] = None):
    """One buffered micro-step of S simulations (the reference's
    ``_buffered_step``), from the same ``RoundDraws`` as a sync round;
    ``states.buffer`` must be attached (``fleet_step`` does so):

    1. gate the market to the idle clients of each seed's current TiFL
       tier and run the unchanged association and allocation stages on
       that cohort;
    2. bill it at z = 1 (no edge scheduler), train it from the current
       global model (``_train_cohort``) and park its deltas in flight with
       their Eq. 13/15 virtual finish times;
    3. advance the virtual clock to the next finish or the timeout
       deadline, and land every finished update in the buffer with the
       weight w(age) · D_n;
    4. merge (a ``buffer_lr`` step on the weighted mean delta) when the
       buffer holds ``buffer_fill_for`` updates or ``timeout_s`` passed
       since the last trigger;
    5. every ``retier_every`` micro-steps, re-tier by the quantiles of
       the per-client duration EMA;
    6. Eq. 20 on the landed clients, and the ``cohort_cost`` bill.

    With ``spec.faults`` the churn advances after fading and association
    routes around the dead edges; an admitted client may crash (billed,
    it does not fly); the in-flight copy of a delta may be poisoned; a
    finished upload may be lost, then retried at ``clock +
    backoff_s(attempts)`` or, out of attempts, dropped; only the
    quarantined tree reaches the buffer; and a trigger merges only with
    ``min_participation`` updates buffered (it still moves the timer).

    ``metrics.total_time_s`` is the clock's advance, ``metrics.z`` the
    applied merge broadcast over the edges, ``metrics.round`` counts
    micro-steps.  Every scalar of the step is a float32 (or int32) tensor
    a seed: Python floats would compare in float64.  Nothing is read back
    to the host but the resolver's sweeps, and no constant is copied to
    the card (``torch.tensor(v, device=...)`` is a blocking copy: each
    scalar is a fill).

    On a split client axis (``mesh``, S = 1) a rank holds its rows [lo,
    lo + R) of ``client_params`` and of ``buffer.pending_delta``, and
    every other leaf whole.  It trains its lanes (``_train_cohort``) and
    parks, poisons and quarantines its own rows, the quarantine's norms
    taken inside an N-row stack (``fault_guard.quarantine(rows=)``); the
    quarantine's per-row verdict is all-gathered (N flags), so every rank
    holds the same ``landed``, and the landing gathers the landed rows
    into the stack the whole sum reads (``_landed_sum``).  The clock, the
    trigger, the retier and the bill run replicated, bit-equal to the
    unsharded step on the same world."""
    dev = bundles.dist.device
    stage = lambda name: _stage(timer, name, dev)        # noqa: E731
    buf: BufferState = states.buffer
    n = cfg.n_clients
    split = _client_split(mesh)
    lo, n_rows = _row_share(mesh, n)
    own = slice(lo, lo + n_rows)          # this rank's rows of (S, N) masks
    f32, i32 = torch.float32, torch.int32
    n_tiers = max(1, int(spec.n_tiers))

    def scalar(v):
        return torch.full((), v, dtype=f32, device=dev)

    def col(mask, leaf):
        return mask.reshape(mask.shape + (1,) * (leaf.dim() - mask.dim()))

    # 0. the scenario transition and the fading, as in the sync round
    dynamic = spec.scenario != "static"
    if dynamic:
        with stage("scenario"):
            scen = scenarios.advance(cfg, spec.scenario, draws.scenario,
                                     states.scenario)
        dist, avail = scen.dist, scen.avail
    else:
        scen = states.scenario
        dist = bundles.dist
        avail = torch.ones(states.staleness.shape, dtype=f32, device=dev)
    gains = noma.evolve_gains(draws.fading, states.gains, dist,
                              path_loss_exponent=cfg.path_loss_exponent,
                              rho=spec.fading_rho)
    # 0b. the fault layer: one churn step of the live-edge mask
    fsp = spec.faults
    fd = draws.faults
    edge_up = (fault_inject.advance_edges(fsp, fd.edge_u,
                                          states.faults.edge_up)
               if fsp is not None else None)

    # 1. the TiFL cohort gate: only idle clients of the scheduled tier
    #    enter this micro-step's market
    cur_tier = torch.remainder(buf.step, n_tiers)                 # (S,)
    eligible = ((~buf.in_flight) & (buf.tier == cur_tier[:, None])
                ).to(f32) * avail
    with stage("associate"):
        assoc, assigned, cand, sweeps = _associate(
            cfg, spec, states, bundles, gains, dist, eligible,
            draws.assoc_u, edge_up)
    with stage("allocate"):
        p, f = _allocate(cfg, spec, draws, assoc, gains, bundles.counts,
                         dist, scen if dynamic else None, actor_params,
                         assigned)
        if dynamic:
            p = torch.minimum(p, scen.p_max_w)
            f = torch.minimum(f, scen.f_max_hz)

    # 2. the per-client Eq. 13/15 surface at z = 1: finish times and the
    #    cohort's bill (no edge is scheduled)
    with stage("schedule"):
        rc_all = cost.round_cost(cfg, power_w=p, f_hz=f, gains=gains,
                                 assoc=assoc,
                                 z=torch.ones(assoc.shape[:-2]
                                              + (cfg.n_edges,), device=dev),
                                 n_samples=bundles.counts,
                                 noma_enabled=spec.noma_enabled,
                                 capacitance=scen.kappa if dynamic else None,
                                 sic_max_per_edge=quota_for(cfg, spec),
                                 assigned=assigned)
    admitted = torch.sum(assoc, dim=-1) > 0                       # (S, N)
    if fsp is not None:
        # a mid-round crash: the cohort's bill charges the admitted client,
        # but its update never takes flight
        crashed = fault_inject.draw_crashes(fsp, fd.crash_u, admitted)
        flying = admitted & ~crashed
    else:
        flying = admitted

    # 3. train the cohort from the current global model and park its
    #    deltas (trained minus the pulled global) in flight
    with stage("train"):
        client_params, _, _ = _train_cohort(cfg, spec, states, bundles,
                                            assoc, draws.batch_idx, mesh)
    flying_own = flying[:, own]
    pending = {k: torch.where(col(flying_own, c), c - states.global_params[k][
        :, None], buf.pending_delta[k]) for k, c in client_params.items()}
    if fsp is not None:
        # poisoning corrupts the transmitted (in-flight) copy, never the
        # local params; a new upload resets its retry ledger
        pending, _ = fault_inject.poison_deltas(fsp, fd.poison_u[:, own],
                                                pending, flying_own)
        attempts0 = torch.where(flying, 0, states.faults.attempts).to(i32)
    # modelled wall duration: τ₂ edge iterations + the edge→cloud hop
    dur = cfg.tau2 * rc_all.client_time_s \
        + scalar(cfg.edge_model_size_bits / cfg.edge_rate_bps)
    finish = torch.where(flying, buf.clock_s[:, None] + dur, buf.finish_s)
    in_flight = buf.in_flight | flying
    pulled = torch.where(flying, buf.version[:, None], buf.pulled_ver)
    obs = torch.where(flying,
                      torch.where(buf.obs_s > 0.0,
                                  0.5 * buf.obs_s + 0.5 * dur, dur),
                      buf.obs_s)

    # 4. the event clock: jump to the earliest in-flight finish or the
    #    timeout deadline, whichever is sooner (never backwards)
    big = scalar(torch.finfo(f32).max)
    next_fin = torch.amin(torch.where(in_flight, finish, big), dim=-1)
    deadline = buf.last_agg_s + scalar(spec.timeout_s)
    target = torch.where(torch.any(in_flight, dim=-1),
                         torch.minimum(next_fin, deadline), deadline)
    clock = torch.maximum(buf.clock_s, target)
    dt = clock - buf.clock_s

    # 5. land every finished update with its staleness weight
    eps = scalar(1e-5)
    landed = in_flight & (finish <= (clock + eps)[:, None])
    land_tree = pending
    if fsp is not None:
        # 5b. uplink loss and retry/backoff: a finished upload is lost with
        #     its SINR-tied probability; with attempts left it re-enters
        #     flight at a backed-off finish time, else it is dropped.  The
        #     delivered updates pass the quarantine, and only the cleaned
        #     tree reaches the buffer (the raw copy stays in the carry for
        #     a retry to re-send)
        landed_raw = landed
        lost = fault_inject.draw_losses(fsp, fd.loss_u, gains, edge_up,
                                        landed_raw)
        can_retry = lost & (attempts0 < int(fsp.max_attempts))
        dropped = lost & ~can_retry
        finish = torch.where(can_retry,
                             clock[:, None]
                             + fault_inject.backoff_s(fsp, attempts0),
                             finish)
        attempts = torch.where(can_retry, attempts0 + 1, attempts0)
        produced = landed_raw & ~lost
        if split:
            land_tree, ok, _ = fault_guard.quarantine(
                pending, produced[:, own], fsp.quarantine_clip, (n, lo))
            landed = mesh.all_gather(ok[0])[None]
            n_rej = torch.sum(produced & ~landed, dim=-1, dtype=i32)
        else:
            land_tree, landed, n_rej = fault_guard.quarantine(
                pending, produced, fsp.quarantine_clip)
    age = staleness.buffer_age(buf.version[:, None], pulled)
    w = torch.where(landed, staleness.buffer_weight(age) * bundles.counts,
                    0.0)
    if split:
        delta_sum, weight_sum = _landed_sum(
            mesh, buf.delta_sum, buf.weight_sum, land_tree, w, landed, n,
            finite=fsp is not None)
    else:
        delta_sum, weight_sum = aggregation.buffer_accumulate(
            buf.delta_sum, buf.weight_sum, land_tree, w)
    fill = buf.fill + torch.sum(landed, dim=-1, dtype=i32)
    if fsp is not None:
        in_flight = (in_flight & ~landed_raw) | can_retry
    else:
        in_flight = in_flight & ~landed

    # 6. the fill-or-timeout trigger: ``applied`` (the merge changed the
    #    model) bumps the version; ``fired`` alone resets the timer, so an
    #    empty timeout does not freeze the clock.  Under faults a trigger
    #    merges only with ``min_participation`` updates buffered (at the
    #    default 1 this is the trigger itself: fill 0 means an empty
    #    buffer)
    fill_target = buffer_fill_for(cfg, spec)
    by_fill = fill >= fill_target
    fired = by_fill | (clock >= deadline - eps)
    do_merge = (fired & (fill >= max(1, int(fsp.min_participation)))
                if fsp is not None else fired)
    applied = do_merge & (weight_sum > 0.0)
    global_params = aggregation.buffer_apply(
        states.global_params, delta_sum, weight_sum, do_merge,
        spec.buffer_lr)
    delta_sum = {k: torch.where(col(do_merge, d), 0.0, d)
                 for k, d in delta_sum.items()}
    weight_sum = torch.where(do_merge, 0.0, weight_sum)
    fill_after = torch.where(do_merge, 0, fill).to(i32)
    version = buf.version + applied.to(i32)
    last_agg = torch.where(fired, clock, buf.last_agg_s)

    # 7. the TiFL retier: quantile tiers over the duration EMA (rank ·
    #    n_tiers // N); unmeasured clients (obs 0) tie and sort first by
    #    index, so both sorts are stable as the reference's
    step1 = buf.step + 1
    do_retier = torch.remainder(step1, max(1, int(spec.retier_every))) == 0
    rank = torch.argsort(torch.argsort(obs, dim=-1, stable=True), dim=-1,
                         stable=True)
    tier = torch.where(do_retier[:, None], (rank * n_tiers) // n,
                       buf.tier).to(i32)

    # 8. Eq. 20 a micro-step: landing is this engine's orchestration, so
    #    a drained client re-enters fresh
    new_stale = staleness.update_staleness(states.staleness, landed)
    rc = cost.cohort_cost(cfg, rc_all, admitted, dt, applied)
    round_idx = states.round_idx + 1
    with stage("eval"):
        accuracy = mlp.accuracy(global_params, bundles.test_x,
                                bundles.test_y)
        loss = mlp.loss(global_params, bundles.test_x, bundles.test_y)
    occupancy = torch.sum(eligible > 0, dim=-1, dtype=i32)
    metrics = RoundMetrics(
        round=round_idx,
        accuracy=accuracy,
        loss=loss,
        avg_staleness=torch.mean(new_stale.float(), dim=-1),
        total_time_s=dt,
        total_energy_j=rc.total_energy_j,
        cost=rc.cost,
        n_associated=torch.sum(admitted, dim=-1, dtype=i32),
        n_available=occupancy,
        z=applied.to(f32)[:, None].expand(-1, cfg.n_edges).contiguous(),
        sweeps=torch.tensor(sweeps))
    new_buf = BufferState(
        pending_delta=pending, finish_s=finish, in_flight=in_flight,
        pulled_ver=pulled, obs_s=obs, tier=tier, delta_sum=delta_sum,
        weight_sum=weight_sum, fill=fill_after, version=version,
        clock_s=clock, last_agg_s=last_agg, step=step1)
    new_faults = fault_tr = None
    if fsp is not None:
        flt: FaultState = states.faults
        n_retry = torch.sum(can_retry, dim=-1, dtype=i32)
        n_crash = torch.sum(crashed, dim=-1, dtype=i32)
        n_drop = torch.sum(dropped, dim=-1, dtype=i32) + n_crash
        new_faults = FaultState(
            edge_up=edge_up, attempts=attempts,
            n_retries=flt.n_retries + n_retry,
            n_dropped=flt.n_dropped + n_drop,
            n_quarantined=flt.n_quarantined + n_rej,
            n_crashed=flt.n_crashed + n_crash)
        fault_tr = _fault_trace(cfg, edge_up, dist, avail, n_retry, n_drop,
                                n_rej)
    new_state = RoundState(global_params, client_params, gains, new_stale,
                           round_idx, scen, new_buf, new_faults,
                           _next_warm(spec, assoc, assigned))
    if spec.telemetry:
        cause = torch.where(fired, torch.where(by_fill, 1, 2), 0).to(i32)
        tr = telemetry_trace.round_trace(
            cfg, spec, round_idx=round_idx, rc_all=rc_all, z=metrics.z,
            assoc=assoc, power_w=p, f_hz=f, counts=bundles.counts,
            staleness=new_stale, capacitance=scen.kappa if dynamic else None,
            sweeps=_device_sweeps(sweeps, dev), sched=None,
            cand=cand, assigned=assigned, dist=dist,
            avail=avail if dynamic else None,
            coverage_radius_m=coverage_radius(cfg),
            buffer=(fill, cause, cur_tier.to(i32), occupancy),
            faults=fault_tr)
        return new_state, (metrics, tr)
    return new_state, metrics


def round_step(cfg, spec: EngineSpec, state: RoundState,
               bundle: RoundBundle, draws: RoundDraws,
               actor_params: Optional[Params] = None, *, timer=None,
               mesh: Optional[Mesh] = None
               ) -> Tuple[RoundState, RoundMetrics]:
    """One global round (or buffered micro-step) of one simulation:
    ``fleet_step`` over a fleet of one (``actor_params``: one actor, as
    ``init_ddpg`` shapes it).  Its metrics are 0-d tensors, with
    ``sweeps`` an int; with ``spec.telemetry`` the output is the
    ``(metrics, trace)`` pair, the trace's leaves without the seed axis.
    ``mesh``: a client mesh, as ``fleet_step`` takes it."""
    state, out = fleet_step(cfg, spec, _lift(state), _lift(bundle),
                            _lift(draws), _lift(actor_params), timer=timer,
                            mesh=mesh)
    metrics, tr = split_output(spec, select_seed(out, 0))
    metrics = metrics._replace(sweeps=int(metrics.sweeps))
    return select_seed(state, 0), (metrics if tr is None else (metrics, tr))


def fleet_snapshot(cfg, spec: EngineSpec, states: RoundState,
                   bundles: RoundBundle,
                   assoc_u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (S, N, M) float one-hot association each seed's state gives
    now, without advancing it: ``_associate`` on the current gains,
    distances and availability (pre-transition: a dynamic round first
    moves the world and fades the channel, so its association is one
    world step ahead of this).  rcea ranks by ``assoc_u`` (S, N, M).
    With ``spec.faults`` and a ``FaultState`` in the carry, it routes
    around the current dead edges as the round does."""
    dynamic = spec.scenario != "static"
    scen = states.scenario
    edge_up = (states.faults.edge_up
               if spec.faults is not None and states.faults is not None
               else None)
    return _associate(cfg, spec, states, bundles, states.gains,
                      scen.dist if dynamic else bundles.dist,
                      scen.avail if dynamic else None, assoc_u, edge_up)[0]


def associate_snapshot(cfg, spec: EngineSpec, state: RoundState,
                       bundle: RoundBundle,
                       assoc_u: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """One simulation's ``fleet_snapshot``: the (N, M) association the
    DDPG trainer's MDP and ``HFLSimulation._associate`` read."""
    return fleet_snapshot(cfg, spec, _lift(state), _lift(bundle),
                          _lift(assoc_u))[0]


def stack_metrics(rows):
    """Per-round metrics -> one ``RoundMetrics`` with a leading round axis
    (after the fleet axis, for ``fleet_step``'s rows: (S, rounds, …)).
    Rows of ``(metrics, trace)`` pairs stack to a pair, the trace's
    leaves stacked the same way."""
    if not isinstance(rows[0], RoundMetrics):
        ms, trs = zip(*rows)
        dim = 1 if ms[0].accuracy.dim() > 0 else 0
        return stack_metrics(list(ms)), telemetry_trace.RoundTrace(
            *(torch.stack(list(field), dim=dim) for field in zip(*trs)))
    fleet = rows[0].accuracy.dim() > 0
    out = []
    for field in zip(*rows):
        if isinstance(field[0], torch.Tensor):
            out.append(torch.stack(list(field), dim=1 if fleet else 0))
        else:
            v = torch.tensor(list(field))
            out.append(v.expand(rows[0].accuracy.shape[0], len(field))
                       if fleet else v)
    return RoundMetrics(*out)


def _drive(cfg, spec: EngineSpec, state: RoundState, bundle: RoundBundle,
           n_rounds: int, generators, actor_params: Optional[Params], *,
           fleet: bool, timer=None, on_round=None,
           mesh: Optional[Mesh] = None):
    """The drivers' loop: the carry normalised to the spec, then
    ``n_rounds`` steps, each on fresh draws (``fleet_draws`` and
    ``fleet_step`` for a fleet, else ``sample_draws`` and ``round_step``),
    each step's output passed to ``on_round`` (if given) and stacked.
    ``mesh``, a client mesh, goes to ``round_step``."""
    draw, step = ((fleet_draws, fleet_step) if fleet
                  else (sample_draws, round_step))
    state = ensure_carry(cfg, spec, state)
    rows = []
    kw = {} if mesh is None else {"mesh": mesh}
    for _ in range(n_rounds):
        draws = draw(cfg, bundle, generators, spec)
        state, out = step(cfg, spec, state, bundle, draws, actor_params,
                          timer=timer, **kw)
        if on_round is not None:
            on_round(out)
        rows.append(out)
    return state, stack_metrics(rows)


def run_scanned(cfg, spec: EngineSpec, state: RoundState,
                bundle: RoundBundle, n_rounds: int,
                generator: torch.Generator,
                actor_params: Optional[Params] = None, *, timer=None,
                on_round=None, mesh: Optional[Mesh] = None
                ) -> Tuple[RoundState, RoundMetrics]:
    """``n_rounds`` rounds, each with fresh draws from ``generator``.
    Metrics leaves gain a leading (n_rounds,) axis (with ``telemetry``
    the output is the ``(metrics, trace)`` pair, see ``split_output``).
    The carry is normalised to the spec first (``ensure_carry``).
    ``on_round`` (if given) gets each round's output as it ends.
    ``mesh``: the client mesh of a state and bundle already split by
    ``shard_clients`` (``run_scanned_client_sharded`` does both)."""
    return _drive(cfg, spec, state, bundle, n_rounds, generator,
                  actor_params, fleet=False, timer=timer, on_round=on_round,
                  mesh=mesh)


def run_fleet(cfg, spec: EngineSpec, states: RoundState,
              bundles: RoundBundle, n_rounds: int, generators,
              actor_params: Optional[Params] = None, *,
              timer=None, on_round=None) -> Tuple[RoundState, RoundMetrics]:
    """``n_rounds`` rounds of a fleet of S independent simulations
    (``stack_fleet``), one batched ``fleet_step`` a round -- the
    counterpart of the reference's ``vmap`` of its scanned driver.  Seed
    s draws from ``generators[s]``, so it follows the trajectory of its
    own ``run_scanned`` from that generator.  ``actor_params``: one actor
    that every seed deploys (expanded along the seed axis as a view).
    Metrics leaves have shape (S, n_rounds, …); ``on_round`` as
    ``run_scanned`` takes it."""
    return run_fleet_actors(cfg, spec, states, bundles, n_rounds, generators,
                            every_seed(actor_params, bundles.dist.shape[0]),
                            timer=timer, on_round=on_round)


def every_seed(actor_params: Optional[Params], seeds: int
               ) -> Optional[Params]:
    """One actor as the actors of ``seeds`` seeds: each leaf expanded
    along a new leading seed axis (a view); None stays None."""
    if actor_params is None:
        return None
    return _map(lambda t: t.expand((seeds,) + t.shape), actor_params)


def run_fleet_actors(cfg, spec: EngineSpec, states: RoundState,
                     bundles: RoundBundle, n_rounds: int, generators,
                     actor_params: Optional[Params], *, timer=None,
                     on_round=None) -> Tuple[RoundState, RoundMetrics]:
    """``run_fleet`` with one actor a seed: ``actor_params`` leaves (S, …),
    seed s billed by the actor trained on its own world (as
    ``ddpg.train_allocator_fleet`` returns them)."""
    return _drive(cfg, spec, states, bundles, n_rounds, generators,
                  actor_params, fleet=True, timer=timer, on_round=on_round)


# ---------------------------------------------------------------------------
# Sharding over a 1-D mesh of processes (``core.mesh``): the seed axis and
# the client axis (the reference's DESIGN.md §8.3 and §9.3)
# ---------------------------------------------------------------------------

def _leaves(tree):
    """The tensor leaves of a state, bundle, draws or metrics tree."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)


def _seed_block(mesh: Mesh, seeds: int):
    """Rank r's seeds of a fleet of ``seeds``: the contiguous block
    [r·b, (r+1)·b) of b = ⌈S / W⌉, indices past the fleet clamped to its
    last seed (a ragged fleet's pad replicates the last seed)."""
    per = -(-seeds // mesh.world)
    return [min(i, seeds - 1)
            for i in range(mesh.rank * per, (mesh.rank + 1) * per)]


def shard_fleet(tree, mesh: Optional[Mesh] = None):
    """This rank's block of a stacked fleet (state, bundle, actors or any
    tree whose tensor leaves lead with the seed axis S), on the rank's
    device: ⌈S / W⌉ seeds, a ragged fleet padded by repeating its last
    seed.  Only the block is copied to the card."""
    mesh = fleet_mesh() if mesh is None else mesh
    seeds = next(_leaves(tree)).shape[0]
    block = _seed_block(mesh, seeds)
    if block == list(range(seeds)):
        return _map(lambda t: t.to(mesh.device), tree)
    sel = torch.tensor(block)
    return _map(lambda t: t.index_select(0, sel.to(t.device)).to(
        mesh.device), tree)


def _rank_generator(gen: torch.Generator, dev: torch.device
                    ) -> torch.Generator:
    """A generator on ``dev`` in ``gen``'s state: the same draws as
    ``gen`` (a CUDA generator's state is its seed and offset, good on any
    card)."""
    if gen.device.type != dev.type:
        raise ValueError(f"a {gen.device.type} generator cannot draw a "
                         f"{dev.type} run's numbers")
    return torch.Generator(device=dev).set_state(gen.get_state())


def _gather_seeds(tree, mesh: Mesh, seeds: int):
    """Every rank's block of a fleet tree gathered in seed order and cut
    to the fleet's ``seeds`` (the pads dropped)."""
    return _map(lambda t: mesh.all_gather(t)[:seeds], tree)


def _sync_generators(generators, gens, mesh: Mesh) -> None:
    """Leave each caller's generator where its seed's rank left its copy,
    as ``run_fleet`` leaves them."""
    states = mesh.all_gather(torch.stack([g.get_state() for g in gens]))
    for s, gen in enumerate(generators):
        gen.set_state(states[s].clone())


def guarded(mesh: Mesh, fn):
    """``fn()`` on this rank, then an ``all_ok`` flag on the mesh: a rank
    that raised posts 0 and raises, every other rank raises
    ``PeerFailed`` instead of waiting at the next gather."""
    try:
        out = fn()
    except PeerFailed:
        raise
    except BaseException:
        mesh.all_ok(False)
        raise
    if not mesh.all_ok(True):
        raise PeerFailed(f"rank {mesh.rank}: another rank of the "
                         f"{mesh.axis} mesh failed")
    return out


def run_fleet_sharded(cfg, spec: EngineSpec, states: RoundState,
                      bundles: RoundBundle, n_rounds: int, generators,
                      actor_params: Optional[Params] = None, *,
                      mesh: Optional[Mesh] = None,
                      per_sim_actors: bool = False,
                      on_round=None) -> Tuple[RoundState, RoundMetrics]:
    """``run_fleet`` (``run_fleet_actors`` with ``per_sim_actors``: the
    actors' leaves lead with the seed axis) with the seed axis split over
    ``mesh`` (default: ``fleet_mesh()``).

    Rank r runs the contiguous block of ⌈S / W⌉ seeds ``shard_fleet``
    gives it (only the block moves to its card; a ragged fleet is padded
    by repeating its last seed, wasted work on the remainder only), each
    seed drawing from a generator on the rank's card set to
    ``generators[s]``'s state.  Then the final states and the per-round
    output (metrics, and the trace with telemetry) are all-gathered in
    seed order and the pads cut off, and each of ``generators`` is left
    in its seed's final state.  A round has no collective and a fleet
    computes each seed as its own run does, so every seed is bit-equal to
    the unsharded ``run_fleet``'s, whatever the engine mode, fault spec,
    scenario or allocator.  ``on_round`` gets this rank's block output of
    each round (``sink.stream_fleet`` gathers and emits it).  A rank that
    raises makes every rank raise (``PeerFailed``) before the gather."""
    mesh = fleet_mesh() if mesh is None else mesh
    seeds = bundles.dist.shape[0]
    if len(generators) != seeds:
        raise ValueError(f"run_fleet_sharded: {len(generators)} generators "
                         f"for {seeds} seeds")
    block = _seed_block(mesh, seeds)

    def local():
        st, bu = shard_fleet((states, bundles), mesh)
        gens = [_rank_generator(generators[i], mesh.device) for i in block]
        if per_sim_actors:
            actors = shard_fleet(actor_params, mesh)
        else:
            actors = every_seed(_map(lambda t: t.to(mesh.device),
                                     actor_params), len(block))
        final, out = run_fleet_actors(cfg, spec, st, bu, n_rounds, gens,
                                      actors, on_round=on_round)
        return final, out, gens

    final, out, gens = guarded(mesh, local)
    _sync_generators(generators, gens, mesh)
    return _gather_seeds(final, mesh, seeds), _gather_seeds(out, mesh, seeds)


def pad_clients(cfg, state: RoundState, bundle: RoundBundle, multiple: int):
    """Pad N up to a multiple of ``multiple`` with inert clients (the
    reference's ``pad_clients``, leaf for leaf): parked at ``area_side_m ·
    1e3`` (distances, positions and waypoints) with speed 0, unavailable
    (``avail`` 0, ``p_drop`` 1, ``p_return`` 0), zero data counts,
    staleness 0 and warm seed −1; the last client's row repeated for
    ``f_max_hz``, ``p_max_w``, ``kappa``, ``client_params``, ``gains``,
    ``x`` and ``y``; a buffer's per-client leaves idle and a fault
    ledger's zero.  They never associate, so they never train into an
    aggregate, earn a rate or bill a joule.  Returns ``(cfg', state',
    bundle')`` with ``cfg.n_clients`` grown -- a padded world is another
    experiment (the round's draws span N); what the client axis keeps is
    sharded == unsharded on the same padded world."""
    n = cfg.n_clients
    pad = (-n) % int(multiple)
    if pad == 0:
        return cfg, state, bundle
    far = cfg.area_side_m * 1e3

    def rep_last(leaf):
        return torch.cat([leaf, leaf[-1:].expand((pad,) + leaf.shape[1:])])

    def const(leaf, value):
        return torch.cat([leaf, torch.full((pad,) + leaf.shape[1:], value,
                                           dtype=leaf.dtype,
                                           device=leaf.device)])

    scen = state.scenario
    if scen is not None:
        scen = scen._replace(
            pos=const(scen.pos, far), waypoint=const(scen.waypoint, far),
            speed=const(scen.speed, 0.0), avail=const(scen.avail, 0.0),
            p_drop=const(scen.p_drop, 1.0),
            p_return=const(scen.p_return, 0.0),
            f_max_hz=rep_last(scen.f_max_hz), p_max_w=rep_last(scen.p_max_w),
            kappa=rep_last(scen.kappa), dist=const(scen.dist, far))
    state = state._replace(
        client_params={k: rep_last(v) for k, v in state.client_params.items()},
        gains=rep_last(state.gains), staleness=const(state.staleness, 0),
        scenario=scen)
    if state.buffer is not None:
        buf = state.buffer
        state = state._replace(buffer=buf._replace(
            pending_delta={k: const(v, 0.0)
                           for k, v in buf.pending_delta.items()},
            finish_s=const(buf.finish_s, 0.0),
            in_flight=const(buf.in_flight, False),
            pulled_ver=const(buf.pulled_ver, 0), obs_s=const(buf.obs_s, 0.0),
            tier=const(buf.tier, 0)))
    if state.faults is not None:
        state = state._replace(faults=state.faults._replace(
            attempts=const(state.faults.attempts, 0)))
    if state.warm is not None:
        state = state._replace(warm=const(state.warm, -1))
    bundle = bundle._replace(
        dist=const(bundle.dist, far), x=rep_last(bundle.x),
        y=rep_last(bundle.y), counts=const(bundle.counts, 0.0))
    return dataclasses.replace(cfg, n_clients=n + pad), state, bundle


def shard_clients(state: RoundState, bundle: RoundBundle,
                  mesh: Optional[Mesh] = None
                  ) -> Tuple[RoundState, RoundBundle]:
    """One simulation split over the client mesh (default:
    ``client_mesh()``): this rank's contiguous N / W rows of the heavy
    per-client leaves -- ``client_params``, ``bundle.x``, ``bundle.y`` and
    the buffered engine's ``buffer.pending_delta`` -- copied to its card,
    and every other leaf replicated there (gains, staleness, distances,
    counts, the scenario state, the warm seed, the global model, the test
    set, the rest of the buffer and the whole ``FaultState``).  The
    buffer's and the fault ledger's per-client scalars (``finish_s``,
    ``in_flight``, ``pulled_ver``, ``obs_s``, ``tier``, ``attempts``) are
    replicated like ``gains`` and ``staleness``, where the reference's
    placement splits them: placement only, the round computes the same.
    A buffer attached later (``ensure_carry``) shapes its
    ``pending_delta`` from the rank's ``client_params``, so it holds the
    rank's rows too.  N must divide by W: pad a ragged N with
    ``pad_clients`` first."""
    mesh = client_mesh() if mesh is None else mesh
    n = bundle.counts.shape[-1]
    if n % mesh.world:
        raise ValueError(f"shard_clients: {n} clients do not split over "
                         f"{mesh.world} ranks; pad_clients first")
    dev = mesh.device
    rows = n // mesh.world
    lo = mesh.rank * rows

    def own(t):
        if mesh.world == 1:
            return t.to(dev)
        part = t[lo:lo + rows]
        return part.clone() if part.device == dev else part.to(dev)

    rep = lambda t: t.to(dev)                          # noqa: E731
    buf = state.buffer
    rest = state._replace(client_params=None, buffer=None if buf is None
                          else buf._replace(pending_delta=None))
    state = _map(rep, rest)._replace(
        client_params={k: own(v) for k, v in state.client_params.items()})
    if buf is not None:
        state = state._replace(buffer=state.buffer._replace(
            pending_delta={k: own(v) for k, v in buf.pending_delta.items()}))
    bundle = _map(rep, bundle._replace(x=None, y=None))._replace(
        x=own(bundle.x), y=own(bundle.y))
    return state, bundle


def gather_clients(state: RoundState, mesh: Mesh) -> RoundState:
    """``state`` with every rank's rows of its split leaves (leaves (N / W,
    …)) gathered into the whole (N, …) stacks, on every rank:
    ``client_params`` and, with a buffer, ``buffer.pending_delta``."""
    def whole(params):
        return {k: mesh.all_gather(v) for k, v in params.items()}

    state = state._replace(client_params=whole(state.client_params))
    if state.buffer is not None:
        state = state._replace(buffer=state.buffer._replace(
            pending_delta=whole(state.buffer.pending_delta)))
    return state


def run_scanned_client_sharded(cfg, spec: EngineSpec, state: RoundState,
                               bundle: RoundBundle, n_rounds: int,
                               generator: torch.Generator,
                               actor_params: Optional[Params] = None, *,
                               mesh: Optional[Mesh] = None, on_round=None
                               ) -> Tuple[RoundState, RoundMetrics]:
    """``run_scanned`` with the client axis split over ``mesh`` (default:
    ``client_mesh()``): ``pad_clients`` to a multiple of W, then
    ``shard_clients``, then the round on every rank with the mesh threaded
    to the train stage.

    Every stage before training runs replicated on the full (N, M)
    control plane -- fading, scoring, association (dense or on the
    frontier), allocation, the Eq. 23a bill and PDD -- from the same
    draws on every rank (a generator on the rank's card set to
    ``generator``'s state).  This is where the reference's GSPMD puts its
    small leaves apart (it shards the gains too), not what it computes:
    those tensors are O(N·M), a few MB at N = 10⁴; a round is bound by
    PDD's host launches; each sweep of the resolver would need a
    collective; and every decision stays bit-equal to the unsharded run.
    Training splits: each rank trains the lanes of its own rows and the
    lanes are all-gathered after each τ₁ block (``_train_cohort``),
    so the whole round is bit-equal to the unsharded one on the same
    padded world.  The buffered engine (``fleet_buffered_step``) keeps
    its ``pending_delta`` rows on their rank and gathers only the landed
    ones; the faulted sync round (``_train_faulty``) forms its deltas
    from the gathered lanes: both bit-equal too.

    Returns the padded world's final state and output, the state's
    ``client_params`` and ``pending_delta`` this rank's rows
    (``gather_clients`` assembles them); ``generator`` is left where the
    run left it; ``on_round`` gets each round's output
    (``sink.stream_scanned_client_sharded`` tees it).  A rank that raises
    stops inside a collective: the launcher (``torchrun``, ``mesh.spawn``)
    ends the others."""
    mesh = client_mesh() if mesh is None else mesh
    cfg, state, bundle = pad_clients(cfg, state, bundle, mesh.world)
    state, bundle = shard_clients(state, bundle, mesh)
    gen = _rank_generator(generator, mesh.device)
    actors = _map(lambda t: t.to(mesh.device), actor_params)
    final, out = run_scanned(cfg, spec, state, bundle, n_rounds, gen,
                             actors, on_round=on_round, mesh=mesh)
    generator.set_state(gen.get_state())
    return final, out


def split_output(spec: EngineSpec, out):
    """A step's or driver's output as ``(metrics, trace)``: telemetry off,
    ``out`` is the ``RoundMetrics`` and the trace ``None``; on, ``out`` is
    already the pair."""
    if spec.telemetry:
        return out
    return out, None


def metrics_row(metrics: RoundMetrics, i: Optional[int] = None
                ) -> Dict[str, Any]:
    """Host-side view: round ``i`` of stacked metrics (or one round)."""
    pick = (lambda l: l[i]) if i is not None else (lambda l: l)
    as_int = lambda v: int(pick(v))
    return {
        "round": as_int(metrics.round),
        "accuracy": float(pick(metrics.accuracy)),
        "loss": float(pick(metrics.loss)),
        "avg_staleness": float(pick(metrics.avg_staleness)),
        "total_time_s": float(pick(metrics.total_time_s)),
        "total_energy_j": float(pick(metrics.total_energy_j)),
        "cost": float(pick(metrics.cost)),
        "n_associated": int(pick(metrics.n_associated)),
        "n_available": as_int(metrics.n_available),
        "z": pick(metrics.z).detach().cpu().numpy(),
        "sweeps": as_int(metrics.sweeps),
    }

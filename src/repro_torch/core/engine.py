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

The port covers the sync round on every scenario kind, dense or on the
candidate frontier, with fcea, gcea or rcea, the ``mid``, ``rra``,
``fpa`` or ``fca`` allocator, PDD or fastest scheduling, NOMA or OMA.
Everything else raises ``NotImplementedError`` naming its ROADMAP item.
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
from repro_torch.data import federated
from repro_torch.device import resolve_device
from repro_torch.kernels import hfl_ops
from repro_torch.models import mlp

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Spec + state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Per-simulation switches, with the reference's defaults.  Options the
    port does not have yet are accepted at their off value only."""
    policy: str = "fcea"            # fcea | gcea | rcea
    allocator: str = "mid"          # mid | rra | fpa | fca
    scheduler: str = "pdd"          # pdd | fastest
    noma_enabled: bool = True
    fading_rho: float = 0.9
    oma_quota_factor: float = 0.5
    # the transition kind (a key of ``scenarios.TRANSITIONS``); the
    # scenario's numbers live in ``RoundState.scenario``
    scenario: str = "static"
    candidates_k: Optional[int] = None
    telemetry: bool = False
    engine_mode: str = "sync"
    faults: Any = None
    warm_start: bool = False

    def __post_init__(self):
        todo = []
        if self.policy not in association.POLICIES:
            raise ValueError(f"unknown association policy {self.policy!r}")
        if self.allocator == "ddpg":
            todo.append("allocator='ddpg' (ROADMAP A15 c)")
        elif self.allocator not in ("mid", "rra", "fpa", "fca"):
            raise ValueError(f"unknown allocator {self.allocator!r}")
        if self.scheduler not in ("pdd", "fastest"):
            raise ValueError(f"unknown scheduler {self.scheduler!r}")
        if self.scenario not in scenarios.TRANSITIONS:
            raise ValueError(f"unknown scenario transition "
                             f"{self.scenario!r}; registered: "
                             f"{sorted(scenarios.TRANSITIONS)}")
        if self.telemetry:
            todo.append("telemetry (ROADMAP A15 d)")
        if self.engine_mode != "sync":
            todo.append("engine_mode='buffered' (ROADMAP A15 e)")
        if self.faults is not None:
            todo.append("faults (ROADMAP A15 f)")
        if self.warm_start:
            todo.append("warm_start (ROADMAP A15 g)")
        if todo:
            raise NotImplementedError(
                "not ported to repro_torch yet: " + ", ".join(todo))


class RoundBundle(NamedTuple):
    """Per-simulation constants.  In a fleet (``stack_fleet``) each of the
    state's, bundle's and draws' tensors has a leading seed axis S."""
    dist: torch.Tensor       # (N, M) float32 client-edge distances at init
    x: torch.Tensor          # (N, cap, dim) float32 padded client data
    y: torch.Tensor          # (N, cap) int32 labels
    counts: torch.Tensor     # (N,) float32 — D_n
    test_x: torch.Tensor     # (T, dim) float32
    test_y: torch.Tensor     # (T,) int32


class RoundState(NamedTuple):
    """Everything that evolves across global rounds."""
    global_params: Params    # cloud model
    client_params: Params    # stacked (N, ...) client models
    gains: torch.Tensor      # (N, M) float32 current |h|²
    staleness: torch.Tensor  # (N,) int32 — A_n
    round_idx: int
    scenario: Any = None     # scenarios.ScenarioState (None: static only)


class RoundDraws(NamedTuple):
    """One round's random numbers."""
    fading: torch.Tensor     # (N, M) float32 Exp(1) fading field
    batch_idx: torch.Tensor  # (τ₂, τ₁, N, B) int32 in [0, max(D_n, 1))
    assoc_u: Optional[torch.Tensor] = None  # (N, M) Uniform[0, 1), rcea
    alloc_u: Optional[torch.Tensor] = None  # (2, N) Uniform[0, 1), rra
    # (U,) Uniform[0, 1): the scenario transition's uniforms, laid out as
    # ``scenarios.draw_shapes`` names them; empty on the static kind
    scenario: Optional[torch.Tensor] = None


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
    ``spec`` needs them, rcea's (N, M) and rra's (2, N) uniforms, and the
    scenario transition's (U,) uniforms (none on the static kind) -- so
    the static fcea/gcea + ``mid`` stream does not depend on any of
    them."""
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
    return RoundDraws(fading=fading, batch_idx=idx, assoc_u=assoc_u,
                      alloc_u=alloc_u, scenario=scen_u)


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
        return type(first)(*(_map(fn, *leaves) for leaves in zip(*trees)))
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

def _grid_allocate(cfg, spec: EngineSpec, assoc, gains, counts, scen,
                   fixed_axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paper's FPA/FCA benchmarks (§V-D): one action axis pinned at its
    maximum, the other grid-optimised (``env.grid_best_action``) against
    the Eq. 23a bill at z = 1, with the scenario's κ and caps; ``assoc``
    is already availability-masked."""
    params = env.make_env_params(
        cfg, assoc, torch.ones(assoc.shape[:-2] + (cfg.n_edges,),
                               device=assoc.device), counts,
        kappa=scen.kappa if scen is not None else None,
        p_max_w=scen.p_max_w if scen is not None else None,
        f_max_hz=scen.f_max_hz if scen is not None else None)
    a = env.grid_best_action(cfg, params, gains, fixed_axis=fixed_axis,
                             fixed_frac=1.0, noma_enabled=spec.noma_enabled)
    return env.env_decode_action(cfg, params, a)


def _allocate(cfg, spec: EngineSpec, draws: RoundDraws, assoc, gains,
              counts, scen) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p_w (S, N), f_hz (S, N)): ``mid`` takes the midpoints, ``rra`` a
    uniform point of each range from ``draws.alloc_u`` (S, 2, N), ``fpa``
    (power at its maximum) and ``fca`` (frequency at its maximum) the
    grid's best point of the other axis.  ``scen`` is the dynamic
    scenario's state (None on the static path)."""
    if spec.allocator in ("fpa", "fca"):
        return _grid_allocate(cfg, spec, assoc, gains, counts, scen,
                              fixed_axis=0 if spec.allocator == "fpa" else 1)
    if spec.allocator == "rra":
        return env.decode_action(cfg, draws.alloc_u)
    shape, dev = draws.fading.shape[:-1], draws.fading.device   # (S, N)
    return (torch.full(shape, 0.5 * (cfg.p_min_w + cfg.p_max_w),
                       device=dev),
            torch.full(shape, 0.5 * (cfg.f_min_hz + cfg.f_max_hz),
                       device=dev))


def _schedule(cfg, spec: EngineSpec, rc_all: cost.RoundCost
              ) -> torch.Tensor:
    """Semi-synchronous edge-selection mask z (S, M) from one cost eval.

    PDD optimises exactly the billed Eq. 23a surface: per-edge time
    ``t_cloud + U_m`` with ``U_m = τ₂ · max_{n∈N_m} t_n``.  All seeds run
    one PDD loop, whose launches do not grow with S."""
    quota = max(1, int(round(cfg.semi_sync_fraction * cfg.n_edges)))
    if spec.scheduler == "pdd":
        t_cloud = torch.full((cfg.n_edges,),
                             cfg.edge_model_size_bits / cfg.edge_rate_bps,
                             dtype=torch.float32,
                             device=rc_all.per_edge_time_s.device)
        U = rc_all.per_edge_time_s - t_cloud
        return pdd.pdd_schedule(rc_all.per_edge_energy_j, t_cloud, U,
                                lam_t=cfg.lambda_t, lam_e=cfg.lambda_e,
                                quota=quota).z_binary
    return pdd.semi_sync_fastest(rc_all.per_edge_time_s, quota)


def _train_cohort(cfg, spec: EngineSpec, state: RoundState,
                  bundle: RoundBundle, assoc: torch.Tensor,
                  batch_idx: torch.Tensor) -> Tuple[Params, Params]:
    """τ₂ × (τ₁ local SGD + edge aggregation) (Eqs. 11, 13) on a compact
    cohort, for every seed of the fleet.  Returns ``(client_params,
    edge_params)``, (S, N, …) and (S, M, …).

    At most K = min(N, quota·M) clients of each seed are admitted, so they
    are gathered once into K lanes (ascending client index, then pad
    lanes), trained and aggregated on the (S, K, …) stack, and scattered
    back once.  Pad lanes repeat client N−1's data and draws, carry zero
    aggregation weight and never scatter back; unadmitted clients keep
    their params.  The lane selection is sync-free: a stable sort of
    ``~selected``.  The S·K lanes are independent, so each τ₂ step trains
    them all in one ``local_sgd_step`` call.

    ``assoc`` (S, N, M); ``batch_idx`` (S, τ₂, τ₁, N, B).
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
    sel_x, sel_y = bundle.x[sd, safe], bundle.y[sd, safe]          # (S,K,…)
    sel_counts = torch.gather(bundle.counts, 1, safe)
    sel_assoc = assoc[sd, safe] * lane_ok[..., None]               # (S,K,M)
    # the lattice is a pure function of the global client id, so the
    # lanes' draws are the full lattice gathered at ``safe``, laid out
    # (τ₂, τ₁, S, K, B) for the folded S·K lanes
    _, tau2, tau1, _, batch = batch_idx.shape
    idx = torch.gather(batch_idx, 3, safe[:, None, None, :, None].expand(
        seeds, tau2, tau1, k_sel, batch)).long().permute(1, 2, 0, 3, 4)
    sd4 = sd[None, :, :, None]
    lane = torch.arange(k_sel, device=dev)[None, None, :, None]

    # admitted lanes start from the global model
    edge_params = aggregation.replicate(state.global_params, cfg.n_edges,
                                        lead=1)
    lane_params = {k: v[sd, safe] for k, v in state.client_params.items()}
    lane_params = aggregation.broadcast_to_clients(sel_assoc, edge_params,
                                                   lane_params)
    for t in range(cfg.tau2):
        bx = sel_x[sd4, lane, idx[t]]                          # (τ₁,S,K,B,D)
        by = sel_y[sd4, lane, idx[t]]                          # (τ₁,S,K,B)
        folded = hfl_ops.local_sgd_step(
            {k: v.reshape((seeds * k_sel,) + v.shape[2:])
             for k, v in lane_params.items()},
            bx.reshape((tau1, seeds * k_sel) + bx.shape[3:]),
            by.reshape(tau1, seeds * k_sel, batch), lr=cfg.lr)
        lane_params = {k: v.reshape((seeds, k_sel) + v.shape[1:])
                       for k, v in folded.items()}
        edge_params = aggregation.edge_aggregate(lane_params, sel_assoc,
                                                 sel_counts)
        lane_params = aggregation.broadcast_to_clients(sel_assoc, edge_params,
                                                       lane_params)
    # scatter back: pad lanes target each seed's scratch row n, dropped
    rows = (sd * (n + 1) + sel_idx).reshape(-1)
    client_params = {}
    for k, old in state.client_params.items():
        buf = torch.cat([old, old[:, :1]], dim=1)
        buf.reshape((seeds * (n + 1),) + old.shape[2:]).index_copy_(
            0, rows, lane_params[k].reshape((seeds * k_sel,) + old.shape[2:]))
        client_params[k] = buf[:, :n]
    return client_params, edge_params


def _train(cfg, spec: EngineSpec, state: RoundState, bundle: RoundBundle,
           assoc: torch.Tensor, z: torch.Tensor, batch_idx: torch.Tensor
           ) -> Tuple[Params, Params]:
    """``_train_cohort`` followed by the semi-synchronous cloud aggregation
    (Eq. 17) of each seed.  Returns ``(global_params, client_params)``."""
    client_params, edge_params = _train_cohort(cfg, spec, state, bundle,
                                               assoc, batch_idx)
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


def _no_stage(name: str):
    return contextlib.nullcontext()


def fleet_step(cfg, spec: EngineSpec, states: RoundState,
               bundles: RoundBundle, draws: RoundDraws, *, timer=None
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
    uniforms, so a fleet of mixed worlds is one round.  ``timer``, if
    given, is called with each stage's name (scenario, on a dynamic kind
    only; associate, allocate, schedule, train, eval) and must return a
    context manager around that stage -- the hook stage timings use."""
    stage = timer or _no_stage
    dev = bundles.dist.device
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
    # 2. fuzzy scoring + association, dense or on the (N, K) frontier;
    #    unavailable clients are out of coverage this round
    with stage("associate"):
        assigned = None
        data_max = float(cfg.max_samples)
        if spec.candidates_k is not None:
            cand = candidates.build_candidates(
                dist, spec.candidates_k,
                coverage_radius_m=coverage_radius(cfg), avail=avail)
            scores = None
            if spec.policy == "fcea":
                scores = hfl_ops.score_candidates(
                    gains, cand.idx, bundles.counts, states.staleness,
                    data_max=data_max)
            assigned, sweeps = association.associate_candidates(
                spec.policy, scores=scores, gains=gains, cand=cand,
                quota=quota_for(cfg, spec), n_edges=m,
                uniform=draws.assoc_u, return_sweeps=True)
            assoc = candidates.assigned_one_hot(assigned, m)
        else:
            scores = None
            if spec.policy == "fcea":
                scores = hfl_ops.score_matrix(gains, bundles.counts,
                                              states.staleness,
                                              data_max=data_max)
            assoc, sweeps = association.associate(
                spec.policy, scores=scores, gains=gains, dist=dist,
                quota=quota_for(cfg, spec),
                coverage_radius_m=coverage_radius(cfg),
                uniform=draws.assoc_u, avail=avail, return_sweeps=True)
        assoc = assoc.float()
        if dynamic and assigned is None:
            # the explicit Eq. 11/17/23a mask: no policy trains on,
            # aggregates or bills a dropped client (the frontier's
            # ``valid`` already excludes it)
            assoc = assoc * avail[..., None]
    # 3. resource allocation, clamped to the device classes' caps
    with stage("allocate"):
        p, f = _allocate(cfg, spec, draws, assoc, gains, bundles.counts,
                         scen if dynamic else None)
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
        z = _schedule(cfg, spec, rc_all)
        rc = cost.apply_schedule(cfg, rc_all, z)
    # 5. τ₂·τ₁ training + hierarchical aggregation
    with stage("train"):
        global_params, client_params = _train(cfg, spec, states, bundles,
                                               assoc, z, draws.batch_idx)
    # 6. staleness (Eq. 20): reset only for clients whose edge was selected
    selected = torch.sum(assoc, dim=-1) > 0
    effective = selected & torch.gather(z > 0, -1,
                                        torch.argmax(assoc, dim=-1))
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
    new_state = RoundState(global_params, client_params, gains, new_stale,
                           round_idx, scen)
    return new_state, metrics


def round_step(cfg, spec: EngineSpec, state: RoundState,
               bundle: RoundBundle, draws: RoundDraws, *, timer=None
               ) -> Tuple[RoundState, RoundMetrics]:
    """One global round of one simulation: ``fleet_step`` over a fleet of
    one.  Its metrics are 0-d tensors, with ``sweeps`` an int."""
    state, metrics = fleet_step(cfg, spec, _lift(state), _lift(bundle),
                                _lift(draws), timer=timer)
    metrics = select_seed(metrics, 0)
    return select_seed(state, 0), metrics._replace(
        sweeps=int(metrics.sweeps))


def stack_metrics(rows) -> RoundMetrics:
    """Per-round metrics -> one ``RoundMetrics`` with a leading round axis
    (after the fleet axis, for ``fleet_step``'s rows: (S, rounds, …))."""
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


def run_scanned(cfg, spec: EngineSpec, state: RoundState,
                bundle: RoundBundle, n_rounds: int,
                generator: torch.Generator, *, timer=None
                ) -> Tuple[RoundState, RoundMetrics]:
    """``n_rounds`` rounds, each with fresh draws from ``generator``.
    Metrics leaves gain a leading (n_rounds,) axis."""
    rows = []
    for _ in range(n_rounds):
        draws = sample_draws(cfg, bundle, generator, spec)
        state, metrics = round_step(cfg, spec, state, bundle, draws,
                                    timer=timer)
        rows.append(metrics)
    return state, stack_metrics(rows)


def run_fleet(cfg, spec: EngineSpec, states: RoundState,
              bundles: RoundBundle, n_rounds: int, generators, *,
              timer=None) -> Tuple[RoundState, RoundMetrics]:
    """``n_rounds`` rounds of a fleet of S independent simulations
    (``stack_fleet``), one batched ``fleet_step`` a round -- the
    counterpart of the reference's ``vmap`` of its scanned driver.  Seed
    s draws from ``generators[s]``, so it follows the trajectory of its
    own ``run_scanned`` from that generator.  Metrics leaves have shape
    (S, n_rounds, …)."""
    rows = []
    for _ in range(n_rounds):
        draws = fleet_draws(cfg, bundles, generators, spec)
        states, metrics = fleet_step(cfg, spec, states, bundles, draws,
                                     timer=timer)
        rows.append(metrics)
    return states, stack_metrics(rows)


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

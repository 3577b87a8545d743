"""Dynamic scenarios: the world moving between global rounds.

In the static round only the channel fades; topology, coverage and client
capability stay as ``init_simulation`` made them.  A scenario makes the
rest move, as a per-round transition inside ``engine.fleet_step``:

    advance(cfg, kind, u, ScenarioState) -> ScenarioState'

* ``ScenarioState`` -- the per-client world state: positions (and so the
  client-edge distances), a two-state Markov availability mask, and the
  device class (per-client ``f_max``/``p_max`` caps and the effective
  capacitance κ).  Tensors, with a leading seed axis in a fleet.
* ``ScenarioSpec`` -- host-side init configuration.  Its numbers become
  state tensors at init, so scenarios of one kind but other speeds, drop
  rates or device mixes run the same transition: the engine's switch is
  the kind string alone.
* ``u`` -- the transition's random numbers, an explicit argument: one flat
  (U,) Uniform[0, 1) tensor (``engine.RoundDraws.scenario``) laid out as
  the kind's draw function names them (``draw_shapes``), which
  ``advance`` unpacks into a dict of views for the transition.
  ``engine.sample_draws`` makes it from a ``torch.Generator``; the tests
  replay the reference's own draws.

Built-in kinds (each parameterised through the state, so any mixture of
the three parts runs one program and a fleet of mixed worlds one round):

* ``static``          -- identity.
* ``random_waypoint`` -- clients walk toward uniformly re-drawn waypoints
  at per-client speeds; coverage and the nearest edge change every round.
* ``markov_dropout``  -- two-state availability chain: an available client
  drops with prob ``p_drop``, a dropped one returns with ``p_return``.
* ``hetero_devices``  -- per-client CPU/power classes drawn at init,
  flowing into the Eq. 23a cost model (κ, f_max, p_max).
* ``dynamic``         -- all three; every built-in mixture lowers to it.
* ``flash_crowd``, ``regional_outage``, ``diurnal`` -- burst arrivals,
  correlated regional outages and a sinusoidal day/night availability,
  each reusing the dropout and speed slots of the state.

Every reduction of a transition is over its own seed's clients (dim −1),
never over a fleet.  Custom transitions register with
``register_transition``.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

_MOBILE = "random_waypoint"
_DROPOUT = "markov_dropout"
_HETERO = "hetero_devices"
_PARTS = (_MOBILE, _DROPOUT, _HETERO)
_FLASH = "flash_crowd"
_REGIONAL = "regional_outage"
_DIURNAL = "diurnal"


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """Host-side scenario initialisation config (every number here
    becomes a ``ScenarioState`` tensor)."""
    kind: str = "static"            # "static" | "+"-joined parts | "dynamic"
    # random_waypoint mobility
    speed_min_mps: float = 1.0
    speed_max_mps: float = 15.0
    round_duration_s: float = 10.0  # wall-clock per global round (motion step)
    # markov_dropout availability
    p_drop: float = 0.15            # P(available -> dropped) per round
    p_return: float = 0.5           # P(dropped -> available) per round
    # hetero_devices classes
    n_device_classes: int = 4
    kappa_spread: float = 1.0       # κ ∈ cfg.capacitance · [1, 1+spread]
    # regional_outage: radius of the outage disk as a fraction of the area
    # side
    outage_radius_frac: float = 0.35
    # diurnal load curve: availability oscillates with this period
    # (rounds) down to `diurnal_floor` at the trough
    diurnal_period_rounds: float = 24.0
    diurnal_floor: float = 0.2

    @property
    def parts(self) -> tuple:
        """The built-in parts this kind activates (a custom registered
        transition has none: its init is the identity parameterisation)."""
        if self.kind == "static":
            return ()
        if self.kind == "dynamic":
            return _PARTS
        parts = tuple(self.kind.split("+"))
        unknown = set(parts) - set(_PARTS)
        if not unknown:
            return parts
        if self.kind in TRANSITIONS:          # registered custom transition
            return ()
        raise ValueError(f"unknown scenario part(s) {sorted(unknown)}; "
                         f"choose from {_PARTS} or register_transition()")

    @property
    def is_dynamic(self) -> bool:
        return self.kind != "static"

    def engine_kind(self) -> str:
        """The engine's switch: every built-in dynamic mixture lowers to
        "dynamic" (which parts act is carried in the state's tensors); a
        custom registered kind selects its own transition."""
        if self.kind == "static":
            return "static"
        return "dynamic" if (self.parts or self.kind == "dynamic") \
            else self.kind

    @property
    def stationary_availability(self) -> float:
        return self.p_return / max(self.p_drop + self.p_return, 1e-12)


class ScenarioState(NamedTuple):
    """Per-client world state carried across rounds (leaves (N, ...),
    (M, 2) or (N, M); a leading seed axis in a fleet)."""
    pos: torch.Tensor        # (N, 2) client positions [m]
    waypoint: torch.Tensor   # (N, 2) current waypoint target [m]
    speed: torch.Tensor      # (N,) metres moved per ROUND (speed·duration)
    avail: torch.Tensor      # (N,) float32 availability mask (1.0 / 0.0)
    p_drop: torch.Tensor     # (N,) P(up -> down); 0 disables dropout
    p_return: torch.Tensor   # (N,) P(down -> up); 1 disables dropout
    f_max_hz: torch.Tensor   # (N,) per-device CPU-frequency cap
    p_max_w: torch.Tensor    # (N,) per-device transmit-power cap
    kappa: torch.Tensor      # (N,) per-device effective capacitance κ
    edges: torch.Tensor      # (M, 2) edge-server positions (constant)
    dist: torch.Tensor       # (N, M) current client-edge distances


def _distances(pos: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(pos[..., :, None, :]
                                    - edges[..., None, :, :], dim=-1)


def init_scenario(cfg, sspec: ScenarioSpec, rng: np.random.Generator,
                  topo: Dict[str, np.ndarray],
                  device: "str | torch.device" = "cuda") -> ScenarioState:
    """Materialise the spec into state tensors on ``device``, drawing from
    ``rng`` after topology and data, in the reference's order (so every
    leaf equals the reference's bit for bit).

    Inactive parts take their identity parameterisation (speed 0, p_drop 0
    / p_return 1, homogeneous devices), so ``advance_dynamic`` is a no-op
    along that axis.
    """
    n = cfg.n_clients
    parts = sspec.parts
    f32 = np.float32
    pos = np.asarray(topo["clients"], f32)
    edges = np.asarray(topo["edges"], f32)
    dist = np.asarray(topo["dist"], f32)

    if _MOBILE in parts:
        speed = rng.uniform(sspec.speed_min_mps, sspec.speed_max_mps,
                            n).astype(f32) * f32(sspec.round_duration_s)
        waypoint = rng.uniform(0.0, cfg.area_side_m, (n, 2)).astype(f32)
    else:
        speed = np.zeros((n,), f32)
        waypoint = pos.copy()

    if _DROPOUT in parts or sspec.kind in (_FLASH, _REGIONAL, _DIURNAL):
        # flash_crowd / regional_outage / diurnal reuse the dropout slots:
        # p_drop is the decay / outage-event / phase-step probability,
        # p_return the burst / recovery probability (or the diurnal floor)
        p_drop = np.full((n,), sspec.p_drop, f32)
        p_return = np.full((n,), sspec.p_return, f32)
    else:
        p_drop = np.zeros((n,), f32)
        p_return = np.ones((n,), f32)

    if sspec.kind == _REGIONAL:
        # the speed slot (no mobility) carries the outage radius
        speed = np.full((n,), sspec.outage_radius_frac * cfg.area_side_m,
                        f32)
    elif sspec.kind == _DIURNAL:
        # p_drop: the per-round phase increment; p_return: the floor;
        # speed: the running phase
        p_drop = np.full((n,), 2.0 * np.pi
                         / max(sspec.diurnal_period_rounds, 1e-6), f32)
        p_return = np.full((n,), sspec.diurnal_floor, f32)
        speed = np.zeros((n,), f32)

    if _HETERO in parts:
        cls = rng.integers(0, sspec.n_device_classes, n)
        frac = (cls + 1.0) / sspec.n_device_classes          # (0, 1]
        f_max = (cfg.f_min_hz
                 + frac * (cfg.f_max_hz - cfg.f_min_hz)).astype(f32)
        p_max = (cfg.p_min_w
                 + frac * (cfg.p_max_w - cfg.p_min_w)).astype(f32)
        # weaker silicon burns more J per cycle at a given f
        kappa = (cfg.capacitance
                 * (1.0 + sspec.kappa_spread * (1.0 - frac))).astype(f32)
    else:
        f_max = np.full((n,), cfg.f_max_hz, f32)
        p_max = np.full((n,), cfg.p_max_w, f32)
        kappa = np.full((n,), cfg.capacitance, f32)

    def t(a):
        return torch.tensor(np.asarray(a, f32), device=device)
    return ScenarioState(pos=t(pos), waypoint=t(waypoint), speed=t(speed),
                         avail=t(np.ones((n,), f32)), p_drop=t(p_drop),
                         p_return=t(p_return), f_max_hz=t(f_max),
                         p_max_w=t(p_max), kappa=t(kappa), edges=t(edges),
                         dist=t(dist))


# ---------------------------------------------------------------------------
# Transitions: fn(cfg, u, state) -> state, with u the kind's uniforms
# ---------------------------------------------------------------------------

def static_transition(cfg, u, s: ScenarioState) -> ScenarioState:
    """Identity: the frozen world."""
    del cfg, u
    return s


def advance_dynamic(cfg, u, s: ScenarioState) -> ScenarioState:
    """One round of world evolution: waypoint motion, then the
    availability chain.  ``u["waypoint"]`` (N, 2) and ``u["drop"]`` (N,).

    Device classes are fixed per simulation; inactive axes are identities
    by parameterisation (see ``init_scenario``), so this one transition
    serves every built-in mixture.
    """
    # random-waypoint motion (speed is metres per round)
    delta = s.waypoint - s.pos                                   # (N, 2)
    d = torch.linalg.vector_norm(delta, dim=-1)                  # (N,)
    arrived = d <= torch.clamp_min(s.speed, 1e-6)
    step = (s.speed / torch.clamp_min(d, 1e-9))[..., None] * delta
    pos = torch.where(arrived[..., None], s.waypoint, s.pos + step)
    fresh_wp = u["waypoint"] * cfg.area_side_m
    waypoint = torch.where(arrived[..., None], fresh_wp, s.waypoint)
    dist = _distances(pos, s.edges)
    # two-state Markov availability
    up = s.avail > 0
    avail = torch.where(up, u["drop"] >= s.p_drop, u["drop"] < s.p_return)
    return s._replace(pos=pos, waypoint=waypoint, dist=dist,
                      avail=avail.to(torch.float32))


def _mean(x: torch.Tensor) -> torch.Tensor:
    """Each seed's mean over its own clients, kept as a trailing axis."""
    return torch.mean(x, dim=-1, keepdim=True)


def flash_crowd_transition(cfg, u, s: ScenarioState) -> ScenarioState:
    """Burst arrivals: availability flips in waves instead of mixing.

    Between bursts the population only decays: each available client drops
    with its ``p_drop`` and dropped clients stay down.  With probability
    ``mean(p_return)`` a round, a flash crowd arrives and every dropped
    client returns at once (those that just dropped this round stay down).
    ``u["burst"]`` () and ``u["decay"]`` (N,).
    """
    del cfg
    burst = u["burst"][..., None] < _mean(s.p_return)
    up = s.avail > 0
    stay_up = up & (u["decay"] >= s.p_drop)
    avail = torch.where(burst, stay_up | ~up, stay_up)
    return s._replace(avail=avail.to(torch.float32))


def regional_outage_transition(cfg, u, s: ScenarioState) -> ScenarioState:
    """Correlated regional outages: whole neighbourhoods go dark at once.

    With probability ``mean(p_drop)`` a round an outage strikes a uniformly
    drawn centre, and every client within the outage radius (the speed
    slot, in metres) drops together.  Downed clients recover independently
    with ``mean(p_return)`` a round.  ``u["event"]`` (), ``u["centre"]``
    (2,) and ``u["recover"]`` (N,).
    """
    event = u["event"][..., None] < _mean(s.p_drop)
    centre = u["centre"] * cfg.area_side_m
    hit = torch.linalg.vector_norm(s.pos - centre[..., None, :], dim=-1) \
        <= _mean(s.speed)
    up = s.avail > 0
    recovered = ~up & (u["recover"] < _mean(s.p_return))
    avail = (up | recovered) & ~(event & hit)
    return s._replace(avail=avail.to(torch.float32))


def diurnal_transition(cfg, u, s: ScenarioState) -> ScenarioState:
    """Diurnal load curve: availability breathes sinusoidally.

    The target level is ``floor + (1 - floor) · (1 + sin φ) / 2``, the
    phase φ advancing a fixed step a round (the p_drop slot; the floor is
    the p_return slot, the running phase the speed slot); each client is
    then available with that probability.  ``u["level"]`` (N,).
    """
    del cfg
    phase = s.speed + s.p_drop
    floor = s.p_return
    level = floor + (1.0 - floor) * 0.5 * (1.0 + torch.sin(phase))
    avail = u["level"] < level
    return s._replace(avail=avail.to(torch.float32), speed=phase)


Transition = Callable[..., ScenarioState]
Draws = Callable[..., Dict[str, Tuple[int, ...]]]


# each kind's uniforms, named in the order they are drawn, with their
# shapes for one simulation; the reference's key splits fix the set
def _no_draws(cfg) -> Dict[str, Tuple[int, ...]]:
    return {}


def _dynamic_draws(cfg) -> Dict[str, Tuple[int, ...]]:
    return {"waypoint": (cfg.n_clients, 2), "drop": (cfg.n_clients,)}


def _flash_draws(cfg) -> Dict[str, Tuple[int, ...]]:
    return {"burst": (), "decay": (cfg.n_clients,)}


def _regional_draws(cfg) -> Dict[str, Tuple[int, ...]]:
    return {"event": (), "centre": (2,), "recover": (cfg.n_clients,)}


def _diurnal_draws(cfg) -> Dict[str, Tuple[int, ...]]:
    return {"level": (cfg.n_clients,)}


TRANSITIONS: Dict[str, Transition] = {"static": static_transition,
                                      "dynamic": advance_dynamic,
                                      _FLASH: flash_crowd_transition,
                                      _REGIONAL: regional_outage_transition,
                                      _DIURNAL: diurnal_transition}
DRAWS: Dict[str, Draws] = {"static": _no_draws, "dynamic": _dynamic_draws,
                           _FLASH: _flash_draws, _REGIONAL: _regional_draws,
                           _DIURNAL: _diurnal_draws}
# the named parts, and every "+"-mixture of them in any order, run the
# same parameterised transition
for _r in range(1, len(_PARTS) + 1):
    for _combo in itertools.permutations(_PARTS, _r):
        TRANSITIONS["+".join(_combo)] = advance_dynamic
        DRAWS["+".join(_combo)] = _dynamic_draws


def register_transition(kind: str, fn: Transition,
                        draws: Draws = _no_draws) -> None:
    """Register a custom transition ``fn(cfg, u, state) -> state``;
    ``draws(cfg)`` names the uniforms it takes (``{name: shape}`` for one
    simulation, in draw order), which ``engine.sample_draws`` then makes."""
    TRANSITIONS[kind] = fn
    DRAWS[kind] = draws


def _check_kind(kind: str) -> None:
    if kind not in TRANSITIONS:
        raise ValueError(f"unknown scenario transition {kind!r}; "
                         f"registered: {sorted(TRANSITIONS)}")


def draw_shapes(cfg, kind: str) -> Dict[str, Tuple[int, ...]]:
    """The uniforms ``kind`` takes a round, ``{name: shape}`` in draw
    order, for one simulation."""
    _check_kind(kind)
    return DRAWS[kind](cfg)


def draw_size(cfg, kind: str) -> int:
    """U, the uniforms ``kind`` takes a round, for one simulation."""
    return sum(math.prod(shape) for shape in draw_shapes(cfg, kind).values())


def unpack_draws(cfg, kind: str, flat: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """(…, U) uniforms -> ``{name: (…, *shape)}`` views, in draw order."""
    out, at = {}, 0
    lead = flat.shape[:-1]
    for name, shape in draw_shapes(cfg, kind).items():
        size = math.prod(shape)
        out[name] = flat[..., at:at + size].reshape(lead + tuple(shape))
        at += size
    if at != flat.shape[-1]:
        raise ValueError(f"scenario {kind!r} takes {at} uniforms a round, "
                         f"got {flat.shape[-1]}")
    return out


def advance(cfg, kind: str, u: torch.Tensor, s: ScenarioState
            ) -> ScenarioState:
    """One round of ``kind`` from ``s`` with the flat (…, U) uniforms
    ``u``."""
    _check_kind(kind)
    return TRANSITIONS[kind](cfg, unpack_draws(cfg, kind, u), s)


# ---------------------------------------------------------------------------
# Presets (the sweep vocabulary)
# ---------------------------------------------------------------------------

PRESETS: Dict[str, ScenarioSpec] = {
    "static": ScenarioSpec(),
    "random_waypoint": ScenarioSpec(kind="random_waypoint"),
    "markov_dropout": ScenarioSpec(kind="markov_dropout"),
    "hetero_devices": ScenarioSpec(kind="hetero_devices"),
    # flaky pedestrians: slow motion, sticky outages
    "mobile_flaky": ScenarioSpec(kind="random_waypoint+markov_dropout",
                                 speed_max_mps=3.0, p_drop=0.3, p_return=0.3),
    # everything at once: vehicular speeds on a heterogeneous fleet
    "full_dynamic": ScenarioSpec(kind="dynamic", speed_max_mps=25.0),
    # burst arrivals: availability decays (p_drop), then a flash crowd
    # returns every dropped client at once with prob p_return per round
    "flash_crowd": ScenarioSpec(kind="flash_crowd", p_drop=0.25,
                                p_return=0.15),
    # spatially-correlated outages: with prob p_drop per round a disk of
    # clients goes dark together; survivors recover with p_return
    "regional_outage": ScenarioSpec(kind="regional_outage", p_drop=0.2,
                                    p_return=0.4),
    # day/night participation rhythm between the floor and 1 over
    # diurnal_period_rounds
    "diurnal": ScenarioSpec(kind="diurnal"),
}


def preset(name_or_spec) -> ScenarioSpec:
    """Resolve a preset name, kind string or ScenarioSpec to a spec."""
    if isinstance(name_or_spec, ScenarioSpec):
        return name_or_spec
    if name_or_spec is None:
        return ScenarioSpec()
    if name_or_spec in PRESETS:
        return PRESETS[name_or_spec]
    return ScenarioSpec(kind=str(name_or_spec))   # .parts validates it

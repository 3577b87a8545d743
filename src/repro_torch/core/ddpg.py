"""DDPG resource allocation (paper §IV-C, Algorithm 2).

Actor-critic with target networks, experience replay and soft updates
(Lillicrap et al. [38]).  All clients form one agent, as in the paper:
the state stacks every associated client's channel gain and data size,
the action is the 2N vector of (transmit power, CPU frequency) per
client.  The environment is ``core.env``'s MDP, whose every slot bills
its reward with the engine's Eq. 23a cost -- one SIC kernel call a slot.

Every stage runs over a leading seed axis S: the networks are (S, in,
out) weights applied as batched products, the replay ring is (S, size,
…), and one autograd pass over the sum of the seeds' losses gives each
seed exactly its own gradient.  ``train_allocator_fleet`` trains S agents
on S stacked worlds in one loop; ``train_allocator`` is that loop over a
fleet of one.  ``init_ddpg`` and ``train_allocator`` take and return one
agent (leaves without the seed axis); ``stack_agents`` makes a fleet.

The randomness is one explicit ``DDPGDraws`` argument: the exploration
noise, each slot's fading field and dropout uniforms, each update's
minibatch indices.  ``sample_ddpg_draws`` makes them on the device from
one ``torch.Generator`` per seed; the tests replay the reference's own
key chain through the same argument.  Which slots train and whether the
replay buffer is empty are functions of the slot count, so those
branches run on the host and nothing is read back from the device.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import engine, env
from repro_torch.models.mlp import scaled_init

Params = Dict[str, torch.Tensor]


class DDPGConfig(NamedTuple):
    state_dim: int
    action_dim: int
    hidden: int = 256
    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    gamma: float = 0.99          # ψ discount
    tau: float = 0.005           # ζ soft-update speed (Eq. 40)
    buffer_size: int = 20_000
    batch_size: int = 64
    noise_sigma: float = 0.1
    noise_decay: float = 0.999


class DDPGState(NamedTuple):
    """One agent, or a fleet of S with every leaf led by S."""
    actor: Params
    critic: Params
    target_actor: Params
    target_critic: Params
    actor_opt: Dict[str, Params]     # {"m": …, "v": …} Adam moments
    critic_opt: Dict[str, Params]
    buffer: Params                   # {"s", "a", "r", "s2"} ring arrays
    buffer_idx: torch.Tensor         # int32 next slot
    buffer_full: torch.Tensor        # bool: the ring has wrapped
    noise_sigma: torch.Tensor        # float32 exploration scale
    step: torch.Tensor               # int32 updates so far


class DDPGDraws(NamedTuple):
    """A training run's random numbers, led by (episodes, steps, S):
    ``reset_fading`` (E, S, N, M) and ``fading`` (E, T, S, N, M) are
    ``Exp(1)`` fields (the episode's first gains, each slot's next);
    ``drop_u`` (E, T, S, N) the dropout chain's uniforms (None in a world
    without one); ``noise`` (E, T, S, A) the standard-normal exploration
    noise; ``batch_idx`` (E, T, S, B) each update's minibatch, uniform
    over the min(t, buffer_size) filled slots after slot t's store."""
    reset_fading: torch.Tensor
    fading: torch.Tensor
    drop_u: Optional[torch.Tensor]
    noise: torch.Tensor
    batch_idx: torch.Tensor

    def seed(self, s: int) -> "DDPGDraws":
        """Seed ``s``'s own draws, its seed axis removed (what
        ``train_allocator`` takes)."""
        return DDPGDraws(self.reset_fading[:, s], *(
            None if v is None else v[:, :, s] for v in self[1:]))


# ---------------------------------------------------------------------------
# Networks
# ---------------------------------------------------------------------------

def _mlp_init(generator: torch.Generator, sizes) -> Params:
    dev = generator.device
    ws = {f"w{i}": scaled_init((sizes[i], sizes[i + 1]),
                               generator=generator, device=dev)
          for i in range(len(sizes) - 1)}
    return ws | {f"b{i}": torch.zeros((sizes[i + 1],), device=dev)
                 for i in range(len(sizes) - 1)}


def _mlp_apply(params: Params, x: torch.Tensor, n_layers: int
               ) -> torch.Tensor:
    """x (B, in) -> (B, out) through ``n_layers`` ReLU layers; one input
    row, x (in,), gives (out,).  A fleet's weights (S, in, out) apply to
    seed s's rows x (S, …) one seed at a time: a batched product's kernel,
    and with it the order of its sums, depends on the batch's size, so a
    seed's products (and their gradients) would differ from its own
    single run's in the last bits."""
    if params["w0"].dim() == 3:
        return torch.stack([
            _mlp_apply({k: v[s] for k, v in params.items()}, x[s], n_layers)
            for s in range(x.shape[0])])
    one = x.dim() == 1
    if one:
        x = x.unsqueeze(0)
    for i in range(n_layers):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            x = torch.relu(x)
    return x[0] if one else x


def actor_apply(params: Params, state: torch.Tensor) -> torch.Tensor:
    """State -> action in [0, 1]^A (the env scales it to physical
    bounds)."""
    return torch.sigmoid(_mlp_apply(params, state, 3))


def critic_apply(params: Params, state: torch.Tensor, action: torch.Tensor
                 ) -> torch.Tensor:
    return _mlp_apply(params, torch.cat([state, action], dim=-1), 3)[..., 0]


def init_ddpg(generator: torch.Generator, cfg: DDPGConfig) -> DDPGState:
    """One agent on ``generator``'s device: scaled-normal weights (actor
    first, then critic), zero biases, targets equal to the networks,
    zero Adam moments and an empty replay ring."""
    dev = generator.device
    actor = _mlp_init(generator, (cfg.state_dim, cfg.hidden, cfg.hidden,
                                  cfg.action_dim))
    critic = _mlp_init(generator, (cfg.state_dim + cfg.action_dim,
                                   cfg.hidden, cfg.hidden, 1))
    zeros = lambda p: {k: torch.zeros_like(v) for k, v in p.items()}
    copy = lambda p: {k: v.clone() for k, v in p.items()}
    f32 = dict(dtype=torch.float32, device=dev)
    buffer = {"s": torch.zeros((cfg.buffer_size, cfg.state_dim), **f32),
              "a": torch.zeros((cfg.buffer_size, cfg.action_dim), **f32),
              "r": torch.zeros((cfg.buffer_size,), **f32),
              "s2": torch.zeros((cfg.buffer_size, cfg.state_dim), **f32)}
    return DDPGState(actor, critic, copy(actor), copy(critic),
                     {"m": zeros(actor), "v": zeros(actor)},
                     {"m": zeros(critic), "v": zeros(critic)}, buffer,
                     torch.zeros((), dtype=torch.int32, device=dev),
                     torch.zeros((), dtype=torch.bool, device=dev),
                     torch.full((), cfg.noise_sigma, **f32),
                     torch.zeros((), dtype=torch.int32, device=dev))


def stack_agents(agents) -> DDPGState:
    """One-agent states (or actors) -> a fleet: every leaf stacked along a
    new leading seed axis (``engine.select_seed`` takes one back)."""
    return engine._map(lambda *leaves: torch.stack(leaves), *agents)


def select_action(agent: DDPGState, obs: torch.Tensor,
                  noise: torch.Tensor) -> torch.Tensor:
    """Algorithm 2 line 8: A = ν(S|θ) + σ·noise, clipped to [0, 1];
    ``obs`` (S, state_dim), ``noise`` (S, A) standard normal."""
    a = actor_apply(agent.actor, obs)
    return torch.clamp(a + agent.noise_sigma[..., None] * noise, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Replay, Adam, updates
# ---------------------------------------------------------------------------

def store(agent: DDPGState, cfg: DDPGConfig, s, a, r, s2) -> DDPGState:
    """Write each seed's transition (s, a (S, …), r (S,), s2) at its ring
    slot; the ring wraps at ``buffer_size`` and is then full."""
    seeds = agent.buffer_idx.shape[0]
    at = (torch.arange(seeds, device=r.device), agent.buffer_idx.long())
    buf = {k: torch.index_put(agent.buffer[k], at, v)
           for k, v in (("s", s), ("a", a), ("r", r), ("s2", s2))}
    nxt = (agent.buffer_idx + 1) % cfg.buffer_size
    return agent._replace(buffer=buf, buffer_idx=nxt,
                          buffer_full=agent.buffer_full | (nxt == 0))


def _per_seed(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-seed (S,) scalar shaped to broadcast over a leaf (S, …)."""
    return c.reshape(c.shape + (1,) * (x.dim() - c.dim()))


def _adam(params: Params, grads, opt: Dict[str, Params], lr: float,
          step: torch.Tensor, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8) -> Tuple[Params, Dict[str, Params]]:
    """The reference's Adam, term for term in its float32 rounding (not
    ``torch.optim.Adam``'s): t = step + 1, m̂ = m / (1 − b1^t),
    v̂ = v / (1 − b2^t), p − lr·m̂ / (√v̂ + eps); the bias corrections are
    each seed's own."""
    keys = list(params)
    p = [params[k] for k in keys]
    g = list(grads)
    m = torch._foreach_add(torch._foreach_mul([opt["m"][k] for k in keys],
                                              b1),
                           torch._foreach_mul(g, 1 - b1))
    v = torch._foreach_add(torch._foreach_mul([opt["v"][k] for k in keys],
                                              b2),
                           torch._foreach_mul(torch._foreach_mul(g, 1 - b2),
                                              g))
    t = step.to(torch.float32) + 1.0
    c1 = 1.0 - torch.full_like(t, b1) ** t
    c2 = 1.0 - torch.full_like(t, b2) ** t
    mhat = [mi / _per_seed(c1, mi) for mi in m]
    vhat = [vi / _per_seed(c2, vi) for vi in v]
    upd = torch._foreach_div(torch._foreach_mul(mhat, lr),
                             torch._foreach_add(torch._foreach_sqrt(vhat),
                                                eps))
    new = torch._foreach_sub(p, upd)
    return (dict(zip(keys, new)),
            {"m": dict(zip(keys, m)), "v": dict(zip(keys, v))})


def _soft(target: Params, online: Params, tau: float) -> Params:
    """Eq. 40: (1 − τ)·target + τ·online."""
    keys = list(target)
    new = torch._foreach_add(
        torch._foreach_mul([target[k] for k in keys], 1 - tau),
        torch._foreach_mul([online[k] for k in keys], tau))
    return dict(zip(keys, new))


def _grads(loss: torch.Tensor, params: Params):
    """d(Σ_s loss_s)/d params: each seed's gradient is its own loss's."""
    return torch.autograd.grad(loss.sum(), list(params.values()))


def _update(agent: DDPGState, cfg: DDPGConfig, batch_idx: torch.Tensor
            ) -> Tuple[DDPGState, Dict[str, torch.Tensor]]:
    """One minibatch update of every seed: the critic (Eq. 38) toward
    y = r + ψ Q'(s2, ν'(s2)) from the targets, then the actor (Eq. 39)
    through the updated critic, then the soft target update (Eq. 40).
    ``batch_idx`` (S, B) indexes each seed's own ring."""
    seeds = batch_idx.shape[0]
    sd = torch.arange(seeds, device=batch_idx.device)[:, None]
    idx = batch_idx.long()
    s, a, r, s2 = (agent.buffer[k][sd, idx] for k in ("s", "a", "r", "s2"))
    with torch.no_grad():
        a2 = actor_apply(agent.target_actor, s2)
        y = r + cfg.gamma * critic_apply(agent.target_critic, s2, a2)
    with torch.enable_grad():
        cp = {k: v.detach().requires_grad_() for k, v in agent.critic.items()}
        cl = torch.mean((y - critic_apply(cp, s, a)) ** 2, dim=-1)
        cg = _grads(cl, cp)
    with torch.no_grad():
        critic, critic_opt = _adam(agent.critic, cg, agent.critic_opt,
                                   cfg.critic_lr, agent.step)
    with torch.enable_grad():
        ap = {k: v.detach().requires_grad_() for k, v in agent.actor.items()}
        al = -torch.mean(critic_apply(critic, s, actor_apply(ap, s)), dim=-1)
        ag = _grads(al, ap)
    with torch.no_grad():
        actor, actor_opt = _adam(agent.actor, ag, agent.actor_opt,
                                 cfg.actor_lr, agent.step)
        new = agent._replace(
            actor=actor, critic=critic,
            target_actor=_soft(agent.target_actor, actor, cfg.tau),
            target_critic=_soft(agent.target_critic, critic, cfg.tau),
            actor_opt=actor_opt, critic_opt=critic_opt,
            noise_sigma=agent.noise_sigma * cfg.noise_decay,
            step=agent.step + 1)
    return new, {"critic_loss": cl.detach(), "actor_loss": al.detach()}


def train_step(agent: DDPGState, cfg: DDPGConfig, batch_idx: torch.Tensor
               ) -> Tuple[DDPGState, Dict[str, torch.Tensor]]:
    """One minibatch update of a fleet of agents (Eqs. 38-40) from the
    (S, B) ring indices ``batch_idx``.

    On an empty replay ring (nothing stored, not wrapped) it is a no-op
    with zero losses: the all-zero initial slots are not experience.  A
    full ring whose write index wrapped back to 0 trains.  Reads the
    ring's state back from the device; the trainer, which knows it,
    calls ``_update`` directly."""
    empty = (agent.buffer_idx == 0) & ~agent.buffer_full
    n_empty = int(torch.sum(empty))
    if n_empty == empty.numel():
        zero = torch.zeros(empty.shape, device=empty.device)
        return agent, {"critic_loss": zero, "actor_loss": zero}
    if n_empty:
        raise ValueError("train_step: the fleet's rings are empty on some "
                         "seeds only; its seeds store in lockstep")
    return _update(agent, cfg, batch_idx)


# ---------------------------------------------------------------------------
# The trainer (Algorithm 2)
# ---------------------------------------------------------------------------

def allocator_config(cfg, spec, *, hidden: int = 128,
                     buffer_size: int = 4096,
                     batch_size: int = 64) -> DDPGConfig:
    """The ``DDPGConfig`` for an engine (cfg, spec): a dynamic scenario adds
    the availability slice to the observation, (3N,) instead of (2N,)."""
    n = cfg.n_clients
    state_dim = (2 + (spec.scenario != "static")) * n
    return DDPGConfig(state_dim=state_dim, action_dim=2 * n, hidden=hidden,
                      buffer_size=buffer_size, batch_size=batch_size)


def sample_ddpg_draws(cfg, dcfg: DDPGConfig, generators, episodes: int,
                      steps: int) -> DDPGDraws:
    """A training run's draws for S = len(generators) seeds, seed s's from
    ``generators[s]`` on its device, in the order reset fading, fading,
    dropout uniforms (only for the (3N,) observation of a dynamic world),
    noise, then one ``torch.randint(0, min(t, buffer_size))`` minibatch
    per slot t = 1, 2, …, E·T."""
    n, m = cfg.n_clients, cfg.n_edges
    drops = dcfg.state_dim == 3 * n
    rows = []
    for gen in generators:
        kw = dict(generator=gen, device=gen.device)
        exp1 = lambda shape: torch.empty(
            shape, dtype=torch.float32, device=gen.device).exponential_(
                generator=gen)
        reset = exp1((episodes, n, m))
        fading = exp1((episodes, steps, n, m))
        drop_u = (torch.rand((episodes, steps, n), **kw) if drops else None)
        noise = torch.randn((episodes, steps, dcfg.action_dim), **kw)
        idx = torch.stack([
            torch.randint(0, min(t, dcfg.buffer_size), (dcfg.batch_size,),
                          **kw)
            for t in range(1, episodes * steps + 1)])
        rows.append(DDPGDraws(reset, fading, drop_u, noise,
                              idx.reshape(episodes, steps, -1)))
    stack = lambda axis, f: None if f[0] is None else torch.stack(f, axis)
    fields = list(zip(*rows))
    return DDPGDraws(stack(1, fields[0]),
                     *(stack(2, f) for f in fields[1:]))


def rollout_step(cfg, params: env.EnvParams, dcfg: DDPGConfig, carry,
                 draws: DDPGDraws, *, noma_enabled: bool = True,
                 warmup: int = 64):
    """Algorithm 2 lines 8-14, one slot of every seed: act with the
    slot's exploration ``draws.noise``, step the env (one SIC call for
    all seeds), store, then one minibatch update from slot ``warmup`` on
    (slots counted across episodes).  ``draws`` is the slot's slice
    (its fields (S, …); ``reset_fading`` unused): its ``batch_idx`` is
    taken whether or not the slot trains, so a run's draws stay aligned
    with the reference's key use.

    ``carry`` = (agent, env_state, obs, t) with ``t`` the host's slot
    count; returns (carry', (reward (S,), losses))."""
    agent, est, obs, t = carry
    act = select_action(agent, obs, draws.noise)
    est, obs2, reward, _ = env.env_step(cfg, params, est, act, draws.fading,
                                        draws.drop_u,
                                        noma_enabled=noma_enabled)
    agent = store(agent, dcfg, obs, act, reward, obs2)
    t += 1
    if t >= warmup:          # the ring holds slot t's transition: not empty
        agent, losses = _update(agent, dcfg, draws.batch_idx)
    else:
        zero = torch.zeros_like(reward)
        losses = {"critic_loss": zero, "actor_loss": zero}
    return (agent, est, obs2, t), (reward, losses)


def _episode_params(cfg, spec, states, bundles, assoc_u=None
                    ) -> env.EnvParams:
    """The training MDP of each seed's current round state: the engine's
    pre-transition association snapshot over the scenario's cost surface
    (distances, availability and its chain, κ and caps)."""
    dynamic = spec.scenario != "static"
    scen = states.scenario if dynamic else None
    assoc = engine.fleet_snapshot(cfg, spec, states, bundles, assoc_u)
    return env.make_env_params(
        cfg, assoc, torch.ones(assoc.shape[:-2] + (cfg.n_edges,),
                               device=assoc.device),
        scen.dist if dynamic else bundles.dist, bundles.counts,
        fading_rho=spec.fading_rho,
        avail=scen.avail if dynamic else None,
        kappa=scen.kappa if dynamic else None,
        p_max_w=scen.p_max_w if dynamic else None,
        f_max_hz=scen.f_max_hz if dynamic else None,
        p_drop=scen.p_drop if dynamic else None,
        p_return=scen.p_return if dynamic else None)


def train_allocator_fleet(cfg, spec, states, bundles, dcfg: DDPGConfig,
                          agents: DDPGState, draws: DDPGDraws, *,
                          warmup: int = 64,
                          assoc_u: Optional[torch.Tensor] = None
                          ) -> Tuple[DDPGState, Dict[str, torch.Tensor]]:
    """Algorithm 2 for a fleet: S agents (``stack_agents``), each on its
    own world (``engine.stack_fleet`` states and bundles; the MDP of each
    seed's current association), trained in one batched loop of E
    episodes × T slots, the shape of ``draws``.  ``assoc_u`` (S, N, M):
    rcea's snapshot uniforms.  Returns the trained agents and the
    per-episode means of the reward and the two losses, each (S, E)."""
    params = _episode_params(cfg, spec, states, bundles, assoc_u)
    episodes, steps = draws.fading.shape[:2]
    history: Dict[str, List[torch.Tensor]] = {
        "episode_reward": [], "critic_loss": [], "actor_loss": []}
    agent, t = agents, 0
    for e in range(episodes):
        est, obs = env.env_reset(cfg, params, draws.reset_fading[e])
        rewards, closs, aloss = [], [], []
        for k in range(steps):
            slot = DDPGDraws(None, *(None if v is None else v[e, k]
                                     for v in draws[1:]))
            (agent, est, obs, t), (reward, losses) = rollout_step(
                cfg, params, dcfg, (agent, est, obs, t), slot,
                noma_enabled=spec.noma_enabled, warmup=warmup)
            rewards.append(reward)
            closs.append(losses["critic_loss"])
            aloss.append(losses["actor_loss"])
        for key, rows in (("episode_reward", rewards), ("critic_loss", closs),
                          ("actor_loss", aloss)):
            # a seed at a time, as the networks' products
            history[key].append(torch.stack(
                [torch.mean(r) for r in torch.stack(rows, dim=-1)]))
    return agent, {k: torch.stack(v, dim=-1) for k, v in history.items()}


def train_allocator(cfg, spec, state, bundle, dcfg: DDPGConfig,
                    agent: DDPGState, draws: DDPGDraws, *, warmup: int = 64,
                    assoc_u: Optional[torch.Tensor] = None
                    ) -> Tuple[DDPGState, Dict[str, torch.Tensor]]:
    """Algorithm 2 for one simulation: ``train_allocator_fleet`` over a
    fleet of one.  ``agent`` and ``draws`` are one seed's (``init_ddpg``;
    ``DDPGDraws.seed``); the history's leaves are (E,)."""
    lift = lambda axis, t: None if t is None else t.unsqueeze(axis)
    draws = DDPGDraws(lift(1, draws.reset_fading),
                      *(lift(2, v) for v in draws[1:]))
    agents, history = train_allocator_fleet(
        cfg, spec, engine._lift(state), engine._lift(bundle), dcfg,
        stack_agents([agent]), draws, warmup=warmup,
        assoc_u=None if assoc_u is None else assoc_u[None])
    return engine.select_seed(agents, 0), {k: v[0] for k, v in history.items()}

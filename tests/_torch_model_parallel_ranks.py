"""The ranks' target of ``tests/test_torch_model_parallel.py``: each case
served across a ``data x model`` mesh of gloo ranks on the CPU.

``make_case(name)`` builds a case of ``CASES`` from its seed alone, so
the ranks build their own inputs (sending them would pickle ~90 MB of
weights to each).  ``rank_main(plan)`` runs on every rank
(``core.mesh.spawn``): for each model-axis size M of ``plan`` it builds
``launch.mesh.make_host_mesh(model=M, device="cpu")`` over the four
ranks, and for each of M's cases the port's model on that mesh from the
reference's weights (``convert.params_from_numpy(..., mesh=)``); then the
full logits and the MoE aux (``apply``), the prefill step's last logits
(``steps.make_prefill_step``), a VLM's prefix through ``prefill_prefix``
or an encoder-decoder's frames through ``prefill_cross``, the prompt
decoded token by token (``decode_step``, each step's logits kept) and
greedy tokens from ``steps.make_serve_step``, and the cache after them
gathered by ``convert.cache_to_numpy``.
Each MoE layer's routing of the forward is recorded as
``moe.route`` returns it.  Also returned: each parameter's local
shape, the weights gathered back by ``convert.params_to_numpy`` (checked
here against the weights given) and this rank's coordinates.

``rank_main(plan, train_plan)`` then trains the cases of ``train_plan``
({model-axis size: [training case names]}, ``TRAIN_CASES``) on the same
meshes with the training placement (``train_case``): ``loss_and_grads``
of the first batch, then ``TRAIN_STEPS`` steps of ``make_train_step``
(lr ``LR``), each gathered whole by ``convert``.
"""
import hashlib

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model, moe

B, S, PROMPT, STEPS, CACHE = 4, 30, 4, 8, 24

# name: (architecture, its reduced config's replacements)
CASES = {
    "yi": ("yi-34b", {}),
    "yi-cp": ("yi-34b", dict(n_heads=6, n_kv_heads=2, d_head=32)),
    "qwen3": ("qwen3-8b", {}),
    "qwen3-straddle": ("qwen3-8b", dict(n_heads=12, n_kv_heads=3,
                                        d_head=32)),
    "qwen1.5": ("qwen1.5-110b", dict(n_kv_heads=2)),
    "stablelm": ("stablelm-1.6b", {}),
    "stablelm-v510": ("stablelm-1.6b", dict(vocab_size=510)),
    "paligemma": ("paligemma-3b", {}),
    "sw4k": ("qwen3-8b-sw4k", dict(window=8)),
    "grok": ("grok-1-314b", {}),
    "grok-e6": ("grok-1-314b", dict(moe_experts=6,
                                    moe_capacity_factor=0.5)),
    "llama4": ("llama4-maverick-400b-a17b", dict(attn_chunk=8)),
    "recurrentgemma": ("recurrentgemma-9b", {}),
    "xlstm": ("xlstm-125m", {}),
    "whisper": ("whisper-large-v3", {}),
    "xlstm-h2": ("xlstm-125m", dict(n_heads=2, n_kv_heads=2)),
    "whisper-cp": ("whisper-large-v3", dict(n_heads=6, n_kv_heads=6,
                                            d_head=32)),
    "whisper-whole": ("whisper-large-v3", dict(n_heads=6, n_kv_heads=6,
                                               d_head=30)),
}
# a case's own cache length: at 1 x 4 the model axis divides neither
# whisper-whole's 26 slots, its dh of 30 nor its 6 heads, so every rank
# holds the whole self cache (its 16 frames still split)
CACHE_LENS = {"whisper-whole": 26}
# one case of each recurrent or encoder-decoder family on the data axis
# alone (4 x 1)
DATA_CASES = ("recurrentgemma", "xlstm", "whisper")


def _perturb(tree, rng):
    """The constant-initialised leaves (norm scales, biases) and the
    untied output table redrawn from ``rng``, recursively."""
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            out[key] = _perturb(leaf, rng)
            continue
        leaf = np.asarray(leaf)
        if key == "scale":
            leaf = 1.0 + 0.2 * rng.normal(size=leaf.shape)
        elif key in ("bias", "bq", "bk", "bv"):
            leaf = 0.3 * rng.normal(size=leaf.shape)
        elif key == "unembedding":
            leaf = 0.02 * rng.normal(size=leaf.shape)
        out[key] = leaf.astype(np.float32)
    return out


def make_case(name: str) -> dict:
    """A case from its seed: the reduced config, weights in the
    reference's layout (a port model drawn from a generator, through
    ``convert.params_to_numpy``, its constant leaves redrawn), B x S
    tokens, and a VLM's prefix embeddings or an encoder-decoder's frames."""
    i = list(CASES).index(name)
    arch, kw = CASES[name]
    cfg = get_config(arch).reduced().replace(**kw)
    raw = convert.params_to_numpy(build_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(i)))
    rng = np.random.default_rng(100 + i)
    params = _perturb(raw, rng)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
    n_extra = cfg.stub_frames if cfg.encoder_layers else cfg.prefix_tokens
    extra = (rng.normal(size=(B, n_extra, cfg.d_model)).astype(np.float32)
             if n_extra else None)
    return dict(name=name, cfg=cfg, params=params, tokens=tokens,
                extra=extra, prompt_len=PROMPT, steps=STEPS,
                cache_len=CACHE_LENS.get(name, CACHE))


def serve_case(case, mesh):
    """One case's outputs as numpy arrays (``mesh`` None: unsharded)."""
    cfg = case["cfg"]
    model = convert.params_from_numpy(case["params"], cfg, device="cpu",
                                      mesh=mesh)
    toks = torch.from_numpy(case["tokens"])
    extra = None if case["extra"] is None else torch.from_numpy(case["extra"])
    routes = []
    real = moe.route

    def record(*a, **kw):
        r = real(*a, **kw)
        routes.append(r)
        return r
    moe.route = record
    try:
        with torch.no_grad():
            logits, aux = model.apply(toks, extra, with_aux=True)
    finally:
        moe.route = real
    prefill, _ = steps.make_prefill_step(cfg, model=model)
    last = prefill({"tokens": toks} if extra is None
                   else {"tokens": toks, "embeddings": extra})
    serve_step, _ = steps.make_serve_step(cfg, model=model)
    b = toks.shape[0]
    cache = model.init_cache(b, case["cache_len"])
    start = 0
    with torch.no_grad():
        if cfg.encoder_layers:
            cache = model.prefill_cross(cache, extra)
        elif extra is not None:
            cache = model.prefill_prefix(cache, extra)
            start = cfg.prefix_tokens
        steps_logits = []
        for i in range(case["prompt_len"]):
            lg, cache = model.decode_step(toks[:, i:i + 1], cache, start + i,
                                          prefix_len=cfg.prefix_tokens)
            steps_logits.append(lg[:, 0])
    tok = toks[:, case["prompt_len"] - 1:case["prompt_len"]]
    greedy = []
    for i in range(case["steps"]):
        tok, cache = serve_step(tok, cache, start + case["prompt_len"] + i)
        greedy.append(tok[:, 0])
    gathered = convert.params_to_numpy(model)
    whole_cache = convert.cache_to_numpy(cache, model, b)
    return dict(
        logits=logits.numpy(), aux=float(aux), last=last.numpy(),
        decode=torch.stack(steps_logits, 1).numpy(),
        greedy=torch.stack(greedy, 1).numpy(),
        routes=[(r.idx.numpy(), r.pos.numpy(), r.keep.numpy(),
                 r.gate.numpy()) for r in routes],
        cache=whole_cache,
        shapes={n: tuple(p.shape) for n, p in model.named_parameters()},
        round_trip=_same_tree(gathered, case["params"]))


def _same_tree(got, want) -> bool:
    if isinstance(want, dict):
        return set(got) == set(want) and all(_same_tree(got[k], want[k])
                                             for k in want)
    return np.array_equal(np.asarray(got), np.asarray(want))


# -- training ----------------------------------------------------------------

LR = 1e-2
TRAIN_STEPS = 3
TRAIN_B, TRAIN_S = 4, 18     # S = 18: context-parallel blocks 5, 5, 5, 3
# a training case: (the serving case whose config and weights it takes, its
# config's further replacements, its batch's rows); a batch of 3 rows the
# data axes of 2 and 4 do not divide: whole on every data rank
TRAIN_CASES = {
    **{name: (name, {}, TRAIN_B) for name in CASES},
    "stablelm-accum": ("stablelm-v510", dict(grad_accum=2), TRAIN_B),
    "yi-remat": ("yi", dict(remat=True), TRAIN_B),
    "yi-odd": ("yi", {}, 3),
}


def train_batches(name: str, cfg):
    """``TRAIN_STEPS`` batches of a training case from its serving case's
    seed and its rows: tokens, labels, a loss mask (some zeros in the
    first batch, all ones after; none on a batch of odd rows, whose loss
    is the plain mean), and a VLM's prefix or an encoder-decoder's
    frames."""
    base, _, rows = TRAIN_CASES[name]
    # the variants of a case (remat, grad_accum) train on its batches
    rng = np.random.default_rng([300, list(CASES).index(base), rows])
    out = []
    for i in range(TRAIN_STEPS):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (rows, TRAIN_S)),
             "labels": rng.integers(0, cfg.vocab_size, (rows, TRAIN_S))}
        b = {k: v.astype(np.int32) for k, v in b.items()}
        if rows % 2 == 0:
            b["loss_mask"] = (rng.random((rows, TRAIN_S)) > 0.2 * (i == 0)
                              ).astype(np.float32)
        n = cfg.stub_frames if cfg.encoder_layers else cfg.prefix_tokens
        if n:
            b["embeddings"] = rng.normal(size=(rows, n, cfg.d_model)) \
                .astype(np.float32)
        out.append(b)
    return out


def make_train_case(name: str, served: dict) -> dict:
    """A training case: its serving case's weights, its config with its
    replacements, its batches."""
    base, kw, _ = TRAIN_CASES[name]
    cfg = served["cfg"].replace(**kw)
    return dict(name=name, cfg=cfg, params=served["params"],
                batches=train_batches(name, cfg))


def train_case(case, mesh):
    """One training case's outputs (``mesh`` None: unsharded): the loss
    and every gradient of the first batch (``loss_and_grads``), then each
    step's loss, both Adam moments after the first step and the weights
    after the last, all gathered whole in the reference's layout; each
    parameter's and each moment's local shape."""
    cfg = case["cfg"]
    model = convert.params_from_numpy(case["params"], cfg, device="cpu",
                                      mesh=mesh, fsdp=True)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in case["batches"]]
    loss, grads = steps.loss_and_grads(model, batches[0])
    out = dict(loss=float(loss), grads=convert.params_to_numpy(model, grads),
               losses=[])
    step_fn, _, opt = steps.make_train_step(cfg, lr=LR, model=model)
    state, count = opt.init(dict(model.named_parameters())), 0
    for b in batches:
        state, count, m = step_fn(state, count, b)
        out["losses"].append(float(m["loss"]))
        if count == 1:
            out["moments"] = convert.opt_state_to_numpy(model, state)
    out["weights"] = convert.params_to_numpy(model)
    out["shapes"] = {n: tuple(p.shape) for n, p in model.named_parameters()}
    out["moment_shapes"] = {k: {n: tuple(t.shape) for n, t in state[k].items()}
                            for k in ("m", "v")}
    return out


# the reference's training program compiled at XLA's lowest backend
# optimisation level: the same function, rounded apart by ~1e-7 at most
# on these cases, in ~40% of the compile time
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def train_reference(case):
    """The reference on a training case: ``jax.value_and_grad`` of its
    ``model_loss`` on the first batch, and three steps of its
    ``train_step`` as its lines compose it (``grad_accum=1``): the same
    gradient program, then ``clip_by_global_norm`` at 1.0 and ``adamw``'s
    ``update`` at lr ``LR``, one program compiled once -- each step's
    loss and the weights after the last."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.launch import steps as jsteps
    from repro.models import build_model as jbuild_model
    from repro.optim import adamw as jadamw
    from repro.optim import clip_by_global_norm as jclip
    cfg = case["cfg"]
    arch, kw = CASES[TRAIN_CASES[case["name"]][0]]
    jmodel = jbuild_model(jget_config(arch).reduced().replace(**kw))
    opt = jadamw(LR, opt_dtype=cfg.opt_dtype_str)

    def step(p, s, b, t):
        loss, grads = jax.value_and_grad(
            lambda q: jsteps.model_loss(jmodel, q, b))(p)
        p, s = opt.update(jclip(grads, 1.0), s, p, t)
        return loss, grads, p, s
    step = jax.jit(step, compiler_options=FAST_COMPILE)
    params = jax.tree.map(jnp.asarray, case["params"])
    state = opt.init(params)
    out = dict(losses=[])
    for i, batch in enumerate(case["batches"]):
        loss, grads, params, state = step(
            params, state, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.asarray(i, jnp.int32))
        if i == 0:
            out["loss"] = float(loss)
            out["grads"] = jax.tree.map(np.asarray, grads)
        out["losses"].append(float(loss))
    out["weights"] = jax.tree.map(np.asarray, params)
    return out


# the train CLI's runs on the mesh (``cli_runs``): its arguments, and
# (name, further arguments) of each run in turn
CLI_ARGS = ["--arch", "stablelm-1.6b", "--batch", "4", "--seq", "16",
            "--lr", str(LR), "--device", "cpu"]
CLI_RUNS = [("first", ["--steps", "2", "--ckpt-every", "1"]),
            ("again", ["--steps", "1", "--resume", "first",
                       "--ckpt-every", "3"]),
            ("whole", ["--steps", "3", "--ckpt-every", "3"])]


def cli_runs(directory: str, mesh_arg):
    """``CLI_RUNS`` of ``launch.train.main`` (with ``--mesh mesh_arg``, or
    unsharded where it is None), each writing its checkpoints under
    ``directory``/name: two steps, a third resumed from them, and three
    uninterrupted.  Returns {name: the lines it printed}."""
    import contextlib
    import io
    import os
    from repro_torch.launch import train
    out = {}
    for name, argv in CLI_RUNS:
        argv = [os.path.join(directory, a) if a == "first" else a
                for a in argv]
        argv += ["--ckpt-dir", os.path.join(directory, name)]
        if mesh_arg is not None:
            argv += ["--mesh", mesh_arg]
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            if train.main(CLI_ARGS + argv) != 0:
                raise RuntimeError(f"train {argv}")
        out[name] = text.getvalue().splitlines()
    return out


def rank_main(plan, train_plan=None, ref_names=(), port_names=(),
              cli_dir=None):
    """``plan`` {model-axis size: [case names]} (served) and ``train_plan``
    {model-axis size: [training case names]} (trained) -> {model-axis
    size: (this rank's coords, {case name: its serving outputs},
    {training case name: its training outputs}, ``collectives``)}; and,
    first, this rank's share (every world-th, from its rank) of the
    reference's training runs of ``ref_names`` (``train_reference``) and
    of the unsharded port's of ``port_names`` (``train_case``), under
    "refs" and "ports"; with ``cli_dir``, last, the train CLI's runs at
    2 x 2 writing there (``cli_runs``), under "cli"."""
    import torch.distributed as dist
    train_plan = train_plan or {}
    bases = [TRAIN_CASES[n][0] for names in train_plan.values()
             for n in names]
    cases = {name: make_case(name)
             for name in dict.fromkeys([n for names in plan.values()
                                        for n in names] + bases)}
    trained = {name: make_train_case(name, cases[TRAIN_CASES[name][0]])
               for names in train_plan.values() for name in names}
    g, world = dist.get_rank(), dist.get_world_size()
    out = {"refs": {n: train_reference(trained[n])
                    for n in ref_names[g::world]},
           "ports": {n: train_case(trained[n], None)
                     for n in port_names[g::world]}}
    for n_model in dict.fromkeys(list(plan) + list(train_plan)):
        mesh = make_host_mesh(model=n_model, device="cpu")
        first = mesh.coords == {"data": 0, "model": 0}
        out[n_model] = (dict(mesh.coords),
                        {name: serve_case(cases[name], mesh)
                         for name in plan.get(n_model, ())},
                        {name: _digested(train_case(trained[name], mesh),
                                         keep=first)
                         for name in train_plan.get(n_model, ())},
                        collectives(mesh))
    if cli_dir is not None:
        out["cli"] = cli_runs(cli_dir, "2x2")
    return out


def rank_value(coords, shape):
    """The tensor a rank at ``coords`` passes ``collectives``: its global
    rank times 100 plus 0..n-1."""
    g = coords["data"] * 100 + coords["model"] * 10
    return torch.arange(float(np.prod(shape))).reshape(shape) + g


def collectives(mesh):
    """``reduce_scatter`` on each axis of ``mesh``: blocks of ``block``'s
    sizes along dim 1 of (2, 7) (ragged where the axis does not divide 7),
    given equal counts along dim 0 of (4, 3), and given ragged counts; and
    the adjoint of a differentiable gather (``parallel.all_gather``), the
    gradient of its output's sum weighted by each gathered position."""
    from repro_torch.models import parallel
    out = {}
    for axis in ("data", "model"):
        w = mesh.shape[axis]
        t = rank_value(mesh.coords, (2, 7))
        out[axis, "block"] = mesh.reduce_scatter(t, axis, dim=1).numpy()
        out[axis, "equal"] = mesh.reduce_scatter(
            rank_value(mesh.coords, (4, 3)), axis, dim=0,
            counts=[4 // w] * w).numpy() if 4 % w == 0 else None
        counts = [1 + (r == 0) * (w - 1) for r in range(w)]
        out[axis, "ragged"] = mesh.reduce_scatter(
            rank_value(mesh.coords, (sum(counts), 2)), axis, dim=0,
            counts=counts).numpy()
        x = rank_value(mesh.coords, (2, 3)).requires_grad_()
        y = parallel.all_gather(mesh, x, axis, dim=1)
        weight = torch.arange(float(y.numel())).reshape(y.shape)
        (y * weight).sum().backward()
        out[axis, "adjoint"] = x.grad.numpy()
    return out


TREES = ("grads", "moments", "weights")


def _digested(out: dict, keep: bool) -> dict:
    """A training case's outputs with ``digest``, the SHA-1 of every leaf
    of its gathered trees (in path order); the trees themselves only where
    ``keep`` (the first rank: every rank's gathered trees are to be the
    same bits, so the others send their digest alone)."""
    h = hashlib.sha1()

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                h.update(k.encode())
                walk(node[k])
        else:
            h.update(np.ascontiguousarray(node).tobytes())
    for k in TREES:
        walk(out[k])
    out["digest"] = h.hexdigest()
    return out if keep else {k: v for k, v in out.items() if k not in TREES}

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
"""
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


def rank_main(plan):
    """``plan`` {model-axis size: [case names]} -> {model-axis size: (this
    rank's coords, {case name: its outputs})}."""
    cases = {name: make_case(name)
             for name in dict.fromkeys(n for names in plan.values()
                                       for n in names)}
    out = {}
    for n_model, names in plan.items():
        mesh = make_host_mesh(model=n_model, device="cpu")
        out[n_model] = (dict(mesh.coords),
                        {name: serve_case(cases[name], mesh)
                         for name in names})
    return out

"""The substrate across ranks on the reference's ``("data", "model")``
mesh, on the CPU: every architecture served on four gloo ranks at
meshes 1 x 4 and 2 x 2, and one of each recurrent or encoder-decoder
family on the data axis alone at 4 x 1, held to the reference's
unsharded ``apply`` and ``decode_step`` and to the port's unsharded
run.

The cases (reduced fp32 configs; weights drawn from a seed in the
reference's layout, ``convert.params_to_numpy`` of a port model drawn
from a generator -- the reference's own ``init`` takes a second a config
eagerly -- with the constant leaves and the untied table redrawn, as
``tests/test_torch_dense_archs.py`` redraws them, then carried into both
packages):

* yi-34b, head-parallel; and with 6 heads over 2 KV heads of 32, which
  the model axis of 4 does not divide: context-parallel at 1 x 4 over
  S = 30, blocks of 8, 8, 8 and 6 (head-parallel at 2 x 2);
* qwen3-8b (q/k norm); with 12 heads over 3 KV heads, whose rank blocks
  straddle two KV groups (K/V expanded);
* qwen1.5-110b (QKV bias, 2 KV heads); stablelm-1.6b (LayerNorm, a tied
  table), and with a vocab of 510, which 4 does not divide: the tables
  split by d_model at 1 x 4, by vocab at 2 x 2;
* paligemma-3b (MQA: ``wk``/``wv`` whole, the prefix through
  ``prefill_prefix``); qwen3-8b-sw4k at a window of 8 (the ring of 8
  slots split over the ranks, wrapping during the decode);
* grok-1-314b (expert-parallel: 4 experts); with 6 experts at a capacity
  factor of 0.5, which 4 does not divide: ``moe_d_ff`` split at 1 x 4,
  expert-parallel at 2 x 2, pairs dropped;
* llama4-maverick (chunked layers at a chunk of 8 and a NoPE global one,
  dense and MoE FFNs);
* recurrentgemma-9b (RG-LRU on the rank's channels, the conv's output
  gathered, one recurrence a rank, and local attention on its ring);
  xlstm-125m (the mLSTM on its heads and channels, the sLSTM with one
  gate of ``w_gates`` a rank at 1 x 4); and with 2 heads, which 4 does
  not divide: at 1 x 4 ``wq`` whole, ``r_gates`` split on dh (gathered
  once a call) and every rank running the whole cells;
* whisper-large-v3 (the encoder-decoder, head-parallel, the frames
  through ``prefill_cross`` into the ranks' blocks of the cross cache);
  and with 6 heads of 32: context-parallel self-attention at 1 x 4 (the
  encoder and the cross-attention whole on every rank), head-parallel at
  2 x 2; and with 6 heads of 30 and a cache of 26 slots, which 4 divides
  in neither slots, dh nor heads: the self cache whole on every rank at
  1 x 4 (its decode the unsharded attention), split at 2 x 2;
* at 4 x 1, one row of the batch a rank: recurrentgemma, xlstm and
  whisper on the data axis alone.

Each case: the full logits (B = 4, S = 30) and the MoE aux, the prefill
step's last logits, a prompt of 4 decoded token by token (each step's
logits; a VLM's from index P after its prefix), then 8 greedy tokens from
``make_serve_step``, and the cache after them gathered over the ranks;
every rank's, against the reference's at the
substrate's tolerances (atol 2e-4, rtol 1e-3; tokens exact) and against
the port's unsharded run at atol 1e-5; each MoE layer's routing (experts,
slots, kept pairs, so the dropped pairs) exactly as the unsharded
port's, the gates at 1e-5 (which ``tests/test_torch_moe_archs.py`` holds to the
reference's).  The weights gathered back by ``convert.params_to_numpy``
are the weights given, and each parameter's local shape is the rules'
block.  A mesh of one runs today's unsharded path bit for bit.  On
stand-in meshes of 2, 3 and 4 model ranks (meta tensors), the full-size
recurrentgemma-9b, xlstm-125m and whisper-large-v3 hold the rules'
blocks and their caches ``cache_spec``'s placement but for the departures
ROADMAP lists (the recurrent states held as the mixer holds them).

Training on the same spawn (``TRAIN_PLAN``): every architecture at 2 x 2
(yi-34b also on a batch of 3 rows, which the data axis does not divide,
and with remat on; stablelm with ``grad_accum=2``), each family at 1 x 4
(yi-cp context-parallel, xlstm-h2's ``r_gates`` on dh, grok-e6's
``moe_d_ff`` split) and at 4 x 1, each with the training placement
(``spec_for_param(..., fsdp=True)``: the MQA ``wk``/``wv`` FSDP on dh,
the tables and ``r_gates`` whole over ``data``).  Each holds: every
rank's losses bit-equal and its gathered trees the first rank's bits;
the loss within rtol 1e-5 of ``jax.value_and_grad`` of the reference's
``model_loss`` and of the unsharded port's; every gradient leaf,
gathered, within 1e-4 of its largest + 1e-6 of the reference's (PR
26's bound) and within 1e-5 of its largest + 1e-8 of the unsharded
port's (the floor covers the leaves whose gradient vanishes
analytically -- the key biases, the mLSTM's input-gate bias -- and is
rounding noise of ~1e-9); three steps of ``make_train_step`` (lr 1e-2):
each step's loss within rtol 1e-4 (the first's 1e-5), the weights after
the third within the Adam-sign bound (max |Δ| ≤ 2.5e-2 a step, a leaf's
mean < 2e-3) of the reference's ``train_step`` -- as its lines compose
it for ``grad_accum=1``: ``value_and_grad(model_loss)``,
``clip_by_global_norm``, ``adamw``'s ``update``, one program a case
compiled at XLA's lowest backend level -- and of the unsharded port's;
the gathered ``m`` and ``v`` after one step within 1e-5 of their
largest (+ 1e-9 and 1e-15, the gradient's floor carried into them) of
the unsharded port's (bfloat16 moments, grok's and llama4's, each
element within 2^-7 of itself -- one rounding -- and 1e-5 of the leaf's
largest); each rank's parameters' and moments' local shapes the rules'
blocks.  ``PORT_ONLY``'s cases are held to the unsharded port alone.
Remat on is bit-equal to remat off; ``grad_accum=2`` holds to the
reference's step.  ``Mesh2D.reduce_scatter`` and a gather's adjoint are
held on each axis.  On stand-in meshes (meta tensors) each family at
3 x 1 -- where FSDP falls through to whole -- and the full-size
qwen3-8b (2 x 2, 4 x 1, 3 x 1), recurrentgemma-9b (2 x 2) and
grok-1-314b (1 x 4) hold the rules' blocks of every parameter and
moment and the state's bytes a rank that PERF.md states.

The ranks run ``tests/_torch_model_parallel_ranks.py``'s ``rank_main``,
spawned once for the module in a thread while the reference's serving
programs (each jitted once) run here; the reference's and the unsharded
port's training runs are shared out among the ranks.
"""
import json
import os
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro_torch import convert
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.core.mesh import spawn
from repro_torch.launch import steps
from repro_torch.launch.mesh import block, make_host_mesh
from repro_torch.models import build_model, moe, parallel
from repro_torch.sharding import cache_spec, model_dim, spec_for_param
from _torch_model_parallel_ranks import (B, CASES, CLI_RUNS, DATA_CASES, LR,
                                        PROMPT, S, STEPS, TRAIN_CASES,
                                        cli_runs, make_case,
                                        make_train_case, rank_main,
                                        rank_value, serve_case)
from _torch_threads import one_torch_thread  # noqa: F401

MODEL_TOL = dict(atol=2e-4, rtol=1e-3)
PORT_TOL = dict(atol=1e-5, rtol=0)
RANKS = 4
LAYOUTS = (4, 2)                  # model-axis sizes: meshes 1 x 4, 2 x 2
IDS = list(CASES)
DATA_IDS = list(DATA_CASES)       # at model-axis size 1: mesh 4 x 1
PLAN = {**{m: IDS for m in LAYOUTS}, 1: DATA_IDS}
PAIRS = [(c, m) for c in IDS for m in LAYOUTS]
SERVED = PAIRS + [(c, 1) for c in DATA_IDS]
SERVED_IDS = [f"{c}-{RANKS // m}x{m}" for c, m in SERVED]
# trained: {model-axis size: training cases}
TRAIN_PLAN = {
    2: ["yi", "qwen3", "qwen1.5", "stablelm-v510", "paligemma", "sw4k",
        "grok", "grok-e6", "llama4", "recurrentgemma", "xlstm", "whisper",
        "stablelm-accum", "yi-remat", "yi-odd"],
    4: ["yi-cp", "paligemma", "grok-e6", "recurrentgemma", "xlstm-h2",
        "whisper"],
    1: ["paligemma", "grok", "recurrentgemma", "xlstm", "whisper", "yi-odd"],
}
TRAINED = [(c, m) for m, names in TRAIN_PLAN.items() for c in names]
TRAINED_IDS = [f"{c}-{RANKS // m}x{m}" for c, m in TRAINED]
# a trained case's reference run: its serving case and its batch's rows
# (remat and grad_accum change no function of the reference's step)
TRAIN_KEYS = {c: (TRAIN_CASES[c][0], TRAIN_CASES[c][2])
              for c, _ in TRAINED}
# the cases held to the unsharded port alone (whose forward is held to the
# reference in tests/test_torch_dense_archs.py and test_torch_moe_archs.py,
# its gradients and steps in test_torch_train.py and _train_step.py): the
# architectures trained at 2 x 2 beside those held to the reference, and
# yi's batch of 3 rows (a function of the batch alone, not of the split)
PORT_ONLY = ("qwen3", "qwen1.5", "sw4k", "llama4", "yi-odd")
# the reference's training runs (one a key, by its first case's name),
# computed on the ranks beside their own work, as are the unsharded
# port's training runs
REF_NAMES = []
for _name, _key in TRAIN_KEYS.items():
    if _name not in PORT_ONLY and _key not in [TRAIN_KEYS[n]
                                               for n in REF_NAMES]:
        REF_NAMES.append(_name)
STEP_ATOL, STEP_MEAN = 2.5e-2, 2e-3
# the gradient's floor (1e-8) carried into each moment after a step: m by
# 1 - b1, v by (1 - b2)·g² at the noise's own size
MOMENT_FLOOR = {"m": 1e-9, "v": 1e-15}


def _case(name):
    """``make_case`` and the reference's model of its config."""
    case = make_case(name)
    arch, kw = CASES[name]
    case["jmodel"] = jbuild_model(jget_config(arch).reduced().replace(**kw))
    return case


def _for_ranks(case):
    return {k: case[k] for k in ("cfg", "params", "tokens", "extra",
                                 "prompt_len", "steps", "cache_len")}


def _reference(case):
    """The reference's outputs of one case: its ``apply`` (jitted once)
    and its ``decode_step`` (jitted once) over the prompt and the greedy
    steps."""
    jmodel, cfg = case["jmodel"], case["cfg"]
    params = jax.tree.map(jnp.asarray, case["params"])
    toks = jnp.asarray(case["tokens"], jnp.int32)
    extra = None if case["extra"] is None else jnp.asarray(case["extra"])
    logits, aux = jax.jit(lambda p, t, e: jmodel.apply(
        p, t, extra_embeddings=e))(params, toks, extra)
    cache = jmodel.init_cache(B, case["cache_len"])
    start = 0
    if cfg.encoder_layers:
        cache = jax.jit(jmodel.prefill_cross)(params, cache, extra)
    elif extra is not None:
        cache = jax.jit(jmodel.prefill_prefix)(params, cache, extra)
        start = cfg.prefix_tokens
    dec = jax.jit(lambda p, t, c, i: jmodel.decode_step(
        p, t, c, i, prefix_len=cfg.prefix_tokens))
    steps = []
    for i in range(PROMPT):
        lg, cache = dec(params, toks[:, i:i + 1], cache,
                        jnp.asarray(start + i, jnp.int32))
        steps.append(np.asarray(lg[:, 0], np.float32))
    tok, greedy = toks[:, PROMPT - 1:PROMPT], []
    for i in range(STEPS):
        lg, cache = dec(params, tok, cache,
                        jnp.asarray(start + PROMPT + i, jnp.int32))
        tok = jnp.argmax(lg[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        greedy.append(np.asarray(tok[:, 0]))
    logits = np.asarray(logits, np.float32)
    return dict(logits=logits, aux=float(aux), last=logits[:, -1],
                decode=np.stack(steps, 1), greedy=np.stack(greedy, 1),
                cache=jax.tree.map(lambda a: np.asarray(a, np.float32),
                                   cache))


@pytest.fixture(scope="module", autouse=True)
def _ranks_started(tmp_path_factory):
    """The cases, the ranks spawned in a thread, and meanwhile the
    reference's and the unsharded port's runs here."""
    cases = {name: _case(name) for name in IDS}
    box = {}
    cli_dir = str(tmp_path_factory.mktemp("cli"))

    def run():
        try:
            box["results"] = spawn(
                rank_main, RANKS, backend="gloo", device="cpu",
                args=(PLAN, TRAIN_PLAN, REF_NAMES, list(TRAIN_KEYS),
                      cli_dir),
                timeout_s=600)
        except BaseException as exc:  # noqa: BLE001 -- re-raised below
            box["error"] = exc

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    trained = {name: make_train_case(name, cases[TRAIN_CASES[name][0]])
               for name in TRAIN_KEYS}
    refs = {name: _reference(case) for name, case in cases.items()}
    ports = {}
    for name, case in cases.items():
        ports[name] = serve_case(_for_ranks(case), None)
        ports[name]["routes"] = (_unsharded_routes(case)
                                 if case["cfg"].moe_experts else [])
    yield dict(thread=thread, box=box, cases=cases, refs=refs, ports=ports,
               trained=trained, cli_dir=cli_dir)
    thread.join()


def _unsharded_routes(case):
    """Each MoE layer's ``moe.route`` of the unsharded port's forward."""
    model = convert.params_from_numpy(case["params"], case["cfg"], "cpu")
    calls = []
    for blk in model.blocks:
        if blk.ffn_kind == "moe":
            blk.moe.register_forward_hook(lambda m, args, out: calls.append(
                moe.route(m.router, args[0], args[1])))
    extra = None if case["extra"] is None else torch.from_numpy(case["extra"])
    with torch.no_grad():
        model.apply(torch.from_numpy(case["tokens"]), extra)
    return [(r.idx.numpy(), r.pos.numpy(), r.keep.numpy(), r.gate.numpy())
            for r in calls]


@pytest.fixture(scope="module")
def runs(_ranks_started):
    """The fixture's context once the ranks are done, with the training
    runs they made of the reference (``train_refs``, by key) and of the
    unsharded port (``train_ports``)."""
    ctx = _ranks_started
    ctx["thread"].join()
    if "error" in ctx["box"]:
        raise ctx["box"]["error"]
    if "train_refs" not in ctx:
        ctx["train_refs"], ctx["train_ports"] = {}, {}
        for res in ctx["box"]["results"]:
            ctx["train_refs"].update({TRAIN_KEYS[n]: r
                                      for n, r in res["refs"].items()})
            ctx["train_ports"].update(res["ports"])
    return ctx


def _rank_outputs(runs, name, n_model):
    return [(res[n_model][0], res[n_model][1][name])
            for res in runs["box"]["results"]]


def _rank_trained(runs, name, n_model):
    return [(res[n_model][0], res[n_model][2][name])
            for res in runs["box"]["results"]]


# -- against the reference and the unsharded port -----------------------------

@pytest.mark.parametrize("name,n_model", SERVED, ids=SERVED_IDS)
def test_sharded_prefill_matches_reference(runs, name, n_model):
    """Full logits, the prefill step's last logits and the aux on every
    rank, against the reference's and the unsharded port's."""
    want, port = runs["refs"][name], runs["ports"][name]
    for coords, got in _rank_outputs(runs, name, n_model):
        msg = f"{name} at model={n_model}, rank {coords}"
        for key in ("logits", "last"):
            np.testing.assert_allclose(got[key], want[key], err_msg=msg,
                                       **MODEL_TOL)
            np.testing.assert_allclose(got[key], port[key], err_msg=msg,
                                       **PORT_TOL)
        np.testing.assert_allclose(got["aux"], want["aux"], err_msg=msg,
                                   **MODEL_TOL)
        np.testing.assert_allclose(got["aux"], port["aux"], err_msg=msg,
                                   **PORT_TOL)


@pytest.mark.parametrize("name,n_model", SERVED, ids=SERVED_IDS)
def test_sharded_decode_matches_reference(runs, name, n_model):
    """The prompt's step logits against the reference's ``decode_step``
    and the unsharded port's; the greedy tokens exact against both."""
    want, port = runs["refs"][name], runs["ports"][name]
    for coords, got in _rank_outputs(runs, name, n_model):
        msg = f"{name} at model={n_model}, rank {coords}"
        np.testing.assert_allclose(got["decode"], want["decode"],
                                   err_msg=msg, **MODEL_TOL)
        np.testing.assert_allclose(got["decode"], port["decode"],
                                   err_msg=msg, **PORT_TOL)
        np.testing.assert_array_equal(got["greedy"], want["greedy"], msg)
        np.testing.assert_array_equal(got["greedy"], port["greedy"], msg)


def _close_tree(got, want, msg, tol):
    if isinstance(want, dict):
        assert set(got) == set(want), msg
        for k in want:
            _close_tree(got[k], want[k], f"{msg}/{k}", tol)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), msg
        for i, (g, w) in enumerate(zip(got, want)):
            _close_tree(g, w, f"{msg}/{i}", tol)
    else:
        np.testing.assert_allclose(got, want, err_msg=msg, **tol)


@pytest.mark.parametrize("name,n_model", SERVED, ids=SERVED_IDS)
def test_sharded_cache_matches_reference(runs, name, n_model):
    """The decode cache after the prompt and the greedy steps, gathered
    over the ranks (``convert.cache_to_numpy``), leaf for leaf against the
    reference's and the unsharded port's."""
    want, port = runs["refs"][name], runs["ports"][name]
    for coords, got in _rank_outputs(runs, name, n_model):
        msg = f"{name} at model={n_model}, rank {coords}"
        _close_tree(got["cache"], want["cache"], msg, MODEL_TOL)
        _close_tree(got["cache"], port["cache"], msg, PORT_TOL)


MOE_PAIRS = [(c, m) for c, m in PAIRS if CASES[c][0] in (
    "grok-1-314b", "llama4-maverick-400b-a17b")]


@pytest.mark.parametrize("name,n_model", MOE_PAIRS,
                         ids=[f"{c}-{RANKS // m}x{m}" for c, m in MOE_PAIRS])
def test_routing_and_dropped_pairs_exact(runs, name, n_model):
    port = runs["ports"][name]["routes"]
    assert port
    for coords, got in _rank_outputs(runs, name, n_model):
        assert len(got["routes"]) == len(port)
        for layer, (g, w) in enumerate(zip(got["routes"], port)):
            msg = f"{name} model={n_model} {coords} layer {layer}"
            for a, b, what in zip(g[:3], w[:3], ("idx", "pos", "keep")):
                np.testing.assert_array_equal(a, b, f"{msg} {what}")
            np.testing.assert_allclose(g[3], w[3], err_msg=f"{msg} gate",
                                       **PORT_TOL)
    if name == "grok-e6":
        assert sum(int((~r[2]).sum()) for r in port) > 0


# -- training on the mesh -----------------------------------------------------

def _leaves(tree, path=""):
    """{path: array} of a nested dict (the reference's layout)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}/{k}"))
        return out
    return {path: np.asarray(tree, np.float32)}


def _close_leaves(got, want, rel, floor, msg):
    """Each leaf within ``rel`` of its largest |want| + ``floor``."""
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want), msg
    for k, w in want.items():
        gap = float(np.abs(got[k] - w).max())
        bound = rel * float(np.abs(w).max()) + floor
        assert gap <= bound, f"{msg} {k}: {gap:.3e} > {bound:.3e}"


def _train_outputs(runs, name, n_model):
    """The reference's run of a trained case (None where only the unsharded
    port holds it), the unsharded port's, the first rank's outputs, and
    every rank's: each rank's gathered trees are the first rank's bits
    (their digests alike)."""
    want = runs["train_refs"].get(TRAIN_KEYS[name])
    ranks = _rank_trained(runs, name, n_model)
    assert len({got["digest"] for _, got in ranks}) == 1, name
    return want, runs["train_ports"][name], ranks[0][1], ranks


@pytest.mark.parametrize("name,n_model", TRAINED, ids=TRAINED_IDS)
def test_sharded_loss_and_grads_match_reference(runs, name, n_model):
    """The loss (bit-equal on every rank) and every gradient leaf, gathered
    over the ranks, against ``jax.value_and_grad`` of the reference's
    ``model_loss`` and the unsharded port's ``loss_and_grads``."""
    want, port, got, ranks = _train_outputs(runs, name, n_model)
    assert len({r["loss"] for _, r in ranks}) == 1, name
    msg = f"{name} at model={n_model}"
    if want is not None:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5,
                                   err_msg=msg)
        _close_leaves(got["grads"], want["grads"], 1e-4, 1e-6, msg)
    np.testing.assert_allclose(got["loss"], port["loss"], rtol=1e-5,
                               err_msg=msg)
    _close_leaves(got["grads"], port["grads"], 1e-5, 1e-8, msg)


@pytest.mark.parametrize("name,n_model", TRAINED, ids=TRAINED_IDS)
def test_sharded_train_steps_match_reference(runs, name, n_model):
    """Three steps of ``make_train_step``: each step's loss (bit-equal on
    every rank) against the reference's and the unsharded port's; the
    weights after the third within the Adam-sign bound of the reference's
    (three steps' worth) and of the unsharded port's; the Adam moments
    after the first step against the unsharded port's."""
    want, port, got, ranks = _train_outputs(runs, name, n_model)
    for i in range(len(port["losses"])):
        assert len({r["losses"][i] for _, r in ranks}) == 1, (name, i)
    msg = f"{name} at model={n_model}"
    for other in (want, port):
        if other is None:
            continue
        # the first step's loss is the loss of the same weights; after
        # it Adam's sign flips (2·lr an element) move later ones apart
        np.testing.assert_allclose(got["losses"][0], other["losses"][0],
                                   rtol=1e-5, err_msg=msg)
        np.testing.assert_allclose(got["losses"], other["losses"], rtol=1e-4,
                                   err_msg=msg)
        g, w = _leaves(got["weights"]), _leaves(other["weights"])
        for k in w:
            d = np.abs(g[k] - w[k])
            assert d.max() <= STEP_ATOL * len(port["losses"]), (msg, k)
            assert d.mean() < STEP_MEAN, (msg, k)
    bf16 = runs["trained"][name]["cfg"].opt_dtype_str == "bfloat16"
    for k in ("m", "v"):
        if bf16:
            # moments stored in bfloat16: a gradient ~1e-7 apart rounds an
            # ulp apart, so each element within 2^-7 of the larger side,
            # beside the gradient's own 1e-5 of the leaf's largest
            mine = _leaves(got["moments"][k])
            for p, w in _leaves(port["moments"][k]).items():
                g = mine[p]
                bound = 2.0 ** -7 * np.maximum(np.abs(w), np.abs(g)) \
                    + 1e-5 * np.abs(w).max()
                assert (np.abs(g - w) <= bound).all(), (msg, k, p)
        else:
            _close_leaves(got["moments"][k], port["moments"][k], 1e-5,
                          MOMENT_FLOOR[k], f"{msg} {k}")


def _checkpoint(directory, step):
    """The weights and the Adam moments the train CLI wrote at ``step``
    under ``directory``: {"": weights, "adam": {"m", "v"}} as numpy
    trees."""
    cfg = get_config("stablelm-1.6b").reduced()
    like = convert.params_to_tree(build_model(cfg, device="cpu"))
    out = {}
    for sub, tmpl in (("", like), ("adam", {"m": like, "v": like})):
        tree, got, _ = store.load_checkpoint(os.path.join(directory, sub),
                                             tmpl, step=step)
        assert got == step
        out[sub] = convert.host_tree(tree)
    return out


def test_train_cli_checkpoints_on_a_mesh(runs, tmp_path):
    """``launch.train --mesh 2x2`` on the four ranks: every rank prints the
    same losses; rank 0's checkpoints (weights and both Adam moments
    gathered) are the unsharded CLI's files -- the same leaves, shapes and
    dtypes, after one step the weights within the Adam-sign bound and the
    moments at the gradients' 1e-5, after two the weights within two
    steps' bound --; and a third step resumed from two on the mesh writes
    the checkpoint of three uninterrupted steps on it, bit for bit."""
    lines = [res["cli"] for res in runs["box"]["results"]]

    def losses(out, name):
        return [line.split("] ", 1)[1].split("(")[0] for line in out[name]
                if "] step" in line]
    for name, _ in CLI_RUNS:
        seen = {tuple(losses(out, name)) for out in lines}
        assert len(seen) == 1 and len(next(iter(seen))) > 0, (name, seen)
    mesh_dir = runs["cli_dir"]
    for sub in ("", "adam"):
        for step in (1, 2):
            assert os.path.exists(os.path.join(
                mesh_dir, "first", sub, f"step_{step}.json"))
    again = _checkpoint(os.path.join(mesh_dir, "again"), 3)
    whole = _checkpoint(os.path.join(mesh_dir, "whole"), 3)
    for sub in again:
        a, w = _leaves(again[sub]), _leaves(whole[sub])
        assert set(a) == set(w)
        for k in w:
            np.testing.assert_array_equal(a[k], w[k], err_msg=f"{sub}{k}")
    here = str(tmp_path)
    cli_runs(here, None)
    for step in (1, 2):
        got = _checkpoint(os.path.join(mesh_dir, "first"), step)
        want = _checkpoint(os.path.join(here, "first"), step)
        for sub in ("", "adam"):
            for ext in ("json",):
                with open(os.path.join(mesh_dir, "first", sub,
                                       f"step_{step}.{ext}")) as f, \
                        open(os.path.join(here, "first", sub,
                                          f"step_{step}.{ext}")) as g:
                    assert json.load(f) == json.load(g), (sub, step)
        g, w = _leaves(got[""]), _leaves(want[""])
        for k in w:
            d = np.abs(g[k] - w[k])
            assert d.max() <= STEP_ATOL * step, (step, k)
            assert d.mean() < STEP_MEAN, (step, k)
        if step == 1:
            for k in ("m", "v"):
                _close_leaves(got["adam"][k], want["adam"][k], 1e-5,
                              MOMENT_FLOOR[k], f"cli {k}")


def _train_mesh(n_data, n_model, rank=0):
    return SimpleNamespace(axis_names=("data", "model"),
                           size=n_data * n_model,
                           shape={"data": n_data, "model": n_model},
                           coords={"data": rank // n_model,
                                   "model": rank % n_model})


def _rules_blocks(full, mesh):
    """{name: the local shape} of ``spec_for_param(..., fsdp=True)``'s
    block of each parameter of whole shape ``full[name]``, and the count
    split over ``data``."""
    out, n_data = {}, 0
    for pname, shape in full.items():
        spec = _spec(pname, shape, mesh)
        local = list(shape)
        for i, entry in enumerate(spec):
            if entry is not None:
                local[i] //= mesh.shape[entry]
        n_data += "data" in spec
        out[pname] = tuple(local)
    return out, n_data


def _spec(pname, shape, mesh):
    """``spec_for_param(..., fsdp=True)`` of a parameter, an axis of one
    rank read as whole (it splits nothing)."""
    spec = spec_for_param(pname.rsplit(".", 1)[-1], shape, mesh, fsdp=True)
    return tuple(e if e is None or mesh.shape[e] > 1 else None for e in spec)


@pytest.mark.parametrize("n_model", sorted(TRAIN_PLAN))
def test_training_ranks_hold_the_fsdp_blocks(runs, n_model):
    """Each rank's parameters and both Adam moments are exactly
    ``spec_for_param(..., fsdp=True)``'s blocks on the mesh; some leaf is
    split over ``data`` wherever the data axis has ranks; remat on trains
    bit for bit as remat off."""
    mesh = _train_mesh(RANKS // n_model, n_model)
    for res in runs["box"]["results"]:
        coords, _, outs = res[n_model][:3]
        for name, out in outs.items():
            full = {n: tuple(s) for n, s in
                    runs["train_ports"][name]["shapes"].items()}
            want, n_data = _rules_blocks(full, mesh)
            assert out["shapes"] == want, (name, coords)
            assert out["moment_shapes"] == {"m": want, "v": want}, name
            assert n_data > 0 or mesh.shape["data"] == 1, name
        if "yi-remat" in outs:
            on, off = outs["yi-remat"], outs["yi"]
            assert on["loss"] == off["loss"] and on["losses"] == off["losses"]
            assert on["digest"] == off["digest"]


def test_train_step_on_a_mesh_of_one_is_unsharded(runs):
    """``make_train_step(mesh=make_host_mesh())`` without a process group
    (a mesh of one) trains today's unsharded model bit for bit."""
    mesh = make_host_mesh(device="cpu")
    case = runs["trained"]["grok"]
    outs = []
    for m in (mesh, None):
        model = convert.params_from_numpy(case["params"], case["cfg"], "cpu")
        step_fn, model, opt = steps.make_train_step(case["cfg"], lr=LR,
                                                    model=model, mesh=m)
        assert model.mesh is None
        state, count, losses = opt.init(dict(model.named_parameters())), 0, []
        for b in case["batches"]:
            state, count, met = step_fn(
                state, count, {k: torch.from_numpy(v) for k, v in b.items()})
            losses.append(float(met["loss"]))
        outs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
    assert outs[0][0] == outs[1][0]
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_model", sorted(TRAIN_PLAN))
def test_reduce_scatter_and_the_gathers_adjoint(runs, n_model):
    """``Mesh2D.reduce_scatter`` on each axis (gloo: the sum whole, then
    the rank's block): ``block``'s sizes by default (ragged where the axis
    does not divide the dim), equal and ragged counts given; and the
    backward of ``parallel.all_gather``: the sum over the axis's ranks of
    the output's gradient, this rank's block (a reduce-scatter)."""
    size = {"data": RANKS // n_model, "model": n_model}
    results = [res[n_model][0:4:3] for res in runs["box"]["results"]]
    for coords, got in results:
        for axis in ("data", "model"):
            w = size[axis]
            peers = [c for c, _ in results
                     if all(c[a] == coords[a] for a in c if a != axis)]
            assert len(peers) == w

            def total(shape):
                return sum(rank_value(c, shape) for c in peers).numpy()
            r = coords[axis]
            lo, hi = block(7, w, r)
            np.testing.assert_array_equal(got[axis, "block"],
                                          total((2, 7))[:, lo:hi])
            if 4 % w == 0:
                np.testing.assert_array_equal(
                    got[axis, "equal"],
                    total((4, 3))[r * 4 // w:(r + 1) * 4 // w])
            counts = [1 + (q == 0) * (w - 1) for q in range(w)]
            lo = sum(counts[:r])
            np.testing.assert_array_equal(
                got[axis, "ragged"],
                total((sum(counts), 2))[lo:lo + counts[r]])
            weight = np.arange(6.0 * w).reshape(2, 3 * w)
            np.testing.assert_array_equal(got[axis, "adjoint"],
                                          w * weight[:, 3 * r:3 * r + 3])


FAMILIES = ("yi", "paligemma", "grok", "recurrentgemma", "xlstm", "whisper")


@pytest.mark.parametrize("name", FAMILIES)
def test_three_by_one_falls_through_to_whole(name):
    """At 3 x 1 (stand-in, meta tensors) 3 divides no FSDP dim of the
    reduced configs: ``make_train_step`` builds every weight and both
    moments whole, as the rules place them."""
    cfg = make_case(name)["cfg"]
    full = {n: tuple(p.shape) for n, p in
            build_model(cfg, device="meta").named_parameters()}
    mesh = _train_mesh(3, 1, rank=2)
    _, model, opt = steps.make_train_step(cfg, device="meta", mesh=mesh)
    want, n_data = _rules_blocks(full, mesh)
    assert n_data == 0 and want == full
    state = opt.init(dict(model.named_parameters()))
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == full
    assert {n: tuple(t.shape) for n, t in state["m"].items()} == full
    assert all(p.data_split is None for p in model.parameters())


# the state's bytes a rank (weights, gradients and both Adam moments: 4
# copies of each rank's blocks in the configs' dtypes) on stand-in meshes,
# as PERF.md states them: (arch, layers or None for the config's, data,
# model) -> bytes
FULL_STATE = {
    ("qwen3-8b", None, 2, 2): 37_745_278_976,
    ("qwen3-8b", None, 4, 1): 47_702_556_672,
    ("qwen3-8b", None, 3, 1): 131_051_765_760,
    ("recurrentgemma-9b", None, 2, 2): 41_891_201_024,
    ("grok-1-314b", 4, 1, 4): 42_583_375_872,
}


@pytest.mark.parametrize("arch,layers,n_data,n_model", list(FULL_STATE),
                         ids=[f"{a}-{d}x{m}" for a, _, d, m in FULL_STATE])
def test_full_size_training_placement(arch, layers, n_data, n_model):
    """At full size on a stand-in mesh (meta tensors): each parameter's and
    each moment's local shape is ``spec_for_param(..., fsdp=True)``'s
    block, tagged with its model and data dims, and the state's bytes a
    rank are ``FULL_STATE``'s."""
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    full = {n: tuple(p.shape) for n, p in
            build_model(cfg, device="meta").named_parameters()}
    mesh = _train_mesh(n_data, n_model, rank=n_data * n_model - 1)
    _, model, opt = steps.make_train_step(cfg, device="meta", mesh=mesh)
    want, n_split = _rules_blocks(full, mesh)
    params = dict(model.named_parameters())
    state = opt.init(params)
    assert {n: tuple(p.shape) for n, p in params.items()} == want
    for k in ("m", "v"):
        assert {n: tuple(t.shape) for n, t in state[k].items()} == want
        assert all(t.dtype == cfg.opt_dtype for t in state[k].values())
    for pname, p in params.items():
        spec = _spec(pname, full[pname], mesh)
        assert (p.model_split, p.data_split) == tuple(
            next((i for i, e in enumerate(spec) if e == a), None)
            for a in ("model", "data")), pname
    assert (n_split > 0) == (arch != "grok-1-314b" and n_data in (2, 4))
    weights = sum(p.numel() * p.element_size() for p in params.values())
    moments = sum(t.numel() * t.element_size() for k in ("m", "v")
                  for t in state[k].values())
    assert 2 * weights + moments == FULL_STATE[(arch, layers, n_data,
                                                n_model)]


# -- placement -----------------------------------------------------------------

@pytest.mark.parametrize("n_model", LAYOUTS)
def test_ranks_hold_the_rules_blocks(runs, n_model):
    """Each parameter's local shape is its rule's block on the model axis;
    the weights gathered back are the weights given; the mesh's
    coordinates are row-major."""
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": RANKS // n_model, "model": n_model})
    for g, res in enumerate(runs["box"]["results"]):
        coords, outs = res[n_model][:2]
        assert coords == {"data": g // n_model, "model": g % n_model}
        for name, out in outs.items():
            assert out["round_trip"], name
            full = runs["ports"][name]["shapes"]
            split = 0
            for pname, shape in out["shapes"].items():
                leaf = pname.rsplit(".", 1)[-1]
                dim = model_dim(spec_for_param(leaf, full[pname], mesh,
                                               fsdp=False))
                want = list(full[pname])
                if dim is not None:
                    want[dim] //= n_model
                    split += 1
                assert shape == tuple(want), (name, pname)
            assert split > 0, name


def test_data_axis_holds_every_weight_whole(runs):
    """At 4 x 1 each rank serves its row of the batch with every weight
    whole: the recurrent mixers and the encoder-decoder on the data axis."""
    for g, res in enumerate(runs["box"]["results"]):
        coords, outs = res[1][:2]
        assert coords == {"data": g, "model": 0}
        assert set(outs) == set(DATA_IDS)
        for name, out in outs.items():
            assert out["round_trip"], name
            assert out["shapes"] == runs["ports"][name]["shapes"], name


def test_context_parallel_blocks_are_ragged():
    """yi-cp's 6 heads do not divide 4: its attention is context-parallel
    at 1 x 4 over S = 30 in blocks of 8, 8, 8 and 6, head-parallel at 2 x 2;
    yi's 4 heads divide both."""
    cfg = get_config("yi-34b").reduced().replace(**CASES["yi-cp"][1])
    assert cfg.attn_seq_shard and cfg.n_heads % 4 and not cfg.n_heads % 2
    assert [block(S, 4, r) for r in range(4)] == [(0, 8), (8, 16), (16, 24),
                                                  (24, 30)]
    for w, seq in ((4, True), (2, False)):
        mesh = SimpleNamespace(axis_names=("data", "model"), size=4,
                               shape={"data": 4 // w, "model": w},
                               coords={"data": 0, "model": 1})
        attn = build_model(cfg, device="meta", mesh=mesh).blocks[0].attn
        assert (attn.seq_parallel, attn.head_parallel) == (seq, not seq)
    straddle = get_config("qwen3-8b").reduced().replace(
        **CASES["qwen3-straddle"][1])
    mesh = SimpleNamespace(axis_names=("data", "model"), size=4,
                           shape={"data": 1, "model": 4},
                           coords={"data": 0, "model": 1})
    attn = build_model(straddle, device="meta", mesh=mesh).blocks[0].attn
    assert attn.heads == (3, 6) and attn.kv_heads == (0, 2)
    assert attn.kv_expand == [0, 1, 1]


def test_whole_cache_fall_through():
    """whisper-whole at 1 x 4: 26 slots, dh 30 and 6 heads, none of which
    4 divides, so ``cache_spec`` leaves the self cache whole and every
    rank holds it (tag None); its 16 frames split (4 a rank); at 2 x 2
    both split.  ``cache_spec`` agrees on each leaf."""
    name = "whisper-whole"
    cfg = get_config(CASES[name][0]).reduced().replace(**CASES[name][1])
    for w, slots in ((4, 26), (2, 13)):
        mesh = _stand_in(w)
        cache = build_model(cfg, device="meta", mesh=mesh).init_cache(
            B, 26)["decoder"]
        assert cache["k"].shape[2] == slots
        assert cache["k"].model_split == (None if w == 4 else 2)
        assert cache["cross_k"].shape[2] == 16 // w
        assert cache["cross_k"].model_split == 2
        for leaf, n in (("k", 26), ("cross_k", 16)):
            shape = (cfg.n_layers, B, n, cfg.n_kv_heads, cfg.d_head)
            assert model_dim(cache_spec(shape, mesh, None)) == \
                cache[leaf].model_split


def test_mesh_of_one_is_the_unsharded_path(runs):
    """Without a process group ``make_host_mesh()`` is 1 x 1 and runs no
    collective; a model built on it computes today's unsharded outputs
    bit for bit."""
    mesh = make_host_mesh(device="cpu")
    assert (mesh.shape, mesh.coords, mesh.world) == (
        {"data": 1, "model": 1}, {"data": 0, "model": 0}, None)
    t = torch.arange(6.0).reshape(2, 3)
    assert mesh.all_gather(t, "model", dim=1) is t
    assert mesh.all_reduce(t, "data") is t and mesh.all_ok(True)
    assert not parallel.active(mesh)
    for name in ("grok", "paligemma"):
        case = runs["cases"][name]
        got = serve_case(_for_ranks(case), mesh)
        want = serve_case(_for_ranks(case), None)
        for key in ("logits", "last", "decode", "greedy"):
            np.testing.assert_array_equal(got[key], want[key], name)
        assert got["aux"] == want["aux"]
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_host_mesh(model=2, device="cpu")


def _stand_in(n_model, rank=1, n_data=1):
    return SimpleNamespace(axis_names=("data", "model"),
                           size=n_data * n_model,
                           shape={"data": n_data, "model": n_model},
                           coords={"data": 0, "model": rank})


@pytest.mark.parametrize("arch", ("recurrentgemma-9b", "xlstm-125m",
                                  "whisper-large-v3"))
def test_model_axis_refuses_unported_mixers(arch):
    """What the model axis still refuses, before any collective: a decode
    cache whose slots it does not divide where ``cache_spec`` would split
    its dh or its heads (only the whole fall-through is ported; ROADMAP
    A25).  ``rec``, ``mlstm``/``slstm`` and the encoder-decoder build on a
    model axis of 2 with some weight split, and ``make_train_step`` builds
    them on a 2 x 2 stand-in with the training placement (some weight
    split over ``data`` too; serving's placement splits none); the data
    axis alone builds them whole for serving."""
    cfg = get_config(arch).reduced()
    mesh = _stand_in(2, rank=0)
    model = build_model(cfg, device="meta", mesh=mesh)
    assert model.mesh is mesh
    assert any(getattr(p, "model_split", None) is not None
               for p in model.parameters())
    assert all(p.data_split is None for p in model.parameters())
    square = _stand_in(2, rank=1, n_data=2)
    _, trained, _ = steps.make_train_step(cfg, device="meta", mesh=square)
    assert parallel.fsdp_active(trained.mesh)
    assert not parallel.fsdp_active(square)
    # ``fsdp=False`` is serving's placement, whatever mesh it is given
    again = build_model(cfg, device="meta", mesh=trained.mesh)
    assert not parallel.fsdp_active(again.mesh)
    assert all(p.data_split is None for p in again.parameters())
    assert any(p.data_split is not None for p in trained.parameters())
    assert any(p.model_split is not None for p in trained.parameters())
    data = SimpleNamespace(axis_names=("data", "model"), size=2,
                           shape={"data": 2, "model": 1},
                           coords={"data": 1, "model": 0})
    model = build_model(cfg, device="meta", mesh=data)
    assert model.mesh is data
    assert all(getattr(p, "model_split", None) is None
               and p.data_split is None for p in model.parameters())
    yi = build_model(get_config("yi-34b").reduced(), device="meta",
                     mesh=mesh)
    _, yi_train, _ = steps.make_train_step(yi.cfg, device="meta",
                                           mesh=square)
    assert yi_train.blocks[0].attn.wq.data_split == 0
    with pytest.raises(ValueError, match="cache of 15 slots.*its dh"):
        yi.init_cache(2, 15)
    assert yi.init_cache(4, 16)["stage_0"]["0"]["k"].shape[1:3] == (4, 8)


# the cache leaves the mixer holds otherwise than cache_spec places them
# (ROADMAP "Accepted departures"): (mixer, leaf) -> {model-axis size:
# (cache_spec's dim, the mixer's dim or None for whole)}, dims of the
# stacked leaf (L, B, ...)
DEPARTURES = {
    # mLSTM n (L, B, heads, dh): cache_spec dh; the mixer its heads, or
    # all of them where the model axis does not divide the heads
    ("mlstm", "n"): {2: (3, 2), 3: (3, None), 4: (3, 2)},
    # mLSTM c (L, B, heads, dh, dv) at 3: cache_spec dv; the heads whole
    ("mlstm", "c"): {3: (4, None)},
    # RG-LRU conv (L, B, 3 taps, dr) at 3: cache_spec the taps; the layer
    # whole (3 does not divide 4096)
    ("rec", "conv"): {3: (2, None)},
    # sLSTM states (L, B, d) at 3: cache_spec the channels; r_gates splits
    # on dh, so every rank runs the whole recurrence
    **{("slstm", k): {3: (2, None)} for k in ("c", "n", "h", "m")},
}


@pytest.mark.parametrize("n_model", (2, 3, 4))
@pytest.mark.parametrize("arch", ("recurrentgemma-9b", "xlstm-125m",
                                  "whisper-large-v3"))
def test_full_size_blocks_and_cache_departures(arch, n_model):
    """At full size on a stand-in model axis of 2, 3 and 4 ranks (meta
    tensors, no process): each parameter's local shape is its rule's
    block (``spec_for_param(..., fsdp=False)``); each leaf of a 448-slot
    decode cache (whisper's 1500 frames too) is ``cache_spec``'s block
    but for ``DEPARTURES``.  At 3 the rules leave every ``rec`` weight,
    the mLSTM's heads and whisper's heads whole and split ``r_gates`` on
    dh; whisper's 448 slots stay whole (the fall-through), its frames
    split and its decoder's self-attention is context-parallel."""
    cfg = get_config(arch)
    mesh = _stand_in(n_model)
    model = build_model(cfg, device="meta", mesh=mesh)
    whole = build_model(cfg, device="meta")
    full = {n: tuple(p.shape) for n, p in whole.named_parameters()}
    split = {}
    for pname, p in model.named_parameters():
        leaf = pname.rsplit(".", 1)[-1]
        dim = model_dim(spec_for_param(leaf, full[pname], mesh, fsdp=False))
        want = list(full[pname])
        if dim is not None:
            want[dim] //= n_model
        assert tuple(p.shape) == tuple(want), pname
        assert p.model_split == dim, pname
        split[leaf] = split.get(leaf, False) or dim is not None
    cache, wcache = model.init_cache(2, 448), whole.init_cache(2, 448)
    if arch == "whisper-large-v3":
        # one layer-stacked cache: (kind, its leaves, the unsharded ones)
        layers = [("attn", cache["decoder"], wcache["decoder"])]
    else:
        layers = [(unit[int(pos)][0], leaves, wcache[stage][pos])
                  for (unit, _), (stage, sub) in zip(model.stages,
                                                     cache.items())
                  for pos, leaves in sub.items()]
    seen = set()
    for kind, leaves, wleaves in layers:
        for name, got in leaves.items():
            want = list(wleaves[name].shape)
            spec_dim = model_dim(cache_spec(want, mesh, None))
            dep = DEPARTURES.get((kind, name), {}).get(n_model)
            if dep is None:
                assert got.model_split == spec_dim, (kind, name)
            else:
                assert (spec_dim, got.model_split) == dep, (kind, name)
                seen.add((kind, name))
            if got.model_split is not None:
                want[got.model_split] //= n_model
            assert tuple(got.shape) == tuple(want), (kind, name)
    kinds = {"recurrentgemma-9b": ("rec",), "xlstm-125m": ("mlstm", "slstm"),
             "whisper-large-v3": ()}[arch]
    assert seen == {k for k, v in DEPARTURES.items()
                    if n_model in v and k[0] in kinds}
    if n_model == 3:
        if arch == "recurrentgemma-9b":
            rec = next(b.rec for b in model.blocks if b.kind == "rec")
            assert all(p.model_split is None for p in rec.parameters())
            assert split["w_in"]            # the MLP's, over d_ff
        if arch == "xlstm-125m":
            assert not split["wq"] and split["r_gates"]
            slstm = next(b.slstm for b in model.blocks if b.kind == "slstm")
            assert slstm.r_split == 3
        if arch == "whisper-large-v3":
            assert not split["wq"]
            assert cache["decoder"]["k"].model_split is None
            assert cache["decoder"]["cross_k"].shape[2] == 500
            assert model.decoder[0].self_attn.seq_parallel

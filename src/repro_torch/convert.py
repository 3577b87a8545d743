"""Carry reference state and weights into the port.

``state_from_numpy`` takes the reference's ``RoundState``/``RoundBundle``
leaves as plain numpy arrays -- the caller converts them with
``np.asarray`` and drops the PRNG key -- and builds the port's
``RoundState``/``RoundBundle`` on ``device``, so both sides can start from
the same params, gains, staleness, world (``scenario_from_numpy``) and
data; a reference buffered state mid-run carries its ``BufferState``
over too (``buffer_from_numpy``), a faulted one its ``FaultState``
(``faults_from_numpy``) and a warm-started one its ``warm`` seed.
``ddpg_from_numpy`` and ``actor_from_numpy`` carry a reference DDPG
agent (networks, targets, Adam moments, replay ring and counters) or a
bare actor, so both sides can train or deploy from the same networks.
``params_from_numpy`` does the same for a substrate model's weights (a
decoder or an encoder-decoder), ``cache_from_numpy`` for its decode
cache, so both sides can decode from the same state, and
``cache_to_numpy`` gathers a (sharded) decode cache back into the
reference's layout; given a
``launch.mesh.Mesh2D`` it builds this rank's blocks of the weights
(``sharding.rules``' placement; with ``fsdp=True`` the training one,
split over ``data`` too), and ``params_to_numpy`` gathers a sharded
model's back, as ``opt_state_to_numpy`` gathers its Adam moments.
``params_to_tree`` and ``params_to_numpy`` go the other way: a model's named tensors
(weights, gradients, Adam moments) in the reference's layout, so both
sides' gradients and optimizer states compare leaf for leaf, and a
checkpoint the port writes is one the reference reads.
"""
from __future__ import annotations

from typing import Any, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core.ddpg import DDPGState
from repro_torch.core.engine import BufferState, RoundBundle, RoundState
from repro_torch.device import resolve_device
from repro_torch.faults.spec import FaultState
from repro_torch.scenarios import ScenarioState
from repro_torch.models import build_model, parallel
from repro_torch.models.encdec import EncDecTransformer
from repro_torch.models.transformer import Transformer


def _fields(obj: Any) -> Mapping[str, Any]:
    return obj._asdict() if hasattr(obj, "_asdict") else dict(obj)


def state_from_numpy(state_np: Any, bundle_np: Any,
                     device: "str | torch.device" = "cuda"
                     ) -> Tuple[RoundState, RoundBundle]:
    """state_np: a mapping or named tuple with ``global_params`` and
    ``client_params`` (dicts of arrays), ``gains``, ``staleness``,
    ``round_idx`` and, optionally, ``scenario`` (a reference
    ``ScenarioState`` as numpy, or None: the state then carries none, and
    runs the static kind only) and ``buffer`` (a reference
    ``BufferState`` as numpy, or None), ``faults`` (a reference
    ``FaultState`` as numpy, or None) and ``warm`` (the (N,) assigned
    seed, or None); bundle_np: one with ``dist``, ``x``,
    ``y``, ``counts``, ``test_x`` and ``test_y``.  Every array is copied
    onto ``device``."""
    dev = resolve_device(device)
    s, b = _fields(state_np), _fields(bundle_np)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    def i32(a):
        return torch.tensor(np.asarray(a, np.int32), device=dev)

    state = RoundState(
        global_params={k: f32(v) for k, v in s["global_params"].items()},
        client_params={k: f32(v) for k, v in s["client_params"].items()},
        gains=f32(s["gains"]),
        staleness=i32(s["staleness"]),
        round_idx=int(np.asarray(s["round_idx"])),
        scenario=scenario_from_numpy(s.get("scenario"), dev),
        buffer=buffer_from_numpy(s.get("buffer"), dev),
        faults=faults_from_numpy(s.get("faults"), dev),
        warm=None if s.get("warm") is None else i32(s["warm"]))
    bundle = RoundBundle(dist=f32(b["dist"]), x=f32(b["x"]), y=i32(b["y"]),
                         counts=f32(b["counts"]), test_x=f32(b["test_x"]),
                         test_y=i32(b["test_y"]))
    return state, bundle


def scenario_from_numpy(scen_np: Any, device: "str | torch.device" = "cuda"
                        ) -> "ScenarioState | None":
    """A reference ``ScenarioState`` (numpy leaves, or a mapping of its 11
    fields) as the port's, every leaf float32 on ``device``; None stays
    None."""
    if scen_np is None:
        return None
    dev = resolve_device(device)
    f = _fields(scen_np)
    return ScenarioState(*(torch.tensor(np.asarray(f[k], np.float32),
                                        device=dev)
                           for k in ScenarioState._fields))


def buffer_from_numpy(buf_np: Any, device: "str | torch.device" = "cuda"
                      ) -> "BufferState | None":
    """A reference ``BufferState`` (numpy leaves, or a mapping of its 13
    fields; with or without a leading fleet axis) as the port's on
    ``device``, each leaf with its dtype (float32, bool, int32); None
    stays None."""
    if buf_np is None:
        return None
    dev = resolve_device(device)
    f = _fields(buf_np)
    return BufferState(*(_tensors(f[k], dev) for k in BufferState._fields))


def faults_from_numpy(flt_np: Any, device: "str | torch.device" = "cuda"
                      ) -> "FaultState | None":
    """A reference ``FaultState`` (numpy leaves, or a mapping of its 6
    fields; with or without a leading fleet axis) as the port's on
    ``device``: ``edge_up`` float32, the rest int32; None stays None."""
    if flt_np is None:
        return None
    dev = resolve_device(device)
    f = _fields(flt_np)
    return FaultState(*(_tensors(f[k], dev) for k in FaultState._fields))


def _tensors(tree: Any, dev: torch.device) -> Any:
    """Every array leaf of a mapping tree copied onto ``dev`` with its
    dtype (float32, int32, bool)."""
    if isinstance(tree, Mapping):
        return {k: _tensors(v, dev) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=dev)


def actor_from_numpy(actor_np: Mapping[str, Any],
                     device: "str | torch.device" = "cuda"
                     ) -> "dict[str, torch.Tensor]":
    """A reference actor pytree (``w0``..``b2``, numpy leaves, with or
    without a leading fleet axis) as the port's, on ``device``."""
    return _tensors(actor_np, resolve_device(device))


def ddpg_from_numpy(state_np: Any, device: "str | torch.device" = "cuda"
                    ) -> DDPGState:
    """A reference ``DDPGState`` with numpy leaves (one agent, or a fleet
    with a leading axis on every leaf) as the port's, on ``device``:
    the networks, targets, Adam moments and replay ring, ``buffer_idx``,
    ``buffer_full``, ``noise_sigma`` and ``step`` with their dtypes."""
    dev = resolve_device(device)
    f = _fields(state_np)
    return DDPGState(*(_tensors(f[k], dev) for k in DDPGState._fields))


# the port's parameter names that differ from the reference pytree's keys
_JAX_NAME = {"lam": "lambda"}


def _leaf(tree: Mapping[str, Any], name: str, where: str) -> np.ndarray:
    """The array at a dotted port parameter name (``attn.q_norm.scale``)
    in a nested reference mapping, each level's key renamed by
    ``_JAX_NAME``; a missing key raises naming the path."""
    node = tree
    for part in name.split("."):
        key = _JAX_NAME.get(part, part)
        if not isinstance(node, Mapping) or key not in node:
            raise KeyError(f"{where}: the reference weights have no "
                           f"{name!r} ({key!r} missing)")
        node = node[key]
    return np.asarray(node)


def _fill(param: torch.Tensor, src: np.ndarray, where: str) -> None:
    if tuple(src.shape) != tuple(param.shape):
        raise ValueError(f"{where}: shape {src.shape} != "
                         f"{tuple(param.shape)}")
    param.copy_(torch.tensor(src))


def params_from_numpy(params_np: Mapping[str, Any], cfg,
                      device: "str | torch.device" = "cuda", mesh=None,
                      fsdp: bool = False
                      ) -> "Transformer | EncDecTransformer":
    """The model ``build_model(cfg)`` on ``device`` holding the weights of
    a reference ``init`` pytree with numpy leaves.  Both kinds have
    ``embed/embedding`` (and ``embed/unembedding`` when untied) and
    ``final_norm/scale`` (and ``bias`` for LayerNorm).  A decoder
    (``Transformer.init``) has ``stage_<i>/<unit position>/<group>/...``
    stacked over the stage's repetitions, nested names included
    (``attn/q_norm/scale``), a MoE block's ``moe/{router, w_gate, w_in,
    w_out}`` (the router stays float32 under any ``param_dtype``, as the
    port's parameter is) and an xLSTM block's ``mlstm/...`` or
    ``slstm/...`` among them.  An encoder-decoder
    (``EncDecTransformer.init``) has ``encoder/...`` and ``decoder/...``
    stacked over the layers and ``enc_norm``.  Every parameter of the port
    is filled; a missing key or a shape mismatch raises.  With a ``mesh``
    (a ``launch.mesh.Mesh2D``), the model holds this rank's block of each
    leaf, as ``sharding.rules`` places it (``fsdp``: the training
    placement, each leaf's FSDP dim split over ``data`` too)."""
    model = build_model(cfg, device=device, mesh=mesh, fsdp=fsdp)
    top = {"embedding": "embed.embedding",
           "unembedding": "embed.unembedding"}
    for name, param in model.named_parameters():
        group, _, rest = name.partition(".")
        if group == "blocks":
            i, name = rest.split(".", 1)
            stage, r, pos = model.block_index[int(i)]
            tree, where = params_np[stage][pos], f"{stage}/{pos}"
        elif group in ("encoder", "decoder"):
            r, name = rest.split(".", 1)
            r = int(r)
            tree, where = params_np[group], group
        else:
            path = top.get(name, name)
            _fill(param, _block(param, _leaf(params_np, path, path), mesh),
                  path)
            continue
        where = f"{where}/{name.replace('.', '/')}[{r}]"
        _fill(param, _block(param, _leaf(tree, name, where)[r], mesh), where)
    return model


def _block(param: torch.Tensor, src: np.ndarray, mesh) -> np.ndarray:
    """This rank's block of a whole leaf, where the model axis (and, on a
    training mesh, the data axis) splits the parameter (``layers.param``'s
    ``model_split`` and ``data_split``)."""
    for axis in ("model", "data"):
        dim = getattr(param, f"{axis}_split", None)
        if dim is not None:
            n = param.shape[dim]
            lo = mesh.coords[axis] * n
            src = np.take(src, range(lo, lo + n), axis=dim)
    return src


def _reference_path(model: "Transformer | EncDecTransformer", name: str
                    ) -> Tuple[Tuple[str, ...], "int | None"]:
    """The reference key path of a port parameter name and its index along
    the stacked repetitions (None for an unstacked leaf): the inverse of
    ``params_from_numpy``'s walk."""
    group, _, rest = name.partition(".")
    if group == "blocks":
        i, sub = rest.split(".", 1)
        stage, r, pos = model.block_index[int(i)]
        head: Tuple[str, ...] = (stage, pos)
    elif group in ("encoder", "decoder"):
        r, sub = rest.split(".", 1)
        r, head = int(r), (group,)
    else:
        r, head = None, ()
        sub = {"embedding": "embed.embedding",
               "unembedding": "embed.unembedding"}.get(name, name)
    return head + tuple(_JAX_NAME.get(p, p) for p in sub.split(".")), r


def params_to_tree(model: "Transformer | EncDecTransformer",
                   tensors: "Mapping[str, torch.Tensor] | None" = None,
                   mesh=None) -> "dict[str, Any]":
    """``tensors`` -- a dict keyed by ``model``'s parameter names (its
    gradients, an optimizer's moments; default the weights themselves) --
    as a nested dict in the layout of the reference's ``init`` pytree:
    ``embed/...``, ``final_norm/...``, a decoder's ``stage_<i>/<unit
    position>/...`` stacked over the stage's repetitions, an
    encoder-decoder's ``encoder/...`` and ``decoder/...`` stacked over the
    layers and ``enc_norm/...``; each leaf detached, on its tensor's
    device, in its dtype.  A model built on a ``mesh`` (default: its own)
    has each split leaf gathered whole, over ``data`` along its
    ``data_split``, then over ``model`` (every rank of the mesh calls
    this)."""
    if tensors is None:
        tensors = dict(model.named_parameters())
    mesh = getattr(model, "mesh", None) if mesh is None else mesh
    params = dict(model.named_parameters())
    leaves = [tensors[name].detach() for name in params]
    if mesh is not None:
        for axis in ("data", "model"):
            leaves = parallel.gather_leaves(
                mesh, axis, leaves, [getattr(p, f"{axis}_split", None)
                                     for p in params.values()])
    reps: "dict[Tuple[str, ...], dict[int, torch.Tensor]]" = {}
    tree: "dict[str, Any]" = {}
    for name, leaf in zip(params, leaves):
        path, r = _reference_path(model, name)
        if r is None:
            _put(tree, path, leaf)
        else:
            reps.setdefault(path, {})[r] = leaf
    for path, by_r in reps.items():
        if sorted(by_r) != list(range(len(by_r))):
            raise ValueError(f"{'/'.join(path)}: repetitions {sorted(by_r)}")
        _put(tree, path, torch.stack([by_r[r] for r in range(len(by_r))]))
    return tree


def _put(tree: "dict[str, Any]", path: Tuple[str, ...], leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def params_to_numpy(model: "Transformer | EncDecTransformer",
                    tensors: "Mapping[str, torch.Tensor] | None" = None,
                    mesh=None) -> "dict[str, Any]":
    """``params_to_tree`` with numpy leaves on the host (a sharded model's
    gathered whole); bfloat16 (which numpy lacks) becomes float32, which
    holds it exactly, so ``params_from_numpy(params_to_numpy(m), cfg)``
    rebuilds ``m`` bit for bit."""
    return host_tree(params_to_tree(model, tensors, mesh))


def host_tree(tree) -> "dict[str, Any]":
    """A nested dict of tensors with numpy leaves on the host, bfloat16 as
    float32 (which holds it exactly); each leaf a copy, never a view of a
    tensor the train step goes on to update in place."""
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    t = tree.detach().to("cpu", copy=True)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def opt_state_to_numpy(model: "Transformer | EncDecTransformer",
                       opt_state: Mapping[str, Mapping[str, torch.Tensor]]
                       ) -> "dict[str, Any]":
    """An Adam state of ``model``'s parameters (``{"m": ..., "v": ...}``,
    each rank's blocks on a mesh) in the reference's layout, each moment
    gathered whole as ``params_to_numpy`` gathers the weights (a
    collective every rank of the mesh calls)."""
    return {k: params_to_numpy(model, opt_state[k]) for k in ("m", "v")}


def opt_state_from_numpy(model: "Transformer | EncDecTransformer",
                         state_np: Mapping[str, Any],
                         opt_state: Mapping[str, Mapping[str, torch.Tensor]]
                         ) -> Mapping[str, Mapping[str, torch.Tensor]]:
    """``opt_state`` (``{"m": ..., "v": ...}`` keyed by ``model``'s
    parameter names, as the optimizer's ``init`` makes it) filled from an
    Adam state in the reference's layout with numpy leaves
    (``opt_state_to_numpy``'s), each moment this rank's block where
    ``model`` is split (``layers.param``'s ``model_split`` and
    ``data_split``), in its own dtype.  A missing key or a shape mismatch
    raises.  Returns ``opt_state``."""
    for name, param in model.named_parameters():
        path, r = _reference_path(model, name)
        where = "/".join(path) + ("" if r is None else f"[{r}]")
        for k in ("m", "v"):
            leaf = state_np[k]
            for key in path:
                if key not in leaf:
                    raise KeyError(f"{k}: missing {where}")
                leaf = leaf[key]
            leaf = np.asarray(leaf if r is None else leaf[r])
            _fill(opt_state[k][name], _block(param, leaf, model.mesh),
                  f"{k} {where}")
    return opt_state


# the leaves of the reference's tuple caches (models/xlstm.py), in order
_TUPLE_CACHE = {"mlstm": ("c", "n", "m", "conv"),
                "slstm": ("c", "n", "h", "m", "conv")}


def cache_from_numpy(cache_np: Mapping[str, Any],
                     model: "Transformer | EncDecTransformer"
                     ) -> "dict[str, Any]":
    """A reference decode cache with numpy leaves as ``model``'s, on the
    model's device, each leaf with its numpy dtype.  An encoder-decoder's
    ``{"decoder": {k, v, cross_k, cross_v}}`` keeps its layout; a
    decoder's ``stage_<i>/<unit position>`` leaves are dicts (attention,
    RG-LRU) or the xLSTM blocks' tuples, which become the port's named
    leaves."""
    dev = model.device
    if isinstance(model, EncDecTransformer):
        return {"decoder": _tensors(cache_np["decoder"], dev)}
    cache = {}
    for si, (unit, _) in enumerate(model.stages):
        stage = {}
        for i, (kind, _) in enumerate(unit):
            leaves = cache_np[f"stage_{si}"][str(i)]
            if kind in _TUPLE_CACHE:
                leaves = dict(zip(_TUPLE_CACHE[kind], leaves))
            stage[str(i)] = _tensors(leaves, dev)
        cache[f"stage_{si}"] = stage
    return cache


def cache_to_numpy(cache: Mapping[str, Any],
                   model: "Transformer | EncDecTransformer", batch: int
                   ) -> "dict[str, Any]":
    """``model``'s decode cache for a batch of ``batch`` rows in the
    reference's layout with numpy leaves (``cache_from_numpy``'s inverse;
    bf16 leaves as float32): on a mesh each leaf gathered over ``model``
    along its ``model_split`` tag and over ``data`` along its rows -- a
    collective every rank of the mesh calls --; the xLSTM blocks' named
    leaves become the reference's tuples."""
    mesh = model.mesh

    def host(leaf: torch.Tensor) -> np.ndarray:
        split = getattr(leaf, "model_split", None)
        if split is not None and parallel.model_active(mesh):
            leaf = mesh.all_gather(leaf.contiguous(), "model", dim=split)
        if parallel.data_rows(mesh, batch) != (0, batch):
            leaf = mesh.all_gather(leaf.contiguous(), "data", dim=1)
        if leaf.dtype not in (torch.float32, torch.int32, torch.int64):
            leaf = leaf.float()
        return leaf.cpu().numpy()

    if isinstance(model, EncDecTransformer):
        return {"decoder": {k: host(v)
                            for k, v in cache["decoder"].items()}}
    out = {}
    for si, (unit, _) in enumerate(model.stages):
        stage = {}
        for i, (kind, _) in enumerate(unit):
            leaves = {k: host(v) for k, v in
                      cache[f"stage_{si}"][str(i)].items()}
            stage[str(i)] = (tuple(leaves[k] for k in _TUPLE_CACHE[kind])
                             if kind in _TUPLE_CACHE else leaves)
        out[f"stage_{si}"] = stage
    return out

"""Logical-axis partition rules of the substrate over a ``("data",
"model")`` mesh (or ``("pod", "data", "model")``).

The port of the reference's ``sharding/rules.py``.  Every parameter is
placed by NAME (its last name in ``named_parameters()``) and shape.  A
rule gives, in negative axis positions,

* a TENSOR dimension chain -- tried in order, the first whose size the
  ``model`` axis divides is split over it (tensor parallelism; the MoE
  leaves try the expert dimension first: expert parallelism), and
* an FSDP dimension chain -- split over ``data`` (fully sharded data
  parallelism, used by training; serving passes ``fsdp=False`` and
  replicates the weights over ``data``).

A dimension no axis divides falls through the chain and stays whole:
MQA's one KV head stays whole while the q heads split.  The ``pod`` axis
is pure data parallelism: weights replicate over it, the batch spans it.

A placement is a plain tuple with one entry a dimension: an axis name, a
tuple of names, or None -- the entries of the reference's
``PartitionSpec``.  A mesh is anything with ``axis_names`` and ``shape``
(a mapping from axis name to size): ``launch.mesh.Mesh2D``, or a
stand-in of any size for checking the rules without processes.

The reference writes its rules for the canonical (unstacked) leaf, whose
dimensions it counts from the end so that its layer-stacked leaves need
no special case; the port's parameters are unstacked, one per layer, so
``tree_specs`` gives the reference's placement without its leading
``reps`` axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

Placement = Tuple[Any, ...]

# (tensor-dim chain, fsdp-dim chain) per leaf name; dims are negative axes
# of the canonical leaf, as the reference's _RULES.  Head dims split only
# when the axis divides them, else they stay whole (a dh split would make
# every score product contract over a split dim); the embedding has no
# FSDP dim (a data-split d makes the unembedding contract over it).
_RULES: Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]] = {
    "embedding": ((-2, -1), ()),
    "unembedding": ((-2, -1), ()),
    "wq": ((-2,), (-3,)),
    "wk": ((-2,), (-3,)),
    "wv": ((-2,), (-3,)),
    "wo": ((-3,), (-1,)),
    "w_in": ((-4, -1), (-2,)),        # -4 never matches 2-D: see _MOE_RULES
    "w_gate": ((-4, -1), (-2,)),
    "w_out": ((-4, -2), (-1,)),
    "w_up": ((-1,), (-2,)),
    "w_up_main": ((-1,), (-2,)),
    "w_up_gate": ((-1,), (-2,)),
    "w_gate_branch": ((-1,), (-2,)),
    "w_gates": ((-1,), (-2,)),
    "w_down": ((-2,), (-1,)),
    "w_a": ((-1,), (-2,)),
    "w_x": ((-1,), (-2,)),
    "conv_w": ((-1,), ()),
    "r_gates": ((-3, -1), ()),
    "w_igate": ((), (-2,)),
    "w_fgate": ((), (-2,)),
}

# the MoE leaves (E, d, ff) / (E, ff, d) share names with the dense MLP's:
# a leaf of 3 or more dims tries the expert dim first
_MOE_RULES: Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]] = {
    "w_in": ((-3, -1), (-2,)),
    "w_gate": ((-3, -1), (-2,)),
    "w_out": ((-3, -2), (-1,)),
}


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Which mesh axes play which logical role."""
    batch: Tuple[str, ...]           # ("pod", "data") or ("data",)
    fsdp: Tuple[str, ...]            # ("data",)
    tensor: Tuple[str, ...]          # ("model",)


def mesh_axes(mesh) -> MeshAxes:
    if "pod" in mesh.axis_names:
        return MeshAxes(("pod", "data"), ("data",), ("model",))
    return MeshAxes(("data",), ("data",), ("model",))


def _axis_size(mesh, axes: Sequence[str]) -> int:
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def _entry(axes: Tuple[str, ...]):
    return axes if len(axes) > 1 else axes[0]


def spec_for_param(name: str, shape: Sequence[int], mesh, *,
                   fsdp: bool = True) -> Placement:
    """The placement of one parameter by its rule name and shape."""
    ax = mesh_axes(mesh)
    shape = tuple(shape)
    ndim = len(shape)
    rules = _RULES.get(name)
    if name in _MOE_RULES and ndim >= 3:
        rules = _MOE_RULES[name]
    spec: list = [None] * ndim
    if rules is None:
        return tuple(spec)
    tensor_chain, fsdp_chain = rules
    t_size = _axis_size(mesh, ax.tensor)
    f_size = _axis_size(mesh, ax.fsdp)
    t_dim = None
    for d in tensor_chain:
        if -d <= ndim and shape[d] % t_size == 0:
            t_dim = d % ndim
            spec[t_dim] = _entry(ax.tensor)
            break
    if t_dim is None and name in ("wq", "wk", "wv") and ndim >= 3:
        # heads whole over `model`: FSDP must then keep the contraction dim
        # d whole (else every projection all-reduces its activation), so
        # it moves to dh
        fsdp_chain = (-1, -3)
    if fsdp:
        for d in fsdp_chain:
            dd = d % ndim if -d <= ndim else None
            if dd is not None and dd != t_dim and shape[d] % f_size == 0:
                spec[dd] = _entry(ax.fsdp)
                break
    return tuple(spec)


def tree_specs(model, mesh, *, fsdp: bool = True) -> Dict[str, Placement]:
    """The placement of every parameter of ``model`` (an ``nn.Module``),
    keyed by its name in ``named_parameters()``."""
    return {name: spec_for_param(name.rsplit(".", 1)[-1], p.shape, mesh,
                                 fsdp=fsdp)
            for name, p in model.named_parameters()}


def batch_axes(mesh, global_batch: int) -> Optional[Tuple[str, ...]]:
    """The longest prefix of the batch axes whose size divides
    ``global_batch`` (the pod axis first), or None: a batch of 1 stays
    whole."""
    ax = mesh_axes(mesh)
    chosen: Tuple[str, ...] = ()
    size = 1
    for a in ax.batch:
        if global_batch % (size * mesh.shape[a]) == 0:
            chosen = chosen + (a,)
            size *= mesh.shape[a]
        else:
            break
    return chosen if chosen else None


def cache_spec(shape: Sequence[int], mesh,
               batch: Optional[Tuple[str, ...]]) -> Placement:
    """A decode-cache leaf: axis 0 the stacked repetitions, axis 1 the
    batch (over ``batch`` where its size divides it).  An attention K/V
    leaf (4 or more dims) splits its SEQUENCE (-3) over ``model``, then
    dh, then the heads, the first the axis divides (flash-decoding: each
    rank's slots give partial softmax statistics, and only those and the
    output cross ranks); a recurrent state (3 dims) splits its channels."""
    ax = mesh_axes(mesh)
    t_size = _axis_size(mesh, ax.tensor)
    shape = tuple(shape)
    ndim = len(shape)
    spec: list = [None] * ndim
    if ndim >= 2:
        b_dim = 1
        if batch and shape[b_dim] % _axis_size(mesh, batch) == 0:
            spec[b_dim] = _entry(batch)
        chain = (-3, -1, -2) if ndim >= 4 else (-1,)
        for d in chain:
            dd = d % ndim
            if dd > b_dim and spec[dd] is None and shape[d] % t_size == 0:
                spec[dd] = ax.tensor[0]
                break
    return tuple(spec)


def input_shardings(specs: Dict[str, Any], mesh, global_batch: int
                    ) -> Dict[str, Any]:
    """The placement of each entry of ``configs.input_specs`` (a train,
    prefill or decode input): the batch over ``batch_axes``, a cache's
    leaves by ``cache_spec``, the decode index whole (``()``)."""
    b_ax = batch_axes(mesh, global_batch)
    b_spec = _entry(b_ax) if b_ax else None

    def cache(tree):
        if isinstance(tree, dict):
            return {k: cache(v) for k, v in tree.items()}
        return cache_spec(tree.shape, mesh, b_ax)

    out: Dict[str, Any] = {}
    for k, v in specs.items():
        if k == "cache":
            out[k] = cache(v)
        elif k == "index":
            out[k] = ()
        else:
            out[k] = (b_spec,) + (None,) * (len(v.shape) - 1)
    return out


def model_dim(spec: Placement) -> Optional[int]:
    """The dimension a placement splits over ``model``, or None."""
    for i, entry in enumerate(spec):
        if entry == "model" or (isinstance(entry, tuple)
                                and "model" in entry):
            return i
    return None

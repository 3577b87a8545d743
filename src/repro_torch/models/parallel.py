"""How the substrate's modules split over a ``launch.mesh.Mesh2D``.

A module built with a mesh whose ``model`` axis has W > 1 ranks holds, of
each weight, the block that ``sharding.spec_for_param(name, shape, mesh,
fsdp=False)`` names: the dimension the rule splits over ``model``, block
r of W on rank r; every other weight whole (serving replicates the
weights over ``data``).  A model built for training (``placed(mesh,
fsdp=True)``: ``make_train_step``) holds ``spec_for_param(...,
fsdp=True)``'s block: the model block, then the data rank's block of the
FSDP dimension (tagged ``data_split`` beside ``model_split``), gathered
over ``data`` at each layer's entry (``gathered``) and freed after it.
With a generator each rank draws every leaf whole, in the unsharded
model's order, keeps its block and frees the rest, so the weights are
the unsharded model's.

The helpers here are what the modules' sharded bodies share: the model
axis's size and this rank's place on it, the sum of row-parallel
partials over ``model`` (in float32, rounded once to the partials'
dtype, so the sum's order is the only departure from one product), the
data axis's rows of a batch (``sharding.batch_axes``: a batch the data
axis does not divide stays whole on every data rank), the lookup and
the logits of an embedding table split by vocab or by ``d_model``, and
the tag a decode cache's leaf carries: ``model_split``, the dim of it
the model axis splits (None: whole on every model rank), as a
parameter's ``model_split`` (``layers.param``).

Gradients follow the adjoint convention.  Every rank seeds its backward
with 1 / (the mesh's size), so that the seeds of the loss -- which every
rank computes, bit for bit -- sum to 1.  Each collective the training
forward reaches runs through an autograd Function whose backward is its
linear adjoint: a gather's is the sum of every rank's gradient, cut to
this rank's block (a reduce-scatter), a sum's is a sum; both in float32,
rounded once.  So a value that several ranks hold has, as its true
gradient, the sum of the ranks' gradients of it, and after the backward
a leaf's gradient is summed over every axis on which the leaf is whole
(``reduce_grads``); an FSDP leaf's data sum is its gather's
reduce-scatter.  No site needs its own rule: a whole leaf sliced at use,
a norm every model rank runs, the MoE aux every data rank computes from
the gathered router logits and a batch every data rank runs whole are
each counted once by the same sums.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch import sharding
from repro_torch.launch.mesh import block

AXES = ("model", "data")
# the most float32 elements one gradient sum over an axis carries at once
BUCKET = 1 << 26


def active(mesh) -> bool:
    """Whether ``mesh`` splits anything: a mesh of one runs today's
    unsharded bodies."""
    return mesh is not None and mesh.size > 1


def model_active(mesh) -> bool:
    return mesh is not None and mesh.shape["model"] > 1


def placed(mesh, fsdp: bool):
    """``mesh`` as a model built on it reads it: with ``fsdp`` a copy this
    module marks for the training placement (FSDP over ``data``), else the
    mesh unmarked (serving's placement), whichever of the two it was
    given.  The mark is this module's own; ``build_model(..., fsdp=)`` is
    the one place a caller chooses."""
    if mesh is None:
        return None
    base = getattr(mesh, "_unplaced", mesh)
    if not fsdp:
        return base
    out = copy.copy(base)
    object.__setattr__(out, "_unplaced", base)
    return out


def fsdp_active(mesh) -> bool:
    """Whether a model on ``mesh`` splits its weights over ``data``."""
    return (mesh is not None and hasattr(mesh, "_unplaced")
            and mesh.shape["data"] > 1)


def model_axis(mesh) -> Tuple[int, int]:
    """(W, r): the model axis's size and this rank's index on it."""
    if mesh is None:
        return 1, 0
    return mesh.shape["model"], mesh.coords["model"]


def split_dim(name: str, shape, mesh) -> Optional[int]:
    """The dimension of a weight that ``model`` splits (serving's
    placement: ``fsdp=False``), or None."""
    if not model_active(mesh):
        return None
    return sharding.model_dim(sharding.spec_for_param(name, shape, mesh,
                                                      fsdp=False))


def local_block(name: str, shape, mesh) -> Tuple[Optional[int], int, int]:
    """(dim, lo, hi): the split dimension and this rank's block of it, or
    (None, 0, 0) for a whole weight."""
    dim = split_dim(name, shape, mesh)
    if dim is None:
        return None, 0, 0
    w, r = model_axis(mesh)
    n = shape[dim] // w
    return dim, r * n, (r + 1) * n


def data_block(name: str, shape, mesh) -> Tuple[Optional[int], int, int]:
    """(dim, lo, hi): the FSDP dimension of weight ``name`` (whole shape
    ``shape``) and this data rank's block of it on a training mesh
    (``placed(mesh, fsdp=True)``), or (None, 0, 0): whole over ``data``."""
    if not fsdp_active(mesh):
        return None, 0, 0
    spec = sharding.spec_for_param(name, shape, mesh, fsdp=True)
    dims = [i for i, e in enumerate(spec) if e == "data"]
    if not dims:
        return None, 0, 0
    n = shape[dims[0]] // mesh.shape["data"]
    r = mesh.coords["data"]
    return dims[0], r * n, (r + 1) * n


def span(name: str, shape, mesh) -> Optional[Tuple[int, int]]:
    """[lo, hi) of this rank's block of the dimension the model axis
    splits of weight ``name``, or None where it stays whole."""
    dim, lo, hi = local_block(name, shape, mesh)
    return None if dim is None else (lo, hi)


def part(block: Optional[Tuple[int, int]], t: torch.Tensor) -> torch.Tensor:
    """The block [lo, hi) of ``t``'s last dim (a whole leaf or activation
    met with a split one), or ``t`` where ``block`` is None."""
    return t if block is None else t[..., block[0]:block[1]]


# -- collectives with their adjoints ------------------------------------------

class _Gather(torch.autograd.Function):
    """``mesh.all_gather`` (``counts``: ``all_gather_ragged``) over
    ``axis``; backward the sum of every rank's gradient in float32, this
    rank's block of it, rounded once."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim, counts):
        ctx.mesh, ctx.axis, ctx.dim, ctx.counts = mesh, axis, dim, counts
        if counts is None:
            return mesh.all_gather(t, axis, dim=dim)
        return mesh.all_gather_ragged(t, counts, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        counts = ctx.counts
        if counts is None:
            n = g.shape[ctx.dim] // ctx.mesh.shape[ctx.axis]
            counts = [n] * ctx.mesh.shape[ctx.axis]
        out = ctx.mesh.reduce_scatter(g.float(), ctx.axis, dim=ctx.dim,
                                      counts=counts)
        return out.to(g.dtype), None, None, None, None


class _Sum(torch.autograd.Function):
    """``mesh.all_reduce`` (sum) over ``axis``; backward the same sum of
    the gradients in float32, rounded once."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_reduce(t, axis)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.all_reduce(g.float(), ctx.axis).to(g.dtype), None,
                None)


def _tracked(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def all_gather(mesh, t: torch.Tensor, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """``mesh.all_gather`` over ``axis``, differentiable (``_Gather``)
    where autograd records ``t``."""
    if mesh.shape[axis] == 1:
        return t
    if _tracked(t):
        return _Gather.apply(t, mesh, axis, dim % t.dim(), None)
    return mesh.all_gather(t, axis, dim=dim)


def all_gather_ragged(mesh, t: torch.Tensor, counts: Sequence[int],
                      axis: str, dim: int = 0) -> torch.Tensor:
    """``mesh.all_gather_ragged`` over ``axis``, differentiable."""
    if mesh.shape[axis] == 1:
        return t
    if _tracked(t):
        return _Gather.apply(t, mesh, axis, dim % t.dim(), list(counts))
    return mesh.all_gather_ragged(t, counts, axis, dim=dim)


def all_reduce(mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """``mesh.all_reduce`` (sum) over ``axis``, differentiable."""
    if mesh.shape[axis] == 1:
        return t
    if _tracked(t):
        return _Sum.apply(t, mesh, axis)
    return mesh.all_reduce(t, axis)


def gather_blocks(mesh, *parts: torch.Tensor, dim: int = -1
                  ) -> Tuple[torch.Tensor, ...]:
    """Each of ``parts``, a rank's block along ``dim``, all-gathered over
    ``model`` into every rank's blocks in rank order -- all in one
    collective."""
    w, _ = model_axis(mesh)
    dim = dim % parts[0].dim()
    sizes = [t.shape[dim] for t in parts]
    both = all_gather(mesh, torch.cat(parts, dim=dim), "model", dim=dim)
    lead, tail = both.shape[:dim], both.shape[dim + 1:]
    both = both.reshape(lead + (w, sum(sizes)) + tail)
    return tuple(t.reshape(lead + (w * n,) + tail)
                 for t, n in zip(both.split(sizes, dim=dim + 1), sizes))


def sum_model(mesh, t: torch.Tensor) -> torch.Tensor:
    """Row-parallel partials summed over ``model`` in float32 and rounded
    once to ``t``'s dtype."""
    if not model_active(mesh):
        return t
    return all_reduce(mesh, t.float(), "model").to(t.dtype)


def data_rows(mesh, batch: int) -> Tuple[int, int]:
    """[lo, hi) of the batch's rows this rank serves: its data rank's block
    where ``sharding.batch_axes`` splits the batch over ``data``, else the
    whole batch."""
    if mesh is None or "data" not in (sharding.batch_axes(mesh, batch)
                                      or ()):
        return 0, batch
    return block(batch, mesh.shape["data"], mesh.coords["data"])


def rows(mesh, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """This rank's rows of a batch-major tensor (None stays None)."""
    if t is None or not active(mesh):
        return t
    lo, hi = data_rows(mesh, t.shape[0])
    return t[lo:hi]


def unrows(mesh, t: torch.Tensor, batch: int) -> torch.Tensor:
    """The whole batch from each data rank's rows (``rows``'s inverse)."""
    if not active(mesh) or data_rows(mesh, batch) == (0, batch):
        return t
    return all_gather(mesh, t, "data", dim=0)


def posted(mesh, what: str, check: Callable[[], None]) -> None:
    """Run ``check`` (a step's validation of its inputs) on this rank and
    post its verdict to every rank before the step's collectives (the
    mesh's ``all_ok``, as the sharded HFL drivers post theirs): a rank
    whose check raised re-raises, every other raises ``PeerFailed``, and
    none waits at a collective its peer never reaches.  Without a mesh
    (today's unsharded path) nothing is checked."""
    if not active(mesh):
        return
    try:
        check()
    except BaseException:
        mesh.all_ok(False)
        raise
    mesh.check(True, what)


def tagged(t: torch.Tensor, whole, local, lead: int = 0) -> torch.Tensor:
    """``t`` (a cache leaf of ``lead`` leading dims, then ``local``) with
    ``model_split`` set: the first dim where ``local`` is smaller than the
    unsharded leaf's ``whole`` (counted in ``t``), or None."""
    dims = [i for i, (a, b) in enumerate(zip(whole, local)) if a != b]
    t.model_split = lead + dims[0] if dims else None
    return t


def layer_view(leaf: torch.Tensor, r: int) -> torch.Tensor:
    """``leaf[r]`` (one repetition of a stacked cache leaf), its
    ``model_split`` tag carried over."""
    out = leaf[r]
    if hasattr(leaf, "model_split"):
        split = leaf.model_split
        out.model_split = None if split is None else split - 1
    return out


def embed(table: torch.Tensor, split: Optional[int], mesh,
          tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The lookup of ``tokens`` in ``table`` (this rank's block where
    ``split`` is 0, by vocab, or 1, by d_model): by vocab, the rank's
    rows (zero for tokens outside its range) summed over `model` -- one
    rank adds a value, the others +0.0, so the sum is exact; by d_model,
    the rank's columns gathered."""
    if split is None:
        return table[tokens].to(dtype)
    if split == 1:
        return all_gather(mesh, table[tokens].to(dtype), "model", dim=-1)
    n = table.shape[0]
    local = tokens - mesh.coords["model"] * n
    inside = (local >= 0) & (local < n)
    part = torch.where(inside[..., None], table[local.clamp(0, n - 1)], 0.0)
    return all_reduce(mesh, part, "model").to(dtype)


def vocab_nll(table: torch.Tensor, split: Optional[int], mesh,
              x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's cross entropy (``layers.token_nll``) of x (..., d)'s
    logits against the (V, d) table and ``labels`` (...,), float32.  A
    table split by vocab (``split`` 0) keeps its logits on their ranks:
    the max over every rank's block (a constant shift, no gradient path),
    the sum of exp and the label's logit (on the rank that holds it) are
    summed over ``model``; no (..., V) tensor is gathered."""
    from repro_torch.models import layers
    if split != 0 or not model_active(mesh):
        return layers.token_nll(unembed(table, split, mesh, x), labels)
    logits = (x @ table.to(x.dtype).t()).float()
    n = table.shape[0]
    peak = mesh.all_reduce(logits.detach().amax(dim=-1), "model", "max")
    sumexp = all_reduce(mesh, torch.exp(logits - peak[..., None]).sum(-1),
                        "model")
    local = labels.long() - mesh.coords["model"] * n
    inside = (local >= 0) & (local < n)
    picked = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])
    label = all_reduce(mesh, torch.where(inside, picked[..., 0], 0.0),
                       "model")
    return torch.log(sumexp) + peak - label


def unembed(table: torch.Tensor, split: Optional[int], mesh,
            x: torch.Tensor) -> torch.Tensor:
    """x (..., d) against the (V, d) table -> logits (..., V), every vocab
    entry on every rank: a vocab-split table's logits gathered over
    `model`, a d_model-split one's partial logits summed."""
    if split is None:
        return x @ table.to(x.dtype).t()
    if split == 0:
        return all_gather(mesh, x @ table.to(x.dtype).t(), "model", dim=-1)
    n = table.shape[1]
    lo = mesh.coords["model"] * n
    return sum_model(mesh, x[..., lo:lo + n] @ table.to(x.dtype).t())


# -- training: the FSDP gather and the gradients' sums ------------------------

@contextlib.contextmanager
def gathered(mesh, module: torch.nn.Module):
    """Within the block, each FSDP leaf of ``module`` (a parameter with a
    ``data_split``) reads as its model block, all-gathered over ``data``
    (``_Gather``: its gradient reduce-scattered back to the rank's block
    in float32); the gathered copies are dropped at the block's end.  A
    model without FSDP leaves reads its parameters as they are."""
    if not fsdp_active(mesh):
        yield
        return
    shadows = []
    for mod in module.modules():
        for name, p in mod._parameters.items():
            dim = getattr(p, "data_split", None)
            if p is not None and dim is not None:
                # an instance attribute is found before nn.Module's
                # parameter lookup
                mod.__dict__[name] = all_gather(mesh, p, "data", dim)
                shadows.append((mod, name))
    try:
        yield
    finally:
        for mod, name in shadows:
            del mod.__dict__[name]


def gather_leaves(mesh, axis: str, leaves: Sequence[torch.Tensor],
                  dims: Sequence[Optional[int]]) -> list:
    """Each of ``leaves`` (a rank's block along ``dims[i]`` over ``axis``;
    None: whole) gathered whole (not differentiable): the split leaves of
    one dtype packed, up to ``BUCKET`` elements, into one all-gather."""
    out = list(leaves)
    if mesh.shape[axis] == 1:
        return out
    w = mesh.shape[axis]
    todo = [i for i, d in enumerate(dims) if d is not None]
    for dtype in dict.fromkeys(leaves[i].dtype for i in todo):
        group = [i for i in todo if leaves[i].dtype == dtype]
        while group:
            take, size = [], 0
            while group and (not take or size + leaves[group[0]].numel()
                             <= BUCKET):
                size += leaves[group[0]].numel()
                take.append(group.pop(0))
            moved = [leaves[i].movedim(dims[i], 0) for i in take]
            full = mesh.all_gather(torch.cat([t.reshape(-1) for t in moved]),
                                   axis).reshape(w, size)
            off = 0
            for i, t in zip(take, moved):
                n = t.numel()
                piece = full[:, off:off + n].reshape((w * t.shape[0],)
                                                     + t.shape[1:])
                out[i] = piece.movedim(0, dims[i])
                off += n
    return out


def whole_axes(p: torch.Tensor, mesh) -> Tuple[str, ...]:
    """The axes of ``mesh`` (of more than one rank) on which the leaf
    ``p`` (a parameter, or a tensor carrying its tags) is whole."""
    split = {"model": getattr(p, "model_split", None),
             "data": getattr(p, "data_split", None)}
    return tuple(a for a in AXES if mesh.shape[a] > 1 and split[a] is None)


def reduce_grads(mesh, params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each rank's gradients of ``params`` (the adjoint convention: see
    the module's docstring) summed over every axis on which the leaf is
    whole, in float32 and rounded once to the gradient's dtype: one
    all-reduce an axis for each bucket of up to ``BUCKET`` elements.  Each
    returned gradient carries its parameter's ``model_split`` and
    ``data_split`` tags (``optim.global_norm`` reads them)."""
    out = dict(grads)
    by_axes: Dict[Tuple[str, ...], list] = {}
    for k, p in params.items():
        axes = whole_axes(p, mesh)
        if axes:
            by_axes.setdefault(axes, []).append(k)
    for axes, names in by_axes.items():
        start = 0
        while start < len(names):
            stop, size = start, 0
            while stop < len(names) and (stop == start
                                         or size + grads[names[stop]].numel()
                                         <= BUCKET):
                size += grads[names[stop]].numel()
                stop += 1
            part = names[start:stop]
            flat = torch.cat([grads[k].reshape(-1).float() for k in part])
            for a in axes:
                flat = mesh.all_reduce(flat, a)
            for k, piece in zip(part, flat.split([grads[k].numel()
                                                   for k in part])):
                out[k] = piece.reshape(grads[k].shape).to(grads[k].dtype)
            start = stop
    for k, p in params.items():
        out[k].model_split = getattr(p, "model_split", None)
        out[k].data_split = getattr(p, "data_split", None)
    return out

"""How the substrate's modules split over a ``launch.mesh.Mesh2D``.

A module built with a mesh whose ``model`` axis has W > 1 ranks holds, of
each weight, the block that ``sharding.spec_for_param(name, shape, mesh,
fsdp=False)`` names: the dimension the rule splits over ``model``, block
r of W on rank r; every other weight whole (serving replicates the
weights over ``data``).  With a generator each rank draws every leaf
whole, in the unsharded model's order, keeps its block and frees the
rest, so the weights are the unsharded model's.

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
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch import sharding
from repro_torch.launch.mesh import block


def active(mesh) -> bool:
    """Whether ``mesh`` splits anything: a mesh of one runs today's
    unsharded bodies."""
    return mesh is not None and mesh.size > 1


def model_active(mesh) -> bool:
    return mesh is not None and mesh.shape["model"] > 1


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


def span(name: str, shape, mesh) -> Optional[Tuple[int, int]]:
    """[lo, hi) of this rank's block of the dimension the model axis
    splits of weight ``name``, or None where it stays whole."""
    dim, lo, hi = local_block(name, shape, mesh)
    return None if dim is None else (lo, hi)


def part(block: Optional[Tuple[int, int]], t: torch.Tensor) -> torch.Tensor:
    """The block [lo, hi) of ``t``'s last dim (a whole leaf or activation
    met with a split one), or ``t`` where ``block`` is None."""
    return t if block is None else t[..., block[0]:block[1]]


def gather_blocks(mesh, *parts: torch.Tensor, dim: int = -1
                  ) -> Tuple[torch.Tensor, ...]:
    """Each of ``parts``, a rank's block along ``dim``, all-gathered over
    ``model`` into every rank's blocks in rank order -- all in one
    collective."""
    w, _ = model_axis(mesh)
    dim = dim % parts[0].dim()
    sizes = [t.shape[dim] for t in parts]
    both = mesh.all_gather(torch.cat(parts, dim=dim), "model", dim=dim)
    lead, tail = both.shape[:dim], both.shape[dim + 1:]
    both = both.reshape(lead + (w, sum(sizes)) + tail)
    return tuple(t.reshape(lead + (w * n,) + tail)
                 for t, n in zip(both.split(sizes, dim=dim + 1), sizes))


def sum_model(mesh, t: torch.Tensor) -> torch.Tensor:
    """Row-parallel partials summed over ``model`` in float32 and rounded
    once to ``t``'s dtype."""
    if not model_active(mesh):
        return t
    return mesh.all_reduce(t.float(), "model").to(t.dtype)


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
    return mesh.all_gather(t, "data", dim=0)


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
        return mesh.all_gather(table[tokens].to(dtype), "model", dim=-1)
    n = table.shape[0]
    local = tokens - mesh.coords["model"] * n
    inside = (local >= 0) & (local < n)
    part = torch.where(inside[..., None], table[local.clamp(0, n - 1)], 0.0)
    return mesh.all_reduce(part, "model").to(dtype)


def unembed(table: torch.Tensor, split: Optional[int], mesh,
            x: torch.Tensor) -> torch.Tensor:
    """x (..., d) against the (V, d) table -> logits (..., V), every vocab
    entry on every rank: a vocab-split table's logits gathered over
    `model`, a d_model-split one's partial logits summed."""
    if split is None:
        return x @ table.to(x.dtype).t()
    if split == 0:
        return mesh.all_gather(x @ table.to(x.dtype).t(), "model", dim=-1)
    n = table.shape[1]
    lo = mesh.coords["model"] * n
    return sum_model(mesh, x[..., lo:lo + n] @ table.to(x.dtype).t())

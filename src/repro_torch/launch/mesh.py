"""The substrate's 2-D device mesh over ``torch.distributed`` (the
reference's ``launch/mesh.py``: a ``("data", "model")`` mesh).

One process a card.  ``make_host_mesh(model=M)`` shapes the default
process group (set up from ``torchrun``'s environment when there is one
and it is not up yet, as ``core.mesh`` sets it up) as ``(world // M) x
M``: global rank g sits at ``(g // M, g % M)``.  A ``Mesh2D`` holds this
rank's coordinates and, for each axis, a 1-D ``core.mesh.Mesh`` over the
sub-group of the ranks that share its other coordinate (one
``dist.new_group`` a row and a column, made by every rank in the same
order); its collectives run over one axis: ``all_reduce`` (sum, max),
``all_gather(dim=)``, ``all_gather_ragged`` and ``reduce_scatter(dim=)``
-- staged for gloo or NCCL as ``core.mesh.Mesh`` stages them -- and
``all_ok`` over the whole world.
An axis of size 1 runs no collective, so without a process group
``make_host_mesh()`` is a 1 x 1 mesh that runs none.

``make_production_mesh`` (the reference's 16 x 16 and 2 x 16 x 16 TPU
pod shapes, which only its dry-run lowers) is not carried.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.mesh import Mesh, PeerFailed, _init_from_env, \
    block, rank_device  # noqa: F401 (block: re-exported)

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A ``data x model`` mesh: this rank at ``coords`` on ``device``;
    ``axes`` maps each axis name to its 1-D ``Mesh`` (group None where
    the axis has one rank).  ``world`` is the whole mesh's process group
    (None for a mesh of one)."""
    shape: Dict[str, int]
    coords: Dict[str, int]
    axes: Dict[str, Mesh]
    world: object
    device: torch.device

    axis_names: Tuple[str, ...] = AXES

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def all_reduce(self, t: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        return self.axes[axis].all_reduce(t, op)

    def all_gather(self, t: torch.Tensor, axis: str,
                   dim: int = 0) -> torch.Tensor:
        return self.axes[axis].all_gather(t, dim)

    def all_gather_ragged(self, t: torch.Tensor, counts: Sequence[int],
                          axis: str, dim: int = 0) -> torch.Tensor:
        return self.axes[axis].all_gather_ragged(t, counts, dim)

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int = 0,
                       counts: Optional[Sequence[int]] = None
                       ) -> torch.Tensor:
        return self.axes[axis].reduce_scatter(t, dim, counts)

    def all_ok(self, ok: bool) -> bool:
        """True when every rank of the mesh passes True (an all-reduce of
        one flag over the whole world)."""
        if self.world is None:
            return bool(ok)
        flag = torch.tensor([1 if ok else 0], dtype=torch.int32)
        if dist.get_backend(self.world) == "nccl":
            flag = flag.to(self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.world)
        return bool(flag.item())

    def check(self, ok: bool, what: str) -> None:
        """``all_ok``, and raise ``PeerFailed`` naming ``what`` on a rank
        that passed True when another did not (the one that did not
        raises its own error)."""
        if not self.all_ok(ok) and ok:
            raise PeerFailed(f"{what}: another rank of the mesh failed")


def make_host_mesh(model: int = 1, device: "str | torch.device | None" = None
                   ) -> Mesh2D:
    """The ``(world // model) x model`` mesh over the default process
    group (set up from ``torchrun``'s environment when it is not up), or a
    1 x 1 mesh that runs no collective when there is none.  ``device``:
    the card by default (``cuda:{LOCAL_RANK}``); ``"cpu"`` for gloo ranks
    on the host."""
    dev = rank_device(device)
    _init_from_env(dev)
    if not dist.is_initialized():
        if model != 1:
            raise ValueError(f"a model axis of {model} needs {model} "
                             f"processes; there is no process group")
        axes = {a: Mesh(a, None, 0, 1, dev) for a in AXES}
        return Mesh2D({"data": 1, "model": 1}, {"data": 0, "model": 0},
                      axes, None, dev)
    world = dist.get_world_size()
    if model < 1 or world % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"world of {world} processes")
    if dist.get_backend() == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL process group needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rank = dist.get_rank()
    n_data = world // model
    d, m = divmod(rank, model)
    rows = [[r * model + c for c in range(model)] for r in range(n_data)]
    cols = [[r * model + c for r in range(n_data)] for c in range(model)]
    groups = {}
    for axis, members, mine in (("model", rows, d), ("data", cols, m)):
        made = [dist.new_group(g) if len(g) > 1 else None for g in members]
        groups[axis] = made[mine]
    axes = {"data": Mesh("data", groups["data"], d, n_data, dev),
            "model": Mesh("model", groups["model"], m, model, dev)}
    return Mesh2D({"data": n_data, "model": model}, {"data": d, "model": m},
                  axes, dist.group.WORLD if world > 1 else None, dev)

"""A 1-D device mesh over ``torch.distributed`` (the reference's
``jax.sharding.Mesh`` of ``engine.fleet_mesh`` and ``engine.client_mesh``).

One process a card, as ``torchrun`` starts them: a ``Mesh`` names its
axis ("fleet" or "clients"), holds the process group, this process's
``rank`` among ``world`` and the device it runs on.  ``fleet_mesh()`` and
``client_mesh()`` read the default process group; under ``torchrun``
(``WORLD_SIZE`` in the environment) they set it up first, NCCL on
``cuda:{LOCAL_RANK}``, or gloo when the caller asks for the CPU.  With no
process group the world is 1, and the sharded drivers pass straight
through to the unsharded ones.

The drivers use two collectives, both here: ``all_gather`` of equal
shapes (``all_gather_ragged`` pads to the longest rank's rows and cuts
after) and ``all_ok``, an all-reduce of one flag; the substrate's 2-D
mesh (``launch.mesh.Mesh2D``, one ``Mesh`` an axis) also gathers along
other dims, sums or maxes (``all_reduce``) and sums and scatters
(``reduce_scatter``: a gather's adjoint, which training runs).  Over
gloo a CUDA tensor goes through the host (gloo is a host transport;
what it takes on CUDA tensors directly depends on the build).  A mesh with a group runs
its collectives even for a world of one.

``spawn`` runs a function in ``world`` fresh processes joined by a
``file://`` rendezvous: NCCL ranks on one host's cards by default, gloo
ranks on the CPU when asked (as the tests ask).  Each child imports the
function anew, so it must be importable there: from a module on the
parent's ``sys.path`` or from the parent's main script.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

AXES = ("fleet", "clients")


class PeerFailed(RuntimeError):
    """Another rank of the mesh raised: this one stops as well."""


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``axis`` over ``world`` processes, this one ``rank``
    on ``device``.  ``group`` is None for a world of one."""
    axis: str
    group: Any
    rank: int
    world: int
    device: torch.device

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the transport takes it: contiguous, bool as uint8, on
        the host for gloo and on this rank's card for NCCL."""
        t = t.contiguous()
        if t.dtype == torch.bool:
            t = t.view(torch.uint8)
        if self.backend == "gloo" and t.device.type != "cpu":
            t = t.cpu()
        elif self.backend == "nccl" and t.device != self.device:
            t = t.to(self.device)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` (one shape on every rank) concatenated along
        ``dim`` in rank order, on ``t``'s device."""
        if self.group is None:
            return t
        src = self._staged(t)
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim=dim) if src.dim() else torch.stack(parts)
        if t.dtype == torch.bool:
            out = out.view(torch.bool)
        return out.to(t.device)

    def all_gather_ragged(self, t: torch.Tensor, counts: Sequence[int],
                          dim: int = 0) -> torch.Tensor:
        """Rank r's ``t`` holds ``counts[r]`` rows along ``dim``
        (``counts`` the same list on every rank): each is padded to the
        longest, gathered, cut back and concatenated in rank order."""
        if self.group is None:
            return t
        width = max(counts)
        if width == 0:
            return t
        t = t.movedim(dim, 0)
        pad = width - t.shape[0]
        if pad:
            t = torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
        full = self.all_gather(t)
        return torch.cat([full[r * width:r * width + c]
                          for r, c in enumerate(counts)]).movedim(0, dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0,
                       counts: Optional[Sequence[int]] = None
                       ) -> torch.Tensor:
        """This rank's block along ``dim`` of the elementwise sum of every
        rank's ``t`` (one shape on every rank): ``counts[r]`` rows for rank
        r (the same list on every rank), by default ``block``'s ceil(n /
        world) rows a rank, the last ones shorter.  NCCL sums and scatters
        equal blocks in one ``reduce_scatter_tensor``; gloo, and ragged
        blocks, sum whole (``all_reduce``) and cut."""
        if self.group is None:
            return t
        dim = dim % t.dim()
        n = t.shape[dim]
        if counts is None:
            counts = [hi - lo for lo, hi in (block(n, self.world, r)
                                             for r in range(self.world))]
        lo = sum(counts[:self.rank])
        if self.backend == "nccl" and len(set(counts)) == 1:
            src = self._staged(t.movedim(dim, 0))
            out = src.new_empty((counts[0],) + src.shape[1:])
            dist.reduce_scatter_tensor(out, src, group=self.group)
            return out.movedim(0, dim).to(t.device)
        src = self._staged(t)
        if src is t:
            src = t.clone()
        dist.all_reduce(src, group=self.group)
        # the block cut on the host: only it goes back to a card
        return src.narrow(dim, lo, counts[self.rank]).to(t.device)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The elementwise ``"sum"`` or ``"max"`` of every rank's ``t``
        (one shape on every rank), on ``t``'s device; every rank gets the
        same bits."""
        if self.group is None:
            return t
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
        if op not in ops:
            raise ValueError(f"all_reduce: unknown op {op!r}")
        src = self._staged(t)
        if src is t:
            src = t.clone()
        dist.all_reduce(src, op=ops[op], group=self.group)
        return src.to(t.device)

    def all_ok(self, ok: bool) -> bool:
        """True when every rank passes True: the flag a driver posts
        before each gather, so that a rank that raised makes every rank
        raise rather than wait at the gather."""
        if self.group is None:
            return bool(ok)
        flag = torch.tensor([1 if ok else 0], dtype=torch.int32)
        if self.backend == "nccl":
            flag = flag.to(self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.group)
        return bool(flag.item())


def block(n: int, parts: int, index: int) -> Tuple[int, int]:
    """[lo, hi) of block ``index`` when ``n`` items go in ``parts`` blocks
    of ceil(n / parts), the last ones shorter (or empty)."""
    size = -(-n // parts)
    lo = min(n, index * size)
    return lo, min(n, lo + size)


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank_device(device: "str | torch.device | None") -> torch.device:
    """This process's device: ``cuda:{LOCAL_RANK}`` (modulo the cards
    there are, so that gloo ranks may share one card) unless ``device``
    names the CPU or an index."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank() % torch.cuda.device_count())
    return dev


def _init_from_env(dev: torch.device) -> None:
    """Set up the default process group from ``torchrun``'s environment
    (``env://``): NCCL for a card, gloo for the CPU."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            device_id=dev if dev.type == "cuda" else None)


def make_mesh(axis: str, device: "str | torch.device | None" = None
              ) -> Mesh:
    """The 1-D ``axis`` mesh over the default process group (set up from
    ``torchrun``'s environment when there is one and it is not up yet), or
    a world of one when there is none.  ``device``: the card by default
    (``cuda:{LOCAL_RANK}``); ``"cpu"`` for gloo ranks on the host."""
    if axis not in AXES:
        raise ValueError(f"unknown mesh axis {axis!r}; choose from {AXES}")
    dev = rank_device(device)
    _init_from_env(dev)
    if not dist.is_initialized():
        return Mesh(axis, None, 0, 1, dev)
    group = dist.group.WORLD
    backend = dist.get_backend(group)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL process group needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(axis, group, dist.get_rank(group), dist.get_world_size(group),
                dev)


def fleet_mesh(device: "str | torch.device | None" = None) -> Mesh:
    """The ``("fleet",)`` mesh: each rank runs a block of the seeds."""
    return make_mesh("fleet", device)


def client_mesh(device: "str | torch.device | None" = None) -> Mesh:
    """The ``("clients",)`` mesh: each rank holds a block of the clients'
    rows."""
    return make_mesh("clients", device)


# ---------------------------------------------------------------------------
# spawn: W processes joined by a file:// rendezvous
# ---------------------------------------------------------------------------

def _child(index: int, fn: Callable, world: int, backend: str, device: str,
           init_file: str, out_dir: str, args: tuple) -> None:
    os.environ["LOCAL_RANK"] = str(index)
    os.environ["RANK"] = str(index)
    if device == "cpu":
        torch.set_num_threads(1)
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=index, world_size=world,
                            timeout=datetime.timedelta(minutes=10))
    try:
        result = fn(*args)
        with open(os.path.join(out_dir, f"rank{index}.pkl"), "wb") as fh:
            pickle.dump(result, fh)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{index}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *, backend: str = "nccl",
          device: str = "cuda", init_file: Optional[str] = None,
          args: tuple = (), timeout_s: Optional[float] = None) -> List[Any]:
    """Run ``fn(*args)`` in ``world`` new processes (the ``spawn`` start
    method), process r with ``LOCAL_RANK=r``, in a default process group
    of ``backend`` joined through the file ``init_file`` (a fresh one in
    a temporary directory by default; it must not exist yet); returns
    each rank's return value (picklable), in rank order.  ``device``:
    ``"cuda"`` (child r on card r modulo the cards there are) or
    ``"cpu"`` (with ``backend="gloo"``; each child then holds torch to
    one thread).  A child that raises
    stops the others and ``RuntimeError`` is raised here with the
    traceback of every rank that raised (the first to fail is usually
    not the first rank: the others then lose their peer); past
    ``timeout_s`` every child is stopped and ``TimeoutError`` raised."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    tmp = tempfile.mkdtemp(prefix="repro-spawn-")
    try:
        init = init_file or os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(
            _child, args=(fn, world, backend, str(device), init, tmp, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=0.5):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"spawn: {world} ranks still running "
                                       f"after {timeout_s} s")
        except ProcessException as exc:
            errs = [f"-- rank {r}:\n" + open(path).read()
                    for r in range(world)
                    if os.path.exists(path := os.path.join(tmp,
                                                           f"rank{r}.err"))]
            raise RuntimeError("spawn: a rank failed\n" + "\n".join(errs)
                               ) from exc
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

"""Build every ``csrc/*.cu`` with nvcc into one library; load it with ctypes.

Each source is compiled to an object by its own nvcc process, all started
together, and one more nvcc call links the objects into one shared
library: the build takes as long as the slowest source rather than the
sum of all, which keeps ``chip_smoke.py`` inside its time limit as
sources are added (one nvcc given every source compiles them one after
another).  The build goes at first use into the checkout's ``build/``
directory (which git ignores), named by a hash of all the sources and the
flags, so an edited source never loads a stale build.  The C entry points
take raw device pointers and the CUDA stream as ``c_void_p``, sizes as
``c_int`` and scalars as ``c_float``; each returns a CUDA error code
(``cudaGetLastError()`` after a launch).  Processes that start
together (the ranks of a mesh) take a file lock around the build, so one
of them compiles and the others load its library.

Also here, for the wrappers of every kernel module: ``ptr``, ``stream``,
``on``, ``require`` and the shared-memory limit ``MAX_SMEM_BYTES``.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the most dynamic shared memory one block may use on the H100
MAX_SMEM_BYTES = 232_448

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "hfl_score_rows": [_P, _P, _P, _P, _P, _P, _I, _P],
    "hfl_score_fused": [_P] * 7 + [_I, _P, _I, _I, _I, _I, _F, _P],
    "hfl_sic_rates": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
    "hfl_local_sgd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _F, _F, _I, _P],
    "hfl_local_sgd_cluster": [_P] * 14 + [_I] * 7 + [_F, _F, _I, _P],
    "hfl_sgd_max_active_clusters": [_I] * 7 + [ctypes.POINTER(_I)],
    "seq_flash_attention": [_P, _P, _P, _P] + [_I] * 11 + [_F, _I, _I, _P],
    "seq_flash_attention_wgmma": [_P, _P, _P, _P] + [_I] * 11 + [_F, _I, _P],
    "seq_linear_recurrence": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
}


class BuildError(RuntimeError):
    """The kernels did not build: no nvcc, or nvcc failed."""


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path          # the shared library
    seconds: float      # nvcc wall time (0.0 when an existing build was used)
    log: str            # nvcc's output: ptxas registers / shared memory


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise BuildError("nvcc not found: the CUDA kernels are built on a "
                     "machine with the CUDA toolkit (set CUDA_HOME)")


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise with the output of any that
    fails, return all their output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [(c, p.returncode, out) for c, p, out in zip(cmds, procs, outs)
              if p.returncode != 0]
    if failed:
        raise BuildError("nvcc failed:\n" + "\n".join(
            f"$ {' '.join(c)}\n(exit {rc})\n{out}" for c, rc, out in failed))
    return "".join(outs)


@functools.cache
def build() -> BuildInfo:
    """Compile the kernels once per process (and once per source hash on
    disk).  Raises with nvcc's output if the build fails."""
    srcs = sources()
    digest = hashlib.sha256(
        b"".join(s.name.encode() + s.read_bytes() for s in srcs)
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    target = BUILD_DIR / f"repro_kernels-{digest}.so"
    if target.exists():
        return BuildInfo(target, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".lock-{digest}", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():         # another process built it meanwhile
            return BuildInfo(target, 0.0, "")
        return _compile(srcs, digest, target)


def _compile(srcs: list[Path], digest: str, target: Path) -> BuildInfo:
    nvcc = _nvcc()
    tag = f"{digest}.{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}-{tag}.o" for s in srcs]
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                        for s, o in zip(srcs, objs)])
        log += _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                          "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, target)
    return BuildInfo(target, seconds, log)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's argtypes set."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.hfl_error_string.argtypes = [ctypes.c_int]
    lib.hfl_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, kernel: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = library().hfl_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA error {code}: {msg}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def on(device: torch.device):
    """Make ``device`` current for a launch: a no-op where it already is
    (the usual case, and the cheaper one on the host), else
    ``torch.cuda.device``."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream(device: torch.device) -> ctypes.c_void_p:
    """The current CUDA stream of ``device`` as a raw handle -- what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building a ``Stream`` object on the host each launch.  It reads the
    private binding ``torch._C._cuda_getCurrentRawStream``, checked against
    torch 2.11.0+cu128; ``tests/test_torch_cuda.py`` holds it to the public
    handle on a side stream, so a torch that changes it fails there."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(index))


def require(t: torch.Tensor, name: str, device: torch.device,
            dtype: torch.dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous tensor of this device, dtype and
    shape -- what a kernel entry point takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")

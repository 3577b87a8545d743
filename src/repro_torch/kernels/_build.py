"""Build ``csrc/hfl_ops.cu`` with nvcc and load it with ctypes.

The library is compiled at first use into the checkout's ``build/``
directory (which git ignores), named by a hash of the source and the
flags so an edited source never loads a stale build.  The C entry points
take raw device pointers and the CUDA stream as ``c_void_p``, sizes as
``c_int`` and scalars as ``c_float``; each returns ``cudaGetLastError()``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "hfl_ops.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "hfl_score_rows": [_P, _P, _P, _P, _P, _P, _I, _P],
    "hfl_sic_rates": [_P, _P, _P, _P, _I, _I, _F, _F, _P],
    "hfl_local_sgd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _F, _F, _I, _P],
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path          # the shared library
    seconds: float      # nvcc wall time (0.0 when an existing build was used)
    log: str            # nvcc's output: ptxas registers / shared memory


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


@functools.cache
def build() -> BuildInfo:
    """Compile the kernels once per process (and once per source hash on
    disk).  Raises with nvcc's output if the build fails."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    target = BUILD_DIR / f"hfl_ops-{digest}.so"
    if target.exists():
        return BuildInfo(target, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
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

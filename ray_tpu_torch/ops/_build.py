"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/<name>-<hash>.so``: a shared library
with a plain C interface, compiled for ``sm_90a`` by nvcc at first use. The
hash covers the source, every header beside it (``csrc/*.cuh``) and the
flags, so a stale library is never loaded after an edit to any of them.
A lock file in the build directory guards concurrent builds (several test
or training processes starting at once). No PyTorch header is compiled,
which keeps a build to seconds.

Nothing here is imported or run at import time of the kernels' modules:
the CPU has no nvcc, and the wrappers only load a library for a CUDA
tensor.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from contextlib import contextmanager
from pathlib import Path
from typing import Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME  # CUDA_HOME/CUDA_PATH or the usual install

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the port's kernels need the CUDA toolkit")


def _flags(defines: Tuple[str, ...]) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """Where ``build`` puts the library of ``csrc/<name>.cu`` compiled with
    the macro definitions ``defines`` ("NAME=VALUE"; the tile sweep's
    overrides, none in use)."""
    cu = CSRC / f"{name}.cu"
    if not cu.exists():
        raise FileNotFoundError(cu)
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for src in [cu, *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


@contextmanager
def _build_lock():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` unless it is built already; returns the
    library's path. The compiler's output (registers, shared memory and
    spills per kernel) is kept beside the library as ``<lib>.log``."""
    path = library_path(name, defines)
    with _build_lock():
        if path.exists():
            return path
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        proc = subprocess.run([_nvcc(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        Path(f"{path}.log").write_text(proc.stdout)
        if proc.returncode != 0:
            raise RuntimeError(f"kernel build of {name} failed (nvcc exit {proc.returncode}):\n"
                               f"{proc.stdout}")
        os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    return ctypes.CDLL(str(build(name, defines)))


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (cudaGetLastError()).
    Every kernel library exports ``rt_cuda_error_string``."""
    if status != 0:
        fn = lib.rt_cuda_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {status} ({fn(status).decode()})")

"""Build the port's CUDA kernels and load them with ctypes.

Every `csrc/*.cu` file is compiled by `nvcc` for `sm_90a` into one shared
library with a plain C interface, at first use, into `csrc/build/` (listed in
`.gitignore`). The sources compile in parallel, one `nvcc` each, all started
together, and are then linked into the library. The library's name carries a
hash of the sources and flags, so an edited source builds anew and a stale
library is never loaded. Nothing here runs at import: the CPU tests import
every module and have no `nvcc`.

Each C entry point takes device pointers, sizes, scalars and a stream,
launches on that stream and returns `cudaGetLastError()`; `kernel()` hands out
the ctypes function with its argument types declared, and `check()` raises on
a non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills, kept in <library>.log
)

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's build (0 if cached)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libcmw_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> tuple[list[str], list[str]]:
    """Run the commands in parallel; wait for every one. Returns (logs, failures)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{logs[-1]}")
    return logs, failed


def _build() -> Path:
    global build_seconds
    so = _library_path()
    if so.exists():
        build_seconds = 0.0
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources()]
    t0 = time.perf_counter()
    try:
        logs, failed = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(sources(), objs)])
        if not failed:
            link_logs, failed = _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
            logs += link_logs
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("\n".join(failed))
    so.with_suffix(".log").write_text("\n".join(logs))
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use in this process."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(_build()))
    return _lib


@functools.cache
def kernel(name: str, n_ptrs: int, n_ints: int, n_floats: int = 0, n_doubles: int = 0):
    """C entry `name(ptr * n_ptrs, int * n_ints, float * n_floats, double *
    n_doubles, stream) -> int` (looked up once per process)."""
    fn = getattr(library(), name)
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_float] * n_floats
        + [ctypes.c_double] * n_doubles + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def check(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {code}")

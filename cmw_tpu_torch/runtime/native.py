"""ctypes bindings for the native runtime (native/cmw_runtime.cpp).

Gives Python the reference's System-layer primitives: a periodic multi-rate
scheduler with barrier start, deadline telemetry, quit-signal handling, a
scalable virtual clock, and latest-wins mailboxes. A copy of
`cmw_tpu/runtime/native.py` (no array library in it) for the PyTorch
package, which may not import the JAX one.

The library is the `native/Makefile` target, built with g++ from
`native/cmw_runtime.cpp` (two levels up from this file, as in the JAX
package). Each process builds it once, into a directory of its own under
the temporary directory, and loads it from there: the JAX package's loader
writes `native/libcmw_runtime.so` in place, so a process that loaded that
file while another one built it could read half a library. Nothing under
`native/` is written.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_lock = threading.Lock()
_lib = None

TASK_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_double)


def _build_and_load() -> ctypes.CDLL:
    """native/Makefile's target built in a fresh directory from a copy of
    the source, loaded, then the directory removed: the loaded library
    stays mapped."""
    out = tempfile.mkdtemp(prefix="cmw_runtime_")
    try:
        shutil.copy(os.path.join(_DIR, "cmw_runtime.cpp"), out)
        subprocess.run(["make", "-s", "-C", out, "-f", os.path.abspath(os.path.join(_DIR, "Makefile"))], check=True)
        return ctypes.CDLL(os.path.join(out, "libcmw_runtime.so"))
    finally:
        shutil.rmtree(out, ignore_errors=True)


def lib():
    global _lib
    with _lock:
        if _lib is None:
            L = _build_and_load()
            L.cmw_scheduler_new.restype = ctypes.c_void_p
            L.cmw_scheduler_free.argtypes = [ctypes.c_void_p]
            L.cmw_add_task.restype = ctypes.c_int
            L.cmw_add_task.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p,
                ctypes.c_double,
                TASK_FN,
                ctypes.c_void_p,
            ]
            for f in ("cmw_start", "cmw_request_stop", "cmw_join", "cmw_handle_quit_signals"):
                getattr(L, f).argtypes = [ctypes.c_void_p]
            for f in ("cmw_is_running", "cmw_any_failed"):
                getattr(L, f).restype = ctypes.c_int
                getattr(L, f).argtypes = [ctypes.c_void_p]
            L.cmw_task_stats.argtypes = [
                ctypes.c_void_p,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
            ]
            L.cmw_clock_now.restype = ctypes.c_double
            L.cmw_clock_now.argtypes = [ctypes.c_void_p]
            L.cmw_clock_set_scale.argtypes = [ctypes.c_void_p, ctypes.c_double]
            L.cmw_mailbox_new.restype = ctypes.c_void_p
            L.cmw_mailbox_free.argtypes = [ctypes.c_void_p]
            L.cmw_mailbox_write.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_uint64,
            ]
            L.cmw_mailbox_read.restype = ctypes.c_uint64
            L.cmw_mailbox_read.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint64),
            ]
            _lib = L
    return _lib


class Mailbox:
    """Latest-wins byte mailbox (the reference's SharedResource<T>)."""

    def __init__(self):
        self._L = lib()
        self._h = self._L.cmw_mailbox_new()

    def write(self, data: bytes):
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        self._L.cmw_mailbox_write(self._h, buf, len(data))

    def read(self, cap: int = 1 << 16):
        out = (ctypes.c_uint8 * cap)()
        ln = ctypes.c_uint64()
        seq = self._L.cmw_mailbox_read(self._h, out, cap, ctypes.byref(ln))
        return int(seq), bytes(out[: ln.value])

    def __del__(self):
        try:
            self._L.cmw_mailbox_free(self._h)
        except Exception:
            pass


class Scheduler:
    """Multi-rate periodic scheduler (the reference's AdvanceableRunner set,
    Main.cpp:75-160): add python callables as periodic tasks, start with a
    shared barrier, poll liveness, read deadline telemetry."""

    def __init__(self):
        self._L = lib()
        self._h = self._L.cmw_scheduler_new()
        self._cbs = []  # keep CFUNCTYPE objects alive

    def add_task(self, name: str, period_s: float, fn) -> int:
        """fn(t_virtual: float) -> bool (False stops the pipeline)."""

        @TASK_FN
        def cb(_user, t):
            try:
                ok = fn(t)
                return 0 if (ok is None or ok) else 1
            except Exception:
                return 1

        self._cbs.append(cb)
        return self._L.cmw_add_task(self._h, name.encode(), period_s, cb, None)

    def start(self):
        self._L.cmw_start(self._h)

    def request_stop(self):
        self._L.cmw_request_stop(self._h)

    def join(self):
        self._L.cmw_join(self._h)

    def is_running(self) -> bool:
        return bool(self._L.cmw_is_running(self._h))

    def any_failed(self) -> bool:
        return bool(self._L.cmw_any_failed(self._h))

    def handle_quit_signals(self):
        self._L.cmw_handle_quit_signals(self._h)

    def clock_now(self) -> float:
        return self._L.cmw_clock_now(self._h)

    def set_time_scale(self, scale: float):
        """real_time_factor analog (worlds/*/world:7)."""
        self._L.cmw_clock_set_scale(self._h, scale)

    def task_stats(self, task: int) -> dict:
        runs = ctypes.c_uint64()
        misses = ctypes.c_uint64()
        mean_ms = ctypes.c_double()
        max_ms = ctypes.c_double()
        self._L.cmw_task_stats(
            self._h, task, ctypes.byref(runs), ctypes.byref(misses),
            ctypes.byref(mean_ms), ctypes.byref(max_ms),
        )
        return {
            "runs": runs.value,
            "deadline_misses": misses.value,
            "mean_exec_ms": mean_ms.value,
            "max_exec_ms": max_ms.value,
        }

    def __del__(self):
        try:
            self._L.cmw_request_stop(self._h)
            self._L.cmw_join(self._h)
            self._L.cmw_scheduler_free(self._h)
        except Exception:
            pass

"""Shared pieces of every cell: statistics, the comparison's gaps, the
conversion of the program's state into the reference's, seeded sampling and
what `nvidia-smi` reads beside the window."""

from __future__ import annotations

import math
import random
import subprocess

import torch


# --- statistics -------------------------------------------------------------

def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of values, linearly interpolated between
    the order statistics (numpy's default); nan for no values."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_seconds(intervals) -> float:
    """Seconds covered by the union of [(start, end)] intervals (any unit in,
    the same unit out)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_share(busy: float, wall: float) -> float | None:
    """1 - busy / wall, in %, or None where nothing was measured."""
    if not wall or wall <= 0 or busy is None:
        return None
    return 100.0 * (1.0 - busy / wall)


def finite_or_none(x):
    """x as a float, or None where it is not finite (the last line writes
    null, never NaN)."""
    if x is None:
        return None
    x = float(x)
    return x if math.isfinite(x) else None


# --- seeded sampling --------------------------------------------------------

class Reservoir:
    """k items drawn uniformly from a stream of unknown length (algorithm R),
    the draws from `seed`: the same seed and stream keep the same items."""

    def __init__(self, k: int, seed: int):
        self.k, self.n, self.items = k, 0, []
        self._rng = random.Random(seed)

    def offer(self, make):
        """Count one more item; keep make() if it is drawn. make is called
        only for a kept item, so an item not kept costs nothing."""
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = self._rng.randrange(self.n)
            if j < self.k:
                self.items[j] = make()


# --- the comparison ---------------------------------------------------------

_REFERENCE_MODULES = ("runtime.loop", "cmpc.solver", "cmpc.qp", "cmpc.formulation", "core.contacts",
                      "mann.generator", "mann.input_builder", "mann.network", "sim.plant", "sim.rigid_body",
                      "estimation.legged_odom", "estimation.fixed_foot", "wbc.swing_foot", "wbc.diff_ik")


def reference_types() -> dict:
    """The reference's NamedTuple classes by name."""
    import importlib

    types = {}
    for m in _REFERENCE_MODULES:
        for v in vars(importlib.import_module(f"portbench.reference.{m}")).values():
            if isinstance(v, type) and issubclass(v, tuple) and hasattr(v, "_fields"):
                types[v.__name__] = v
    return types


def convert(obj, types: dict, device=None):
    """The program's `obj` in the reference's types (`reference_types()`):
    each NamedTuple as the reference's class of the same name, each of its
    fields taken by name from obj, recursively; tensors as they are, or
    moved to `device` where it is given, and other leaves as they are. A
    field the program lacks raises AttributeError (the reference's structure
    is frozen; the program's may grow)."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        cls = types[type(obj).__name__]
        return cls(*(convert(getattr(obj, f), types, device) for f in cls._fields))
    if isinstance(obj, tuple):
        return tuple(convert(o, types, device) for o in obj)
    if device is not None and isinstance(obj, torch.Tensor):
        return obj.to(device)
    return obj


def leaves(tree, prefix=""):
    """[(path, tensor)] of a (nested) NamedTuple's tensor leaves."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or [str(i) for i in range(len(tree))]
        out = []
        for name, sub in zip(names, tree):
            out += leaves(sub, f"{prefix}.{name}" if prefix else name)
        return out
    return []


def leaf_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max(1, max |want|): absolute below 1, relative
    above; inf where got is not finite where want is, or shapes differ."""
    if got.shape != want.shape:
        return math.inf
    g, w = got.to(want.device).double(), want.double()
    ok = torch.isfinite(w)
    if g.numel() == 0 or not bool(ok.any()):
        return 0.0
    if not bool(torch.isfinite(g[ok]).all()):
        return math.inf
    return float((g[ok] - w[ok]).abs().max()) / max(1.0, float(w[ok].abs().max()))


def compare_trees(got, want):
    """(largest gap of the floating leaves, its path, number of discrete
    (integer, bool) elements that differ) of the program's `got` against the
    reference's `want`, leaf by leaf over want's fields (by name)."""
    worst, where, mismatched = 0.0, "", 0
    got_leaves = dict(leaves(got))
    for path, w in leaves(want):
        g = got_leaves.get(path)
        if g is None:
            return math.inf, f"{path} (missing)", mismatched
        g = g.to(w.device)
        if w.dtype.is_floating_point:
            gap = leaf_gap(g, w)
            if not gap <= worst:
                worst, where = gap, path
        elif g.shape != w.shape:
            mismatched += w.numel()
        else:
            mismatched += int((g != w).sum())
    return worst, where, mismatched


# --- the card ---------------------------------------------------------------

def sync_read(t: torch.Tensor):
    """The tensor on the host: waits for the card."""
    return t.detach().cpu()


def nvidia_smi() -> str:
    """The card's name, power limit, SM clock, power draw and temperature, as
    nvidia-smi reads them now; "" where it cannot be run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else ""


class tf32:
    """Float32 products in TF32 on the card (on) or in full float32 (off)
    inside the block, the flags restored after it: the reference runs with
    TF32 off, its control with TF32 on."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


class reference_place:
    """Where the reference runs after the window, as `with
    reference_place(cell) as device:`. A run puts it on the cell's device
    with cuSOLVER's linalg, as the program's; `cell.reference_on` moves it
    to the CPU ("cpu") or to MAGMA's linalg on the card ("magma"), two sound
    changes of rounding that portbench/tests measure against the limits."""

    def __init__(self, cell):
        self.on, self.device = cell.reference_on, "cpu" if cell.reference_on == "cpu" else cell.device

    def __enter__(self):
        if self.on == "magma":
            torch.backends.cuda.preferred_linalg_library("magma")
        return self.device

    def __exit__(self, *exc):
        if self.on == "magma":
            torch.backends.cuda.preferred_linalg_library("cusolver")


def device_info(device: str, count: int = 1) -> dict:
    """The result's `device`: platform, the card's name, cards used, and the
    peak of allocated memory (read now)."""
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def capture_seconds(cell) -> float | None:
    """Seconds the program's graph cache (`runtime/cache.py`) spent on
    warm-up, capture and instantiation, summed over its entries; None off
    the card or for the control (no program)."""
    if cell.device == "cpu" or cell.control:
        return None
    from cmw_tpu_torch.runtime import cache

    return sum(e.capture_s for e in cache.entries().values())

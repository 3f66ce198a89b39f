"""In-process cache of captured CUDA graphs: the port's compiled dispatch.

Counterpart of `cmw_tpu/runtime/cache.py`. JAX compiles the system's hot
paths (`jax.jit` of the solve, `lax.scan` of the plant's substeps and of the
closed loop) and caches the executables, in memory per process and, through
that module, on disk. Both halves have a counterpart here:

  - on disk, what is compiled: `ops/_build.py`'s shared library of the
    hand-written kernels, named by a hash of the sources and flags
    (`csrc/build/libcmw_kernels_<hash>.so`), built once and reused;
  - in memory, the programs: this module. A shape-static function of
    tensors is captured once per key into a `torch.cuda.CUDAGraph` and from
    then on replayed as one dispatch, as a jitted function is traced once
    per signature and then run as one executable.

`graphed(owner, fn, *args)` runs `fn(*args)`. The args are pytrees
(NamedTuples, tuples) of tensors; other leaves (None, numbers) are static.
The key is `owner`, a hashable value that names the computation and the
static values it closes over, plus every tensor leaf's shape, dtype and
device and the values of the static leaves, as JAX keys its jit cache by
the static arguments' value and the arrays' avals. Never by `id()`: an
object that keys by identity is held in the key, so that its id cannot be
reused (see `WalkingController.__hash__`).

On a miss the call copies its inputs into static buffers (allocated outside
the graph pool), runs `fn` once on a side stream (the warm-up: lazy
initialisation, the kernels' nvcc build, cuBLAS handles, the constant caches
of `core/consts.py`), captures `fn` into a graph whose memory comes from one
pool shared by the cache, instantiates it and replays it. A key that has run
eagerly on the card since the last `clear()` (under `disable_graphs()`)
skips the warm-up: that run did the lazy initialisation. On every call the inputs are
copied into the static buffers, the graph is replayed, and the outputs that
leave are cloned: the next replay, of this graph or of another one sharing
the pool, overwrites the static outputs (callers keep every tick's
Telemetry, and warm starts chain). An output that is an input, unchanged,
is handed back as the caller's own tensor, as the eager function hands it
back. No graph relies on the pool's contents between its replays, only on
its static inputs, which lie outside the pool; but a graph's static outputs
may lie where another graph's scratch does. So one lock, shared by every
thread, is held from the copy into the inputs through the replay to the
clones (a replay releases the GIL: the real-time walker replays the solve
and the WBC stage from two threads), and each call's work waits on the card
for the last call's clones (`_done`), so that two threads on two streams
cannot overlap either. `clear()` drops every graph and the pool.

Inside a warm-up or a capture, a nested `graphed` call runs `fn` as is
(it becomes part of the outer graph), as a jitted function called inside
another traces into it.

The kernel wrappers' launch counts (`ops/spd_inverse.launches`,
`ops/symv.launches`, `ops/admm_fused.launches`,
`ops/riccati_admm.launches`, `ops/rigid_step.launches`) move only while Python runs
the wrapper. The warm-up's and the capture's moves are taken back; the
capture's are recorded with the graph and added on every replay, so a
graphed call counts what one eager call counts.

Under tracing (`runtime/trace.py`), a card call records the spans
`cache.lookup` (flatten and key), `cache.lock_wait`, `cache.copy_in`,
`cache.launch` (`graph.replay()` itself) and `cache.clone_out` under the
caller's span, and on a miss `cache.capture` with `cache.warm_up` and
`cache.instantiate` inside; a timing-event pair around each replay gives its
device time with no profiler. A graph captured with tracing on carries its
stages' marks (`trace.stage`) and counters (`Entry.traced`: replays, host ns
by span, device ns, node count, the pool's growth by its capture). A graph
captured with tracing off carries neither; off, each span site costs one
flag check.

`disable_graphs()` is the counterpart of `jax.disable_jit()`: calls inside
it run eagerly, e.g. under `torch.profiler` where the kernels should be
attributed to the eager path's own ops. On a CUDA device a capture or
replay error raises; nothing falls back to eager. On the CPU `graphed`
calls `fn` as is: there are no graphs there, and the caller asked for the
CPU.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, NamedTuple

import torch
import torch.utils._pytree as pytree

from cmw_tpu_torch.core import consts
from cmw_tpu_torch.ops import admm_fused, riccati_admm, rigid_step, spd_inverse, symv
from cmw_tpu_torch.runtime import trace

COUNTED = (spd_inverse, symv, admm_fused, riccati_admm, rigid_step)  # modules whose `launches` a graph carries
CARD = "cuda"  # the device type whose calls are captured (the CPU tests' fake card sets "cpu")

_state = threading.local()  # per thread: `disabled` depth, `inside` a warm-up or capture
_graphs: dict = {}
_warm: set = set()  # keys whose fn has run eagerly on the card since the last clear()
_pool = None
_done = None  # a CUDA event recorded after the last call's clones
_lock = threading.Lock()  # held by a card call from its lookup to its clones (captures included)


class Ident:
    """Keys an object by identity, holding it: while the key lives the
    object does, so its identity cannot pass to another object."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return type(other) is Ident and other.obj is self.obj


class Entry(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: list  # the static input buffers, one per tensor leaf
    outputs: list  # the distinct static output tensors
    layout: list  # per output leaf: ("in", i) | ("out", j) | ("static", value)
    out_spec: Any
    launches: tuple  # COUNTED's counts of one replay
    capture_s: float  # warm-up (if any) + capture + instantiation seconds
    instantiate_s: float  # the instantiation's share of capture_s
    traced: trace.GraphTrace | None  # marks and counters, for a graph captured with tracing on


def _depth(name: str) -> int:
    return getattr(_state, name, 0)


@contextlib.contextmanager
def disable_graphs():
    """Run every `graphed` call in this thread eagerly (nests)."""
    _state.disabled = _depth("disabled") + 1
    try:
        yield
    finally:
        _state.disabled -= 1


def graphs_enabled() -> bool:
    return _depth("disabled") == 0 and _depth("inside") == 0


def read_launches() -> tuple:
    return tuple(m.launches for m in COUNTED)


def _add_launches(counts) -> None:
    for m, c in zip(COUNTED, counts):
        m.launches += c


def _delta(after, before) -> tuple:
    return tuple(a - b for a, b in zip(after, before))


def _signature(leaf):
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), leaf.dtype, leaf.device)
    hash(leaf)  # a static leaf keys by value: it must be hashable
    return ("static", leaf)


def entries() -> dict:
    """The cache: key -> Entry (read-only use: phase reports, tests)."""
    return _graphs


def pool_bytes() -> int:
    """Bytes of device memory the shared graph pool holds (its segments in
    the caching allocator's snapshot); the pool only grows while graphs
    live, so this is also its peak."""
    if _pool is None:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(_pool))


def _record(graph, fn: Callable, static_args):
    """Capture fn on the static inputs into graph (thread_local: another
    thread's calls, e.g. the real-time walker's other task, do not break
    it); returns the static outputs."""
    with torch.cuda.graph(graph, pool=_pool, capture_error_mode="thread_local"):
        return fn(*static_args)


def _capture(owner, fn: Callable, leaves: list, spec, device: torch.device, warm: bool) -> Entry:
    global _pool
    pool_before = pool_bytes() if trace.enabled() else 0
    t0 = time.perf_counter()
    tensors = [leaf for leaf in leaves if isinstance(leaf, torch.Tensor)]
    inputs = [torch.empty(t.shape, dtype=t.dtype, device=device) for t in tensors]
    torch._foreach_copy_(inputs, tensors)
    it = iter(inputs)
    static_args = pytree.tree_unflatten([next(it) if isinstance(x, torch.Tensor) else x for x in leaves], spec)
    if _pool is None:
        _pool = torch.cuda.graph_pool_handle()
    before = read_launches()
    _state.inside = _depth("inside") + 1
    try:
        if not warm:
            with trace.span("cache.warm_up"):
                side = torch.cuda.Stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    fn(*static_args)
                torch.cuda.current_stream(device).wait_stream(side)
        mid = read_launches()
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # instantiated below, timed apart from the capture
        with trace.marking() as marks:
            out = _record(graph, fn, static_args)
        after = read_launches()
    finally:
        _state.inside -= 1
    t_inst = time.perf_counter()
    with trace.span("cache.instantiate"):
        graph.instantiate()
    instantiate_s = time.perf_counter() - t_inst
    capture_s = time.perf_counter() - t0
    _add_launches(_delta(before, after))  # the warm-up and the capture ran nothing for the caller
    out_leaves, out_spec = pytree.tree_flatten(out)
    by_id = {id(t): i for i, t in enumerate(inputs)}
    outputs, layout, seen = [], [], {}
    for leaf in out_leaves:
        if not isinstance(leaf, torch.Tensor):
            layout.append(("static", leaf))
        elif id(leaf) in by_id:
            layout.append(("in", by_id[id(leaf)]))
        else:
            if id(leaf) not in seen:
                seen[id(leaf)] = len(outputs)
                outputs.append(leaf)
            layout.append(("out", seen[id(leaf)]))
    traced = None
    if marks is not None:
        name = owner[0] if isinstance(owner, tuple) and owner and isinstance(owner[0], str) else repr(owner)
        pool = pool_bytes()
        traced = trace.GraphTrace(name, marks, trace.graph_nodes(graph), pool, pool - pool_before)
    return Entry(graph, inputs, outputs, layout, out_spec, _delta(after, mid), capture_s, instantiate_s, traced)


def _key(owner, leaves: list, spec):
    return (owner, spec, tuple(_signature(leaf) for leaf in leaves))


def signature(tree):
    """A pytree's structure with each tensor leaf's shape, dtype and device
    and each other leaf's value: what it adds to a key."""
    leaves, spec = pytree.tree_flatten(tree)
    return spec, tuple(_signature(leaf) for leaf in leaves)


def _on_card(tensors: list) -> bool:
    return graphs_enabled() and any(t.device.type == CARD for t in tensors)


def replays(*args) -> bool:
    """Whether `graphed(owner, fn, *args)` goes through a graph (graphs on
    in this thread and a tensor on the card) rather than calling fn."""
    return _on_card([leaf for leaf in pytree.tree_leaves(args) if isinstance(leaf, torch.Tensor)])


def key(owner, *args):
    """The cache key of `graphed(owner, fn, *args)`."""
    return _key(owner, *pytree.tree_flatten(args))


def lookup(owner, *args) -> Entry | None:
    """The captured graph `graphed(owner, fn, *args)` would replay, if any."""
    with _lock:
        return _graphs.get(key(owner, *args))


def graphed(owner, fn: Callable, *args):
    """fn(*args) through the graph cache (see the module docstring). `owner`
    is a hashable value that, with the inputs' signatures, fixes what fn
    computes."""
    global _done
    with trace.span("cache.lookup") as lookup:
        leaves, spec = pytree.tree_flatten(args)
        tensors = [leaf for leaf in leaves if isinstance(leaf, torch.Tensor)]
        card = _on_card(tensors)
        if card:
            devices = {t.device for t in tensors}
            if len(devices) != 1:
                raise ValueError(f"graphed {owner!r}: tensors on {sorted(map(str, devices))}, expected one {CARD} "
                                 "device")
            device = next(iter(devices))
            k = _key(owner, leaves, spec)
    if not card:
        if _depth("disabled") and not _depth("inside") and any(t.device.type == CARD for t in tensors):
            _warm.add(_key(owner, leaves, spec))  # an eager run on the card: the lazy initialisation is done
        return fn(*args)  # no graphs off the card (and none without a tensor)
    with trace.span("cache.lock_wait") as wait:
        _lock.acquire()
    try:
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device)
            entry, copy = _graphs.get(k), trace.OFF
            if entry is None:
                if _done is not None:
                    stream.wait_event(_done)
                with trace.span("cache.capture"):
                    entry = _graphs[k] = _capture(owner, fn, leaves, spec, device, k in _warm)
            else:
                with trace.span("cache.copy_in") as copy:
                    if _done is not None:
                        stream.wait_event(_done)
                    torch._foreach_copy_(entry.inputs, tensors)
            with trace.replay(entry.traced, stream), trace.span("cache.launch") as launch:
                entry.graph.replay()
            _add_launches(entry.launches)
            with trace.span("cache.clone_out") as clone:
                outs = [t.clone() for t in entry.outputs]
                _done = torch.cuda.Event()
                _done.record(stream)
    finally:
        _lock.release()
    trace.count(entry.traced, lookup, wait, copy, launch, clone)
    parts = [tensors[v] if kind == "in" else outs[v] if kind == "out" else v for kind, v in entry.layout]
    return pytree.tree_unflatten(parts, entry.out_spec)


def clear() -> None:
    """Drop every captured graph, the shared pool and the constants the
    graphs read (`core/consts.py`), and hand the pool's memory back to the
    card. Callers that are done with a configuration call it (the sweep CLI
    after each arm, the breakdown after each solver configuration): each key
    holds its graph, and the owner it keys by, for the life of the process."""
    global _pool, _done
    with _lock:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        _graphs.clear()
        _warm.clear()
        _pool = _done = None
        consts.clear()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()

"""The port's tracing: host spans, stage marks that ride inside captured
CUDA graphs, and the graph cache's counters.

Every hot path of the port replays a cached CUDA graph (`runtime/cache.py`),
and a replay runs no Python: a `torch.profiler.record_function` range inside
the captured code exists only while the graph is captured. This module gives
the program spans that survive the replay. One on/off state for the process,
off by default:

  - `span(name, rid=None)`: a host span. On close it keeps its id, its
    parent's id (the span open around it in this thread, 0 for none), its
    name, its request id and its start and end in a bounded buffer. The
    request id is given where a request starts (`WalkingController.step`:
    the tick; `_periods`: the period's count in the process;
    `apps.bench.chain`: the call's count) and inherited by every span
    inside. While a torch.profiler session runs, the span also opens a
    `record_function` range of its name, so that the profiler's trace names
    the program's spans.
  - `stage(name)`: a span that, inside a `cache.graphed` capture made while
    tracing is on, also captures a pair of timing events
    (`torch.cuda.Event(enable_timing=True, external=True)`) as event-record
    nodes around its work, so that every replay of the graph carries the
    stage's device marks. The stages are the loop's (`mann`, `mpc.solve`,
    `wbc.plant`, `wbc.estimation`, `wbc.ik`) and the solve's (`mpc.factor`,
    `mpc.linearize`, `mpc.admm`, `mpc.line_search`).
  - `replay(graph, stream)`: around a replay in `cache.graphed` (a graph
    captured with tracing on): a pair of timing events around the replay on
    the stream, the replay's device span with no profiler.
  - `collect()`: the spans and resolved replays recorded since the last
    collect (`Trace`), handed over and forgotten.

The clock: spans are stamped with `time.time_ns()` (CLOCK_REALTIME), the
clock torch.profiler stamps its events with (c10's `getTime`;
`tests/test_torch_trace.py` holds a span against a profiler session's
`start_ns`). Device times go on it through an anchor event recorded right
after a read of that clock with the card idle: an event's time is the
anchor's plus `anchor.elapsed_time(event)`. `collect()` re-anchors. A
replay's marks are overwritten by the graph's next replay, so each replay is
resolved (its events read) before the next replay of the same graph, after
waiting for it on the host where the caller has not already read its
results, and by `collect()`: tracing waits for the card, and only tracing.

`enable()` must precede the first capture: it raises while the cache holds
graphs, which would replay without marks. A graph captured with tracing off
carries no marks and no counters, so an untraced process replays the same
graphs as before tracing existed. Off, `span` and `stage` cost one flag
check each: they hand back one shared no-op context manager, with no
allocation and no C++ call.
"""

from __future__ import annotations

import collections
import ctypes
import itertools
import threading
import time
from typing import NamedTuple

import torch

SPAN_CAP = 1 << 17  # spans kept between two collect() calls (the oldest go first)
REPLAY_CAP = 1 << 15  # resolved replays kept between two collect() calls

_on = False
_tls = threading.local()  # per thread: `stack` of open spans; `marks` / `open_marks` of the capture under way
_spans: collections.deque = collections.deque(maxlen=SPAN_CAP)
_replays: collections.deque = collections.deque(maxlen=REPLAY_CAP)
_waiting: dict = {}  # id(GraphTrace) -> GraphTrace whose last replay is not resolved yet
_ids = itertools.count(1)
_anchor = None  # (host ns, the event recorded right after it)
_lock = threading.Lock()  # guards _waiting, each graph's pending replay and the anchor


class _Off:
    """The shared no-op context manager that `span` and `stage` hand back
    with tracing off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


def enabled() -> bool:
    return _on


def enable() -> None:
    """Turn tracing on for the process. RuntimeError while the graph cache
    holds graphs: those were captured without marks."""
    global _on
    from cmw_tpu_torch.runtime import cache

    if cache.entries():
        raise RuntimeError(f"trace.enable() after {len(cache.entries())} graph(s) were captured without marks: "
                           "enable tracing before the first capture, or cache.clear() first")
    _on = True


def disable() -> None:
    """Turn tracing off and forget what it recorded. Graphs captured while
    it was on keep their marks, which nothing reads."""
    global _on, _anchor
    _on = False
    with _lock:
        for g in _waiting.values():
            g.pending = None
        _waiting.clear()
        _anchor = None
    _spans.clear()
    _replays.clear()


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _event(external: bool = False):
    return torch.cuda.Event(enable_timing=True, external=external)


class Span:
    """A closed span: id, parent (the id of the span open around it in its
    thread, 0 for none), name, rid (request id), start_ns and end_ns on
    the profiler's clock."""

    __slots__ = ("id", "parent", "name", "rid", "start_ns", "end_ns", "_range")

    def __init__(self, name: str, rid=None):
        self.name, self.rid = name, rid

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.id, self.parent = next(_ids), (up.id if up is not None else 0)
        if self.rid is None and up is not None:
            self.rid = up.rid
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.autograd.profiler.record_function(self.name)
            self._range.__enter__()
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        _stack().pop()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _spans.append(self)
        return False


class _Stage(Span):
    __slots__ = ("_mark",)

    def __enter__(self):
        super().__enter__()
        self._mark = None
        marks = getattr(_tls, "marks", None)
        if marks is not None:  # inside a capture made with tracing on: an event-record node before the work
            opened = _tls.open_marks
            self._mark = len(marks)
            start = _event(external=True)
            start.record()
            marks.append([self.name, start, None, opened[-1] if opened else -1])
            opened.append(self._mark)
        return self

    def __exit__(self, *exc):
        if self._mark is not None:
            end = _event(external=True)
            end.record()
            _tls.marks[self._mark][2] = end
            _tls.open_marks.pop()
        return super().__exit__(*exc)


def span(name: str, rid=None):
    """A host span (see the module docstring); with tracing off, OFF."""
    if not _on:
        return OFF
    return Span(name, rid)


def stage(name: str):
    """A span that also marks the card inside a capture made with tracing
    on (see the module docstring); with tracing off, OFF."""
    if not _on:
        return OFF
    return _Stage(name)


class marking:
    """Around a capture (`cache._capture`): with tracing on, the stages
    inside put their marks into the list it yields, [name, start event, end
    event, index of the enclosing mark or -1]; off, it yields None."""

    def __enter__(self):
        if not _on:
            return None
        _tls.marks, _tls.open_marks = [], []
        return _tls.marks

    def __exit__(self, *exc):
        _tls.marks = _tls.open_marks = None
        return False


class GraphTrace:
    """What tracing keeps of one cached graph (`cache.Entry.traced`), for
    graphs captured with tracing on: its name (the owner's first element),
    its stage marks, its node count (None where the CUDA runtime cannot be
    asked), the graph pool's bytes after its capture and their growth by
    it, and counters of its calls: replays, host ns by span (`cache.lookup`,
    `cache.lock_wait`, `cache.copy_in`, `cache.launch`, `cache.clone_out`)
    and device ns of the replays resolved."""

    __slots__ = ("name", "marks", "nodes", "pool_bytes", "pool_growth", "replays", "host_ns", "device_ns", "events",
                 "pending")

    def __init__(self, name: str, marks: list, nodes, pool_bytes: int, pool_growth: int):
        self.name, self.marks, self.nodes = name, tuple(tuple(m) for m in marks), nodes
        self.pool_bytes, self.pool_growth = pool_bytes, pool_growth
        self.replays, self.host_ns, self.device_ns = 0, {}, 0.0
        self.events = None  # (start, end): the timing events around each replay, made at the first
        self.pending = None  # (rid, parent span id) of the last replay, until it is resolved


class Replay(NamedTuple):
    """A resolved replay: the graph's name, the request id and the id of the
    span open at its launch, its device start and end on the host clock
    (ns), and its marks [(stage, start ns, end ns, index of the enclosing
    mark or -1)] on the same clock."""

    graph: str
    rid: object
    parent: int
    start_ns: float
    end_ns: float
    marks: tuple

    @property
    def ns(self) -> float:
        return self.end_ns - self.start_ns


class Trace(NamedTuple):
    spans: list  # Span, in the order they closed
    replays: list  # Replay, in the order they were resolved


def _reanchor() -> None:
    global _anchor
    torch.cuda.synchronize()
    event = _event()
    host = time.time_ns()
    event.record()
    _anchor = (host, event)


def _resolve(g: GraphTrace) -> None:
    """Read g's last replay's events (waiting for it), add its device time to
    g and keep it as a Replay. Holds _lock."""
    (start, end), (rid, parent) = g.events, g.pending
    g.pending = None
    _waiting.pop(id(g), None)
    end.synchronize()
    t0 = _anchor[0] + _anchor[1].elapsed_time(start) * 1e6
    dev = start.elapsed_time(end) * 1e6
    g.device_ns += dev
    marks = tuple((name, t0 + start.elapsed_time(a) * 1e6, t0 + start.elapsed_time(b) * 1e6, up)
                  for name, a, b, up in g.marks)
    _replays.append(Replay(g.name, rid, parent, t0, t0 + dev, marks))


class _Replaying:
    __slots__ = ("g", "stream")

    def __init__(self, g: GraphTrace, stream):
        self.g, self.stream = g, stream

    def __enter__(self):
        g = self.g
        with _lock:
            if g.pending is not None:  # its events and marks are about to be overwritten
                with span("trace.resolve"):
                    _resolve(g)
            if _anchor is None:
                _reanchor()
        if g.events is None:
            g.events = (_event(), _event())
        g.events[0].record(self.stream)
        return self

    def __exit__(self, *exc):
        g = self.g
        g.events[1].record(self.stream)
        stack = _stack()
        up = stack[-1] if stack else None
        with _lock:
            g.pending = (up.rid if up else None, up.id if up else 0)
            g.replays += 1
            _waiting[id(g)] = g
        return False


def replay(g: GraphTrace | None, stream):
    """Around `graph.replay()` on stream: with tracing on and a graph
    captured with it on, the graph's pair of timing events recorded around
    the replay (read before the graph's next replay or at collect()); else
    OFF."""
    if not _on or g is None:
        return OFF
    return _Replaying(g, stream)


def count(g: GraphTrace | None, *spans) -> None:
    """Add each span's host ns to g's counters (OFF spans and graphs
    captured with tracing off count nothing)."""
    if not _on or g is None:
        return
    for sp in spans:
        if sp is not OFF:
            g.host_ns[sp.name] = g.host_ns.get(sp.name, 0) + sp.ns


def collect() -> Trace:
    """Resolve every replay not yet resolved (waiting for the card),
    re-anchor, and hand over what was recorded since the last collect()."""
    with _lock:
        for g in list(_waiting.values()):
            _resolve(g)
        if _anchor is not None:
            _reanchor()
    spans, replays = list(_spans), list(_replays)
    _spans.clear()
    _replays.clear()
    return Trace(spans, replays)


def _cudart():
    """The CUDA runtime library this process loaded (torch's), or None."""
    try:
        with open("/proc/self/maps") as f:
            paths = {line.split()[-1] for line in f if "libcudart.so" in line}
    except OSError:
        return None
    return ctypes.CDLL(sorted(paths)[0]) if paths else None


def graph_nodes(graph) -> int | None:
    """The node count of a captured `torch.cuda.CUDAGraph` (kept with
    keep_graph=True), by `cudaGraphGetNodes` on the CUDA runtime torch
    loaded; None where that cannot be asked."""
    raw = getattr(graph, "raw_cuda_graph", None)
    lib = _cudart() if raw is not None else None
    if lib is None:
        return None
    get = lib.cudaGraphGetNodes
    get.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    get.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    return int(n.value) if get(ctypes.c_void_p(raw()), None, ctypes.byref(n)) == 0 else None


# --- reading a Trace ----------------------------------------------------------

def self_ns(spans) -> dict:
    """{span id: its ns less its children's}, over the spans given."""
    out = {sp.id: sp.ns for sp in spans}
    for sp in spans:
        if sp.parent in out:
            out[sp.parent] -= sp.ns
    return out


def summary(tr: Trace) -> dict:
    """Totals by name: spans {name: [count, ns, self ns]}, replays {graph:
    [count, device ns]}, marks {stage: [count, device ns]}."""
    own = self_ns(tr.spans)
    spans, replays, marks = {}, {}, {}
    for sp in tr.spans:
        row = spans.setdefault(sp.name, [0, 0, 0])
        row[0], row[1], row[2] = row[0] + 1, row[1] + sp.ns, row[2] + own[sp.id]
    for r in tr.replays:
        row = replays.setdefault(r.graph, [0, 0.0])
        row[0], row[1] = row[0] + 1, row[1] + r.ns
        for name, a, b, _ in r.marks:
            row = marks.setdefault(name, [0, 0.0])
            row[0], row[1] = row[0] + 1, row[1] + (b - a)
    return {"spans": spans, "replays": replays, "marks": marks}

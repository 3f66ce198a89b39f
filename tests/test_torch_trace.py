"""The port's tracing (`cmw_tpu_torch/runtime/trace.py`) on the CPU, on the
graph cache's fake card (`tests/test_torch_cache.py`), and on the card.

Checked:

  - with tracing off nothing is recorded, `span` and `stage` hand back one
    shared no-op, and a graph captured off carries no marks or counters;
  - with tracing on, a replayed call of `cache.graphed` gives `cache.lookup`
    -> `lock_wait` -> `copy_in` -> `launch` -> `clone_out` under the
    caller's span, each tick of `WalkingController.step` one request id;
  - a span's self time is its time less its children's;
  - `enable()` after a capture raises;
  - a span's start agrees with a CPU torch.profiler session's `start_ns`
    for the range it opens, within 100 us (the median of ten spans: the
    span clock is the profiler's);
  - stage marks ride in every replay of a graph captured with tracing on,
    inside the replay's own events, and the graph's counters count;
  - `tools/trace_cells.py`'s readings find nothing in an empty trace, and
    read a controller's trace on the fake card;
  - `apps.bench --profile`'s Chrome trace shows the program's spans;
  - on the card: a replay's marks lie inside its replay events, the parts
    of the `_mpc_post` and `_wbc_stage` replays (their marked stages and
    the gaps between them) sum to the replay's device time within 2 %, and
    replays of graphs with marks equal the eager episode bitwise."""

import importlib.util
import json
import statistics
import time
from pathlib import Path

import pytest
import torch
from test_torch_cache import assert_trees_equal, card, controller, double  # noqa: F401  (card: the fixture)

from cmw_tpu_torch.apps import bench as BENCH
from cmw_tpu_torch.cmpc import CentroidalMPCSolver, ergocub_mpc_config
from cmw_tpu_torch.dist import sweep as TS
from cmw_tpu_torch.runtime import cache, trace
from cmw_tpu_torch.runtime import loop as TL

DISPATCH = ["cache.lookup", "cache.lock_wait", "cache.copy_in", "cache.launch", "cache.clone_out"]


def _tool():
    path = Path(__file__).resolve().parents[1] / "tools" / "trace_cells.py"
    spec = importlib.util.spec_from_file_location("trace_cells", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()


@pytest.fixture
def tracing(card):  # noqa: F811
    """Tracing on, over the fake card's empty cache; off (and forgotten) after."""
    trace.enable()
    yield
    trace.disable()


def staged(x, y):
    with trace.stage("outer"):
        with trace.stage("inner"):
            z = x * 2.0
        return z + y


def test_off_records_nothing(card):  # noqa: F811
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b", 3) is trace.stage("c") is trace.OFF
    x, y = torch.ones(3), torch.zeros(3)
    for _ in range(3):
        cache.graphed(("staged",), staged, x, y)
    with trace.span("outside"), trace.stage("stage"):
        pass
    got = trace.collect()
    assert got.spans == [] and got.replays == []
    (entry,) = card().values()
    assert entry.traced is None  # captured off: no marks, no counters


def test_dispatch_spans_under_the_callers_span(tracing):
    """Seven ticks at mpc_every 5: every tick is one `loop.step` whose spans
    all carry its tick; a replayed WBC tick's stage dispatches through the
    five cache spans in order; the MPC stage holds its host read."""
    ctl = controller(wbc_dt=0.012)
    inp = TL.TickInput(*(a[:, 0] for a in TL.constant_inputs(1, (0.3, 0.0, 1.0, 0.0), batch=1, device="cpu")))
    s = ctl.initial_state(1)
    trace.collect()
    for tick in range(7):
        s, _ = ctl.step(s, inp, tick)
    got = trace.collect()
    by_id = {sp.id: sp for sp in got.spans}
    steps = [sp for sp in got.spans if sp.name == "loop.step"]
    assert [sp.rid for sp in steps] == list(range(7))

    def root(sp):
        while sp.parent in by_id:
            sp = by_id[sp.parent]
        return sp

    assert all(root(sp).name == "loop.step" and sp.rid == root(sp).rid for sp in got.spans)
    for step in steps:
        kids = [sp for sp in got.spans if sp.parent == step.id]
        want = ["loop.mpc_stage", "loop.wbc_stage"] if step.rid % 5 == 0 else ["loop.wbc_stage"]
        assert [sp.name for sp in sorted(kids, key=lambda sp: sp.start_ns)] == want
        wbc = next(sp for sp in kids if sp.name == "loop.wbc_stage")
        inside = sorted((sp for sp in got.spans if sp.parent == wbc.id), key=lambda sp: sp.start_ns)
        dispatch = [sp.name for sp in inside if sp.name.startswith("cache.")]
        if step.rid == 0:  # the first tick captures
            assert dispatch == ["cache.lookup", "cache.lock_wait", "cache.capture", "cache.launch", "cache.clone_out"]
        else:
            assert dispatch == DISPATCH
        if step.rid % 5 == 0:
            mpc = next(sp for sp in kids if sp.name == "loop.mpc_stage")
            assert "loop.mpc_read" in {sp.name for sp in got.spans if sp.parent == mpc.id}
    # the readings of the benchmark's walks, from the program's own records
    assert TOOL.mann_device_ms(got) > 0 and TOOL.solve_device_ms(got) > 0
    assert TOOL.dispatch_host_ms_wbc_tick(got) > 0
    wbc_graph = next(e.traced for e in cache.entries().values() if e.traced.name == "wbc_stage")
    assert wbc_graph.replays == 7 and set(wbc_graph.host_ns) == set(DISPATCH) and wbc_graph.device_ns > 0


def test_self_time(tracing):
    with trace.span("parent") as parent:
        time.sleep(0.002)
        with trace.span("child") as a:
            time.sleep(0.001)
        with trace.span("child") as b:
            with trace.span("grandchild") as c:
                time.sleep(0.001)
    got = trace.collect()
    own = trace.self_ns(got.spans)
    assert own[parent.id] == parent.ns - a.ns - b.ns and own[b.id] == b.ns - c.ns and own[c.id] == c.ns
    assert own[parent.id] >= 2_000_000
    spans = trace.summary(got)["spans"]
    assert spans["child"] == [2, a.ns + b.ns, a.ns + b.ns - c.ns]
    assert spans["parent"] == [1, parent.ns, own[parent.id]]
    assert (c.parent, b.parent, a.parent, parent.parent) == (b.id, parent.id, parent.id, 0)


def test_enable_after_a_capture_raises(card):  # noqa: F811
    cache.graphed(("double",), double, torch.ones(2), torch.ones(2))
    with pytest.raises(RuntimeError, match="before the first capture"):
        trace.enable()
    assert not trace.enabled()
    cache.clear()
    trace.enable()
    trace.disable()


def test_span_clock_is_the_profilers():
    from torch.profiler import ProfilerActivity, profile

    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for k in range(12):
                with trace.span(f"clock.{k}"):
                    time.sleep(0.001)
        got = {sp.name: sp for sp in trace.collect().spans}
    finally:
        trace.disable()
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name().startswith("clock.")}
    assert set(ranges) == set(got)
    # the first ranges pay the profiler's own set-up; the median, since a
    # thread preempted between the range's stamp and the span's delays one
    # span, not the clock
    gaps = [abs(got[f"clock.{k}"].start_ns - ranges[f"clock.{k}"].start_ns()) for k in range(2, 12)]
    assert statistics.median(gaps) < 100_000, gaps


def test_marks_ride_in_replays(tracing):
    """A graph captured with tracing on: each replay resolves into a Replay
    whose marks (outer around inner) lie inside its own events; the graph
    counts its replays, host ns by dispatch span and device ns."""
    x, y = torch.ones(3), torch.zeros(3)
    with trace.span("caller", 41):
        for _ in range(3):
            out = cache.graphed(("staged",), staged, x, y)
    assert torch.equal(out, staged(x, y))
    got = trace.collect()
    (entry,) = cache.entries().values()
    g = entry.traced
    assert g.name == "staged" and [m[0] for m in g.marks] == ["outer", "inner"] and g.marks[1][3] == 0
    assert g.replays == 3 and len(got.replays) == 3 and g.device_ns > 0 and g.nodes is None
    assert set(g.host_ns) == set(DISPATCH) and all(v > 0 for v in g.host_ns.values())
    caller = next(sp for sp in got.spans if sp.name == "caller")
    for r in got.replays:
        assert (r.graph, r.rid, r.parent) == ("staged", 41, caller.id)
        (o, o0, o1, up_o), (i, i0, i1, up_i) = r.marks
        assert (o, i, up_o, up_i) == ("outer", "inner", -1, 0)
        assert r.start_ns <= o0 <= i0 <= i1 <= o1 <= r.end_ns
    assert trace.summary(got)["marks"]["inner"][0] == 3
    assert {sp.name for sp in got.spans} >= {"cache.capture", "cache.warm_up", "cache.instantiate", "trace.resolve"}


def test_disable_forgets(tracing):
    cache.graphed(("staged",), staged, torch.ones(2), torch.ones(2))
    trace.disable()
    assert trace.collect() == trace.Trace([], []) and not trace.enabled()
    (entry,) = cache.entries().values()
    assert entry.traced.pending is None  # its replay, never resolved, is let go


@pytest.mark.parametrize("name", sorted(TOOL.METRICS))
def test_readings_of_an_empty_trace_are_none(name):
    fn, _ = TOOL.METRICS[name]
    assert fn(trace.Trace([], []), wall_ns=1e9, nodes=1000) is None


def test_bench_profile_shows_the_programs_spans(tmp_path):
    cfg = ergocub_mpc_config(horizon=0.3, sqp_iters=1, admm_iters=4)
    solver = CentroidalMPCSolver(cfg)
    params = BENCH.make_params(cfg, BENCH.lateral_pushes(2), device="cpu")
    BENCH.measure(solver, params, 1, 1, profile_dir=str(tmp_path))
    assert not trace.enabled()
    events = json.loads((tmp_path / "bench_chain.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"bench.chain", "cache.lookup", "mpc.factor", "mpc.admm", "mpc.line_search"} <= names


@pytest.mark.cuda
def test_card_marks_lie_in_their_replays_and_replays_stay_bitwise():
    """On the card, tracing on: the walk's graphs' replays carry their marks
    inside their own events; the `_mpc_post` and `_wbc_stage` replays' parts
    (their outermost marks and the gaps between them) sum to the replay's
    device time within 2 %; and the blocked episode's period replays equal
    the eager episode bitwise, as on the fake card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and their event nodes have no CPU mode")
    import chip_smoke
    from cmw_tpu_torch import convert
    from cmw_tpu_torch.core import kinematics as TK
    from cmw_tpu_torch.mann.generator import GeneratorConfig
    from cmw_tpu_torch.runtime.config import ergocub_gazebo_v1

    cache.clear()
    trace.enable()
    try:
        weights = convert.mann_weights_from_numpy(chip_smoke.synthetic_mann_numpy(), device="cuda")
        cfg = ergocub_gazebo_v1(mpc=ergocub_mpc_config(horizon=0.6), wbc_dt=0.012,
                                gen=GeneratorConfig(slow_down_factor=2.5))
        ctl = TL.WalkingController(cfg, TK.ergocub_approx(), weights, device="cuda")
        B, every = 2, ctl.cfg.mpc_every
        s0 = ctl.initial_state(B)
        inputs = TL.constant_inputs(2 * every, (0.3, 0.0, 1.0, 0.0), batch=B, device="cuda")
        s = s0
        for k in range(2 * every):
            s, tel = ctl.step(s, TL.TickInput(*(a[:, k] for a in inputs)), k)
            tel.q.cpu()
        got = trace.collect()
        seen = set()
        for r in got.replays:
            assert all(r.start_ns - 1e3 <= a <= b <= r.end_ns + 1e3 for _, a, b, _ in r.marks), r.graph
            if r.graph in ("mpc_post", "wbc_stage"):
                top = sorted((a, b) for _, a, b, up in r.marks if up == -1)
                assert top, r.graph
                seen.add(r.graph)
                edges = [r.start_ns] + [t for ab in top for t in ab] + [r.end_ns]
                parts = [max(0.0, edges[i + 1] - edges[i]) for i in range(len(edges) - 1)]
                assert sum(parts) == pytest.approx(r.ns, rel=0.02), r.graph
        assert seen == {"mpc_post", "wbc_stage"}
        with cache.disable_graphs():
            s_e, tel_e = ctl.run_episode(s0, inputs)
        z = s0.x9[:, 2]
        acc0 = (z * 0, z * 0, z * 0, torch.ones_like(z, dtype=torch.bool), torch.ones_like(z), z + 10.0, z)
        acc_e = acc0
        for k in range(inputs.joypad.shape[1]):
            acc_e = TS.fold(acc_e, TL.Telemetry(*(a[:, k] for a in tel_e)))
        s_b, tel_b = ctl.run_episode_blocked(s0, inputs)
        s_f, acc_f = ctl.run_episode_fold(s0, inputs, TS.fold, acc0)
        period = [e.traced for e in cache.entries().values() if e.traced is not None and e.traced.name == "period"]
        assert len(period) == 2 and all(p.marks for p in period)
        assert_trees_equal((s_b, tel_b), (s_e, tel_e))
        assert_trees_equal((s_f, acc_f), (s_e, acc_e))
    finally:
        trace.disable()
        cache.clear()

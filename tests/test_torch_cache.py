"""The graph cache (`cmw_tpu_torch/runtime/cache.py`) on the CPU.

The CPU has no CUDA graphs, so the cache's own logic runs on a fake card:
`CARD` set to "cpu", the stream and device calls made no-ops, and the
capture (`cache._record`) replaced by a FakeGraph that records the captured
function on its static inputs and, like a real replay, runs it again on
replay without Python's side effects (the launch counters), its stages'
marks recorded again as a replay's event-record nodes are; a FakeEvent keeps
the host's time of its record as the card's. Checked:

  - the keys: the `no_adjust` ablation pair of controllers gets two entries
    (the aliasing that shipped a null ablation in JAX), an equal-valued
    controller none, another B or another dtype a new one;
  - the cached call equals the plain call bitwise, on the CPU as is and on
    the fake card over calls with other inputs; an output that is an input
    comes back as the caller's tensor, the other outputs are the caller's
    own (a later replay leaves them as they were);
  - `disable_graphs()` nests, and calls inside it capture nothing;
  - the launch bookkeeping: a graph records the launches of its capture
    and adds them on every call, the warm-up's and the capture's taken back;
    a nested graphed call inside a capture becomes part of the outer graph;
  - a capture that fails raises and leaves no entry; a key run eagerly
    on the card first is captured without a warm-up;
  - two threads replaying two graphs whose static outputs share memory, as
    graphs sharing the pool may, each get their own graph's result (a
    replay releases the GIL; the cache's lock runs from copy-in to clones);
  - `clear()` drops every graph and the pool;
  - the MPC stage at the default cadence (a generator call every stage)
    holds exactly two graphs, `_mpc_pre`'s and `_mpc_post`'s with the
    generator called; `_mpc_post` without the call only comes with a slowed
    gait (a call every 5th stage), or from `warm_mpc_stage`;
  - a period graph's replays (`run_episode_blocked`, `run_episode_fold`
    with the sweep's fold) equal the eager episode tick by tick, bitwise;
  - a fold that changes its accumulator's structure raises on the card."""

import contextlib
import threading
import time

import pytest
import torch

import chip_smoke
from cmw_tpu_torch import convert
from cmw_tpu_torch.apps import bench as BENCH
from cmw_tpu_torch.cmpc import CentroidalMPCSolver, ergocub_mpc_config
from cmw_tpu_torch.cmpc.formulation import no_adjust
from cmw_tpu_torch.core import kinematics as TK
from cmw_tpu_torch.dist import sweep as TS
from cmw_tpu_torch.mann.generator import GeneratorConfig
from cmw_tpu_torch.ops import admm_fused, riccati_admm, rigid_step, spd_inverse, symv
from cmw_tpu_torch.runtime import cache, trace
from cmw_tpu_torch.runtime import loop as TL
from cmw_tpu_torch.runtime.config import ergocub_gazebo_v1
from cmw_tpu_torch.runtime.loop import WalkingController

torch.set_num_threads(2)


class FakeStream:
    def wait_stream(self, other):
        pass

    def wait_event(self, event):
        pass


class FakeEvent:
    """Keeps the host's time of its last record() as the card's: on the
    fake card the work is done when it is launched."""

    def __init__(self, enable_timing=False, blocking=False, interprocess=False, external=False):
        self.ns = None

    def record(self, stream=None):
        self.ns = time.perf_counter_ns()

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.ns - self.ns) / 1e6


class FakeGraph:
    """Replays the captured call: fn again on the same static inputs, its
    results written into the static outputs, the launch counters untouched
    (a replay runs no Python)."""

    def __init__(self, keep_graph=False):
        self.fn = self.args = self.out = self.marks = None

    def instantiate(self):
        pass

    def replay(self):
        counts = cache.read_launches()
        with cache.disable_graphs(), trace.marking() as again:  # what the capture recorded, nested calls inline
            got = self.fn(*self.args)
        for mark, now in zip(self.marks or (), again or ()):  # the capture's stage marks record again
            mark[1].ns, mark[2].ns = now[1].ns, now[2].ns
        for o, g in zip(torch.utils._pytree.tree_leaves(self.out), torch.utils._pytree.tree_leaves(got)):
            if isinstance(o, torch.Tensor) and o is not g:
                one = tuple(slice(0, 1) if st == 0 else slice(None) for st in o.stride())  # an expanded output's base
                o[one].copy_(g[one])
        cache._add_launches(cache._delta(counts, cache.read_launches()))


def fake_record(graph, fn, static_args):
    graph.fn, graph.args, graph.marks = fn, static_args, getattr(trace._tls, "marks", None)
    graph.out = fn(*static_args)
    return graph.out


@pytest.fixture
def card(monkeypatch):
    """The fake card, with an empty cache."""
    monkeypatch.setattr(cache, "CARD", "cpu")
    monkeypatch.setattr(cache, "_graphs", {})
    monkeypatch.setattr(cache, "_warm", set())
    monkeypatch.setattr(cache, "_pool", None)
    monkeypatch.setattr(cache, "_record", fake_record)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: FakeStream())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(cache, "pool_bytes", lambda: 0)
    monkeypatch.setattr(cache, "_done", None)
    for m in cache.COUNTED:
        monkeypatch.setattr(m, "launches", 0)
    return cache.entries


def double(x, y):
    return x * 2.0 + y, y


def test_keys(card):
    weights = convert.mann_weights_from_numpy(chip_smoke.synthetic_mann_numpy(), device="cpu")
    model = TK.ergocub_approx()
    base = ergocub_gazebo_v1()
    a = WalkingController(base, model, weights, device="cpu")
    b = WalkingController(ergocub_gazebo_v1(), model, weights, device="cpu")
    off = WalkingController(ergocub_gazebo_v1(mpc=no_adjust(base.mpc)), model, weights, device="cpu")
    x, y = torch.ones(2, 3), torch.zeros(2, 3)
    for ctl in (a, off):
        cache.graphed(("probe", ctl), double, x, y)
    assert len(card()) == 2  # the ablation arms never share a graph
    cache.graphed(("probe", b), double, x, y)
    assert len(card()) == 2  # an equal-valued controller shares a's
    cache.graphed(("probe", a), double, torch.ones(3, 3), torch.zeros(3, 3))
    assert len(card()) == 3  # another B
    cache.graphed(("probe", a), double, x.double(), y.double())
    assert len(card()) == 4  # another dtype
    assert cache.lookup(("probe", b), x, y) is cache.lookup(("probe", a), x, y) is not None
    assert cache.lookup(("probe", off), torch.ones(5, 3), y) is None


def test_cached_equals_plain(card, monkeypatch):
    # on the CPU as is: the solve (Riccati) through the cache is the eager solve
    monkeypatch.setattr(cache, "CARD", "cuda")
    cfg = ergocub_mpc_config(horizon=0.3)
    solver = CentroidalMPCSolver(cfg)
    params = BENCH.make_params(cfg, BENCH.lateral_pushes(2), device="cpu")
    warm = solver.cold_start(2, device="cpu")
    for g, w in zip(solver.solve(params, warm), solver._solve(params, warm)):
        assert torch.equal(g, w)
    assert not card()
    # on the fake card: replays against plain calls on other inputs
    monkeypatch.setattr(cache, "CARD", "cpu")
    x, y = torch.randn(4, 5, generator=torch.Generator().manual_seed(0)), torch.randn(4, 5)
    outs = []
    for k in range(3):
        xk = x + k
        out, passed = cache.graphed(("double",), double, xk, y)
        assert torch.equal(out, double(xk, y)[0])
        assert passed is y  # an input handed back is the caller's own tensor
        outs.append(out)
    assert len(card()) == 1
    assert torch.equal(outs[0], double(x, y)[0])  # later replays left it alone


def test_disable_graphs_nests(card):
    assert cache.graphs_enabled()
    with cache.disable_graphs():
        assert not cache.graphs_enabled()
        with cache.disable_graphs():
            assert not cache.graphs_enabled()
        assert not cache.graphs_enabled()
        out, _ = cache.graphed(("double",), double, torch.ones(2), torch.ones(2))
        assert torch.equal(out, torch.full((2,), 3.0)) and not card()
    assert cache.graphs_enabled()


def test_launch_bookkeeping(card):
    def kernels(x):  # stands for a path through the wrappers: K3 once, K5 twice, K2 twice, K6 once
        spd_inverse.launches += 1
        admm_fused.launches += 2
        riccati_admm.launches += 2
        rigid_step.launches += 1
        return x + 1.0

    def outer(x):  # a graphed call inside another's capture is part of it
        symv.launches += 1
        return cache.graphed(("inner",), kernels, x) * 2.0

    x = torch.zeros(3)
    assert torch.equal(cache.graphed(("k",), kernels, x), x + 1.0)
    assert cache.read_launches() == (1, 0, 2, 2, 1)  # warm-up and capture taken back, one replay added
    for _ in range(2):
        cache.graphed(("k",), kernels, x)
    assert cache.read_launches() == (3, 0, 6, 6, 3)
    assert cache.lookup(("k",), x).launches == (1, 0, 2, 2, 1)
    for m in cache.COUNTED:
        m.launches = 0
    for _ in range(2):
        assert torch.equal(cache.graphed(("outer",), outer, x), (x + 1.0) * 2.0)
    assert cache.read_launches() == (2, 2, 4, 4, 2)
    assert cache.lookup(("outer",), x).launches == (1, 1, 2, 2, 1) and cache.lookup(("inner",), x) is None


def test_eager_run_skips_the_warm_up(card):
    """A key run eagerly on the card is captured without a warm-up; clear()
    forgets it (the constants it filled go with the graphs)."""
    calls = []

    def counted(x):
        calls.append(1)
        return x + 1.0

    x = torch.zeros(2)
    cache.graphed(("cold",), counted, x)
    assert len(calls) == 3  # warm-up, capture, replay
    with cache.disable_graphs():
        cache.graphed(("warm",), counted, x)
    cache.graphed(("warm",), counted, x)
    assert len(calls) == 3 + 1 + 2  # the eager run; then capture and replay
    cache.clear()
    cache.graphed(("warm",), counted, x)
    assert len(calls) == 6 + 3


def test_capture_failure_raises(card, monkeypatch):
    def broken(graph, fn, static_args):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(cache, "_record", broken)
    with pytest.raises(RuntimeError, match="capturing"):
        cache.graphed(("double",), double, torch.ones(2), torch.ones(2))
    assert not card() and cache.graphs_enabled()


def test_threads_sharing_the_pool(card, monkeypatch):
    pool = torch.zeros(8)

    def pooled_record(graph, fn, static_args):  # both graphs' static outputs in one block of the pool
        graph.fn, graph.args = fn, static_args
        graph.out = pool[:4].view(2, 2)
        graph.out.copy_(fn(*static_args))
        return graph.out

    def plus_one(x):
        return x + 1.0

    def times_ten(x):
        return x * 10.0

    monkeypatch.setattr(cache, "_record", pooled_record)
    xa, xb = torch.ones(2, 2), torch.full((2, 2), 2.0)
    cache.graphed(("a",), plus_one, xa)
    cache.graphed(("b",), times_ten, xb)
    a_replayed, b_replayed = threading.Event(), threading.Event()
    replay = FakeGraph.replay

    def interleaved(graph):  # a's replay gives b's thread the time to replay before a's outputs are cloned
        replay(graph)
        if graph.fn is plus_one:
            a_replayed.set()
            b_replayed.wait(0.3)
        else:
            b_replayed.set()

    monkeypatch.setattr(FakeGraph, "replay", interleaved)
    got = {}

    def run_b():
        a_replayed.wait(5.0)
        got["b"] = cache.graphed(("b",), times_ten, xb)

    thread = threading.Thread(target=run_b)
    thread.start()
    got["a"] = cache.graphed(("a",), plus_one, xa)
    thread.join()
    assert torch.equal(got["a"], xa + 1.0) and torch.equal(got["b"], xb * 10.0)


def test_clear(card):
    x = torch.zeros(3)
    cache.graphed(("double",), double, x, x)
    assert len(card()) == 1 and cache._pool is not None
    cache.clear()
    assert not card() and cache._pool is None and cache._done is None
    out, _ = cache.graphed(("double",), double, x + 1.0, x)
    assert torch.equal(out, torch.full((3,), 2.0)) and len(card()) == 1


def controller(**kw):
    """A kinematic-plant controller on the CPU at the short horizon, the
    synthetic weights."""
    weights = convert.mann_weights_from_numpy(chip_smoke.synthetic_mann_numpy(), device="cpu")
    cfg = ergocub_gazebo_v1(mpc=ergocub_mpc_config(horizon=0.6), **kw)
    return WalkingController(cfg, TK.ergocub_approx(), weights, device="cpu")


def stage_graphs(ctl, s, inp):
    """{"pre", "post[True]", "post[False]"}: which of the MPC stage's graphs the cache holds."""
    s = TL._without_rng(s)
    pre = ctl._mpc_pre(s, inp)
    found = {"pre"} if cache.lookup(("mpc_pre", ctl), s, inp) else set()
    return found | {f"post[{c}]" for c in (True, False) if cache.lookup(("mpc_post", ctl), s, inp, pre, c)}


@pytest.mark.parametrize("slow", [1.0, 2.5], ids=["default", "slowed"])
def test_mpc_stage_graphs(card, slow):
    """Two MPC stages a period apart: at the default cadence both call the
    generator, and the cache holds the pre graph and post[True] only; with
    the gait slowed 2.5x (mannCallingTime 300 ms, a call every 5th stage)
    the second stage does not call, and post[False] comes."""
    ctl = controller(gen=GeneratorConfig(slow_down_factor=slow))
    B = 2
    inp = TL.TickInput(*(a[:, 0] for a in TL.constant_inputs(1, (0.3, 0.0, 1.0, 0.0), batch=B, device="cpu")))
    s = ctl.initial_state(B)
    s1 = ctl._mpc_stage(s, inp)
    s2 = ctl._mpc_stage(chip_smoke.coast(ctl, s1), inp)
    assert torch.equal(s2.mann.t0, s1.mann.t0) == (slow != 1.0)  # the second stage called the generator or not
    want = {"pre", "post[True]"} | ({"post[False]"} if slow != 1.0 else set())
    assert stage_graphs(ctl, s, inp) == want and len(card()) == len(want)


def test_warm_mpc_stage(card):
    """The real-time walker's warm-up: both of post's graphs before any
    stage that skips the generator."""
    ctl = controller()
    B = 1
    inp = TL.TickInput(*(a[:, 0] for a in TL.constant_inputs(1, batch=B, device="cpu")))
    s = ctl.initial_state(B)
    ctl.warm_mpc_stage(s, inp)
    assert stage_graphs(ctl, s, inp) == {"pre", "post[True]", "post[False]"} and len(card()) == 3


def assert_trees_equal(a, b):
    for x, y in zip(torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)):
        assert not isinstance(x, torch.Tensor) or torch.equal(x, y)


def test_period_replay_equals_eager(card):
    """Two MPC periods (mpc_every 5 at wbc_dt 12 ms), the second a replay of
    the period graph, against run_episode eagerly tick by tick: the blocked
    episode's state and telemetry, and the folded accumulator, bitwise. The
    gait is slowed 2.5x, so the second stage calls no generator eagerly,
    where the period runs it and every item keeps its stored rollout."""
    ctl = controller(wbc_dt=0.012, gen=GeneratorConfig(slow_down_factor=2.5))
    B = 2
    s0 = ctl.initial_state(B)
    inputs = TL.constant_inputs(2 * ctl.cfg.mpc_every, (0.3, 0.0, 1.0, 0.0), batch=B, device="cpu")
    with cache.disable_graphs():
        s_e, tel_e = ctl.run_episode(s0, inputs)
    z = s0.x9[:, 2]
    acc0 = (z * 0, z * 0, z * 0, torch.ones_like(z, dtype=torch.bool), torch.ones_like(z), z + 10.0, z)
    acc_e = acc0
    for k in range(inputs.joypad.shape[1]):
        acc_e = TS.fold(acc_e, TL.Telemetry(*(a[:, k] for a in tel_e)))
    s_b, tel_b = ctl.run_episode_blocked(s0, inputs)
    assert len(card()) == 1  # one period graph, replayed for the second period
    s_f, acc_f = ctl.run_episode_fold(s0, inputs, TS.fold, acc0)
    assert len(card()) == 2  # the fold keys its own
    assert torch.equal(s_e.mann.t0, torch.zeros(B, dtype=s_e.t.dtype))  # the one call, at tick 0
    assert_trees_equal((s_b, tel_b), (s_e, tel_e))
    assert_trees_equal((s_f, acc_f), (s_e, acc_e))


def test_fold_keeps_its_structure(card):
    """A fold whose accumulator grows by a tensor a tick: ValueError on the card."""
    ctl = controller(wbc_dt=0.012)
    inputs = TL.constant_inputs(ctl.cfg.mpc_every, batch=1, device="cpu")

    def grow(acc, tel):
        return acc + (tel.com_mpc,)

    with pytest.raises(ValueError, match="structure"):
        ctl.run_episode_fold(ctl.initial_state(1), inputs, grow, ())

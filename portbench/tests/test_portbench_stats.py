"""The shared arithmetic on synthetic numbers, the frozen work counts, the
inputs as functions of the seed alone, and the last line's form."""

import json
import math

import numpy as np
import pytest
import torch

from portbench import common, run, weights, work
from portbench.drivers import solve_chain, sweep, walk


@pytest.mark.parametrize("q", [0, 10, 50, 90, 99, 100])
def test_percentile_is_numpys(q):
    xs = list(np.random.default_rng(0).exponential(1.0, 137))
    assert common.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)
    assert math.isnan(common.percentile([], q))


def test_union_and_idle_share():
    assert common.union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert common.union_seconds([]) == 0
    assert common.idle_share(3.0, 4.0) == pytest.approx(25.0)
    assert common.idle_share(None, 4.0) is None and common.idle_share(1.0, 0.0) is None


def test_chain_gaps():
    want = torch.arange(1.0, 41.0).reshape(4, 10)  # [KB, B], largest 40
    first, p90 = solve_chain.chain_gaps(want.clone(), want)
    assert (first, p90) == (0.0, 0.0)
    one_late = want.clone()
    one_late[2, 3] += 4.0  # one item of a later solve: neither number moves
    assert solve_chain.chain_gaps(one_late, want) == (0.0, 0.0)
    one_first = want.clone()
    one_first[0, 7] += 4.0  # one item of the first solve
    assert solve_chain.chain_gaps(one_first, want)[0] == pytest.approx(0.1)
    broad = want + 0.4  # every item
    assert solve_chain.chain_gaps(broad, want) == (pytest.approx(0.01, rel=1e-5), pytest.approx(0.01, rel=1e-5))
    bad = want.clone()
    bad[1, 1] = math.nan
    assert solve_chain.chain_gaps(bad, want) == (math.inf, math.inf)
    assert solve_chain.chain_gaps(want[:, :5], want) == (math.inf, math.inf)


def test_reservoir_is_seeded_and_lazy():
    def draw(seed, n):
        r = common.Reservoir(3, seed)
        made = []
        for i in range(n):
            r.offer(lambda i=i: made.append(i) or i)
        return r.items, len(made)

    a, made = draw(7, 1000)
    assert a == draw(7, 1000)[0] and len(a) == 3 and made < 1000
    assert draw(8, 1000)[0] != a
    assert draw(7, 2)[0] == [0, 1]


def test_gaps():
    want = torch.tensor([0.5, 100.0, -3.0])
    assert common.leaf_gap(want.clone(), want) == 0.0
    assert common.leaf_gap(want + torch.tensor([1e-3, 0.0, 0.0]), want) == pytest.approx(1e-5, rel=1e-4)
    assert common.leaf_gap(torch.tensor([0.5, float("nan"), -3.0]), want) == math.inf
    assert common.leaf_gap(want[:2], want) == math.inf
    small = torch.tensor([1e-3, -2e-3])
    assert common.leaf_gap(small + 1e-4, small) == pytest.approx(1e-4, rel=1e-3)  # absolute below 1 (float32 inputs)


def test_compare_trees_by_name():
    from portbench.reference.cmpc.qp import ADMMState

    want = ADMMState(torch.ones(2), torch.zeros(3), torch.arange(2))
    assert common.compare_trees(want, want) == (0.0, "", 0)
    got = want._replace(zc=torch.full((3,), 0.25), y=torch.tensor([0, 5]))
    gap, where, flags = common.compare_trees(got, want)
    assert gap == 0.25 and where == "zc" and flags == 1


def test_work_counts_are_pinned():
    assert work.riccati_solve_work(20, 1304, 504, 2, 24) == (48_394_944, 15_606_000)
    assert work.riccati_solve_work(13, 856, 336, 2, 30) == (32_219_424, 12_530_700)
    assert work.dense_solve_work(504, 1080, 1332, 2, 24) == (702_120_192, 33_686_016)
    assert work.fused_solve_work(504, 1304, 1080, 1332, 2, 24) == (702_163_584, 9_407_104)
    assert work.spd_inverse_work(512, 504) == (2 * 512 * 504 * 504 * 4, 512 * 504**3)
    assert work.F32_FLOP_PER_S == 67e12 and work.HBM_BYTES_PER_S == 3.35e12


def _cell(name, seed):
    return run.load_cell(name, seed, 1.0, False, device="cpu")


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**33 + 1])
def test_inputs_are_functions_of_the_seed(seed):
    a, b = solve_chain.pushes(_cell("gz_solve_b512", seed), 512), solve_chain.pushes(_cell("gz_solve_b512", seed), 512)
    assert torch.equal(a, b) and float(a[:, 1].abs().max()) <= 1.0 and float(a[:, [0, 2]].abs().max()) == 0
    assert not torch.equal(a, solve_chain.pushes(_cell("gz_solve_b512", seed + 1), 512))

    j1, j2 = walk.Joystick(_cell("gz_walk_b1", seed)), walk.Joystick(_cell("gz_walk_b1", seed))
    cmds = [j1.at(0.002 * k) for k in range(0, 10000, 7)]
    assert cmds == [j2.at(0.002 * k) for k in range(0, 10000, 7)]
    changes = [c for changed, c in cmds if changed]
    assert 3 <= len(changes) <= 11  # a new stick every 2-4 s over 20 s
    assert all(0.3 <= math.hypot(c[0], c[1]) <= 0.8 and c[2:] == [1.0, 0.0] for c in changes)

    w1, w2 = weights.synthetic(seed, "cpu"), weights.synthetic(seed, "cpu")
    flat = lambda w: [t for _, t in common.leaves(tuple(w.values()))]  # noqa: E731
    assert len(flat(w1)) == 16 and all(torch.equal(x, y) for x, y in zip(flat(w1), flat(w2)))
    assert not torch.equal(w1["w_out"], weights.synthetic(seed + 1, "cpu")["w_out"])


def test_sweep_episodes_are_functions_of_the_seed():
    from portbench.controller import Controller

    cell = _cell("gz_push_sweep_rigid_b256", 11)
    ctl = Controller("reference", cell.config, "kinematic", weights.synthetic(11, "cpu"), "cpu")
    e0, e0b, e1 = (sweep.episode_inputs(ctl, cell, e, "cpu") for e in (0, 0, 1))
    assert torch.equal(e0.ext_force, e0b.ext_force) and not torch.equal(e0.ext_force, e1.ext_force)
    f = e0.ext_force
    assert f.shape == (256, 600, 3)
    on = f.abs().sum(-1).amax(0) > 0
    assert int(on.sum()) == 200 and bool(on[30]) and not bool(on[29]) and not bool(on[230])
    assert float(f[0::2, :, 1:].abs().max()) == 0 and float(f[1::2, :, [0, 2]].abs().max()) == 0
    assert float(f.abs().max()) <= 2.0


def test_last_line_writes_null_for_non_finite():
    cell = _cell("gz_solve_b512", 1)
    out = {"attempted": 8, "failed": 0, "e2e": {"solves_per_s": float("nan"), "setup_s": 1.5},
           "device": {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 1},
           "checks": [("cost_gap", float("inf"), 1e-4), ("prim_gap", 0.0, 1e-4)]}
    line = run.result(cell, out)
    text = json.dumps(line, allow_nan=False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert line["metrics"]["solves_per_s"]["value"] is None and line["correct"] is False
    assert json.loads(text)["compared"]["cost_gap"] == {"value": None, "limit": 1e-4}
    ok = run.result(cell, dict(out, checks=[("cost_gap", 0.0, 1e-4)]))
    assert ok["correct"] is True
    assert run.result(cell, dict(out, checks=[("cost_gap", 0.0, 1e-4)], failed=1))["correct"] is False

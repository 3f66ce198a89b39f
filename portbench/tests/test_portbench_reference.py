"""The reference against the program at a tiny size on the CPU, and each
fault a cell can have planted under the timed path: the harness, with its
look for a card skipped, must come out not correct.

On the CPU both sides run eagerly and compute alike, so every gap is 0. A
cell's faults: a step that returns its state unchanged, half of the batch
left out (its items given the mean of the rest), and an answer altered where
it is produced. No cell runs on more than one chip, so none has an exchange
between chips to leave out.
"""

import pytest
import torch

from portbench import run

SMALL = {  # the cell's traffic at a size the CPU holds
    "gz_solve_b512": (dict(batch=4, chain=2, warm_chains=1), 0.1),
    "gz_walk_b1": ({}, 3.0),  # an MPC tick and some WBC ticks
    "sn000_walk_b1": ({}, 3.0),
    "gz_push_sweep_rigid_b256": (dict(batch=4, plant="kinematic", episode_s=0.12, push_t0=0.0), 0.1),  # pushed from tick 0
}


def _run(workload, seed=2**31 + 3):
    traffic, seconds = SMALL[workload]
    cell = run.load_cell(workload, seed, seconds, False, device="cpu")
    cell.traffic = dict(cell.traffic, **traffic)
    return run.result(cell, run.driver(cell).run(cell))


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_reference_agrees_with_the_program_on_the_cpu(workload):
    line = _run(workload)
    assert line["correct"], line["compared"]
    assert all(c["value"] == 0 for c in line["compared"].values()), line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0


def _halve(t: torch.Tensor) -> torch.Tensor:
    """The batch's second half given the mean of the first (floats only)."""
    if not t.dtype.is_floating_point or t.dim() == 0 or t.shape[0] < 2:
        return t
    h = t.shape[0] // 2
    out = t.clone()
    out[h:] = t[:h].mean(dim=0, keepdim=True)
    return out


def _map(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        items = [_map(x, fn) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def _plant(monkeypatch, workload, fault):
    from cmw_tpu_torch.apps import bench
    from cmw_tpu_torch.cmpc.solver import CentroidalMPCSolver
    from cmw_tpu_torch.runtime.loop import WalkingController

    if workload == "gz_solve_b512":
        chain = bench.chain
        if fault == "unchanged_state":  # the chain's warm start never advances
            monkeypatch.setattr(CentroidalMPCSolver, "warm_from",
                                lambda self, params, sol: self.cold_start(sol.z.shape[0], device=sol.z.device))
        elif fault == "half_batch":
            monkeypatch.setattr(bench, "chain", lambda *a: tuple(_halve(x.T).T for x in chain(*a)))
        else:
            def altered(*a):
                costs, prims = chain(*a)
                costs = costs.clone()
                costs[0, 0] += 1e-4 * max(1.0, float(costs.abs().max()))  # over ten times the first solve's limit
                return costs, prims
            monkeypatch.setattr(bench, "chain", altered)
    elif workload in ("gz_walk_b1", "sn000_walk_b1"):
        if fault == "unchanged_state":
            wbc = WalkingController._wbc_stage
            monkeypatch.setattr(WalkingController, "_wbc_stage", lambda self, s, inp: (s, wbc(self, s, inp)[1]))
        else:
            step = WalkingController.step

            def altered(self, s, inp, tick):
                s1, tel = step(self, s, inp, tick)
                return s1, tel._replace(q=tel.q + 1e-2)  # ten times the limit
            monkeypatch.setattr(WalkingController, "step", altered)
    else:
        fold = WalkingController.run_episode_fold
        if fault == "unchanged_state":
            monkeypatch.setattr(WalkingController, "run_episode_fold",
                                lambda self, s, inp, f, acc: (s, fold(self, s, inp, f, acc)[1]))
        elif fault == "half_batch":
            monkeypatch.setattr(WalkingController, "run_episode_fold",
                                lambda self, s, inp, f, acc: _map(fold(self, s, inp, f, acc), _halve))
        else:
            def altered(self, s, inp, f, acc):
                s1, acc1 = fold(self, s, inp, f, acc)
                return s1, (acc1[0] + 0.1,) + tuple(acc1[1:])  # ten times the limit
            monkeypatch.setattr(WalkingController, "run_episode_fold", altered)


FAULTS = [(w, f) for w in sorted(SMALL) for f in ("unchanged_state", "half_batch", "altered_answer")
          if not (f == "half_batch" and w.endswith("_b1"))]  # a batch of one has no half to leave out


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_planted_fault_is_not_correct(monkeypatch, workload, fault):
    _plant(monkeypatch, workload, fault)
    line = _run(workload)
    assert not line["correct"], (fault, line["compared"])


def test_rigid_start_and_period_agree_on_the_cpu():
    """The rigid cell's start (the settle), which its runs do not work out
    again, and one rigid period, at B = 2."""
    from portbench import common, weights
    from portbench.controller import Controller

    cell = run.load_cell("gz_push_sweep_rigid_b256", 9, 0.1, False, device="cpu")
    w = weights.synthetic(9, "cpu")
    s = Controller("program", cell.config, "rigid", w, "cpu").initial_state(2)
    ref = Controller("reference", cell.config, "rigid", w, "cpu").initial_state(2)
    assert common.compare_trees(s, ref) == (0.0, "", 0)
    cell.traffic = dict(cell.traffic, batch=2, episode_s=0.06, push_t0=0.0)
    line = run.result(cell, run.driver(cell).run(cell))
    assert line["correct"] and line["compared"]["period_gap"]["value"] == 0, line["compared"]

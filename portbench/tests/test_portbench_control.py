"""The control of every cell: the plain reference put in the program's place
and computed with TF32 (the nearest precision below the float32 the
configurations state), at the cell's own size, on the card. Each run must
come out as not correct; the numbers it compared are printed (the upper
readings the limits were set from, PERF.md).

  python -m pytest portbench/tests/test_portbench_control.py -s
"""

import json

import pytest
import torch

from portbench import run

SEEDS = (3_000_000_001, 3_000_000_002, 3_000_000_003)
CELLS = {  # cell -> seconds of its short window (long enough to reach every sampled kind of step)
    "gz_solve_b512": 1.0,
    "gz_walk_b1": 4.0,
    "sn000_walk_b1": 4.0,
    "gz_push_sweep_rigid_b256": 1.0,
}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("the control runs on the card")
    names = {w["name"] for w in run.manifest()["workloads"]}
    if workload not in names:
        pytest.skip(f"{workload} is not a cell of BENCHMARK.json")
    for seed in SEEDS:
        cell = run.load_cell(workload, seed, CELLS[workload], False)
        cell.control = True
        line = run.result(cell, run.driver(cell).run(cell))
        print(json.dumps({"control": workload, "seed": seed, "correct": line["correct"],
                          "compared": line["compared"]}), flush=True)
        assert not line["correct"], f"{workload} seed {seed}: the TF32 control came out correct"

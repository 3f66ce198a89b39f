"""A sound change of rounding has to come out correct: the program, as a run
drives it at the cell's own size on the card, against the plain reference
computed elsewhere than a run computes it: in float32 on the CPU (every
operation rounded otherwise), or on the card with MAGMA's linalg in place
of cuSOLVER's (the factorisations and solves rounded otherwise). The
numbers compared are printed: the lower readings beside the limits
(PERF.md). A limit that such a run fails would refuse a later change that
only reorders sums.

  python -m pytest portbench/tests/test_portbench_rounding.py -s
"""

import json

import pytest
import torch

from portbench import run

SEEDS = (3_100_000_001, 3_100_000_002, 3_100_000_003)
CELLS = {  # cell -> (seconds of its short window, where the reference runs)
    "gz_solve_b512": (1.0, "cpu"),
    "gz_walk_b1": (4.0, "cpu"),
    "sn000_walk_b1": (4.0, "cpu"),
    # eagerly on the CPU a rigid period at B 256 takes minutes
    "gz_push_sweep_rigid_b256": (1.0, "magma"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_rounding_is_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("the program runs on the card")
    names = {w["name"] for w in run.manifest()["workloads"]}
    if workload not in names:
        pytest.skip(f"{workload} is not a cell of BENCHMARK.json")
    seconds, where = CELLS[workload]
    for seed in SEEDS:
        cell = run.load_cell(workload, seed, seconds, False)
        cell.reference_on = where
        line = run.result(cell, run.driver(cell).run(cell))
        print(json.dumps({"rounding": workload, "reference_on": where, "seed": seed, "correct": line["correct"],
                          "compared": line["compared"]}), flush=True)
        assert line["correct"], f"{workload} seed {seed}: the reference on {where} came out not correct"

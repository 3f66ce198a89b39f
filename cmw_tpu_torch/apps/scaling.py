"""Scaling-efficiency report: batched MPC solves/s at 1..N ranks.

The counterpart of `python -m cmw_tpu.apps.scaling`. It measures weak
scaling of the batched solve: a fixed batch per rank, the ranks of a
`torch.distributed` process group (`dist/ranks.py`: NCCL, one card a rank;
gloo with `--cpu`), each rank solving its slice of the pushes as a chain of
warm-started solves with the mean cost all-reduced after each, and prints one
JSON row per rank count, then a `scaling_report` line. Only the rows measured
on cards are the cards' numbers; `--cpu` checks the same program with CPU
processes.

Example:
  python -m cmw_tpu_torch.apps.scaling --devices 1 --per-device 64
  python -m cmw_tpu_torch.apps.scaling --cpu --devices 1,2 --per-device 8
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from cmw_tpu_torch.dist.ranks import run_ranks

CPU_RANKS = 8  # the rank counts --cpu tries by default, as JAX's 8 virtual CPU devices


def _measure_rank(rank: int, world: int, device: str, per_device: int, reps: int, chain: int):
    from cmw_tpu_torch.cmpc import ergocub_mpc_config
    from cmw_tpu_torch.entry import example

    B = per_device * world
    pushes = torch.linspace(-1.0, 1.0, B)[rank * per_device:(rank + 1) * per_device]
    solver, params = example(ergocub_mpc_config(), pushes, device)
    warm = solver.cold_start(per_device, device=device)

    def run():
        w, costs = warm, []
        for _ in range(chain):
            sol = solver.solve(params, w)
            mean_cost = sol.cost.mean() / world
            dist.all_reduce(mean_cost)  # the sweep-metric reduction across the ranks
            costs.append(mean_cost)
            w = solver.warm_from(params, sol)
        return torch.stack(costs)

    float(run().sum())  # the first chain builds and loads what the solve needs
    t = time.perf_counter()
    for _ in range(reps):
        float(run().sum())  # waits for the card
    dt = (time.perf_counter() - t) / reps / chain
    return B / dt


def measure(n_dev: int, per_device: int, reps: int, chain: int, *, device="cuda") -> float:
    """Solves/s of the batch per_device x n_dev on n_dev ranks: the mean of
    `reps` chains of `chain` warm-started solves, after one chain unmeasured."""
    return run_ranks(n_dev, "cmw_tpu_torch.apps.scaling:_measure_rank",
                     {"per_device": per_device, "reps": reps, "chain": chain}, device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--devices", default="", help="comma list, default 1..N")
    p.add_argument("--per-device", type=int, default=64)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--chain", type=int, default=2)
    p.add_argument("--cpu", action="store_true", help="CPU processes over gloo (default: the cards, NCCL)")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    n_avail = CPU_RANKS if args.cpu else torch.cuda.device_count()
    if args.devices:
        counts = [int(x) for x in args.devices.split(",")]
    else:
        counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_avail]

    rows = []
    base_rate = None
    for n in counts:
        rate = measure(n, args.per_device, args.reps, args.chain, device=device)
        if base_rate is None:
            base_rate = rate
        rows.append(
            {
                "devices": n,
                "batch": n * args.per_device,
                "solves_per_s": round(rate, 1),
                "speedup": round(rate / base_rate, 2),
                "efficiency": round(rate / base_rate / n, 3),
            }
        )
        print(json.dumps(rows[-1]))

    print(
        json.dumps(
            {
                "metric": "scaling_report",
                "platform": "cpu" if args.cpu else "gpu",
                "per_device_batch": args.per_device,
                "rows": rows,
            }
        )
    )
    return rows


if __name__ == "__main__":
    main()

"""Benchmark: batched centroidal-MPC solves/s on the card.

The counterpart of the repository's `bench.py` (which stays the JAX
package's benchmark). Prints ONE JSON line on stdout, with bench.py's keys:
{"metric", "value", "unit", "vs_baseline", "extra": {"batch", "sqp_iters",
"admm_iters", "compile_s", "model_flops_per_solve", "mfu_est",
"hbm_bytes_per_solve", "hbm_bw_util_est", "numerics_ok", "device"}}.

  - Headline, at ergocub_mpc_config() (the Riccati x-update): B walking
    scenarios pushed sideways by linspace(-1, 1) m/s^2 (`make_params`), each
    a chain of KB warm-started solves of the same parameters. The first
    chain's wall is `compile_s`: in the port that is lazy initialisation
    plus any nvcc build of the kernels, not a compile. Then `--reps` chains,
    each ended by torch.cuda.synchronize() and a scalar read;
    solves/s = B / (mean chain seconds / KB) and vs_baseline its ratio to
    one solve per 60 ms MPC tick (the reference's budget, BASELINE.md).
  - Numerics sentinel: one B = 1 solve on that configuration against one on
    the dense KKT with the plain Cholesky inverse (kkt_impl="dense",
    inverse_impl="xla"): numerics_ok when |dcost| <= 0.005 (|cost| + 1) and
    prim_res < 1e-2. An exception there gives numerics_ok false, with its
    traceback on stderr, and the line is still printed.
  - Roofline: `work_per_solve` counts one solve's operations and bytes on
    its path as the port runs it (`ops/roofline.py`, the kernel table's
    counts), over the card's float32 rate and memory rate.
  - `--full`, after the line: the B = 1 latency of a chain of 10
    warm-started solves over `--samples` dispatches (p50 / p99 / count),
    `bf16_kkt_solves_per_s` (the B x KB chain with kkt_dtype="bf16" on the
    dense KKT) and `cost_pallas_vs_xla` (the sentinel's two costs), written
    with the headline's dict to `--extra-out` as JSON, never to stdout.
  - `--profile DIR`: a torch.profiler trace of one chain, exported into DIR.

It runs on the card; `--cpu` runs it on the CPU (with `--batch` cut, a
check of the program, not a measurement). The configuration and KB are
fixed; `run` takes others, for the CPU tests.

Example:
  python -m cmw_tpu_torch.apps.bench
  python -m cmw_tpu_torch.apps.bench --full --extra-out /tmp/bench_extra.json
  python -m cmw_tpu_torch.apps.bench --cpu --batch 4 --reps 1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from cmw_tpu_torch.cmpc import CentroidalMPCSolver, MPCParams, ergocub_mpc_config
from cmw_tpu_torch.cmpc import formulation as F
from cmw_tpu_torch.core import contacts
from cmw_tpu_torch.core.centroidal import pack_state
from cmw_tpu_torch.ops import roofline as R
from cmw_tpu_torch.ops.symv import BLK

BASELINE_SOLVES_PER_S = 1.0 / 0.06  # the reference: one solve per 60 ms MPC tick
T0 = 1.02  # the gait's time at the first interval: the left foot swinging
KB = 4  # warm-started solves a chain (bench.py:69)
LATENCY_CHAIN = 10  # warm-started B = 1 solves per latency dispatch (bench.py:201)


def make_params(cfg, pushes, *, device="cuda", dtype=torch.float32) -> MPCParams:
    """bench.py's walking parameters, one item per push row of pushes [B, 3]:
    the 8-step alternating gait snapped to the grid at t0 = 1.02 s, the CoM
    at 0.7 m at rest, its reference moving forward at 0.08 m/s."""
    plan = contacts.snap_to_grid(contacts.make_alternating_gait(n_steps=8, device=device, dtype=dtype), cfg.dt)
    stage = contacts.mpc_stage_params(plan, T0, cfg.T, cfg.dt, cfg.n_slots)
    B, N = pushes.shape[0], cfg.N
    com0 = torch.tensor([0.0, 0.0, 0.7], dtype=dtype, device=device)
    ahead = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=device)
    com_ref = com0 + 0.08 * cfg.dt * torch.arange(N, dtype=dtype, device=device)[:, None] * ahead
    zero = torch.zeros(B, 3, dtype=dtype, device=device)
    return MPCParams(
        x0=pack_state(com0.expand(B, 3), zero, zero),
        com_ref=com_ref.expand(B, N, 3),
        ang_mom_ref=torch.zeros(B, N, 3, dtype=dtype, device=device),
        stage=type(stage)(*(a.expand(B, *a.shape) for a in stage)),
        ext_force=pushes.to(device=device, dtype=dtype),
        ext_torque=zero,
    )


def lateral_pushes(B: int, *, dtype=torch.float32) -> torch.Tensor:
    """[B, 3]: pushes along y in linspace(-1, 1) m/s^2."""
    y = torch.linspace(-1.0, 1.0, B, dtype=dtype)
    return torch.stack([torch.zeros_like(y), y, torch.zeros_like(y)], dim=-1)


def chain(solver, params, warm, KB: int):
    """KB warm-started solves of the same parameters, each from the last
    (bench.py:74-78). Returns (costs [KB, B], prim_res [KB, B])."""
    costs, prims = [], []
    for _ in range(KB):
        sol = solver.solve(params, warm)
        warm = solver.warm_from(params, sol)
        costs.append(sol.cost)
        prims.append(sol.prim_res)
    return torch.stack(costs), torch.stack(prims)


def _sync(t: torch.Tensor) -> float:
    """Wait for the card, then read a scalar of t."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return float(t.sum())


def measure(solver, params, KB: int, reps: int, profile_dir: str = ""):
    """(first chain's seconds, mean seconds of `reps` more, (costs, prims)
    of the first chain), every chain from a cold start."""
    B, device, dtype = params.x0.shape[0], params.x0.device, params.x0.dtype
    warm = solver.cold_start(B, device=device, dtype=dtype)
    t = time.perf_counter()
    first = chain(solver, params, warm, KB)
    _sync(first[0])
    first_s = time.perf_counter() - t
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=activities) as prof:
            _sync(chain(solver, params, warm, KB)[0])
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "bench_chain.json"))
    t = time.perf_counter()
    for _ in range(reps):
        _sync(chain(solver, params, warm, KB)[0])
    return first_s, (time.perf_counter() - t) / reps, first


def work_per_solve(cfg) -> tuple[int, int]:
    """(operations, bytes) of one solve at cfg on its path, counted as the
    port runs it:

      - Riccati (kkt_impl "auto" / "riccati"): bench.py's count
        (bench.py:143-154): `cmpc/riccati.py` runs the same recursion;
      - dense: one SPD inverse (K3) and sqp x admm packed symv calls (K4),
        counted as the kernel table counts them (`ops/roofline.py`), plus
        2 nr n^2 for J^T J and the constraint products (4 nnz(A) an ADMM
        iteration) in the operations;
      - fused (admm_impl="fused"): one K3 call and sqp fused ADMM calls (K5).

    nr and nnz(A) are counted on bench's parameters (built on the CPU)."""
    n, m = cfg.n_vars, cfg.n_con
    if cfg.kkt_impl in ("auto", "riccati"):
        T = cfg.T
        stage_floats = 2 * (24 * 33) + 3 * (24 * 24) + 81 + 2 * (9 * 24)
        flops = (T * 12 * 2 * 33**3 + 57 * T * 600
                 + cfg.sqp_iters * cfg.admm_iters * (T * 2 * 2 * stage_floats + 4 * m * (n // 8)))
        nbytes = cfg.sqp_iters * cfg.admm_iters * T * stage_floats * 4 + T * stage_floats * 4 * 3
        return flops, nbytes
    params = make_params(cfg, torch.zeros(1, 3), device="cpu")
    nr = F.residuals(cfg, params, torch.zeros(1, n)).shape[-1]
    nnz = int(torch.count_nonzero(F.constraint_dense(cfg, params.stage)))
    nbytes, flops = R.spd_inverse_work(1, n)
    flops += 2 * nr * n * n
    if cfg.admm_impl == "fused":
        b, f = R.admm_fused_work(1, n, m, nnz, cfg.admm_iters)
        return flops + cfg.sqp_iters * f, nbytes + cfg.sqp_iters * b
    nb = -(-n // BLK)
    b, f = R.symv_work(1, nb * (nb + 1) // 2, nb * BLK, BLK)
    iters = cfg.sqp_iters * cfg.admm_iters
    return flops + iters * (f + 4 * nnz), nbytes + iters * b


def device_name(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device == "cpu":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=512, help="scenarios B")
    p.add_argument("--reps", type=int, default=5, help="timed chains after the first")
    p.add_argument("--full", action="store_true", help="the extras, after the line, into --extra-out")
    p.add_argument("--samples", type=int, default=200, help="--full: B = 1 latency dispatches")
    p.add_argument("--extra-out", default="", help="--full: the JSON file of the extras")
    p.add_argument("--profile", default="", help="a torch.profiler trace of one chain into this directory")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = p.parse_args(argv)
    if args.full and not args.extra_out:
        p.error("--full needs --extra-out")
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benchmark runs on the card (pass --cpu for the CPU)")
    return run(ergocub_mpc_config(), args.batch, device=device, reps=args.reps, full=args.full,
               samples=args.samples, extra_out=args.extra_out, profile_dir=args.profile)


def run(cfg, B: int, *, device: str, chain_len: int = KB, reps: int = 5, full: bool = False, samples: int = 200,
        extra_out: str = "", profile_dir: str = "") -> dict:
    """The benchmark at cfg: prints the line (and with `full` writes the
    extras to `extra_out`); returns the line's dict."""
    solver = CentroidalMPCSolver(cfg)

    # --- headline: B scenarios, KB warm-started solves a chain -----------------
    params = make_params(cfg, lateral_pushes(B), device=device)
    compile_s, chain_s, _ = measure(solver, params, chain_len, reps, profile_dir)
    solves_per_s = B / (chain_s / chain_len)

    # --- numerics sentinel: the default path against the dense Cholesky one ----
    cost_p = cost_x = float("nan")
    base = make_params(cfg, torch.zeros(1, 3), device=device)
    try:
        solver_x = CentroidalMPCSolver(dataclasses.replace(cfg, kkt_impl="dense", inverse_impl="xla"))
        sol_p = solver.solve(base, solver.cold_start(1, device=device))
        sol_x = solver_x.solve(base, solver_x.cold_start(1, device=device))
        cost_p, cost_x = float(sol_p.cost[0]), float(sol_x.cost[0])
        numerics_ok = bool(abs(cost_p - cost_x) <= 0.005 * (abs(cost_x) + 1.0) and float(sol_p.prim_res[0]) < 1e-2)
    except Exception:  # reported as numerics_ok false; the line still goes out
        traceback.print_exc(file=sys.stderr)
        numerics_ok = False

    flops, nbytes = work_per_solve(cfg)
    result = {
        "metric": "batched_mpc_solves_per_s",
        "value": solves_per_s,
        "unit": "solves/s/chip",
        "vs_baseline": solves_per_s / BASELINE_SOLVES_PER_S,
        "extra": {
            "batch": B,
            "sqp_iters": cfg.sqp_iters,
            "admm_iters": cfg.admm_iters,
            "compile_s": compile_s,
            "model_flops_per_solve": int(flops),
            "mfu_est": flops * solves_per_s / R.F32_FLOP_PER_S,
            "hbm_bytes_per_solve": int(nbytes),
            "hbm_bw_util_est": nbytes * solves_per_s / R.HBM_BYTES_PER_S,
            "numerics_ok": numerics_ok,
            "device": device_name(device),
        },
    }
    print(json.dumps(result), flush=True)
    if not full:
        return result

    # ======== extras (--full only; into --extra-out, never to stdout) ========
    extra = dict(result["extra"])
    # single-solve latency: a chain of warm-started B = 1 solves a dispatch
    w0 = solver.cold_start(1, device=device)
    _sync(chain(solver, base, w0, LATENCY_CHAIN)[0])
    lat = []
    for _ in range(samples):
        t = time.perf_counter()
        _sync(chain(solver, base, w0, LATENCY_CHAIN)[0])
        lat.append((time.perf_counter() - t) / LATENCY_CHAIN)
    lat = np.array(lat)
    extra["single_solve_p50_ms"] = float(np.percentile(lat, 50) * 1e3)
    extra["single_solve_p99_ms"] = float(np.percentile(lat, 99) * 1e3)
    extra["latency_samples"] = len(lat)
    # the bf16 KKT (a dense-KKT option) on the headline's shape
    solver16 = CentroidalMPCSolver(dataclasses.replace(cfg, kkt_dtype="bf16", kkt_impl="dense"))
    _, chain16_s, _ = measure(solver16, params, chain_len, reps)
    extra["bf16_kkt_solves_per_s"] = B / (chain16_s / chain_len)
    extra["cost_pallas_vs_xla"] = [cost_p, cost_x]
    with open(extra_out, "w") as f:
        json.dump(dict(result, extra=extra), f, indent=1)
    print(f"full bench extras -> {extra_out}", file=sys.stderr)
    return result


if __name__ == "__main__":
    main()

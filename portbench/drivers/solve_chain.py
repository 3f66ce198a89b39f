"""Driver `solve_chain`: the batched solve, one chain after another.

The entry is the program's KB-solve chain (`cmw_tpu_torch.apps.bench.chain`,
on the card one replay of its CUDA graph), back to back for the window, each
chain from a cold start on the same B scenarios, each ended by a read of
its results' finiteness on the host. Traffic (`traffic/<name>.json`):
`batch` walking scenarios at the gait's time `t0`, each pushed sideways by
y ~ U(-push_y_max, push_y_max) m/s^2 from the seed, `chain` warm-started
solves a chain.

End to end: solves_per_s, every solve of the chains completed in the window
over the window (which closes when the chain running at `--seconds`
returns). Compared: every chain's costs and primal residuals against the
reference's chain from its own parameters (`portbench/reference`), each by
the largest gap of the chain's first solve over every item (`chain_gaps`;
a gap is |program - reference| / max(1, max |reference|)), and the costs
also by the 90th percentile of the gaps over every item and solve. Not the
largest over the later solves: each starts warm from the one before, and a
change of rounding alone moves a few items there as far as TF32 does. Nor
the residuals' percentile: rounding alone moves it half as far as TF32.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import common, presets, trace, work

TRACE_CHAINS = 1  # chains in the profiled sub-window (~218k kernels at B = 512)


def chain_gaps(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(largest gap of the first solve, 90th percentile of every gap) of the
    program's [KB, B] costs or residuals against the reference's; inf where
    a value is not finite where the reference's is, or the shapes differ."""
    if got.shape != want.shape:
        return math.inf, math.inf
    g, w = got.to(want.device).double(), want.double()
    ok = torch.isfinite(w)
    if not bool(torch.isfinite(g[ok]).all()):
        return math.inf, math.inf
    gap = torch.where(ok, (g - w).abs(), torch.zeros_like(w)) / max(1.0, float(w[ok].abs().max()))
    return float(gap[0].max()), common.percentile(gap.flatten().tolist(), 90)


def pushes(cell, B: int) -> torch.Tensor:
    """[B, 3] lateral pushes from the seed (float64, host)."""
    rng = np.random.default_rng([cell.seed, 1])
    y = rng.uniform(-1.0, 1.0, B) * cell.traffic["push_y_max"]
    return torch.as_tensor(np.stack([np.zeros(B), y, np.zeros(B)], axis=-1))


class Program:
    """The system under test: the program's chain."""

    def __init__(self, mpc, device):
        from cmw_tpu_torch.apps import bench
        from cmw_tpu_torch.cmpc.solver import CentroidalMPCSolver

        self.bench, self.solver, self.device = bench, CentroidalMPCSolver(mpc), device

    def inputs(self, push, t0):
        if abs(self.bench.T0 - t0) > 1e-12:
            raise ValueError(f"the program's chain starts at t0 = {self.bench.T0}, the traffic at {t0}")
        params = self.bench.make_params(self.solver.cfg, push.float(), device=self.device)
        return params, self.solver.cold_start(push.shape[0], device=self.device)

    def chain(self, params, warm, KB: int):
        return self.bench.chain(self.solver, params, warm, KB)

    def free(self):
        from cmw_tpu_torch.runtime import cache

        del self.solver
        cache.clear()


class Reference:
    """The plain reference's chain (eager, no hand kernel), in float32 with
    TF32 off, or on for the control."""

    def __init__(self, mpc, device, tf32: bool = False):
        from portbench.reference.cmpc.solver import CentroidalMPCSolver

        self.solver, self.device, self.tf32 = CentroidalMPCSolver(mpc), device, tf32

    def inputs(self, push, t0):
        from portbench.reference.inputs import make_params

        params = make_params(self.solver.cfg, push.float(), t0, device=self.device)
        return params, self.solver.cold_start(push.shape[0], device=self.device)

    def chain(self, params, warm, KB: int):
        costs, prims = [], []
        with common.tf32(self.tf32):
            for _ in range(KB):
                sol = self.solver.solve(params, warm)
                warm = self.solver.warm_from(params, sol)
                costs.append(sol.cost)
                prims.append(sol.prim_res)
        return torch.stack(costs), torch.stack(prims)

    def free(self):
        del self.solver


def run(cell) -> dict:
    tr, dev = cell.traffic, cell.device
    B, KB, t0 = tr["batch"], tr["chain"], tr["t0"]
    mpc_prog = presets.walking_config(cell.config, "kinematic", "program").mpc
    mpc_ref = presets.walking_config(cell.config, "kinematic", "reference").mpc
    push = pushes(cell, B)
    sut = Reference(mpc_ref, dev, tf32=True) if cell.control else Program(mpc_prog, dev)
    params, warm = sut.inputs(push, t0)
    for _ in range(tr.get("warm_chains", 2)):  # the first captures the chain's graph
        common.sync_read(sut.chain(params, warm, KB)[0])

    # --- the window ------------------------------------------------------------
    cell.note(f"card before the window: {common.nvidia_smi()}")
    outs, failed, ends = [], 0, []
    t_first = time.perf_counter()
    while True:
        costs, prims = sut.chain(params, warm, KB)
        bad = (~torch.isfinite(costs) | ~torch.isfinite(prims)).sum()
        failed += int(bad)  # waits for the chain
        outs.append((costs, prims))
        elapsed = time.perf_counter() - t_first
        ends.append(elapsed)
        if elapsed >= cell.seconds:
            break
    cell.note(f"card after the window: {common.nvidia_smi()}")
    n_chains = len(outs)
    rate = n_chains * B * KB / elapsed
    out = {"attempted": n_chains * B * KB, "failed": failed, "device": common.device_info(dev),
           "e2e": {"solves_per_s": rate, "setup_s": t_first - cell.t_start}}
    cell.note(f"solve_chain: {n_chains} chains of B {B} x KB {KB} in {elapsed:.4f} s, {rate:.2f} solves/s, "
              f"a chain {1e3 * elapsed / n_chains:.3f} ms; setup {t_first - cell.t_start:.3f} s")
    cell.note(f"solve_chain: chain walls (ms) {[round(1e3 * (b - a), 1) for a, b in zip([0.0] + ends, ends)]}")

    # --- the traced sub-window -------------------------------------------------
    if cell.trace:
        flops, _ = work.riccati_solve_work(mpc_ref.T, mpc_ref.n_con, mpc_ref.n_vars, mpc_ref.sqp_iters,
                                           mpc_ref.admm_iters)
        out["trace"] = {"solves_per_s": rate, "solve_flops": flops, "capture_s": common.capture_seconds(cell)}
        if dev != "cpu":
            with trace.fenced_profile() as prof:
                for _ in range(TRACE_CHAINS):
                    common.sync_read(sut.chain(params, warm, KB)[0])
            sess = trace.Session(prof)
            if sess.whole:
                out["busy_s"], out["window_s"] = sess.busy_ns() / 1e9, sess.window_ns() / 1e9
                out["breakdown"] = sess.breakdown()
            cell.note(f"traced {TRACE_CHAINS} chain(s): {len(sess.card)} device ops, whole {sess.whole}, busy "
                      f"{out.get('busy_s')} s of {out.get('window_s')} s")

    # --- the comparison, once the program's state is freed -------------------
    sut.free()
    with common.reference_place(cell) as ref_dev:
        ref = Reference(mpc_ref, ref_dev)
        want_c, want_p = ref.chain(*ref.inputs(push, t0), KB)
    first_c, p90_c = (max(x) for x in zip(*(chain_gaps(c, want_c) for c, _ in outs)))
    first_p = max(chain_gaps(p, want_p)[0] for _, p in outs)
    lim = tr["limits"]
    out["checks"] = [("cost_gap_first", first_c, lim["cost_gap_first"]), ("cost_gap_p90", p90_c, lim["cost_gap_p90"]),
                     ("prim_gap_first", first_p, lim["prim_gap_first"])]
    return out


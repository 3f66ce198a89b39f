"""Stage-level time breakdown of the batched MPC solve at ergocub_mpc_config().

The counterpart of the repository's `tools/diag_breakdown.py`, with its
lines. At batch B (`apps.bench.make_params`), each timed as the mean of
`--reps` calls after one untimed, with torch.cuda.synchronize() around each:

  - the full solve from a cold start at (sqp_iters, admm_iters) = (2, 24),
    (2, 1), (1, 24) and (1, 1), and from them the marginal cost of one ADMM
    iteration and of the second SQP iteration;
  - the Gauss-Newton build alone: the residual Jacobian (torch.func jacfwd),
    J^T J, A^T rho A and sigma I, at z = 0;
  - the KKT inverse alone, through the SPD inverse kernel ("pallas", the
    JAX tool's name for it) and through the plain Cholesky inverse
    ("xla chol");
  - the batched residual evaluation;
  - the "accounted" sum: GN build + one inverse + the ADMM iterations.

On the card each timed part replays a cached CUDA graph (the untimed call
captures it, `runtime/cache.py`), as the JAX tool jits each part: the
solves the solver's own graph, the KKT build, each inverse and the
residuals one graph each.

Example:
  python -m cmw_tpu_torch.apps.breakdown --batch 512
  python -m cmw_tpu_torch.apps.breakdown --cpu --batch 4 --reps 1
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.func import jacfwd, vmap

from cmw_tpu_torch.apps.bench import lateral_pushes, make_params
from cmw_tpu_torch.cmpc import CentroidalMPCSolver, ergocub_mpc_config
from cmw_tpu_torch.cmpc import formulation as F
from cmw_tpu_torch.cmpc.qp import spd_inverse
from cmw_tpu_torch.ops import spd_inverse as K3
from cmw_tpu_torch.runtime import cache

SOLVES = (("full(2,24)", {}), ("sqp2_admm1", dict(admm_iters=1)), ("sqp1_admm24", dict(sqp_iters=1)),
          ("sqp1_admm1", dict(sqp_iters=1, admm_iters=1)))


def timeit(fn, *args, reps: int = 5, device: str = "cuda") -> float:
    """Mean seconds of `reps` calls of fn(*args) after one untimed, each
    between two waits for the card (on `device` "cuda")."""

    def wait():
        if device == "cuda":
            torch.cuda.synchronize()

    fn(*args)
    total = 0.0
    for _ in range(reps):
        wait()
        t = time.perf_counter()
        fn(*args)
        wait()
        total += time.perf_counter() - t
    return total / reps


def build_kkt(cfg, params):
    """The dense path's KKT matrix at z = 0: J^T J + levenberg I + sigma I +
    A^T rho A, [B, n, n]."""
    B, n = params.x0.shape[0], cfg.n_vars
    dtype, device = params.x0.dtype, params.x0.device
    z0 = torch.zeros(B, n, dtype=dtype, device=device)
    _, _, rho = F.constraint_bounds(cfg, params.stage, dtype)
    ata = F.ata_blockdiag(cfg, params.stage, rho, dtype)
    J = vmap(jacfwd(lambda p, z: F.residuals(cfg, p, z), argnums=1))(params, z0)
    eye = torch.eye(n, dtype=dtype, device=device)
    H = J.transpose(-1, -2) @ J + cfg.levenberg * eye
    return H + cfg.admm_sigma * eye + ata


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=512, help="scenarios B")
    p.add_argument("--reps", type=int, default=5, help="timed calls of each part")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the breakdown runs on the card (pass --cpu for the CPU)")
    B, reps = args.batch, args.reps
    pushes = lateral_pushes(B)

    results = {}
    for name, kw in SOLVES:
        cfg = ergocub_mpc_config(**kw)
        solver = CentroidalMPCSolver(cfg)
        bp = make_params(cfg, pushes, device=device)
        warm = solver.cold_start(B, device=device)
        dt = timeit(lambda: solver.solve(bp, warm).cost, reps=reps, device=device)
        results[name] = dt
        print(f"{name:14s}: {dt*1e3:8.2f} ms  ({B/dt:8.0f} solves/s)", flush=True)
        cache.clear()  # done with this configuration's graph

    # marginal costs
    cfg = ergocub_mpc_config()
    n_admm = cfg.sqp_iters * cfg.admm_iters
    admm_iter_ms = (results["full(2,24)"] - results["sqp2_admm1"]) / (cfg.sqp_iters * (cfg.admm_iters - 1)) * 1e3
    sqp_ms = (results["full(2,24)"] - results["sqp1_admm24"]) * 1e3
    print(f"per-ADMM-iteration: {admm_iter_ms:.3f} ms  (x{n_admm} = {admm_iter_ms*n_admm:.1f} ms)")
    print(f"second SQP iteration total: {sqp_ms:.1f} ms")

    # the KKT build and inverse alone, each its own graph
    def gn_build(p):
        return cache.graphed(("breakdown.build_kkt", cfg), lambda q: build_kkt(cfg, q), p)

    bp = make_params(cfg, pushes, device=device)
    kkts = gn_build(bp).contiguous()
    dt_gn = timeit(gn_build, bp, reps=reps, device=device)
    print(f"GN build (jacfwd+JtJ+ata): {dt_gn*1e3:8.2f} ms", flush=True)
    dt_pal = timeit(lambda M: cache.graphed(("breakdown.inverse_pallas",), K3.spd_inverse, M), kkts, reps=reps,
                    device=device)
    print(f"KKT inverse (pallas):      {dt_pal*1e3:8.2f} ms", flush=True)
    dt_xla = timeit(lambda M: cache.graphed(("breakdown.inverse_xla",), spd_inverse, M), kkts, reps=reps,
                    device=device)
    print(f"KKT inverse (xla chol):    {dt_xla*1e3:8.2f} ms", flush=True)

    # residual evaluation
    z0 = torch.zeros(B, cfg.n_vars, device=device)
    dt_res = timeit(lambda p, z: cache.graphed(("breakdown.residuals", cfg), lambda q, zz: F.residuals(cfg, q, zz),
                                               p, z), bp, z0, reps=reps, device=device)
    print(f"residual eval (batched):   {dt_res*1e3:8.2f} ms", flush=True)
    cache.clear()

    accounted = dt_gn + dt_pal + n_admm * admm_iter_ms / 1e3
    print(
        f"accounted: GN {dt_gn*1e3:.1f} + inv {dt_pal*1e3:.1f} + admm {admm_iter_ms*n_admm:.1f}"
        f" = {accounted*1e3:.1f} ms of {results['full(2,24)']*1e3:.1f} ms"
    )
    return dict(results, admm_iter=admm_iter_ms / 1e3, second_sqp=sqp_ms / 1e3, gn_build=dt_gn, inverse_pallas=dt_pal,
                inverse_xla=dt_xla, residuals=dt_res, accounted=accounted)


if __name__ == "__main__":
    main()

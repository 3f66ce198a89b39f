"""Solver parity check: the port's SQP vs the independent scipy-f64 oracle.

The counterpart of `python -m cmw_tpu.apps.parity`, with the same cases,
flags and JSON keys (`jax_cost` holds the cost of the solver under test, here
the port's, so that one reader takes both CLIs' output). The solve runs on
the card unless `--cpu` is given; the oracle reads each case's parameters as
CPU tensors of one item. `parity_ok` is true when every case's cost ratio is
at most 1.02 and the oracle converged (status 0).

Example: python -m cmw_tpu_torch.apps.parity --horizon 0.6
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import torch

from cmw_tpu_torch.cmpc import CentroidalMPCSolver, MPCParams, ergocub_mpc_config, oracle
from cmw_tpu_torch.core import contacts
from cmw_tpu_torch.core.centroidal import pack_state


def _tree(fn, *trees):
    """fn over the tensors of equally shaped (nested) MPCParams."""
    if isinstance(trees[0], torch.Tensor):
        return fn(*trees)
    return type(trees[0])(*(_tree(fn, *parts) for parts in zip(*trees)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--horizon", type=float, default=0.6)
    p.add_argument("--sqp-iters", type=int, default=10)
    p.add_argument("--admm-iters", type=int, default=150)
    p.add_argument("--cpu", action="store_true", help="solve on the CPU (default: the card)")
    args = p.parse_args(argv)
    dev = "cpu" if args.cpu else "cuda"

    cfg = ergocub_mpc_config(horizon=args.horizon, sqp_iters=args.sqp_iters, admm_iters=args.admm_iters)
    solver = CentroidalMPCSolver(cfg)

    def vec(values):
        return torch.tensor(values, dtype=torch.float32, device=dev)

    def case(plan, t0, com0, x0=None, push=(0.0, 0.0, 0.0), drift=0.0):
        stage = contacts.mpc_stage_params(plan, t0, cfg.T, cfg.dt, cfg.n_slots)
        com_ref = vec(com0).expand(cfg.N, 3)
        if drift:
            com_ref = com_ref + drift * cfg.dt * torch.arange(cfg.N, device=dev)[:, None] * vec([1.0, 0.0, 0.0])
        zero = torch.zeros(3, device=dev)
        return MPCParams(
            x0=pack_state(vec(x0 if x0 is not None else com0), zero, zero),
            com_ref=com_ref,
            ang_mom_ref=torch.zeros(cfg.N, 3, device=dev),
            stage=stage,
            ext_force=vec(push),
            ext_torque=zero,
        )

    # standing with offset
    plan = contacts.empty_plan(2, 8, device=dev)
    act, deact, pos, valid = plan.act.clone(), plan.deact.clone(), plan.pos.clone(), plan.valid.clone()
    act[:, 0] = 0.0
    deact[:, 0] = 1e6
    valid[:, 0] = 1.0
    pos[0, 0, 1] = 0.08
    pos[1, 0, 1] = -0.08
    plan = plan._replace(act=act, deact=deact, pos=pos, valid=valid)
    gait = contacts.snap_to_grid(contacts.make_alternating_gait(n_steps=8, device=dev), cfg.dt)
    cases = {
        "standing_offset": case(plan, 0.0, [0.0, 0.0, 0.7], x0=[0.03, 0.01, 0.69]),
        "walking": case(gait, 0.9, [0.0, 0.0, 0.7], drift=0.1),
        "walking_push": case(gait, 1.02, [0.0, 0.0, 0.7], push=(0.0, 1.0, 0.0), drift=0.08),
    }

    # the oracle's SLSQP takes tens of seconds a case on one core: the three
    # run in processes of their own while the solver runs here, the cases as
    # one batch. Each process gets copies: sending a CPU tensor to a process
    # moves its storage to shared memory in the pool's thread, under the
    # solver's feet
    with ProcessPoolExecutor(len(cases), mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(oracle.solve_oracle, cfg, _tree(lambda a: a.cpu().clone(), params))
                   for params in cases.values()]
        batch = _tree(lambda *a: torch.stack(a), *cases.values())
        sol = solver.solve(batch, solver.cold_start(len(cases), device=dev))
        costs, prims = sol.cost.tolist(), sol.prim_res.tolist()
        results = []
        for k, (name, future) in enumerate(zip(cases, futures)):
            _, c_o, res = future.result()
            results.append(
                {
                    "case": name,
                    "jax_cost": round(costs[k], 5),
                    "oracle_cost": round(float(c_o), 5),
                    "ratio": round(costs[k] / max(c_o, 1e-9), 4),
                    "oracle_status": int(res.status),
                    "prim_res": prims[k],
                }
            )

    ok = all(r["ratio"] <= 1.02 and r["oracle_status"] == 0 for r in results)
    out = {"parity_ok": ok, "cases": results}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

"""Entry points of the PyTorch package: one solve at the production
configuration, and the multi-process dry run of the production workloads.

The counterpart of the repository's `__graft_entry__.py`. `entry()` returns
(fn, example_args) for one solve of the flagship configuration; where JAX
shards over a device mesh, `dryrun_multichip(n)` runs n ranks of a
`torch.distributed` process group (`dist/ranks.py`): NCCL, one card a rank,
unless the caller passes device="cpu" (gloo).

The episode of the dry run needs the MANN ONNX file, which JAX's reads from
the reference repository's checkout; here the caller names it.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from cmw_tpu_torch.cmpc import CentroidalMPCSolver, MPCParams, ergocub_mpc_config
from cmw_tpu_torch.core import contacts
from cmw_tpu_torch.core.centroidal import pack_state
from cmw_tpu_torch.dist.ranks import run_ranks


def example(cfg, pushes, device="cuda"):
    """(solver, params [B, ...]): the 8-step gait at t0 = 1.02 s (left foot
    swinging), standing at 0.7 m, one item per lateral push in `pushes` [B]."""
    solver = CentroidalMPCSolver(cfg)
    plan = contacts.snap_to_grid(contacts.make_alternating_gait(n_steps=8, device=device), cfg.dt)
    stage = contacts.mpc_stage_params(plan, 1.02, cfg.T, cfg.dt, cfg.n_slots)
    pushes = torch.as_tensor(pushes, dtype=torch.float32, device=device)
    B = pushes.shape[0]
    com0 = torch.tensor([0.0, 0.0, 0.7], device=device)
    zero = torch.zeros(B, 3, device=device)
    params = MPCParams(
        x0=pack_state(com0.expand(B, 3), zero, zero),
        com_ref=com0.expand(B, cfg.N, 3),
        ang_mom_ref=torch.zeros(B, cfg.N, 3, device=device),
        stage=type(stage)(*(a.expand(B, *a.shape) for a in stage)),
        ext_force=torch.stack([torch.zeros_like(pushes), pushes, torch.zeros_like(pushes)], dim=-1),
        ext_torque=zero,
    )
    return solver, params


def entry(device="cuda"):
    """(fn, example_args): one centroidal-MPC solve at ergocub_mpc_config()
    (the flagship), on a batch of one."""
    solver, params = example(ergocub_mpc_config(), [0.0], device)
    return solver.solve, (params, solver.cold_start(1, device=device))


def _dryrun_rank(rank: int, world: int, device: str, mann: str):
    """One rank of dryrun_multichip: items [2 rank, 2 rank + 2) of the
    batch 2 world, then one item of the episode."""
    from cmw_tpu_torch.core import kinematics as kin
    from cmw_tpu_torch.mann.network import load_mann_weights
    from cmw_tpu_torch.runtime.config import ergocub_gazebo_v1
    from cmw_tpu_torch.runtime.loop import WalkingController, constant_inputs

    # --- 1. the production-config solve, 2 items a rank ------------------------
    cfg = ergocub_mpc_config()  # production trip counts (sqp 2 / admm 24)
    B = 2 * world
    pushes = torch.linspace(-1.0, 1.0, B)[2 * rank:2 * rank + 2]
    solver, params = example(cfg, pushes, device)
    sols = solver.solve(params, solver.cold_start(2, device=device))
    mean_cost = sols.cost.mean()
    dist.all_reduce(mean_cost)
    mean_cost = float(mean_cost) / world
    assert sols.forces.shape[0] == 2 and math.isfinite(mean_cost), mean_cost
    if rank == 0:
        print(f"dryrun_multichip solver OK: {world} ranks, sqp {cfg.sqp_iters} x admm {cfg.admm_iters}, "
              f"mean cost {mean_cost:.3f}")

    # --- 2. the walking episode, one scenario a rank ---------------------------
    ctl = WalkingController(ergocub_gazebo_v1(), kin.ergocub_approx(), load_mann_weights(mann, device=device),
                            device=device)
    S = 2 * ctl.cfg.mpc_every  # two MPC periods of WBC ticks
    inputs = constant_inputs(S, (0.8, 0.0, 1.0, 0.0), device=device)
    ext = inputs.ext_force.clone()
    ext[:, S // 2:, 1] = float(torch.linspace(0.0, 1.0, world)[rank])
    sN, tel = ctl.run_episode_blocked(ctl.initial_state(1), inputs._replace(ext_force=ext))
    com_max = tel.com_mpc.abs().max()
    dist.all_reduce(com_max, op=dist.ReduceOp.MAX)
    com_max = float(com_max)
    assert sN.x9.shape[0] == 1 and com_max < 10.0, com_max
    if rank == 0:
        print(f"dryrun_multichip episode OK: {world} ranks x {S} WBC ticks (MANN+MPC+IK graph), "
              f"max|com| {com_max:.3f}")
    return {"mean_cost": mean_cost, "com_max": com_max}


def dryrun_multichip(n_devices: int, mann: str, *, device="cuda") -> dict:
    """Run the PRODUCTION workloads on n ranks and reduce across them:

      1. the production-config MPC solve (sqp 2 / admm 24), the batch
         2 n_devices split 2 items a rank, the mean cost all-reduced;
      2. the closed-loop walking episode (MANN + MPC + WBC IK) over two MPC
         periods, one scenario a rank (pushed from mid-episode by
         linspace(0, 1, n) m/s^2 sideways), max |com| all-reduced.

    `mann` is the MANN ONNX file. Returns rank 0's {"mean_cost", "com_max"}.
    """
    return run_ranks(n_devices, "cmw_tpu_torch.entry:_dryrun_rank", {"mann": mann}, device)

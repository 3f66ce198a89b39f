"""The solve chain's parameters, worked out by the reference from the
benchmark's inputs (a copy of the program's `apps/bench.make_params`)."""

from __future__ import annotations

import torch

from portbench.reference.cmpc.formulation import MPCParams
from portbench.reference.core import contacts
from portbench.reference.core.centroidal import pack_state


def make_params(cfg, pushes, t0: float, *, device="cuda", dtype=torch.float32) -> MPCParams:
    """The walking parameters, one item per push row of pushes [B, 3]: the
    8-step alternating gait snapped to the grid at t0, the CoM at 0.7 m at
    rest, its reference moving forward at 0.08 m/s."""
    plan = contacts.snap_to_grid(contacts.make_alternating_gait(n_steps=8, device=device, dtype=dtype), cfg.dt)
    stage = contacts.mpc_stage_params(plan, t0, cfg.T, cfg.dt, cfg.n_slots)
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

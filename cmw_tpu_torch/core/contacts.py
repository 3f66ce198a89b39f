"""Fixed-shape contact plans — the solver's part of `cmw_tpu/core/contacts.py`.

A plan is a NamedTuple of padded tensors: per contact (foot) up to P phases,
each with activation/deactivation time, pose and a validity flag. Invalid
phases carry BIG_TIME times so time comparisons are vacuous. Every function
takes any number of leading batch dimensions in front of the plan's own.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BIG_TIME = 1e9


class ContactPlan(NamedTuple):
    """Padded footstep plan. nc contacts (0=left, 1=right), P phase slots."""

    act: torch.Tensor  # [..., nc, P] activation times (s); BIG_TIME if invalid
    deact: torch.Tensor  # [..., nc, P] deactivation times (s)
    pos: torch.Tensor  # [..., nc, P, 3] contact (sole) position, world
    rot: torch.Tensor  # [..., nc, P, 3, 3] contact orientation, world
    valid: torch.Tensor  # [..., nc, P] {0., 1.}


def empty_plan(nc: int = 2, P: int = 16, *, device="cuda", dtype=torch.float32) -> ContactPlan:
    eye = torch.eye(3, dtype=dtype, device=device).expand(nc, P, 3, 3).clone()
    return ContactPlan(
        act=torch.full((nc, P), BIG_TIME, dtype=dtype, device=device),
        deact=torch.full((nc, P), BIG_TIME, dtype=dtype, device=device),
        pos=torch.zeros((nc, P, 3), dtype=dtype, device=device),
        rot=eye,
        valid=torch.zeros((nc, P), dtype=dtype, device=device),
    )


def snap_to_grid(plan: ContactPlan, dt: float) -> ContactPlan:
    """Round phase boundaries to the MPC grid (half to even, as jnp.round)."""

    def snap(t):
        return torch.where(plan.valid > 0, torch.round(t / dt) * dt, t)

    return plan._replace(act=snap(plan.act), deact=snap(plan.deact))


class MPCStageParams(NamedTuple):
    """Fixed-shape per-horizon contact parameters for the MPC solver.

    Shapes: T force intervals, nc contacts, K adjustable-position slots.
    """

    active: torch.Tensor  # [..., nc, T] contact active during interval k
    slot_onehot: torch.Tensor  # [..., nc, T, K] interval -> position-slot map
    slot_pos_nom: torch.Tensor  # [..., nc, K, 3] nominal contact position
    slot_rot: torch.Tensor  # [..., nc, K, 3, 3] contact orientation
    slot_valid: torch.Tensor  # [..., nc, K]
    slot_adjustable: torch.Tensor  # [..., nc, K] 1 if contact starts in the future
    slot_act: torch.Tensor  # [..., nc, K] phase activation times (warm-start keying)
    slot_deact: torch.Tensor  # [..., nc, K]


def _time(t0, like):
    """t0 as a Python float (weakly typed, as in jnp) or as a tensor [...] of
    the plan's leading batch shape, then shaped [..., 1, 1] to broadcast
    against the plan's per-contact tensors [..., nc, P]."""
    if isinstance(t0, torch.Tensor):
        return t0.to(dtype=like.dtype, device=like.device)[..., None, None]
    return float(t0)


def mpc_stage_params(plan: ContactPlan, t0, T: int, dt: float, K: int) -> MPCStageParams:
    """Pack a contact plan into fixed-shape MPC parameters.

    Interval k covers [t0 + k dt, t0 + (k+1) dt); a contact is active on the
    interval if its phase contains the interval midpoint. `t0` is a float or
    a tensor with the plan's leading batch shape.
    """
    P = plan.act.shape[-1]
    dtype, device = plan.act.dtype, plan.act.device
    t0x = _time(t0, plan.act)  # float or [..., 1, 1]
    tk = t0x + dt * torch.arange(T, dtype=dtype, device=device) + 0.5 * dt  # [T] or [..., 1, T]
    tk = tk[..., None]  # [T, 1] or [..., 1, T, 1]
    # [..., nc, T, P] phase membership per interval
    m = (
        plan.valid[..., :, None, :]
        * (plan.act[..., :, None, :] <= tk)
        * (tk < plan.deact[..., :, None, :])
    )
    active = m.amax(dim=-1)  # [..., nc, T]
    phase_idx = torch.argmax(m, dim=-1)  # first maximum, as jnp.argmax

    # first phase still relevant at t0 (deact > t0): the "slot 0" phase
    rel = plan.valid * (plan.deact > t0x + 0.5 * dt)
    first = torch.argmax(rel, dim=-1)  # [..., nc]
    has_rel = rel.amax(dim=-1)

    ks = torch.arange(K, device=device)
    slot = phase_idx - first[..., None]  # [..., nc, T]
    slot_oh = (
        (slot[..., None] == ks) * active[..., None] * has_rel[..., None, None]
    ).to(dtype)

    slot_phase = torch.clamp(first[..., None] + ks, 0, P - 1)  # [..., nc, K]

    def take(a, trailing: int):
        idx = slot_phase.reshape(slot_phase.shape + (1,) * trailing)
        idx = idx.expand(slot_phase.shape + a.shape[a.dim() - trailing:])
        return torch.take_along_dim(a, idx, dim=-1 - trailing)

    slot_valid = (
        take(plan.valid, 0)
        * (first[..., None] + ks < P)
        * has_rel[..., None]
    )
    slot_act = take(plan.act, 0)
    slot_adj = slot_valid * (slot_act > t0x + 0.5 * dt)
    return MPCStageParams(
        active=active.to(dtype),
        slot_onehot=slot_oh,
        slot_pos_nom=take(plan.pos, 1),
        slot_rot=take(plan.rot, 2),
        slot_valid=slot_valid.to(dtype),
        slot_adjustable=slot_adj.to(dtype),
        slot_act=slot_act,
        slot_deact=take(plan.deact, 0),
    )


def make_alternating_gait(
    nc_phases: int = 16,
    t_first_lift: float = 1.0,
    single_support: float = 0.50,
    double_support: float = 0.20,
    step_length: float = 0.10,
    step_width: float = 0.16,
    n_steps: int = 10,
    first_swing: int = 0,
    z: float = 0.0,
    *,
    device="cuda",
    dtype=torch.float32,
) -> ContactPlan:
    """Host-side scripted alternating-foot gait (numpy -> tensors on `device`,
    the card unless the caller passes another).

    Both feet start in stance at +-step_width/2. From t_first_lift, feet
    alternate swings of `single_support` seconds separated by
    `double_support` overlap, advancing `step_length` per step.
    """
    npd = torch.empty((), dtype=dtype).numpy().dtype
    P = nc_phases
    act = np.full((2, P), BIG_TIME, npd)
    deact = np.full((2, P), BIG_TIME, npd)
    pos = np.zeros((2, P, 3), npd)
    rot = np.broadcast_to(np.eye(3, dtype=npd), (2, P, 3, 3)).copy()
    valid = np.zeros((2, P), npd)

    y = np.array([step_width / 2.0, -step_width / 2.0], npd)
    x = np.zeros(2, npd)
    phase_count = [0, 0]

    def add_phase(i, a, d, px):
        k = phase_count[i]
        if k >= P:
            return
        act[i, k] = a
        deact[i, k] = d
        pos[i, k] = [px, y[i], z]
        valid[i, k] = 1.0
        phase_count[i] = k + 1

    # schedule: swing foot lifts at t, lands at t+single_support; stance foot
    # keeps contact until its own lift (t + single_support + double_support)
    t = t_first_lift
    swing = first_swing
    lands = []
    for _ in range(n_steps):
        x[swing] += step_length
        lands.append((swing, t, t + single_support, float(x[swing])))
        t = t + single_support + double_support
        swing = 1 - swing

    # contact (stance) intervals: from landing (or 0) until the next lift
    lift_times = {0: [], 1: []}
    land_times = {0: [(0.0, 0.0)], 1: [(0.0, 0.0)]}
    for foot, t_lift, t_land, px in lands:
        lift_times[foot].append(t_lift)
        land_times[foot].append((t_land, px))
    for i in (0, 1):
        lts = lift_times[i] + [BIG_TIME]
        for k, (t_land, px) in enumerate(land_times[i]):
            add_phase(i, t_land, lts[k] if k < len(lts) else BIG_TIME, px)

    def tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return ContactPlan(
        act=tensor(act), deact=tensor(deact), pos=tensor(pos), rot=tensor(rot), valid=tensor(valid)
    )

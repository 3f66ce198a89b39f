"""Fixed-shape contact plans: PyTorch counterpart of `cmw_tpu/core/contacts.py`.

A plan is a NamedTuple of padded tensors: per contact (foot) up to P phases,
each with activation/deactivation time, pose and a validity flag. Invalid
phases carry BIG_TIME times so time comparisons are vacuous. Every function
takes any number of leading batch dimensions in front of the plan's own; a
time `t` is a float or a tensor of the plan's leading batch shape.

  active_phase / next_phase / present_phase   the phase at, after or before t
  gather_phase                                per-contact phase data at indices
  snap_to_grid                                round boundaries to the MPC grid
  merge_plans                                 receding-horizon contact merge
  mpc_stage_params                            pack a plan for the MPC solver
  write_back_adjusted                         MPC-adjusted footsteps -> plan
  plan_from_timeline                          sampled contact flags -> plan
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

    @property
    def num_contacts(self) -> int:
        return self.act.shape[-2]

    @property
    def num_phases(self) -> int:
        return self.act.shape[-1]


def empty_plan(nc: int = 2, P: int = 16, *, device="cuda", dtype=torch.float32) -> ContactPlan:
    eye = torch.eye(3, dtype=dtype, device=device).expand(nc, P, 3, 3).clone()
    return ContactPlan(
        act=torch.full((nc, P), BIG_TIME, dtype=dtype, device=device),
        deact=torch.full((nc, P), BIG_TIME, dtype=dtype, device=device),
        pos=torch.zeros((nc, P, 3), dtype=dtype, device=device),
        rot=eye,
        valid=torch.zeros((nc, P), dtype=dtype, device=device),
    )


def _time(t0, like, trailing: int = 2):
    """t0 as a Python float (weakly typed, as in jnp) or as a tensor [...] of
    the plan's leading batch shape, then shaped [..., 1, 1] (`trailing` ones)
    to broadcast against the plan's per-contact tensors [..., nc, P]."""
    if isinstance(t0, torch.Tensor):
        return t0.to(dtype=like.dtype, device=like.device)[(...,) + (None,) * trailing]
    return float(t0)


_T_TOL = 1e-4  # half-tick slack: f32 time accumulation vs grid-snapped phases


def _phase_mask_at(plan: ContactPlan, t) -> torch.Tensor:
    """[..., nc, P] mask of phases active at time t (act <= t < deact), with a
    small tolerance so accumulated-f32 times at exact phase boundaries
    resolve to the newly-started phase."""
    t = _time(t, plan.act)
    return plan.valid * (plan.act <= t + _T_TOL) * (t + _T_TOL < plan.deact)


def active_phase(plan: ContactPlan, t):
    """Per contact: (phase index, in_contact flag) at time t. The index is the
    first active phase, 0 if there is none (torch.argmax takes the first
    maximum, as jnp.argmax)."""
    m = _phase_mask_at(plan, t)
    return torch.argmax(m, dim=-1), m.amax(dim=-1)


def next_phase(plan: ContactPlan, t):
    """Per contact: (index of first phase with act > t, exists flag)."""
    m = plan.valid * (plan.act > _time(t, plan.act))
    return torch.argmax(m, dim=-1), m.amax(dim=-1)


def present_phase(plan: ContactPlan, t):
    """Per contact: last phase with act <= t (active or most recent)."""
    m = plan.valid * (plan.act <= _time(t, plan.act))
    P = plan.act.shape[-1]
    # last True: argmax over the reversed phases
    idx = P - 1 - torch.argmax(torch.flip(m, dims=(-1,)), dim=-1)
    return idx, m.amax(dim=-1)


def _take_phase(a, idx, trailing: int):
    """a [..., nc, P, *trailing dims] at per-contact phase indices idx [..., nc]."""
    i = idx.reshape(idx.shape + (1,) * (trailing + 1))
    i = i.expand(idx.shape + (1,) + a.shape[a.dim() - trailing:])
    return torch.take_along_dim(a, i, dim=-1 - trailing).squeeze(-1 - trailing)


def gather_phase(plan: ContactPlan, idx):
    """Per-contact phase data (act, deact, pos, rot, valid) at indices idx [..., nc]."""
    return (_take_phase(plan.act, idx, 0), _take_phase(plan.deact, idx, 0), _take_phase(plan.pos, idx, 1),
            _take_phase(plan.rot, idx, 2), _take_phase(plan.valid, idx, 0))


def snap_to_grid(plan: ContactPlan, dt: float) -> ContactPlan:
    """Round phase boundaries to the MPC grid (half to even, as jnp.round)."""

    def snap(t):
        return torch.where(plan.valid > 0, torch.round(t / dt) * dt, t)

    return plan._replace(act=snap(plan.act), deact=snap(plan.deact))


def merge_plans(mann: ContactPlan, mpc: ContactPlan, t) -> ContactPlan:
    """Receding-horizon contact merge.

    For each foot: keep all future MANN contacts (act > t) verbatim; for the
    current contact, keep the MPC-adjusted pose but the MANN timing. If the
    MPC has no active contact at t, fall through to MANN-only.
    """
    P = mann.act.shape[-1]
    mpc_idx, mpc_active = active_phase(mpc, t)
    mann_idx, mann_active = active_phase(mann, t)
    mpc_act_t, _, mpc_pos, mpc_rot, _ = gather_phase(mpc, mpc_idx)
    use_merged = mpc_active * mann_active  # [..., nc]

    # phase j of the output = (j == current mann phase) ? merged : mann phase
    # j, dropping mann phases with act <= t that are not current
    phases = torch.arange(P, device=mann.act.device)
    is_future = mann.valid * (mann.act > _time(t, mann.act))
    is_current = (phases == mann_idx[..., None]) * mann_active[..., None]
    keep = torch.maximum(is_future, is_current)

    sel = is_current * use_merged[..., None]  # [..., nc, P]: mpc pose on the current phase
    pos = torch.where(sel[..., None] > 0, mpc_pos[..., None, :], mann.pos)
    rot = torch.where(sel[..., None, None] > 0, mpc_rot[..., None, :, :], mann.rot)
    act = torch.where(keep > 0, mann.act, BIG_TIME)
    deact = torch.where(keep > 0, mann.deact, BIG_TIME)
    valid = keep

    # The regenerated MANN timeline only starts at t, so its current phase's
    # activation is clipped to ~t; restore the true activation time from the
    # previous plan.
    act = torch.where(sel > 0, torch.minimum(act, mpc_act_t[..., None]), act)

    # A foot swinging at t has no active contact in either plan, but the
    # swing planner must interpolate from its previous stance pose: retain
    # the old plan's most recent past phase in the (free) last slot.
    prev_idx, has_prev = present_phase(mpc, t)
    pa, pd, ppos, prot, _ = gather_phase(mpc, prev_idx)
    keep_past = (1.0 - mann_active) * has_prev  # [..., nc]
    last = phases == P - 1
    put = (keep_past > 0)[..., None] & last  # [..., nc, P]: the last slot of a swinging foot
    act = torch.where(put, pa[..., None], act)
    deact = torch.where(put, torch.clamp(pd, max=_time(t, pd, 1))[..., None], deact)
    valid = torch.where(last, torch.maximum(valid, keep_past[..., None]), valid)
    pos = torch.where(put[..., None], ppos[..., None, :], pos)
    rot = torch.where(put[..., None, None], prot[..., None, :, :], rot)
    return ContactPlan(act=act, deact=deact, pos=pos, rot=rot, valid=valid)


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


def write_back_adjusted(plan: ContactPlan, t0, K: int, slot_pos, slot_valid) -> ContactPlan:
    """Write MPC-adjusted slot positions [..., nc, K, 3] back into the plan
    (the MPC output's updated contact list, which the swing-foot planners
    consume)."""
    P = plan.act.shape[-1]
    rel = plan.valid * (plan.deact > _time(t0, plan.act))
    first = torch.argmax(rel, dim=-1)
    has_rel = rel.amax(dim=-1)
    # scatter slot_pos into phases first..first+K-1 where slot_valid
    slot_of_phase = torch.arange(P, device=plan.act.device) - first[..., None]  # [..., nc, P]
    in_slots = (slot_of_phase >= 0) & (slot_of_phase < K)
    slot_idx = torch.clamp(slot_of_phase, 0, K - 1)
    gathered = torch.take_along_dim(slot_pos, slot_idx[..., None].expand(slot_idx.shape + (3,)), dim=-2)
    sv = torch.take_along_dim(slot_valid, slot_idx, dim=-1)
    use = (in_slots & (sv > 0) & (has_rel[..., None] > 0) & (plan.valid > 0))[..., None]
    return plan._replace(pos=torch.where(use, gathered, plan.pos))


def plan_from_timeline(flags, times, pos, rot, P: int = 16) -> ContactPlan:
    """Convert a sampled contact timeline into a padded ContactPlan.

    flags [..., S, nc] in {0,1}; times [..., S]; pos [..., S, nc, 3]; rot
    [..., S, nc, 3, 3] (the locked stance pose at each sample, constant
    within a phase). A phase open at the last sample is left open
    (deactivation = BIG_TIME); phases past the P-th are dropped.
    """
    S = flags.shape[-2]
    dtype, device = flags.dtype, flags.device
    dt_s = (times[..., 1] - times[..., 0])[..., None, None]
    prev = torch.cat([torch.zeros_like(flags[..., :1, :]), flags[..., :-1, :]], dim=-2)
    rising = flags * (1.0 - prev)  # [..., S, nc]
    phase_id = torch.cumsum(rising, dim=-2) - 1.0  # valid where flags
    pid = torch.arange(P, dtype=dtype, device=device)
    onehot = ((phase_id[..., None] == pid) * (flags[..., None] > 0)).to(dtype)  # [..., S, nc, P]
    on = onehot > 0

    t_b = times[..., :, None, None]
    act = torch.where(on, t_b, BIG_TIME).amin(dim=-3)  # [..., nc, P]
    last_t = torch.where(on, t_b, -1.0).amax(dim=-3)
    valid = (onehot.amax(dim=-3) > 0).to(dtype)
    open_end = onehot[..., -1, :, :]  # the phase contains the final sample
    deact = torch.where(open_end > 0, BIG_TIME, last_t + dt_s)
    deact = torch.where(valid > 0, deact, BIG_TIME)
    act = torch.where(valid > 0, act, BIG_TIME)

    # pose: the sample at the last step of each phase
    samples = torch.arange(S, dtype=dtype, device=device)[:, None, None]
    last_idx = torch.argmax(torch.where(on, samples, -1.0), dim=-3)  # [..., nc, P]
    pos_p = torch.take_along_dim(pos.movedim(-3, -2), last_idx[..., None].expand(last_idx.shape + (3,)), dim=-2)
    rot_p = torch.take_along_dim(rot.movedim(-4, -3), last_idx[..., None, None].expand(last_idx.shape + (3, 3)),
                                 dim=-3)
    return ContactPlan(act=act, deact=deact, pos=pos_p, rot=rot_p, valid=valid)


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

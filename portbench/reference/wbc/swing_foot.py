"""Swing-foot SE3 trajectory from a contact plan.

PyTorch counterpart of `cmw_tpu/wbc/swing_foot.py` (BLF
`Planners::SwingFootPlanner` x2, reference WholeBodyQPBlock.cpp:231-261,
1092-1119; swing_foot_planner.ini: step_height 0.035, foot_apex_time 0.5,
landing velocity/acceleration 0).

Each foot holds its contact pose in stance; in swing it goes from the
previous contact pose to the next one: xy and yaw by a quintic time scaling
with zero boundary velocity and acceleration, z by two quintic segments
through an apex step_height above the higher end at foot_apex_time of the
swing. Batch-first: the plan is [B, nc, P, ...] and t [B].
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from portbench.reference.core import contacts as C
from portbench.reference.core import lie
from portbench.reference.core.splines import quintic_hermite, quintic_timescale


@dataclasses.dataclass(frozen=True)
class SwingFootConfig:
    step_height: float = 0.035
    foot_apex_time: float = 0.5  # fraction of the swing interval
    landing_velocity: float = 0.0
    landing_acceleration: float = 0.0


class FootState(NamedTuple):
    rot: torch.Tensor  # [B, nc, 3, 3]
    pos: torch.Tensor  # [B, nc, 3]
    lin_vel: torch.Tensor  # [B, nc, 3]
    ang_vel: torch.Tensor  # [B, nc, 3]
    in_contact: torch.Tensor  # [B, nc]
    progress: torch.Tensor  # [B, nc] swing phase fraction in [0, 1]; 0 in stance


def evaluate(plan: C.ContactPlan, t, cfg: SwingFootConfig = SwingFootConfig()) -> FootState:
    """Foot pose and velocity of every contact at time t ([B], or a float)."""
    if not isinstance(t, torch.Tensor):
        t = torch.full(plan.act.shape[:-2], float(t), dtype=plan.act.dtype, device=plan.act.device)
    cur_idx, in_contact = C.active_phase(plan, t)
    # previous contact = last phase with act <= t; next = first with act > t
    prev_idx, _ = C.present_phase(plan, t)
    next_idx, has_next = C.next_phase(plan, t)

    _, d_p, pos_p, rot_p, _ = C.gather_phase(plan, prev_idx)
    a_n, _, pos_n, rot_n, _ = C.gather_phase(plan, next_idx)
    _, _, pos_c, rot_c, _ = C.gather_phase(plan, cur_idx)

    tc = t[..., None]  # [B, 1] against the per-contact [B, nc]
    # swing window: from the previous deactivation to the next activation
    t0 = d_p
    t1 = torch.where(has_next > 0, a_n, d_p + 1.0)
    dur = torch.clamp(t1 - t0, min=1e-6)

    s, ds = quintic_timescale(tc, t0, t1)  # [B, nc]
    # xy and yaw interpolate on the time-scaled geodesic
    xy = pos_p[..., 0:2] + s[..., None] * (pos_n[..., 0:2] - pos_p[..., 0:2])
    v_xy = ds[..., None] * (pos_n[..., 0:2] - pos_p[..., 0:2])
    yaw_p = lie.yaw_of(rot_p)
    dyaw = lie.yaw_of(rot_p.transpose(-1, -2) @ rot_n)
    yaw = yaw_p + s * dyaw
    w_z = ds * dyaw

    # z: two quintic segments through the apex
    z_apex = torch.maximum(pos_p[..., 2], pos_n[..., 2]) + cfg.step_height
    t_apex = t0 + cfg.foot_apex_time * dur
    zeros = torch.zeros_like(z_apex)[..., None]
    z_up, vz_up, _ = quintic_hermite(tc, t0, t_apex, pos_p[..., 2:3], zeros, zeros, z_apex[..., None], zeros, zeros)
    z_dn, vz_dn, _ = quintic_hermite(
        tc, t_apex, t1, z_apex[..., None], zeros, zeros, pos_n[..., 2:3],
        zeros + cfg.landing_velocity, zeros + cfg.landing_acceleration,
    )
    before_apex = (tc < t_apex)[..., None]
    z = torch.where(before_apex, z_up, z_dn)
    vz = torch.where(before_apex, vz_up, vz_dn)

    swing_pos = torch.cat([xy, z], dim=-1)
    swing_vel = torch.cat([v_xy, vz], dim=-1)
    swing_rot = lie.rotz(yaw)
    swing_w = torch.stack([torch.zeros_like(w_z), torch.zeros_like(w_z), w_z], dim=-1)

    in_c = in_contact[..., None] > 0
    return FootState(
        rot=torch.where(in_c[..., None], rot_c, swing_rot),
        pos=torch.where(in_c, pos_c, swing_pos),
        lin_vel=torch.where(in_c, 0.0, swing_vel),
        ang_vel=torch.where(in_c, 0.0, swing_w),
        in_contact=in_contact,
        progress=torch.where(in_contact > 0, 0.0, torch.clamp((tc - t0) / dur, 0.0, 1.0)),
    )

"""Contact-aided legged odometry: floating-base pose from the fixed foot.

PyTorch counterpart of `cmw_tpu/estimation/legged_odom.py` (BLF
`Estimators::LeggedOdometry`, reference WholeBodyQPBlock.cpp:92-128,
263-320; legged_odometry.ini: `initial_fixed_frame l_sole`,
`switching_pattern useExternal`), batch-first.

The fixed sole's world pose is pinned; the base pose follows from the
measured joints through the kinematic chain,
  T_world_base = T_world_sole * (T_base_sole(q))^-1,
and the base twist from the fixed sole being stationary,
  J_sole(q) nu = 0  =>  v_base = -(J_b)^-1 J_q qdot,
with J_b = [[I, -hat(r)], [0, I]] the base block of the sole Jacobian.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from portbench.reference.core import kinematics as kin
from portbench.reference.core import lie
from portbench.reference.core.consts import eye_like, tensor_like


@dataclasses.dataclass(frozen=True)
class OdomConfig:
    """Per-robot legged_odometry.ini values (all shipped robots share them)."""

    base_link: str = "root_link"
    base_link_imu: str = "root_link"
    left_foot_contact_frame: str = "l_sole"
    right_foot_contact_frame: str = "r_sole"
    initial_fixed_frame: str = "l_sole"
    switching_pattern: str = "useExternal"  # the detector drives the switches

    @property
    def initial_fixed_index(self) -> int:
        """0 = left, 1 = right: the double-support tie-break fed to
        fixed_foot.detect."""
        return 0 if self.initial_fixed_frame == self.left_foot_contact_frame else 1


class OdometryState(NamedTuple):
    fixed_index: torch.Tensor  # [B] long (0 = left, 1 = right)
    fixed_rot: torch.Tensor  # [B, 3, 3] pinned world pose of the fixed sole
    fixed_pos: torch.Tensor  # [B, 3]


def init(model: kin.RobotModel, q, fixed_index=0, sole_rot=None, sole_pos=None) -> OdometryState:
    """From joints q [B, nj]: the fixed sole at the origin unless given."""
    lead = q.shape[:-1]
    return OdometryState(
        fixed_index=tensor_like(fixed_index, q, torch.long).expand(lead),
        fixed_rot=eye_like(3, q).expand(lead + (3, 3)) if sole_rot is None else sole_rot,
        fixed_pos=torch.zeros(lead + (3,), dtype=q.dtype, device=q.device) if sole_pos is None else sole_pos,
    )


def _sole_frames(model: kin.RobotModel):
    return model.frame_index("l_sole"), model.frame_index("r_sole")


def _fixed(state: OdometryState, left, right):
    """The fixed sole's entry of per-foot values [B, ...]."""
    sel = (state.fixed_index == 0).reshape(state.fixed_index.shape + (1,) * (left.dim() - state.fixed_index.dim()))
    return torch.where(sel, left, right)


def base_pose(model: kin.RobotModel, state: OdometryState, q):
    """Base world pose (R [B, 3, 3], p [B, 3]) from joints + pinned fixed sole."""
    lead = q.shape[:-1]
    lR, lp = kin.fk(model, q, eye_like(3, q).expand(lead + (3, 3)), torch.zeros_like(q[..., :3]))
    fR, fp = kin.frame_poses(model, lR, lp)
    li, ri = _sole_frames(model)
    sole_R = _fixed(state, fR[..., li, :, :], fR[..., ri, :, :])
    sole_p = _fixed(state, fp[..., li, :], fp[..., ri, :])
    # T_world_base = T_world_sole * inv(T_base_sole)
    Rinv, pinv = lie.se3_inverse(sole_R, sole_p)
    return lie.se3_compose(state.fixed_rot, state.fixed_pos, Rinv, pinv)


def base_pose_fused(model: kin.RobotModel, state: OdometryState, q, imu_R):
    """Base pose with IMU-fused attitude (complementary, yaw-preserving):
    roll and pitch from the IMU, yaw from the kinematic anchor,
      R_fused = Rz(yaw_kin) Rz(-yaw_imu) R_imu,
    and the position re-anchored so that the fixed sole's planned position
    stays pinned under the fused attitude (WholeBodyQPBlock.cpp:300-320)."""
    base_R_kin, _ = base_pose(model, state, q)
    R_f = lie.rotz(lie.yaw_of(base_R_kin) - lie.yaw_of(imu_R)) @ imu_R
    lR, lp = kin.fk(model, q, R_f, torch.zeros_like(q[..., :3]))
    _, fp = kin.frame_poses(model, lR, lp)
    li, ri = _sole_frames(model)
    sole_p = _fixed(state, fp[..., li, :], fp[..., ri, :])
    return R_f, state.fixed_pos - sole_p


def base_twist(model: kin.RobotModel, state: OdometryState, q, qd, base_R, base_p):
    """Base twist [B, 6] from the fixed-sole stationarity constraint."""
    lR, lp = kin.fk(model, q, base_R, base_p)
    li, ri = _sole_frames(model)
    J = _fixed(state, kin.frame_jacobian(model, lR, lp, li), kin.frame_jacobian(model, lR, lp, ri))
    Jb, Jq = J[..., :, 0:6], J[..., :, 6:]
    rhs = (-Jq @ qd[..., None])[..., 0]
    # Jb = [[I, -hat(r)], [0, I]] with r = p_sole - p_base, so
    # v = rhs_lin + hat(r) w (the base block's closed-form inverse)
    hat_r = -Jb[..., 0:3, 3:6]
    w = rhs[..., 3:6]
    v = rhs[..., 0:3] + (hat_r @ w[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def switch_fixed_foot(state: OdometryState, new_index, new_rot, new_pos) -> OdometryState:
    """Change the fixed frame (BLF `changeFixedFrame`, WholeBodyQPBlock.cpp:
    300-320): pin the new sole at its planned pose."""
    idx = tensor_like(new_index, state.fixed_index, torch.long).expand(state.fixed_index.shape)
    return OdometryState(fixed_index=idx, fixed_rot=new_rot, fixed_pos=new_pos)

"""Differential inverse kinematics QP: the reference's IK task stack.

PyTorch counterpart of `cmw_tpu/wbc/diff_ik.py` (BLF
`IK::QPInverseKinematics` built from ik.ini, reference
WholeBodyQPBlock.cpp:131-175, solve at :1233-1237), batch-first. Variables
nu = [base linear vel (3), base angular vel (3), qdot (26)] (mixed
representation). Tasks of config/robots/ergoCubGazeboV1/ik.ini:

  priority 0 (hard):  LEFT_FOOT / RIGHT_FOOT SE3Task (kp_lin 5, kp_ang 4),
                      COM CoMTask xy (kp 2), ROOT_TASK R3Task z (kp 1)
  priority 1 (soft):  CHEST SO3Task (kp 5, weight (10, 10, 10)),
                      JOINT_REGULARIZATION JointTrackingTask (kp 5)

Hard tasks are equality rows, soft tasks the weighted objective; with no
inequality rows the QP is one KKT solve (`qp.solve_eq_qp`). The optional
rows (angular momentum, a joint-velocity box, a chest roll/pitch weight)
are added only when their target is given.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from portbench.reference.cmpc.qp import solve_eq_box_qp, solve_eq_qp
from portbench.reference.core import kinematics as kin
from portbench.reference.core import lie
from portbench.reference.core.consts import constant_like, eye_like, tensor_like

_JOINT_REG_WEIGHT = (
    1.0, 1.0, 1.0, 1.0, 1.0, 1.0,  # left leg   (ik.ini weight rows 1-2)
    2.0, 2.0, 2.0, 2.0, 2.0, 2.0,  # right leg / torso block per ik.ini
    2.0, 2.0, 1.0,
    1.0, 1.0, 1.0,
    1.0, 1.0, 1.0, 1.0,
    1.0, 1.0, 1.0, 1.0,
)


@dataclasses.dataclass(frozen=True)
class IKConfig:
    """Per-robot IK task gains (config/robots/<ROBOT>/ik.ini; defaults =
    ergoCubGazeboV1/ik.ini)."""

    kp_foot_lin: float = 5.0
    kp_foot_ang: float = 4.0
    kp_com: float = 2.0
    kp_root: float = 1.0
    kp_chest: float = 5.0
    # per-joint kp tuple (ik.ini JOINT_REGULARIZATION `kp`); a scalar
    # broadcasts over all joints
    kp_posture: tuple | float = 5.0
    chest_frame: str = "chest"  # iCubGenova09 uses "neck_2"
    chest_weight: tuple = (10.0, 10.0, 10.0)
    posture_weight: tuple = _JOINT_REG_WEIGHT
    damping: float = 1e-4  # Tikhonov on the soft objective


class IKTargets(NamedTuple):
    foot_rot: torch.Tensor  # [B, 2, 3, 3]
    foot_pos: torch.Tensor  # [B, 2, 3]
    foot_lin_vel: torch.Tensor  # [B, 2, 3]
    foot_ang_vel: torch.Tensor  # [B, 2, 3]
    com_xy: torch.Tensor  # [B, 2]
    dcom_xy: torch.Tensor  # [B, 2]
    root_z: torch.Tensor  # [B]
    droot_z: torch.Tensor  # [B]
    chest_rot: torch.Tensor  # [B, 3, 3]
    q_reg: torch.Tensor  # [B, 26]
    # optional angular-momentum task: the desired mass-normalised centroidal
    # angular momentum [B, 3] and its soft weight ([B] or a float); None
    # skips the rows
    ang_mom: torch.Tensor | None = None
    ang_mom_w: torch.Tensor | None = None
    # optional joint-velocity box [B, nj] (rad/s); None keeps the
    # reference's equality-only QP, set solves it with qp.solve_eq_box_qp
    qd_lo: torch.Tensor | None = None
    qd_hi: torch.Tensor | None = None
    # optional multiplier [B] on the chest task's roll/pitch weight rows;
    # None keeps the ik.ini weights
    chest_w_rp: torch.Tensor | None = None


def solve_ik(model: kin.RobotModel, q, base_rot, base_pos, targets: IKTargets, cfg: IKConfig = IKConfig()):
    """One IK QP solve per batch item: q [B, nj], base_rot [B, 3, 3],
    base_pos [B, 3]. Returns nu [B, 6 + nj] = [v_base, w_base, qdot]."""
    nj = model.nj
    nv = 6 + nj
    lead = q.shape[:-1]
    lR, lp = kin.fk(model, q, base_rot, base_pos)
    fR, fp = kin.frame_poses(model, lR, lp)

    rows_J, rows_b = [], []
    for i, frame in enumerate(("l_sole", "r_sole")):
        fidx = model.frame_index(frame)
        J = kin.frame_jacobian(model, lR, lp, fidx)
        e_lin = targets.foot_lin_vel[..., i, :] + cfg.kp_foot_lin * (targets.foot_pos[..., i, :] - fp[..., fidx, :])
        e_ang = targets.foot_ang_vel[..., i, :] + cfg.kp_foot_ang * lie.so3_log(
            targets.foot_rot[..., i, :, :] @ fR[..., fidx, :, :].transpose(-1, -2)
        )
        rows_J.append(J)
        rows_b.append(torch.cat([e_lin, e_ang], dim=-1))

    Jcom = kin.com_jacobian(model, lR, lp)
    c = kin.com(model, lR, lp)
    rows_J.append(Jcom[..., 0:2, :])
    rows_b.append(targets.dcom_xy + cfg.kp_com * (targets.com_xy - c[..., 0:2]))

    # ROOT_TASK: R3Task on the root_link origin, mask (0, 0, 1)
    ridx = model.frame_index("root_link")
    Jroot = kin.frame_jacobian(model, lR, lp, ridx)
    rows_J.append(Jroot[..., 2:3, :])
    rows_b.append((targets.droot_z + cfg.kp_root * (targets.root_z - fp[..., ridx, 2]))[..., None])

    A = torch.cat(rows_J, dim=-2)  # [B, 15, nv]
    b = torch.cat(rows_b, dim=-1)

    # soft: chest SO3 + posture
    cidx = model.frame_index(cfg.chest_frame)
    Jchest = kin.frame_jacobian(model, lR, lp, cidx)[..., 3:6, :]
    e_chest = cfg.kp_chest * lie.so3_log(targets.chest_rot @ fR[..., cidx, :, :].transpose(-1, -2))
    w_chest = constant_like(tuple(cfg.chest_weight), q).expand(lead + (3,))
    if targets.chest_w_rp is not None:
        # scale only the world roll/pitch rows; yaw keeps the ik.ini weight
        rp = tensor_like(targets.chest_w_rp, q).expand(lead)
        w_chest = w_chest * torch.stack([rp, rp, torch.ones_like(rp)], dim=-1)

    eye = eye_like(nj, q)
    Jpost = torch.cat([torch.zeros_like(eye[:, :1]).expand(nj, 6), eye], dim=-1).expand(lead + (nj, nv))
    kp_post = tuple(cfg.kp_posture) if isinstance(cfg.kp_posture, (tuple, list)) else float(cfg.kp_posture)
    e_post = constant_like(kp_post, q) * (targets.q_reg - q)
    w_post = constant_like(tuple(cfg.posture_weight), q).expand(lead + (nj,))

    Js = torch.cat([Jchest, Jpost], dim=-2)
    es = torch.cat([e_chest, e_post], dim=-1)
    W = torch.cat([w_chest, w_post], dim=-1)

    if targets.ang_mom is not None:
        # angular-momentum velocity-level task: (A_ang / m) nu = L_des
        A_h = kin.centroidal_momentum_matrix(model, lR, lp)
        J_L = A_h[..., 3:6, :] / model.total_mass
        w_L = tensor_like(targets.ang_mom_w, q)[..., None].expand(lead + (3,))
        Js = torch.cat([Js, J_L], dim=-2)
        es = torch.cat([es, targets.ang_mom], dim=-1)
        W = torch.cat([W, w_L], dim=-1)

    JsW = Js * W[..., :, None]
    H = JsW.transpose(-1, -2) @ Js + cfg.damping * eye_like(nv, q)
    g = (JsW.transpose(-1, -2) @ es[..., None])[..., 0]
    if targets.qd_lo is not None:
        mask = torch.cat([torch.zeros_like(q[..., :6]), torch.ones_like(q)], dim=-1)
        big = torch.full_like(q[..., :6], 1e9)
        lo = torch.cat([-big, targets.qd_lo], dim=-1)
        hi = torch.cat([big, targets.qd_hi], dim=-1)
        return solve_eq_box_qp(H, g, A, b, mask, lo, hi)
    return solve_eq_qp(H, g, A, b)

"""Joystick -> desired base-trajectory input for the MANN generator.

PyTorch counterpart of `cmw_tpu/mann/input_builder.py` (parameters of
mann.ini:22-31): maps the joypad's motion and facing sticks [B, 2] to a
desired future base path [B, K, 2] — velocities clamped to a
forward/side/backward ellipsoid, facing angle clamped to per-quadrant
limits, positions integrated from the limited velocity over K knots.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.core.consts import device_constant as _device_constant


@dataclasses.dataclass(frozen=True)
class InputBuilderConfig:
    # mann.ini:22-31
    base_vel_norm: float = 0.4
    ellipsoid_forward_axis: float = 3.0
    ellipsoid_side_axis: float = 0.3
    ellipsoid_backward_axis: float = 0.8
    ellipsoid_scaling_factor: float = 0.4
    max_facing_angle_forward: float = 0.20
    max_facing_angle_backward: float = 0.1
    max_facing_angle_side_opposite_sign: float = 0.26
    max_facing_angle_side_same_sign: float = 0.17
    number_of_knots: int = 7
    time_horizon: float = 0.8  # mann.ini:15


class DesiredBaseTrajectory(NamedTuple):
    positions: torch.Tensor  # [..., K, 2] in current base frame
    facing: torch.Tensor  # [..., K, 2] unit vectors
    velocities: torch.Tensor  # [..., K, 2]


def _pick(cond, a: float, b: float, like):
    """torch.where over two constants, in the dtype and device of `like`."""
    return torch.where(cond, torch.full_like(like, a), torch.full_like(like, b))


def _limit_to_ellipsoid(v, cfg: InputBuilderConfig):
    """Clamp planar velocity to the forward/side/backward ellipsoid."""
    a_fwd = cfg.ellipsoid_forward_axis * cfg.ellipsoid_scaling_factor
    a_back = cfg.ellipsoid_backward_axis * cfg.ellipsoid_scaling_factor
    a_side = cfg.ellipsoid_side_axis * cfg.ellipsoid_scaling_factor
    vx = v[..., 0]
    ax = _pick(vx >= 0, a_fwd, a_back, vx)
    r2 = (vx / torch.clamp(ax, min=1e-9)) ** 2 + (v[..., 1] / max(a_side, 1e-9)) ** 2
    scale = torch.where(r2 > 1.0, 1.0 / torch.sqrt(torch.clamp(r2, min=1e-12)), torch.ones_like(r2))
    return v * scale[..., None]


def _limit_facing_angle(facing, motion, cfg: InputBuilderConfig):
    """Clamp the facing angle relative to forward, with per-quadrant limits
    (mann.ini:27-30)."""
    ang = torch.atan2(facing[..., 1], facing[..., 0])
    moving_fwd = motion[..., 0] >= 0.0
    side_sign_same = motion[..., 1] * ang >= 0.0
    lim_straight = _pick(moving_fwd, cfg.max_facing_angle_forward, cfg.max_facing_angle_backward, ang)
    lim_side = _pick(side_sign_same, cfg.max_facing_angle_side_same_sign,
                     cfg.max_facing_angle_side_opposite_sign, ang)
    sideways = motion[..., 1].abs() > motion[..., 0].abs()
    lim = torch.where(sideways, lim_side, lim_straight)
    ang = torch.clamp(ang, -lim, lim)
    return torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)


def build_desired_trajectory(
    motion_direction, facing_direction, cfg: InputBuilderConfig = InputBuilderConfig()
) -> DesiredBaseTrajectory:
    """motion/facing [..., 2] (joystick sticks) -> K-knot desired base path [..., K, 2]."""
    K = cfg.number_of_knots
    mnorm = torch.linalg.norm(motion_direction, dim=-1, keepdim=True)
    v_des = torch.where(
        mnorm > 1e-3,
        motion_direction / torch.clamp(mnorm, min=1e-9) * cfg.base_vel_norm * torch.clamp(mnorm, max=1.0),
        torch.zeros_like(motion_direction),
    )
    v_lim = _limit_to_ellipsoid(v_des, cfg)

    fnorm = torch.linalg.norm(facing_direction, dim=-1, keepdim=True)
    forward = _device_constant((1.0, 0.0), facing_direction.device, facing_direction.dtype)
    f_raw = torch.where(fnorm > 1e-3, facing_direction / torch.clamp(fnorm, min=1e-9), forward)
    f_lim = _limit_facing_angle(f_raw, v_lim, cfg)

    # knot times of jnp.linspace: start + (stop - start) * k / (K - 1), the
    # last exactly the horizon
    t = _device_constant(tuple(np.linspace(0.0, cfg.time_horizon, K).tolist()), v_lim.device, v_lim.dtype)[:, None]
    positions = t * v_lim[..., None, :]
    lead = v_lim.shape[:-1]
    velocities = v_lim[..., None, :].expand(lead + (K, 2))
    facing = f_lim[..., None, :].expand(lead + (K, 2))
    return DesiredBaseTrajectory(positions=positions, facing=facing, velocities=velocities)

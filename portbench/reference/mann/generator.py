"""Autoregressive MANN trajectory generator, batch-first in PyTorch.

Counterpart of `cmw_tpu/mann/generator.py` (parameters of mann.ini): rolls
the mixture-of-experts network at 50 Hz over 0.8 s (40 steps), producing
CoM / angular-momentum / joint / base-pose trajectories and a contact
timeline from per-foot Schmitt triggers with hysteresis.

Feature layout (124 in / 91 out): input = 12 trajectory points x (2D
position + 2D facing + 2D velocity) in the current projected-base frame,
then 26 joint positions + 26 joint velocities; output = 6 future
trajectory points x 6, then joint positions/velocities and 3 momentum
terms. The 12 input points are 6 past (over the past 1.0 s) + 6 future; the
future points blend the previous prediction with the joystick-desired
trajectory.

The projected base (xy, yaw) integrates the network's predicted root
motion; its height pins the lower sole to the ground; roll is zero and
pitch the constant walk-ready value (flat-ground walking).

Every tensor carries a leading batch dimension [B, ...]; the rollout is a
Python loop over steps, and `generate_with_states` returns the state after
each step stacked as [B, S, ...] so a caller can re-root the next rollout
at any knot. On the card the whole rollout replays one CUDA graph cached
for the config's value, the model and the weights (`runtime/cache.py`), the
counterpart of JAX's jitted `lax.scan` over the steps.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.core import kinematics as kin
from portbench.reference.core import lie
from portbench.reference.mann.input_builder import DesiredBaseTrajectory, _device_constant
from portbench.reference.mann.network import MANNWeights, mann_forward
from portbench.reference.runtime import cache

N_PAST = 6  # of the 12 projected_base_datapoints (mann.ini:57)
N_FUTURE = 6
NJ = 26


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    dt: float = 0.02  # mann.ini:13
    time_horizon: float = 0.8  # mann.ini:15
    past_horizon: float = 1.0  # mann.ini:60 past_projected_base_horizon
    # real-time stretch of the generated gait (mann.ini:16): the network
    # rolls in its own 50 Hz gait time, but each output step is stamped
    # slow_down_factor * dt apart in controller time. The autoregression and
    # the Schmitt triggers below live in gait time.
    slow_down_factor: float = 1.0
    # Schmitt triggers (mann.ini:33-55)
    on_threshold: float = 0.01
    off_threshold: float = 0.01
    switch_on_after: float = 0.04
    switch_off_after: float = 0.04
    # foot-corner offsets in the sole frame for contact detection: a foot
    # stays in contact as long as its lowest corner is down
    corners: tuple = (
        (0.08, 0.03, 0.0),
        (0.08, -0.03, 0.0),
        (-0.08, -0.03, 0.0),
        (-0.08, 0.03, 0.0),
    )
    # weight of the desired trajectory in the blended future points, ramping
    # linearly to this value at the far end of the horizon
    desired_blend: float = 1.0
    # constant base pitch of the generator's flat-ground FK (the walk-ready
    # value, kin.CROUCH_BASE_PITCH): MANN's postures have flat soles only
    # with the base pitched so
    base_pitch: float = -0.11

    @property
    def n_steps(self) -> int:
        return int(round(self.time_horizon / self.dt))

    @property
    def past_stride(self) -> int:
        # history is stored every step; past points sampled every stride
        return int(round(self.past_horizon / self.dt / N_PAST))


class GeneratorState(NamedTuple):
    """Complete autoregression state (save/restore = merge-point support)."""

    base_xy: torch.Tensor  # [B, 2] world
    base_yaw: torch.Tensor  # [B]
    q: torch.Tensor  # [B, 26]
    qd: torch.Tensor  # [B, 26]
    future_traj: torch.Tensor  # [B, 6, 6] predicted (pos2, facing2, vel2), base frame
    hist_xy: torch.Tensor  # [B, H, 2] world-frame base history (ring, newest last)
    hist_facing: torch.Tensor  # [B, H, 2] world frame
    hist_vel: torch.Tensor  # [B, H, 2] world frame
    contact: torch.Tensor  # [B, 2] {0,1} stance state (L, R)
    contact_timer: torch.Tensor  # [B, 2] hysteresis accumulators (s)
    foot_pose_xy_yaw: torch.Tensor  # [B, 2, 3] locked stance sole (x, y, yaw)


class GeneratorOutput(NamedTuple):
    com: torch.Tensor  # [B, S, 3]
    ang_mom: torch.Tensor  # [B, S, 3] (not mass-normalized)
    joints: torch.Tensor  # [B, S, 26]
    base_xy_yaw: torch.Tensor  # [B, S, 3]
    base_height: torch.Tensor  # [B, S]
    contact: torch.Tensor  # [B, S, 2]
    foot_pose_xy_yaw: torch.Tensor  # [B, S, 2, 3]


def _hist_len(cfg: GeneratorConfig) -> int:
    return N_PAST * cfg.past_stride


_NP_FLOAT = {torch.float32: np.float32, torch.float64: np.float64}


def _base_rot(cfg: GeneratorConfig, yaw):
    """Full base rotation for FK [B, 3, 3]: yaw (tracked state) composed with
    the constant walk-ready pitch (cfg.base_pitch, its cosine and sine taken
    of the angle rounded to the dtype on the host, where a graph can run it)."""
    p = float(_NP_FLOAT[yaw.dtype](cfg.base_pitch))
    cp, sp = math.cos(p), math.sin(p)
    pitch = _device_constant(((cp, 0.0, sp), (0.0, 1.0, 0.0), (-sp, 0.0, cp)), yaw.device, yaw.dtype)
    return lie.rotz(yaw) @ pitch


def _sole_xy_yaw(fR, fp, idx):
    """[..., 3] (x, y, yaw) of frame idx."""
    return torch.stack([fp[..., idx, 0], fp[..., idx, 1], lie.yaw_of(fR[..., idx, :, :])], dim=-1)


def initial_state(
    cfg: GeneratorConfig,
    model: kin.RobotModel,
    q,
    base_xy=None,
    base_yaw=None,
) -> GeneratorState:
    """From initial joint configurations q [B, 26] and projected base poses
    (base_xy [B, 2], base_yaw [B]; zeros by default)."""
    B, dtype, device = q.shape[0], q.dtype, q.device
    base_xy = torch.zeros(B, 2, dtype=dtype, device=device) if base_xy is None else base_xy
    base_yaw = torch.zeros(B, dtype=dtype, device=device) if base_yaw is None else base_yaw
    H = _hist_len(cfg)
    facing = torch.stack([torch.cos(base_yaw), torch.sin(base_yaw)], dim=-1)
    fut = torch.zeros(B, N_FUTURE, 6, dtype=dtype, device=device)
    fut[..., 2] = 1.0  # facing forward
    # stance feet from FK at the initial pose
    base_pos = torch.cat([base_xy, torch.zeros(B, 1, dtype=dtype, device=device)], dim=-1)
    lR, lp = kin.fk(model, q, _base_rot(cfg, base_yaw), base_pos)
    fR, fp = kin.frame_poses(model, lR, lp)
    feet = [_sole_xy_yaw(fR, fp, model.frame_index(n)) for n in ("l_sole", "r_sole")]
    return GeneratorState(
        base_xy=base_xy,
        base_yaw=base_yaw,
        q=q,
        qd=torch.zeros(B, NJ, dtype=dtype, device=device),
        future_traj=fut,
        hist_xy=base_xy[:, None, :].expand(B, H, 2).clone(),
        hist_facing=facing[:, None, :].expand(B, H, 2).clone(),
        hist_vel=torch.zeros(B, H, 2, dtype=dtype, device=device),
        contact=torch.ones(B, 2, dtype=dtype, device=device),
        contact_timer=torch.zeros(B, 2, dtype=dtype, device=device),
        foot_pose_xy_yaw=torch.stack(feet, dim=-2),
    )


def _world_to_base_xy(v, base_xy, yaw):
    """v [B, n, 2] world points -> base frame; base_xy [B, 2], yaw [B]."""
    c, s = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
    d = v - base_xy[:, None, :]
    return torch.stack([c * d[..., 0] + s * d[..., 1], -s * d[..., 0] + c * d[..., 1]], dim=-1)


def _rot_to_base(v, c, s):
    return torch.stack([c * v[..., 0] + s * v[..., 1], -s * v[..., 0] + c * v[..., 1]], dim=-1)


def _rot_to_world(v, c, s):
    return torch.stack([c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1]], dim=-1)


def _build_input(cfg: GeneratorConfig, s: GeneratorState, desired: DesiredBaseTrajectory):
    """Assemble the 124-feature vector [B, 124] in the current base frame."""
    ring = slice(0, N_PAST * cfg.past_stride, cfg.past_stride)  # oldest -> newest over the ring
    c, sn = torch.cos(s.base_yaw)[:, None], torch.sin(s.base_yaw)[:, None]
    past_xy = _world_to_base_xy(s.hist_xy[:, ring], s.base_xy, s.base_yaw)
    past_face = _rot_to_base(s.hist_facing[:, ring], c, sn)
    past_vel = _rot_to_base(s.hist_vel[:, ring], c, sn)

    # blend the predicted future with the desired trajectory: the nearest
    # desired knot per future point, in exact index arithmetic (the two
    # grids share tie points, where rounding the exact quotient half to even
    # is what jnp.round does on it)
    n_des = desired.positions.shape[-2]
    di = np.clip(np.round(np.arange(1, N_FUTURE + 1) * (n_des - 1) / N_FUTURE), 0, n_des - 1).astype(int)
    di = _device_constant(tuple(di.tolist()), s.q.device, torch.long)
    k = torch.arange(1, N_FUTURE + 1, dtype=s.q.dtype, device=s.q.device)
    w = (cfg.desired_blend * k / N_FUTURE)[:, None]
    fut = s.future_traj
    fut_pos = (1 - w) * fut[..., 0:2] + w * desired.positions.index_select(1, di)
    fut_face = (1 - w) * fut[..., 2:4] + w * desired.facing.index_select(1, di)
    fut_vel = (1 - w) * fut[..., 4:6] + w * desired.velocities.index_select(1, di)
    fut_face = fut_face / torch.clamp(torch.linalg.norm(fut_face, dim=-1, keepdim=True), min=1e-6)

    B = s.q.shape[0]
    pos = torch.cat([past_xy, fut_pos], dim=1)  # [B, 12, 2]
    face = torch.cat([past_face, fut_face], dim=1)
    vel = torch.cat([past_vel, fut_vel], dim=1)
    return torch.cat([pos.reshape(B, -1), face.reshape(B, -1), vel.reshape(B, -1), s.q, s.qd], dim=-1)


def _parse_output(y):
    B = y.shape[0]
    fut = torch.stack(
        [y[:, 0:12].reshape(B, N_FUTURE, 2), y[:, 12:24].reshape(B, N_FUTURE, 2), y[:, 24:36].reshape(B, N_FUTURE, 2)],
        dim=-2,
    ).reshape(B, N_FUTURE, 6)  # [pos2 | facing2 | vel2] per point
    return fut, y[:, 36:62], y[:, 62:88], y[:, 88:91]


def _base_height(cfg: GeneratorConfig, model: kin.RobotModel, q, yaw):
    """Base z [B] such that the lowest sole sits exactly on the ground:
    walking has no flight phase, so the stance foot is the lower one."""
    lR, lp = kin.fk(model, q, _base_rot(cfg, yaw), torch.zeros(3, dtype=q.dtype, device=q.device))
    _, fp = kin.frame_poses(model, lR, lp)
    zs = torch.stack([fp[:, model.frame_index("l_sole"), 2], fp[:, model.frame_index("r_sole"), 2]], dim=-1)
    return -zs.amin(dim=-1)


def step(
    cfg: GeneratorConfig,
    model: kin.RobotModel,
    weights: MANNWeights,
    s: GeneratorState,
    desired: DesiredBaseTrajectory,
):
    """One 20 ms autoregressive step. Returns (new_state, per-step record),
    each field [B, ...]."""
    x = _build_input(cfg, s, desired)
    y = mann_forward(weights, x)
    fut, q_new, qd_new, _extra = _parse_output(y)
    dtype, device = x.dtype, x.device

    # advance the projected base by the first predicted future point,
    # scaled from its lead time to one control step
    lead = cfg.time_horizon / N_FUTURE
    scale = cfg.dt / lead
    c0, s0 = torch.cos(s.base_yaw), torch.sin(s.base_yaw)
    dxy_b = fut[:, 0, 0:2] * scale
    base_xy = s.base_xy + _rot_to_world(dxy_b, c0, s0)
    dyaw = torch.atan2(fut[:, 0, 3], fut[:, 0, 2]) * scale
    base_yaw = s.base_yaw + dyaw
    vel_w = _rot_to_world(fut[:, 0, 4:6], c0, s0)

    # contact detection: Schmitt trigger on sole heights with hysteresis
    z_base = _base_height(cfg, model, q_new, base_yaw)
    base_pos = torch.cat([base_xy, z_base[:, None]], dim=-1)
    lR, lp = kin.fk(model, q_new, _base_rot(cfg, base_yaw), base_pos)
    fR, fp = kin.frame_poses(model, lR, lp)
    li, ri = model.frame_index("l_sole"), model.frame_index("r_sole")
    # lowest-corner height per foot: corner world z = sole z + (R_sole @ offset)_z
    offs = _device_constant(cfg.corners, device, dtype)  # [4, 3]
    corner_z = torch.stack(
        [fp[:, li, 2:3] + fR[:, li, 2, :] @ offs.T, fp[:, ri, 2:3] + fR[:, ri, 2, :] @ offs.T], dim=1
    )  # [B, 2, 4]
    sole_z = corner_z.amin(dim=-1)
    in_contact = s.contact > 0
    raw = torch.where(in_contact, sole_z < cfg.off_threshold, sole_z < cfg.on_threshold).to(dtype)
    # timer accumulates while the raw signal disagrees with the state
    switch_after = torch.where(in_contact, torch.full_like(sole_z, cfg.switch_off_after),
                               torch.full_like(sole_z, cfg.switch_on_after))
    disagree = (raw - s.contact).abs()
    timer = (s.contact_timer + cfg.dt) * disagree
    flip = (timer >= switch_after).to(dtype)
    contact = s.contact * (1 - flip) + (1 - s.contact) * flip
    timer = timer * (1 - flip)

    # lock foot pose at touchdown; keep while in stance
    sole_xy_yaw = torch.stack([_sole_xy_yaw(fR, fp, li), _sole_xy_yaw(fR, fp, ri)], dim=1)  # [B, 2, 3]
    touchdown = ((1 - s.contact) * contact)[..., None]
    foot_pose = torch.where((contact[..., None] > 0) & (touchdown == 0), s.foot_pose_xy_yaw, sole_xy_yaw)

    # com + centroidal momentum
    c = kin.com(model, lR, lp)
    zeros = torch.zeros(x.shape[0], 3, dtype=dtype, device=device)
    nu = torch.cat([vel_w, zeros, (dyaw / cfg.dt)[:, None], qd_new], dim=-1)
    h = kin.centroidal_momentum(model, lR, lp, nu)

    # history ring shift
    facing_w = torch.stack([torch.cos(base_yaw), torch.sin(base_yaw)], dim=-1)
    new_state = GeneratorState(
        base_xy=base_xy,
        base_yaw=base_yaw,
        q=q_new,
        qd=qd_new,
        future_traj=fut,
        hist_xy=torch.cat([s.hist_xy[:, 1:], base_xy[:, None]], dim=1),
        hist_facing=torch.cat([s.hist_facing[:, 1:], facing_w[:, None]], dim=1),
        hist_vel=torch.cat([s.hist_vel[:, 1:], vel_w[:, None]], dim=1),
        contact=contact,
        contact_timer=timer,
        foot_pose_xy_yaw=foot_pose,
    )
    record = GeneratorOutput(
        com=c,
        ang_mom=h[:, 3:6],
        joints=q_new,
        base_xy_yaw=torch.cat([base_xy, base_yaw[:, None]], dim=-1),
        base_height=z_base,
        contact=contact,
        foot_pose_xy_yaw=foot_pose,
    )
    return new_state, record


def _stack(items, cls):
    return cls(*(torch.stack(parts, dim=1) for parts in zip(*items)))


def generate(
    cfg: GeneratorConfig,
    model: kin.RobotModel,
    weights: MANNWeights,
    state: GeneratorState,
    desired: DesiredBaseTrajectory,
) -> tuple[GeneratorState, GeneratorOutput]:
    """Roll the generator over the full horizon (40 steps @ 50 Hz).

    Returns (final_state, per-step outputs stacked [B, S, ...])."""
    return generate_with_states(cfg, model, weights, state, desired)[:2]


def generate_with_states(
    cfg: GeneratorConfig,
    model: kin.RobotModel,
    weights: MANNWeights,
    state: GeneratorState,
    desired: DesiredBaseTrajectory,
):
    """Like generate(), but also returns the post-step states stacked
    [B, S, ...], so that the next rollout can re-root at an intermediate
    knot: `GeneratorState(*(a[:, k] for a in states))` is the state after
    step k + 1. On the card the rollout is one graph, keyed by the config's
    value and the model's and the weights' identity: the weights are read in
    place, never copied into the graph's inputs (the controller hands over
    the same cast weights on every call, `WalkingController._weights_as`)."""
    owner = ("mann.generate", cfg, cache.Ident(model), cache.Ident(weights))
    return cache.graphed(owner, lambda st, des: _rollout(cfg, model, weights, st, des), state, desired)


def _rollout(cfg: GeneratorConfig, model: kin.RobotModel, weights: MANNWeights, state: GeneratorState,
             desired: DesiredBaseTrajectory):
    records, states = [], []
    for _ in range(cfg.n_steps):
        state, rec = step(cfg, model, weights, state, desired)
        records.append(rec)
        states.append(state)
    return state, _stack(records, GeneratorOutput), _stack(states, GeneratorState)

"""Numpy oracle for the autoregressive MANN trajectory generator.

Independent float64 re-implementation of `mann/generator.py`'s semantics —
feature-window assembly, desired-trajectory blending, base-pose
reconstruction, per-corner Schmitt-trigger contact detection, CoM +
centroidal angular momentum — built on the independent numpy ONNX
interpreter (`mann/onnx_ref.py`) and its own numpy forward-kinematics
chain. It shares NOTHING with the JAX path but the `GeneratorConfig` /
`GeneratorState` containers and the static `RobotModel` arrays — with one
deliberate exception: the desired-trajectory knot resampling rule
`round((k+1)*(n_des-1)/N_FUTURE)` is shared BY CONSTRUCTION (both sides
implement the same nearest-knot convention), so the parity test pins it
only through the 7-knot config where the indices are exact; a bug in that
one formula would escape this oracle.

Trajectory-level agreement between this rollout and the `lax.scan`
generator (tests/test_mann.py::test_generator_oracle_parity_40_steps)
pins the reconstruction choices the JAX generator makes against a second
implementation, the validation the reference delegates to BLF's
`MANNTrajectoryGenerator` upstream tests (driven at
CentroidalMPCBlock.cpp:464-509; parameters mann.ini:13-55).

A copy of `cmw_tpu/mann/gen_oracle.py` (numpy only) for the PyTorch package,
which may not import the JAX one; only the imports differ. It reads the
port's RobotModel and GeneratorConfig, and one item's GeneratorState and
desired trajectory as CPU tensors (no batch axis).
"""

from __future__ import annotations

import numpy as np

from cmw_tpu_torch.core.kinematics import RobotModel
from cmw_tpu_torch.mann.generator import (
    N_FUTURE,
    N_PAST,
    GeneratorConfig,
    GeneratorState,
)
from cmw_tpu_torch.mann.onnx_import import OnnxGraph, load_onnx_graph
from cmw_tpu_torch.mann.onnx_ref import run_graph


# -- numpy kinematics (independent of core.kinematics' JAX functions) --------


def _rotz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _roty(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _axis_angle(ax, th):
    ax = np.asarray(ax, np.float64)
    K = np.array(
        [[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]], np.float64
    )
    return np.eye(3) + np.sin(th) * K + (1.0 - np.cos(th)) * (K @ K)


def fk_np(model: RobotModel, q, base_rot, base_pos):
    R = [np.asarray(base_rot, np.float64)]
    p = [np.asarray(base_pos, np.float64)]
    for i in range(model.nj):
        par = int(model.parent[i])
        Rj = _axis_angle(model.axis[i], float(q[i]))
        R.append(R[par] @ np.asarray(model.origin_rot[i]) @ Rj)
        p.append(p[par] + R[par] @ np.asarray(model.origin_pos[i]))
    return np.stack(R), np.stack(p)


def frame_pose_np(model: RobotModel, R, p, name):
    fi = model.frame_index(name)
    li = int(model.frame_link[fi])
    return R[li] @ np.asarray(model.frame_rot[fi]), p[li] + R[li] @ np.asarray(
        model.frame_pos[fi]
    )


def com_np(model: RobotModel, R, p):
    m = np.asarray(model.link_mass, np.float64)
    cw = p + np.einsum("lij,lj->li", R, np.asarray(model.link_com, np.float64))
    return (m[:, None] * cw).sum(0) / m.sum()


def ang_mom_np(model: RobotModel, R, p, nu):
    """Centroidal angular momentum, summed link by link: each link
    contributes m c_rel x v_com + R I R^T w."""
    nj = model.nj
    anc = np.zeros((nj + 1, nj))
    for i in range(nj):
        anc[i + 1] = anc[int(model.parent[i])]
        anc[i + 1, i] = 1.0
    par = model.parent
    axis_w = np.einsum(
        "jab,jbc,jc->ja", R[par], np.asarray(model.origin_rot), np.asarray(model.axis)
    )
    pivot = p[par] + np.einsum("jab,jb->ja", R[par], np.asarray(model.origin_pos))
    m = np.asarray(model.link_mass, np.float64)
    cw = p + np.einsum("lij,lj->li", R, np.asarray(model.link_com, np.float64))
    com = (m[:, None] * cw).sum(0) / m.sum()
    v_b, w_b, qd = nu[0:3], nu[3:6], nu[6:]
    L = np.zeros(3)
    for l in range(nj + 1):
        w_l = w_b.copy()
        v_l = v_b + np.cross(w_b, cw[l] - p[0])
        for j in range(nj):
            if anc[l, j]:
                w_l = w_l + axis_w[j] * qd[j]
                v_l = v_l + np.cross(axis_w[j], cw[l] - pivot[j]) * qd[j]
        Iw = R[l] @ np.asarray(model.link_inertia[l]) @ R[l].T
        L += m[l] * np.cross(cw[l] - com, v_l) + Iw @ w_l
    return L


# -- the oracle rollout -------------------------------------------------------


def _to_base(v, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    v = np.asarray(v, np.float64)
    return np.stack([c * v[..., 0] + s * v[..., 1], -s * v[..., 0] + c * v[..., 1]], -1)


def _to_world(v, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    v = np.asarray(v, np.float64)
    return np.stack([c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1]], -1)


def rollout_oracle(
    cfg: GeneratorConfig,
    model: RobotModel,
    graph: OnnxGraph,
    state: GeneratorState,
    desired,
    n_steps: int | None = None,
):
    """Numpy autoregressive rollout from a (JAX) GeneratorState.

    Returns dict of stacked per-step records mirroring GeneratorOutput plus
    the final numpy state pieces needed for assertions.
    """
    s = {k: np.asarray(v, np.float64) for k, v in state._asdict().items()}
    des_pos = np.asarray(desired.positions, np.float64)
    des_face = np.asarray(desired.facing, np.float64)
    des_vel = np.asarray(desired.velocities, np.float64)
    n = cfg.n_steps if n_steps is None else n_steps
    base_pitch_rot = _roty(cfg.base_pitch)
    corners = np.asarray(cfg.corners, np.float64)

    rec = {k: [] for k in ("com", "ang_mom", "joints", "base_xy_yaw", "contact")}
    for _ in range(n):
        # 124-feature vector in the current base frame
        idx = np.arange(N_PAST) * cfg.past_stride
        past_xy = _to_base(s["hist_xy"][idx] - s["base_xy"], s["base_yaw"])
        past_face = _to_base(s["hist_facing"][idx], s["base_yaw"])
        past_vel = _to_base(s["hist_vel"][idx], s["base_yaw"])
        n_des = des_pos.shape[0]
        di = np.clip(
            np.round((np.arange(N_FUTURE) + 1) * (n_des - 1) / N_FUTURE).astype(int),
            0,
            n_des - 1,
        )
        w = (cfg.desired_blend * (np.arange(N_FUTURE) + 1) / N_FUTURE)[:, None]
        fut_pos = (1 - w) * s["future_traj"][:, 0:2] + w * des_pos[di]
        fut_face = (1 - w) * s["future_traj"][:, 2:4] + w * des_face[di]
        fut_vel = (1 - w) * s["future_traj"][:, 4:6] + w * des_vel[di]
        fut_face /= np.maximum(np.linalg.norm(fut_face, axis=-1, keepdims=True), 1e-6)
        x = np.concatenate(
            [
                np.concatenate([past_xy, fut_pos]).ravel(),
                np.concatenate([past_face, fut_face]).ravel(),
                np.concatenate([past_vel, fut_vel]).ravel(),
                s["q"],
                s["qd"],
            ]
        ).astype(np.float32)

        y = run_graph(graph, {"input": x[None]})["output"][0].astype(np.float64)
        fut = np.stack(
            [y[0:12].reshape(N_FUTURE, 2), y[12:24].reshape(N_FUTURE, 2), y[24:36].reshape(N_FUTURE, 2)],
            axis=-2,
        ).reshape(N_FUTURE, 6)
        q_new, qd_new = y[36:62], y[62:88]

        scale = cfg.dt / (cfg.time_horizon / N_FUTURE)
        base_xy = s["base_xy"] + _to_world(fut[0, 0:2] * scale, s["base_yaw"])
        dyaw = np.arctan2(fut[0, 3], fut[0, 2]) * scale
        base_yaw = s["base_yaw"] + dyaw
        vel_w = _to_world(fut[0, 4:6], s["base_yaw"])

        # base height: lowest sole exactly on the ground
        base_rot = _rotz(base_yaw) @ base_pitch_rot
        R0, p0 = fk_np(model, q_new, base_rot, np.zeros(3))
        soles = [frame_pose_np(model, R0, p0, f) for f in ("l_sole", "r_sole")]
        z_base = -min(sp[2] for _, sp in soles)
        base_pos = np.array([base_xy[0], base_xy[1], z_base])
        R, p = fk_np(model, q_new, base_rot, base_pos)
        soles = [frame_pose_np(model, R, p, f) for f in ("l_sole", "r_sole")]

        # per-corner Schmitt triggers with hysteresis timers
        contact = s["contact"].copy()
        timer = s["contact_timer"].copy()
        sole_xy_yaw = np.zeros((2, 3))
        for f, (fR, fp) in enumerate(soles):
            corner_z = fp[2] + (fR @ corners.T)[2]
            low = corner_z.min()
            raw = (
                low < cfg.off_threshold if contact[f] > 0 else low < cfg.on_threshold
            )
            switch_after = cfg.switch_off_after if contact[f] > 0 else cfg.switch_on_after
            if float(raw) != contact[f]:
                timer[f] += cfg.dt
            else:
                timer[f] = 0.0
            if timer[f] >= switch_after:
                contact[f] = 1.0 - contact[f]
                timer[f] = 0.0
            sole_xy_yaw[f] = [fp[0], fp[1], np.arctan2(fR[1, 0], fR[0, 0])]
        touchdown = (1 - s["contact"]) * contact
        foot_pose = np.where(
            (contact[:, None] > 0) & (touchdown[:, None] == 0),
            s["foot_pose_xy_yaw"],
            sole_xy_yaw,
        )

        c = com_np(model, R, p)
        nu = np.concatenate([vel_w, [0.0, 0.0, 0.0], [dyaw / cfg.dt], qd_new])
        L = ang_mom_np(model, R, p, nu)

        facing_w = _to_world(np.array([1.0, 0.0]), base_yaw)
        s = dict(
            base_xy=base_xy,
            base_yaw=base_yaw,
            q=q_new,
            qd=qd_new,
            future_traj=fut,
            hist_xy=np.concatenate([s["hist_xy"][1:], base_xy[None]]),
            hist_facing=np.concatenate([s["hist_facing"][1:], facing_w[None]]),
            hist_vel=np.concatenate([s["hist_vel"][1:], vel_w[None]]),
            contact=contact,
            contact_timer=timer,
            foot_pose_xy_yaw=foot_pose,
        )
        rec["com"].append(c)
        rec["ang_mom"].append(L)
        rec["joints"].append(q_new)
        rec["base_xy_yaw"].append(np.concatenate([base_xy, [base_yaw]]))
        rec["contact"].append(contact.copy())
    return {k: np.stack(v) for k, v in rec.items()}, s


def load_graph(path: str) -> OnnxGraph:
    return load_onnx_graph(path)

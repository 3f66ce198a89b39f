"""Telemetry persistence: a named-channel schema and an npz file.

PyTorch counterpart of `cmw_tpu/runtime/telemetry.py` (the reference
declares the schema once, WholeBodyQPBlock.cpp:655-712, then streams a
vector per tick). `WalkingController.run_episode` returns `Telemetry` with
batch-first stacked tensors [B, S, ...]; `save` writes them with the schema
on the host, `load` reads them back as numpy. With `item`, `save` writes one
item alone in JAX's layout ([S, ...], JAX's metadata keys), which JAX's
loader and its readers take as they take the JAX package's files.
"""

from __future__ import annotations

import json

import numpy as np

SCHEMA = {
    "com_mpc": "integrated centroidal-model CoM [m] (the MPC plant state)",
    "dcom_mpc": "integrated CoM velocity [m/s]",
    "ang_mom_mpc": "integrated mass-normalized angular momentum",
    "com_meas": "FK CoM of the commanded robot [m]",
    "com_ik_target": "CoM target fed to the IK (xy from LTI integrator)",
    "zmp_des": "desired ZMP from MPC corner forces [m]",
    "foot_pos_des": "desired sole positions [nc,3]",
    "foot_contact": "planned stance flags [nc]",
    "forces0": "applied (first-interval) corner forces / mass [nc,ncor,3]",
    "q": "commanded joint positions [nj]",
    "base_pos": "commanded base position [m]",
    "base_est_pos": "legged-odometry base estimate [m]",
    "fixed_foot_idx": "fixed foot (0=left, 1=right)",
    "mpc_cost": "last MPC cost",
    "mpc_prim": "last MPC primal residual",
    "adjusted_step": "current slot nominal/adjusted positions [nc,K,3]",
    "zmp_meas": "measured ZMP from contact wrenches [m]",
    "vcom_zmp": "CoM-ZMP stabilizer velocity output [m/s, xy]",
    "dq_cmd": "IK joint-velocity command [nj]",
    "joypad": "joystick input [motion_x, motion_y, facing_x, facing_y]",
    "q_reg": "MANN posture regularization target [nj]",
    "com_mann": "MANN CoM reference at the current MPC knot [m]",
    "ang_mom_mann": "MANN angular-momentum reference (mass-normalized)",
    "gait_hold": "1.0 while the gait clock is paused (gait-hold retiming)",
    "gait_rush": "gait-clock acceleration factor (gait-rush; 0 = nominal)",
    "base_act_pos": "physical base position (rigid plant) [m]",
    "base_act_up": "cos(base tilt) = R_act[2,2] (rigid plant)",
    "base_act_lean": "world-z of base x/y axes (pitch/roll proxies)",
    "fz_act": "physical per-foot normal-force sum [nc] (N)",
    "ft_act": "physical per-foot tangential-force sum [nc,2] (N)",
    "com_act": "ground-truth plant CoM [m] (== com_meas without rigid)",
    "q_act": "physical joint positions [nj] (== q without rigid)",
}


def save(path: str, telemetry, wbc_dt: float, extra: dict | None = None, *, item: int | None = None):
    """Write stacked Telemetry [B, S, ...] and its schema to an npz file, or
    with `item` that item's channels [S, ...] in JAX's layout (no `batch`
    key). Every channel must be in SCHEMA."""
    arrays = {k: (v if item is None else v[item]).detach().cpu().numpy() for k, v in telemetry._asdict().items()}
    unknown = sorted(set(arrays) - set(SCHEMA))
    if unknown:
        raise ValueError(f"telemetry channels without a schema entry: {unknown}")
    first = next(iter(arrays.values()))
    meta = {"schema": {k: SCHEMA[k] for k in arrays}, "wbc_dt": wbc_dt}
    if item is None:
        meta["batch"] = int(first.shape[0])
    meta["ticks"] = int(first.shape[0 if item is not None else 1])
    if extra:
        meta.update(extra)
    arrays["_meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load(path: str):
    """Returns (dict of channel arrays, [B, S, ...] or one item's [S, ...],
    metadata dict)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["_meta_json"]).decode())
        chans = {k: z[k] for k in z.files if k != "_meta_json"}
    if set(chans) != set(meta["schema"]):
        raise ValueError(f"{path}: channels {sorted(chans)} do not match the schema {sorted(meta['schema'])}")
    return chans, meta

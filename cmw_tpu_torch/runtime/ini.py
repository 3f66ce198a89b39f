"""YARP ResourceFinder ini-dialect parser + robot-config loader.

PyTorch-package counterpart of `cmw_tpu/runtime/ini.py`: plain Python that
builds the port's config classes. The reference's configuration is ini trees
in this dialect: `key value` pairs, quoted strings, `(tuple, of, values)`
possibly spanning lines (and occasionally missing commas, as in
centroidal_mpc.ini's corner_3 "(-0.08 0.01, 0.0)"), `[GROUP]` sections and
`[include GROUP "./file.ini"]` composition.

`load_robot_config(dir)` builds a WalkingConfig straight from a reference
config directory (e.g. src/centroidal-mpc-walking/config/robots/
ergoCubGazeboV1 of the reference repository), so parameter parity with the
reference is read off its own files rather than re-typed. Every field that
the files do not set keeps the class default, which equals the JAX
package's.
"""

from __future__ import annotations

import os
import re

from cmw_tpu_torch.cmpc.formulation import MPCConfig
from cmw_tpu_torch.estimation.legged_odom import OdomConfig
from cmw_tpu_torch.mann.generator import GeneratorConfig
from cmw_tpu_torch.mann.input_builder import InputBuilderConfig
from cmw_tpu_torch.runtime.config import WalkingConfig
from cmw_tpu_torch.wbc.com_zmp import CoMZMPGains
from cmw_tpu_torch.wbc.diff_ik import IKConfig
from cmw_tpu_torch.wbc.swing_foot import SwingFootConfig


def _parse_value(tok: str):
    tok = tok.strip()
    if tok.startswith('"') and tok.endswith('"'):
        return tok[1:-1]
    if tok.startswith("(") and tok.endswith(")"):
        inner = tok[1:-1].replace(",", " ")
        return tuple(_parse_value(t) for t in inner.split())
    low = tok.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok


def parse_ini(path: str) -> dict:
    """Parse one ini file (following [include] directives) into
    {key: value, GROUP: {key: value, ...}, ...}."""
    root: dict = {}
    current = root
    base = os.path.dirname(path)

    with open(path) as f:
        raw = f.read()

    # join continuation lines: unbalanced parentheses
    lines = []
    buf = ""
    for line in raw.splitlines():
        line = line.split("#", 1)[0].split("//", 1)[0].rstrip()
        if not line.strip():
            continue
        buf = (buf + " " + line).strip() if buf else line
        if buf.count("(") > buf.count(")"):
            continue
        lines.append(buf)
        buf = ""
    if buf:
        lines.append(buf)

    inc = re.compile(r'^\[include\s+(\S+)\s+"([^"]+)"\]$')
    grp = re.compile(r"^\[(\S+)\]$")
    for line in lines:
        m = inc.match(line.strip())
        if m:
            group, rel = m.groups()
            root[group] = parse_ini(os.path.join(base, rel))
            current = root  # an include closes any open group
            continue
        m = grp.match(line.strip())
        if m:
            current = root.setdefault(m.group(1), {})
            continue
        parts = line.strip().split(None, 1)
        if len(parts) == 1:
            current[parts[0]] = True
            continue
        key, val = parts
        current[key] = _parse_value(val.strip())
    return root


def load_robot_config(robot_dir: str) -> WalkingConfig:
    """Reference robot config dir -> WalkingConfig."""
    def opt(name):
        p = os.path.join(robot_dir, name)
        return parse_ini(p) if os.path.exists(p) else {}

    main = parse_ini(os.path.join(robot_dir, "centroidal_mpc_walking.ini"))
    mpc_ini = parse_ini(os.path.join(robot_dir, "centroidal_mpc.ini"))
    # the original ICRA-2022 iCub configs predate the MANN/swing files
    # (SURVEY.md R8) — fall back to defaults for those groups
    mann_ini = opt("mann.ini")
    swing_ini = opt("swing_foot_planner.ini")

    def corners(g):
        return tuple(tuple(float(x) for x in g[f"corner_{i}"]) for i in range(g["number_of_corners"]))

    c0, c1 = mpc_ini["CONTACT_0"], mpc_ini["CONTACT_1"]
    # older configs (iCub*) use controller_sampling_time/horizon keys, with
    # the horizon given as a STEP COUNT rather than seconds
    dt = float(mpc_ini.get("sampling_time", mpc_ini.get("controller_sampling_time", 0.06)))
    horizon = float(mpc_ini.get("time_horizon", mpc_ini.get("controller_horizon", 1.2)))
    if horizon > 5.0:  # step count, not seconds
        horizon = horizon * dt
    mpc = MPCConfig(
        dt=float(dt),
        horizon=float(horizon),
        n_contacts=int(mpc_ini.get("number_of_maximum_contacts", 2)),
        mu=float(mpc_ini.get("static_friction_coefficient", 0.33)),
        corners=(corners(c0), corners(c1)),
        bbox_lower=(
            tuple(float(x) for x in c0["bounding_box_lower_limit"]),
            tuple(float(x) for x in c1["bounding_box_lower_limit"]),
        ),
        bbox_upper=(
            tuple(float(x) for x in c0["bounding_box_upper_limit"]),
            tuple(float(x) for x in c1["bounding_box_upper_limit"]),
        ),
        com_weight=tuple(float(x) for x in mpc_ini["com_weight"]),
        contact_position_weight=float(mpc_ini["contact_position_weight"]),
        force_rate_weight=tuple(float(x) for x in mpc_ini["force_rate_of_change_weight"]),
        angular_momentum_weight=float(mpc_ini["angular_momentum_weight"]),
        # absent in the original ICRA-2022 iCub formulation
        force_symmetry_weight=float(mpc_ini.get("contact_force_symmetry_weight", 0.0)),
    )

    lf = mann_ini.get("LEFT_FOOT", {})
    gen = GeneratorConfig(
        dt=float(mann_ini.get("sampling_time", 0.02)),
        time_horizon=float(mann_ini.get("time_horizon", 0.8)),
        past_horizon=float(mann_ini.get("past_projected_base_horizon", 1.0)),
        slow_down_factor=float(mann_ini.get("slow_down_factor", 1.0)),
        on_threshold=float(lf.get("on_threshold", 0.01)),
        off_threshold=float(lf.get("off_threshold", 0.01)),
        switch_on_after=float(lf.get("switch_on_after", 0.04)),
        switch_off_after=float(lf.get("switch_off_after", 0.04)),
    )

    ib = InputBuilderConfig(
        base_vel_norm=float(mann_ini.get("base_vel_norm", 0.4)),
        ellipsoid_forward_axis=float(mann_ini.get("ellipsoid_forward_axis", 3.0)),
        ellipsoid_side_axis=float(mann_ini.get("ellipsoid_side_axis", 0.3)),
        ellipsoid_backward_axis=float(mann_ini.get("ellipsoid_backward_axis", 0.8)),
        ellipsoid_scaling_factor=float(mann_ini.get("ellipsoid_scaling_factor", 0.4)),
        max_facing_angle_forward=float(mann_ini.get("max_facing_direction_angle_forward", 0.2)),
        max_facing_angle_backward=float(mann_ini.get("max_facing_direction_angle_backward", 0.1)),
        max_facing_angle_side_opposite_sign=float(
            mann_ini.get("max_facing_direction_angle_side_opposite_sign", 0.26)
        ),
        max_facing_angle_side_same_sign=float(
            mann_ini.get("max_facing_direction_angle_side_same_sign", 0.17)
        ),
        number_of_knots=int(mann_ini.get("number_of_knots", 7)),
        time_horizon=float(mann_ini.get("time_horizon", 0.8)),
    )

    swing = SwingFootConfig(
        step_height=float(swing_ini.get("step_height", 0.035)),
        foot_apex_time=float(swing_ini.get("foot_apex_time", 0.5)),
        landing_velocity=float(swing_ini.get("foot_landing_velocity", 0.0)),
        landing_acceleration=float(swing_ini.get("foot_landing_acceleration", 0.0)),
    )

    zmp_grp = main.get("COM_ZMP_CONTROLLER", {})
    gains = CoMZMPGains(
        com_gain=tuple(float(x) for x in zmp_grp.get("com_gain", (4.0, 4.0))),
        zmp_gain=tuple(float(x) for x in zmp_grp.get("zmp_gain", (0.5, 0.5))),
    )

    wbc_dt = float(main.get("WHOLE_BODY_RUNNER", {}).get("sampling_time", 0.002))

    ik = load_ik_config(os.path.join(robot_dir, "ik.ini"))
    odom = load_odom_config(os.path.join(robot_dir, "legged_odometry.ini"))

    return WalkingConfig(
        mpc=mpc, gen=gen, input_builder=ib, swing=swing, gains=gains,
        wbc_dt=wbc_dt, ik=ik, odom=odom,
    )


def load_ik_config(path: str) -> IKConfig:
    """ik.ini -> IKConfig, supporting BOTH dialects in the reference tree
    (WholeBodyQPBlock.cpp:131-175 consumes the groups):

    * current (ergoCub*, iCubGazeboV3): LEFT_FOOT/RIGHT_FOOT/COM/CHEST/
      ROOT_TASK/JOINT_REGULARIZATION with priorities + masks;
    * original ICRA-2022 (iCubGenova09): L_FOOT/R_FOOT/COM_TASK/CHEST_TASK/
      REGULARIZATION_TASK — no ROOT_TASK group (kp_root keeps its default)
      and a different CoM gain (kp_linear 10 vs 2), chest frame neck_2.
    """
    if not os.path.exists(path):
        return IKConfig()
    ini = parse_ini(path)

    def group(*names) -> dict:
        for n in names:
            if n in ini:
                return ini[n]
        return {}

    lfoot = group("LEFT_FOOT", "L_FOOT")
    com = group("COM", "COM_TASK")
    chest = group("CHEST", "CHEST_TASK")
    root = group("ROOT_TASK")
    reg = group("JOINT_REGULARIZATION", "REGULARIZATION_TASK")
    d = IKConfig()  # defaults = ergoCubGazeboV1 values
    kp = reg.get("kp", d.kp_posture)
    return IKConfig(
        kp_foot_lin=float(lfoot.get("kp_linear", d.kp_foot_lin)),
        kp_foot_ang=float(lfoot.get("kp_angular", d.kp_foot_ang)),
        kp_com=float(com.get("kp_linear", d.kp_com)),
        kp_root=float(root.get("kp_linear", d.kp_root)),
        kp_chest=float(chest.get("kp_angular", d.kp_chest)),
        kp_posture=(
            tuple(float(x) for x in kp) if isinstance(kp, tuple) else float(kp)
        ),
        chest_frame=str(chest.get("frame_name", d.chest_frame)),
        chest_weight=tuple(float(x) for x in chest.get("weight", d.chest_weight)),
        posture_weight=tuple(
            float(x) for x in reg.get("weight", d.posture_weight)
        ),
    )


def load_odom_config(path: str) -> OdomConfig:
    """legged_odometry.ini -> OdomConfig (ModelInfo + LeggedOdom groups)."""
    if not os.path.exists(path):
        return OdomConfig()
    ini = parse_ini(path)
    mi, lo = ini.get("ModelInfo", {}), ini.get("LeggedOdom", {})
    d = OdomConfig()
    return OdomConfig(
        base_link=str(mi.get("base_link", d.base_link)),
        base_link_imu=str(mi.get("base_link_imu", d.base_link_imu)),
        left_foot_contact_frame=str(
            mi.get("left_foot_contact_frame", d.left_foot_contact_frame)
        ),
        right_foot_contact_frame=str(
            mi.get("right_foot_contact_frame", d.right_foot_contact_frame)
        ),
        initial_fixed_frame=str(lo.get("initial_fixed_frame", d.initial_fixed_frame)),
        switching_pattern=str(lo.get("switching_pattern", d.switching_pattern)),
    )

"""The port's ini loader (`cmw_tpu_torch.runtime.ini`) against the JAX
package's (`cmw_tpu.runtime.ini`) on the same files, which the tests write
(the reference's robot directories are not in the repository):

  - the dialect cases of tests/test_ini.py:12-45 through both parsers: the
    same dict;
  - robot directories through both loaders: the two WalkingConfigs equal
    field by field, nested configs included (a field the files do not set
    takes each package's class default, so a default that differs shows
    here). One directory sets every key load_robot_config reads, with the
    current ik.ini dialect; one the same with the original ICRA-2022 ik.ini
    dialect; one is an older iCub-style directory (controller_sampling_time,
    the horizon as a step count, no mann.ini, swing-foot, ik.ini or
    odometry file);
  - `walk --robot-dir --cpu` on the first directory for a few ticks."""

import dataclasses
import json

import pytest
import torch

import chip_smoke
from cmw_tpu.runtime import ini as JI
from cmw_tpu_torch.apps import walk as TWalk
from cmw_tpu_torch.runtime import ini as TI

torch.set_num_threads(2)

DIALECT = """
top_str "hello"
top_num 0.25
top_tuple (1.0, 2.0, 3.0)
sloppy_tuple (-0.08 0.01, 0.0)   # missing comma, as in the reference
multi_line (a, b,
            c)
flag true
off false // a comment of the other kind
bare_key

[GROUP_A]
x 1
y (2, 3)

[include INC "./b.ini"]
after_include 7
"""


def test_parse_dialect_matches_jax(tmp_path):
    (tmp_path / "b.ini").write_text("inner_key 5\n")
    p = tmp_path / "a.ini"
    p.write_text(DIALECT)
    got, want = TI.parse_ini(str(p)), JI.parse_ini(str(p))
    assert got == want
    assert got["sloppy_tuple"] == (-0.08, 0.01, 0.0) and got["multi_line"] == ("a", "b", "c")
    assert got["INC"]["inner_key"] == 5 and got["after_include"] == 7 and got["bare_key"] is True


CORNERS = """number_of_corners 4
corner_0 (0.09, 0.02, 0.0)
corner_1 (0.09, -0.02, 0.0)
corner_2 (-0.07 -0.02, 0.0)
corner_3 (-0.07, 0.02, 0.0)
"""

MPC_INI = f"""sampling_time 0.06
time_horizon 0.6
number_of_maximum_contacts 2
static_friction_coefficient 0.4
com_weight (12.0, 11.0, 150.0)
contact_position_weight 1500.0
force_rate_of_change_weight (9.0, 8.0,
                             7.0)
angular_momentum_weight 90.0
contact_force_symmetry_weight 2.0

[CONTACT_0]
{CORNERS}bounding_box_lower_limit (-0.02, 0.0, 0.0)
bounding_box_upper_limit (0.02, 0.06, 0.0)

[CONTACT_1]
{CORNERS}bounding_box_lower_limit (-0.02, -0.06, 0.0)
bounding_box_upper_limit (0.02, 0.0, 0.0)
"""

MAIN_INI = """name centroidal-mpc-walking

[WHOLE_BODY_RUNNER]
sampling_time 0.002

[COM_ZMP_CONTROLLER]
com_gain (3.5, 3.0)
zmp_gain (0.6, 0.4)

[include MPC "./centroidal_mpc.ini"]
"""

MANN_INI = """sampling_time 0.02
time_horizon 0.8
past_projected_base_horizon 0.9
slow_down_factor 1.0
base_vel_norm 0.35
ellipsoid_forward_axis 2.5
ellipsoid_side_axis 0.25
ellipsoid_backward_axis 0.7
ellipsoid_scaling_factor 0.45
max_facing_direction_angle_forward 0.25
max_facing_direction_angle_backward 0.15
max_facing_direction_angle_side_opposite_sign 0.3
max_facing_direction_angle_side_same_sign 0.2
number_of_knots 7

[LEFT_FOOT]
on_threshold 0.012
off_threshold 0.011
switch_on_after 0.06
switch_off_after 0.05
"""

SWING_INI = """step_height 0.04
foot_apex_time 0.45
foot_landing_velocity -0.05
foot_landing_acceleration 0.02
"""

IK_CURRENT = f"""[LEFT_FOOT]
kp_linear 6.0
kp_angular 4.5

[COM]
kp_linear 2.5

[ROOT_TASK]
kp_linear 1.5

[CHEST]
kp_angular 5.5
frame_name "chest"
weight (9.0, 9.0, 8.0)

[JOINT_REGULARIZATION]
kp ({", ".join(["4.0"] * 26)})
weight ({", ".join(["1.5"] * 6 + ["2.0"] * 8 + ["1.0"] * 12)})
"""

IK_ORIGINAL = f"""[L_FOOT]
kp_linear 5.0
kp_angular 4.0

[COM_TASK]
kp_linear 10.0

[CHEST_TASK]
kp_angular 5.0
frame_name neck_2
weight (1.0, 1.0, 1.0)

[REGULARIZATION_TASK]
kp 5.0
weight ({", ".join(["1.0"] * 3 + ["2.0"] * 8 + ["1.0"] * 15)})
"""

ODOM_INI = """[ModelInfo]
base_link "root_link"
base_link_imu "root_link"
left_foot_contact_frame "l_sole"
right_foot_contact_frame "r_sole"

[LeggedOdom]
initial_fixed_frame "r_sole"
switching_pattern "alternate"
"""

ICUB_MPC_INI = f"""controller_sampling_time 0.1
controller_horizon 13
number_of_maximum_contacts 2
static_friction_coefficient 0.33
com_weight (10.0, 10.0, 200.0)
contact_position_weight 2000.0
force_rate_of_change_weight (10.0, 10.0, 10.0)
angular_momentum_weight 100.0

[CONTACT_0]
{CORNERS}bounding_box_lower_limit (-0.01, 0.0, 0.0)
bounding_box_upper_limit (0.01, 0.05, 0.0)

[CONTACT_1]
{CORNERS}bounding_box_lower_limit (-0.01, -0.05, 0.0)
bounding_box_upper_limit (0.01, 0.0, 0.0)
"""

ROBOTS = {
    "current": {"centroidal_mpc_walking.ini": MAIN_INI, "centroidal_mpc.ini": MPC_INI, "mann.ini": MANN_INI,
                "swing_foot_planner.ini": SWING_INI, "ik.ini": IK_CURRENT, "legged_odometry.ini": ODOM_INI},
    "original_ik": {"centroidal_mpc_walking.ini": MAIN_INI, "centroidal_mpc.ini": MPC_INI, "mann.ini": MANN_INI,
                    "swing_foot_planner.ini": SWING_INI, "ik.ini": IK_ORIGINAL, "legged_odometry.ini": ODOM_INI},
    "icub_old": {"centroidal_mpc_walking.ini": "[WHOLE_BODY_RUNNER]\nsampling_time 0.01\n",
                 "centroidal_mpc.ini": ICUB_MPC_INI},
}


def write_robot(root, name):
    d = root / name
    d.mkdir()
    for fname, text in ROBOTS[name].items():
        (d / fname).write_text(text)
    return str(d)


def flat(cfg, prefix=""):
    """{field path: value} over a config and its nested dataclasses."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update(flat(v, f"{prefix}{f.name}."))
        else:
            out[f"{prefix}{f.name}"] = v
    out[f"{prefix}<class>"] = type(cfg).__name__
    return out


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_robot_config_matches_jax_field_by_field(tmp_path, robot):
    d = write_robot(tmp_path, robot)
    got, want = flat(TI.load_robot_config(d)), flat(JI.load_robot_config(d))
    assert list(got) == list(want)
    diff = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
    assert not diff, diff
    # the files were read, not defaulted
    cfg = TI.load_robot_config(d)
    if robot == "icub_old":
        assert cfg.mpc.dt == 0.1 and cfg.mpc.horizon == pytest.approx(1.3) and cfg.wbc_dt == 0.01
        assert cfg.mpc.force_symmetry_weight == 0.0  # absent in the original formulation
    else:
        assert cfg.mpc.mu == 0.4 and cfg.mpc.corners[0][2] == (-0.07, -0.02, 0.0)
        assert cfg.gen.on_threshold == 0.012 and cfg.swing.landing_velocity == -0.05
        assert cfg.gains.zmp_gain == (0.6, 0.4) and cfg.odom.switching_pattern == "alternate"
        assert cfg.ik.chest_frame == ("neck_2" if robot == "original_ik" else "chest")


def test_walk_cli_reads_a_robot_dir(tmp_path, capsys):
    """`walk --robot-dir --cpu` on the written directory for 5 ticks (one MPC
    tick at its 0.6 s horizon): finite, and the telemetry holds 5 ticks."""
    mann = tmp_path / "mann4.onnx"
    mann.write_bytes(chip_smoke.mann_onnx_bytes(chip_smoke.synthetic_mann_numpy()))
    out = str(tmp_path / "tel.npz")
    TWalk.main(["--cpu", "--robot-dir", write_robot(tmp_path, "current"), "--mann", str(mann), "--seconds", "0.01",
                "--out", out])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["ticks"] == 5 and summary["finite"], summary
    from cmw_tpu_torch.runtime import telemetry

    chans, _ = telemetry.load(out)
    assert chans["com_mpc"].shape == (5, 3)


def test_written_ergocub_dir_loads_back(tmp_path):
    """chip_smoke.write_robot_dir (phase 12's robot directory) writes
    ergocub_gazebo_v1()'s values: both loaders read it back to their own
    package's preset, field for field."""
    from cmw_tpu.runtime.config import ergocub_gazebo_v1 as jax_preset
    from cmw_tpu_torch.runtime.config import ergocub_gazebo_v1

    d = chip_smoke.write_robot_dir(str(tmp_path), ergocub_gazebo_v1())
    assert TI.load_robot_config(d) == ergocub_gazebo_v1()
    assert flat(JI.load_robot_config(d)) == flat(jax_preset())

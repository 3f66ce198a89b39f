"""Configuration presets (the reference's ini tree).

PyTorch counterpart of `cmw_tpu/runtime/config.py`: every field and
property of `WalkingConfig` with its default, and the presets
`ergocub_gazebo_v1` (sim: MPC 16.7 Hz, WBC 500 Hz) and `ergocub_sn000`
(robot: MPC 10 Hz, WBC 200 Hz, MANN slowed 5x). Each field's full rationale
is in the JAX package's docstrings at the same name; the fields marked
"(rigid)" act only with the rigid-body plant (`rigid` set).
"""

from __future__ import annotations

import dataclasses
import math

from portbench.reference.cmpc.formulation import MPCConfig
from portbench.reference.estimation.legged_odom import OdomConfig
from portbench.reference.mann.generator import GeneratorConfig
from portbench.reference.mann.input_builder import InputBuilderConfig
from portbench.reference.sim.plant import PlantConfig
from portbench.reference.sim.rigid_body import RigidBodyConfig
from portbench.reference.wbc.com_zmp import CoMZMPGains
from portbench.reference.wbc.diff_ik import IKConfig
from portbench.reference.wbc.swing_foot import SwingFootConfig


@dataclasses.dataclass(frozen=True)
class WalkingConfig:
    """Everything the closed loop needs; hashable."""

    mpc: MPCConfig = MPCConfig()
    gen: GeneratorConfig = GeneratorConfig()
    ik: IKConfig = IKConfig()
    swing: SwingFootConfig = SwingFootConfig()
    gains: CoMZMPGains = CoMZMPGains()
    input_builder: InputBuilderConfig = InputBuilderConfig()
    odom: OdomConfig = OdomConfig()
    plant: PlantConfig = PlantConfig()  # default: ideal (adherent) plant
    # the rigid-body plant (sim/rigid_body.py, the Gazebo stand-in); None ->
    # the reference's adherent topology on the kinematic plant
    rigid: RigidBodyConfig | None = None
    rigid_settle_s: float = 0.4  # pre-episode contact settling time (rigid)
    wbc_dt: float = 0.002  # WHOLE_BODY_RUNNER sampling_time
    plan_phases: int = 16
    # CoM-height reference override (CentroidalMPCBlock.cpp:531-534); None ->
    # com_height_drop below the model's standing CoM
    com_height_override: float | None = None
    com_height_drop: float = 0.05
    # startup reference decay constant; None -> 0.4 on the rigid plant, 0 here
    ref_ramp_tau: float | None = None
    # stand mode: below this joystick motion, freeze the MANN autoregression
    # and hold the CoM over the stance centroid
    stand_mode: bool = True
    stand_threshold: float = 0.05
    lift_gate_window: float = 0.0  # contact-force-gated swing lift (rigid)
    lift_load_thresh: float = 0.25
    gait_hold_window: float = 0.5  # gait-hold clock pause (rigid)
    gait_hold_thresh: float = 0.25
    gait_hold_max_s: float = 0.6
    capture_margin_x: float = 0.15  # gait-hold capture hull margins (rigid)
    capture_margin_y: float = 0.10
    state_fb_gain: float = 3.0  # measured-state feedback into x9 (rigid)
    state_fb_l: float = 3.0
    com_int_band: float = 0.05  # CoM integrator anti-windup band (rigid)
    # joystick slew limit on the motion components (full scale per second; 0 off)
    joypad_slew: float = 0.0
    reconcile_contacts: bool = True  # measured landing poses into the plan (rigid)
    reconcile_load_thresh: float = 0.15  # x body weight
    gen_resync: bool = True  # generator world re-sync (rigid)
    td_load_thresh: float = 0.10  # early touchdown (rigid)
    td_lookahead: float = 0.13
    perfect_state: bool = False  # ground-truth base pose (rigid, diagnostic)
    ang_mom_task_weight: float = 0.0  # IK angular-momentum task (rigid)
    cp_gov: float = 2.0  # capture-point speed governor (rigid)
    lag_gov: float = 0.0  # CoM-lag speed governor (rigid)
    lag_band: float = 0.10
    cp_gov_margin: float = 0.10  # cp_gov's stance-toe reach margin (m)
    rush_gain: float = 5.0  # gait-rush (rigid)
    rush_margin: float = 0.03
    step_ext_max: float = 0.20  # capture step extension (rigid)
    step_ext_margin: float = 0.06
    brake_speed: float = 0.0  # overspeed double-support brake (rigid)
    brake_margin: float = 0.05
    # IK joint-limit box (default off = the reference's equality-only stack):
    # qdot in clip(ik_limit_gain (q_lim - q), +-qd_lim) via qp.solve_eq_box_qp
    ik_joint_limits: bool = False
    ik_limit_gain: float = 5.0
    fwd_release: float = 1.0  # forward-escape hold release (rigid)
    rush_ds: float = 1.0  # double-support rush (rigid)
    chest_w_rp: float = 1.0  # chest roll/pitch weight multiplier (rigid)
    chest_lean_gain: float = 0.0  # capture-scheduled chest lean (rigid)
    step_reach_len: float = 0.0  # catch-step reach cap (rigid)
    crouch_gain: float = 0.0  # capture-scheduled crouch (rigid)
    crouch_max: float = 0.12
    odom_blend: float = 0.25  # odometry anchor complementary filter (rigid)
    # scale on the MANN angular-momentum reference fed to the MPC
    # (1 = CentroidalMPCBlock.cpp:525-529)
    ang_mom_ref_scale: float = 1.0

    @property
    def ref_ramp(self) -> float:
        """Resolved startup-reference decay constant (ref_ramp_tau)."""
        if self.ref_ramp_tau is None:
            return 0.4 if self.rigid is not None else 0.0
        return self.ref_ramp_tau

    @property
    def mpc_every(self) -> int:
        return int(round(self.mpc.dt / self.wbc_dt))

    @property
    def mann_calling_time(self) -> float:
        """mannCallingTime = lcm(slow_down_factor * gen dT, MPC dT)
        (CentroidalMPCBlock.cpp:262-265): the generator advances only when
        this much gait time has passed since its last call; between calls
        the stored output is re-sliced at absolute times. 60 ms (every MPC
        tick) for the factor-1 sim robots, 100 ms (every tick) for
        ergoCubSN000, 300 ms (every 5th tick) for ergoCubSN001."""
        a = round(self.gen.slow_down_factor * self.gen.dt * 1e6)
        b = round(self.mpc.dt * 1e6)
        return math.lcm(a, b) / 1e6

    @property
    def mann_advance(self) -> int:
        """Generator steps consumed per call, the reference's
        mergePointIndex (CentroidalMPCBlock.cpp:265)."""
        adv = int(round(self.mann_calling_time / (self.gen.slow_down_factor * self.gen.dt)))
        if adv > self.gen.n_steps:
            raise ValueError(
                f"mannCallingTime {self.mann_calling_time} needs a merge point {adv} steps in, beyond the "
                f"generator horizon ({self.gen.n_steps} steps) — lengthen gen.time_horizon"
            )
        return adv

    @property
    def mann_call_every(self) -> int:
        """MPC ticks between generator calls (an integer by construction)."""
        return int(round(self.mann_calling_time / self.mpc.dt))


def ergocub_gazebo_v1(**overrides) -> WalkingConfig:
    """Sim preset (config/robots/ergoCubGazeboV1: MPC 16.7 Hz, WBC 500 Hz)."""
    return WalkingConfig(**overrides)


def ergocub_sn000(**overrides) -> WalkingConfig:
    """Robot preset (config/robots/ergoCubSN000: MPC 10 Hz with a 1.3 s
    horizon, WBC 200 Hz, the MANN gait slowed 5x in real time, mann.ini:16)."""
    kw = dict(
        mpc=MPCConfig(dt=0.1, horizon=1.3, sqp_iters=2, admm_iters=30),
        gen=GeneratorConfig(slow_down_factor=5.0),
        wbc_dt=0.005,
    )
    kw.update(overrides)
    return WalkingConfig(**kw)

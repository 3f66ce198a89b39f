"""The closed-loop walking controller, tick after tick, batch-first.

PyTorch counterpart of `cmw_tpu/runtime/loop.py`. One
`WalkingController.step` is one WBC tick (wbc_dt); every `mpc_every`-th tick
first runs the MPC stage:

  every WBC tick (`_wbc_stage`):        every MPC tick (`_mpc_stage`):
    plant servo + encoder read            joystick slew -> input builder
    fixed-foot detector                   MANN generate (re-rooted at the
    legged odometry                         merge point) or re-slice
    centroidal RK4 integrator             frequency adapters, stand mode
    measured / desired ZMP                contact-plan merge + grid snap
    CoM-ZMP stabilizer + LTI integrator   centroidal MPC solve (warm)
    swing-foot planners                   adjusted steps written back,
    differential-IK QP                      first-interval forces held
    floating-base + joint integration

The MPC receives the integrated centroidal state, not measurements (the
reference's adherent loop, WholeBodyQPBlock.cpp:1259-1262). Every tensor
carries a leading batch axis [B]; JAX's per-item `lax.cond` and `tree_map`
selections become `torch.where` over the batch. Whether a tick is an MPC tick
is decided on the host from a Python-int tick counter (the same for every
item), so a WBC tick reads nothing back from the card; an MPC tick reads one
flag vector (does any item call the generator).

With `cfg.rigid` set the plant is the rigid-body dynamics
(`sim/rigid_body.py`, the Gazebo stand-in) and the controller closes the loop
on its measurements: the spawn settles onto the contact in `initial_state`;
the MPC stage adds the gait hold and the speed governors, the generator
re-sync, the contact reconciliation and the capture step; the WBC stage steps
the plant (the push is a real force on the base), keeps a persistent
odometry anchor with IMU attitude, feeds the measured state back into the
integrator, reads the ZMP from the contact forces and adds the touchdown and
lift gates, the gait rush, the crouch, the chest lean and the rigid-only IK
rows.

On the card the stages replay CUDA graphs cached for the controller's value
and the inputs' shapes (`runtime/cache.py`), the counterparts of JAX's
jitted episode (`cmw_tpu/runtime/loop.py:1488-1564`): the WBC stage one
graph; the MPC stage two, `_mpc_pre` and `_mpc_post`, around its one host
read (does any item call the generator: post's graph is keyed by that bool,
JAX's `lax.cond`); and in the blocked and folded episodes each whole MPC
period one graph (`_period`: the MPC stage with the generator run for the
whole batch and selected per item, as JAX's vmapped cond selects, then
mpc_every WBC ticks), reading nothing back inside a period.

Tracing (`runtime/trace.py`): `step` is the span `loop.step` with the tick
as request id, holding `loop.mpc_stage` (with `loop.mpc_read`, its one host
read) and `loop.wbc_stage`; each period of `_periods` is `loop.period` with
the count of periods run before it in the process as request id. Inside the stages, `trace.stage` marks `mann`,
`mpc.solve`, `wbc.plant` (the rigid plant's dynamics step),
`wbc.estimation` and `wbc.ik`; what they leave out (the kinematic plant,
integrators, ZMP, swing feet, telemetry, the MPC stage's glue) is the self
time of `loop.mpc_stage` / `loop.wbc_stage`. A graph captured with tracing
on carries these stages' device marks into every replay; a graph captured
with tracing off carries none, and each span site then costs one flag
check.
"""

from __future__ import annotations

import functools
import itertools
from typing import NamedTuple

import torch

from cmw_tpu_torch.cmpc import formulation as F
from cmw_tpu_torch.cmpc.solver import CentroidalMPCSolver, WarmStart
from cmw_tpu_torch.core import contacts as C
from cmw_tpu_torch.core import kinematics as kin
from cmw_tpu_torch.core import lie
from cmw_tpu_torch.core.centroidal import centroidal_dynamics, pack_state
from cmw_tpu_torch.core.consts import constant_like, eye_like
from cmw_tpu_torch.core.integrators import rk4_step
from cmw_tpu_torch.core.splines import linear_spline
from cmw_tpu_torch.estimation import fixed_foot, legged_odom
from cmw_tpu_torch.mann import generator as G
from cmw_tpu_torch.mann.input_builder import DesiredBaseTrajectory, build_desired_trajectory
from cmw_tpu_torch.mann.network import MANNWeights
from cmw_tpu_torch.runtime import cache, trace
from cmw_tpu_torch.runtime.config import WalkingConfig
from cmw_tpu_torch.sim import plant as P
from cmw_tpu_torch.sim import rigid_body as RB
from cmw_tpu_torch.wbc import swing_foot
from cmw_tpu_torch.wbc.com_zmp import com_zmp_control
from cmw_tpu_torch.wbc.diff_ik import IKTargets, solve_ik
from cmw_tpu_torch.wbc.zmp import desired_zmp_from_corners


class DynConfig(NamedTuple):
    """Tuning knobs carried as tensors [B] in LoopState (cmw_tpu's traced
    knobs, loop.py:54-127); defaults from the WalkingConfig fields of the
    same names. On the kinematic plant only joypad_slew acts; the rest feed
    the rigid-plant branches."""

    gait_hold_window: torch.Tensor
    gait_hold_thresh: torch.Tensor
    gait_hold_max_s: torch.Tensor
    capture_margin_x: torch.Tensor
    capture_margin_y: torch.Tensor
    state_fb_gain: torch.Tensor
    state_fb_l: torch.Tensor
    com_int_band: torch.Tensor
    joypad_slew: torch.Tensor
    td_load_thresh: torch.Tensor
    td_lookahead: torch.Tensor
    ang_mom_w: torch.Tensor
    cp_gov: torch.Tensor
    lag_gov: torch.Tensor
    lag_band: torch.Tensor
    cp_margin: torch.Tensor
    rush_gain: torch.Tensor
    rush_margin: torch.Tensor
    step_ext_max: torch.Tensor
    step_ext_margin: torch.Tensor
    odom_blend: torch.Tensor
    brake_speed: torch.Tensor
    brake_margin: torch.Tensor
    fwd_release: torch.Tensor
    rush_ds: torch.Tensor
    chest_w_rp: torch.Tensor
    chest_lean_gain: torch.Tensor
    step_reach_len: torch.Tensor
    crouch_gain: torch.Tensor
    crouch_max: torch.Tensor


# DynConfig field -> the WalkingConfig field it starts from
_PERIODS = itertools.count()  # the periods `_periods` has run in this process: each `loop.period` span's request id

_DYN_SOURCE = dict(
    {f: f for f in DynConfig._fields},
    ang_mom_w="ang_mom_task_weight",
    cp_margin="cp_gov_margin",
)


class StoredMann(NamedTuple):
    """The last generator call's output, re-sliced at absolute times on the
    MPC ticks between calls (CentroidalMPCBlock.cpp:477-500,544-577)."""

    t0: torch.Tensor  # [B] absolute time of the call
    com: torch.Tensor  # [B, S, 3] CoM timeline (raw MANN, world)
    ang_mom: torch.Tensor  # [B, S, 3] angular-momentum timeline (raw MANN)
    joints0: torch.Tensor  # [B, nj] first-knot posture (regularisation target)
    yaw0: torch.Tensor  # [B] first-knot base yaw (chest task set-point)
    plan: C.ContactPlan  # MANN contact phase list (absolute times)


class LoopState(NamedTuple):
    t: torch.Tensor  # [B] absolute (gait) time
    tick: torch.Tensor  # [B] long
    x9: torch.Tensor  # [B, 9] integrated centroidal state (the MPC's plant)
    com_xy_int: torch.Tensor  # [B, 2] CoM LTI integrator
    base_rot: torch.Tensor  # [B, 3, 3] desired floating base
    base_pos: torch.Tensor  # [B, 3]
    q: torch.Tensor  # [B, nj] desired joints (PositionDirect stream)
    warm: WarmStart
    plan: C.ContactPlan  # merged + MPC-adjusted plan
    forces0: torch.Tensor  # [B, nc, ncor, 3] held first-interval MPC forces
    corner0: torch.Tensor  # [B, nc, ncor, 3] their world positions
    active0: torch.Tensor  # [B, nc]
    zmp_des: torch.Tensor  # [B, 3]
    gen_state: G.GeneratorState
    q_reg: torch.Tensor  # [B, nj] MANN posture regularisation
    chest_yaw: torch.Tensor  # [B]
    root_z_off: torch.Tensor  # [B] bootstrap root offset (WBQP:1066-1080)
    com_z_ref: torch.Tensor  # [B] height reference
    ref_off: torch.Tensor  # [B, 3] decaying startup reference offset
    mpc_cost: torch.Tensor  # [B] last solve diagnostics
    mpc_prim: torch.Tensor  # [B]
    plant: P.PlantState  # simulated robot (servo lag + sensor noise)
    rb: RB.RigidBodyState | None  # the rigid-body plant (None on the kinematic plant)
    com_mann: torch.Tensor  # [B, 3] MANN CoM reference at knot 0
    ang_mom_mann: torch.Tensor  # [B, 3] MANN angular-momentum reference
    hold: torch.Tensor  # [B] 1 while the gait clock is paused (rigid plant)
    hold_time: torch.Tensor  # [B]
    joypad_lp: torch.Tensor  # [B, 4] slew-limited joystick
    mann: StoredMann
    odo: legged_odom.OdometryState
    dyn: DynConfig


class RigidMeasurements(NamedTuple):
    """What the MPC stage measures on the rigid plant before it plans
    (cmw_tpu/runtime/loop.py:536-599), in the current estimate frame."""

    prev_plan: C.ContactPlan  # the previous plan, snapped to the MPC grid
    feet_prev: swing_foot.FootState  # its swing feet now
    load: torch.Tensor  # [B, nc] measured normal force per foot / body weight
    meas_pos: torch.Tensor  # [B, nc, 3] measured sole positions at z = 0
    meas_rot: torch.Tensor  # [B, nc, 3, 3] their yaw-only rotations
    base_rot: torch.Tensor  # [B, 3, 3] estimated base attitude
    com: torch.Tensor  # [B, 3] estimated CoM
    dcom: torch.Tensor  # [B, 3] estimated CoM velocity
    cp_xy: torch.Tensor  # [B, 2] instantaneous capture point (LIPM)
    pos_cp: torch.Tensor  # [B, nc, 3] each foot's current phase position


class MPCPre(NamedTuple):
    """What the MPC stage computes before its host read (`_mpc_pre`), for
    `_mpc_post`."""

    joypad_lp: torch.Tensor  # [B, 4] slewed joystick (the slew state; stand mode keys off it)
    moving: torch.Tensor  # [B] bool: above the stand threshold
    hold: torch.Tensor  # [B] gait hold (rigid; zeros on the kinematic plant)
    hold_time: torch.Tensor  # [B]
    desired: DesiredBaseTrajectory  # the governed joystick's desired base path
    gen_state: G.GeneratorState  # after the re-sync (rigid)
    stored: StoredMann  # after the re-sync (rigid)
    call_now: torch.Tensor  # [B] bool: the item calls the generator
    rig: RigidMeasurements | None  # the rigid plant's measurements (None on the kinematic plant)


class TickInput(NamedTuple):
    joypad: torch.Tensor  # [B, 4] = [motion_x, motion_y, facing_x, facing_y]
    ext_force: torch.Tensor  # [B, 3] mass-normalised push (measured wrench)
    ext_torque: torch.Tensor  # [B, 3]


class Telemetry(NamedTuple):
    """Per-tick channels [B, ...] (the reference's VectorsCollectionServer
    schema, WholeBodyQPBlock.cpp:655-712; runtime/telemetry.SCHEMA)."""

    com_mpc: torch.Tensor
    dcom_mpc: torch.Tensor
    ang_mom_mpc: torch.Tensor
    com_meas: torch.Tensor
    com_ik_target: torch.Tensor
    zmp_des: torch.Tensor
    foot_pos_des: torch.Tensor
    foot_contact: torch.Tensor
    forces0: torch.Tensor
    q: torch.Tensor
    base_pos: torch.Tensor
    base_est_pos: torch.Tensor
    fixed_foot_idx: torch.Tensor
    mpc_cost: torch.Tensor
    mpc_prim: torch.Tensor
    adjusted_step: torch.Tensor
    zmp_meas: torch.Tensor
    vcom_zmp: torch.Tensor
    dq_cmd: torch.Tensor
    joypad: torch.Tensor
    q_reg: torch.Tensor
    com_mann: torch.Tensor
    ang_mom_mann: torch.Tensor
    gait_hold: torch.Tensor
    gait_rush: torch.Tensor
    base_act_pos: torch.Tensor
    base_act_up: torch.Tensor
    base_act_lean: torch.Tensor
    fz_act: torch.Tensor
    ft_act: torch.Tensor
    com_act: torch.Tensor
    q_act: torch.Tensor


def _where(cond, a, b):
    """Per batch item (cond [B] bool): a where cond, else b, leaf by leaf
    over tensors and (nested) NamedTuples."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim())), a, b)
    return type(a)(*(_where(cond, x, y) for x, y in zip(a, b)))


def _without_rng(s: LoopState) -> LoopState:
    """s without the plant's noise generator, which no graph carries (a
    static leaf would key each episode's graph by its generator)."""
    return s._replace(plant=s.plant._replace(rng=None))


def _with_rng(s: LoopState, rng) -> LoopState:
    return s._replace(plant=s.plant._replace(rng=rng))


@functools.cache
def _ref_decay(dt: float, ramp: float, n: int, dtype: torch.dtype) -> tuple:
    """The startup reference offset's decay a MPC tick, exp(-dt / ramp)
    rounded to the dtype, and its powers over n knots: host values made once
    (the first call is a graph's warm-up), since a graph can make no tensor
    from host data."""
    decay = torch.exp(torch.tensor(-dt / ramp, dtype=dtype))
    return float(decay), tuple((decay ** torch.arange(n, dtype=dtype)).tolist())


def _cast_weights(w: MANNWeights, device, dtype) -> MANNWeights:
    return MANNWeights(*(tuple(a.to(device, dtype) for a in f) if isinstance(f, tuple) else f.to(device, dtype)
                         for f in w))


class WalkingController:
    """Holds the static pieces: configs, robot model, MANN weights, device."""

    def __init__(self, cfg: WalkingConfig, model: kin.RobotModel, weights: MANNWeights, *, device="cuda"):
        self.cfg = cfg
        self.model = model
        self.weights = weights
        self.device = torch.device(device)
        self.solver = CentroidalMPCSolver(cfg.mpc)
        self.mass = model.total_mass
        self._polished = {}
        self._weights = {}

    # The WBC stage's graphs are cached with the controller in the key (as
    # JAX jits the episode with `self` static), and the cache keys by
    # __hash__/__eq__. The default identity hash is UNSAFE across controller
    # lifetimes: CPython reuses a freed object's id, so a controller built
    # after a previous one died can alias the dead controller's entry and
    # silently run the OLD config's program. Observed in JAX's `sweep
    # --ablation` (one process, sequential arms): the pinned-footstep arm
    # reproduced the step-adjustment arm's 32 scenario outcomes bit-for-bit
    # while the same two configs run side by side diverged within 2 s. Hash
    # and compare by STATIC VALUE instead: the frozen WalkingConfig carries
    # full value semantics; model/weights compare by identity (the cached key
    # holds strong refs, so a hit's stored objects are alive and `is` is
    # sound). Same-value controllers share captured graphs.
    def __hash__(self):
        return hash(self.cfg)

    def __eq__(self, other):
        return (
            type(other) is WalkingController
            and self.cfg == other.cfg
            and self.model is other.model
            and self.weights is other.weights
        )

    def _weights_as(self, like: torch.Tensor) -> MANNWeights:
        key = (like.device, like.dtype)
        if key not in self._weights:
            self._weights[key] = _cast_weights(self.weights, like.device, like.dtype)
        return self._weights[key]

    # -- init -----------------------------------------------------------------

    def polished_initial_pose(self, dtype=torch.float32, drop: float | None = None):
        """The walk-ready crouch (kin.walk_ready_pose) projected onto this
        model's constraint manifold by 60 iterations of the production IK
        with both soles flat on the ground, the CoM over the feet centroid
        and, by `drop`, the root lowered to the operating height
        (cmw_tpu/runtime/loop.py:263-333). Returns (q [nj], base_rot [3, 3]);
        cached per (drop, dtype, device)."""
        if drop is None:
            drop = 0.0 if self.cfg.com_height_override is not None else self.cfg.com_height_drop
        key = (drop, dtype, self.device)
        if key in self._polished:
            return self._polished[key]
        cfg, model, dev = self.cfg, self.model, self.device
        q0_np, rot_np = kin.walk_ready_pose()
        q = torch.as_tensor(q0_np, dtype=dtype, device=dev)[None]
        base_rot = torch.as_tensor(rot_np, dtype=dtype, device=dev)[None]
        base_pos = torch.zeros(1, 3, dtype=dtype, device=dev)
        li, ri = model.frame_index("l_sole"), model.frame_index("r_sole")
        # flat-foot targets: each sole keeps its xy and yaw, both at the mean height
        fR, fp = kin.frame_poses(model, *kin.fk(model, q, base_rot, base_pos))
        z_mean = 0.5 * (fp[:, li, 2] + fp[:, ri, 2])
        foot_pos_t = torch.stack([torch.cat([fp[:, f, 0:2], z_mean[:, None]], dim=-1) for f in (li, ri)], dim=1)
        foot_rot_t = torch.stack([lie.rotz(lie.yaw_of(fR[:, f])) for f in (li, ri)], dim=1)
        zeros = torch.zeros_like(foot_pos_t)
        targets = IKTargets(
            foot_rot=foot_rot_t, foot_pos=foot_pos_t, foot_lin_vel=zeros, foot_ang_vel=zeros,
            com_xy=foot_pos_t[..., 0:2].mean(dim=1), dcom_xy=torch.zeros_like(z_mean[:, None].expand(1, 2)),
            root_z=base_pos[:, 2] - drop, droot_z=torch.zeros_like(z_mean),
            chest_rot=eye_like(3, q)[None], q_reg=q,
        )
        h = 0.05
        for _ in range(60):
            nu = solve_ik(model, q, base_rot, base_pos, targets, cfg.ik)
            base_rot, base_pos = lie.integrate_mixed_velocity(base_rot, base_pos, nu[:, 0:3], nu[:, 3:6], h)
            q = q + h * nu[:, 6:]
        self._polished[key] = (q[0], base_rot[0])
        return self._polished[key]

    def _settled_plant(self, q0, base_rot0, base_pos) -> RB.RigidBodyState:
        """The rigid plant spawned at the start pose, pre-sunk by the static
        penetration mg / (8 kp) so that the springs carry the weight from the
        start, settled for rigid_settle_s while the servos hold q0, its
        friction anchors then reset (cmw_tpu/runtime/loop.py:397-420). The B
        items start identical, so the settle runs on the first and the
        result is shared."""
        cfg, model = self.cfg, self.model
        B = q0.shape[0]
        sink = self.mass * 9.80665 / (8.0 * cfg.rigid.contact_kp)
        spawn = base_pos[:1] - constant_like((0.0, 0.0, sink), base_pos)
        rb = RB.initial_state(model, q0[:1], base_rot0[:1], spawn, cfg.rigid, device=q0.device, dtype=q0.dtype)
        rb = RB.settle(cfg.rigid, model, rb, q0[:1], cfg.wbc_dt, int(round(cfg.rigid_settle_s / cfg.wbc_dt)))
        rb = RB.reset_anchors(model, rb)
        return RB.RigidBodyState(*(a.expand((B,) + a.shape[1:]) for a in rb[:-1]),
                                 RB.RigidDynParams(*(a.expand(B) for a in rb.params)))

    def initial_state(self, B: int, q0=None, base_rot0=None, dtype=torch.float32) -> LoopState:
        """B identical items at the start of an episode
        (cmw_tpu/runtime/loop.py:335-505). Default start: the
        polished walk-ready crouch; pass q0 [nj] (and base_rot0 [3, 3]) to
        start elsewhere. The controller's device holds every tensor."""
        cfg, model, dev = self.cfg, self.model, self.device
        nj = model.nj
        used_polished = q0 is None and base_rot0 is None
        if used_polished:
            q0, base_rot0 = self.polished_initial_pose(dtype)
        q0 = torch.zeros(nj, dtype=dtype, device=dev) if q0 is None else torch.as_tensor(q0, dtype=dtype, device=dev)
        base_rot0 = eye_like(3, q0) if base_rot0 is None else torch.as_tensor(base_rot0, dtype=dtype, device=dev)
        q0 = q0.expand(B, nj)
        base_rot0 = base_rot0.expand(B, 3, 3)
        zeros3 = torch.zeros(B, 3, dtype=dtype, device=dev)
        zeros = zeros3[:, 0]
        li, ri = model.frame_index("l_sole"), model.frame_index("r_sole")
        # place the base so that the lower sole touches the ground
        _, fp = kin.frame_poses(model, *kin.fk(model, q0, base_rot0, zeros3))
        base_pos = torch.stack([zeros, zeros, -torch.minimum(fp[:, li, 2], fp[:, ri, 2])], dim=-1)
        lR, lp = kin.fk(model, q0, base_rot0, base_pos)
        fR, fp = kin.frame_poses(model, lR, lp)
        com0 = kin.com(model, lR, lp)
        # the polish already descended to the operating height; an explicit
        # start still squats com_height_drop below its standing CoM
        if cfg.com_height_override is not None:
            com_z_ref = torch.full_like(zeros, cfg.com_height_override)
        elif used_polished:
            com_z_ref = com0[:, 2]
        else:
            com_z_ref = com0[:, 2] - cfg.com_height_drop

        # the initial double-stance plan: the FK soles projected to z = 0
        # with yaw-only rotations
        plan = C.empty_plan(2, cfg.plan_phases, device=dev, dtype=dtype)
        plan = C.ContactPlan(*(a.expand((B,) + a.shape).clone() for a in plan))
        for foot, idx in enumerate((li, ri)):
            plan.act[:, foot, 0] = 0.0
            plan.valid[:, foot, 0] = 1.0
            plan.pos[:, foot, 0, 0:2] = fp[:, idx, 0:2]
            plan.rot[:, foot, 0] = lie.rotz(lie.yaw_of(fR[:, idx]))

        mpc = cfg.mpc
        stage = C.mpc_stage_params(plan, 0.0, mpc.T, mpc.dt, mpc.n_slots)
        forces0 = F.nominal_force_guess(mpc, stage, dtype)[:, 0]
        _, _, corner_k = F.interval_contact_geometry(mpc, stage, stage.slot_pos_nom)
        # the MANN seed is the walk-ready (drop = 0) crouch, the network's
        # training distribution, even when the robot starts deeper
        q_ready, _ = self.polished_initial_pose(dtype, drop=0.0)
        gen0 = G.initial_state(cfg.gen, model, q_ready.expand(B, nj))
        ff0 = fixed_foot.detect(plan, zeros, cfg.odom.initial_fixed_index)
        rb0 = None
        if cfg.rigid is not None:
            rb0 = self._settled_plant(q0, base_rot0, base_pos)
            # bootstrap the integrated state from the measured (odometry) CoM
            # of the settled plant (WholeBodyQPBlock.cpp:1037-1080)
            eR, ep = legged_odom.base_pose(model, legged_odom.OdometryState(ff0.index, ff0.rot, ff0.pos), rb0.q)
            com0 = kin.com(model, *kin.fk(model, rb0.q, eR, ep))
        fixed_z = lambda x: torch.cat([x[:, 0:2], zeros[:, None]], dim=-1)  # noqa: E731
        return LoopState(
            t=zeros,
            tick=torch.zeros(B, dtype=torch.long, device=dev),
            x9=pack_state(com0, zeros3, zeros3),
            com_xy_int=com0[:, 0:2],
            base_rot=base_rot0,
            base_pos=base_pos,
            q=q0,
            warm=self.solver.cold_start(B, device=dev, dtype=dtype),
            plan=plan,
            forces0=forces0,
            corner0=corner_k[:, 0],
            active0=stage.active[..., 0],
            zmp_des=fixed_z(com0),
            gen_state=gen0,
            q_reg=q0,
            chest_yaw=zeros,
            root_z_off=base_pos[:, 2] - com0[:, 2],
            com_z_ref=com_z_ref,
            ref_off=zeros3,
            mpc_cost=zeros,
            mpc_prim=zeros,
            plant=P.initial_state(cfg.plant, q0),
            rb=rb0,
            com_mann=torch.cat([com0[:, 0:2], com_z_ref[:, None]], dim=-1),
            ang_mom_mann=zeros3,
            hold=zeros,
            hold_time=zeros,
            joypad_lp=constant_like((0.0, 0.0, 1.0, 0.0), zeros).expand(B, 4),  # facing forward
            mann=StoredMann(
                # t0 = -1e9 so that tick 0 always calls the generator; the
                # arrays are placeholders that call overwrites
                t0=torch.full_like(zeros, -1e9),
                com=torch.zeros(B, cfg.gen.n_steps, 3, dtype=dtype, device=dev),
                ang_mom=torch.zeros(B, cfg.gen.n_steps, 3, dtype=dtype, device=dev),
                joints0=q0,
                yaw0=zeros,
                plan=plan,
            ),
            odo=legged_odom.OdometryState(ff0.index, ff0.rot, ff0.pos),
            dyn=DynConfig(*(torch.full_like(zeros, getattr(cfg, _DYN_SOURCE[f])) for f in DynConfig._fields)),
        )

    # -- MPC + MANN stage (every cfg.mpc_every ticks) ---------------------------

    def _noisy(self) -> bool:
        """Sensor noise on: the WBC tick draws from the plant's generator in
        place, which a graph captured on one episode's generator cannot do
        for another's, so the tick (and a period holding it) runs eagerly."""
        pcfg = self.cfg.plant
        return pcfg.encoder_noise > 0.0 or pcfg.velocity_noise > 0.0 or pcfg.wrench_noise > 0.0

    def _mpc_stage(self, s: LoopState, inp: TickInput) -> LoopState:
        """The MPC stage: `_mpc_pre`, one read of the card (does any item
        call the generator), then `_mpc_post` with the generator run only if
        one does: JAX's unbatched `lax.cond` (cmw_tpu/runtime/loop.py:822).
        On the card each half replays its graph, post's keyed by the bool."""
        with trace.span("loop.mpc_stage"):
            s_in = _without_rng(s)
            pre = cache.graphed(("mpc_pre", self), self._mpc_pre, s_in, inp)
            with trace.span("loop.mpc_read"):
                called = bool(pre.call_now.any())  # the MPC stage's one read from the card
            # the stage writes no plant: the caller's comes back, noise generator and all
            return cache.graphed(("mpc_post", self), self._mpc_post, s_in, inp, pre, called)._replace(plant=s.plant)

    def warm_mpc_stage(self, s: LoopState, inp: TickInput) -> None:
        """On the card, capture the MPC stage's graphs for these shapes,
        post's with the generator called and without (the latter first comes
        with a stage whose items all skip the call), so that a real-time
        caller never captures while its clocks run. Off the card, nothing."""
        s_in = _without_rng(s)
        if cache.replays(s_in, inp):
            pre = cache.graphed(("mpc_pre", self), self._mpc_pre, s_in, inp)
            for called in (True, False):
                cache.graphed(("mpc_post", self), self._mpc_post, s_in, inp, pre, called)

    def _mpc_pre(self, s: LoopState, inp: TickInput) -> MPCPre:
        """The MPC stage up to its host read: the joystick slew, the rigid
        plant's measurements, gait hold and speed governors, the desired
        base trajectory, the generator re-sync, and which items call the
        generator."""
        cfg, mpc = self.cfg, self.cfg.mpc
        # 0. joystick slew limit; facing passes through (slew 0 disables)
        dmax = (s.dyn.joypad_slew * mpc.dt)[:, None]
        motion = s.joypad_lp[:, 0:2] + torch.minimum(torch.maximum(inp.joypad[:, 0:2] - s.joypad_lp[:, 0:2], -dmax),
                                                     dmax)
        motion = torch.where(s.dyn.joypad_slew[:, None] > 0, motion, inp.joypad[:, 0:2])
        joypad = torch.cat([motion, inp.joypad[:, 2:4]], dim=-1)
        # the slew state and stand mode key off the pre-governor command
        joypad_lp = joypad
        moving = torch.linalg.vector_norm(joypad[:, 0:2], dim=-1) > cfg.stand_threshold
        hold, hold_time, rig = torch.zeros_like(s.hold), s.hold_time, None
        if cfg.rigid is not None:
            # 0b. the rigid plant's measurements, gait hold and speed governors
            rig = self._rigid_measurements(s)
            hold, hold_time = self._gait_hold(s, rig)
            joypad = self._speed_governors(s, rig, joypad)

        # 1. joystick -> desired base trajectory
        desired = build_desired_trajectory(joypad[:, 0:2], joypad[:, 2:4], cfg.input_builder)
        gen_state, stored = s.gen_state, s.mann
        if cfg.rigid is not None and cfg.gen_resync:
            gen_state, stored = self._resync_generator(s, gen_state, stored)

        # 2. the generator advances when mannCallingTime of gait time has
        # passed since its last call (half a WBC tick of slack for the f32
        # clock), re-rooted mann_advance knots in
        call_now = (s.t - stored.t0 >= cfg.mann_calling_time - 0.5 * cfg.wbc_dt) | (s.tick == 0)
        return MPCPre(joypad_lp, moving, hold, hold_time, desired, gen_state, stored, call_now, rig)

    def _mpc_post(self, s: LoopState, inp: TickInput, pre: MPCPre, called: bool) -> LoopState:
        """The MPC stage after its host read. With `called` the generator
        runs for the whole batch and each item keeps what it chose by
        pre.call_now (bitwise what a call for some items computes, and JAX's
        vmapped cond, a select); without it no item calls. Then the
        frequency adapters, merge and snap, stand mode, the rigid plan edits,
        the solve and the write-back."""
        cfg, model = self.cfg, self.model
        mpc = cfg.mpc
        dtype, dev = s.x9.dtype, s.x9.device
        gen_state, stored, moving, hold = pre.gen_state, pre.stored, pre.moving, pre.hold
        # the adapters' input knots are slow_down_factor * gen dt apart in real time
        slow = cfg.gen.slow_down_factor
        gen_times = (torch.arange(cfg.gen.n_steps, dtype=dtype, device=dev) + 1.0) * (cfg.gen.dt * slow)
        knot_times = torch.arange(mpc.N, dtype=dtype, device=dev) * mpc.dt
        gen_next = gen_state
        if called:
            with trace.stage("mann"):
                _, outs, states = G.generate_with_states(cfg.gen, model, self._weights_as(s.x9), gen_state,
                                                         pre.desired)
                called_next = G.GeneratorState(*(a[:, cfg.mann_advance - 1] for a in states))
                # the contact timeline, prepended with the current state so that
                # the ongoing stance phase covers t, as a plan at absolute times
                flags = torch.cat([gen_state.contact[:, None], outs.contact], dim=1)
                pose_tl = torch.cat([gen_state.foot_pose_xy_yaw[:, None], outs.foot_pose_xy_yaw], dim=1)
                tl_times = s.t[:, None] + torch.cat([torch.zeros_like(gen_times[:1]), gen_times])
                foot_pos = torch.cat([pose_tl[..., 0:2], torch.zeros_like(pose_tl[..., 0:1])], dim=-1)
                mann_plan = C.plan_from_timeline(flags, tl_times, foot_pos, lie.rotz(pose_tl[..., 2]),
                                                 P=cfg.plan_phases)
                fresh = StoredMann(t0=s.t, com=outs.com, ang_mom=outs.ang_mom, joints0=outs.joints[:, 0],
                                   yaw0=outs.base_xy_yaw[:, 0, 2], plan=mann_plan)
                gen_next = _where(pre.call_now, called_next, gen_state)
                stored = _where(pre.call_now, fresh, stored)

        # 3. frequency adapters: the stored rollout at the MPC knots' absolute times
        rel_times = (s.t - stored.t0)[:, None] + knot_times
        com_ref, _ = linear_spline(gen_times, stored.com, rel_times)
        com_ref = torch.cat([com_ref[..., 0:2], s.com_z_ref[:, None, None].expand(-1, mpc.N, 1)], dim=-1)
        if cfg.ref_ramp > 0.0:
            # startup shaping: decay the initial reference mismatch
            decay, powers = _ref_decay(mpc.dt, cfg.ref_ramp, mpc.N, dtype)
            ref_off = torch.where((s.tick == 0)[:, None], s.x9[:, 0:3] - com_ref[:, 0], s.ref_off * decay)
            kdec = constant_like(powers, s.x9)
            com_ref = com_ref + ref_off[:, None, :] * kdec[:, None]
        else:
            ref_off = s.ref_off
        L_ref, _ = linear_spline(gen_times, stored.ang_mom, rel_times)
        L_ref = L_ref * (cfg.ang_mom_ref_scale / (self.mass * slow))

        # 5. merge the stored MANN plan with the previous (adjusted) plan, snap
        plan = C.snap_to_grid(C.merge_plans(stored.plan, s.plan, s.t), mpc.dt)

        # stand mode: below the joystick threshold, freeze the
        # autoregression and hold the CoM over the active-contact centroid
        if cfg.stand_mode:
            gen_next = _where(moving, gen_next, gen_state)
            plan = _where(moving, plan, C.snap_to_grid(s.plan, mpc.dt))
            act_now = C.mpc_stage_params(s.plan, s.t, 1, mpc.dt, mpc.n_slots)
            w_act = act_now.active[..., 0]
            pos_now = torch.einsum("bis,bisx->bix", act_now.slot_onehot[:, :, 0, :], act_now.slot_pos_nom)
            feet_mid = (w_act[..., None] * pos_now).sum(dim=-2) / torch.clamp(w_act.sum(dim=-1, keepdim=True),
                                                                               min=1.0)
            com_hold = torch.cat([feet_mid[:, 0:2], s.com_z_ref[:, None]], dim=-1)
            still = ~moving[:, None, None]
            com_ref = torch.where(still, com_hold[:, None, :], com_ref)
            L_ref = torch.where(still, 0.0, L_ref)
        if cfg.rigid is not None:
            # the gait hold freezes the generator and the plan, so that the
            # swing, the landing and the MPC's force schedule retime together
            held = hold > 0
            gen_next = _where(held, gen_state, gen_next)
            plan = _where(held, pre.rig.prev_plan, plan)
            if cfg.reconcile_contacts:
                plan = self._reconcile_contacts(s, pre.rig, plan, hold)
            plan = self._capture_step(s, pre.rig, plan)

        # 6. solve from the integrated state, with the measured wrench
        # deadbanded as the WBC does (WholeBodyQPBlock.cpp:1018-1021)
        stage = C.mpc_stage_params(plan, s.t, mpc.T, mpc.dt, mpc.n_slots)
        ext_f, ext_tau = P.deadband_wrench(inp.ext_force, inp.ext_torque, self.mass)
        params = F.MPCParams(x0=s.x9, com_ref=com_ref, ang_mom_ref=L_ref, stage=stage, ext_force=ext_f,
                             ext_torque=ext_tau)
        with trace.stage("mpc.solve"):
            sol = self.solver.solve(params, s.warm)
        warm = self.solver.warm_from(params, sol)

        # 7. write the adjusted footsteps back; hold the first-interval forces
        plan = C.write_back_adjusted(plan, s.t, mpc.n_slots, sol.positions, stage.slot_valid)
        _, _, corner_k = F.interval_contact_geometry(mpc, stage, sol.positions)
        pos_k0 = torch.einsum("bis,bisx->bix", stage.slot_onehot[:, :, 0, :], sol.positions)
        zmp_des = desired_zmp_from_corners(sol.forces[:, 0], corner_k[:, 0], centers=pos_k0)
        # posture regularisation: only the upper body (tail 14) tracks MANN
        # (WholeBodyQPBlock.cpp:975-979)
        q_reg = torch.cat([s.q_reg[:, 0:12], stored.joints0[:, 12:26]], dim=-1)
        if cfg.stand_mode:
            q_reg = torch.where(moving[:, None], q_reg, s.q_reg)
            chest_yaw = torch.where(moving, stored.yaw0, s.chest_yaw)
        else:
            chest_yaw = stored.yaw0
        return s._replace(
            warm=warm, plan=plan, forces0=sol.forces[:, 0], corner0=corner_k[:, 0],
            active0=stage.active[..., 0], zmp_des=zmp_des, gen_state=gen_next, q_reg=q_reg,
            chest_yaw=chest_yaw, mpc_cost=sol.cost, mpc_prim=sol.prim_res, ref_off=ref_off,
            com_mann=com_ref[:, 0], ang_mom_mann=L_ref[:, 0], hold=hold, hold_time=pre.hold_time,
            joypad_lp=pre.joypad_lp, mann=stored,
        )

    # -- the rigid plant's MPC-stage branches -----------------------------------

    def _rigid_measurements(self, s: LoopState) -> RigidMeasurements:
        """Step 0b's measurements: sole poses for the landing reconciliation
        and the estimated centroidal state for the capture gates, in the
        frame of the persistent odometry anchor (loop.py:536-599)."""
        cfg, model, mpc = self.cfg, self.model, self.cfg.mpc
        rb = s.rb
        prev_plan = C.snap_to_grid(s.plan, mpc.dt)
        feet_prev = swing_foot.evaluate(prev_plan, s.t, cfg.swing)
        load = rb.corner_forces[..., 2].sum(-1) / (self.mass * 9.80665)
        if cfg.perfect_state:
            bR, bp = rb.base_rot, rb.base_pos
        else:
            bR, bp = legged_odom.base_pose_fused(model, s.odo, rb.q, rb.base_rot)
        lR, lp = kin.fk(model, rb.q, bR, bp)
        fR, fp = kin.frame_poses(model, lR, lp)
        soles = [model.frame_index(f) for f in ("l_sole", "r_sole")]
        meas_pos = torch.stack([fp[:, i] for i in soles], dim=1)
        meas_pos = torch.cat([meas_pos[..., 0:2], torch.zeros_like(meas_pos[..., 2:3])], dim=-1)
        meas_rot = lie.rotz(torch.stack([lie.yaw_of(fR[:, i]) for i in soles], dim=1))
        com_r = kin.com(model, lR, lp)
        if cfg.perfect_state:
            nu_r = rb.nu[:, 0:6]
        else:
            nu_r = legged_odom.base_twist(model, s.odo, rb.q, rb.nu[:, 6:], bR, bp)
        h_r = kin.centroidal_momentum(model, lR, lp, torch.cat([nu_r, rb.nu[:, 6:]], dim=-1))
        dcom_r = h_r[:, 0:3] / self.mass
        cp_xy = com_r[:, 0:2] + dcom_r[:, 0:2] * torch.sqrt(torch.clamp_min(com_r[:, 2], 0.3) / 9.80665)[:, None]
        idxp, _ = C.active_phase(prev_plan, s.t)
        _, _, pos_cp, _, _ = C.gather_phase(prev_plan, idxp)
        return RigidMeasurements(prev_plan, feet_prev, load, meas_pos, meas_rot, bR, com_r, dcom_r, cp_xy, pos_cp)

    def _gait_hold(self, s: LoopState, m: RigidMeasurements):
        """The gait-hold decision (loop.py:572-673): pause the clock before a
        lift-off while the transfer lags (load still on the lifting foot, or
        the capture point outside the hull of the other stance foot and the
        landing), unless the capture point escapes forward past the other
        foot's toe; the overspeed brake; never while a foot is in late swing.
        Returns (hold [B], hold_time [B])."""
        mpc, d = self.cfg.mpc, s.dyn
        dtype = s.t.dtype
        idxp, in_cp = C.active_phase(m.prev_plan, s.t)
        _, deact_p, _, _, _ = C.gather_phase(m.prev_plan, idxp)
        about_to_lift = (in_cp > 0.5) & (deact_p <= s.t[:, None] + mpc.dt + 1e-6)
        early_swing = (m.feet_prev.in_contact < 0.5) & (m.feet_prev.progress < d.gait_hold_window[:, None])
        idxn, has_n = C.next_phase(m.prev_plan, s.t)
        _, _, pos_n, _, _ = C.gather_phase(m.prev_plan, idxn)
        land_xy = torch.where(has_n[..., None] > 0, pos_n[..., 0:2], m.pos_cp[..., 0:2])
        stance_xy = m.pos_cp.flip(1)[..., 0:2]  # the OTHER foot's stance pose
        margin = torch.stack([d.capture_margin_x, d.capture_margin_y], dim=-1)[:, None, :]
        lo = torch.minimum(stance_xy, land_xy) - margin
        hi = torch.maximum(stance_xy, land_xy) + margin
        cp = m.cp_xy[:, None, :]
        capture_ok = ((cp >= lo) & (cp <= hi)).all(dim=-1)
        # forward capture escape: the remaining stance foot's toe along travel
        spd_m = torch.linalg.vector_norm(m.dcom[:, 0:2], dim=-1)
        vdir_m = m.dcom[:, 0:2] / torch.clamp_min(spd_m, 1e-6)[:, None]
        toe_other = (m.pos_cp.flip(1)[..., 0:2] @ vdir_m[:, :, None])[..., 0] + 0.08
        cp_along = (m.cp_xy * vdir_m).sum(dim=-1)
        fwd_escape = ((cp_along[:, None] > toe_other + d.rush_margin[:, None]) & (spd_m > 0.05)[:, None]
                      & (d.fwd_release > 0)[:, None])
        lagging = (about_to_lift | early_swing) & ((m.load > d.gait_hold_thresh[:, None]) | ~capture_ok) & ~fwd_escape
        # overspeed double-support brake, while a loaded toe still covers the capture point
        toe_al = torch.where(m.load > 0.05, (m.pos_cp[..., 0:2] @ vdir_m[:, :, None])[..., 0] + 0.08,
                             -1e9).amax(dim=-1)
        brake = (d.brake_speed > 0) & (spd_m > d.brake_speed) & (cp_along < toe_al + d.brake_margin)
        lagging = lagging | (about_to_lift & brake[:, None])
        late_swing = (m.feet_prev.in_contact < 0.5) & (m.feet_prev.progress >= d.gait_hold_window[:, None])
        want = lagging.any(dim=-1) & ~late_swing.any(dim=-1) & (d.gait_hold_window > 0)
        hold = (want & (s.hold_time < d.gait_hold_max_s)).to(dtype)
        hold_time = torch.where(want, s.hold_time + mpc.dt, 0.0)
        return hold, hold_time

    def _speed_governors(self, s: LoopState, m: RigidMeasurements, joypad):
        """The capture-point and CoM-lag speed governors (loop.py:675-721):
        scale the commanded motion down when the capture point runs past the
        loaded toe (+ cp_margin), or the CoM lags the loaded support along
        the motion direction (past lag_band)."""
        d = s.dyn
        sup_w = (m.load > 0.05).to(s.t.dtype)
        toe_x = torch.where(sup_w > 0, m.pos_cp[..., 0] + 0.08, -1e9).amax(dim=-1)
        overshoot = torch.clamp_min(m.cp_xy[:, 0] - (toe_x + d.cp_margin), 0.0)
        gov = torch.clamp(1.0 - d.cp_gov * overshoot, 0.0, 1.0)
        gov = torch.where(d.cp_gov > 0, gov, 1.0)
        yaw_b = lie.yaw_of(m.base_rot)
        mnorm = torch.linalg.vector_norm(joypad[:, 0:2], dim=-1)
        mdir_b = joypad[:, 0:2] / torch.clamp_min(mnorm, 1e-6)[:, None]
        cy, sy = torch.cos(yaw_b), torch.sin(yaw_b)
        mdir_w = torch.stack([cy * mdir_b[:, 0] - sy * mdir_b[:, 1], sy * mdir_b[:, 0] + cy * mdir_b[:, 1]], dim=-1)
        sup_c = (sup_w[..., None] * m.pos_cp[..., 0:2]).sum(dim=1) / torch.clamp_min(sup_w.sum(dim=-1), 1.0)[:, None]
        lag = ((sup_c - m.com[:, 0:2]) * mdir_w).sum(dim=-1)
        gov2 = torch.clamp(1.0 - d.lag_gov * torch.clamp_min(lag - d.lag_band, 0.0), 0.0, 1.0)
        gov2 = torch.where((d.lag_gov > 0) & (mnorm > 1e-3), gov2, 1.0)
        return torch.cat([joypad[:, 0:2] * (gov * gov2)[:, None], joypad[:, 2:4]], dim=-1)

    def _resync_generator(self, s: LoopState, gen_state: G.GeneratorState, stored: StoredMann):
        """Generator-plan re-sync (loop.py:728-755): translate the generator's
        virtual world, and the stored rollout in it, onto the reconciled
        plan's stance soles."""
        plan0 = C.snap_to_grid(s.plan, self.cfg.mpc.dt)
        idx0, in0 = C.active_phase(plan0, s.t)
        _, _, pos0, _, _ = C.gather_phase(plan0, idx0)
        w0 = ((in0 > 0.5) & (gen_state.contact > 0.5)).to(s.t.dtype)
        dxy = ((pos0[..., 0:2] - gen_state.foot_pose_xy_yaw[..., 0:2]) * w0[..., None]).sum(dim=1) / torch.clamp_min(
            w0.sum(dim=-1), 1.0)[:, None]

        def shift(a, d):  # add d to a's first two components
            return torch.cat([a[..., 0:2] + d, a[..., 2:]], dim=-1)

        gen_state = gen_state._replace(base_xy=gen_state.base_xy + dxy, hist_xy=gen_state.hist_xy + dxy[:, None],
                                       foot_pose_xy_yaw=shift(gen_state.foot_pose_xy_yaw, dxy[:, None]))
        stored = stored._replace(com=shift(stored.com, dxy[:, None]),
                                 plan=stored.plan._replace(pos=shift(stored.plan.pos, dxy[:, None, None])))
        return gen_state, stored

    def _reconcile_contacts(self, s: LoopState, m: RigidMeasurements, plan: C.ContactPlan, hold):
        """Contact reconciliation and early activation (loop.py:893-940): in
        the first two periods of a contact phase (the clock not held), write
        the foot's measured sole pose into it; a swinging foot that already
        carries load, its activation within td_lookahead, becomes active now."""
        mpc, d = self.cfg.mpc, s.dyn
        phases = torch.arange(plan.act.shape[-1], device=s.t.device)
        idx_c, in_c = C.active_phase(plan, s.t)
        act_c, _, _, _, _ = C.gather_phase(plan, idx_c)
        upd = (in_c > 0.5) & (act_c > s.t[:, None] - 2.0 * mpc.dt - 1e-6) & (hold < 0.5)[:, None]
        sel = (upd[..., None] & (phases == idx_c[..., None]))[..., None]
        plan = plan._replace(pos=torch.where(sel, m.meas_pos[:, :, None, :], plan.pos),
                             rot=torch.where(sel[..., None], m.meas_rot[:, :, None], plan.rot))
        idxn, has_n = C.next_phase(plan, s.t)
        act_n, _, _, _, _ = C.gather_phase(plan, idxn)
        _, in_c = C.active_phase(plan, s.t)
        early_act = ((in_c < 0.5) & (has_n > 0.5) & (m.load > d.td_load_thresh[:, None])
                     & (act_n <= s.t[:, None] + d.td_lookahead[:, None]) & (d.td_load_thresh > 0)[:, None])
        return plan._replace(act=torch.where(early_act[..., None] & (phases == idxn[..., None]), s.t[:, None, None],
                                             plan.act))

    def _capture_step(self, s: LoopState, m: RigidMeasurements, plan: C.ContactPlan):
        """Capture-step extension with the geometric reach cap (loop.py:
        942-993): move a swinging foot's next landing forward, along the
        measured CoM velocity, to the capture point + step_ext_margin (at
        most step_ext_max, and within step_reach_len of the CoM)."""
        d = s.dyn
        idxn, has_n = C.next_phase(plan, s.t)
        _, _, pos_n, _, _ = C.gather_phase(plan, idxn)
        mv = torch.linalg.vector_norm(m.dcom[:, 0:2], dim=-1)
        dirx = m.dcom[:, 0:2] / torch.clamp_min(mv, 1e-6)[:, None]
        _, in_c = C.active_phase(plan, s.t)
        lead = torch.einsum("bx,bix->bi", dirx, m.cp_xy[:, None, :] - pos_n[..., 0:2])
        ext = torch.minimum(torch.clamp_min(lead + d.step_ext_margin[:, None], 0.0), d.step_ext_max[:, None])
        off0 = torch.einsum("bx,bix->bi", dirx, pos_n[..., 0:2] - m.com[:, None, 0:2])
        d_max = torch.sqrt(torch.clamp_min(d.step_reach_len ** 2 - m.com[:, 2] ** 2, 0.0))
        ext_cap = torch.clamp_min(d_max[:, None] - off0, 0.0)
        ext = torch.where(d.step_reach_len[:, None] > 0, torch.minimum(ext, ext_cap), ext)
        do_ext = ((in_c < 0.5) & (has_n > 0.5) & (lead > 0.0) & (d.step_ext_max > 0)[:, None]
                  & (mv > 0.1)[:, None])
        new_xy = pos_n[..., 0:2] + dirx[:, None, :] * ext[..., None]
        phases = torch.arange(plan.act.shape[-1], device=s.t.device)
        sel = (do_ext[..., None] & (phases == idxn[..., None]))[..., None]
        new_pos = torch.cat([new_xy, torch.zeros_like(new_xy[..., :1])], dim=-1)[:, :, None, :]
        return plan._replace(pos=torch.where(sel, new_pos, plan.pos))

    # -- WBC stage (every tick) -------------------------------------------------

    def _wbc_stage(self, s: LoopState, inp: TickInput) -> tuple[LoopState, Telemetry]:
        """One WBC tick. On the card it replays the graph cached for this
        controller's value and the inputs' shapes; the plant's noise
        generator stays out of the graph. With sensor noise on it runs
        eagerly (`_noisy`)."""
        with trace.span("loop.wbc_stage"):
            if self._noisy():
                return self._wbc_stage_eager(s, inp)
            s2, tel = cache.graphed(("wbc_stage", self), self._wbc_stage_eager, _without_rng(s), inp)
            return _with_rng(s2, s.plant.rng), tel

    def _wbc_stage_eager(self, s: LoopState, inp: TickInput) -> tuple[LoopState, Telemetry]:
        cfg, model = self.cfg, self.model
        dt = cfg.wbc_dt
        pcfg = cfg.plant
        rigid = cfg.rigid is not None
        if rigid:
            with trace.stage("wbc.plant"):
                # the rigid plant: the servos track the PositionDirect stream
                # through the Lagrangian dynamics, the push is a real force on
                # the base, the encoders read the physical joints
                rbs = RB.dynamics_step(cfg.rigid, model, s.rb, s.q, dt, ext_force_base=inp.ext_force * self.mass)
            q_meas, ps = rbs.q, s.plant
        else:
            # kinematic plant: the actual joints track the PositionDirect
            # stream (servo lag), the encoders read them (with noise)
            rbs = s.rb
            ps = P.servo_step(pcfg, s.plant, s.q, dt)
            q_meas, _, ps = P.read_joints(pcfg, ps)

        with trace.stage("wbc.estimation"):
            # fixed foot + legged odometry on the measured joints
            ff = fixed_foot.detect(s.plan, s.t, cfg.odom.initial_fixed_index)
            if rigid:
                odo = self._odometry_anchor(s, ff, q_meas, rbs.base_rot)
                if cfg.perfect_state:
                    base_est_R, base_est_p = rbs.base_rot, rbs.base_pos
                else:
                    # the base attitude from the (ideal) base IMU
                    base_est_R, base_est_p = legged_odom.base_pose_fused(model, odo, q_meas, rbs.base_rot)
            else:
                odo = legged_odom.OdometryState(ff.index, ff.rot, ff.pos)
                base_est_R, base_est_p = legged_odom.base_pose(model, odo, q_meas)

        # measured external wrench, deadbanded below 0.7 N
        ext_f, ext_tau = P.deadband_wrench(inp.ext_force, inp.ext_torque, self.mass)
        # centroidal integrator under the held MPC forces (+ measured push)
        x9 = rk4_step(lambda x: centroidal_dynamics(x, s.forces0, s.corner0, s.active0, ext_f, ext_tau), s.x9, dt)
        com_des3, dcom_des3 = x9[:, 0:3], x9[:, 3:6]
        # measured CoM: FK of the estimated robot (WholeBodyQPBlock.cpp:950-991)
        lR, lp = kin.fk(model, q_meas, base_est_R, base_est_p)
        com_meas = kin.com(model, lR, lp)
        if rigid:
            # measured-state feedback into the integrator, lateral only
            # (loop.py:1148-1177): the height tracks the plan stiffly
            qd_meas = rbs.nu[:, 6:]  # ideal encoders
            if cfg.perfect_state:
                nu_est = rbs.nu[:, 0:6]
            else:
                nu_est = legged_odom.base_twist(model, odo, q_meas, qd_meas, base_est_R, base_est_p)
            h = kin.centroidal_momentum(model, lR, lp, torch.cat([nu_est, qd_meas], dim=-1))
            meas9 = pack_state(com_meas, h[:, 0:3] / self.mass, h[:, 3:6] / self.mass)
            g, gl = s.dyn.state_fb_gain, s.dyn.state_fb_l
            zero = torch.zeros_like(g)
            fb_rate = torch.stack([g, g, zero, g, g, zero, gl, gl, gl], dim=-1)
            x9 = x9 + dt * fb_rate * (meas9 - x9)
            com_des3, dcom_des3 = x9[:, 0:3], x9[:, 3:6]
            # measured ZMP: the plant's contact forces at the corners of
            # the odometry-frame kinematics (WholeBodyQPBlock.cpp:745-777)
            fRm, fpm = kin.frame_poses(model, lR, lp)
            soles = [model.frame_index(f) for f in ("l_sole", "r_sole")]
            cl = RB.corners(q_meas)
            corner_meas = torch.stack(
                [fpm[:, f, None, :] + torch.einsum("bac,jc->bja", fRm[:, f], cl[i]) for i, f in enumerate(soles)],
                dim=1)
            zmp_meas = desired_zmp_from_corners(rbs.corner_forces, corner_meas, centers=corner_meas.mean(dim=-2))
        elif pcfg.wrench_noise > 0.0:
            # measured ZMP from the wrench sensors (evaluateZMP, :737-803)
            zmp_meas, ps = P.read_zmp(pcfg, ps, s.forces0, s.corner0, s.corner0.mean(dim=-2))
        else:
            zmp_meas = s.zmp_des
        v_cmd = com_zmp_control(dcom_des3[:, 0:2], com_des3[:, 0:2], s.zmp_des[:, 0:2], com_meas[:, 0:2],
                                zmp_meas[:, 0:2], lie.yaw_of(s.base_rot), cfg.gains)
        com_xy_int = s.com_xy_int + dt * v_cmd
        feet = swing_foot.evaluate(s.plan, s.t, cfg.swing)
        root_z = com_des3[:, 2] + s.root_z_off
        zero = torch.zeros_like(s.t)
        rush = zero
        if rigid:
            # anti-windup: the integrated CoM command stays within
            # com_int_band of the measured CoM (0 disables)
            band = s.dyn.com_int_band[:, None]
            clipped = torch.minimum(torch.maximum(com_xy_int, com_meas[:, 0:2] - band), com_meas[:, 0:2] + band)
            com_xy_int = torch.where(band > 0, clipped, com_xy_int)
            sole_meas = torch.stack([fpm[:, f] for f in soles], dim=1)
            sole_meas = torch.cat([sole_meas[..., 0:2], torch.clamp_min(sole_meas[..., 2:3], 0.0)], dim=-1)
            feet = self._touchdown_gates(s, feet, rbs, sole_meas)
            rush, crouch, lean, dirv = self._capture_schedules(s, feet, com_meas, meas9)
            root_z = root_z - crouch
        # chest set-point: world-upright at the regularisation posture's
        # chest yaw (WholeBodyQPBlock.cpp:1219-1228)
        rfR, _ = kin.frame_poses(model, *kin.fk(model, s.q_reg, base_est_R, base_est_p))
        yaw_frame = "chest" if "chest" in model.frame_names else cfg.ik.chest_frame
        chest_rot_target = lie.rotz(lie.yaw_of(rfR[:, model.frame_index(yaw_frame)]))
        if rigid:
            # capture-scheduled forward lean about (-dy, dx, 0), toward travel
            lean_axis = torch.stack([-dirv[:, 1], dirv[:, 0], zero], dim=-1)
            chest_rot_target = lie.so3_exp(lean[:, None] * lean_axis) @ chest_rot_target
        targets = IKTargets(
            foot_rot=feet.rot, foot_pos=feet.pos, foot_lin_vel=feet.lin_vel, foot_ang_vel=feet.ang_vel,
            com_xy=com_xy_int, dcom_xy=v_cmd, root_z=root_z, droot_z=dcom_des3[:, 2],
            chest_rot=chest_rot_target, q_reg=s.q_reg,
            # the rigid-only rows: the angular-momentum task on the MPC's
            # planned L and the chest roll/pitch weight
            ang_mom=x9[:, 6:9] if rigid else None, ang_mom_w=s.dyn.ang_mom_w if rigid else None,
            chest_w_rp=s.dyn.chest_w_rp if rigid else None,
        )
        if cfg.ik_joint_limits and model.q_lim is not None:
            # joint-limit qdot box: approach the position limits
            # exponentially, capped by the actuator speed class
            ql, qh = (constant_like(tuple(model.q_lim[:, i].tolist()), s.q) for i in (0, 1))
            vm = constant_like(tuple(model.qd_lim.tolist()), s.q)
            targets = targets._replace(
                qd_lo=torch.maximum(-vm, cfg.ik_limit_gain * (ql - s.q)),
                qd_hi=torch.minimum(vm, cfg.ik_limit_gain * (qh - s.q)),
            )

        with trace.stage("wbc.ik"):
            # the IK's kinematic state: the measured (estimated) base with the
            # desired joints (WholeBodyQPBlock.cpp:962-967)
            nu = solve_ik(model, s.q, base_est_R, base_est_p, targets, cfg.ik)

        base_rot, base_pos = lie.integrate_mixed_velocity(s.base_rot, s.base_pos, nu[:, 0:3], nu[:, 3:6], dt)
        q = s.q + dt * nu[:, 6:]
        # gait time pauses while s.hold is set and runs up to 3x under the rush
        t = s.t + dt * (1.0 - s.hold) * (1.0 + rush) if rigid else s.t + dt * (1.0 - s.hold)
        s2 = s._replace(t=t, tick=s.tick + 1, x9=x9, com_xy_int=com_xy_int, base_rot=base_rot, base_pos=base_pos,
                        q=q, plant=ps, rb=rbs, odo=odo)
        stage_now = C.mpc_stage_params(s.plan, s.t, 1, cfg.mpc.dt, cfg.mpc.n_slots)
        nc = feet.in_contact.shape[-1]
        if rigid:
            act = dict(
                base_act_pos=rbs.base_pos, base_act_up=rbs.base_rot[:, 2, 2], base_act_lean=rbs.base_rot[:, 2, 0:2],
                fz_act=rbs.corner_forces[..., 2].sum(-1), ft_act=rbs.corner_forces[..., 0:2].sum(-2),
                com_act=kin.com(model, *kin.fk(model, rbs.q, rbs.base_rot, rbs.base_pos)), q_act=rbs.q)
        else:
            # the kinematic plant has no contact forces (the rigid plant's initial state's zeros in JAX)
            act = dict(base_act_pos=base_pos, base_act_up=base_rot[:, 2, 2], base_act_lean=base_rot[:, 2, 0:2],
                       fz_act=zero[:, None].expand(-1, nc), ft_act=zero[:, None, None].expand(-1, nc, 2),
                       com_act=com_meas, q_act=q)
        tel = Telemetry(
            com_mpc=com_des3, dcom_mpc=dcom_des3, ang_mom_mpc=x9[:, 6:9], com_meas=com_meas,
            com_ik_target=torch.cat([com_xy_int, com_des3[:, 2:3]], dim=-1), zmp_des=s.zmp_des,
            foot_pos_des=feet.pos, foot_contact=feet.in_contact, forces0=s.forces0, q=q, base_pos=base_pos,
            base_est_pos=base_est_p, fixed_foot_idx=ff.index.to(s.t.dtype), mpc_cost=s.mpc_cost,
            mpc_prim=s.mpc_prim, adjusted_step=stage_now.slot_pos_nom, zmp_meas=zmp_meas, vcom_zmp=v_cmd,
            dq_cmd=nu[:, 6:], joypad=inp.joypad, q_reg=s.q_reg, com_mann=s.com_mann,
            ang_mom_mann=s.ang_mom_mann, gait_hold=s.hold, gait_rush=rush, **act,
        )
        return s2, tel

    # -- the rigid plant's WBC-stage branches -----------------------------------

    def _odometry_anchor(self, s: LoopState, ff, q_meas, imu_R) -> legged_odom.OdometryState:
        """The persistent odometry anchor (loop.py:1087-1120): on a fixed-frame
        switch the new sole is pinned at its measured pose in the current
        estimate frame (z = 0, yaw only); every tick the anchor then moves
        toward the plan's pose by odom_blend (1 = the reference's instant plan
        anchoring)."""
        model = self.model
        switched = ff.index != s.odo.fixed_index
        lR0, lp0 = kin.fk(model, q_meas, *legged_odom.base_pose_fused(model, s.odo, q_meas, imu_R))
        fR0, fp0 = kin.frame_poses(model, lR0, lp0)
        li, ri = model.frame_index("l_sole"), model.frame_index("r_sole")
        left = ff.index == 0
        new_p = torch.where(left[:, None], fp0[:, li], fp0[:, ri])
        new_p = torch.cat([new_p[:, 0:2], torch.zeros_like(new_p[:, 2:3])], dim=-1)
        new_yaw = torch.where(left, lie.yaw_of(fR0[:, li]), lie.yaw_of(fR0[:, ri]))
        cont_pos = torch.where(switched[:, None], new_p, s.odo.fixed_pos)
        cont_yaw = torch.where(switched, new_yaw, lie.yaw_of(s.odo.fixed_rot))
        a = s.dyn.odom_blend
        dyaw = lie.yaw_of(ff.rot) - cont_yaw
        dyaw = torch.atan2(torch.sin(dyaw), torch.cos(dyaw))
        return legged_odom.OdometryState(ff.index, lie.rotz(cont_yaw + a * dyaw),
                                         cont_pos + a[:, None] * (ff.pos - cont_pos))

    def _touchdown_gates(self, s: LoopState, feet: swing_foot.FootState, rbs, sole_meas) -> swing_foot.FootState:
        """The early-touchdown gate (loop.py:1226-1254: a late-swing foot that
        already measures load holds its measured sole pose) and, with
        lift_gate_window > 0, the load-gated swing lift (:1256-1273: an
        early-swing foot holds its sole pose until the plant's contact forces
        say it is unloaded). sole_meas [B, nc, 3]: measured soles, z >= 0."""
        cfg, d = self.cfg, s.dyn
        load = rbs.corner_forces[..., 2].sum(-1) / (self.mass * 9.80665)
        early_td = ((feet.in_contact < 0.5) & (feet.progress > d.gait_hold_window[:, None])
                    & (load > d.td_load_thresh[:, None]) & (d.td_load_thresh > 0)[:, None])
        g = early_td[..., None]
        feet = feet._replace(pos=torch.where(g, sole_meas, feet.pos), lin_vel=torch.where(g, 0.0, feet.lin_vel),
                             ang_vel=torch.where(g, 0.0, feet.ang_vel))
        if cfg.lift_gate_window > 0.0:
            load_gate = torch.sigmoid((cfg.lift_load_thresh - load) * 30.0)
            early = (feet.in_contact < 0.5) & (feet.progress < cfg.lift_gate_window)
            gate = torch.where(early, load_gate, 1.0)[..., None]
            feet = feet._replace(pos=gate * feet.pos + (1.0 - gate) * sole_meas, lin_vel=gate * feet.lin_vel,
                                 ang_vel=gate * feet.ang_vel)
        return feet

    def _capture_schedules(self, s: LoopState, feet: swing_foot.FootState, com_meas, meas9):
        """What the measured capture point's overshoot past the loaded toe
        schedules (loop.py:1275-1327, 1353-1374): the gait rush (clock
        acceleration, 0..2), the crouch (root-z drop, up to crouch_max) and
        the chest lean (rad, up to 0.4), with the travel direction.
        Returns (rush, crouch, lean [B], dirv [B, 2])."""
        d = s.dyn
        dcom2 = meas9[:, 3:5]
        sp = torch.linalg.vector_norm(dcom2, dim=-1)
        dirv = dcom2 / torch.clamp_min(sp, 1e-6)[:, None]
        cp2 = com_meas[:, 0:2] + dcom2 * torch.sqrt(torch.clamp_min(com_meas[:, 2], 0.3) / 9.80665)[:, None]
        along = (feet.pos[..., 0:2] @ dirv[:, :, None])[..., 0]
        toe = torch.where(feet.in_contact > 0.5, along + 0.08, -1e9).amax(dim=-1)
        cp_along = (cp2 * dirv).sum(dim=-1)
        cp_over_toe = cp_along - toe  # margin-free, for the crouch and the lean
        # the rush keeps the grouping dot - (toe + margin): reassociated it is
        # not bit-identical in f32, and the rigid loop turns an ulp into a
        # trajectory shift
        over = cp_along - (toe + d.rush_margin)
        any_swing = (feet.in_contact < 0.5).any(dim=-1)
        any_contact = (feet.in_contact > 0.5).any(dim=-1)
        rush = torch.clamp(d.rush_gain * torch.clamp_min(over, 0.0), 0.0, 2.0)
        rush = torch.where((any_swing | (d.rush_ds > 0)) & (d.rush_gain > 0) & (sp > 0.05), rush, 0.0)
        # gated on contact: with no foot down `toe` is the -1e9 sentinel
        gate = (sp > 0.05) & any_contact
        over_toe = torch.clamp_min(cp_over_toe, 0.0)
        crouch = torch.where(gate, torch.minimum(torch.clamp_min(d.crouch_gain * over_toe, 0.0), d.crouch_max), 0.0)
        lean = torch.where(gate, torch.clamp(d.chest_lean_gain * over_toe, 0.0, 0.4), 0.0)
        return rush, crouch, lean, dirv

    # -- the step + episode ------------------------------------------------------

    def step(self, s: LoopState, inp: TickInput, tick: int) -> tuple[LoopState, Telemetry]:
        """One WBC tick, preceded by the MPC stage when `tick` (a Python int,
        the same for every item: s.tick without reading the card) is a
        multiple of mpc_every."""
        with trace.span("loop.step", tick):
            if tick % self.cfg.mpc_every == 0:
                s = self._mpc_stage(s, inp)
            return self._wbc_stage(s, inp)

    def _episode(self, s0: LoopState, inputs: TickInput, tick: int, on_tick) -> LoopState:
        """The episode's loop: `step` on each tick's inputs from the Python
        int `tick`, each tick's batched Telemetry [B, ...] handed to on_tick.
        Returns the final state."""
        s = s0
        for k in range(inputs.joypad.shape[1]):
            s, tel = self.step(s, TickInput(*(a[:, k] for a in inputs)), tick + k)
            on_tick(tel)
        return s

    def run_episode(self, s0: LoopState, inputs: TickInput):
        """inputs: TickInput [B, S, ...]. Returns (final state, Telemetry
        stacked [B, S, ...]). s0's tick is read from the state once."""
        tels = []
        s = self._episode(s0, inputs, int(s0.tick[0]), tels.append)
        return s, Telemetry(*(torch.stack(parts, dim=1) for parts in zip(*tels)))

    def _blocked_tick(self, s0: LoopState, inputs: TickInput) -> int:
        """s0's tick, read once as run_episode reads it, after the blocked
        episode's preconditions (cmw_tpu/runtime/loop.py:1508-1564): it
        starts on an MPC tick and runs whole MPC periods. ValueError where
        JAX asserts."""
        k = self.cfg.mpc_every
        S = inputs.joypad.shape[1]
        tick = int(s0.tick[0])
        if tick % k:
            raise ValueError(f"the episode must start on an MPC tick: tick {tick} is not a multiple of {k}")
        if S % k:
            raise ValueError(f"episode length {S} must be a multiple of {k}")
        return tick

    def _period(self, s: LoopState, blk: TickInput, fold=None, acc=None):
        """One MPC period from an MPC tick, blk [B, mpc_every, ...]: the MPC
        stage on the block's first input with the generator run for the
        whole batch (`_mpc_post(called=True)`: each item keeps its choice by
        call_now, bitwise the stage's result whenever an item calls, and what
        JAX's vmapped cond selects), then mpc_every eager-body WBC ticks.
        Returns (state, Telemetry [B, mpc_every, ...]) or, with fold, (state,
        the accumulator folded over the ticks). Reads nothing back."""
        first = TickInput(*(a[:, 0] for a in blk))
        s = self._mpc_post(s, first, self._mpc_pre(s, first), True)
        tels = []
        for k in range(blk.joypad.shape[1]):
            s, tel = self._wbc_stage_eager(s, TickInput(*(a[:, k] for a in blk)))
            if fold is None:
                tels.append(tel)
            else:
                acc = fold(acc, tel)
        if fold is None:
            return s, Telemetry(*(torch.stack(parts, dim=1) for parts in zip(*tels)))
        return s, acc

    def _periods(self, s0: LoopState, inputs: TickInput, fold=None, acc=None):
        """The blocked episode's loop: `_period` on each whole MPC period of
        inputs, one replayed graph a period on the card, keyed by the
        controller and the fold, as JAX scans the period body
        (cmw_tpu/runtime/loop.py:1508-1564). Returns (final state, the
        periods' Telemetry [B, S, ...] or the accumulator)."""
        k = self.cfg.mpc_every
        card = cache.replays(s0)
        s, tels = _without_rng(s0), []
        for j in range(0, inputs.joypad.shape[1], k):
            blk = TickInput(*(a[:, j:j + k] for a in inputs))
            with trace.span("loop.period", next(_PERIODS)):
                s, out = cache.graphed(("period", self), self._period, s, blk, fold, acc)
            if fold is None:
                tels.append(out)
                continue
            if card and cache.signature(out) != cache.signature(acc):
                raise ValueError(f"run_episode_fold on the card: the fold {fold!r} changed its accumulator's "
                                 "structure, shapes or dtypes; as a scan carry, it must keep them")
            acc = out
        s = _with_rng(s, s0.plant.rng)
        return (s, acc) if fold is not None else (s, Telemetry(*(torch.cat(p, dim=1) for p in zip(*tels))))

    def run_episode_blocked(self, s0: LoopState, inputs: TickInput):
        """run_episode over whole MPC periods from an MPC tick (the batched
        sweep's episode): each period one MPC stage on its first input, then
        mpc_every WBC stages (`_periods`). The same (final state, Telemetry
        [B, S, ...]). With sensor noise on the WBC ticks, and so the periods,
        run eagerly (`_noisy`): tick by tick through `step`."""
        self._blocked_tick(s0, inputs)
        if self._noisy():
            return self.run_episode(s0, inputs)
        return self._periods(s0, inputs)

    def run_episode_fold(self, s0: LoopState, inputs: TickInput, fold, acc0):
        """The blocked episode folding each tick's batched Telemetry [B, ...]
        into an accumulator, acc = fold(acc, tel), in place of stacking it:
        memory O(1) in the episode length. Returns (final state, acc). On the
        card the period graph is keyed by the fold, so a fold must keep its
        accumulator's structure, shapes and dtypes, as JAX's scan carry does
        (ValueError otherwise; the CPU runs it as it is), and a module-level
        fold keys every call to one graph. With sensor noise on, tick by
        tick, eagerly."""
        tick = self._blocked_tick(s0, inputs)
        if not self._noisy():
            return self._periods(s0, inputs, fold, acc0)
        acc = acc0

        def on_tick(tel):
            nonlocal acc
            acc = fold(acc, tel)

        return self._episode(s0, inputs, tick, on_tick), acc


def constant_inputs(S: int, joypad=(0.0, 0.0, 1.0, 0.0), dtype=torch.float32, *, batch: int = 1,
                    device="cuda") -> TickInput:
    """The same joystick on every tick and item, no push: TickInput [batch, S, ...]."""
    return TickInput(
        joypad=torch.tensor(joypad, dtype=dtype, device=device).expand(batch, S, 4),
        ext_force=torch.zeros(batch, S, 3, dtype=dtype, device=device),
        ext_torque=torch.zeros(batch, S, 3, dtype=dtype, device=device),
    )

"""The closed-loop walking controller, tick after tick, batch-first.

PyTorch counterpart of `cmw_tpu/runtime/loop.py` on the kinematic plant. One
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

The branches that need the rigid-body plant (`cfg.rigid`, cmw_tpu/sim/
rigid_body.py) are not ported: the controller refuses such a config, and
each place where JAX branches on it says which lines were left out.

The stages run inside `torch.profiler.record_function` spans: `mann`,
`mpc.solve` (the MPC stage's other work is `mpc.other`), `wbc.estimation`,
`wbc.ik` and `wbc.other` (plant, integrators, ZMP, swing feet, telemetry).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

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
from cmw_tpu_torch.mann.input_builder import build_desired_trajectory
from cmw_tpu_torch.mann.network import MANNWeights
from cmw_tpu_torch.runtime.config import WalkingConfig
from cmw_tpu_torch.sim import plant as P
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
    rb: None  # the rigid-body plant's state: None (not ported)
    com_mann: torch.Tensor  # [B, 3] MANN CoM reference at knot 0
    ang_mom_mann: torch.Tensor  # [B, 3] MANN angular-momentum reference
    hold: torch.Tensor  # [B] 1 while the gait clock is paused (rigid plant)
    hold_time: torch.Tensor  # [B]
    joypad_lp: torch.Tensor  # [B, 4] slew-limited joystick
    mann: StoredMann
    odo: legged_odom.OdometryState
    dyn: DynConfig


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


def _cast_weights(w: MANNWeights, device, dtype) -> MANNWeights:
    return MANNWeights(*(tuple(a.to(device, dtype) for a in f) if isinstance(f, tuple) else f.to(device, dtype)
                         for f in w))


class WalkingController:
    """Holds the static pieces: configs, robot model, MANN weights, device."""

    def __init__(self, cfg: WalkingConfig, model: kin.RobotModel, weights: MANNWeights, *, device="cuda"):
        if cfg.rigid is not None:
            raise NotImplementedError(
                "the rigid-body plant (cmw_tpu/sim/rigid_body.py) is not ported: run with cfg.rigid = None")
        self.cfg = cfg
        self.model = model
        self.weights = weights
        self.device = torch.device(device)
        self.solver = CentroidalMPCSolver(cfg.mpc)
        self.mass = model.total_mass
        self._polished = {}
        self._weights = {}

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

    def initial_state(self, B: int, q0=None, base_rot0=None, dtype=torch.float32) -> LoopState:
        """B identical items at the start of an episode
        (cmw_tpu/runtime/loop.py:335-505, kinematic plant). Default start: the
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
        # (the rigid plant's spawn and settling, loop.py:397-425, not ported)
        ff0 = fixed_foot.detect(plan, zeros, cfg.odom.initial_fixed_index)
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
            rb=None,
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

    def _mpc_stage(self, s: LoopState, inp: TickInput) -> LoopState:
        cfg, model = self.cfg, self.model
        mpc = cfg.mpc
        dtype, dev = s.x9.dtype, s.x9.device
        with record_function("mpc.other"):
            # 0. joystick slew limit; facing passes through (slew 0 disables)
            dmax = (s.dyn.joypad_slew * mpc.dt)[:, None]
            motion = s.joypad_lp[:, 0:2] + torch.minimum(torch.maximum(inp.joypad[:, 0:2] - s.joypad_lp[:, 0:2], -dmax),
                                                         dmax)
            motion = torch.where(s.dyn.joypad_slew[:, None] > 0, motion, inp.joypad[:, 0:2])
            joypad = torch.cat([motion, inp.joypad[:, 2:4]], dim=-1)
            moving = torch.linalg.vector_norm(joypad[:, 0:2], dim=-1) > cfg.stand_threshold
            # (0b, the rigid plant's gait-hold and speed governors, loop.py:533-721: not ported)
            hold = torch.zeros_like(s.hold)

            # 1. joystick -> desired base trajectory
            desired = build_desired_trajectory(joypad[:, 0:2], joypad[:, 2:4], cfg.input_builder)
            gen_state, stored = s.gen_state, s.mann
            # (1b, the rigid plant's generator re-sync, loop.py:734-755: not ported)

            # the adapters' input knots are slow_down_factor * gen dt apart in real time
            slow = cfg.gen.slow_down_factor
            gen_times = (torch.arange(cfg.gen.n_steps, dtype=dtype, device=dev) + 1.0) * (cfg.gen.dt * slow)
            knot_times = torch.arange(mpc.N, dtype=dtype, device=dev) * mpc.dt

            # 2. the generator advances when mannCallingTime of gait time has
            # passed since its last call (half a WBC tick of slack for the f32
            # clock), re-rooted mann_advance knots in; it runs for the whole
            # batch when any item calls, and each item keeps what it chose
            call_now = (s.t - stored.t0 >= cfg.mann_calling_time - 0.5 * cfg.wbc_dt) | (s.tick == 0)
            calls = call_now.cpu()  # the MPC tick's one read from the card
        gen_next = gen_state
        if bool(calls.any()):
            with record_function("mann"):
                _, outs, states = G.generate_with_states(cfg.gen, model, self._weights_as(s.x9), gen_state, desired)
                called_next = G.GeneratorState(*(a[:, cfg.mann_advance - 1] for a in states))
                # the contact timeline, prepended with the current state so that
                # the ongoing stance phase covers t, as a plan at absolute times
                flags = torch.cat([gen_state.contact[:, None], outs.contact], dim=1)
                pose_tl = torch.cat([gen_state.foot_pose_xy_yaw[:, None], outs.foot_pose_xy_yaw], dim=1)
                tl_times = s.t[:, None] + torch.cat([torch.zeros_like(gen_times[:1]), gen_times])
                foot_pos = torch.cat([pose_tl[..., 0:2], torch.zeros_like(pose_tl[..., 0:1])], dim=-1)
                mann_plan = C.plan_from_timeline(flags, tl_times, foot_pos, lie.rotz(pose_tl[..., 2]),
                                                 P=cfg.plan_phases)
                called = StoredMann(t0=s.t, com=outs.com, ang_mom=outs.ang_mom, joints0=outs.joints[:, 0],
                                    yaw0=outs.base_xy_yaw[:, 0, 2], plan=mann_plan)
                gen_next = _where(call_now, called_next, gen_state)
                stored = _where(call_now, called, stored)

        with record_function("mpc.other"):
            # 3. frequency adapters: the stored rollout at the MPC knots' absolute times
            rel_times = (s.t - stored.t0)[:, None] + knot_times
            com_ref, _ = linear_spline(gen_times, stored.com, rel_times)
            com_ref = torch.cat([com_ref[..., 0:2], s.com_z_ref[:, None, None].expand(-1, mpc.N, 1)], dim=-1)
            if cfg.ref_ramp > 0.0:
                # startup shaping: decay the initial reference mismatch
                decay = torch.exp(torch.tensor(-mpc.dt / cfg.ref_ramp, dtype=dtype))
                ref_off = torch.where((s.tick == 0)[:, None], s.x9[:, 0:3] - com_ref[:, 0], s.ref_off * decay)
                kdec = constant_like(tuple((decay ** torch.arange(mpc.N, dtype=dtype)).tolist()), s.x9)
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
            # (the rigid plant's hold freeze, contact reconciliation, early
            # activation and capture step, loop.py:886-993: not ported)

            # 6. solve from the integrated state, with the measured wrench
            # deadbanded as the WBC does (WholeBodyQPBlock.cpp:1018-1021)
            stage = C.mpc_stage_params(plan, s.t, mpc.T, mpc.dt, mpc.n_slots)
            ext_f, ext_tau = P.deadband_wrench(inp.ext_force, inp.ext_torque, self.mass)
            params = F.MPCParams(x0=s.x9, com_ref=com_ref, ang_mom_ref=L_ref, stage=stage, ext_force=ext_f,
                                 ext_torque=ext_tau)
        with record_function("mpc.solve"):
            sol = self.solver.solve(params, s.warm)
        with record_function("mpc.other"):
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
                com_mann=com_ref[:, 0], ang_mom_mann=L_ref[:, 0], hold=hold, hold_time=s.hold_time,
                joypad_lp=joypad, mann=stored,
            )

    # -- WBC stage (every tick) -------------------------------------------------

    def _wbc_stage(self, s: LoopState, inp: TickInput) -> tuple[LoopState, Telemetry]:
        cfg, model = self.cfg, self.model
        dt = cfg.wbc_dt
        pcfg = cfg.plant
        with record_function("wbc.other"):
            # (the rigid plant's dynamics step, loop.py:1063-1073: not ported)
            # kinematic plant: the actual joints track the PositionDirect
            # stream (servo lag), the encoders read them (with noise)
            ps = P.servo_step(pcfg, s.plant, s.q, dt)
            q_meas, _, ps = P.read_joints(pcfg, ps)

        with record_function("wbc.estimation"):
            # fixed foot + legged odometry on the measured joints
            # (the rigid plant's persistent anchor, loop.py:1087-1120, and
            # IMU fusion, :1123-1128: not ported)
            ff = fixed_foot.detect(s.plan, s.t, cfg.odom.initial_fixed_index)
            odo = legged_odom.OdometryState(ff.index, ff.rot, ff.pos)
            base_est_R, base_est_p = legged_odom.base_pose(model, odo, q_meas)

        with record_function("wbc.other"):
            # measured external wrench, deadbanded below 0.7 N
            ext_f, ext_tau = P.deadband_wrench(inp.ext_force, inp.ext_torque, self.mass)
            # centroidal integrator under the held MPC forces (+ measured push)
            x9 = rk4_step(lambda x: centroidal_dynamics(x, s.forces0, s.corner0, s.active0, ext_f, ext_tau), s.x9, dt)
            com_des3, dcom_des3 = x9[:, 0:3], x9[:, 3:6]
            # measured CoM: FK of the estimated robot (WholeBodyQPBlock.cpp:950-991)
            lR, lp = kin.fk(model, q_meas, base_est_R, base_est_p)
            com_meas = kin.com(model, lR, lp)
            # (the rigid plant's measured-state feedback, loop.py:1152-1177: not ported)
            # measured ZMP from the wrench sensors (evaluateZMP, :737-803)
            if pcfg.wrench_noise > 0.0:
                zmp_meas, ps = P.read_zmp(pcfg, ps, s.forces0, s.corner0, s.corner0.mean(dim=-2))
            else:
                zmp_meas = s.zmp_des
            v_cmd = com_zmp_control(dcom_des3[:, 0:2], com_des3[:, 0:2], s.zmp_des[:, 0:2], com_meas[:, 0:2],
                                    zmp_meas[:, 0:2], lie.yaw_of(s.base_rot), cfg.gains)
            com_xy_int = s.com_xy_int + dt * v_cmd
            feet = swing_foot.evaluate(s.plan, s.t, cfg.swing)
            # (the rigid plant's touchdown and lift gates, gait rush and
            # crouch, loop.py:1213-1327: not ported)
            # chest set-point: world-upright at the regularisation posture's
            # chest yaw (WholeBodyQPBlock.cpp:1219-1228)
            rfR, _ = kin.frame_poses(model, *kin.fk(model, s.q_reg, base_est_R, base_est_p))
            yaw_frame = "chest" if "chest" in model.frame_names else cfg.ik.chest_frame
            chest_rot_target = lie.rotz(lie.yaw_of(rfR[:, model.frame_index(yaw_frame)]))
            targets = IKTargets(
                foot_rot=feet.rot, foot_pos=feet.pos, foot_lin_vel=feet.lin_vel, foot_ang_vel=feet.ang_vel,
                com_xy=com_xy_int, dcom_xy=v_cmd, root_z=com_des3[:, 2] + s.root_z_off, droot_z=dcom_des3[:, 2],
                chest_rot=chest_rot_target, q_reg=s.q_reg,
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

        with record_function("wbc.ik"):
            # the IK's kinematic state: the measured (estimated) base with the
            # desired joints (WholeBodyQPBlock.cpp:962-967)
            nu = solve_ik(model, s.q, base_est_R, base_est_p, targets, cfg.ik)

        with record_function("wbc.other"):
            base_rot, base_pos = lie.integrate_mixed_velocity(s.base_rot, s.base_pos, nu[:, 0:3], nu[:, 3:6], dt)
            q = s.q + dt * nu[:, 6:]
            s2 = s._replace(
                # gait time pauses while s.hold is set (rigid plant only)
                t=s.t + dt * (1.0 - s.hold),
                tick=s.tick + 1,
                x9=x9, com_xy_int=com_xy_int, base_rot=base_rot, base_pos=base_pos, q=q, plant=ps, odo=odo,
            )
            stage_now = C.mpc_stage_params(s.plan, s.t, 1, cfg.mpc.dt, cfg.mpc.n_slots)
            nc = feet.in_contact.shape[-1]
            zero = torch.zeros_like(s.t)
            tel = Telemetry(
                com_mpc=com_des3, dcom_mpc=dcom_des3, ang_mom_mpc=x9[:, 6:9], com_meas=com_meas,
                com_ik_target=torch.cat([com_xy_int, com_des3[:, 2:3]], dim=-1), zmp_des=s.zmp_des,
                foot_pos_des=feet.pos, foot_contact=feet.in_contact, forces0=s.forces0, q=q, base_pos=base_pos,
                base_est_pos=base_est_p, fixed_foot_idx=ff.index.to(s.t.dtype), mpc_cost=s.mpc_cost,
                mpc_prim=s.mpc_prim, adjusted_step=stage_now.slot_pos_nom, zmp_meas=zmp_meas, vcom_zmp=v_cmd,
                dq_cmd=nu[:, 6:], joypad=inp.joypad, q_reg=s.q_reg, com_mann=s.com_mann,
                ang_mom_mann=s.ang_mom_mann, gait_hold=s.hold, gait_rush=zero,
                base_act_pos=base_pos, base_act_up=base_rot[:, 2, 2], base_act_lean=base_rot[:, 2, 0:2],
                # the kinematic plant has no contact forces (the rigid plant's initial state's zeros in JAX)
                fz_act=zero[:, None].expand(-1, nc), ft_act=zero[:, None, None].expand(-1, nc, 2),
                com_act=com_meas, q_act=q,
            )
            return s2, tel

    # -- the step + episode ------------------------------------------------------

    def step(self, s: LoopState, inp: TickInput, tick: int) -> tuple[LoopState, Telemetry]:
        """One WBC tick, preceded by the MPC stage when `tick` (a Python int,
        the same for every item: s.tick without reading the card) is a
        multiple of mpc_every."""
        if tick % self.cfg.mpc_every == 0:
            s = self._mpc_stage(s, inp)
        return self._wbc_stage(s, inp)

    def run_episode(self, s0: LoopState, inputs: TickInput):
        """inputs: TickInput [B, S, ...]. Returns (final state, Telemetry
        stacked [B, S, ...]). s0's tick is read from the state once."""
        tick = int(s0.tick[0])
        s, tels = s0, []
        for k in range(inputs.joypad.shape[1]):
            s, tel = self.step(s, TickInput(*(a[:, k] for a in inputs)), tick + k)
            tels.append(tel)
        return s, Telemetry(*(torch.stack(parts, dim=1) for parts in zip(*tels)))


def constant_inputs(S: int, joypad=(0.0, 0.0, 1.0, 0.0), dtype=torch.float32, *, batch: int = 1,
                    device="cuda") -> TickInput:
    """The same joystick on every tick and item, no push: TickInput [batch, S, ...]."""
    return TickInput(
        joypad=torch.tensor(joypad, dtype=dtype, device=device).expand(batch, S, 4),
        ext_force=torch.zeros(batch, S, 3, dtype=dtype, device=device),
        ext_torque=torch.zeros(batch, S, 3, dtype=dtype, device=device),
    )

"""Floating-base rigid-body dynamics plant, the Gazebo stand-in.

PyTorch counterpart of `cmw_tpu/sim/rigid_body.py`, batch-first: the full
Lagrangian dynamics of the 26-DoF + floating-base model, penalty ground
contact at the 8 sole corners, PID joint servos tracking the PositionDirect
stream, and velocity-implicit substeps. Every tensor carries a leading batch
axis [B]; the plant parameters (`RigidDynParams`) are tensors [B], one value
per item, so a batch can sweep them.

Generalized velocity nu = [v_base(world), w_base(world), qdot] in R^(6+nj)
(the mixed representation of core/kinematics). The equation of motion is
taken in a local exponential chart x around the current configuration
(p(x) = p + dx_p, R(x) = exp(hat(dx_th)) R, q(x) = q + dx_q):

    M(0) a = tau_gen - (d/dt M) nu + 1/2 d/dx (nu^T M(x) nu) - dV/dx + J_c^T f_c

with every configuration derivative taken by `torch.func` (`jvp` for the
d/dt M term along x' = nu, `grad` of the batch sum for the other two: the
items are independent, so the sum's gradient is each item's gradient). At
x = 0 the chart velocities coincide with nu, so the solved velocity
integrates directly (R <- exp(hat(w h)) R).

Contact: per-corner penalty normal force with friction anchors, the Coulomb
cap and the slip applied per foot; see `dynamics_step`. The two Cholesky
solves of a substep read nothing back from the card (`cholesky_ex` with no
status check, two triangular solves), so a control tick never waits for it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from cmw_tpu_torch.core import kinematics as kin
from cmw_tpu_torch.core import lie
from cmw_tpu_torch.core.centroidal import GRAVITY
from cmw_tpu_torch.core.consts import constant_like, eye_like
from cmw_tpu_torch.ops import rigid_step as K6
from cmw_tpu_torch.runtime import cache

SOLES = ("l_sole", "r_sole")


@dataclasses.dataclass(frozen=True)
class RigidBodyConfig:
    """Plant parameters (hashable); the rationale of each value is in the
    JAX package's docstring at the same name. Only `substeps` and
    `armature` are read by `dynamics_step`; the others start the per-item
    `RigidDynParams` in `initial_state`."""

    substeps: int = 2  # dynamics substeps per control tick (1 ms at 500 Hz)
    contact_kp: float = 6.0e4  # N/m per corner
    contact_kd: float = 3.0e3  # N s/m per corner
    contact_mu: float = 0.8  # plant-side friction (> the MPC's 0.33 margin)
    contact_ks: float = 1.0e5  # N/m tangential anchor spring (static friction)
    contact_kt: float = 6.0e2  # N s/m tangential damping
    anchor_relax_tau: float = 0.3  # s, anchor stress relaxation (0 disables)
    servo_kp: float = 3000.0  # N m/rad
    servo_kd: float = 150.0  # N m s/rad
    servo_ki: float = 4000.0  # N m/(rad s)
    servo_int_max: float = 90.0  # N m anti-windup clamp on the I term
    tau_max: float = 400.0  # N m actuator torque limit (P + I part)
    joint_damping: float = 0.5  # N m s/rad passive
    armature: float = 0.03  # kg m^2 rotor inertia added to M's joint diagonal


class RigidDynParams(NamedTuple):
    """The plant parameters the step reads, each a tensor [B]: override them
    per item with `state._replace(params=state.params._replace(...))`."""

    contact_kp: torch.Tensor
    contact_kd: torch.Tensor
    contact_mu: torch.Tensor
    contact_ks: torch.Tensor
    contact_kt: torch.Tensor
    anchor_relax_tau: torch.Tensor
    servo_kp: torch.Tensor
    servo_kd: torch.Tensor
    servo_ki: torch.Tensor
    servo_int_max: torch.Tensor
    tau_max: torch.Tensor
    joint_damping: torch.Tensor


def dyn_params(cfg: RigidBodyConfig, B: int, *, device="cuda", dtype=torch.float32) -> RigidDynParams:
    """cfg's values as RigidDynParams, B items each."""
    return RigidDynParams(*(torch.full((B,), float(getattr(cfg, f)), dtype=dtype, device=device)
                            for f in RigidDynParams._fields))


class RigidBodyState(NamedTuple):
    base_rot: torch.Tensor  # [B, 3, 3]
    base_pos: torch.Tensor  # [B, 3]
    q: torch.Tensor  # [B, nj]
    nu: torch.Tensor  # [B, 6 + nj] = [v_base(world), w_base(world), qdot]
    corner_forces: torch.Tensor  # [B, nc, ncor, 3] last contact forces (world, N)
    anchors: torch.Tensor  # [B, nc, ncor, 2] tangential friction anchors (world xy)
    servo_int: torch.Tensor  # [B, nj] integral term of the joint servos (N m)
    params: RigidDynParams  # per-item plant parameters


def default_corners(n_feet: int = 2) -> np.ndarray:
    """The plant's sole corner table [nc, 4, 3] in the sole frame (an
    ergoCub-class sole, wider than the MPC's +-0.01 m corner band)."""
    return np.array(
        [[[0.1, 0.05, 0.0], [0.1, -0.05, 0.0], [-0.08, -0.05, 0.0], [-0.08, 0.05, 0.0]]] * n_feet
    )


def corners(like: torch.Tensor, corners_local: np.ndarray | None = None, n_feet: int = 2) -> torch.Tensor:
    """The corner table [nc, ncor, 3] (default_corners unless given) as a
    shared constant in like's dtype and device."""
    table = default_corners(n_feet) if corners_local is None else np.asarray(corners_local, dtype=np.float64)
    return constant_like(tuple(tuple(tuple(c) for c in foot) for foot in table.tolist()), like)


def initial_state(model: kin.RobotModel, q0, base_rot, base_pos, cfg: RigidBodyConfig, sole_frames: tuple = SOLES,
                  corners_local: np.ndarray | None = None, *, device="cuda", dtype=torch.float32) -> RigidBodyState:
    """The plant at rest in pose (q0 [B, nj], base_rot [B, 3, 3], base_pos
    [B, 3]), its friction anchors at the corners' world positions and its
    parameters from `cfg` (the one source of RigidDynParams: the step reads
    them from the state, not from the cfg it is given)."""
    q0, base_rot, base_pos = (torch.as_tensor(a, dtype=dtype, device=device) for a in (q0, base_rot, base_pos))
    link_R, link_p = kin.fk(model, q0, base_rot, base_pos)
    pts, _ = corner_points_jacobians(model, link_R, link_p, sole_frames, corners(q0, corners_local, len(sole_frames)))
    B = q0.shape[0]
    return RigidBodyState(
        base_rot=base_rot,
        base_pos=base_pos,
        q=q0,
        nu=torch.zeros(B, 6 + model.nj, dtype=dtype, device=device),
        corner_forces=torch.zeros_like(pts),
        anchors=pts[..., 0:2],
        servo_int=torch.zeros_like(q0),
        params=dyn_params(cfg, B, device=device, dtype=dtype),
    )


# -- inertia ------------------------------------------------------------------


def mass_matrix(model: kin.RobotModel, link_R, link_p, armature: float = 0.0):
    """Joint-space inertia matrix M [B, 6+nj, 6+nj], the composite of the
    link CoM Jacobians."""
    mt = model.tensors(link_R.device, link_R.dtype)
    _, Jv, Jw = kin.link_com_jacobians(model, link_R, link_p)
    I_w = torch.einsum("...lab,lbc,...ldc->...lad", link_R, mt.link_inertia, link_R)
    M = torch.einsum("l,...lxi,...lxj->...ij", mt.link_mass, Jv, Jv) + torch.einsum(
        "...lxi,...lxy,...lyj->...ij", Jw, I_w, Jw)
    if armature > 0.0:
        M = M + armature * torch.diag(constant_like((0.0,) * 6 + (1.0,) * model.nj, M))
    return M


def _perturbed_fk(model, base_rot, base_pos, q, x):
    """FK at the exponential-chart point x [B, 6+nj] = [dp, dth, dq]."""
    R = lie.so3_exp(x[..., 3:6]) @ base_rot
    p = base_pos + x[..., 0:3]
    return kin.fk(model, q + x[..., 6:], R, p)


def bias_forces(cfg: RigidBodyConfig, model, base_rot, base_pos, q, nu):
    """Coriolis/centrifugal + gravity generalized forces [B, 6+nj] (RHS sign:
    M a = tau_gen - b)."""
    x0 = torch.zeros_like(nu)

    def M_of(x):
        return mass_matrix(model, *_perturbed_fk(model, base_rot, base_pos, q, x), cfg.armature)

    def Mnu_of(x):
        return (M_of(x) @ nu[..., None])[..., 0]

    # d/dt(M) nu = the jvp of (x -> M(x) nu) along x' = nu at x = 0
    _, Mdot_nu = torch.func.jvp(Mnu_of, (x0,), (nu,))
    quad_grad = torch.func.grad(lambda x: (0.5 * (nu * Mnu_of(x)).sum(dim=-1)).sum())(x0)

    def V_of(x):
        link_R, link_p = _perturbed_fk(model, base_rot, base_pos, q, x)
        mt = model.tensors(link_R.device, link_R.dtype)
        c_world = link_p + torch.einsum("...lij,lj->...li", link_R, mt.link_com)
        return (GRAVITY * (c_world[..., 2] * mt.link_mass).sum(dim=-1)).sum()

    g_gen = torch.func.grad(V_of)(x0)
    return Mdot_nu - quad_grad + g_gen


# -- contact ------------------------------------------------------------------


def corner_points_jacobians(model, link_R, link_p, sole_frames: tuple, corners_local):
    """World positions and point Jacobians of the sole corners
    (corners_local [nc, ncor, 3] in the sole frame).

    Returns (pts [B, nc, ncor, 3], J_pts [B, nc, ncor, 3, 6+nj])."""
    fR, fp = kin.frame_poses(model, link_R, link_p)
    pts, Js = [], []
    for i, fname in enumerate(sole_frames):
        fi = model.frame_index(fname)
        Jf = kin.frame_jacobian(model, link_R, link_p, fi)  # [B, 6, 6+nj]
        r = torch.einsum("...ab,jb->...ja", fR[..., fi, :, :], corners_local[i])  # sole -> corner, world
        pts.append(fp[..., fi, None, :] + r)
        # point Jacobian: Jv + w x r  =>  Jv - hat(r) Jw
        Js.append(Jf[..., None, 0:3, :] - lie.hat(r) @ Jf[..., None, 3:6, :])
    return torch.stack(pts, dim=-3), torch.stack(Js, dim=-4)


# -- step ---------------------------------------------------------------------


def _substep(cfg: RigidBodyConfig, model, s: RigidBodyState, q_cmd, h: float, sole_frames, cl, f_ext):
    """One velocity-implicit substep (the ODE ERP/CFM analog):

      (M + h J^T D J + h diag_j(d_srv)) nu+ = M nu + h (tau0 - b + J^T f0)

    with per-corner D = diag(kt + h ks, kt + h ks, kd + h kp) on the active
    corners and d_srv = servo_kd + joint_damping + h servo_kp; f0 and tau0
    are the forces and torques at the current state without their velocity
    terms (those act implicitly on the left)."""
    p_ = s.params
    link_R, link_p = kin.fk(model, s.q, s.base_rot, s.base_pos)
    M = mass_matrix(model, link_R, link_p, cfg.armature)
    b = bias_forces(cfg, model, s.base_rot, s.base_pos, s.q, s.nu)
    pts, J_pts = corner_points_jacobians(model, link_R, link_p, sole_frames, cl)

    def per_corner(v):  # [B] -> [B, 1, 1], against [B, nc, ncor]
        return v[:, None, None]

    pen = torch.clamp_min(-pts[..., 2], 0.0)
    active = (pen > 0.0).to(pen.dtype)
    xy = pts[..., 0:2]
    # friction anchors reset per foot (all its corners airborne), not per corner
    foot_down = (active.amax(dim=-1) > 0)[..., None, None]
    anchors0 = torch.where(foot_down, s.anchors, xy)
    # stress relaxation: the DC spring preload decays (tau == 0 disables)
    tau = per_corner(p_.anchor_relax_tau)[..., None]
    relax = torch.where(tau > 0.0, h / torch.clamp_min(tau, 1e-6), 0.0)
    anchors0 = anchors0 + (xy - anchors0) * relax

    # position-only force parts (the velocity terms are implicit)
    fz0 = per_corner(p_.contact_kp) * pen * active
    ft0 = -per_corner(p_.contact_ks)[..., None] * (xy - anchors0) * active[..., None]
    f0 = torch.cat([ft0, fz0[..., None]], dim=-1)

    err = q_cmd - s.q
    int_max, tau_max = p_.servo_int_max[:, None], p_.tau_max[:, None]
    s_int = torch.minimum(torch.maximum(s.servo_int + p_.servo_ki[:, None] * h * err, -int_max), int_max)
    # tau_max clips the explicit P + I part only (the implicit damping on the
    # left is not bounded), as Gazebo's patched PID saturates its output only
    tau_j0 = torch.minimum(torch.maximum(p_.servo_kp[:, None] * err + s_int, -tau_max), tau_max)
    d_srv = p_.servo_kd + p_.joint_damping + h * p_.servo_kp
    tau0 = torch.cat([f_ext, torch.zeros_like(f_ext), tau_j0], dim=-1)
    nj = model.nj
    M_srv = M + torch.diag_embed(h * torch.cat([torch.zeros_like(M[..., 0, 0:6]), d_srv[:, None].expand(-1, nj)],
                                               dim=-1))
    reg = 1e-9 * eye_like(6 + nj, M)
    Mnu = (M @ s.nu[..., None])[..., 0]

    def solve_with(act):
        """The implicit solve with the given corner active set."""
        d_t = per_corner(p_.contact_kt + h * p_.contact_ks) * act
        d_z = per_corner(p_.contact_kd + h * p_.contact_kp) * act
        D = torch.stack([d_t, d_t, d_z], dim=-1)  # [B, nc, ncor, 3]
        f0a = f0 * act[..., None]
        JDJ = torch.einsum("...ncxi,...ncx,...ncxj->...ij", J_pts, D, J_pts)
        rhs = Mnu + h * (tau0 - b + torch.einsum("...ncxk,...ncx->...k", J_pts, f0a))
        L, _ = torch.linalg.cholesky_ex(M_srv + h * JDJ + reg)
        y = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
        nu_n = torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
        v_new = torch.einsum("...ncxk,...k->...ncx", J_pts, nu_n)
        return nu_n, f0a - D * v_new

    # active-set pass: corners whose implicit normal force comes out negative
    # are separating this substep; drop them and solve once more
    _, fc_try = solve_with(active)
    active = active * (fc_try[..., 2] > 0.0).to(active.dtype)
    nu_n, fc = solve_with(active)
    fz = torch.clamp_min(fc[..., 2], 0.0) * active
    ft_raw = fc[..., 0:2]
    # Coulomb cap and stick-slip per foot (contact patch), not per corner; the
    # cap shapes the recorded forces and the anchor slip, so during a slip the
    # plant is stiffer than contact_mu for up to one substep (deliberate)
    ft_foot = ft_raw.sum(dim=-2)  # [B, nc, 2]
    cap_foot = p_.contact_mu[:, None] * fz.sum(dim=-1)  # [B, nc]
    ft_foot_norm = torch.linalg.vector_norm(ft_foot, dim=-1)
    scale = torch.clamp_max(cap_foot / torch.clamp_min(ft_foot_norm, 1e-9), 1.0)[..., None, None]
    ft = ft_raw * scale
    fc = torch.cat([ft, fz[..., None]], dim=-1)
    # sliding: translate all of the foot's anchors by the common slip, toward
    # the foot, so that the springs alone carry the capped force
    slip = (
        -(ft_foot / torch.clamp_min(ft_foot_norm, 1e-9)[..., None])[..., None, :]
        * ((1.0 - scale[..., 0]) * ft_foot_norm[..., None] / per_corner(p_.contact_ks) / 4.0)[..., None]
    )
    anchors = torch.where((active.amax(dim=-1) > 0)[..., None, None] & (scale < 1.0), anchors0 + slip, anchors0)

    base_pos = s.base_pos + h * nu_n[..., 0:3]
    base_rot = lie.so3_exp(h * nu_n[..., 3:6]) @ s.base_rot
    q = s.q + h * nu_n[..., 6:]
    return RigidBodyState(base_rot, base_pos, q, nu_n, fc, anchors, s_int, p_)


def dynamics_step(cfg: RigidBodyConfig, model: kin.RobotModel, state: RigidBodyState, q_cmd, dt: float,
                  sole_frames: tuple = SOLES, corners_local: np.ndarray | None = None, ext_force_base=None):
    """One control tick: cfg.substeps semi-implicit Euler substeps of dt /
    substeps. q_cmd [B, nj] is the servo set-point; ext_force_base [B, 3]
    (world N, at the base origin) a push. Of `cfg` only `substeps` and
    `armature` are read: the other parameters come from `state.params`.

    On the card the tick is one launch of the kernel K6 (`ops/rigid_step`,
    every substep of every item), inside the CUDA graph cached for (cfg's
    value, the model and corners_local by identity, dt, sole_frames, the
    inputs' shapes), the counterpart of JAX's substep scan
    (`cmw_tpu/sim/rigid_body.py:460`); on the CPU its twin `_dynamics_step`
    runs eagerly."""
    def tick(st, qc, ef):
        step = _dynamics_step if st.q.device.type == "cpu" else _kernel_step
        return step(cfg, model, st, qc, dt, sole_frames, corners_local, ef)

    owner = ("dynamics_step", cfg, cache.Ident(model), dt, sole_frames,
             None if corners_local is None else cache.Ident(corners_local))
    return cache.graphed(owner, tick, state, q_cmd, ext_force_base)


def _kernel_step(cfg, model, state, q_cmd, dt, sole_frames, corners_local, ext_force_base):
    """The tick as one launch of K6 (CUDA tensors; it raises on any other)."""
    cl = default_corners(len(sole_frames)) if corners_local is None else corners_local
    out = K6.rigid_step(model, sole_frames, cl, tuple(state[:-1]), torch.stack(tuple(state.params), dim=-1), q_cmd,
                        ext_force_base, substeps=cfg.substeps, h=dt / cfg.substeps, armature=cfg.armature)
    return RigidBodyState(*out, state.params)


def _dynamics_step(cfg, model, state, q_cmd, dt, sole_frames, corners_local, ext_force_base):
    """The plain twin of K6: the tick's substeps, eagerly."""
    cl = corners(state.q, corners_local, len(sole_frames))
    f_ext = torch.zeros_like(state.base_pos) if ext_force_base is None else ext_force_base
    h = dt / cfg.substeps
    for _ in range(cfg.substeps):
        state = _substep(cfg, model, state, q_cmd, h, sole_frames, cl, f_ext)
    return state


def reset_anchors(model: kin.RobotModel, state: RigidBodyState, sole_frames: tuple = SOLES,
                  corners_local: np.ndarray | None = None) -> RigidBodyState:
    """Re-anchor the tangential friction springs at the corners' current
    world positions, zeroing any spring preload (needed after `settle`:
    sinking onto the contact splays the soles and leaves each foot with a
    hidden inward pull that surfaces as a push when the other foot unloads)."""
    link_R, link_p = kin.fk(model, state.q, state.base_rot, state.base_pos)
    pts, _ = corner_points_jacobians(model, link_R, link_p, sole_frames,
                                     corners(state.q, corners_local, len(sole_frames)))
    return state._replace(anchors=pts[..., 0:2])


def settle(cfg: RigidBodyConfig, model: kin.RobotModel, state: RigidBodyState, q_cmd, dt: float, n_steps: int,
           sole_frames: tuple = SOLES, corners_local: np.ndarray | None = None) -> RigidBodyState:
    """Let the plant sink onto the penalty contact for n_steps control ticks
    while the servos hold q_cmd (the Gazebo 'spawn, then wait' phase): on the
    card n_steps replays of the tick's graph, as JAX's scan runs its body
    (`cmw_tpu/sim/rigid_body.py:521`)."""
    for _ in range(n_steps):
        state = dynamics_step(cfg, model, state, q_cmd, dt, sole_frames, corners_local)
    return state

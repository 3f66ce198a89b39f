"""Centroidal-MPC optimal-control formulation, batch-first.

PyTorch counterpart of `cmw_tpu/cmpc/formulation.py`; the math, the packing
of z and of the constraint rows, and the config are the same. Decision
variables z = [F, P]:

  F [T, nc, ncor, 3]  world-frame corner forces / mass, piecewise constant
  P [nc, K, 3]        contact positions for up to K phase slots per contact

Every function takes any number of leading batch dimensions (`[..., n]`),
so the solver calls them on `[B, ...]` tensors and `torch.func.vmap` can
call them per item. The rollout keeps the EXACT discrete map under
piecewise-constant forces (c+ = c + dt v + dt^2/2 a): a forward-Euler
rollout lets the closed loop drift up in CoM z and diverge under pushes.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from portbench.reference.core.centroidal import GRAVITY, cross, gravity_vector, unpack_state
from portbench.reference.core.consts import constant_like, device_constant
from portbench.reference.core.contacts import MPCStageParams


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Static solver configuration; fields and defaults as in cmw_tpu.

    `kkt_impl` "auto"/"riccati" is the Riccati x-update, the only branch of
    the benchmark's copy of the solver (`cmpc/solver.py`); the dense-path
    knobs (`inverse_impl`, `xupdate_impl`, `admm_impl`, `kkt_dtype`) are kept
    so that the configuration's value matches the program's, and are not
    read.
    """

    dt: float = 0.06
    horizon: float = 1.2
    n_contacts: int = 2
    n_corners: int = 4
    n_slots: int = 4
    mu: float = 0.33
    fz_max: float = 3.0 * GRAVITY
    f_box: float = 6.0 * GRAVITY
    corners: tuple = (
        ((0.08, 0.01, 0.0), (0.08, -0.01, 0.0), (-0.08, -0.01, 0.0), (-0.08, 0.01, 0.0)),
        ((0.08, 0.01, 0.0), (0.08, -0.01, 0.0), (-0.08, -0.01, 0.0), (-0.08, 0.01, 0.0)),
    )
    bbox_lower: tuple = ((-0.01, -0.00, 0.0), (-0.01, -0.05, 0.0))
    bbox_upper: tuple = ((0.01, 0.05, 0.0), (0.01, 0.00, 0.0))
    com_weight: tuple = (10.0, 10.0, 200.0)
    contact_position_weight: float = 2e3
    force_rate_weight: tuple = (10.0, 10.0, 10.0)
    angular_momentum_weight: float = 1e2
    force_symmetry_weight: float = 100.0
    sqp_iters: int = 2
    admm_iters: int = 24
    admm_rho: float = 10.0
    admm_rho_pos: float = 2e3
    admm_rho_eq: float = 1e4
    admm_sigma: float = 1e-6
    admm_alpha: float = 1.6
    levenberg: float = 1e-7
    line_search_alphas: tuple = (1.0, 0.85, 0.7, 0.55, 0.4, 0.25, 0.1, 0.0)
    merit_penalty: float = 1e3
    refactor_every_sqp: bool = False
    inverse_impl: str = "auto"
    admm_impl: str = "auto"
    kkt_dtype: str = "f32"
    kkt_f32_tail: int = 0
    xupdate_impl: str = "auto"
    kkt_impl: str = "auto"
    ns_iters: int = 12

    @property
    def T(self) -> int:
        return int(round(self.horizon / self.dt))

    @property
    def N(self) -> int:
        return self.T + 1

    @property
    def n_forces(self) -> int:
        return self.T * self.n_contacts * self.n_corners * 3

    @property
    def n_positions(self) -> int:
        return self.n_contacts * self.n_slots * 3

    @property
    def n_vars(self) -> int:
        return self.n_forces + self.n_positions

    @property
    def n_con(self) -> int:
        tcc = self.T * self.n_contacts * self.n_corners
        return tcc * 3 + tcc * 5 + self.n_positions

    def corners_arr(self, *, device=None, dtype=torch.float32):
        return device_constant(_tuples(self.corners), torch.device(device or "cpu"), dtype)

    def cone_matrix(self, *, device=None, dtype=torch.float32):
        """D [5,3]: local-frame friction pyramid + fz row."""
        mu = self.mu
        D = ((1.0, 0.0, -mu), (-1.0, 0.0, -mu), (0.0, 1.0, -mu), (0.0, -1.0, -mu), (0.0, 0.0, 1.0))
        return device_constant(D, torch.device(device or "cpu"), dtype)


def ergocub_mpc_config(**overrides) -> MPCConfig:
    """The ergoCubGazeboV1 preset (the defaults of MPCConfig)."""
    return MPCConfig(**overrides)


def no_adjust(cfg: MPCConfig, eps: float = 1e-4) -> MPCConfig:
    """Disable online step adjustment: shrink the contact-location boxes to
    ~zero so footsteps stay at their nominal poses."""
    nc = cfg.n_contacts
    return dataclasses.replace(
        cfg,
        bbox_lower=tuple((-eps, -eps, 0.0) for _ in range(nc)),
        bbox_upper=tuple((eps, eps, 0.0) for _ in range(nc)),
    )


class MPCParams(NamedTuple):
    """Per-solve parameters; each field with leading batch dims [...]."""

    x0: torch.Tensor  # [..., 9] initial (com, vcom, ang_mom)
    com_ref: torch.Tensor  # [..., N, 3]
    ang_mom_ref: torch.Tensor  # [..., N, 3]
    stage: MPCStageParams
    ext_force: torch.Tensor  # [..., 3] external force / mass, world
    ext_torque: torch.Tensor  # [..., 3] external torque / mass about CoM


def _tuples(values):
    """A config's nested sequence of numbers as nested tuples (a constant's key)."""
    return tuple(_tuples(v) for v in values) if isinstance(values, (tuple, list)) else values


def _like(x, values):
    return constant_like(_tuples(values), x)


# --- decision-vector packing -------------------------------------------------


def pack_z(cfg: MPCConfig, forces, positions):
    lead = forces.shape[:-4]
    return torch.cat([forces.reshape(lead + (-1,)), positions.reshape(lead + (-1,))], dim=-1)


def unpack_z(cfg: MPCConfig, z):
    nf = cfg.n_forces
    lead = z.shape[:-1]
    F = z[..., :nf].reshape(lead + (cfg.T, cfg.n_contacts, cfg.n_corners, 3))
    P = z[..., nf:].reshape(lead + (cfg.n_contacts, cfg.n_slots, 3))
    return F, P


# --- rollout + residuals -----------------------------------------------------


def interval_contact_geometry(cfg: MPCConfig, stage: MPCStageParams, positions):
    """Per-interval contact pose and world corner positions.

    positions [..., nc, K, 3]. Returns pos_k [..., T, nc, 3],
    rot_k [..., T, nc, 3, 3], corner_k [..., T, nc, ncor, 3].
    """
    pos_k = torch.einsum("...its,...isx->...tix", stage.slot_onehot, positions)
    rot_k = torch.einsum("...its,...isxy->...tixy", stage.slot_onehot, stage.slot_rot)
    corners = cfg.corners_arr(device=positions.device, dtype=positions.dtype)
    corner_k = pos_k[..., None, :] + torch.einsum("...tiab,ijb->...tija", rot_k, corners)
    return pos_k, rot_k, corner_k


def interval_step(cfg: MPCConfig, params: MPCParams, x, f_k, c_k, a_k):
    """One exact discrete interval under the held corner forces f_k
    [..., nc, ncor, 3] at world corners c_k, activation a_k [..., nc].
    The single source of the discrete map: `rollout` loops over it and the
    Riccati x-update linearises it per stage. Reads params.ext_force and
    params.ext_torque only."""
    dt = cfg.dt
    com, vcom, L = x[..., 0:3], x[..., 3:6], x[..., 6:9]
    f = f_k * a_k[..., :, None, None]
    f_tot = f.sum(dim=(-3, -2))
    acc = gravity_vector(vcom) + f_tot + params.ext_force
    com_n = com + dt * vcom + 0.5 * dt * dt * acc
    vcom_n = vcom + dt * acc
    # integral over the interval of sum (c - com(t)) x f, com(t) = com + v t + a t^2 / 2
    dL0 = cross(c_k - com[..., None, None, :], f).sum(dim=(-3, -2))
    sweep = 0.5 * dt * dt * vcom + (dt**3 / 6.0) * acc
    L_n = L + dt * (dL0 + params.ext_torque) - cross(sweep, f_tot)
    return torch.cat([com_n, vcom_n, L_n], dim=-1)


def rollout(cfg: MPCConfig, params: MPCParams, forces, positions):
    """Exact discrete rollout under piecewise-constant corner forces.
    Returns X [..., N, 9]."""
    _, _, corner_k = interval_contact_geometry(cfg, params.stage, positions)
    active_k = params.stage.active.transpose(-1, -2)  # [..., T, nc]
    xs = [params.x0]
    for t in range(cfg.T):
        xs.append(
            interval_step(
                cfg, params, xs[-1], forces[..., t, :, :, :], corner_k[..., t, :, :, :], active_k[..., t, :]
            )
        )
    return torch.stack(xs, dim=-2)


def residuals(cfg: MPCConfig, params: MPCParams, z):
    """Stacked weighted residual vector r(z) [..., nr]; cost = 1/2 |r|^2."""
    F, P = unpack_z(cfg, z)
    X = rollout(cfg, params, F, P)
    com, _, L = unpack_state(X)
    lead = z.shape[:-1]

    w_com = torch.sqrt(_like(z, cfg.com_weight))
    w_L = torch.sqrt(_like(z, cfg.angular_momentum_weight))
    w_pos = torch.sqrt(_like(z, cfg.contact_position_weight))
    w_rate = torch.sqrt(_like(z, cfg.force_rate_weight))
    w_sym = torch.sqrt(_like(z, cfg.force_symmetry_weight))

    r_com = (w_com * (com[..., 1:, :] - params.com_ref[..., 1:, :])).reshape(lead + (-1,))
    r_L = (w_L * (L[..., 1:, :] - params.ang_mom_ref[..., 1:, :])).reshape(lead + (-1,))

    adj = (params.stage.slot_valid * params.stage.slot_adjustable)[..., None]
    r_pos = (w_pos * adj * (P - params.stage.slot_pos_nom)).reshape(lead + (-1,))

    r_rate = (w_rate * (F[..., 1:, :, :, :] - F[..., :-1, :, :, :])).reshape(lead + (-1,))

    mean_f = F.mean(dim=-2, keepdim=True)
    act = params.stage.active.transpose(-1, -2)[..., None, None]  # [..., T, nc, 1, 1]
    r_sym = (w_sym * act * (F - mean_f)).reshape(lead + (-1,))

    return torch.cat([r_com, r_L, r_pos, r_rate, r_sym], dim=-1)


# --- linear constraint operator ---------------------------------------------


class ConstraintOp(NamedTuple):
    """Stage-dependent coefficients of the constraint operator A, built once
    per solve by `constraint_op`."""

    cone_coeff: torch.Tensor  # [..., T, nc, 5, 3]: D @ rot_k^T per interval
    slot_rot: torch.Tensor  # [..., nc, K, 3, 3]


def _rot_k(cfg: MPCConfig, stage: MPCStageParams):
    return torch.einsum("...its,...isxy->...tixy", stage.slot_onehot, stage.slot_rot)


def _cone_coeff(cfg: MPCConfig, stage: MPCStageParams, dtype):
    rot_k = _rot_k(cfg, stage).to(dtype)
    D = cfg.cone_matrix(device=rot_k.device, dtype=dtype)
    # cone row d of the local force = sum_a D[d,a] (rot_k^T f)[a]
    return torch.einsum("da,...tica->...tidc", D, rot_k)


def constraint_op(cfg: MPCConfig, stage: MPCStageParams, dtype=torch.float32) -> ConstraintOp:
    return ConstraintOp(cone_coeff=_cone_coeff(cfg, stage, dtype), slot_rot=stage.slot_rot.to(dtype))


def op_matvec(cfg: MPCConfig, op: ConstraintOp, z):
    """A z: [..., n] -> [..., m]. Blocks: force identity; friction cone
    (contact frame); contact position in the contact frame."""
    F, P = unpack_z(cfg, z)
    lead = z.shape[:-1]
    # [t,i,j,d] = sum_c coeff[t,i,d,c] F[t,i,j,c]
    cone = (op.cone_coeff[..., :, :, None, :, :] * F[..., :, :, :, None, :]).sum(dim=-1)
    # [i,s,a] = sum_b rot[i,s,b,a] P[i,s,b]
    p_loc = (op.slot_rot * P[..., :, :, :, None]).sum(dim=-2)
    return torch.cat(
        [F.reshape(lead + (-1,)), cone.reshape(lead + (-1,)), p_loc.reshape(lead + (-1,))], dim=-1
    )


def op_rmatvec(cfg: MPCConfig, op: ConstraintOp, y):
    """A^T y: [..., m] -> [..., n]."""
    T, nc, ncor, K = cfg.T, cfg.n_contacts, cfg.n_corners, cfg.n_slots
    tcc3 = cfg.n_forces
    tcc5 = T * nc * ncor * 5
    lead = y.shape[:-1]
    y1 = y[..., :tcc3].reshape(lead + (T, nc, ncor, 3))
    y2 = y[..., tcc3:tcc3 + tcc5].reshape(lead + (T, nc, ncor, 5))
    y3 = y[..., tcc3 + tcc5:].reshape(lead + (nc, K, 3))
    # [t,i,j,c] = sum_d y2[t,i,j,d] coeff[t,i,d,c]
    gF = y1 + (y2[..., :, None] * op.cone_coeff[..., :, :, None, :, :]).sum(dim=-2)
    # [i,s,b] = sum_a y3[i,s,a] rot[i,s,b,a]
    gP = (op.slot_rot * y3[..., :, :, None, :]).sum(dim=-1)
    return torch.cat([gF.reshape(lead + (-1,)), gP.reshape(lead + (-1,))], dim=-1)


def constraint_matvec(cfg: MPCConfig, stage: MPCStageParams, z):
    """A z (one-shot convenience; hot paths precompute `constraint_op`)."""
    return op_matvec(cfg, constraint_op(cfg, stage, z.dtype), z)


def constraint_rmatvec(cfg: MPCConfig, stage: MPCStageParams, y):
    """A^T y (one-shot convenience; hot paths precompute `constraint_op`)."""
    return op_rmatvec(cfg, constraint_op(cfg, stage, y.dtype), y)


def constraint_bounds(cfg: MPCConfig, stage: MPCStageParams, dtype=torch.float32):
    """(l, u, rho_vec), each [..., m], for the three constraint blocks."""
    T, nc, ncor, K = cfg.T, cfg.n_contacts, cfg.n_corners, cfg.n_slots
    device = stage.active.device
    lead = stage.active.shape[:-2]
    act = stage.active.transpose(-1, -2)[..., None, None] > 0  # [..., T, nc, 1, 1]
    shape1 = lead + (T, nc, ncor, 3)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    def flat(x):
        return x.reshape(lead + (-1,))

    # block 1: force identity; active: generous box, inactive: pinned to 0
    zero = full((), 0.0)
    l1 = torch.where(act, full((), -cfg.f_box), zero).expand(shape1)
    u1 = torch.where(act, full((), cfg.f_box), zero).expand(shape1)
    rho1 = torch.where(act, full((), cfg.admm_rho), full((), cfg.admm_rho_eq)).expand(shape1)

    # block 2: cone rows, constant (satisfied with equality at f = 0)
    shape2 = lead + (T, nc, ncor, 5)
    l2 = device_constant((-1e20, -1e20, -1e20, -1e20, 0.0), device, dtype).expand(shape2)
    u2 = device_constant((0.0, 0.0, 0.0, 0.0, cfg.fz_max), device, dtype).expand(shape2)
    rho2 = full(shape2, cfg.admm_rho)

    # block 3: position boxes in the contact frame around nominal
    p_nom_loc = torch.einsum("...isba,...isb->...isa", stage.slot_rot, stage.slot_pos_nom).to(dtype)
    bl = device_constant(_tuples(cfg.bbox_lower), device, dtype)[:, None, :]
    bu = device_constant(_tuples(cfg.bbox_upper), device, dtype)[:, None, :]
    adj = (stage.slot_valid * stage.slot_adjustable)[..., None] > 0
    l3 = p_nom_loc + torch.where(adj, bl, zero)
    u3 = p_nom_loc + torch.where(adj, bu, zero)
    rho3 = torch.where(adj, full((), cfg.admm_rho_pos), full((), cfg.admm_rho_eq)).expand(lead + (nc, K, 3))

    l = torch.cat([flat(l1), flat(l2), flat(l3)], dim=-1)
    u = torch.cat([flat(u1), flat(u2), flat(u3)], dim=-1)
    rho = torch.cat([flat(rho1), flat(rho2), flat(rho3)], dim=-1)
    return l, u, rho


def ata_blocks(cfg: MPCConfig, stage: MPCStageParams, rho, dtype=torch.float32):
    """The 3x3 blocks of A^T diag(rho) A: (blk_force [..., T, nc, ncor, 3, 3],
    blk_pos [..., nc, K, 3, 3])."""
    T, nc, ncor, K = cfg.T, cfg.n_contacts, cfg.n_corners, cfg.n_slots
    tcc3 = cfg.n_forces
    tcc5 = T * nc * ncor * 5
    lead = rho.shape[:-1]
    rho1 = rho[..., :tcc3].reshape(lead + (T, nc, ncor, 3))
    rho2 = rho[..., tcc3:tcc3 + tcc5].reshape(lead + (T, nc, ncor, 5))
    rho3 = rho[..., tcc3 + tcc5:].reshape(lead + (nc, K, 3))
    C = _cone_coeff(cfg, stage, dtype)  # [..., T, nc, 5, 3], the same for every corner
    eye = torch.eye(3, dtype=dtype, device=rho.device)
    blk_cone = torch.einsum("...tijd,...tidc,...tide->...tijce", rho2, C, C)
    blk_force = blk_cone + rho1[..., None] * eye
    blk_pos = rho3[..., None] * eye
    return blk_force, blk_pos


def _blockdiag3(blocks, n):
    """[..., nblk, 3, 3] -> dense [..., n, n] with the blocks on the diagonal."""
    lead = blocks.shape[:-3]
    nblk = blocks.shape[-3]
    idx = torch.arange(nblk, device=blocks.device)
    rows = (idx[:, None, None] * 3 + torch.arange(3, device=blocks.device)[None, :, None]).expand(nblk, 3, 3)
    cols = (idx[:, None, None] * 3 + torch.arange(3, device=blocks.device)[None, None, :]).expand(nblk, 3, 3)
    M = torch.zeros(lead + (n * n,), dtype=blocks.dtype, device=blocks.device)
    M[..., (rows * n + cols).reshape(-1)] = blocks.reshape(lead + (-1,))
    return M.reshape(lead + (n, n))


def nominal_force_guess(cfg: MPCConfig, stage: MPCStageParams, dtype=torch.float32):
    """Gravity-supporting initial forces: GRAVITY shared among active corners."""
    act = stage.active.transpose(-1, -2)[..., None].to(dtype)  # [..., T, nc, 1]
    n_active = torch.clamp(act.sum(dim=(-2, -1), keepdim=True) * cfg.n_corners, min=1.0)
    fz = (GRAVITY * act / n_active).expand(act.shape[:-1] + (cfg.n_corners,))  # [..., T, nc, ncor]
    zero = torch.zeros_like(fz)
    return torch.stack([zero, zero, fz], dim=-1)

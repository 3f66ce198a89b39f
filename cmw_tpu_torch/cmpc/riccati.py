"""Structure-exploiting ADMM x-update: parametric Riccati, batch-first.

PyTorch counterpart of `cmw_tpu/cmpc/riccati.py`, in plain PyTorch. The
x-update applies M^-1 with M = H + sigma I + A^T rho A, where
H = J^T J + levenberg I is the Gauss-Newton Hessian of the condensed
formulation. Every residual row is linear in the sensitivity states y, the
forces F and the contact positions P, and y obeys

    y_{t+1} = A_t y_t + B_t F_t + C_t P,     y_0 = 0

with the per-stage Jacobians of `formulation.interval_step`. So M is the
condensed Hessian of a time-structured LQR with augmented state
s_t = [y_t (9), F_{t-1} (nu)] (the force-rate coupling), control u_t = F_t
and a global parameter P. A P-carrying backward Riccati recursion factors M
once per solve (`riccati_factor`); each ADMM iteration then solves M x = rhs
with one backward and one forward vector sweep over the T stages
(`riccati_apply`). The apply equals the dense inverse to f64 round-off
(tests/test_torch_riccati.py). On the card the solver runs the whole ADMM
loop, these sweeps included, as one kernel launch (`ops/riccati_admm.py`);
`riccati_apply` is the x-update of that kernel's twin, the CPU's path.

The augmented-state size is ns = 9 + nu, computed from the config (it is
33 at the production config), and the gain shapes are checked.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from cmw_tpu_torch.cmpc import formulation as F
from cmw_tpu_torch.cmpc.formulation import _blockdiag3
from cmw_tpu_torch.core.consts import device_constant, eye_like


class RiccatiFactor(NamedTuple):
    """Per-stage gains and the Schur piece of the factored KKT operator.

    Shapes: B items, T stages, ns = 9 + nu augmented state, nu controls,
    np_ contact-position parameters. D1 is symmetric, so the backward sweep
    reads K' and KP' in place of L_su D1 and L_uP' D1."""

    A: torch.Tensor  # [B, T, 9, 9]    dX'/dX
    B: torch.Tensor  # [B, T, 9, nu]   dX'/dF
    C: torch.Tensor  # [B, T, 9, np_]  dX'/dP
    K: torch.Tensor  # [B, T, nu, ns]  feedback gain (H_u^-1 L_su')
    KP: torch.Tensor  # [B, T, nu, np_] P-feedforward gain (H_u^-1 L_uP)
    D1: torch.Tensor  # [B, T, nu, nu]  H_u^-1
    Sinv: torch.Tensor  # [B, np_, np_]  (Pi_0 + H_pp)^-1


def _mv(A, x):
    return torch.matmul(A, x[..., None])[..., 0]


def _mtv(A, x):
    return torch.matmul(A.transpose(-1, -2), x[..., None])[..., 0]


def _t(A):
    return A.transpose(-1, -2)


def _spd_inverse_small(M):
    """Gauss-Jordan inverse of small SPD matrices [..., n, n], no pivoting
    (valid for SPD: every pivot is a Schur complement, hence positive)."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device).expand(M.shape)
    A = torch.cat([M, eye], dim=-1)
    for j in range(n):
        row = A[..., j, :] / A[..., j, j, None]
        A = A - A[..., :, j, None] * row[..., None, :]
        A[..., j, :] = row
    return A[..., :, n:]


def _stage_jacobians(cfg: F.MPCConfig, params: F.MPCParams, z_lin):
    """Per-stage Jacobians (A_t, B_t, C_t) of `formulation.interval_step` at
    the rollout states of z_lin [B, n], by forward-mode autodiff."""
    nc, ncor, K, T = cfg.n_contacts, cfg.n_corners, cfg.n_slots, cfg.T
    Bsz = z_lin.shape[0]
    F_lin, P_lin = F.unpack_z(cfg, z_lin)
    X = F.rollout(cfg, params, F_lin, P_lin)  # [B, N, 9]
    stage = params.stage
    corners = cfg.corners_arr(device=z_lin.device, dtype=z_lin.dtype)

    def step_zp(x, f_flat, p_flat, soh_t, a_t, slot_rot, ext_force, ext_torque):
        P = p_flat.reshape(nc, K, 3)
        f_k = f_flat.reshape(nc, ncor, 3)
        rot = torch.einsum("is,isxy->ixy", soh_t, slot_rot)
        pos = torch.einsum("is,isx->ix", soh_t, P)
        c_k = pos[:, None, :] + torch.einsum("iab,ijb->ija", rot, corners)
        ext = F.MPCParams(None, None, None, None, ext_force, ext_torque)
        return F.interval_step(cfg, ext, x, f_k, c_k, a_t)

    def per_stage(a):
        """[B, ...] -> [B * T, ...] (the same value at every stage)."""
        return a.repeat_interleave(T, dim=0)

    jac = vmap(jacfwd(step_zp, argnums=(0, 1, 2)))
    args = (
        X[:, :-1].reshape(Bsz * T, 9),
        F_lin.reshape(Bsz * T, nc * ncor * 3),
        per_stage(P_lin.reshape(Bsz, -1)),
        stage.slot_onehot.transpose(1, 2).reshape(Bsz * T, nc, K),
        stage.active.transpose(1, 2).reshape(Bsz * T, nc),
        per_stage(stage.slot_rot),
        per_stage(params.ext_force),
        per_stage(params.ext_torque),
    )
    # forward-mode duals need inputs that own their memory (no expanded views)
    A, Bm, C = jac(*(a.contiguous() for a in args))
    return (
        A.reshape(Bsz, T, 9, 9),
        Bm.reshape(Bsz, T, 9, -1),
        C.reshape(Bsz, T, 9, -1),
    )


def _cost_blocks(cfg: F.MPCConfig, stage, rho, lam_sigma, dtype):
    """Stage cost blocks matching H + sigma I + A^T rho A exactly.

    Returns (q_track [9], wr2 [nu], R [B, T, nu, nu], Hpp [B, np_, np_])."""
    T, nc, ncor, K = cfg.T, cfg.n_contacts, cfg.n_corners, cfg.n_slots
    nu = nc * ncor * 3
    np_ = nc * K * 3
    device = rho.device
    Bsz = rho.shape[0]

    q_track = torch.cat(
        [
            device_constant(tuple(cfg.com_weight), device, dtype),
            torch.zeros(3, dtype=dtype, device=device),
            torch.full((3,), cfg.angular_momentum_weight, dtype=dtype, device=device),
        ]
    )
    wr2 = device_constant(tuple(cfg.force_rate_weight), device, dtype).repeat(nc * ncor)

    # symmetry: per (t, contact, axis) the 4 corner coords carry
    # w_sym^2 act (I - 11'/4), a projection
    eye_c = np.eye(ncor) - np.ones((ncor, ncor)) / ncor
    sym_blk = np.kron(np.kron(np.eye(nc), eye_c), np.eye(3))
    sym_blk = device_constant(tuple(map(tuple, sym_blk.tolist())), device, dtype)
    act_coord = stage.active.transpose(-1, -2).repeat_interleave(ncor * 3, dim=-1).to(dtype)  # [B, T, nu]
    R_sym = cfg.force_symmetry_weight * act_coord[..., :, None] * sym_blk * act_coord[..., None, :]

    blk_force, blk_pos = F.ata_blocks(cfg, stage, rho, dtype)
    ata_f = _blockdiag3(blk_force.reshape(Bsz, T, -1, 3, 3), nu)
    eye_u = torch.eye(nu, dtype=dtype, device=device)
    R = R_sym + ata_f + lam_sigma * eye_u
    # the rate cost on u_t (vs F_prev in the state) applies for t >= 1
    t_ge1 = (torch.arange(T, device=device) >= 1).to(dtype)[:, None, None]
    R = R + t_ge1 * torch.diag(wr2)

    adj = (stage.slot_valid * stage.slot_adjustable).reshape(Bsz, -1).repeat_interleave(3, dim=-1)
    Hpp = (
        torch.diag_embed(cfg.contact_position_weight * adj.to(dtype))
        + lam_sigma * torch.eye(np_, dtype=dtype, device=device)
        + _blockdiag3(blk_pos.reshape(Bsz, -1, 3, 3), np_)
    )
    return q_track, wr2, R, Hpp


def riccati_factor(
    cfg: F.MPCConfig, params: F.MPCParams, z_lin, rho, lam_sigma: float
) -> RiccatiFactor:
    """Factor M = H + sigma I + A^T rho A at z_lin [B, n] by the parametric
    backward Riccati recursion (once per SQP linearisation)."""
    dtype, device = z_lin.dtype, z_lin.device
    T = cfg.T
    nu = cfg.n_contacts * cfg.n_corners * 3
    np_ = cfg.n_contacts * cfg.n_slots * 3
    ns = 9 + nu
    Bsz = z_lin.shape[0]

    A, Bm, C = _stage_jacobians(cfg, params, z_lin)
    q_track, wr2, R, Hpp = _cost_blocks(cfg, params.stage, rho, lam_sigma, dtype)

    def zeros(*shape):
        return torch.zeros((Bsz,) + shape, dtype=dtype, device=device)

    diag_q = torch.diag(q_track)
    diag_w = torch.diag(wr2).expand(Bsz, nu, nu)
    # terminal: tracking on y_T only
    Phi_yy, Phi_yf, Phi_ff = diag_q.expand(Bsz, 9, 9), zeros(9, nu), zeros(nu, nu)
    Gam_y, Gam_f, Pi = zeros(9, np_), zeros(nu, np_), zeros(np_, np_)

    Ks, KPs, D1s = [None] * T, [None] * T, [None] * T
    for t in reversed(range(T)):
        At, Bt, Ct, Rt = A[:, t], Bm[:, t], C[:, t], R[:, t]
        t_ge1 = 1.0 if t >= 1 else 0.0
        # G = [[B],[I]]; F = [[A, 0],[0, 0]]; E = [[C],[0]]
        G3 = torch.cat([Bt, At, Ct], dim=-1)  # [B, 9, nu + 9 + np_]
        P3 = Phi_yy @ G3
        PyyB, PyyA, PyyC0 = P3[..., :nu], P3[..., nu:nu + 9], P3[..., nu + 9:]
        X1 = PyyB + Phi_yf  # [B, 9, nu]
        X2 = PyyC0 + Gam_y  # [B, 9, np_]
        Q = _t(G3) @ torch.cat([X1, X2, PyyA, PyyC0], dim=-1)
        c1, c2, c3 = nu, nu + np_, nu + np_ + 9
        BtX1, BtX2 = Q[:, :nu, :c1], Q[:, :nu, c1:c2]
        AtX1, AtX2, AtPyyA = Q[:, nu:nu + 9, :c1], Q[:, nu:nu + 9, c1:c2], Q[:, nu:nu + 9, c2:c3]
        CtX2, CtPyyC0 = Q[:, nu + 9:, c1:c2], Q[:, nu + 9:, c3:]
        Y = _t(Phi_yf) @ G3
        YB, YC = Y[..., :nu], Y[..., nu + 9:]

        Hu = Rt + BtX1 + YB + Phi_ff
        Hu = 0.5 * (Hu + _t(Hu))
        Lsu = torch.cat([AtX1, -t_ge1 * diag_w], dim=-2)  # [B, ns, nu]
        LuP = BtX2 + YC + Gam_f  # [B, nu, np_]
        D1 = _spd_inverse_small(Hu)
        D1 = 0.5 * (D1 + _t(D1))
        S = D1 @ torch.cat([_t(Lsu), LuP], dim=-1)
        K, KP = S[..., :ns], S[..., ns:]
        C2 = Lsu @ torch.cat([K, KP], dim=-1)  # [B, ns, ns + np_]
        corr, LsuKP = C2[..., :ns], C2[..., ns:]

        Phi_yy = t_ge1 * diag_q + AtPyyA - corr[:, :9, :9]
        Phi_yf = -corr[:, :9, 9:]
        Phi_ff = t_ge1 * diag_w - corr[:, 9:, 9:]
        Phi_yy = 0.5 * (Phi_yy + _t(Phi_yy))
        Phi_ff = 0.5 * (Phi_ff + _t(Phi_ff))
        Gam_y = AtX2 - LsuKP[:, :9]
        Gam_f = -LsuKP[:, 9:]
        # Pi' + C'Phi_yy C + C'Gam_y + Gam_y'C - LuP' D1 LuP
        Pi = Pi + CtX2 + _t(CtX2 - CtPyyC0) - _t(LuP) @ KP
        Pi = 0.5 * (Pi + _t(Pi))
        Ks[t], KPs[t], D1s[t] = K, KP, D1

    S = Pi + Hpp
    S = 0.5 * (S + _t(S))
    # cholesky_ex reads nothing back from the card (cholesky checks its
    # status there); a matrix that is not SPD gives NaN, as JAX's Cholesky does
    Ls, _ = torch.linalg.cholesky_ex(S)
    Sinv = torch.cholesky_solve(eye_like(np_, S).expand(Bsz, np_, np_), Ls)
    fac = RiccatiFactor(
        A=A, B=Bm, C=C, K=torch.stack(Ks, dim=1), KP=torch.stack(KPs, dim=1), D1=torch.stack(D1s, dim=1), Sinv=Sinv
    )
    expected = {
        "A": (9, 9), "B": (9, nu), "C": (9, np_), "K": (nu, ns), "KP": (nu, np_), "D1": (nu, nu),
    }
    for name, shape in expected.items():
        got = getattr(fac, name).shape
        if got != (Bsz, T) + shape:
            raise AssertionError(f"riccati_factor: {name} has shape {tuple(got)}, expected {(Bsz, T) + shape}")
    return fac


def riccati_apply(cfg: F.MPCConfig, fac: RiccatiFactor, rhs):
    """Solve M x = rhs [B, n] with the factored operator: one backward
    vector sweep, the P solve, one forward sweep."""
    T = cfg.T
    nu = fac.K.shape[-2]
    ns = fac.K.shape[-1]
    nf = cfg.n_forces
    Bsz = rhs.shape[0]
    rhs_F = rhs[:, :nf].reshape(Bsz, T, nu)
    rhs_P = rhs[:, nf:]

    gam = rhs.new_zeros(Bsz, ns)
    pi = rhs.new_zeros(rhs_P.shape)
    zeros_u = rhs.new_zeros(Bsz, nu)
    ffs = [None] * T
    for t in reversed(range(T)):
        At, Bt, Ct = fac.A[:, t], fac.B[:, t], fac.C[:, t]
        Kt, KPt, D1t = fac.K[:, t], fac.KP[:, t], fac.D1[:, t]
        gam9 = gam[:, :9]
        gv = _mtv(Bt, gam9) + gam[:, 9:] - rhs_F[:, t]  # G' gamma' - rhs_t
        ffs[t] = _mv(D1t, gv)
        pi = pi + _mtv(Ct, gam9) - _mtv(KPt, gv)
        gam = torch.cat([_mtv(At, gam9), zeros_u], dim=-1) - _mtv(Kt, gv)
    P = -_mv(fac.Sinv, pi - rhs_P)

    s = rhs.new_zeros(Bsz, ns)
    us = []
    for t in range(T):
        At, Bt, Ct = fac.A[:, t], fac.B[:, t], fac.C[:, t]
        u = -_mv(fac.K[:, t], s) - _mv(fac.KP[:, t], P) - ffs[t]
        y_n = _mv(At, s[:, :9]) + _mv(Bt, u) + _mv(Ct, P)
        s = torch.cat([y_n, u], dim=-1)
        us.append(u)
    return torch.cat([torch.stack(us, dim=1).reshape(Bsz, -1), P], dim=-1)

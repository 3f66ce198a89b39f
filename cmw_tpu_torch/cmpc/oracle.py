"""CPU oracle for the centroidal-MPC NLP: independent numpy/f64 + scipy SLSQP.

Plays the role of the reference's CasADi+IPOPT solve (SURVEY.md §2.4, §4) for
parity testing: a from-scratch reimplementation of the same OCP — numpy
float64, scipy.optimize SLSQP — sharing NOTHING with the JAX solver except
the MPCConfig/MPCParams containers. Agreement between the two implementations
(objective value and solution trajectories within tolerance) is the
"golden parity" gate of the test pyramid.

A copy of `cmw_tpu/cmpc/oracle.py` for the PyTorch package, which may not
import the JAX one; only GRAVITY's import differs. It reads the port's
MPCConfig and one item's unbatched MPCParams as CPU tensors.
"""

from __future__ import annotations

import numpy as np
from scipy import optimize

from cmw_tpu_torch.core.centroidal import GRAVITY


def _unpack(cfg, z):
    nf = cfg.n_forces
    F = z[:nf].reshape(cfg.T, cfg.n_contacts, cfg.n_corners, 3)
    P = z[nf:].reshape(cfg.n_contacts, cfg.n_slots, 3)
    return F, P


def rollout_np(cfg, params, F, P):
    stage = params.stage
    oh = np.asarray(stage.slot_onehot, np.float64)  # [nc,T,K]
    rot_s = np.asarray(stage.slot_rot, np.float64)  # [nc,K,3,3]
    corners = np.array(cfg.corners, np.float64)  # [nc,ncor,3]
    active = np.asarray(stage.active, np.float64)  # [nc,T]
    ext_f = np.asarray(params.ext_force, np.float64)
    ext_t = np.asarray(params.ext_torque, np.float64)

    pos_k = np.einsum("its,isx->tix", oh, P)
    rot_k = np.einsum("its,isxy->tixy", oh, rot_s)
    corner_k = pos_k[:, :, None, :] + np.einsum("tiab,ijb->tija", rot_k, corners)

    X = np.zeros((cfg.N, 9))
    X[0] = np.asarray(params.x0, np.float64)
    g = np.array([0.0, 0.0, -GRAVITY])
    dt = cfg.dt
    # exact discrete map under piecewise-constant forces (must mirror
    # formulation.rollout — see its docstring for why not plain Euler)
    for k in range(cfg.T):
        c, v, L = X[k, 0:3], X[k, 3:6], X[k, 6:9]
        m = active[:, k][:, None, None]
        f = F[k] * m
        f_tot = f.sum((0, 1))
        acc = g + f_tot + ext_f
        dL0 = np.cross(corner_k[k] - c, f).sum((0, 1))
        sweep = 0.5 * dt * dt * v + (dt**3 / 6.0) * acc
        X[k + 1, 0:3] = c + dt * v + 0.5 * dt * dt * acc
        X[k + 1, 3:6] = v + dt * acc
        X[k + 1, 6:9] = L + dt * (dL0 + ext_t) - np.cross(sweep, f_tot)
    return X


def cost_np(cfg, params, z):
    F, P = _unpack(cfg, z)
    X = rollout_np(cfg, params, F, P)
    stage = params.stage
    w_com = np.array(cfg.com_weight)
    com_ref = np.asarray(params.com_ref, np.float64)
    L_ref = np.asarray(params.ang_mom_ref, np.float64)
    c = 0.0
    c += 0.5 * np.sum(w_com * (X[1:, 0:3] - com_ref[1:]) ** 2)
    c += 0.5 * cfg.angular_momentum_weight * np.sum((X[1:, 6:9] - L_ref[1:]) ** 2)
    adj = (np.asarray(stage.slot_valid) * np.asarray(stage.slot_adjustable))[..., None]
    nom = np.asarray(stage.slot_pos_nom, np.float64)
    c += 0.5 * cfg.contact_position_weight * np.sum((adj * (P - nom)) ** 2)
    c += 0.5 * np.sum(np.array(cfg.force_rate_weight) * (F[1:] - F[:-1]) ** 2)
    act = np.asarray(stage.active).T[:, :, None, None]
    c += 0.5 * cfg.force_symmetry_weight * np.sum(
        (act * (F - F.mean(axis=2, keepdims=True))) ** 2
    )
    return c


def solve_oracle(cfg, params, z0=None, maxiter=300):
    """Solve the OCP with scipy SLSQP in float64. Returns (z, cost, result).

    Pinned variables (forces on inactive intervals, non-adjustable contact
    positions) are eliminated from the decision vector rather than
    constrained, so SLSQP's LSQ subproblems stay well-posed.
    """
    stage = params.stage
    active = np.asarray(stage.active, np.float64)  # [nc,T]
    oh = np.asarray(stage.slot_onehot, np.float64)
    rot_s = np.asarray(stage.slot_rot, np.float64)
    nom = np.asarray(stage.slot_pos_nom, np.float64)
    adj = np.asarray(stage.slot_valid) * np.asarray(stage.slot_adjustable)

    # free-variable masks
    f_free = np.broadcast_to(
        active.T[:, :, None, None] > 0, (cfg.T, cfg.n_contacts, cfg.n_corners, 3)
    ).ravel()
    p_free = np.broadcast_to(adj[..., None] > 0, (cfg.n_contacts, cfg.n_slots, 3)).ravel()
    free = np.concatenate([f_free, p_free])
    nfree = int(free.sum())

    if z0 is None:
        F0 = np.zeros((cfg.T, cfg.n_contacts, cfg.n_corners, 3))
        for k in range(cfg.T):
            na = active[:, k].sum() * cfg.n_corners
            if na > 0:
                F0[k, :, :, 2] = GRAVITY * active[:, k][:, None] / na
        z0 = np.concatenate([F0.ravel(), nom.ravel()])

    z_base = np.concatenate(
        [np.zeros(cfg.n_forces), nom.ravel()]
    )  # values of pinned entries

    def embed(x):
        z = z_base.copy()
        z[free] = x
        return z

    rot_k = np.einsum("its,isxy->tixy", oh, rot_s)  # [T,nc,3,3]
    mu = cfg.mu
    act_mask = np.broadcast_to(
        active.T[:, :, None] > 0, (cfg.T, cfg.n_contacts, cfg.n_corners)
    ).ravel()
    adj_mask = np.broadcast_to(adj[..., None] > 0, (cfg.n_contacts, cfg.n_slots, 3)).ravel()

    def ineq(x):
        """All >= 0 constraints, only non-vacuous rows."""
        F, P = _unpack(cfg, embed(x))
        f_loc = np.einsum("tica,tijc->tija", rot_k, F)
        cone = np.stack(
            [
                mu * f_loc[..., 2] - f_loc[..., 0],
                mu * f_loc[..., 2] + f_loc[..., 0],
                mu * f_loc[..., 2] - f_loc[..., 1],
                mu * f_loc[..., 2] + f_loc[..., 1],
                f_loc[..., 2],
                cfg.fz_max - f_loc[..., 2],
            ],
            axis=-1,
        ).reshape(-1, 6)[act_mask].ravel()
        d = np.einsum("isba,isb->isa", rot_s, P - nom)
        bl = np.array(cfg.bbox_lower)[:, None, :]
        bu = np.array(cfg.bbox_upper)[:, None, :]
        box = np.stack([bu - d, d - bl], axis=-1).reshape(-1, 2)[adj_mask].ravel()
        return np.concatenate([cone, box])

    res = optimize.minimize(
        lambda x: cost_np(cfg, params, embed(x)),
        z0[free],
        method="SLSQP",
        constraints=[{"type": "ineq", "fun": ineq}],
        options={"maxiter": maxiter, "ftol": 1e-10},
    )
    z = embed(res.x)
    return z, cost_np(cfg, params, z), res

"""Port Riccati x-update (`cmw_tpu_torch.cmpc.riccati`).

In f64 the factored apply must equal the port's own dense solve with
M = J^T J + (levenberg + sigma) I + A^T rho A to near machine precision: this
pins the derivation (cost blocks, recursions, Schur complement), as
tests/test_riccati.py:86 does for JAX. At f32 the factor's gains are held
against the JAX factor on the same inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_tpu.cmpc import formulation as JF
from cmw_tpu.cmpc import riccati as jric
from cmw_tpu.core import contacts as jcontacts
from cmw_tpu.core.centroidal import pack_state
from cmw_tpu_torch import convert
from cmw_tpu_torch.cmpc import formulation as TF
from cmw_tpu_torch.cmpc import riccati as tric

torch.set_num_threads(2)

F64_RTOL = 1e-9  # relative to max|x| (tests/test_riccati.py:115)
# f32 gains: the same recursion over 20 stages, with sums in another order and
# a Gauss-Jordan pivot inverse each stage; entries of K reach ~1e2 and D1 is an
# inverse of a matrix with rho = 1e4 rows, so compare relative to each gain's
# largest entry.
GAIN_RTOL = 2e-3


def jax_params(cfg, push, t0=1.02):
    plan = jcontacts.snap_to_grid(jcontacts.make_alternating_gait(n_steps=8), cfg.dt)
    stage = jcontacts.mpc_stage_params(plan, t0, cfg.T, cfg.dt, cfg.n_slots)
    N = cfg.N
    com_ref = jnp.asarray([0.0, 0.0, 0.7]) + 0.08 * cfg.dt * jnp.arange(N)[:, None] * jnp.asarray([1.0, 0.0, 0.0])
    return JF.MPCParams(
        x0=pack_state(jnp.asarray([0.0, 0.0, 0.7]), jnp.zeros(3), jnp.zeros(3)),
        com_ref=com_ref,
        ang_mom_ref=jnp.zeros((N, 3)),
        stage=stage,
        ext_force=jnp.asarray(push, jnp.float32),
        ext_torque=jnp.zeros(3),
    )


def port_case(horizon, pushes, dtype):
    jcfg = JF.ergocub_mpc_config(horizon=horizon)
    jp = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[jax_params(jcfg, p) for p in pushes])
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    return jcfg, jp, tcfg, convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu", dtype=dtype)


@pytest.mark.parametrize("horizon", [1.2, 0.6])
def test_riccati_apply_matches_dense_solve_f64(horizon):
    _, _, cfg, params = port_case(horizon, ((0.3, -0.4, 0.0), (0.0, 1.0, 0.0)), torch.float64)
    B = 2
    z_lin = torch.tensor(0.1 * np.random.default_rng(7).standard_normal((B, cfg.n_vars)), dtype=torch.float64)
    _, _, rho = TF.constraint_bounds(cfg, params.stage, torch.float64)
    lam_sig = cfg.levenberg + cfg.admm_sigma
    fac = tric.riccati_factor(cfg, params, z_lin, rho, lam_sig)
    ns, nu = fac.K.shape[-1], fac.K.shape[-2]
    assert ns == 9 + nu == 9 + cfg.n_contacts * cfg.n_corners * 3

    J = torch.func.vmap(torch.func.jacfwd(lambda p, z: TF.residuals(cfg, p, z), argnums=1))(params, z_lin)
    eye = torch.eye(cfg.n_vars, dtype=torch.float64)
    M = J.transpose(-1, -2) @ J + cfg.levenberg * eye + cfg.admm_sigma * eye + TF.ata_blockdiag(
        cfg, params.stage, rho, torch.float64
    )
    rhs = torch.tensor(np.random.default_rng(11).standard_normal((B, cfg.n_vars)), dtype=torch.float64)
    x_ric = tric.riccati_apply(cfg, fac, rhs).numpy()
    x_dense = np.linalg.solve(M.numpy(), rhs.numpy()[..., None])[..., 0]
    err = float(np.abs(x_ric - x_dense).max() / np.abs(x_dense).max())
    assert err < F64_RTOL, err


def test_riccati_factor_matches_jax_f32():
    jcfg, jp, cfg, params = port_case(1.2, ((0.0, 0.6, 0.0), (0.0, -1.0, 0.0)), torch.float32)
    Fg = jax.vmap(lambda s: JF.nominal_force_guess(jcfg, s))(jp.stage)
    z = jax.vmap(lambda f, p: JF.pack_z(jcfg, f, p))(Fg, jp.stage.slot_pos_nom)
    rho = jax.vmap(lambda s: JF.constraint_bounds(jcfg, s)[2])(jp.stage)
    lam_sig = jcfg.levenberg + jcfg.admm_sigma
    want = jax.vmap(lambda p, zz, r: jric.riccati_factor(jcfg, p, zz, r, lam_sig))(jp, z, rho)
    got = tric.riccati_factor(cfg, params, torch.tensor(np.asarray(z)), torch.tensor(np.asarray(rho)), lam_sig)
    for name in tric.RiccatiFactor._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=GAIN_RTOL * np.abs(w).max(), err_msg=name)

    rhs = np.random.default_rng(3).standard_normal((2, jcfg.n_vars)).astype(np.float32)
    x_want = np.asarray(jax.vmap(lambda f, r: jric.riccati_apply(jcfg, f, r))(want, rhs))
    x_got = tric.riccati_apply(cfg, got, torch.tensor(rhs)).numpy()
    np.testing.assert_allclose(x_got, x_want, rtol=0, atol=GAIN_RTOL * np.abs(x_want).max())


def test_spd_inverse_small_matches_numpy():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((3, 24, 24))
    M = A @ A.transpose(0, 2, 1) + 24 * np.eye(24)
    X = tric._spd_inverse_small(torch.tensor(M)).numpy()
    np.testing.assert_allclose(X, np.linalg.inv(M), rtol=1e-10, atol=1e-12)

"""Port parity: `cmw_tpu_torch.cmpc.formulation` vs `cmw_tpu.cmpc.formulation`.

The same inputs, made with numpy from a seed, go through the JAX function
(per item, `jax.vmap` over a batch of 2) and through its port counterpart
(batch-first), both in f32 on the CPU, at the full horizon (T = 20) and at
horizon 0.6 (T = 10).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_tpu.cmpc import formulation as JF
from cmw_tpu.core import contacts as jcontacts
from cmw_tpu.core.centroidal import pack_state
from cmw_tpu_torch import convert
from cmw_tpu_torch.cmpc import formulation as TF
from cmw_tpu_torch.core import contacts as tcontacts

torch.set_num_threads(2)

# Same f32 math, sums in another order: agreement to a few f32 ulps of the
# largest terms. The Jacobian goes through forward-mode AD in both packages,
# whose tangent sums reorder further.
RTOL, ATOL = 1e-5, 1e-5
JAC_ATOL = 1e-4
PUSHES = ((0.0, 1.0, 0.0), (0.3, -0.4, 0.0))
T0S = (1.02, 0.9)


def jax_params(cfg, t0, push):
    plan = jcontacts.snap_to_grid(jcontacts.make_alternating_gait(n_steps=8), cfg.dt)
    stage = jcontacts.mpc_stage_params(plan, t0, cfg.T, cfg.dt, cfg.n_slots)
    N = cfg.N
    com_ref = jnp.asarray([0.0, 0.0, 0.7]) + 0.08 * cfg.dt * jnp.arange(N)[:, None] * jnp.asarray([1.0, 0.0, 0.0])
    return JF.MPCParams(
        x0=pack_state(jnp.asarray([0.01, -0.02, 0.7]), jnp.asarray([0.1, 0.0, 0.0]), jnp.zeros(3)),
        com_ref=com_ref,
        ang_mom_ref=jnp.zeros((N, 3)),
        stage=stage,
        ext_force=jnp.asarray(push, jnp.float32),
        ext_torque=jnp.asarray([0.0, 0.05, 0.0], jnp.float32),
    )


@pytest.fixture(scope="module", params=[1.2, 0.6], ids=["T20", "T10"])
def case(request):
    jcfg = JF.ergocub_mpc_config(horizon=request.param)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    jp = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[jax_params(jcfg, t, p) for t, p in zip(T0S, PUSHES)])
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    # a physically scaled point: gravity-ish forces and nominal positions, plus noise
    Fg = jax.vmap(lambda s: JF.nominal_force_guess(jcfg, s))(jp.stage)
    z = jax.vmap(lambda f, p: JF.pack_z(jcfg, f, p))(Fg, jp.stage.slot_pos_nom)
    z = np.asarray(z) + 0.05 * rng.standard_normal(z.shape).astype(np.float32)
    y = rng.standard_normal((2, jcfg.n_con)).astype(np.float32)
    rho = np.asarray(jax.vmap(lambda s: JF.constraint_bounds(jcfg, s)[2])(jp.stage))
    return jcfg, tcfg, jp, tp, z, y, rho


def _jax_fn(name, cfg, p, z, y, rho):
    if name == "rollout":
        F, P = JF.unpack_z(cfg, z)
        return JF.rollout(cfg, p, F, P)
    if name == "residuals":
        return JF.residuals(cfg, p, z)
    if name == "op_matvec":
        return JF.op_matvec(cfg, JF.constraint_op(cfg, p.stage), z)
    if name == "op_rmatvec":
        return JF.op_rmatvec(cfg, JF.constraint_op(cfg, p.stage), y)
    if name == "constraint_bounds":
        return jnp.stack(JF.constraint_bounds(cfg, p.stage))
    if name == "ata_blockdiag":
        return JF.ata_blockdiag(cfg, p.stage, rho)
    if name == "nominal_force_guess":
        return JF.nominal_force_guess(cfg, p.stage)
    raise KeyError(name)


def _torch_fn(name, cfg, p, z, y, rho):
    if name == "rollout":
        F, P = TF.unpack_z(cfg, z)
        return TF.rollout(cfg, p, F, P)
    if name == "residuals":
        return TF.residuals(cfg, p, z)
    if name == "op_matvec":
        return TF.op_matvec(cfg, TF.constraint_op(cfg, p.stage), z)
    if name == "op_rmatvec":
        return TF.op_rmatvec(cfg, TF.constraint_op(cfg, p.stage), y)
    if name == "constraint_bounds":
        return torch.stack(TF.constraint_bounds(cfg, p.stage), dim=1)
    if name == "ata_blockdiag":
        return TF.ata_blockdiag(cfg, p.stage, rho)
    if name == "nominal_force_guess":
        return TF.nominal_force_guess(cfg, p.stage)
    raise KeyError(name)


FUNCTIONS = [
    "rollout", "residuals", "op_matvec", "op_rmatvec", "constraint_bounds", "ata_blockdiag", "nominal_force_guess",
]


@pytest.mark.parametrize("name", FUNCTIONS)
def test_formulation_matches_jax(case, name):
    jcfg, tcfg, jp, tp, z, y, rho = case
    want = np.asarray(jax.vmap(lambda p, zz, yy, rr: _jax_fn(name, jcfg, p, zz, yy, rr))(jp, z, y, rho))
    got = _torch_fn(name, tcfg, tp, torch.tensor(z), torch.tensor(y), torch.tensor(rho)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_mpc_stage_params_matches_jax(case):
    jcfg, tcfg, jp, tp, *_ = case
    for field in jp.stage._fields:
        np.testing.assert_allclose(
            getattr(tp.stage, field).numpy(), np.asarray(getattr(jp.stage, field)), rtol=RTOL, atol=ATOL,
            err_msg=field,
        )
    # the port also takes a per-item t0 tensor and a batched plan
    plan = tcontacts.snap_to_grid(tcontacts.make_alternating_gait(n_steps=8, device="cpu"), tcfg.dt)
    plan_b = type(plan)(*[a.expand((2,) + a.shape) for a in plan])
    stage_b = tcontacts.mpc_stage_params(plan_b, torch.tensor(T0S), tcfg.T, tcfg.dt, tcfg.n_slots)
    for field in jp.stage._fields:
        np.testing.assert_allclose(getattr(stage_b, field).numpy(), np.asarray(getattr(jp.stage, field)),
                                   rtol=RTOL, atol=ATOL, err_msg=field)


def test_jacfwd_residuals_matches_jax(case):
    jcfg, tcfg, jp, tp, z, *_ = case
    want = np.asarray(jax.vmap(jax.jacfwd(lambda p, zz: JF.residuals(jcfg, p, zz), argnums=1))(jp, z))
    got = torch.func.vmap(torch.func.jacfwd(lambda p, zz: TF.residuals(tcfg, p, zz), argnums=1))(
        tp, torch.tensor(z)
    ).numpy()
    assert got.shape == want.shape == (2, want.shape[1], jcfg.n_vars)
    np.testing.assert_allclose(got, want, atol=JAC_ATOL)


def test_config_round_trip():
    """config_from_dict inverts dataclasses.asdict, also through JSON."""
    jcfg = JF.ergocub_mpc_config(horizon=0.6, kkt_impl="dense", line_search_alphas=(1.0, 0.5, 0.0))
    for d in (dataclasses.asdict(jcfg), json.loads(json.dumps(dataclasses.asdict(jcfg)))):
        tcfg = convert.config_from_dict(d)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert (tcfg.T, tcfg.n_vars, tcfg.n_con) == (jcfg.T, jcfg.n_vars, jcfg.n_con)
        hash(tcfg)
    assert dataclasses.asdict(TF.ergocub_mpc_config()) == dataclasses.asdict(JF.ergocub_mpc_config())
    assert dataclasses.asdict(TF.no_adjust(TF.ergocub_mpc_config())) == dataclasses.asdict(
        JF.no_adjust(JF.ergocub_mpc_config())
    )

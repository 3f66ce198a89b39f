"""Port parity for the whole solve: `cmw_tpu_torch` vs `jax.vmap(cmw_tpu ...solve)`.

B = 2 walking scenarios with lateral pushes (0, +1.0, 0) and (0, -1.0, 0),
a cold solve at t0 = 1.02 and one warm-started tick at t0 = 1.08, on both
KKT branches and on the dense branch's fused ADMM loop (JAX runs its fused
Pallas kernel in interpret mode), f32 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_tpu.cmpc import CentroidalMPCSolver as JaxSolver
from cmw_tpu.cmpc import formulation as JF
from cmw_tpu.core import contacts as jcontacts
from cmw_tpu.core.centroidal import pack_state
from cmw_tpu_torch import convert
from cmw_tpu_torch.cmpc import CentroidalMPCSolver, ergocub_mpc_config
from cmw_tpu_torch.core import contacts
from cmw_tpu_torch.ops import admm_fused as K5
from cmw_tpu_torch.ops import spd_inverse as K3
from cmw_tpu_torch.ops import symv as K4

torch.set_num_threads(2)

# Cross-path tolerances of tests/test_riccati.py:127-144 and tests/test_ops.py:
# 118-121: two f32 solves of the same problem through differently ordered
# sums (2 SQP x 24 ADMM iterations with rho up to 1e4) agree to ~1e-5.
COST_RTOL = 2e-3
PRIM_MAX = 1e-2
FORCE_ATOL = 1e-3
POS_ATOL = 1e-4
PUSHES = ((0.0, 1.0, 0.0), (0.0, -1.0, 0.0))

CASES = {
    "dense": dict(kkt_impl="dense", inverse_impl="xla"),
    "dense_symv": dict(kkt_impl="dense", inverse_impl="xla", xupdate_impl="symv"),
    "dense_fused": dict(kkt_impl="dense", inverse_impl="xla", admm_impl="fused"),
    "riccati": dict(),
}


def jax_params(cfg, t0, push):
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


def batch(cfg, t0, pushes=PUSHES):
    jp = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[jax_params(cfg, t0, p) for p in pushes])
    return jp, convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def assert_same_solution(got, want):
    w = {k: np.asarray(v) for k, v in want._asdict().items()}
    g = convert.solution_to_numpy(got)
    np.testing.assert_allclose(g["cost"], w["cost"], rtol=COST_RTOL)
    assert g["prim_res"].max() < PRIM_MAX and w["prim_res"].max() < PRIM_MAX
    assert np.isfinite(g["z"]).all()
    np.testing.assert_allclose(g["forces"], w["forces"], atol=FORCE_ATOL)
    np.testing.assert_allclose(g["positions"], w["positions"], atol=POS_ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_solve_matches_jax(name):
    jcfg = JF.ergocub_mpc_config(**CASES[name])
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    js, ts = JaxSolver(jcfg), CentroidalMPCSolver(tcfg)
    jsolve = jax.jit(jax.vmap(js.solve))

    launches = (K3.launches, K4.launches, K5.launches)
    jp, tp = batch(jcfg, 1.02)
    jsol = jsolve(jp, jax.vmap(lambda _: js.cold_start())(jnp.arange(len(PUSHES))))
    tsol = ts.solve(tp, ts.cold_start(len(PUSHES), device="cpu"))
    assert_same_solution(tsol, jsol)

    # one warm-started receding-horizon tick, from each package's own state
    jp2, tp2 = batch(jcfg, 1.08)
    jsol2 = jsolve(jp2, jax.vmap(js.warm_from)(jp2, jsol))
    tsol2 = ts.solve(tp2, ts.warm_from(tp2, tsol))
    assert_same_solution(tsol2, jsol2)
    # and from the JAX warm start carried across
    warm = convert.warm_from_numpy({k: np.asarray(v) for k, v in jax.vmap(js.warm_from)(jp2, jsol)._asdict().items()},
                                   device="cpu")
    assert_same_solution(ts.solve(tp2, warm), jsol2)
    assert (K3.launches, K4.launches, K5.launches) == launches  # CPU tensors never reach a kernel


@pytest.mark.parametrize("kkt_impl", ["dense", "riccati"])
def test_lateral_push_saturates_footstep_box(kkt_impl):
    """ext_force [0, 1.2, 0] moves the left foot's next step to the +y edge
    of its box (bbox_upper y = 0.05) and keeps every step in its box."""
    cfg = ergocub_mpc_config(kkt_impl=kkt_impl)
    _, tp = batch(JF.ergocub_mpc_config(), 1.02, pushes=((0.0, 1.2, 0.0),))
    solver = CentroidalMPCSolver(cfg)
    sol = solver.solve(tp, solver.cold_start(1, device="cpu"))
    stage = tp.stage
    adj = (stage.slot_adjustable * stage.slot_valid)[..., None]
    d = ((sol.positions - stage.slot_pos_nom) * adj)[0]
    assert abs(float(d[0, :, 1].max()) - cfg.bbox_upper[0][1]) < 1e-3
    bl = torch.tensor(cfg.bbox_lower)[:, None, :]
    bu = torch.tensor(cfg.bbox_upper)[:, None, :]
    assert bool(((d <= bu + 1e-4) & (d >= bl - 1e-4)).all())
    assert float(sol.prim_res.max()) < PRIM_MAX


@pytest.mark.parametrize("kkt_impl", ["dense", "riccati"])
def test_empty_plan_stays_finite(kkt_impl):
    """No contacts at all: free fall, zero forces, finite everything."""
    cfg = ergocub_mpc_config(kkt_impl=kkt_impl)
    _, tp = batch(JF.ergocub_mpc_config(), 1.02, pushes=((0.0, 0.0, 0.0),))
    stage = contacts.mpc_stage_params(contacts.empty_plan(device="cpu"), 1.02, cfg.T, cfg.dt, cfg.n_slots)
    tp = tp._replace(stage=type(stage)(*[a[None] for a in stage]))
    solver = CentroidalMPCSolver(cfg)
    sol = solver.solve(tp, solver.cold_start(1, device="cpu"))
    for name, value in sol._asdict().items():
        assert bool(torch.isfinite(value).all()), name
    assert float(sol.forces.abs().max()) == 0.0


def test_unknown_and_unported_options_raise():
    for field in ("kkt_impl", "inverse_impl", "xupdate_impl", "admm_impl", "kkt_dtype"):
        with pytest.raises(ValueError, match=field):
            CentroidalMPCSolver(ergocub_mpc_config(**{field: "nonsense"}))
    assert CentroidalMPCSolver(ergocub_mpc_config(kkt_impl="dense", admm_impl="fused")).use_fused
    with pytest.raises(NotImplementedError):
        CentroidalMPCSolver(ergocub_mpc_config(kkt_impl="dense", kkt_dtype="bf16"))
    # the Riccati branch ignores the dense-path knobs, as in JAX
    assert not CentroidalMPCSolver(ergocub_mpc_config(admm_impl="fused", kkt_dtype="bf16")).use_fused


def test_refactor_every_sqp_solves():
    """refactor_every_sqp=True (exact Gauss-Newton) on both branches: feasible,
    finite, and not materially worse than quasi-Newton on a hard cold start
    (tests/test_riccati.py:147-162)."""
    _, tp = batch(JF.ergocub_mpc_config(horizon=0.6), 1.02, pushes=((0.0, 1.2, 0.0),))
    for kkt_impl in ("dense", "riccati"):
        cfg_q = ergocub_mpc_config(horizon=0.6, kkt_impl=kkt_impl)
        cfg_e = dataclasses.replace(cfg_q, refactor_every_sqp=True)
        sq, se = CentroidalMPCSolver(cfg_q), CentroidalMPCSolver(cfg_e)
        sol_q = sq.solve(tp, sq.cold_start(1, device="cpu"))
        sol_e = se.solve(tp, se.cold_start(1, device="cpu"))
        assert np.isfinite(float(sol_e.cost)) and float(sol_e.prim_res) < PRIM_MAX
        assert float(sol_e.cost) <= 1.1 * float(sol_q.cost)


def test_entry_points_default_to_the_card():
    """Without `device`, the entry points put their tensors on the card; on a
    machine without one they raise rather than fall back to the CPU."""
    solver = CentroidalMPCSolver(ergocub_mpc_config())
    plan_np = {k: np.asarray(v) for k, v in jcontacts.make_alternating_gait(n_steps=2)._asdict().items()}
    calls = (
        lambda: solver.cold_start(1),
        lambda: contacts.make_alternating_gait(),
        lambda: contacts.empty_plan(),
        lambda: convert.plan_from_numpy(plan_np),
    )
    for call in calls:
        if torch.cuda.is_available():
            assert all(t.device.type == "cuda" for t in call())
        else:
            with pytest.raises((AssertionError, RuntimeError)):  # torch: "not compiled with CUDA" / no device
                call()

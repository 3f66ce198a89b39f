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
from cmw_tpu_torch.ops import riccati_admm as K2
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
# JAX's envelope of the bf16 KKT against f32 on converged solves
# (tests/test_cmpc.py:211-235): prim_res < 5e-2, cost within 8 %
BF16_PRIM_MAX = 5e-2
BF16_COST_RTOL = 0.08
# the port's bf16 solve against JAX's in f64, where both round the same
# values to bf16: the two packages' sums differ only in f64 ulps
BF16_F64_TOL = 1e-9

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

    launches = (K2.launches, K3.launches, K4.launches, K5.launches)
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
    assert (K2.launches, K3.launches, K4.launches, K5.launches) == launches  # CPU tensors never reach a kernel


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
    # every kkt_dtype JAX runs is run on the dense branch ("auto" is "f32", as in JAX off a TPU)
    _, tp = batch(JF.ergocub_mpc_config(horizon=0.6), 1.02, pushes=((0.0, 1.2, 0.0),))
    for kkt_dtype, resolved in (("auto", "f32"), ("f32", "f32"), ("bf16", "bf16")):
        solver = CentroidalMPCSolver(ergocub_mpc_config(horizon=0.6, kkt_impl="dense", kkt_dtype=kkt_dtype))
        assert solver.kkt_dtype == resolved
        sol = solver.solve(tp, solver.cold_start(1, device="cpu"))
        assert bool(torch.isfinite(sol.z).all()) and float(sol.prim_res[0]) < BF16_PRIM_MAX
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


BF16_CFG = dict(sqp_iters=6, admm_iters=80, refactor_every_sqp=True, kkt_impl="dense", inverse_impl="xla")


def bf16_params(cfg, push, dtype):
    """tests/test_cmpc.py:211-235's problem: the 6-step gait at t0 = 0.66,
    standing at 0.7 m, with and without the lateral push 1.2."""
    plan = jcontacts.snap_to_grid(jcontacts.make_alternating_gait(n_steps=6), cfg.dt)
    stage = jcontacts.mpc_stage_params(plan, 0.66, cfg.T, cfg.dt, cfg.n_slots)
    com0 = np.array([0.0, 0.0, 0.7])
    params = JF.MPCParams(
        x0=np.concatenate([com0, np.zeros(6)]), com_ref=np.broadcast_to(com0, (cfg.N, 3)),
        ang_mom_ref=np.zeros((cfg.N, 3)), stage=jax.tree_util.tree_map(np.asarray, stage),
        ext_force=np.zeros(3) if push is None else np.asarray(push), ext_torque=np.zeros(3),
    )
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype) if np.asarray(a).dtype.kind == "f" else a, params)


@pytest.mark.parametrize("tail", [0, 8])
def test_bf16_kkt_matches_jax_in_f64(tail):
    """kkt_dtype="bf16" on the dense branch, kkt_f32_tail 0 and 8, against
    JAX's dense bf16 solve on the same problems in f64 (JAX's own test at
    tests/test_cmpc.py:211 runs the default Riccati branch, which ignores
    kkt_dtype). In f64 both packages round the same values to bf16, so the
    solves agree to f64 ulps (BF16_F64_TOL). In f32 they cannot be held to
    each other: the rounding to bf16 is chaotic there, and JAX against itself
    with x0 scaled by 1 + 1e-7 moves the cost by up to 1.8 % and the forces
    by up to 5.8e-2 on these problems (printed by
    test_bf16_kkt_within_jax_envelope)."""
    jcfg = JF.ergocub_mpc_config(**BF16_CFG, kkt_dtype="bf16", kkt_f32_tail=tail)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    js, ts = JaxSolver(jcfg), CentroidalMPCSolver(tcfg)
    for push in (None, (0.0, 1.2, 0.0)):
        p = bf16_params(jcfg, push, np.float64)
        with jax.enable_x64(True):
            warm = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), js.cold_start())
            want = jax.tree_util.tree_map(np.asarray, jax.jit(js.solve)(jax.tree_util.tree_map(jnp.asarray, p), warm))
        tp = convert.params_from_numpy(jax.tree_util.tree_map(lambda a: a[None], p), device="cpu", dtype=torch.float64)
        got = convert.solution_to_numpy(ts.solve(tp, ts.cold_start(1, device="cpu", dtype=torch.float64)))
        for name in ("cost", "prim_res", "forces", "positions", "z"):
            np.testing.assert_allclose(got[name][0], want._asdict()[name], rtol=BF16_F64_TOL, atol=BF16_F64_TOL,
                                       err_msg=f"push {push} {name}")


@pytest.mark.parametrize("tail", [0, 8])
def test_bf16_kkt_within_jax_envelope(tail, capsys):
    """The port's f32 bf16 solve within JAX's envelope (prim_res < 5e-2,
    cost within 8 %) of both packages' f32 solves of the same problems.
    Printed beside it: the port's bf16 solve against JAX's, JAX's against
    itself with x0 scaled by 1 + 1e-7 (the spread of the bf16 rounding in
    f32), and JAX's own bf16 cost offset from its f32 cost."""
    jcfg32 = JF.ergocub_mpc_config(**BF16_CFG)
    jcfg16 = dataclasses.replace(jcfg32, kkt_dtype="bf16", kkt_f32_tail=tail)
    j32, j16 = JaxSolver(jcfg32), JaxSolver(jcfg16)
    jsolve32, jsolve16 = jax.jit(j32.solve), jax.jit(j16.solve)
    cfg32 = convert.config_from_dict(dataclasses.asdict(jcfg32))
    s32, s16 = CentroidalMPCSolver(cfg32), CentroidalMPCSolver(dataclasses.replace(cfg32, kkt_dtype="bf16",
                                                                                  kkt_f32_tail=tail))
    for push in (None, (0.0, 1.2, 0.0)):
        p = bf16_params(jcfg32, push, np.float32)
        jp = jax.tree_util.tree_map(jnp.asarray, p)
        want32 = float(jsolve32(jp, j32.cold_start()).cost)
        want16 = jsolve16(jp, j16.cold_start())
        bumped = jsolve16(jp._replace(x0=jp.x0 * (1.0 + 1e-7)), j16.cold_start())
        tp = convert.params_from_numpy(jax.tree_util.tree_map(lambda a: a[None], p), device="cpu")
        sol32 = s32.solve(tp, s32.cold_start(1, device="cpu"))
        sol16 = s16.solve(tp, s16.cold_start(1, device="cpu"))
        cost16 = float(sol16.cost[0])
        with capsys.disabled():
            print(f"\nbf16 tail {tail} push {push}: cost offset from f32 port {cost16 / float(sol32.cost[0]) - 1:.3e} "
                  f"JAX {float(want16.cost) / want32 - 1:.3e}; |dcost| / cost port vs JAX "
                  f"{abs(cost16 - float(want16.cost)) / float(want16.cost):.3e}, JAX vs JAX bumped "
                  f"{abs(float(bumped.cost) - float(want16.cost)) / float(want16.cost):.3e}; max |dforces| port vs JAX "
                  f"{float(np.abs(sol16.forces[0].numpy() - np.asarray(want16.forces)).max()):.3e}, JAX vs JAX bumped "
                  f"{float(np.abs(np.asarray(bumped.forces) - np.asarray(want16.forces)).max()):.3e}; prim port "
                  f"{float(sol16.prim_res[0]):.3e} JAX {float(want16.prim_res):.3e}")
        assert float(sol16.prim_res[0]) < BF16_PRIM_MAX
        for ref in (float(sol32.cost[0]), want32):
            assert abs(cost16 - ref) < BF16_COST_RTOL * ref

"""Port parity for the whole-body level and what it stands on:
`cmw_tpu_torch.wbc` (ZMP, CoM-ZMP, swing foot, differential IK),
`cmpc.qp.solve_eq_qp` / `solve_eq_box_qp`, `estimation` (fixed foot, legged
odometry) and `sim.plant` against `cmw_tpu`, the same numpy inputs from a
seed through both, batched in the port against `jax.vmap` (one jit per
function and dtype), in float64 (JAX under enable_x64) and float32.

Tolerances: f64 within F64_TOL of max(1, |value|); f32 within F32_GAP_MULT
times JAX's own f32-vs-f64 gap on the same inputs, plus 4 ulps of the
channel's scale. Plant noise is held by its statistics: the port's noise
stream (a torch.Generator) cannot match JAX's keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cmw_tpu.cmpc import qp as Jqp
from cmw_tpu.core import contacts as JC
from cmw_tpu.core import kinematics as JK
from cmw_tpu.estimation import fixed_foot as Jff
from cmw_tpu.estimation import legged_odom as Jodo
from cmw_tpu.sim import plant as JP
from cmw_tpu.wbc import com_zmp as Jcz
from cmw_tpu.wbc import diff_ik as Jik
from cmw_tpu.wbc import swing_foot as Jsf
from cmw_tpu.wbc import zmp as Jzmp
from cmw_tpu_torch import convert
from cmw_tpu_torch.cmpc import qp as Tqp
from cmw_tpu_torch.cmpc.formulation import ergocub_mpc_config
from cmw_tpu_torch.core import kinematics as TK
from cmw_tpu_torch.estimation import fixed_foot as Tff
from cmw_tpu_torch.estimation import legged_odom as Todo
from cmw_tpu_torch.runtime.config import ergocub_gazebo_v1
from cmw_tpu_torch.runtime.loop import TickInput, WalkingController
from cmw_tpu_torch.sim import plant as TP
from cmw_tpu_torch.wbc import com_zmp as Tcz
from cmw_tpu_torch.wbc import diff_ik as Tik
from cmw_tpu_torch.wbc import swing_foot as Tsf
from cmw_tpu_torch.wbc import zmp as Tzmp

torch.set_num_threads(2)

DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
F64_TOL = 1e-9
F32_GAP_MULT = 4.0
B = 6
# the IK's f32 error is set by its KKT's conditioning: JAX's own f32-vs-f64
# gap, a max over the items, measures that scale stably over 24 items (over
# 6, the max of either package's gap moves 4x from seed to seed)
B_IK = 24


def _leaves(x):
    if x is None:
        return []
    if isinstance(x, (tuple, list)):
        return [leaf for part in x for leaf in _leaves(part)]
    return [np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x, dtype=np.float64)]


_JITS = {}


def run_both(jfn, tfn, inputs, key=None):
    """{dtype: (JAX outputs, port outputs)} as lists of float64 numpy leaves;
    inputs are numpy arrays with the batch axis first (float arrays cast to
    the dtype, integer ones kept). JAX runs `jfn` under jit(vmap); with a
    `key`, the jitted function is kept for later calls with that key."""
    out = {}
    for dt, (jd, td) in DTYPES.items():
        with jax.enable_x64(dt == "f64"):
            args = [jnp.asarray(a, jd) if np.asarray(a).dtype.kind == "f" else jnp.asarray(a) for a in inputs]
            fn = _JITS.get((key, dt)) if key is not None else None
            if fn is None:
                fn = jax.jit(jax.vmap(jfn))
                if key is not None:
                    _JITS[(key, dt)] = fn
            want = _leaves(jax.tree_util.tree_map(np.asarray, fn(*args)))
        targs = [torch.as_tensor(np.asarray(a), dtype=td) if np.asarray(a).dtype.kind == "f"
                 else torch.as_tensor(np.asarray(a)) for a in inputs]
        out[dt] = (want, _leaves(tfn(*targs)))
    return out


def check(out, names=None):
    """f64 within F64_TOL; f32 within F32_GAP_MULT x JAX's f32-vs-f64 gap."""
    (w64, g64), (w32, g32) = out["f64"], out["f32"]
    assert len(w64) == len(g64) == len(w32) == len(g32)
    names = names or [str(i) for i in range(len(w64))]
    for name, w, g in zip(names, w64, g64):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        scale = max(1.0, np.abs(w).max(initial=0.0))
        assert np.abs(g - w).max(initial=0.0) <= F64_TOL * scale, (name, np.abs(g - w).max())
    for name, w, g, ref in zip(names, w32, g32, w64):
        gap = np.abs(w - ref).max(initial=0.0)
        tol = F32_GAP_MULT * gap + 4 * np.finfo(np.float32).eps * max(1.0, np.abs(ref).max(initial=0.0))
        assert np.abs(g - w).max(initial=0.0) <= tol, (name, np.abs(g - w).max(), gap)


def _rot(rng, n, scale=1.0):
    w = scale * rng.standard_normal((n, 3))
    th = np.linalg.norm(w, axis=-1)[:, None, None]
    W = np.cross(np.eye(3)[None], (w / th[..., 0])[:, None, :])
    return np.eye(3) + np.sin(th) * W + (1 - np.cos(th)) * W @ W


@pytest.fixture(scope="module")
def model():
    jm = JK.ergocub_urdf()
    return jm, convert.robot_model_from_numpy(jm)


# --- ZMP and CoM-ZMP -----------------------------------------------------------


def test_zmp_matches_jax():
    rng = np.random.default_rng(0)
    wrench = rng.standard_normal((B, 2, 6))
    wrench[:, :, 2] = rng.uniform(-1.0, 30.0, (B, 2))  # some feet unloaded
    rot = _rot(rng, 2 * B, 0.2).reshape(B, 2, 3, 3)
    pos = rng.standard_normal((B, 2, 3))
    check(run_both(Jzmp.foot_zmp, Tzmp.foot_zmp, (wrench, rot, pos)))
    check(run_both(Jzmp.global_zmp, Tzmp.global_zmp, (wrench, rot, pos)))
    forces = rng.standard_normal((B, 2, 4, 3))
    forces[..., 2] = rng.uniform(-2.0, 8.0, (B, 2, 4))
    corners = pos[:, :, None, :] + 0.1 * rng.standard_normal((B, 2, 4, 3))
    check(run_both(Jzmp.desired_zmp_from_corners, Tzmp.desired_zmp_from_corners, (forces, corners)))
    centers = pos + 0.02 * rng.standard_normal((B, 2, 3))
    check(run_both(lambda f, c, m: Jzmp.desired_zmp_from_corners(f, c, centers=m),
                   lambda f, c, m: Tzmp.desired_zmp_from_corners(f, c, centers=m), (forces, corners, centers)))


def test_com_zmp_matches_jax():
    rng = np.random.default_rng(1)
    args = [rng.standard_normal((B, 2)) for _ in range(5)] + [rng.uniform(-3.0, 3.0, B)]
    gains = Jcz.CoMZMPGains(com_gain=(3.0, 5.0), zmp_gain=(0.5, 0.7))
    tgains = Tcz.CoMZMPGains(com_gain=(3.0, 5.0), zmp_gain=(0.5, 0.7))
    check(run_both(lambda *a: Jcz.com_zmp_control(*a, gains), lambda *a: Tcz.com_zmp_control(*a, tgains), args))


# --- plans: the alternating gait and the lifted MANN plan ----------------------


@pytest.fixture(scope="module")
def plans(model):
    """{name: numpy plan [B, ...] and times [B]}: the scripted alternating
    gait, and the plan the port's MPC stage writes from the lifted synthetic
    weights (the left foot swings from t = 0.06 s and has no next landing in
    the horizon), each at stance, early-swing and late-swing times."""
    gait = {k: np.asarray(v) for k, v in JC.make_alternating_gait(n_steps=6)._asdict().items()}
    gait = {k: np.broadcast_to(v, (B,) + v.shape).copy() for k, v in gait.items()}
    _, tm = model
    ctl = WalkingController(ergocub_gazebo_v1(mpc=ergocub_mpc_config(horizon=0.6)), tm,
                            convert.mann_weights_from_numpy(chip_smoke.lifted(chip_smoke.synthetic_mann_numpy()),
                                                            device="cpu", dtype=torch.float64), device="cpu")
    s = ctl.initial_state(B, dtype=torch.float64)
    joy = chip_smoke.joysticks(B, device="cpu").double()
    s = ctl._mpc_stage(s, TickInput(joy, torch.zeros(B, 3, dtype=torch.float64), torch.zeros(B, 3, dtype=torch.float64)))
    lift = convert.solution_to_numpy(s.plan)
    return {
        "gait": (gait, np.array([0.3, 0.61, 0.75, 1.02, 1.2, 1.39])),  # single-support ends 0.6 + 0.8 k
        "lift": (lift, np.array([0.0, 0.03, 0.061, 0.09, 0.3, 0.95])),
    }


@pytest.mark.parametrize("name", ["gait", "lift"])
def test_swing_foot_matches_jax(plans, name):
    plan, t = plans[name]
    cfg = Jsf.SwingFootConfig(step_height=0.05, foot_apex_time=0.4, landing_velocity=-0.1)
    tcfg = Tsf.SwingFootConfig(step_height=0.05, foot_apex_time=0.4, landing_velocity=-0.1)
    fields = list(plan)
    out = run_both(lambda t_, *p: Jsf.evaluate(JC.ContactPlan(**dict(zip(fields, p))), t_, cfg),
                   lambda t_, *p: Tsf.evaluate(convert.plan_from_numpy(dict(zip(fields, p)), device="cpu",
                                                                       dtype=t_.dtype), t_, tcfg),
                   [t] + [plan[f] for f in fields])
    check(out, names=list(Tsf.FootState._fields))
    contact = out["f64"][0][4]
    assert contact.min() == 0.0 and contact.max() == 1.0  # both stance and swing are held
    progress = out["f64"][0][5]
    assert ((progress > 0.0) & (progress < 0.3)).any() and (progress > 0.7).any()  # early and late swing


@pytest.mark.parametrize("name", ["gait", "lift"])
def test_fixed_foot_matches_jax(plans, name):
    plan, t = plans[name]
    fields = list(plan)
    for prefer in (0, 1):
        out = run_both(lambda t_, *p: Jff.detect(JC.ContactPlan(**dict(zip(fields, p))), t_, prefer),
                       lambda t_, *p: Tff.detect(convert.plan_from_numpy(dict(zip(fields, p)), device="cpu",
                                                                         dtype=t_.dtype), t_, prefer),
                       [t] + [plan[f] for f in fields])
        check(out, names=list(Tff.FixedFoot._fields))
        np.testing.assert_array_equal(out["f32"][1][0], out["f64"][0][0])  # the same foot in both dtypes


# --- the dense QPs -------------------------------------------------------------


def _qp(seed, n=32, m=15, rank_deficient=False):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    H = G @ np.swapaxes(G, 1, 2) / n + 1e-3 * np.eye(n)
    A = rng.standard_normal((B, m, n))
    if rank_deficient:  # two equal rows with inconsistent targets (a singular exact KKT)
        A[:, -1] = A[:, 0]
    return H, rng.standard_normal((B, n)), A, rng.standard_normal((B, m))


@pytest.mark.parametrize("rank_deficient", [False, True])
def test_solve_eq_qp_matches_jax(rank_deficient):
    check(run_both(Jqp.solve_eq_qp, Tqp.solve_eq_qp, _qp(2, rank_deficient=rank_deficient)))


@pytest.mark.parametrize("box", ["loose", "active"])
def test_solve_eq_box_qp_matches_jax(box):
    H, g, A, b = _qp(3)
    n = H.shape[-1]
    mask = np.concatenate([np.zeros(6), np.ones(n - 6)])
    x = np.linalg.solve(H[0], g[0])  # the unconstrained scale
    half = 10.0 * np.abs(x).max() if box == "loose" else 0.05
    lo, hi = np.full((B, n), -half), np.full((B, n), half)
    out = run_both(lambda H_, g_, A_, b_, l_, u_: Jqp.solve_eq_box_qp(H_, g_, A_, b_, jnp.asarray(mask, H_.dtype), l_, u_),
                   lambda H_, g_, A_, b_, l_, u_: Tqp.solve_eq_box_qp(H_, g_, A_, b_, torch.as_tensor(mask, dtype=H_.dtype),
                                                                      l_, u_), (H, g, A, b, lo, hi))
    check(out)
    v = out["f64"][1][0]
    if box == "active":
        assert np.abs(v[:, 6:]).max() > 0.9 * half  # the box binds
    else:
        np.testing.assert_allclose(v, np.stack([np.asarray(Jqp.solve_eq_qp(*(jnp.asarray(a[i]) for a in (H, g, A, b))))
                                                for i in range(B)]), atol=1e-5)


# --- differential IK -----------------------------------------------------------


def _ik_inputs(jm, tm, pose, seed, B=B_IK):
    """B configurations near `pose` with targets near their FK: feet, CoM,
    root, chest and posture; base at the origin with the crouch pitch."""
    rng = np.random.default_rng(seed)
    q0, R0 = pose
    q = q0[None] + 0.02 * rng.standard_normal((B, jm.nj))
    R = np.einsum("bij,jk->bik", _rot(rng, B, 0.02), R0)
    p = 0.01 * rng.standard_normal((B, 3))
    lR, lp = TK.fk(tm, *(torch.as_tensor(a) for a in (q, R, p)))
    fR, fp = (a.numpy() for a in TK.frame_poses(tm, lR, lp))
    c = TK.com(tm, lR, lp).numpy()
    soles = [jm.frame_index("l_sole"), jm.frame_index("r_sole")]
    return dict(
        q=q, R=R, p=p,
        foot_rot=np.einsum("bfij,bfjk->bfik", _rot(rng, 2 * B, 0.05).reshape(B, 2, 3, 3), fR[:, soles]),
        foot_pos=fp[:, soles] + 0.01 * rng.standard_normal((B, 2, 3)),
        foot_lin_vel=0.1 * rng.standard_normal((B, 2, 3)), foot_ang_vel=0.1 * rng.standard_normal((B, 2, 3)),
        com_xy=c[:, 0:2] + 0.01 * rng.standard_normal((B, 2)), dcom_xy=0.1 * rng.standard_normal((B, 2)),
        root_z=p[:, 2] - 0.02, droot_z=0.05 * rng.standard_normal(B), chest_rot=_rot(rng, B, 0.1),
        q_reg=q0[None] + 0.05 * rng.standard_normal((B, jm.nj)),
        ang_mom=0.05 * rng.standard_normal((B, 3)), ang_mom_w=rng.uniform(0.5, 5.0, B),
        qd_lo=-rng.uniform(0.05, 0.5, (B, jm.nj)), qd_hi=rng.uniform(0.05, 0.5, (B, jm.nj)),
        chest_w_rp=rng.uniform(0.5, 30.0, B),
    )


IK_CASES = {"plain": (), "joint box": ("qd_lo", "qd_hi"), "ang_mom": ("ang_mom", "ang_mom_w"),
            "chest_w_rp": ("chest_w_rp",)}
IK_BASE = ("foot_rot", "foot_pos", "foot_lin_vel", "foot_ang_vel", "com_xy", "dcom_xy", "root_z", "droot_z",
           "chest_rot", "q_reg")


@pytest.fixture(scope="module")
def poses(model):
    """The walk-ready crouch, and the polished pose (the port's f64
    polish, which tests/test_torch_runtime.py holds against JAX)."""
    jm, tm = model
    ctl = WalkingController(ergocub_gazebo_v1(), tm, convert.mann_weights_from_numpy(
        chip_smoke.synthetic_mann_numpy(), device="cpu"), device="cpu")
    q, R = ctl.polished_initial_pose(torch.float64)
    return {"walk-ready": JK.walk_ready_pose(), "polished": (q.numpy(), R.numpy())}


@pytest.mark.parametrize("pose", ["walk-ready", "polished"])
@pytest.mark.parametrize("case", list(IK_CASES))
def test_solve_ik_matches_jax(model, poses, pose, case):
    jm, tm = model
    inp = _ik_inputs(jm, tm, poses[pose], seed=4)
    keys = IK_BASE + IK_CASES[case]

    def jfn(q, R, p, *t):
        return Jik.solve_ik(jm, q, R, p, Jik.IKTargets(**dict(zip(keys, t))))

    def tfn(q, R, p, *t):
        return Tik.solve_ik(tm, q, R, p, Tik.IKTargets(**dict(zip(keys[:len(t)], t))))

    out = run_both(jfn, tfn, [inp["q"], inp["R"], inp["p"]] + [inp[k] for k in keys], key=("ik", case))
    check(out)
    nu = out["f64"][1][0]
    assert np.isfinite(nu).all() and np.abs(nu).max() > 1e-3
    if case == "joint box":  # the box pulls the joint velocities in (ADMM: approximately)
        free = tfn(*(torch.as_tensor(inp[k]) for k in ("q", "R", "p") + IK_BASE)).numpy()

        def excess(v):
            return np.maximum(np.maximum(v[:, 6:] - inp["qd_hi"], inp["qd_lo"] - v[:, 6:]), 0.0).max()

        assert excess(nu) < excess(free), (excess(nu), excess(free))


# --- legged odometry -----------------------------------------------------------


def test_legged_odometry_matches_jax(model):
    jm, tm = model
    rng = np.random.default_rng(5)
    q = JK.walk_ready_pose()[0][None] + 0.1 * rng.standard_normal((B, jm.nj))
    qd = rng.standard_normal((B, jm.nj))
    idx = np.arange(B) % 2
    fR, fp = _rot(rng, B, 0.3), rng.standard_normal((B, 3))
    imu = _rot(rng, B, 0.2)
    bR, bp = _rot(rng, B, 0.2), rng.standard_normal((B, 3))

    def J(q_, i, R_, p_, qd_, imu_, bR_, bp_):
        st = Jodo.OdometryState(i, R_, p_)
        init = Jodo.init(jm, q_, i, R_, p_)
        sw = Jodo.switch_fixed_foot(st, 1 - i, bR_, bp_)
        return (Jodo.base_pose(jm, st, q_), Jodo.base_pose_fused(jm, st, q_, imu_),
                Jodo.base_twist(jm, st, q_, qd_, bR_, bp_), init, sw, Jodo.base_pose(jm, sw, q_))

    def T(q_, i, R_, p_, qd_, imu_, bR_, bp_):
        st = Todo.OdometryState(i, R_, p_)
        init = Todo.init(tm, q_, i, R_, p_)
        sw = Todo.switch_fixed_foot(st, 1 - i, bR_, bp_)
        return (Todo.base_pose(tm, st, q_), Todo.base_pose_fused(tm, st, q_, imu_),
                Todo.base_twist(tm, st, q_, qd_, bR_, bp_), init, sw, Todo.base_pose(tm, sw, q_))

    check(run_both(J, T, (q, idx, fR, fp, qd, imu, bR, bp)))
    # defaults: the left sole at the origin
    default = Todo.init(tm, torch.as_tensor(q))
    assert default.fixed_index.tolist() == [0] * B and float(default.fixed_pos.abs().max()) == 0.0
    assert Todo.OdomConfig().initial_fixed_index == Jodo.OdomConfig().initial_fixed_index == 0
    assert Todo.OdomConfig(initial_fixed_frame="r_sole").initial_fixed_index == 1


# --- the kinematic plant -------------------------------------------------------


@pytest.mark.parametrize("tau", [0.0, 0.01])
def test_plant_matches_jax(tau):
    """The ideal plant (tau 0) and the servo lag, noise-free: servo_step,
    read_joints, read_zmp and the wrench deadband, in both packages."""
    rng = np.random.default_rng(6)
    q_act, dq_act, q_cmd = (rng.standard_normal((B, 26)) for _ in range(3))
    forces = np.abs(rng.standard_normal((B, 2, 4, 3)))
    corners = rng.standard_normal((B, 2, 4, 3))
    push = np.concatenate([np.zeros((B // 2, 3)), 0.05 * rng.standard_normal((B - B // 2, 3))])  # below/above 0.7 N
    pj, pt = JP.PlantConfig(servo_tau=tau), TP.PlantConfig(servo_tau=tau)
    assert pj.enabled == pt.enabled == (tau > 0)

    def J(qa, dqa, qc, f, c, e):
        ps = JP.initial_state(pj, qa)._replace(dq_act=dqa)
        ps = JP.servo_step(pj, ps, qc, 0.002)
        q_m, dq_m, ps = JP.read_joints(pj, ps)
        zmp, _ = JP.read_zmp(pj, ps, f, c, c.mean(axis=1))
        return q_m, dq_m, ps.q_act, ps.dq_act, zmp, JP.deadband_wrench(e, 2 * e, 55.0)

    def T(qa, dqa, qc, f, c, e):
        ps = TP.initial_state(pt, qa)._replace(dq_act=dqa)
        ps = TP.servo_step(pt, ps, qc, 0.002)
        q_m, dq_m, ps = TP.read_joints(pt, ps)
        zmp, _ = TP.read_zmp(pt, ps, f, c, c.mean(dim=2))
        return q_m, dq_m, ps.q_act, ps.dq_act, zmp, TP.deadband_wrench(e, 2 * e, 55.0)

    out = run_both(J, T, (q_act, dq_act, q_cmd, forces, corners, push))
    check(out)
    if tau == 0.0:  # the ideal plant realises the command exactly
        np.testing.assert_array_equal(out["f64"][1][0], q_cmd)


def test_plant_noise_statistics():
    """Encoder, velocity and wrench noise: per channel mean ~0 and std ~ the
    configured sigma over many items, as JAX's; the ideal plant draws no
    random number (the generator's state is untouched)."""
    n = 4096
    cfg = TP.PlantConfig(servo_tau=0.0, encoder_noise=0.01, velocity_noise=0.2, wrench_noise=0.5, seed=3)
    q = torch.zeros(n, 26, dtype=torch.float64)
    ps = TP.initial_state(cfg, q)
    q_m, dq_m, ps = TP.read_joints(cfg, ps)
    f0 = torch.zeros(n, 2, 4, 3, dtype=torch.float64)
    f0[..., 2] = 2.0
    corners = torch.zeros_like(f0)
    corners[..., 0] = torch.tensor([0.1, 0.1, -0.1, -0.1], dtype=torch.float64)
    zmp, ps = TP.read_zmp(cfg, ps, f0, corners, corners.mean(dim=2))
    jcfg = JP.PlantConfig(servo_tau=0.0, encoder_noise=0.01, velocity_noise=0.2, wrench_noise=0.5, seed=3)
    with jax.enable_x64(True):
        keys = jax.random.split(jax.random.PRNGKey(7), n)
        jq, jdq, _ = jax.vmap(lambda k: JP.read_joints(jcfg, JP.initial_state(jcfg, jnp.zeros(26))._replace(rng=k)))(keys)
        jz = jax.vmap(lambda k: JP.read_zmp(jcfg, JP.initial_state(jcfg, jnp.zeros(26))._replace(rng=k),
                                            jnp.asarray(f0[0].numpy()), jnp.asarray(corners[0].numpy()),
                                            jnp.asarray(corners[0].numpy()).mean(axis=1))[0])(keys)
    for name, got, want, sigma in (("q", q_m.numpy(), np.asarray(jq), 0.01), ("dq", dq_m.numpy(), np.asarray(jdq), 0.2)):
        for x in (got, want):
            assert np.abs(x.mean(0)).max() < 5 * sigma / np.sqrt(n), name
            np.testing.assert_allclose(x.std(0), sigma, rtol=0.1, err_msg=name)
    # the sensed ZMP: the same spread in both packages
    np.testing.assert_allclose(zmp.numpy()[:, :2].std(0), np.asarray(jz)[:, :2].std(0), rtol=0.1)
    np.testing.assert_allclose(zmp.numpy()[:, :2].mean(0), np.asarray(jz)[:, :2].mean(0), atol=3e-3)
    ideal = TP.PlantConfig()
    ps0 = TP.initial_state(ideal, q)
    before = ps0.rng.get_state().clone()
    out = TP.read_joints(ideal, ps0)
    TP.read_zmp(ideal, ps0, f0, corners, corners.mean(dim=2))
    assert out[0] is q and torch.equal(ps0.rng.get_state(), before)

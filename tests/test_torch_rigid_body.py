"""Port parity for the rigid-body plant (`cmw_tpu_torch.sim.rigid_body`)
against `cmw_tpu.sim.rigid_body`, and the port's own copies of the four
physics checks of tests/test_rigid_body.py.

Parity: both models (the URDF and the built-in approximation), B = 2 items
at random poses and velocities from a numpy seed, each item with its own
plant parameters (contact_mu, servo_kp, contact_kp); JAX under jit of its
vmap in float64 (enable_x64). The mass matrix, the bias forces, the corner
points and Jacobians, one dynamics step (with a push), a 10-tick settle and
reset_anchors within F64_TOL of max(1, |value|), the active corners
identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_tpu.core import kinematics as JK
from cmw_tpu.sim import rigid_body as JRB
from cmw_tpu_torch import convert
from cmw_tpu_torch.core import kinematics as TK
from cmw_tpu_torch.core.centroidal import GRAVITY
from cmw_tpu_torch.sim import rigid_body as TRB

torch.set_num_threads(2)

B = 2
F64_TOL = 1e-9
DT = 0.002
MODELS = {"urdf": JK.ergocub_urdf, "approx": JK.ergocub_approx}
# per-item plant parameters: item 0 the defaults, item 1 another plant
PARAMS = {"contact_mu": (0.8, 0.5), "servo_kp": (3000.0, 2200.0), "contact_kp": (6.0e4, 4.5e4)}


def f64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    assert np.abs(got - want).max(initial=0.0) <= F64_TOL * scale, (name, float(np.abs(got - want).max()))


def close_state(got: TRB.RigidBodyState, want, name):
    for f in TRB.RigidBodyState._fields:
        if f == "params":
            for p in TRB.RigidDynParams._fields:
                close(getattr(got.params, p).numpy(), getattr(want.params, p), f"{name}.params.{p}")
        else:
            close(getattr(got, f).numpy(), getattr(want, f), f"{name}.{f}")


@pytest.fixture(scope="module", params=list(MODELS))
def rig(request):
    """Both packages' models, B random configurations, and the standing
    spawn (the walk-ready crouch, soles 2 mm into the ground) as both
    packages' plant states, with the per-item parameters."""
    jm = MODELS[request.param]()
    tm = convert.robot_model_from_numpy(jm)
    rng = np.random.default_rng(5)
    nj = jm.nj
    q = rng.uniform(-0.3, 0.3, (B, nj))
    w = rng.normal(size=(B, 3)) * 0.2
    R = np.stack([JK_exp(v) for v in w])
    p = rng.normal(size=(B, 3)) * 0.1 + [0.0, 0.0, 0.7]
    nu = rng.normal(size=(B, 6 + nj)) * 0.5
    q0, R0 = JK.walk_ready_pose()
    lR, lp = JK.fk(jm, jnp.asarray(q0), jnp.asarray(R0), jnp.zeros(3))
    _, fp = JK.frame_poses(jm, lR, lp)
    z = -min(float(fp[jm.frame_index("l_sole"), 2]), float(fp[jm.frame_index("r_sole"), 2])) - 0.002
    spawn = (np.stack([q0] * B), np.stack([R0] * B), np.array([[0.0, 0.0, z]] * B))
    cfg = JRB.RigidBodyConfig()
    with jax.enable_x64(True):
        js = jax.jit(jax.vmap(lambda a, b, c: JRB.initial_state(jm, a, b, c, cfg)))(*spawn)
        js = js._replace(params=js.params._replace(**{k: jnp.asarray(v) for k, v in PARAMS.items()}))
    ts = TRB.initial_state(tm, *spawn, TRB.RigidBodyConfig(), device="cpu", dtype=torch.float64)
    ts = ts._replace(params=ts.params._replace(**{k: f64(v) for k, v in PARAMS.items()}))
    return dict(jm=jm, tm=tm, cfg=cfg, q=q, R=R, p=p, nu=nu, spawn=spawn, js=js, ts=ts, q_cmd=spawn[0] + 0.02)


def JK_exp(w):
    """Rodrigues' formula in numpy (a random base attitude)."""
    th = np.linalg.norm(w)
    W = np.cross(np.eye(3), w / th)
    return np.eye(3) + np.sin(th) * W + (1 - np.cos(th)) * W @ W


def test_initial_state_matches_jax(rig):
    """The spawn's state: corner anchors at the corners' world positions, zero
    velocities, forces and servo integrals, the parameters from the config."""
    close_state(rig["ts"], rig["js"], "initial_state")
    defaults = TRB.dyn_params(TRB.RigidBodyConfig(), B, device="cpu")
    for f in TRB.RigidDynParams._fields:
        assert getattr(defaults, f).shape == (B,) and getattr(defaults, f).device.type == "cpu"
        assert float(getattr(defaults, f)[0]) == pytest.approx(getattr(rig["cfg"], f), rel=1e-6)


def test_mass_matrix_bias_forces_and_corners_match_jax(rig):
    """mass_matrix (with the armature), bias_forces (the torch.func jvp and
    grads through FK and M(x)) and corner_points_jacobians at B random
    configurations, within F64_TOL."""
    jm, tm, cfg = rig["jm"], rig["tm"], rig["cfg"]
    q, R, p, nu = rig["q"], rig["R"], rig["p"], rig["nu"]
    cl = JRB.default_corners(2)

    def jax_calls(q, R, p, nu):
        lR, lp = JK.fk(jm, q, R, p)
        return (JRB.mass_matrix(jm, lR, lp, cfg.armature), JRB.bias_forces(cfg, jm, R, p, q, nu),
                JRB.corner_points_jacobians(jm, lR, lp, ("l_sole", "r_sole"), jnp.asarray(cl)))

    with jax.enable_x64(True):
        M, b, (pts, J) = jax.jit(jax.vmap(jax_calls))(q, R, p, nu)
    lR, lp = TK.fk(tm, f64(q), f64(R), f64(p))
    close(TRB.mass_matrix(tm, lR, lp, cfg.armature).numpy(), M, "mass_matrix")
    close(TRB.bias_forces(TRB.RigidBodyConfig(), tm, f64(R), f64(p), f64(q), f64(nu)).numpy(), b, "bias_forces")
    tp, tJ = TRB.corner_points_jacobians(tm, lR, lp, ("l_sole", "r_sole"), f64(cl))
    close(tp.numpy(), pts, "corner points")
    close(tJ.numpy(), J, "corner Jacobians")
    assert tp.shape == (B, 2, 4, 3) and tJ.shape == (B, 2, 4, 3, 6 + tm.nj)


def test_dynamics_step_matches_jax(rig):
    """One control tick (2 substeps) from the standing spawn with a servo
    offset and a push on the base of item 1, within F64_TOL; the corners in
    contact identical."""
    jm, tm, cfg = rig["jm"], rig["tm"], rig["cfg"]
    push = np.array([[0.0, 0.0, 0.0], [40.0, -25.0, 0.0]])
    with jax.enable_x64(True):
        want = jax.jit(jax.vmap(lambda s, qc, f: JRB.dynamics_step(cfg, jm, s, qc, DT, ext_force_base=f)))(
            rig["js"], rig["q_cmd"], push)
    got = TRB.dynamics_step(TRB.RigidBodyConfig(), tm, rig["ts"], f64(rig["q_cmd"]), DT, ext_force_base=f64(push))
    close_state(got, want, "dynamics_step")
    np.testing.assert_array_equal(got.corner_forces[..., 2].numpy() > 0, np.asarray(want.corner_forces)[..., 2] > 0)
    assert (got.corner_forces[..., 2] > 0).any()


def test_settle_and_reset_anchors_match_jax(rig):
    """A 10-tick settle holding q_cmd, then reset_anchors, within F64_TOL;
    the corners in contact identical."""
    jm, tm, cfg = rig["jm"], rig["tm"], rig["cfg"]

    def jax_settle(s, qc):
        s = JRB.settle(cfg, jm, s, qc, DT, 10)
        return s, JRB.reset_anchors(jm, s)

    with jax.enable_x64(True):
        want, want_reset = jax.jit(jax.vmap(jax_settle))(rig["js"], rig["q_cmd"])
    got = TRB.settle(TRB.RigidBodyConfig(), tm, rig["ts"], f64(rig["q_cmd"]), DT, 10)
    close_state(got, want, "settle")
    np.testing.assert_array_equal(got.corner_forces[..., 2].numpy() > 0, np.asarray(want.corner_forces)[..., 2] > 0)
    reset = TRB.reset_anchors(tm, got)
    close_state(reset, want_reset, "reset_anchors")
    assert np.abs(reset.anchors.numpy() - got.anchors.numpy()).max() > 0  # the settle moved the corners


# --- the port's own copies of tests/test_rigid_body.py (f32, as there) ---------

PASSIVE = TRB.RigidBodyConfig(substeps=1, servo_kp=0.0, servo_kd=0.0, servo_ki=0.0, joint_damping=0.0, armature=0.0)


@pytest.fixture(scope="module")
def approx():
    return TK.ergocub_approx()


def _posed(model, seed=0, base_z=1.2):
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.uniform(-0.3, 0.3, model.nj), dtype=torch.float32)[None]
    return q, torch.eye(3)[None], torch.tensor([[0.0, 0.0, base_z]])


def _com_velocity(model, s):
    lR, lp = TK.fk(model, s.q, s.base_rot, s.base_pos)
    return TK.centroidal_momentum(model, lR, lp, s.nu)[0, 0:3].double().numpy() / model.total_mass


def test_mass_matrix_spd_and_momentum_consistency(approx):
    """M is symmetric (atol 1e-3) and positive definite, and its first 6 rows
    times nu reproduce the centroidal momentum map: linear momentum, and the
    angular momentum shifted from the CoM to the base origin (rtol and atol
    2e-4, f32)."""
    q, R, p = _posed(approx)
    lR, lp = TK.fk(approx, q, R, p)
    M = TRB.mass_matrix(approx, lR, lp)[0].double().numpy()
    assert np.allclose(M, M.T, atol=1e-3)
    assert np.all(np.linalg.eigvalsh(M) > 0)
    nu = torch.as_tensor(np.random.default_rng(1).normal(size=6 + approx.nj), dtype=torch.float32)[None]
    h = TK.centroidal_momentum(approx, lR, lp, nu)[0].double().numpy()
    Mnu = M @ nu[0].double().numpy()
    np.testing.assert_allclose(Mnu[0:3], h[0:3], rtol=2e-4, atol=2e-4)
    com = TK.com(approx, lR, lp)[0].double().numpy()
    L_base = h[3:6] + np.cross(com - p[0].double().numpy(), h[0:3])
    np.testing.assert_allclose(Mnu[3:6], L_base, rtol=2e-4, atol=2e-4)


def test_free_fall_com_acceleration(approx):
    """Airborne and unactuated, the CoM accelerates at -g: the first
    difference of its velocity over 20 steps of 1 ms within rtol 2e-2 in z
    and atol 0.2 m/s^2 in x and y."""
    q, R, p = _posed(approx, base_z=5.0)
    s = TRB.initial_state(approx, q, R, p, PASSIVE, device="cpu")
    s = s._replace(nu=torch.as_tensor(0.3 * np.random.default_rng(2).normal(size=6 + approx.nj),
                                      dtype=torch.float32)[None])
    vs = [_com_velocity(approx, s)]
    for _ in range(20):
        s = TRB.dynamics_step(PASSIVE, approx, s, s.q * 0.0, 1e-3)
        vs.append(_com_velocity(approx, s))
    acc = np.diff(np.stack(vs), axis=0) / 1e-3
    np.testing.assert_allclose(acc[:, 2], -GRAVITY, rtol=2e-2)
    np.testing.assert_allclose(acc[:, 0:2], 0.0, atol=0.2)


def test_passive_energy_conservation(approx):
    """No contact, actuation or damping: E = T + V drifts less than 1 % over
    0.1 s (200 steps of 0.5 ms) of tumbling."""
    q, R, p = _posed(approx, base_z=5.0)
    s = TRB.initial_state(approx, q, R, p, PASSIVE, device="cpu")
    s = s._replace(nu=torch.as_tensor(0.5 * np.random.default_rng(3).normal(size=6 + approx.nj),
                                      dtype=torch.float32)[None])
    mt = approx.tensors("cpu", torch.float32)

    def energy(st):
        lR, lp = TK.fk(approx, st.q, st.base_rot, st.base_pos)
        M = TRB.mass_matrix(approx, lR, lp)
        T = 0.5 * float(st.nu[0] @ (M[0] @ st.nu[0]))
        cw = lp + torch.einsum("...lij,lj->...li", lR, mt.link_com)
        return T + GRAVITY * float(cw[0, :, 2] @ mt.link_mass)

    e0 = energy(s)
    for _ in range(200):
        s = TRB.dynamics_step(PASSIVE, approx, s, s.q * 0.0, 5e-4)
    e1 = energy(s)
    assert abs(e1 - e0) / abs(e0) < 0.01, (e0, e1)


def test_standing_equilibrium(approx):
    """Feet on the ground, the servos holding the zero pose: after 0.5 s the
    robot stands: finite, the base within 2 cm of its spawn height and in xy,
    its rotation within 0.05 of the identity, total corner fz within 10 % of
    m g, and every velocity below 0.5."""
    q0 = torch.zeros(1, approx.nj)
    R = torch.eye(3)[None]
    _, fp = TK.frame_poses(approx, *TK.fk(approx, q0, R, torch.zeros(1, 3)))
    base_pos = torch.tensor([[0.0, 0.0, -float(fp[0, approx.frame_index("l_sole"), 2])]])
    cfg = TRB.RigidBodyConfig()
    s = TRB.initial_state(approx, q0, R, base_pos, cfg, device="cpu")
    s = TRB.settle(cfg, approx, s, q0, 2e-3, 250)
    assert bool(torch.isfinite(s.nu).all())
    assert abs(float(s.base_pos[0, 2]) - float(base_pos[0, 2])) < 0.02
    assert float(s.base_pos[0, 0:2].abs().max()) < 0.02
    assert float((s.base_rot[0] - torch.eye(3)).abs().max()) < 0.05
    mg = approx.total_mass * GRAVITY
    assert abs(float(s.corner_forces[..., 2].sum()) - mg) / mg < 0.1
    assert float(s.nu.abs().max()) < 0.5


def test_rigid_body_entry_points_default_to_the_card(rig):
    """initial_state and dyn_params default to the card: without one they
    raise rather than fall back to the CPU."""
    cfg = TRB.RigidBodyConfig()
    calls = (lambda: TRB.dyn_params(cfg, B), lambda: TRB.initial_state(rig["tm"], *rig["spawn"], cfg))
    for call in calls:
        if torch.cuda.is_available():
            out = call()
            assert all(t.device.type == "cuda" for t in jax.tree_util.tree_leaves(out) if isinstance(t, torch.Tensor))
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rig["cfg"])  # the same fields and defaults as JAX's

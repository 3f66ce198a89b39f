"""Port parity for `cmw_tpu_torch.core.kinematics` vs `cmw_tpu.core.kinematics`:
the host-side models (URDF reduction, the built-in approximation, the
walk-ready pose) array for array, and every device function at random
configurations of both models, batched in the port against `jax.vmap`, in
float64 (JAX under enable_x64) and float32."""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_tpu.core import kinematics as JK
from cmw_tpu_torch import convert
from cmw_tpu_torch.core import kinematics as TK
from cmw_tpu_torch.core import lie as tlie

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = {"urdf": (JK.ergocub_urdf, TK.ergocub_urdf), "approx": (JK.ergocub_approx, TK.ergocub_approx)}
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
TOL = {"f64": 1e-12, "f32": 1e-5}  # of max(1, |value|)
FUNCS = ["fk", "frame_poses", "com", "joint_world_axes", "frame_jacobian", "com_jacobian", "link_com_jacobians",
         "centroidal_momentum_matrix", "centroidal_momentum"]
B = 4


def _configs(nj, seed=0):
    """B configurations: the walk-ready crouch and random ones, random base
    poses, random velocities nu."""
    rng = np.random.default_rng(seed)
    q = np.concatenate([JK.walk_ready_pose()[0][None], rng.uniform(-1.0, 1.0, (B - 1, nj))])
    w = rng.standard_normal((B, 3))
    th = np.linalg.norm(w, axis=-1)[:, None, None]
    W = np.cross(np.eye(3)[None], (w / th[..., 0])[:, None, :])  # hat(w / |w|)
    R = np.eye(3) + np.sin(th) * W + (1 - np.cos(th)) * W @ W
    p = rng.standard_normal((B, 3))
    nu = rng.standard_normal((B, 6 + nj))
    return q, R, p, nu


def _calls(K, model, q, R, p, nu):
    """{name: outputs} of every device function of module K on one item (or,
    for the port, the batch)."""
    lR, lp = K.fk(model, q, R, p)
    return {
        "fk": (lR, lp),
        "frame_poses": K.frame_poses(model, lR, lp),
        "com": K.com(model, lR, lp),
        "joint_world_axes": K.joint_world_axes(model, lR, lp),
        "frame_jacobian": tuple(K.frame_jacobian(model, lR, lp, f) for f in range(len(model.frame_names))),
        "com_jacobian": K.com_jacobian(model, lR, lp),
        "link_com_jacobians": K.link_com_jacobians(model, lR, lp),
        "centroidal_momentum_matrix": K.centroidal_momentum_matrix(model, lR, lp),
        "centroidal_momentum": K.centroidal_momentum(model, lR, lp, nu),
    }


@pytest.fixture(scope="module")
def results():
    """{(model, dtype): (JAX outputs, port outputs)}: JAX in one jit of the
    vmapped calls per case."""
    out = {}
    for mname, (jmake, _) in MODELS.items():
        jm = jmake()
        tm = convert.robot_model_from_numpy(jm)
        args = _configs(jm.nj)
        for dt, (jd, td) in DTYPES.items():
            with jax.enable_x64(dt == "f64"):
                fn = jax.jit(jax.vmap(lambda *a: _calls(JK, jm, *a)))
                want = jax.tree_util.tree_map(np.asarray, fn(*(jnp.asarray(a, jd) for a in args)))
            got = _calls(TK, tm, *(torch.tensor(a, dtype=td) for a in args))
            out[(mname, dt)] = (want, got)
    return out


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("mname", list(MODELS))
@pytest.mark.parametrize("name", FUNCS)
def test_kinematics_matches_jax(results, name, mname, dt):
    want, got = results[(mname, dt)]
    w_leaves = jax.tree_util.tree_leaves(want[name])
    g_leaves = jax.tree_util.tree_leaves(got[name])
    assert len(w_leaves) == len(g_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert g.dtype == DTYPES[dt][1] and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL[dt] * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("mname", list(MODELS))
def test_momentum_matrix_times_velocity_is_the_momentum(results, mname):
    """h = A_h nu, in the port (f64)."""
    _, got = results[(mname, "f64")]
    nu = torch.tensor(_configs(MODELS[mname][0]().nj)[3])
    h = (got["centroidal_momentum_matrix"] @ nu[..., None])[..., 0]
    np.testing.assert_allclose(h.numpy(), got["centroidal_momentum"].numpy(), atol=1e-11)


@pytest.mark.parametrize("mname", list(MODELS))
def test_host_models_match_jax(mname):
    """Every field of the port's model equals the JAX package's, read from its
    own copy of the URDF (or built by its own ergocub_approx)."""
    jmake, tmake = MODELS[mname]
    jm, tm = jmake(), tmake()
    for f in ("joint_names", "frame_names"):
        assert getattr(tm, f) == getattr(jm, f)
    for f in ("parent", "axis", "origin_pos", "origin_rot", "link_mass", "link_com", "link_inertia", "frame_link",
              "frame_pos", "frame_rot", "q_lim", "qd_lim"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f), err_msg=f)
    assert tm.total_mass == jm.total_mass and tm.nj == jm.nj == 26
    assert tm.frame_index("r_sole") == jm.frame_index("r_sole")
    assert tm.joint_index("l_knee") == jm.joint_index("l_knee")


def test_urdf_copy_and_poses_match_jax():
    """The port ships a byte-identical URDF; the walk-ready constants agree."""
    assert filecmp.cmp(os.path.join(ROOT, "cmw_tpu", "models", "ergocub.urdf"),
                       os.path.join(ROOT, "cmw_tpu_torch", "models", "ergocub.urdf"), shallow=False)
    for a, b in zip(TK.walk_ready_pose(), JK.walk_ready_pose()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TK.reference_initial_pose(), JK.reference_initial_pose())
    assert TK.CROUCH_BASE_PITCH == JK.CROUCH_BASE_PITCH and TK.ERGOCUB_JOINTS == JK.ERGOCUB_JOINTS


def test_model_tensors_are_made_once():
    """The constant tensors are made once per (device, dtype) and reused."""
    tm = TK.ergocub_approx()
    a = tm.tensors("cpu", torch.float32)
    assert tm.tensors(torch.device("cpu"), torch.float32) is a
    assert tm.tensors("cpu", torch.float64) is not a and tm.tensors("cpu", torch.float64).axis.dtype == torch.float64
    q = torch.zeros(2, tm.nj)
    R = tlie.so3_exp(torch.zeros(2, 3))
    TK.fk(tm, q, R, torch.zeros(3))  # an unbatched base broadcasts against the batch
    assert tm.tensors("cpu", torch.float32) is a

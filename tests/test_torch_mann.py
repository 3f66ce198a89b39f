"""Port parity for `cmw_tpu_torch.mann` vs `cmw_tpu.mann`: the network at the
published mann4 shapes, the ONNX loader of both packages on a small ONNX
file encoded here, the joystick input builder, and the 40-step generator
rollout, batched in the port against `jax.vmap`, in float64 (JAX under
enable_x64) and float32.

The shipped ONNX weights are not in the repository; the network runs on the
synthetic weights of `chip_smoke.synthetic_mann_numpy` (walk-ready joints in
the output bias, a slow forward base motion), and on a variant that lifts
the left foot, so that the Schmitt trigger switches and a foot swings."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import lifted, mann_onnx_bytes, synthetic_mann_numpy
from cmw_tpu.core import kinematics as JK
from cmw_tpu.mann import generator as JG
from cmw_tpu.mann import input_builder as JIB
from cmw_tpu.mann import network as JN
from cmw_tpu_torch import convert
from cmw_tpu_torch.mann import generator as TG
from cmw_tpu_torch.mann import input_builder as TIB
from cmw_tpu_torch.mann import network as TN

torch.set_num_threads(2)

DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
GEN_F64_TOL = 1e-9
# f32: the port against JAX within this multiple of JAX's own f32-vs-f64 gap
# on the same rollout, per channel (plus 4 ulps of the channel's scale)
F32_GAP_MULT = 4.0
# four items: forward, a sideways stick facing left, backwards facing right,
# and a forward walk from a state with the left foot just off (a timer
# running), which the trigger turns on again
STICKS = np.array([[0.8, 0.0, 1.0, 0.0], [0.3, 0.9, -0.2, 1.0], [-0.7, -0.2, 0.5, -1.0], [0.5, 0.0, 1.0, 0.0]])
CHANNELS = ("com", "ang_mom", "joints", "base_xy_yaw", "base_height", "foot_pose_xy_yaw")


WEIGHTS = {"walk": synthetic_mann_numpy(), "lift": lifted(synthetic_mann_numpy())}


def _jax_weights(W, jd):
    return JN.MANNWeights(**jax.tree_util.tree_map(lambda a: jnp.asarray(a, jd), W))


@pytest.fixture(scope="module")
def model():
    jm = JK.ergocub_urdf()
    return jm, convert.robot_model_from_numpy(jm)


def _start_flags(n):
    """(contact, timer) [n, 2] of the start: item 3 with its left foot off and
    half its switch-on time elapsed."""
    contact, timer = np.ones((n, 2)), np.zeros((n, 2))
    contact[3, 0], timer[3, 0] = 0.0, 0.02
    return contact, timer


@pytest.fixture(scope="module")
def rollouts(model):
    """{(weights, dtype): (JAX (start, outs, states), port (start, outs,
    states))}: the initial state at the walk-ready pose, the desired
    trajectories and 40 steps; JAX in one jit per dtype, the weights an
    argument."""
    jm, tm = model
    cfg = JG.GeneratorConfig()
    q0 = np.stack([JK.walk_ready_pose()[0]] * len(STICKS))
    contact, timer = _start_flags(len(STICKS))

    def jax_rollout(w, q, c, tm_, stick):
        s = JG.initial_state(cfg, jm, q)._replace(contact=c, contact_timer=tm_)
        desired = JIB.build_desired_trajectory(stick[:2], stick[2:])
        return (s,) + JG.generate_with_states(cfg, jm, w, s, desired)[1:]

    out = {}
    for dt, (jd, td) in DTYPES.items():
        with jax.enable_x64(dt == "f64"):
            gen = jax.jit(jax.vmap(jax_rollout, in_axes=(None, 0, 0, 0, 0)))
            args = [jnp.asarray(a, jd) for a in (q0, contact, timer, STICKS)]
            for wname, W in WEIGHTS.items():
                want = jax.tree_util.tree_map(np.asarray, gen(_jax_weights(W, jd), *args))
                start = TG.initial_state(TG.GeneratorConfig(), tm, torch.tensor(q0, dtype=td))
                start = start._replace(contact=torch.tensor(contact, dtype=td), contact_timer=torch.tensor(timer, dtype=td))
                tdes = TIB.build_desired_trajectory(torch.tensor(STICKS[:, :2], dtype=td),
                                                    torch.tensor(STICKS[:, 2:], dtype=td))
                tw = convert.mann_weights_from_numpy(W, device="cpu", dtype=td)
                got = (start,) + TG.generate_with_states(TG.GeneratorConfig(), tm, tw, start, tdes)[1:]
                out[(wname, dt)] = (want, got)
    return out


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("wname", list(WEIGHTS))
def test_generator_matches_jax(rollouts, wname, dt):
    """40 steps: contact flags identical; f64 within 1e-9 on every channel and
    every post-step state; f32 within F32_GAP_MULT x JAX's own f32-vs-f64
    gap."""
    (w_start, w_outs, w_states), (g_start, g_outs, g_states) = rollouts[(wname, dt)]
    for name, g, w in zip(w_start._fields, g_start, w_start):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GEN_F64_TOL if dt == "f64" else 1e-6, err_msg=name)
    np.testing.assert_array_equal(g_outs.contact.numpy(), w_outs.contact)
    np.testing.assert_array_equal(g_states.contact.numpy(), w_states.contact)
    if wname == "lift":  # the trigger switched: the left foot swings after two steps
        assert w_outs.contact[0, 1:, 0].max() == 0.0 and w_outs.contact[:, :, 1].min() == 1.0
    else:
        assert w_outs.contact[:, 1:].min() == 1.0  # double support once item 3's foot is down
    if dt == "f64":
        for name, g, w in zip(w_outs._fields + w_states._fields, list(g_outs) + list(g_states),
                              list(w_outs) + list(w_states)):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GEN_F64_TOL, err_msg=name)
        return
    (_, ref64, _), _ = rollouts[(wname, "f64")]
    for name in CHANNELS:
        w, g, w64 = getattr(w_outs, name), getattr(g_outs, name).numpy(), getattr(ref64, name)
        gap = np.abs(w.astype(np.float64) - w64).max()
        tol = F32_GAP_MULT * gap + 4 * np.finfo(np.float32).eps * max(1.0, np.abs(w64).max())
        assert np.abs(g.astype(np.float64) - w).max() <= tol, (name, np.abs(g - w).max(), gap)


def test_rerooting_reproduces_the_suffix(rollouts, model):
    """Restarting from the state after step k reproduces the rollout's steps
    k + 1, ... (the merge-point mechanism): the port, bitwise."""
    _, tm = model
    _, (_, outs, states) = rollouts[("lift", "f64")]
    k = 3
    restart = TG.GeneratorState(*(a[:, k - 1] for a in states))
    tdes = TIB.build_desired_trajectory(torch.tensor(STICKS[:, :2]), torch.tensor(STICKS[:, 2:]))
    tw = convert.mann_weights_from_numpy(WEIGHTS["lift"], device="cpu", dtype=torch.float64)
    _, again = TG.generate(TG.GeneratorConfig(), tm, tw, restart, tdes)
    S = outs.com.shape[1]
    for name, a, b in zip(outs._fields, again, outs):
        torch.testing.assert_close(a[:, : S - k], b[:, k:], rtol=0, atol=0, msg=name)


def test_generator_config_matches_jax():
    assert dataclasses.asdict(TG.GeneratorConfig()) == dataclasses.asdict(JG.GeneratorConfig())
    assert TG.GeneratorConfig().n_steps == 40 and TG._hist_len(TG.GeneratorConfig()) == 48
    assert dataclasses.asdict(TIB.InputBuilderConfig()) == dataclasses.asdict(JIB.InputBuilderConfig())


@pytest.mark.parametrize("dt", list(DTYPES))
def test_forward_matches_jax(dt):
    """The network at the published shapes (124 -> gate 32 -> 32 -> 4, 4
    experts 124 -> 128 -> 128 -> 91), and the inference module."""
    jd, td = DTYPES[dt]
    W = synthetic_mann_numpy(seed=5)
    x = np.random.default_rng(6).standard_normal((5, 124))
    with jax.enable_x64(dt == "f64"):
        want = np.asarray(jax.vmap(lambda v: JN.mann_forward(_jax_weights(W, jd), v))(jnp.asarray(x, jd)))
    tw = convert.mann_weights_from_numpy(W, device="cpu", dtype=td)
    assert [tuple(a.shape) for a in tw.expert_w] == [(4, 128, 124), (4, 128, 128), (4, 91, 128)]
    assert (tw.in_size, tw.out_size) == (124, 91)
    got = TN.mann_forward(tw, torch.tensor(x, dtype=td))
    tol = 1e-12 if dt == "f64" else 2e-6
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * np.abs(want).max())
    net = TN.MANN(tw)
    assert torch.equal(net(torch.tensor(x, dtype=td)), got)
    assert sum(1 for _ in net.buffers()) == 16
    assert all(a is b for a, b in zip(jax.tree_util.tree_leaves(net.weights), jax.tree_util.tree_leaves(tw)))


# --- a small ONNX file, encoded by chip_smoke.mann_onnx_bytes ----------------


def _small_weights(seed=7, n_in=6, n_g=5, E=3, n_h=4, n_out=3):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return dict(w_in=r(n_in, n_in), b_in=r(n_in), gate_w=(r(n_g, n_in), r(n_g, n_g), r(E, n_g)),
                gate_b=(r(n_g), r(n_g), r(E)), expert_w=(r(E, n_h, n_in), r(E, n_h, n_h), r(E, n_out, n_h)),
                expert_b=(r(E, n_h), r(E, n_h), r(E, n_out)), w_out=r(n_out, n_out), b_out=r(n_out))


def test_onnx_loader_matches_jax(tmp_path):
    """Both packages' loaders read the same small ONNX file to the same
    arrays (raw and packed float data, plain and packed dims), and the two
    forwards agree on it."""
    W = _small_weights()
    path = tmp_path / "mann_small.onnx"
    path.write_bytes(mann_onnx_bytes(W))
    jw = JN.load_mann_weights(str(path))
    tw = TN.load_mann_weights(str(path), device="cpu")
    for name, j, t in zip(jw._fields, jax.tree_util.tree_leaves(tuple(jw)), jax.tree_util.tree_leaves(tuple(tw))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for name in jw._fields:
        for j, w in zip(jax.tree_util.tree_leaves(getattr(jw, name)), jax.tree_util.tree_leaves(W[name])):
            np.testing.assert_array_equal(np.asarray(j), w, err_msg=name)
    x = np.random.default_rng(8).standard_normal((4, 6)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda v: JN.mann_forward(jw, v))(jnp.asarray(x)))
    np.testing.assert_allclose(TN.mann_forward(tw, torch.tensor(x)).numpy(), want, rtol=2e-6, atol=2e-6)
    assert TN.load_mann_weights(str(path), device="cpu", dtype=torch.float64).w_in.dtype == torch.float64


@pytest.mark.parametrize("dt", list(DTYPES))
def test_input_builder_matches_jax(dt):
    """Motion sticks in all four quadrants, along each axis, beyond the unit
    circle, below the 1e-3 dead zone and zero; facing sticks in all four
    quadrants and zero."""
    jd, td = DTYPES[dt]
    motion = np.array([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0], [0.7, 0.7], [-0.5, 0.6], [-0.5, -0.6],
                       [0.6, -0.5], [2.0, 1.0], [5e-4, 0.0], [0.0, 0.0], [0.3, 0.1]])
    facing = np.array([[1.0, 0.0], [0.3, 1.0], [-1.0, 0.2], [0.5, -1.0], [-0.4, -0.4], [1.0, 1.0], [0.2, -0.3],
                       [-1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.0, 0.0], [0.0, 0.0]])
    with jax.enable_x64(dt == "f64"):
        want = jax.vmap(JIB.build_desired_trajectory)(jnp.asarray(motion, jd), jnp.asarray(facing, jd))
    got = TIB.build_desired_trajectory(torch.tensor(motion, dtype=td), torch.tensor(facing, dtype=td))
    tol = 1e-14 if dt == "f64" else 1e-7  # jnp.linspace's knot times in f32: an ulp
    for name, g, w in zip(want._fields, got, want):
        assert g.dtype == td and tuple(g.shape) == (12, 7, 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol, err_msg=name)
    assert float(got.velocities[10].abs().max()) == 0.0 and got.facing[10, 0].tolist() == [1.0, 0.0]

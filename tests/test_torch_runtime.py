"""Port parity for the closed-loop walking controller on the kinematic plant
(`cmw_tpu_torch.runtime`) against `cmw_tpu.runtime.loop`, in float64 (JAX
under enable_x64; float32 for the initial state), at
ergocub_gazebo_v1(mpc=ergocub_mpc_config(horizon=0.6)) on the synthetic
MANN weights whose left foot swings (`chip_smoke.lifted`):

  - the initial state and the polished initial pose;
  - one `_wbc_stage` and one `_mpc_stage` from the same states, converted
    from a JAX episode at double-support and left-swing ticks;
  - a 35-tick episode at B = 2 (MPC ticks 0 and 30), tick by tick.

JAX runs each stage in one jit of its vmap (module fixture). f64 within
F64_TOL of max(1, |value|); contact flags and fixed-foot indices identical;
f32 within F32_GAP_MULT times JAX's own f32-vs-f64 gap."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cmw_tpu.cmpc import formulation as JF
from cmw_tpu.core import kinematics as JK
from cmw_tpu.mann import network as JN
from cmw_tpu.runtime import config as JCfg
from cmw_tpu.runtime import loop as JL
from cmw_tpu.sim import plant as JP
from cmw_tpu.wbc import diff_ik as Jik
from cmw_tpu_torch import convert
from cmw_tpu_torch.runtime import config as TCfg
from cmw_tpu_torch.runtime import loop as TL
from cmw_tpu_torch.sim import plant as TP

torch.set_num_threads(2)

B = 2
HORIZON = 0.6
F64_TOL = 1e-9
F32_GAP_MULT = 4.0
W_LIFT = chip_smoke.lifted(chip_smoke.synthetic_mann_numpy())
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
EPISODE = 41  # JAX ticks recorded: two MPC periods' starts (0, 30) and 11 ticks of the second
FLAGS = ("foot_contact", "fixed_foot_idx")  # held exactly


def jax_weights(W, jd):
    return JN.MANNWeights(**jax.tree_util.tree_map(lambda a: jnp.asarray(a, jd), W))


def controllers(wcfg_kw=None, W=W_LIFT):
    """{dtype: (JAX controller, port controller)} on the CPU with the same
    config and weights; JAX's is built under its dtype's x64 mode."""
    jm = JK.ergocub_urdf()
    tm = convert.robot_model_from_numpy(jm)
    out = {}
    for dt, (jd, td) in DTYPES.items():
        with jax.enable_x64(dt == "f64"):
            jcfg = (wcfg_kw or {}).get("jax") or JCfg.ergocub_gazebo_v1(mpc=JF.ergocub_mpc_config(horizon=HORIZON))
            jctl = JL.WalkingController(jcfg, jm, jax_weights(W, jd))
        tcfg = (wcfg_kw or {}).get("port") or TCfg.ergocub_gazebo_v1(
            mpc=convert.config_from_dict(dataclasses.asdict(jcfg.mpc)))
        tctl = TL.WalkingController(tcfg, tm, convert.mann_weights_from_numpy(W, device="cpu", dtype=td), device="cpu")
        out[dt] = (jctl, tctl)
    return out


def jax_initial_state(jctl, jd):
    """JAX's (polished pose (q, base_rot) by drop, initial state). Its
    polished_initial_pose runs 60 IK solves and FKs eagerly (~25 s a pose
    on a CPU): it runs here with the same `solve_ik` and `fk` under jit, and
    initial_state, its poses cached, in one jit."""
    jitted = {}

    def jit_with_model(fn, static=None):
        """fn(model, *args) under jit, the model and args[static] held fixed."""
        def call(model, *args):
            fixed = args[static] if static is not None else None
            key = (fn, id(model), fixed)
            if key not in jitted:
                if static is None:
                    jitted[key] = jax.jit(lambda *a: fn(model, *a))
                else:
                    jitted[key] = jax.jit(lambda *a: fn(model, *a[:static], fixed, *a[static:]))
            return jitted[key](*(a for i, a in enumerate(args) if i != static))
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JL, "solve_ik", jit_with_model(Jik.solve_ik, 4))
        mp.setattr(JK, "fk", jit_with_model(JK.fk))
        polish = {drop: jctl.polished_initial_pose(jd, drop) for drop in (0.0, 0.05)}
        return polish, jax.jit(lambda: jctl.initial_state(dtype=jd))()


def to_jax(d, template, batch):
    """Port numpy dict (loop_state_to_numpy) -> a JAX NamedTuple with a batch
    axis; leaves the port does not carry (the rigid-body state, the plant's
    key) are the JAX template's, broadcast."""
    fields = {}
    for name in type(template)._fields:
        t = getattr(template, name)
        if name in d:
            v = d[name]
            fields[name] = to_jax(v, t, batch) if isinstance(v, dict) else jnp.asarray(v, dtype=t.dtype)
        else:
            fields[name] = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (batch,) + a.shape), t)
    return type(template)(**fields)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tick_input(joy, dt):
    """The joystick joy [B, 4] and no push, as the port's and JAX's TickInput."""
    jd, td = DTYPES[dt]
    jinp = JL.TickInput(*(jnp.asarray(a, jd) for a in (joy, np.zeros((len(joy), 3)), np.zeros((len(joy), 3)))))
    return convert.tick_input_from_numpy(np_tree(jinp), device="cpu", dtype=td), jinp


def compare(got: dict, want, tol, path="", skip=()):
    """Every leaf of the port's numpy dict against the JAX tree: exact for
    integer leaves and FLAGS, else within tol * max(1, |want|)."""
    for name, g in got.items():
        if name in skip:
            continue
        w = getattr(want, name) if not isinstance(want, dict) else want[name]
        where = f"{path}.{name}"
        if isinstance(g, dict):
            compare(g, w, tol, where, skip)
            continue
        w = np.asarray(w)
        assert g.shape == w.shape, (where, g.shape, w.shape)
        if g.dtype.kind in "iu" or name in FLAGS:
            np.testing.assert_array_equal(g, w, err_msg=where)
        else:
            scale = max(1.0, float(np.abs(w).max(initial=0.0)))
            assert np.abs(g - w).max(initial=0.0) <= tol * scale, (where, float(np.abs(g - w).max()))


@pytest.fixture(scope="module")
def rig():
    """Controllers, initial states, the JAX f64 stages, and a JAX f64 episode
    of EPISODE ticks from the port's initial state (converted), recording the
    state entering each tick."""
    ctls = controllers()
    joy = chip_smoke.joysticks(B, device="cpu").numpy()
    init = {}
    for dt, (jd, td) in DTYPES.items():
        with jax.enable_x64(dt == "f64"):
            init[dt] = jax_initial_state(ctls[dt][0], jd)
    jctl, tctl = ctls["f64"]
    s0 = tctl.initial_state(B, dtype=torch.float64)
    pre, tels = [], []
    with jax.enable_x64(True):
        tinp, jinp = tick_input(joy, "f64")
        template = init["f64"][1]
        mpc, wbc = jax.jit(jax.vmap(jctl._mpc_stage)), jax.jit(jax.vmap(jctl._wbc_stage))
        js = to_jax(convert.loop_state_to_numpy(s0), template, B)
        for k in range(EPISODE):
            pre.append(np_tree(js))
            if k % jctl.cfg.mpc_every == 0:
                js = mpc(js, jinp)
            js, tel = wbc(js, jinp)
            tels.append(np_tree(tel))
    return dict(ctls=ctls, init=init, s0=s0, tinp=tinp, jinp=jinp, pre=pre, tels=tels, mpc=mpc, wbc=wbc,
                template=template)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_initial_state_matches_jax(rig, dt):
    """initial_state and polished_initial_pose (both drops): f64 within
    F64_TOL; f32 within F32_GAP_MULT x JAX's own f32-vs-f64 gap, the gap at
    least the polish's: the 60 f32 IK iterations end ~3e-6 from the f64 pose
    (JAX eager against JAX jitted: 4.7e-6 apart), one pose by luck nearer,
    and every field of the initial state follows from the poses."""
    _, tctl = rig["ctls"][dt]
    td = DTYPES[dt][1]
    polish, want = (np_tree(x) for x in rig["init"][dt])
    polish64, want64 = (np_tree(x) for x in rig["init"]["f64"])
    polish_gap = max(float(np.abs(np.asarray(polish[d][i], np.float64) - polish64[d][i]).max())
                     for d in (0.0, 0.05) for i in (0, 1))
    got = convert.loop_state_to_numpy(tctl.initial_state(B, dtype=td))
    got = jax.tree_util.tree_map(lambda a: a[0], got)  # the items are identical
    assert tctl.initial_state(B, dtype=td).plant.rng.initial_seed() == tctl.cfg.plant.seed
    pairs = [(f"polish drop={d}.{i}", tctl.polished_initial_pose(td, d)[i].numpy(), polish[d][i], polish64[d][i])
             for d in (0.0, 0.05) for i in (0, 1)]

    def walk(g, w, w64, path):
        for name, v in g.items():
            wv, w64v = getattr(w, name), getattr(w64, name)
            if isinstance(v, dict):
                walk(v, wv, w64v, f"{path}.{name}")
            else:
                pairs.append((f"{path}.{name}", v, np.asarray(wv), np.asarray(w64v)))

    walk(got, want, want64, "")
    for name, g, w, w64 in pairs:
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if g.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        g, w, w64 = (np.asarray(a, np.float64) for a in (g, w, w64))
        scale = max(1.0, np.abs(w64).max(initial=0.0))
        if dt == "f64":
            tol = F64_TOL * scale
        else:
            gap = max(np.abs(w - w64).max(initial=0.0), polish_gap)
            tol = F32_GAP_MULT * gap + 4 * np.finfo(np.float32).eps * scale
        assert np.abs(g - w).max(initial=0.0) <= tol, (name, np.abs(g - w).max(), tol)


@pytest.mark.parametrize("tick", [10, 40])
def test_wbc_stage_matches_jax(rig, tick):
    """One WBC tick from the same converted state of the JAX episode, at a
    double-support tick (10) and a left-swing tick (40): the next state and
    the telemetry within F64_TOL, flags identical."""
    jctl, tctl = rig["ctls"]["f64"]
    state = rig["pre"][tick]
    s = convert.loop_state_from_numpy(state._asdict(), device="cpu", dtype=torch.float64)
    s2, tel = tctl._wbc_stage(s, rig["tinp"])
    with jax.enable_x64(True):
        js2, jtel = np_tree(rig["wbc"](JL.LoopState(*jax.tree_util.tree_map(jnp.asarray, state)), rig["jinp"]))
    compare(convert.solution_to_numpy(tel), jtel, F64_TOL)
    compare(convert.loop_state_to_numpy(s2), js2, F64_TOL)
    left = tel.foot_contact[:, 0].numpy()
    assert (left == 1.0).all() if tick == 10 else (left == 0.0).all()
    assert (tel.fz_act.numpy() == 0).all() and (jtel.fz_act == 0).all() and (jtel.ft_act == 0).all()


def test_wbc_stage_options_match_jax(rig):
    """The WBC stage with the optional paths on: a 10 ms joint-servo lag in
    the plant and the IK's joint-limit box (qp.solve_eq_box_qp), from the
    left-swing state of the JAX episode, within F64_TOL."""
    jctl, tctl = rig["ctls"]["f64"]
    jcfg = dataclasses.replace(jctl.cfg, plant=JP.PlantConfig(servo_tau=0.01), ik_joint_limits=True)
    tcfg = dataclasses.replace(tctl.cfg, plant=TP.PlantConfig(servo_tau=0.01), ik_joint_limits=True)
    jctl2 = JL.WalkingController(jcfg, jctl.model, jctl.weights)
    tctl2 = TL.WalkingController(tcfg, tctl.model, tctl.weights, device="cpu")
    state = rig["pre"][40]
    lag = np.asarray(state.q) + 0.01  # the actual joints behind the command
    state = state._replace(plant=state.plant._replace(q_act=lag))
    s = convert.loop_state_from_numpy(state._asdict(), device="cpu", dtype=torch.float64)
    s2, tel = tctl2._wbc_stage(s, rig["tinp"])
    with jax.enable_x64(True):
        js = JL.LoopState(*jax.tree_util.tree_map(jnp.asarray, state))
        js2, jtel = np_tree(jax.jit(jax.vmap(jctl2._wbc_stage))(js, rig["jinp"]))
    compare(convert.solution_to_numpy(tel), jtel, F64_TOL)
    compare(convert.loop_state_to_numpy(s2), js2, F64_TOL)
    # the box bounds the joint velocities: approach the limits at most at ik_limit_gain
    q_lim = tctl.model.q_lim
    dq = tel.dq_cmd.numpy()
    assert (dq <= tcfg.ik_limit_gain * (q_lim[:, 1] - np.asarray(state.q)) + 1e-3).all()
    assert np.abs(s2.plant.dq_act.numpy()).max() > 0  # the servo moved the actual joints


@pytest.mark.parametrize("tick", [0, 30])
def test_mpc_stage_matches_jax_f64(rig, tick):
    """One MPC stage (a generator call, the merge, the solve, the write-back)
    from the same converted state of the JAX episode, in double support
    (tick 0) and with the left foot swinging (tick 30): every field of the
    next state within F64_TOL."""
    jctl, tctl = rig["ctls"]["f64"]
    state = rig["pre"][tick]
    s = convert.loop_state_from_numpy(state._asdict(), device="cpu", dtype=torch.float64)
    got = convert.loop_state_to_numpy(tctl._mpc_stage(s, rig["tinp"]))
    with jax.enable_x64(True):
        want = np_tree(rig["mpc"](JL.LoopState(*jax.tree_util.tree_map(jnp.asarray, state)), rig["jinp"]))
    compare(got, want, F64_TOL)
    assert (got["mann"]["t0"] == state.t).all()  # the generator was called


def test_episode_matches_jax(rig):
    """35 ticks at B = 2 (MPC ticks 0 and 30) through run_episode, against
    the JAX stages tick by tick: flags identical, every telemetry channel of
    every item and tick within F64_TOL, the final state too."""
    jctl, tctl = rig["ctls"]["f64"]
    S = 35
    inputs = TL.TickInput(*(a[:, None].expand(a.shape[0], S, *a.shape[1:]) for a in rig["tinp"]))
    sN, tel = tctl.run_episode(rig["s0"], inputs)
    got = convert.solution_to_numpy(tel)
    for k in range(S):
        compare({n: v[:, k] for n, v in got.items()}, rig["tels"][k], F64_TOL, path=f"tick {k}")
    compare(convert.loop_state_to_numpy(sN), rig["pre"][S], F64_TOL)
    contact = got["foot_contact"]
    assert contact[:, :30, 0].min() == 1.0 and contact[:, 30:, 0].max() == 0.0  # the left foot lifts at t = 0.06
    assert np.isfinite(got["q"]).all() and got["mpc_prim"].max() < 1e-2
    assert int(sN.tick[0]) == S and float(sN.t[0]) == pytest.approx(S * tctl.cfg.wbc_dt)

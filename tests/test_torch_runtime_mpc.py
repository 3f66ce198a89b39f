"""Port parity for the walking controller's MPC stage in float32, and the
runtime's remaining surface:

  - `_mpc_stage` against `cmw_tpu.runtime.loop` (JAX in one jit of its vmap)
    from the same converted states of a JAX float32 episode on the lifted
    synthetic weights, in double support (tick 0) and with the left foot
    swinging (tick 30), within the solver tests' tolerances;
  - the same stage against `chip_smoke.mpc_tick`, the seven steps composed
    by hand: they agree exactly;
  - the ergocub_sn000 preset (slow-down 5, wbc_dt 0.005) and, with
    ergoCubSN001's 60 ms MPC, the generator called every 5th MPC tick and
    its stored output re-sliced on the ticks between;
  - a rigid-plant config built and stepped, telemetry files, and the default
    device of the controller on either plant.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cmw_tpu.cmpc import formulation as JF
from cmw_tpu.runtime import config as JCfg
from cmw_tpu.runtime import loop as JL
from cmw_tpu.runtime import telemetry as JT
from cmw_tpu_torch import convert
from cmw_tpu_torch.cmpc import formulation as TF
from cmw_tpu_torch.runtime import config as TCfg
from cmw_tpu_torch.runtime import loop as TL
from cmw_tpu_torch.runtime import telemetry as TT
from cmw_tpu_torch.sim import rigid_body as TRB
from test_torch_mann_mpc import REF_ATOL, TIME_RTOL
from test_torch_runtime import B, np_tree, tick_input, to_jax
from test_torch_runtime import controllers as make_controllers
from test_torch_solver import COST_RTOL, FORCE_ATOL, POS_ATOL, PRIM_MAX

torch.set_num_threads(2)

# the next state's fields by what bounds them (the ADMM's dual and slack
# iterates are the solver's internals, not held, as in the solver tests)
EXACT = {"active0", "hold", "hold_time", "joypad_lp", "plan.valid", "mann.plan.valid", "gen_state.contact",
         "warm.valid", "ref_off"}
TIMES = {"plan.act", "plan.deact", "mann.plan.act", "mann.plan.deact", "mann.t0", "warm.slot_act"}
POSITIONS = {"plan.pos", "corner0", "zmp_des"}
SKIP = {"warm.dual", "warm.slack", "mpc_prim", "mpc_cost", "warm.z", "forces0", "dyn"}


def mpc_compare(cfg, got: dict, want, path=""):
    """The port's next state against JAX's, field by field (see the sets above)."""
    for name, g in got.items():
        where = f"{path}{name}"
        w = getattr(want, name)
        if isinstance(g, dict):
            mpc_compare(cfg, g, w, where + ".")
            continue
        if where in SKIP or where.split(".")[0] in SKIP:
            continue
        w = np.asarray(w)
        assert g.shape == w.shape, where
        if where in EXACT or g.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=where)
        elif where in TIMES:
            np.testing.assert_allclose(g, w, rtol=TIME_RTOL, atol=0, err_msg=where)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=POS_ATOL if where in POSITIONS else REF_ATOL, err_msg=where)
    if path:
        return
    np.testing.assert_allclose(got["mpc_cost"], np.asarray(want.mpc_cost), rtol=COST_RTOL)
    assert got["mpc_prim"].max() < PRIM_MAX and np.asarray(want.mpc_prim).max() < PRIM_MAX
    np.testing.assert_allclose(got["forces0"], np.asarray(want.forces0), atol=FORCE_ATOL)
    nf = cfg.mpc.n_forces
    np.testing.assert_allclose(got["warm"]["z"][:, :nf], np.asarray(want.warm.z)[:, :nf], atol=FORCE_ATOL)
    np.testing.assert_allclose(got["warm"]["z"][:, nf:], np.asarray(want.warm.z)[:, nf:], atol=POS_ATOL)


def jax_template(jctl, tctl, jd, td):
    """A JAX LoopState of the right structure and dtype, for the leaves the
    port does not carry (the rigid-body state, the plant's key): JAX's
    initial_state under jit, its polished-pose cache filled with the port's
    poses (every other leaf is overwritten by the converted port state)."""
    jctl._polished_poses = {d: tuple(jnp.asarray(a.numpy(), jd) for a in tctl.polished_initial_pose(td, d))
                            for d in (0.0, 0.05)}
    return jax.jit(lambda: jctl.initial_state(dtype=jd))()


@pytest.fixture(scope="module")
def rig():
    """f32: a JAX episode of 31 ticks from the port's initial state, the JAX
    MPC stage jitted, the state entering each tick."""
    jctl, tctl = make_controllers()["f32"]
    s0 = tctl.initial_state(B, dtype=torch.float32)
    tinp, jinp = tick_input(chip_smoke.joysticks(B, device="cpu").numpy(), "f32")
    js = to_jax(convert.loop_state_to_numpy(s0), jax_template(jctl, tctl, jnp.float32, torch.float32), B)
    mpc, wbc = jax.jit(jax.vmap(jctl._mpc_stage)), jax.jit(jax.vmap(jctl._wbc_stage))
    pre = []
    for k in range(31):
        pre.append(np_tree(js))
        if k % jctl.cfg.mpc_every == 0:
            js = mpc(js, jinp)
        js, _ = wbc(js, jinp)
    return dict(jctl=jctl, tctl=tctl, s0=s0, tinp=tinp, jinp=jinp, mpc=mpc, pre=pre)


@pytest.mark.parametrize("tick", [0, 30])
def test_mpc_stage_matches_jax_f32(rig, tick):
    state = rig["pre"][tick]
    s = convert.loop_state_from_numpy(state._asdict(), device="cpu", dtype=torch.float32)
    got = convert.loop_state_to_numpy(rig["tctl"]._mpc_stage(s, rig["tinp"]))
    want = np_tree(rig["mpc"](JL.LoopState(*jax.tree_util.tree_map(jnp.asarray, state)), rig["jinp"]))
    mpc_compare(rig["tctl"].cfg, got, want)
    left = got["active0"][:, 0]
    assert (left == 1.0).all() if tick == 0 else (left == 0.0).all()


def test_mpc_stage_stand_mode_and_slew_match_jax(rig):
    """The same stage at tick 30 with item 0's stick reversed under the
    joystick slew limit (1 full scale / s, a knob of the state) and item 1's
    stick released without it (stand mode: the generator frozen, the CoM
    held over the stance centroid)."""
    state = rig["pre"][30]
    state = state._replace(dyn=state.dyn._replace(joypad_slew=np.array([1.0, 0.0], np.float32)))
    joy = rig["tinp"].joypad.numpy().copy()
    joy[0, 0:2] *= -1.0
    joy[1, 0:2] = 0.0
    tinp, jinp = tick_input(joy, "f32")
    s = convert.loop_state_from_numpy(state._asdict(), device="cpu", dtype=torch.float32)
    got = convert.loop_state_to_numpy(rig["tctl"]._mpc_stage(s, tinp))
    want = np_tree(rig["mpc"](JL.LoopState(*jax.tree_util.tree_map(jnp.asarray, state)), jinp))
    mpc_compare(rig["tctl"].cfg, got, want)
    # item 1 stands: its generator state did not advance; item 0 walks on
    np.testing.assert_array_equal(got["gen_state"]["q"][1], state.gen_state.q[1])
    assert np.abs(got["gen_state"]["q"][0] - state.gen_state.q[0]).max() > 0
    # item 0's slewed stick moved 1 x mpc dt toward the reversed command
    step = np.abs(got["joypad_lp"][0, 0:2] - state.joypad_lp[0, 0:2]).max()
    assert step == pytest.approx(rig["tctl"].cfg.mpc.dt, rel=1e-5)


@pytest.mark.parametrize("tick", [0, 30])
def test_mpc_stage_is_mpc_tick(rig, tick):
    """On a generator-call tick the controller's MPC stage and
    chip_smoke.mpc_tick (the same seven steps composed by hand) agree
    exactly: references, plan, solution, next generator state."""
    tctl = rig["tctl"]
    s = convert.loop_state_from_numpy(rig["pre"][tick]._asdict(), device="cpu", dtype=torch.float32)
    nxt = tctl._mpc_stage(s, rig["tinp"])
    chain = chip_smoke.Chain(t=s.t, gen=s.gen_state, plan=s.plan, warm=s.warm, x0=s.x9)
    cfg = tctl.cfg
    c_next, sol, params = chip_smoke.mpc_tick(tctl.solver, cfg.gen, tctl.model, tctl._weights_as(s.x9), chain,
                                              rig["tinp"].joypad, s.com_z_ref, cfg.mann_advance)
    assert cfg.mann_advance == chip_smoke.mann_advance(cfg.gen, cfg.mpc.dt)
    pairs = [("forces0", nxt.forces0, sol.forces[:, 0]), ("cost", nxt.mpc_cost, sol.cost),
             ("com_mann", nxt.com_mann, params.com_ref[:, 0]), ("ang_mom_mann", nxt.ang_mom_mann,
                                                                 params.ang_mom_ref[:, 0])]
    pairs += [(f"plan.{n}", a, b) for n, a, b in zip(nxt.plan._fields, nxt.plan, c_next.plan)]
    pairs += [(f"warm.{n}", a, b) for n, a, b in zip(nxt.warm._fields, nxt.warm, c_next.warm)]
    pairs += [(f"gen.{n}", a, b) for n, a, b in zip(nxt.gen_state._fields, nxt.gen_state, c_next.gen)]
    for name, a, b in pairs:
        assert torch.equal(a, b), name


# --- ergoCubSN000 / SN001 timing ------------------------------------------------


def sn_controllers():
    """The sn000 preset with ergoCubSN001's 60 ms MPC (horizon cut to 0.6 s):
    mannCallingTime lcm(5 x 20 ms, 60 ms) = 0.3 s, a generator call every 5th
    MPC tick, re-rooted 3 steps in."""
    jcfg = JCfg.ergocub_sn000(mpc=JF.MPCConfig(dt=0.06, horizon=0.6, sqp_iters=2, admm_iters=30))
    tcfg = TCfg.ergocub_sn000(mpc=convert.config_from_dict(dataclasses.asdict(jcfg.mpc)))
    return jcfg, tcfg


def test_sn000_presets_match_jax():
    for jc, tc in ((JCfg.ergocub_sn000(), TCfg.ergocub_sn000()), sn_controllers(),
                   (JCfg.ergocub_gazebo_v1(), TCfg.ergocub_gazebo_v1())):
        for prop in ("mpc_every", "mann_calling_time", "mann_advance", "mann_call_every", "ref_ramp"):
            assert getattr(tc, prop) == getattr(jc, prop), prop
        port = dataclasses.asdict(tc)
        jax_fields = dataclasses.asdict(jc)
        assert set(port) == set(jax_fields)
        for name, value in jax_fields.items():
            if isinstance(value, dict):  # nested configs: the same values
                assert {k: (tuple(v) if isinstance(v, list) else v) for k, v in port[name].items()} == \
                    {k: (tuple(v) if isinstance(v, list) else v) for k, v in value.items()}, name
            else:
                assert port[name] == value, name
    sn0 = TCfg.ergocub_sn000()
    assert (sn0.mpc_every, sn0.mann_advance, sn0.mann_call_every) == (20, 1, 1)


def test_sn_generator_calls_and_reslicing_match_jax():
    """13 ticks on the port (MPC ticks 0 and 12): the generator is called at
    tick 0 and not at 12, where the MPC knots read the stored rollout 60 ms
    later; both MPC stages against JAX's from the same converted states."""
    jcfg, tcfg = sn_controllers()
    assert (tcfg.mpc_every, tcfg.mann_call_every, tcfg.mann_advance) == (12, 5, 3)
    ctls = make_controllers({"jax": jcfg, "port": tcfg})
    jctl, tctl = ctls["f32"]
    s = tctl.initial_state(B, dtype=torch.float32)
    tinp, jinp = tick_input(chip_smoke.joysticks(B, device="cpu").numpy(), "f32")
    template = jax_template(jctl, tctl, jnp.float32, torch.float32)
    mpc = jax.jit(jax.vmap(jctl._mpc_stage))
    for tick in range(13):
        if tick % tcfg.mpc_every == 0:
            before = convert.loop_state_to_numpy(s)
            s = tctl._mpc_stage(s, tinp)
            got = convert.loop_state_to_numpy(s)
            want = np_tree(mpc(to_jax(before, template, B), jinp))
            mpc_compare(tcfg, got, want)
            if tick == 0:
                assert (got["mann"]["t0"] == 0.0).all()
            else:  # no call: the stored rollout and the generator state carry over
                for name in ("t0", "com", "ang_mom", "joints0", "yaw0"):
                    np.testing.assert_array_equal(got["mann"][name], before["mann"][name], err_msg=name)
                np.testing.assert_array_equal(got["gen_state"]["q"], before["gen_state"]["q"])
        s, _ = tctl._wbc_stage(s, tinp)


# --- the rest of the surface ------------------------------------------------------


def test_rigid_plant_builds_and_steps():
    """A config with the rigid-body plant builds and steps on the CPU: the
    settled plant carries the robot's weight and two ticks (an MPC tick
    first) move it, with its forces in the telemetry."""
    _, tctl = make_controllers()["f32"]
    cfg = TCfg.ergocub_gazebo_v1(rigid=TRB.RigidBodyConfig(), rigid_settle_s=0.004, mpc=tctl.cfg.mpc)
    ctl = TL.WalkingController(cfg, tctl.model, tctl.weights, device="cpu")
    s0 = ctl.initial_state(B)
    assert isinstance(s0.rb, TRB.RigidBodyState) and s0.rb.q.shape == (B, ctl.model.nj)
    assert float(s0.rb.corner_forces[0, ..., 2].sum()) > 0.5 * ctl.mass * 9.80665
    sN, tel = ctl.run_episode(s0, TL.constant_inputs(2, (0.5, 0.0, 1.0, 0.0), batch=B, device="cpu"))
    assert int(sN.tick[0]) == 2 and bool(torch.isfinite(tel.q_act).all()) and float(tel.mpc_prim.max()) < 1e-2
    assert (tel.fz_act > 0).any() and not torch.equal(sN.rb.q, s0.rb.q)
    assert float(tel.base_act_up.min()) > 0.8


def test_rigid_controller_defaults_to_the_card():
    """WalkingController with cfg.rigid defaults to the card like the
    kinematic one; without one its initial state (the settle) raises rather
    than falls back to the CPU."""
    _, tctl = make_controllers()["f32"]
    cfg = TCfg.ergocub_gazebo_v1(rigid=TRB.RigidBodyConfig(), rigid_settle_s=0.004, mpc=tctl.cfg.mpc)
    ctl = TL.WalkingController(cfg, tctl.model, tctl.weights)
    assert ctl.device.type == "cuda"
    if torch.cuda.is_available():
        assert ctl.initial_state(1).rb.q.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            ctl.initial_state(1)


def test_telemetry_round_trip(tmp_path):
    """save/load of a 4-tick B = 2 episode; the JAX package's loader reads
    the same file, and both schemas name the same channels."""
    _, tctl = make_controllers()["f32"]
    s0 = tctl.initial_state(B, dtype=torch.float32)
    _, tel = tctl.run_episode(s0, TL.constant_inputs(4, (0.5, 0.0, 1.0, 0.0), batch=B, device="cpu"))
    path = str(tmp_path / "tel.npz")
    TT.save(path, tel, tctl.cfg.wbc_dt, extra={"note": "port"})
    chans, meta = TT.load(path)
    assert (meta["batch"], meta["ticks"], meta["wbc_dt"], meta["note"]) == (B, 4, tctl.cfg.wbc_dt, "port")
    assert set(chans) == set(TL.Telemetry._fields) == set(TT.SCHEMA) == set(JT.SCHEMA)
    for name, value in tel._asdict().items():
        np.testing.assert_array_equal(chans[name], value.numpy(), err_msg=name)
        assert chans[name].shape[:2] == (B, 4)
    jchans, jmeta = JT.load(path)
    assert set(jchans) == set(chans) and jmeta["schema"] == meta["schema"]
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, com_mpc=np.zeros(1), _meta_json=np.frombuffer(b'{"schema": {}}', dtype=np.uint8))
    with pytest.raises(ValueError):
        TT.load(bad)


def test_controller_defaults_to_the_card():
    """Without `device`, the controller, its initial state and
    constant_inputs live on the card; on a machine without one they raise
    rather than fall back to the CPU."""
    _, tctl = make_controllers()["f32"]
    ctl = TL.WalkingController(TCfg.ergocub_gazebo_v1(mpc=TF.ergocub_mpc_config(horizon=0.6)), tctl.model,
                               tctl.weights)
    assert ctl.device.type == "cuda"
    calls = (lambda: ctl.initial_state(1), lambda: TL.constant_inputs(3))
    for call in calls:
        if torch.cuda.is_available():
            out = call()
            assert all(t.device.type == "cuda" for t in jax.tree_util.tree_leaves(out) if isinstance(t, torch.Tensor))
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()

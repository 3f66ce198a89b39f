"""Port parity for the walking controller on the rigid-body plant
(`cmw_tpu_torch.runtime.loop` with cfg.rigid) against `cmw_tpu.runtime.loop`,
at ergocub_gazebo_v1(rigid=RigidBodyConfig(), mpc=ergocub_mpc_config(horizon=
0.6), rigid_settle_s=SETTLE_S) on the synthetic MANN weights whose left foot
swings (`chip_smoke.lifted`), with the random joysticks of chip_smoke, B = 2:

  - the rigid initial state (spawn, a settle of SETTLE_S / wbc_dt ticks in
    both packages alike, reset anchors, the odometry CoM bootstrap);
  - one `_wbc_stage` and one `_mpc_stage` from the same states, converted
    from a JAX episode at a double-support and a left-swing tick;
  - a 35-tick episode (MPC ticks 0 and 30), tick by tick, and the same with
    a push on the base over the first MPC period (PUSH), in which the gait
    rush fires;
  - both stages from the pushed episode's state at tick 30 with a landing
    planned for the swinging left foot (`landing_state`), in which the early
    activation and the capture step (MPC stage; its reach cap in the knobs
    file) and the early touchdown (WBC stage) fire, each shown to act by
    switching it off;
  - the episode in float32 against JAX's float32 run within F32_GAP_MULT
    times JAX's own f32-vs-f64 gap over the first MPC period;
  - the converters' round trip of a RigidBodyState and a LoopState with one.

This file runs the IMU-fused estimate (perfect_state False) with the knobs at
their defaults; tests/test_torch_rigid_loop_knobs.py runs the same checks
with perfect_state True and every rigid knob non-zero. JAX runs each stage in
one jit of its vmap (module fixture). f64 within F64_TOL of max(1, |value|);
contact flags, fixed feet and the plant's active corners identical."""

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
from cmw_tpu.sim import rigid_body as JRB
from cmw_tpu_torch import convert
from cmw_tpu_torch.core.contacts import BIG_TIME
from cmw_tpu_torch.runtime import config as TCfg
from cmw_tpu_torch.runtime import loop as TL
from cmw_tpu_torch.sim import rigid_body as TRB
from test_torch_runtime import DTYPES, F64_TOL, HORIZON, W_LIFT, compare, controllers, jax_initial_state, np_tree
from test_torch_runtime import tick_input, to_jax

torch.set_num_threads(2)

B = 2
SETTLE_S = 0.01  # 5 WBC ticks of settling in initial_state (the presets' 0.4 s in chip_smoke.py phase 10)
EPISODE = 41  # JAX ticks recorded: two MPC periods' starts (0, 30) and 11 ticks of the second
S = 35  # the episode held tick by tick
F32_GAP_MULT = 4.0
PERIOD = 30  # ticks of one MPC period
# the push on the base, mass-normalised (m/s^2), over the first MPC period:
# item 0 is pushed against its forward stick, item 1 forward-right across its
# backward one; ~0.7 m/s of impulse each, the impulse of the push sweep's
# largest push (2 m/s^2 for 0.4 s)
PUSH = np.array([[-12.0, 0.0, 0.0], [6.0, -10.0, 0.0]])
PUSH_TICKS = PERIOD
STAND = np.array([[0.0, 0.0, 1.0, 0.0]] * B)  # the stick at rest (stand mode)
# the left foot's landing in `landing_state` (s, on the MPC grid), per item
LANDING = (0.12, 0.48)
LANDING_AHEAD = 0.1  # m: item 1's landing there lies this far ahead of its sole along the CoM velocity
SHORT_REACH = 0.71  # m: item 1's reach cap there (if it has one), ~1 cm over the CoM height, so that it binds


def rigid_rig(wcfg_kw: dict, dyn: dict | None = None, dtypes=("f64",)):
    """Controllers with cfg.rigid (+ wcfg_kw), the port's initial state in
    each dtype (with the DynConfig knobs `dyn`, as JAX's traced knobs), JAX's
    f64 initial state, the jitted JAX stages, and a JAX f64 episode of EPISODE
    ticks from the port's f64 initial state, recording the state entering
    each tick."""
    kw = dict(rigid_settle_s=SETTLE_S, **wcfg_kw)
    jcfg = JCfg.ergocub_gazebo_v1(mpc=JF.ergocub_mpc_config(horizon=HORIZON), rigid=JRB.RigidBodyConfig(), **kw)
    tcfg = TCfg.ergocub_gazebo_v1(mpc=convert.config_from_dict(dataclasses.asdict(jcfg.mpc)),
                                  rigid=TRB.RigidBodyConfig(), **kw)
    ctls = controllers({"jax": jcfg, "port": tcfg})
    joy = chip_smoke.joysticks(B, device="cpu").numpy()
    out = dict(ctls=ctls, s0={}, stages={}, inputs={}, push_inputs={}, dyn=dyn or {})
    for dt in dtypes:
        jd, td = DTYPES[dt]
        jctl, tctl = ctls[dt]
        s0 = tctl.initial_state(B, dtype=td)
        out["s0"][dt] = s0._replace(dyn=s0.dyn._replace(**{k: torch.full((B,), v, dtype=td) for k, v in (dyn or {}).items()}))
        with jax.enable_x64(dt == "f64"):
            out["inputs"][dt] = tick_input(joy, dt)
            out["push_inputs"][dt] = pushed_input(joy, dt)
            out["stages"][dt] = (jax.jit(jax.vmap(jctl._mpc_stage)), jax.jit(jax.vmap(jctl._wbc_stage)))
    with jax.enable_x64(True):
        _, out["init"] = jax_initial_state(ctls["f64"][0], jnp.float64)
    start = convert.loop_state_to_numpy(out["s0"]["f64"])
    out["pre"], out["tels"] = jax_episode(out, "f64", start, EPISODE)
    out["pushed"] = jax_episode(out, "f64", start, S, pushed=True)
    with jax.enable_x64(True):
        out["stand"] = tick_input(STAND, "f64")
    return out


def pushed_input(joy, dt):
    """The joystick joy [B, 4] and the push PUSH, as the port's and JAX's
    TickInput."""
    jd, td = DTYPES[dt]
    jinp = JL.TickInput(*(jnp.asarray(a, jd) for a in (joy, PUSH, np.zeros((len(joy), 3)))))
    return convert.tick_input_from_numpy(np_tree(jinp), device="cpu", dtype=td), jinp


def inputs_at(rig, dt, k, pushed):
    """(port, JAX) TickInput of tick k: pushed over the first PUSH_TICKS."""
    return rig["push_inputs" if pushed and k < PUSH_TICKS else "inputs"][dt]


def jax_episode(rig, dt, state: dict, ticks, pushed=False):
    """JAX's stages in dtype dt for `ticks` ticks from a port numpy state:
    (the states entering each tick and the one after the last, telemetry)."""
    jctl, _ = rig["ctls"][dt]
    mpc, wbc = rig["stages"][dt]
    pre, tels = [], []
    with jax.enable_x64(dt == "f64"):
        js = to_jax(state, rig["init"], B)
        js = jax.tree_util.tree_map(lambda a: a.astype(DTYPES[dt][0]) if jnp.issubdtype(a.dtype, jnp.floating) else a,
                                    js)
        for k in range(ticks):
            pre.append(np_tree(js))
            _, jinp = inputs_at(rig, dt, k, pushed)
            if k % jctl.cfg.mpc_every == 0:
                js = mpc(js, jinp)
            js, tel = wbc(js, jinp)
            tels.append(np_tree(tel))
        pre.append(np_tree(js))
    return pre, tels


def port_episode(rig, dt, s, ticks, pushed=False):
    """The port tick by tick: (final state, Telemetry numpy [B, ticks, ...],
    active corners [B, ticks, nc, ncor] after each tick)."""
    _, tctl = rig["ctls"][dt]
    tels, active = [], []
    for k in range(ticks):
        s, tel = tctl.step(s, inputs_at(rig, dt, k, pushed)[0], k)
        tels.append(tel)
        active.append(s.rb.corner_forces[..., 2].numpy() > 0)
    stacked = TL.Telemetry(*(torch.stack(parts, dim=1) for parts in zip(*tels)))
    return s, convert.solution_to_numpy(stacked), np.stack(active, axis=1)


def check_initial_state(rig):
    """The port's rigid initial state (f64) against JAX's jitted one, items
    alike; the plant settled onto its feet."""
    got = jax.tree_util.tree_map(lambda a: a[0], convert.loop_state_to_numpy(rig["s0"]["f64"]))
    want = np_tree(rig["init"])
    got.pop("dyn")  # the knobs: set apart from the initial state
    compare(got, want, F64_TOL)
    rb = rig["s0"]["f64"].rb
    assert (rb.corner_forces[..., 2] > 0).any() and rb.params.contact_kp.shape == (B,)
    np.testing.assert_array_equal(rb.q[0].numpy(), rb.q[1].numpy())


def wbc_stage_vs_jax(rig, state, inputs):
    """One WBC tick (the plant's dynamics step included) from the JAX numpy
    state `state` with the (port, JAX) inputs: the next state and the
    telemetry within F64_TOL, the active corners identical. Returns (the
    port's input state, its next state, its telemetry)."""
    _, tctl = rig["ctls"]["f64"]
    s = convert.loop_state_from_numpy(state._asdict(), device="cpu", dtype=torch.float64)
    tinp, jinp = inputs
    s2, tel = tctl._wbc_stage(s, tinp)
    with jax.enable_x64(True):
        js2, jtel = np_tree(rig["stages"]["f64"][1](JL.LoopState(*jax.tree_util.tree_map(jnp.asarray, state)), jinp))
    compare(convert.solution_to_numpy(tel), jtel, F64_TOL)
    compare(convert.loop_state_to_numpy(s2), js2, F64_TOL)
    np.testing.assert_array_equal(s2.rb.corner_forces[..., 2].numpy() > 0, js2.rb.corner_forces[..., 2] > 0)
    return s, s2, tel


def mpc_stage_vs_jax(rig, state, inputs):
    """One MPC stage from the JAX numpy state `state` with the (port, JAX)
    inputs: every field of the next state within F64_TOL. Returns (the
    port's input state, its next state)."""
    _, tctl = rig["ctls"]["f64"]
    s = convert.loop_state_from_numpy(state._asdict(), device="cpu", dtype=torch.float64)
    tinp, jinp = inputs
    got = tctl._mpc_stage(s, tinp)
    with jax.enable_x64(True):
        want = np_tree(rig["stages"]["f64"][0](JL.LoopState(*jax.tree_util.tree_map(jnp.asarray, state)), jinp))
    compare(convert.loop_state_to_numpy(got), want, F64_TOL)
    return s, got


def with_dyn(s, **values):
    """The port state s with DynConfig fields set to `values` on every item."""
    return s._replace(dyn=s.dyn._replace(**{k: torch.full_like(s.t, v) for k, v in values.items()}))


def item_gap(a, b):
    """Per item: the largest |a - b| over the other axes."""
    return (a - b).abs().flatten(1).amax(dim=1)


def check_wbc_stage(rig, tick):
    """One WBC tick from the converted JAX state of `tick` (wbc_stage_vs_jax):
    the left foot in contact before the first MPC period's end and in swing
    after it; the physical plant's contact forces in the telemetry."""
    _, _, tel = wbc_stage_vs_jax(rig, rig["pre"][tick], rig["inputs"]["f64"])
    left = tel.foot_contact[:, 0].numpy()
    assert (left == 1.0).all() if tick < PERIOD else (left == 0.0).all()
    assert (tel.fz_act.numpy() > 0).any()  # the physical plant's forces, not the kinematic plant's zeros
    return tel


def check_mpc_stage(rig, tick):
    """One MPC stage (measurements, gait hold, governors, re-sync, generator,
    merge, reconciliation, capture step, solve) from the converted JAX state
    of `tick` (mpc_stage_vs_jax). Returns the port's next state, numpy."""
    _, got = mpc_stage_vs_jax(rig, rig["pre"][tick], rig["inputs"]["f64"])
    return convert.loop_state_to_numpy(got)


def check_episode(rig, pushed=False):
    """35 ticks at B = 2 through WalkingController.step against the JAX stages
    tick by tick (with the push PUSH over the first PUSH_TICKS if `pushed`):
    flags and active corners identical, every telemetry channel of every item
    and tick within F64_TOL, the final state too; upright, solved, finite."""
    pre, tels = rig["pushed"] if pushed else (rig["pre"], rig["tels"])
    sN, got, active = port_episode(rig, "f64", rig["s0"]["f64"], S, pushed)
    for k in range(S):
        compare({n: v[:, k] for n, v in got.items()}, tels[k], F64_TOL, path=f"tick {k}")
        np.testing.assert_array_equal(active[:, k], pre[k + 1].rb.corner_forces[..., 2] > 0, err_msg=f"{k}")
    compare(convert.loop_state_to_numpy(sN), pre[S], F64_TOL)
    assert np.isfinite(got["q_act"]).all() and got["mpc_prim"].max() < 1e-2 and got["base_act_up"].min() > 0.8
    return got


def landing_state(rig):
    """The pushed episode's JAX state entering tick 30 (an MPC tick, the push
    just over), at rest on the stick (STAND, the stick's filter too, so that
    stand mode keeps the plan), with the swinging left foot's plan rewritten
    to a swing from -0.06 s to a landing at LANDING[b] s with its sole pose
    unchanged. Item 0's landing lies within td_lookahead while the foot still
    carries load (early activation at the MPC stage) and past
    gait_hold_window of its swing (early touchdown at the WBC stage); item
    1's lies LANDING_AHEAD along the CoM velocity, short of the capture
    point (the capture step moves it further, by less than step_ext_max;
    with a reach cap (step_reach_len > 0), that cap is SHORT_REACH, so that
    it binds), and its swing is under 0.3 done (the load-gated lift with
    lift_gate_window 0.3). The synthetic weights' lifted foot never lands
    within the generator's horizon, so no episode state plans a landing."""
    s = rig["pushed"][0][PUSH_TICKS]
    act, deact, pos, rot, valid = (np.array(a) for a in s.plan)
    for b, land in enumerate(LANDING):
        i = int(np.argmax(valid[b, 0] * (act[b, 0] <= s.t[b])))  # the left foot's last phase
        p, r = pos[b, 0, i].copy(), rot[b, 0, i].copy()
        act[b, 0], deact[b, 0], valid[b, 0] = BIG_TIME, BIG_TIME, 0.0
        act[b, 0, :2], deact[b, 0, :2], valid[b, 0, :2] = (-0.12, land), (-0.06, BIG_TIME), 1.0
        pos[b, 0, :2], rot[b, 0, :2] = p, r
    v = s.x9[1, 3:5]
    pos[1, 0, 1, :2] += LANDING_AHEAD * v / np.linalg.norm(v)
    reach = np.array(s.dyn.step_reach_len)
    reach[1] = SHORT_REACH if reach[1] > 0 else 0.0
    return s._replace(plan=type(s.plan)(act, deact, pos, rot, valid), joypad_lp=STAND.copy(),
                      dyn=s.dyn._replace(step_reach_len=reach))


def check_landing_mpc_stage(rig):
    """The MPC stage from `landing_state` against JAX (mpc_stage_vs_jax), and
    its branches: item 0's landing becomes active now (early activation);
    the capture step, and on its own the reach cap where there is one, move
    item 1's landing (each set to 0 moves it elsewhere). Returns the port's
    input state."""
    _, tctl = rig["ctls"]["f64"]
    stand = rig["stand"][0]
    s, got = mpc_stage_vs_jax(rig, landing_state(rig), rig["stand"])
    assert float(got.plan.act[0, 0, 1]) == float(s.t[0]) and float(s.plan.act[0, 0, 1]) == LANDING[0]
    capped = float(s.dyn.step_reach_len[1]) > 0
    for knob in ("step_ext_max", "step_reach_len") if capped else ("step_ext_max",):
        off = tctl._mpc_stage(with_dyn(s, **{knob: 0.0}), stand)
        assert float(item_gap(got.plan.pos[:, 0, 1], off.plan.pos[:, 0, 1])[1]) > 1e-2, knob
    return s


def check_landing_wbc_stage(rig):
    """The WBC stage from `landing_state` against JAX (wbc_stage_vs_jax), and
    the early touchdown: item 0's late-swing foot, loaded, holds its measured
    sole (td_load_thresh set to 0 changes item 0's joint command)."""
    _, tctl = rig["ctls"]["f64"]
    s, _, tel = wbc_stage_vs_jax(rig, landing_state(rig), rig["stand"])
    _, off = tctl._wbc_stage(with_dyn(s, td_load_thresh=0.0), rig["stand"][0])
    assert float(item_gap(tel.dq_cmd, off.dq_cmd)[0]) > 1e-3
    return s, tel


@pytest.fixture(scope="module")
def rig():
    return rigid_rig({}, dtypes=("f64", "f32"))


def test_rigid_initial_state_matches_jax(rig):
    check_initial_state(rig)


@pytest.mark.parametrize("tick", [10, 40])
def test_rigid_wbc_stage_matches_jax(rig, tick):
    check_wbc_stage(rig, tick)


@pytest.mark.parametrize("tick", [0, 30])
def test_rigid_mpc_stage_matches_jax(rig, tick):
    got = check_mpc_stage(rig, tick)
    assert (got["mann"]["t0"] == rig["pre"][tick].t).all()  # the generator was called


def test_rigid_episode_matches_jax(rig):
    got = check_episode(rig)
    assert got["gait_hold"][:, 30:].max() == 1.0  # the lifting foot's load holds the clock (the gait-hold branch)


def test_rigid_pushed_episode_matches_jax(rig):
    got = check_episode(rig, pushed=True)
    assert got["gait_rush"].max() > 0.0  # the capture point past the loaded toe runs the clock faster
    assert np.abs(got["base_act_pos"][:, S - 1] - rig["tels"][S - 1].base_act_pos).max() > 1e-2  # the push moved it


def test_rigid_landing_mpc_stage_matches_jax(rig):
    check_landing_mpc_stage(rig)


def test_rigid_landing_wbc_stage_matches_jax(rig):
    check_landing_wbc_stage(rig)


def test_rigid_episode_f32_within_jax_gap(rig):
    """The episode in float32 from the port's f32 initial state: flags and
    active corners identical to JAX's f32 run on all 35 ticks, every channel
    over the first MPC period within F32_GAP_MULT x JAX's own f32-vs-f64 gap
    (JAX f64 from the same state) + 4 f32 ulps of max(1, |value|)."""
    s0 = rig["s0"]["f32"]
    start = convert.loop_state_to_numpy(s0)
    pre32, tels32 = jax_episode(rig, "f32", start, S)
    _, tels64 = jax_episode(rig, "f64", start, PERIOD)
    _, got, active = port_episode(rig, "f32", s0, S)
    eps = 4 * np.finfo(np.float32).eps
    for k in range(S):
        for n in ("foot_contact", "fixed_foot_idx"):
            np.testing.assert_array_equal(got[n][:, k], getattr(tels32[k], n), err_msg=f"{n} tick {k}")
        np.testing.assert_array_equal(active[:, k], pre32[k + 1].rb.corner_forces[..., 2] > 0, err_msg=f"{k}")
    for n, g in got.items():
        w32 = np.stack([np.asarray(getattr(t, n), np.float64) for t in tels32[:PERIOD]], axis=1)
        w64 = np.stack([np.asarray(getattr(t, n), np.float64) for t in tels64], axis=1)
        scale = max(1.0, np.abs(w64).max(initial=0.0))
        tol = F32_GAP_MULT * np.abs(w32 - w64).max(initial=0.0) + eps * scale
        assert np.abs(g[:, :PERIOD] - w32).max(initial=0.0) <= tol, (n, np.abs(g[:, :PERIOD] - w32).max(), tol)


def test_convert_round_trips_rigid_states(rig):
    """JAX's RigidBodyState and a LoopState with one, to the port and back,
    exactly (f64)."""
    state = rig["pre"][40]
    rb = convert.rigid_state_from_numpy(state.rb._asdict(), device="cpu", dtype=torch.float64)
    assert isinstance(rb, TRB.RigidBodyState) and isinstance(rb.params, TRB.RigidDynParams)
    assert rb.params.servo_kp.shape == (B,) and rb.corner_forces.shape == (B, 2, 4, 3)
    back = convert.rigid_state_to_numpy(rb)
    compare(back, state.rb, 0.0)
    s = convert.loop_state_from_numpy(state._asdict(), device="cpu", dtype=torch.float64)
    assert isinstance(s.rb, TRB.RigidBodyState)
    compare(convert.loop_state_to_numpy(s), state, 0.0)

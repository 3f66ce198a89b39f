"""Port parity for the walking controller on the rigid-body plant with the
ground-truth base state (perfect_state True) and every rigid knob non-zero:
the load-gated swing lift (lift_gate_window, a static field), and the traced
knobs lag_gov, brake_speed, chest_lean_gain, crouch_gain, step_reach_len and
ang_mom_w (ang_mom_task_weight: the IK's angular-momentum rows), set in both
packages' DynConfig. The checks are those of tests/test_torch_rigid_loop.py
(initial state, both stages at a double-support and a left-swing tick, the
35-tick B = 2 episode tick by tick, unpushed and pushed, both stages from the
landing state), in float64 within F64_TOL, plus the MPC stage from the
states in which the CoM-lag governor and the overspeed brake act
(`governed_state`, `braking_state`). Each knob is shown to act on its own:
set to 0 (the lift gate: a controller built with it 0), it changes what a
stage computes from a state that the parity checks cover."""

import dataclasses

import numpy as np
import pytest
import torch

from cmw_tpu_torch.runtime import loop as TL
from test_torch_rigid_loop import PUSH_TICKS, check_episode, check_initial_state, check_landing_mpc_stage
from test_torch_rigid_loop import check_landing_wbc_stage, check_mpc_stage, check_wbc_stage, item_gap
from test_torch_rigid_loop import mpc_stage_vs_jax, rigid_rig, with_dyn

torch.set_num_threads(2)

KNOBS = dict(lag_gov=2.0, brake_speed=0.02, chest_lean_gain=1.5, crouch_gain=0.5, step_reach_len=0.8, ang_mom_w=0.5)
BRAKE_TICK = 20  # the pushed episode's tick at which the left foot is about to lift (its phase ends at 0.06 s)


@pytest.fixture(scope="module")
def rig():
    return rigid_rig(dict(perfect_state=True, lift_gate_window=0.3), dyn=KNOBS)


def governed_state(rig):
    """The pushed episode's JAX state entering tick 30 with lag_band 0: item
    0, pushed back against its forward stick, has its CoM behind the loaded
    support along the stick, so the CoM-lag governor scales its stick."""
    s = rig["pushed"][0][PUSH_TICKS]
    return s._replace(dyn=s.dyn._replace(lag_band=np.zeros_like(s.dyn.lag_band)))


def braking_state(rig):
    """The pushed episode's JAX state entering tick BRAKE_TICK, the left foot
    about to lift and the CoM moving faster than brake_speed, with the other
    gait-hold reasons switched off (gait_hold_thresh above any load, capture
    margins of 10 m, no forward release) and brake_margin 1 m: the overspeed
    brake alone holds the gait."""
    s = rig["pushed"][0][BRAKE_TICK]
    d = s.dyn
    full = lambda v: np.full_like(d.lag_band, v)  # noqa: E731
    return s._replace(dyn=d._replace(gait_hold_thresh=full(10.0), capture_margin_x=full(10.0),
                                     capture_margin_y=full(10.0), fwd_release=full(0.0), brake_margin=full(1.0)))


def test_knobs_initial_state_matches_jax(rig):
    check_initial_state(rig)
    for name, value in KNOBS.items():
        assert (getattr(rig["s0"]["f64"].dyn, name) == value).all()


@pytest.mark.parametrize("tick", [10, 40])
def test_knobs_wbc_stage_matches_jax(rig, tick):
    check_wbc_stage(rig, tick)


@pytest.mark.parametrize("tick", [0, 30])
def test_knobs_mpc_stage_matches_jax(rig, tick):
    check_mpc_stage(rig, tick)


def test_knobs_episode_matches_jax(rig):
    check_episode(rig)


def test_knobs_pushed_episode_matches_jax(rig):
    got = check_episode(rig, pushed=True)
    assert got["gait_rush"].max() > 0.0


def test_knobs_landing_mpc_stage_matches_jax(rig):
    check_landing_mpc_stage(rig)


def test_knobs_landing_wbc_stage_matches_jax(rig):
    check_landing_wbc_stage(rig)


@pytest.mark.parametrize("which", ["governed", "braking"])
def test_knobs_gait_mpc_stage_matches_jax(rig, which):
    state = governed_state(rig) if which == "governed" else braking_state(rig)
    _, got = mpc_stage_vs_jax(rig, state, rig["inputs"]["f64"])
    if which == "braking":
        assert (got.hold == 1.0).all()


def test_knobs_act(rig):
    """All the knobs together change what the controller computes: from the
    same states, the WBC stage with the knobs (and the lift gate) differs
    from the one with every knob at 0, and so does the MPC stage's governed
    joystick, read through the generator's rollout."""
    from cmw_tpu_torch import convert

    _, tctl = rig["ctls"]["f64"]
    tinp = rig["inputs"]["f64"][0]
    for tick in (10, 40):
        s = convert.loop_state_from_numpy(rig["pre"][tick]._asdict(), device="cpu", dtype=torch.float64)
        _, tel = tctl._wbc_stage(s, tinp)
        _, tel0 = tctl._wbc_stage(with_dyn(s, **{k: 0.0 for k in KNOBS}), tinp)
        assert np.abs(tel.dq_cmd.numpy() - tel0.dq_cmd.numpy()).max() > 1e-9
    assert all(float(getattr(s.dyn, k)[0]) == v for k, v in KNOBS.items())
    s = convert.loop_state_from_numpy(governed_state(rig)._asdict(), device="cpu", dtype=torch.float64)
    on = tctl._mpc_stage(s, tinp)
    off = tctl._mpc_stage(with_dyn(s, **{k: 0.0 for k in KNOBS}), tinp)
    assert float(item_gap(on.mann.com, off.mann.com)[0]) > 1e-9


@pytest.mark.parametrize("knob", ["lift_gate_window", *KNOBS])
def test_each_knob_acts(rig, knob):
    """Each knob alone, set to 0, changes what a stage computes from a state
    that the parity tests above cover: the item and the output where it acts.

      - lift_gate_window: the landing state's WBC stage, item 1 (early swing);
      - crouch_gain, chest_lean_gain, ang_mom_w: the pushed state of tick 30,
        WBC stage, item 0 (its capture point past the loaded toe);
      - step_reach_len: the landing state's MPC stage, item 1's landing;
      - lag_gov: governed_state's MPC stage, item 0's generator rollout;
      - brake_speed: braking_state's MPC stage, the gait hold of both items."""
    from cmw_tpu_torch import convert

    _, tctl = rig["ctls"]["f64"]
    walk, stand = rig["inputs"]["f64"][0], rig["stand"][0]
    to_port = lambda state: convert.loop_state_from_numpy(state._asdict(), device="cpu", dtype=torch.float64)  # noqa: E731
    if knob == "lift_gate_window":
        s, tel = check_landing_wbc_stage(rig)
        ungated = TL.WalkingController(dataclasses.replace(tctl.cfg, lift_gate_window=0.0), tctl.model, tctl.weights,
                                       device="cpu")
        _, off = ungated._wbc_stage(s, stand)
        assert float(item_gap(tel.dq_cmd, off.dq_cmd)[1]) > 1e-3
    elif knob in ("crouch_gain", "chest_lean_gain", "ang_mom_w"):
        s = to_port(rig["pushed"][0][PUSH_TICKS])
        _, tel = tctl._wbc_stage(s, walk)
        _, off = tctl._wbc_stage(with_dyn(s, **{knob: 0.0}), walk)
        assert float(item_gap(tel.dq_cmd, off.dq_cmd)[0]) > (1e-5 if knob == "ang_mom_w" else 1e-2)
    elif knob == "step_reach_len":
        check_landing_mpc_stage(rig)  # sets it to 0 on its own, item 1's landing moves
    elif knob == "lag_gov":
        s = to_port(governed_state(rig))
        on, off = (tctl._mpc_stage(with_dyn(s, lag_gov=v), walk) for v in (KNOBS["lag_gov"], 0.0))
        assert float(item_gap(on.mann.com, off.mann.com)[0]) > 1e-7
    else:  # brake_speed
        s = to_port(braking_state(rig))
        on, off = (tctl._mpc_stage(with_dyn(s, brake_speed=v), walk) for v in (KNOBS["brake_speed"], 0.0))
        assert (on.hold == 1.0).all() and (off.hold == 0.0).all()

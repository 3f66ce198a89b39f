"""The port's native runtime bindings and real-time walker
(`cmw_tpu_torch.runtime.native`, `runtime.realtime`, `apps.joypad`) on the
CPU, on a small controller (ergocub_gazebo_v1 at a 0.6 s MPC horizon, the
synthetic MANN weights at the published mann4 shapes):

  - the joypad mailbox -> TickInput path (tests/test_native.py:93's twin):
    exact values, latest wins, equal to JAX's `_tick_input` on the same
    writes;
  - `_mpc_task` / `_wbc_task` called by hand in `run_episode`'s order equal
    `run_episode` bitwise (the handoff of MPC_FIELDS), and MPC_FIELDS covers
    every field `_mpc_stage` writes;
  - a short headless run on the scheduler (tests/test_native.py:120's twin):
    no failure, ticks advance, the state stays finite; a task that raises
    stops the pipeline and is reported;
  - the terminal joypad's keys;
  - `walk --interactive --cpu` as a process of its own (it installs quit
    signal handlers) for a short window."""

import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from cmw_tpu.runtime import native as jnative
from cmw_tpu.runtime.realtime import RealtimeWalker as JaxWalker
from cmw_tpu_torch import convert
from cmw_tpu_torch.apps.joypad import TerminalJoypad
from cmw_tpu_torch.cmpc import ergocub_mpc_config
from cmw_tpu_torch.core import kinematics as kin
from cmw_tpu_torch.runtime import loop, native
from cmw_tpu_torch.runtime.config import ergocub_gazebo_v1
from cmw_tpu_torch.runtime.realtime import MPC_FIELDS, RealtimeWalker

torch.set_num_threads(2)

JOY = (0.5, 0.0, 1.0, 0.0)  # exact in f32


@pytest.fixture(scope="module")
def ctl():
    weights = convert.mann_weights_from_numpy(chip_smoke.synthetic_mann_numpy(), device="cpu")
    return loop.WalkingController(ergocub_gazebo_v1(mpc=ergocub_mpc_config(horizon=0.6)), kin.ergocub_approx(), weights,
                                  device="cpu")


def test_mailbox_to_tick_input_matches_jax(ctl):
    rw = RealtimeWalker(ctl)
    jw = JaxWalker.__new__(JaxWalker)  # JAX's walker without its jitted stages
    jw.joy_mailbox = jnative.Mailbox()
    jw.joy_mailbox.write(struct.pack("<4f", 0.0, 0.0, 1.0, 0.0))

    def same():
        got, want = rw._tick_input(), jw._tick_input()
        assert got.joypad.shape == (1, 4) and got.ext_force.shape == (1, 3) and got.ext_torque.shape == (1, 3)
        np.testing.assert_array_equal(got.joypad[0].numpy(), np.asarray(want.joypad))
        np.testing.assert_array_equal(got.ext_force[0].numpy(), np.asarray(want.ext_force))
        return got

    assert same().joypad[0].tolist() == [0.0, 0.0, 1.0, 0.0]
    for w in (rw, jw):
        JaxWalker.set_joypad(w, 0.7, -0.2, 0.5, 0.5)
    assert np.allclose(same().joypad[0].numpy(), [0.7, -0.2, 0.5, 0.5], atol=1e-6)
    for w in (rw, jw):  # latest wins
        JaxWalker.set_joypad(w, 0.1, 0.0)
        JaxWalker.set_joypad(w, 0.9, 0.0)
    assert float(same().joypad[0, 0]) == pytest.approx(0.9)


def test_tasks_by_hand_equal_run_episode(ctl):
    """mpc_every + 5 ticks (two MPC stages): the MPC task on each MPC tick,
    then the WBC task, against run_episode on the same constant joystick."""
    rw = RealtimeWalker(ctl)
    s0 = rw.state
    # MPC_FIELDS names every field the MPC stage writes: the rest come back untouched
    s1 = ctl._mpc_stage(s0, rw._tick_input())
    untouched = [f for f in loop.LoopState._fields if getattr(s1, f) is getattr(s0, f)]
    assert set(loop.LoopState._fields) - set(untouched) <= set(MPC_FIELDS)

    S = ctl.cfg.mpc_every + 5
    rw.set_joypad(*JOY)
    for k in range(S):
        if k % ctl.cfg.mpc_every == 0:
            assert rw._mpc_task(0.0)
        assert rw._wbc_task(0.0)
    assert rw.errors == []
    want_s, want_tel = ctl.run_episode(s0, loop.constant_inputs(S, JOY, device="cpu"))
    got, want = convert.loop_state_to_numpy(rw.state), convert.loop_state_to_numpy(want_s)
    flat_got, flat_want = dict(_leaves(got)), dict(_leaves(want))
    assert flat_got.keys() == flat_want.keys()
    for name, value in flat_want.items():
        np.testing.assert_array_equal(flat_got[name], value, err_msg=name)
    com = np.stack([c for _, c, _ in rw.telemetry])
    np.testing.assert_array_equal(com, want_tel.com_mpc[0].numpy())
    assert [t for t, _, _ in rw.telemetry][-1] == float(want_s.t[0])


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        yield from _leaves(tree._asdict(), prefix)
    elif tree is not None:
        yield prefix.rstrip("."), np.asarray(tree)


def test_headless_run(ctl):
    """2 s of wall at time scale 0.1 (a 20 ms WBC and 0.6 s MPC period), a
    joypad change mid-run: no failure, ticks, finite; the MPC and WBC stats."""
    rw = RealtimeWalker(ctl, time_scale=0.1)
    rw.set_joypad(0.5, 0.0)
    stats = rw.run(duration_s=2.0)
    assert not stats["failed"] and stats["errors"] == [], stats
    assert stats["ticks"] > 0 and stats["sim_time"] > 0.0 and stats["finite"], stats
    assert stats["mpc"]["runs"] > 0 and stats["wbc"]["runs"] == stats["ticks"], stats
    assert bool(torch.isfinite(rw.state.q).all())
    rw.set_joypad(0.0, 0.3)
    assert rw._tick_input().joypad[0, 1] == pytest.approx(0.3)


def test_a_task_that_raises_stops_the_pipeline(ctl):
    rw = RealtimeWalker(ctl, time_scale=0.1)

    def broken(s, inp):
        raise RuntimeError("a broken stage")

    rw.warmup()
    rw.warmup = lambda: None
    rw.ctl = type("Broken", (), {"cfg": ctl.cfg, "_mpc_stage": ctl._mpc_stage, "_wbc_stage": staticmethod(broken)})()
    stats = rw.run(duration_s=1.0)
    assert stats["failed"] and stats["ticks"] == 0
    assert any("a broken stage" in e for e in stats["errors"]), stats["errors"]


def test_joypad_keys():
    seen = []
    jp = TerminalJoypad(lambda *a: seen.append(a))
    for ch in "wwaq":
        assert jp.handle_key(ch)
    assert seen[-1] == pytest.approx((0.5, 0.25, np.cos(0.1), np.sin(0.1)))
    assert jp.handle_key(" ") and seen[-1] == (0.0, 0.0, 1.0, 0.0)
    assert not jp.handle_key("x")


def test_native_mailbox_and_scheduler():
    mb = native.Mailbox()
    assert mb.read() == (0, b"")
    mb.write(b"hello")
    mb.write(b"world!")
    assert mb.read() == (2, b"world!")
    sched = native.Scheduler()
    sched.add_task("dies", 0.01, lambda t: False)
    sched.start()
    sched.join()
    assert sched.any_failed() and not sched.is_running()


def test_walk_cli_interactive(tmp_path):
    """`walk --interactive --cpu` for 0.02 s of logical time at time scale
    0.1 (0.2 s of wall) with no terminal: the JSON stats of a run that did
    not fail."""
    mann = tmp_path / "mann4.onnx"
    mann.write_bytes(chip_smoke.mann_onnx_bytes(chip_smoke.synthetic_mann_numpy()))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "cmw_tpu_torch.apps.walk", "--cpu", "--interactive", "--mann", str(mann), "--seconds",
         "0.02", "--time-scale", "0.1"],
        cwd=root, env=dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="2"), stdin=subprocess.DEVNULL,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not stats["failed"] and stats["errors"] == [], stats

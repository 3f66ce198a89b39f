"""Interactive real-time walking on the native scheduler.

PyTorch counterpart of `cmw_tpu/runtime/realtime.py`, the re-composition of
the reference's process topology (Main.cpp:62-160): two periodic tasks on
the C++ scheduler (`runtime/native.py`), "MPC" (mpc.dt period: MANN +
CentroidalMPC stage) and "WBC" (wbc_dt period: estimator + stabilizer + IK
stage), exchanging state under a lock (the SharedResource pair), with
barrier-synchronized start, quit-signal handling, a liveness watchdog and
per-task deadline telemetry. A joypad source (`apps/joypad.py`, the
cmw-FakeJoypad analog) feeds the direction commands through a mailbox.

The walker drives one robot: the controller's state at B = 1, each tick's
`TickInput` [1, ...] built from the mailbox. On the card the stages replay
their graphs (`runtime/cache.py`: the WBC stage's, and the MPC stage's two
around its one host read), one thread at a time; each task waits for its
results by reading them back.
Logical time stays tick-driven; the virtual clock's time scale plays the
role of the reference's Gazebo real_time_factor. A task slower than its
period shows as deadline misses in the stats, not as a failure.

The tasks run in the scheduler's threads through ctypes callbacks: each one
makes the controller's card current in its thread, and lets no exception
out. An exception is kept in `errors` and the task reports failure, which
stops the scheduler (`stats["failed"]`).

The MPC task hands over every field `_mpc_stage` writes (`MPC_FIELDS`). JAX's
tuple (`cmw_tpu/runtime/realtime.py:29-41`) names eleven of them and drops the
seven others its `_mpc_stage` writes (the startup reference offset, the MANN
references, the gait hold, the slewed joystick and the stored generator
rollout), so its walker's slew and stored rollout never advance; with all of
them, the two tasks called in `run_episode`'s order reproduce `run_episode`
exactly.
"""

from __future__ import annotations

import struct
import threading
import time
import traceback

import numpy as np
import torch

from cmw_tpu_torch.runtime import native
from cmw_tpu_torch.runtime.loop import TickInput, WalkingController

MPC_FIELDS = (
    "warm",
    "plan",
    "forces0",
    "corner0",
    "active0",
    "zmp_des",
    "gen_state",
    "q_reg",
    "chest_yaw",
    "mpc_cost",
    "mpc_prim",
    "ref_off",
    "com_mann",
    "ang_mom_mann",
    "hold",
    "hold_time",
    "joypad_lp",
    "mann",
)


class RealtimeWalker:
    def __init__(self, ctl: WalkingController, time_scale: float = 0.1):
        self.ctl = ctl
        self.state = ctl.initial_state(1)
        self.lock = threading.Lock()
        self.joy_mailbox = native.Mailbox()
        self.joy_mailbox.write(struct.pack("<4f", 0.0, 0.0, 1.0, 0.0))
        self.time_scale = time_scale
        self.telemetry = []
        self.errors = []
        self.sched = native.Scheduler()
        dev = ctl.device
        self._card = None
        if dev.type == "cuda":
            self._card = dev.index if dev.index is not None else torch.cuda.current_device()

    # -- inputs ----------------------------------------------------------------

    def _tick_input(self) -> TickInput:
        _, data = self.joy_mailbox.read(64)
        joy = struct.unpack("<4f", data[:16]) if len(data) >= 16 else (0.0, 0.0, 1.0, 0.0)
        like = self.state.x9
        zero = torch.zeros(1, 3, dtype=like.dtype, device=like.device)
        return TickInput(joypad=torch.tensor([joy], dtype=like.dtype, device=like.device), ext_force=zero,
                         ext_torque=zero)

    def set_joypad(self, motion_x, motion_y, facing_x=1.0, facing_y=0.0):
        self.joy_mailbox.write(struct.pack("<4f", motion_x, motion_y, facing_x, facing_y))

    # -- tasks -------------------------------------------------------------------

    def _guarded(self, body):
        """Runs a task's body in a scheduler thread: on the controller's card,
        with no exception leaving (kept in `errors`; the task then fails)."""
        try:
            if self._card is not None:
                torch.cuda.set_device(self._card)
            return body()
        except Exception:
            self.errors.append(traceback.format_exc())
            return False

    def _mpc_step(self):
        with self.lock:
            s = self.state
        s2 = self.ctl._mpc_stage(s, self._tick_input())
        float(s2.mpc_prim[0])  # waits for the card
        with self.lock:
            # publish only MPC-owned fields (the WBC may have advanced)
            self.state = self.state._replace(**{f: getattr(s2, f) for f in MPC_FIELDS})
        return True

    def _wbc_step(self):
        with self.lock:
            s = self.state
        s2, tel = self.ctl._wbc_stage(s, self._tick_input())
        finite = bool(torch.isfinite(s2.q).all())  # waits for the card
        with self.lock:
            mpc_now = {f: getattr(self.state, f) for f in MPC_FIELDS}
            self.state = s2._replace(**mpc_now)
        self.telemetry.append((float(s2.t[0]), tel.com_mpc[0].cpu().numpy(), tel.foot_contact[0].cpu().numpy()))
        return finite

    def _mpc_task(self, _t=None):
        return self._guarded(self._mpc_step)

    def _wbc_task(self, _t=None):
        return self._guarded(self._wbc_step)

    # -- run -----------------------------------------------------------------------

    def warmup(self):
        """Run both stages once before the clocks start (the reference's y/n
        start gate, Main.cpp:118-128): the first calls build and load what
        the stages need and capture their graphs, the MPC stage's both
        (with and without a generator call: the MPC task's ticks drift
        against the WBC's, so either may come). The MPC stage's result is
        kept, the WBC stage's dropped."""
        inp = self._tick_input()
        self.ctl.warm_mpc_stage(self.state, inp)
        s2 = self.ctl._mpc_stage(self.state, inp)
        self.state = self.state._replace(**{f: getattr(s2, f) for f in MPC_FIELDS})
        s3, _ = self.ctl._wbc_stage(self.state, inp)
        float(s3.q[0, 0])

    def run(self, duration_s: float, install_signals: bool = False) -> dict:
        """Run the two-task pipeline for `duration_s` wall seconds."""
        cfg = self.ctl.cfg
        self.warmup()
        scale = self.time_scale
        mpc_id = self.sched.add_task("MPC", cfg.mpc.dt / scale, self._mpc_task)
        wbc_id = self.sched.add_task("WBC", cfg.wbc_dt / scale, self._wbc_task)
        self.sched.set_time_scale(scale)
        if install_signals:
            self.sched.handle_quit_signals()
        self.sched.start()
        t0 = time.monotonic()
        # watchdog loop (Main.cpp:137-145)
        while time.monotonic() - t0 < duration_s and self.sched.is_running():
            time.sleep(0.1)
        self.sched.request_stop()
        self.sched.join()
        stats = {
            "failed": self.sched.any_failed(),
            "mpc": self.sched.task_stats(mpc_id),
            "wbc": self.sched.task_stats(wbc_id),
            "ticks": len(self.telemetry),
            "sim_time": float(self.state.t[0]),
            "errors": list(self.errors),
        }
        if self.telemetry:
            com = np.stack([c for (_, c, _) in self.telemetry])
            stats["com_final"] = [round(float(v), 4) for v in com[-1]]
            stats["finite"] = bool(np.isfinite(com).all())
        return stats

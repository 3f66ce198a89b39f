"""Closed-loop walking demo (the reference's `cmw-walking`).

Runs the MANN -> CentroidalMPC -> WBC loop on the card for a scripted
joystick schedule and writes telemetry (npz). `--joystick` segments
"t0:mx,my,fx,fy" change the command at time t0. The counterpart of
`python -m cmw_tpu.apps.walk`, with the same flags; `--robot-dir` reads a
reference-style ini config directory (`runtime/ini.py`), `--interactive`
drives the walker with the terminal joypad on the native real-time scheduler
(`runtime/realtime.py`).

The walk is one robot (B = 1), so its telemetry file has JAX's layout:
channels [S, ...] and JAX's metadata keys, which JAX's readers take. The
state checkpoints (`--save-state`, `--resume-state`) keep the port's own
format (`runtime/checkpoint.py`): the two packages' state trees differ, so
neither reads the other's.

Example:
  python -m cmw_tpu_torch.apps.walk --seconds 4 --mann mann4.onnx --joystick 0:1,0,1,0 2:0,1,1,0
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from cmw_tpu_torch.apps.joypad import TerminalJoypad
from cmw_tpu_torch.core import kinematics as kin
from cmw_tpu_torch.mann.network import load_mann_weights
from cmw_tpu_torch.runtime import checkpoint, telemetry
from cmw_tpu_torch.runtime.config import ergocub_gazebo_v1, ergocub_sn000
from cmw_tpu_torch.runtime.ini import load_robot_config
from cmw_tpu_torch.runtime.loop import TickInput, WalkingController
from cmw_tpu_torch.runtime.realtime import RealtimeWalker


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--robot", default="ergoCubGazeboV1", choices=["ergoCubGazeboV1", "ergoCubSN000"])
    p.add_argument(
        "--robot-dir",
        default=None,
        help="load the WalkingConfig from a reference-style ini config dir "
        "(e.g. .../config/robots/ergoCubGazeboV1); overrides --robot",
    )
    p.add_argument(
        "--mann",
        default="src/centroidal-mpc-walking/config/robots/ergoCubGazeboV1/onnx_50_mann4_smaller_steps.onnx",
        help="the MANN ONNX file (default: the reference repository's mann4 file, from the root of its "
        "checkout; it is not in this repository)",
    )
    p.add_argument("--urdf", default=None,
                   help="robot URDF: 'builtin' (the checked-in ergoCub model) or a path (default: built-in model)")
    p.add_argument("--joystick", nargs="*", default=["0:1,0,1,0"], help="t0:mx,my,fx,fy segments")
    p.add_argument("--push", default=None, help="t0,t1,fx,fy,fz external push window")
    p.add_argument("--out", default="walk_telemetry.npz")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    p.add_argument(
        "--interactive",
        action="store_true",
        help="drive with the terminal joypad on the native real-time scheduler "
        "(the reference's cmw-FakeJoypad + AdvanceableRunner mode)",
    )
    p.add_argument(
        "--time-scale",
        type=float,
        default=0.05,
        help="interactive virtual-clock rate vs wall time (the Gazebo real_time_factor analog)",
    )
    p.add_argument("--save-state", default=None, help="write a loop-state checkpoint here")
    p.add_argument("--resume-state", default=None, help="resume from a loop-state checkpoint")
    args = p.parse_args(argv)

    dev = "cpu" if args.cpu else "cuda"
    if args.robot_dir:
        cfg = load_robot_config(args.robot_dir)
    else:
        cfg = ergocub_gazebo_v1() if args.robot == "ergoCubGazeboV1" else ergocub_sn000()
    if args.urdf:
        model = kin.ergocub_urdf(None if args.urdf == "builtin" else args.urdf)
    else:
        model = kin.ergocub_approx()
    ctl = WalkingController(cfg, model, load_mann_weights(args.mann, device=dev), device=dev)

    if args.interactive:
        rw = RealtimeWalker(ctl, time_scale=args.time_scale)
        if args.resume_state:
            rw.state = checkpoint.load(args.resume_state, rw.state)
        jp = TerminalJoypad(rw.set_joypad)
        jp.start()
        print("interactive walk: w/s fwd/back, a/d left/right, q/e yaw, space stop, x quit (Ctrl-C to end)", flush=True)
        try:
            stats = rw.run(args.seconds / args.time_scale, install_signals=True)
        finally:
            jp.stop()
        if args.save_state:
            checkpoint.save(args.save_state, rw.state, meta={"t": float(rw.state.t[0])})
        print(json.dumps(stats))
        return stats

    S = int(round(args.seconds / cfg.wbc_dt))
    joy = np.zeros((S, 4), np.float32)
    segs = []
    for seg in args.joystick:
        t0, vals = seg.split(":")
        segs.append((float(t0), [float(v) for v in vals.split(",")]))
    for t0, vals in sorted(segs):
        joy[int(t0 / cfg.wbc_dt):] = vals
    ext = np.zeros((S, 3), np.float32)
    if args.push:
        t0, t1, fx, fy, fz = [float(v) for v in args.push.split(",")]
        ext[int(t0 / cfg.wbc_dt):int(t1 / cfg.wbc_dt)] = [fx, fy, fz]
    inputs = TickInput(*(torch.from_numpy(a)[None].to(dev) for a in (joy, ext, np.zeros((S, 3), np.float32))))

    s0 = ctl.initial_state(1)
    if args.resume_state:
        s0 = checkpoint.load(args.resume_state, s0)
    t = time.perf_counter()
    sN, tel = ctl.run_episode(s0, inputs)
    com = tel.com_mpc[0].cpu().numpy()  # waits for the card
    wall = time.perf_counter() - t
    if args.save_state:
        checkpoint.save(args.save_state, sN, meta={"t": float(sN.t[0])})

    telemetry.save(args.out, tel, cfg.wbc_dt, extra={"robot": args.robot}, item=0)
    summary = {
        "ticks": S,
        "sim_seconds": args.seconds,
        "wall_seconds": round(wall, 2),
        "realtime_factor": round(args.seconds / wall, 2),
        "com_travel_xy": [round(float(com[-1, i] - com[0, i]), 3) for i in (0, 1)],
        "com_z_range": [round(float(com[:, 2].min()), 3), round(float(com[:, 2].max()), 3)],
        "finite": bool(np.isfinite(com).all()),
        "mpc_prim_max": float(tel.mpc_prim.max()),
        "telemetry": args.out,
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()

"""Batched push-recovery sweep (BASELINE config 5).

Runs B perturbed closed-loop scenarios (push pulses of varying magnitude,
along x or y) as one batch on the card, optionally split over the ranks of
a process group (dist/). Prints survival statistics and throughput as one
JSON line. The counterpart of `python -m cmw_tpu.apps.sweep`, with the same
flags, defaults and keys.

Examples:
  python -m cmw_tpu_torch.apps.sweep --batch 64 --seconds 2 --mann mann4.onnx
  python -m cmw_tpu_torch.apps.sweep --cpu --batch 8 --seconds 0.06 --mann mann4.onnx
  torchrun --nproc-per-node 4 -m cmw_tpu_torch.apps.sweep --mesh --batch 2048 --mann mann4.onnx
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
import torch.distributed as dist

from cmw_tpu_torch.cmpc.formulation import no_adjust
from cmw_tpu_torch.core import kinematics as kin
from cmw_tpu_torch.core.centroidal import GRAVITY
from cmw_tpu_torch.dist.sweep import run_sweep
from cmw_tpu_torch.mann.network import load_mann_weights
from cmw_tpu_torch.runtime import cache
from cmw_tpu_torch.runtime.config import ergocub_gazebo_v1
from cmw_tpu_torch.runtime.loop import WalkingController
from cmw_tpu_torch.sim.rigid_body import RigidBodyConfig
from cmw_tpu_torch.wbc.swing_foot import SwingFootConfig


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--push-max", type=float, default=2.0)
    p.add_argument(
        "--push-duration",
        type=float,
        default=0.4,
        help="push window length [s]; sustained pushes (>=1.5) are the "
        "regime where footstep adjustment separates from pinned footsteps",
    )
    p.add_argument("--mesh", action="store_true",
                   help="split the batch over the ranks of the process group the launcher (torchrun) sets up")
    p.add_argument("--kkt", default=None, choices=["dense", "riccati"],
                   help="force MPCConfig.kkt_impl (A/B the solver x-update)")
    p.add_argument("--chunk", type=int, default=512,
                   help="scenarios per chunk, run one after another (bounds peak memory)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    p.add_argument(
        "--no-adjust",
        action="store_true",
        help="pin footsteps to nominal (disable the MPC's contact-location "
        "decision variables: the paper's step-adjustment ablation)",
    )
    p.add_argument(
        "--ablation",
        action="store_true",
        help="run the sweep twice (step adjustment on/off) and report both",
    )
    p.add_argument("--per-scenario", action="store_true", help="include per-scenario masks in the JSON")
    p.add_argument(
        "--fz-max",
        type=float,
        default=None,
        help="per-corner normal-force cap in units of g (mass-normalized). "
        "The default (3g) leaves force authority effectively unconstrained; "
        "a realistic leg (~1.6x body weight => ~0.4g/corner) saturates under "
        "large pushes, which is the regime where footstep adjustment matters",
    )
    p.add_argument(
        "--vx",
        type=float,
        default=None,
        help="commanded forward velocity (default: 0.8 adherent, 0.0 rigid: "
        "the physical gait steps in place while pushed, the paper's "
        "push-recovery protocol)",
    )
    p.add_argument(
        "--ramp",
        type=float,
        default=None,
        help="joystick ramp-in seconds (default: 1.0 rigid, 0 adherent)",
    )
    p.add_argument(
        "--push-t0",
        type=float,
        default=0.6,
        help="push window start [s] (move past the ramp for rigid runs)",
    )
    p.add_argument(
        "--rigid",
        action="store_true",
        help="run the scenarios on the rigid-body dynamics plant "
        "(sim/rigid_body.py, the Gazebo stand-in) instead of the adherent "
        "kinematic plant; the fall criterion becomes the physical base "
        "tipping over or collapsing",
    )
    p.add_argument(
        "--op-point",
        action="store_true",
        help="apply the measured rigid-gait operating point "
        "(perfect_state, com_height_drop=0.10, swing_height=0.07)",
    )
    p.add_argument(
        "--mann",
        default="src/centroidal-mpc-walking/config/robots/ergoCubGazeboV1/onnx_50_mann4_smaller_steps.onnx",
        help="the MANN ONNX file (default: the reference repository's mann4 file, from the root of its "
        "checkout; it is not in this repository)",
    )
    args = p.parse_args(argv)

    dev = "cpu" if args.cpu else "cuda"
    started = args.mesh and not dist.is_initialized() and "WORLD_SIZE" in os.environ
    if started:
        # the launcher's environment names the group; without one run_sweep
        # refuses use_mesh
        dist.init_process_group("gloo" if args.cpu else "nccl")
        if not args.cpu:
            dev = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
            torch.cuda.set_device(dev)
    try:
        _sweep(args, dev)
    finally:
        if started:
            dist.destroy_process_group()


def _sweep(args, dev):
    model = kin.ergocub_approx()
    weights = load_mann_weights(args.mann, device=dev)

    def run(adjust: bool) -> dict:
        cfg = ergocub_gazebo_v1()
        mpc = cfg.mpc
        if args.fz_max is not None:
            mpc = dataclasses.replace(mpc, fz_max=args.fz_max * GRAVITY)
        if args.kkt is not None:
            mpc = dataclasses.replace(mpc, kkt_impl=args.kkt)
        if not adjust:
            mpc = no_adjust(mpc)
        kw = {}
        if args.rigid:
            kw["rigid"] = RigidBodyConfig()
            if args.op_point:
                kw.update(perfect_state=True, com_height_drop=0.10, swing=SwingFootConfig(step_height=0.07))
            if not adjust:
                # step adjustment off must also pin the WBC-side capture-step
                # extension, step adjustment by another mechanism
                kw["step_ext_max"] = 0.0
        cfg = ergocub_gazebo_v1(mpc=mpc, **kw)
        ctl = WalkingController(cfg, model, weights, device=dev)
        t = time.perf_counter()
        vx = args.vx if args.vx is not None else (0.0 if args.rigid else 0.8)
        ramp = args.ramp if args.ramp is not None else (1.0 if args.rigid else 0.0)
        stats = run_sweep(
            ctl,
            batch=args.batch,
            seconds=args.seconds,
            push_max=args.push_max,
            use_mesh=args.mesh,
            chunk=args.chunk,
            per_scenario=args.per_scenario,
            push_duration=args.push_duration,
            vx=vx,
            ramp=ramp,
            push_t0=args.push_t0,
            # the commanded-walking gait criterion at the operating point
            # (dist/sweep._shard_metrics)
            up_thresh=0.7 if (args.rigid and args.op_point) else 0.9,
            model_guards=not (args.rigid and args.op_point),
        )
        wall = time.perf_counter() - t  # run_sweep read its results back from the card
        cache.clear()  # this arm's graphs (the other arm's controller keys its own)
        stats.update(
            {
                "step_adjustment": adjust,
                "wall_seconds": round(wall, 2),
                "scenario_seconds_per_s": round(args.batch * args.seconds / wall, 2),
                "devices": dist.get_world_size() if args.mesh else 1,
            }
        )
        return stats

    if args.ablation:
        on, off = run(True), run(False)
        out = {"adjust_on": on, "adjust_off": off,
               "survival_gain": round(on["survival_rate"] - off["survival_rate"], 3)}
    else:
        out = run(not args.no_adjust)
    if not args.mesh or dist.get_rank() == 0:
        print(json.dumps(out))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`cmw_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives `CentroidalMPCSolver.solve` of the port at the production
configuration (ergocub_mpc_config(): T = 20, 504 variables, 1,304 constraint
rows, sqp 2 x admm 24) on the card, through the same entry points a user
calls, alone and fed by the MANN trajectory generator, and checks it:

  1. the card's name and power limit; the kernels' build from csrc/*.cu (one
     nvcc per source, all started together); a probe of whether
     torch.profiler records the card's work (every profile of phases 7-10
     reads "not measured" where it records none);
  2. each hand-written kernel against its plain PyTorch twin on the card:
     the SPD inverse (||I - M X||_inf < 1e-4 and agreement with the twin
     within INV_RTOL max|X| on real walking KKT matrices, on a badly scaled
     random SPD matrix and at the ragged sizes n in {1, 24, 33, 100, 504} at
     B in {1, 8}; the residual on 8 items of the B = 512 walking-KKT
     inverse), the packed symv (rtol 2e-5 / atol 1e-4, at (B, nb) in
     K4_SHAPES and on the packed walking-KKT inverse; two launches on the same
     inputs bitwise equal) and the fused ADMM loop (compaction + cluster
     loop) on real walking QPs (minv from the SPD-inverse kernel, A from
     constraint_dense, q from the cold-start linearisation) at B = 4 and
     B = 512, on a dense random A at B = 4 (the kernel's dense branch; at
     n = 40, m = 56, and at n = 504, m = 1,304 in f32, its bf16 modes printed
     beside the twin's own f32-vs-f64 gap), at ragged sizes (n = 37, m = 50,
     B = 4, two items with a row over the row cap) and at the sizes of the
     longer horizons K5_HORIZONS, which take the kernel's other launches (16
     blocks a cluster; one block per scenario with and without the lists):
     a sparse random A at B = 4 (the bf16 modes over K5_SHORT_ITERS), and
     walking QPs at B = 4, printed beside the twin's own f32-vs-f64 gap, not
     held; iters = 24, for each operand precision, within ADMM_TOL, two
     launches on the same inputs bitwise equal;
  3. the dense-KKT main path with the batched ADMM loop (K3, K4): a cold
     solve and 10 warm-started receding-horizon ticks at B = 1, the
     lateral-push footstep check, then the bench shape (`apps.bench`'s
     parameters and chain: B = 512 pushes, KB = 4 warm-started solves); both
     kernels' launch counts must rise;
  4. the dense-KKT main path with the fused ADMM kernel (K3, K5,
     admm_impl="fused"): the same chains; K5 must launch exactly sqp_iters
     times per solve and K4 never;
  5. the default Riccati main path (plain PyTorch), the same chains;
  6. numerics sentinel: the card's dense solve vs the port's plain CPU solve,
     the card's Riccati and fused solves vs its dense solve and the fused vs
     the Riccati solve, each within |dcost| <= 0.005 (|cost| + 1) and
     prim_res < 1e-2; the bench chains of the three paths against each other,
     and the dense chain once more with the batched-matmul x-update (no K4)
     against all three;
  7. timings (printed, not asserted): each kernel at B = 1 and B = 512 beside
     its bound (and, where bytes set it, the rate reached on those bytes),
     its plain twin and, where one exists, the one PyTorch call
     that computes the same function, and K5 at the longer horizons; one
     torch.profiler pass over an SPD inverse, a packed symv and a fused ADMM
     call at B = 1 and at B = 512, with the device time and count of each of
     its kernels, and the device time of torch.matmul on the unpacked matrix
     beside K4's; K5's launch at each horizon and how many of its clusters
     the card runs at once; each
     path's B = 1 warm tick (its B = 512 x KB = 4 rate is phase 13's);
  8. joystick -> MANN -> MPC, the MPC stage of the walking controller
     (`WalkingController._mpc_stage` on the kinematic plant, from
     `initial_state` at the walk-ready pose) on the checked-in ergoCub URDF,
     with SYNTHETIC MANN weights at the published mann4 shapes (numpy seed;
     the shipped ONNX weights are not in the repository): the 40-step
     generator at B = 1 and B = 256 on the card against the port on the CPU
     in f64 (contact flags identical, every channel within GEN_TOL); one MPC
     tick at B = 256 on the fused (K3, K5) and the Riccati path, held against
     each other and against the port's CPU stage in f64 on 4 items within the
     sentinel, then RECEDING_TICKS receding fused stages at B = 1, each
     re-rooting the generator mann_advance knots in (`coast` carries the
     MPC's plant one period on between them, as the WBC ticks would); K3 and
     K5 must launch in the phase (K5 sqp_iters
     times per fused solve); printed: the generator's wall per call at
     B = 1 and B = 256, one profiled generator call (device time, kernels,
     idle share) and the B = 1 tick's p50;
  9. the closed loop, joystick -> MANN -> MPC -> swing foot / ZMP / CoM-ZMP /
     IK -> integration (`cmw_tpu_torch.runtime.loop.WalkingController`, the
     kinematic plant), tick after tick: CLOSED_TICKS at B = 1 on the fused MPC
     (K3, K5) against the port on the CPU in f64 (contact flags and fixed feet
     identical on every tick, every telemetry channel within CLOSED_TOL over
     the first MPC period), 30 ticks at B = 1 on the dense MPC (K3, K4), 60
     ticks at B = 256 on the lifted weights with random joysticks (4 items
     against the CPU f64, a foot in swing), each episode within mpc_prim <
     1e-2 and |com_meas - com_mpc|_xy < 0.09; K5 must launch sqp_iters times
     per MPC tick; printed: the WBC tick's wall at B = 1 and 256 (with the
     number of operations in it that waited for the card), the MPC stage's
     wall, and one profiled MPC period at B = 256 split by the loop's spans;
 10. the closed loop on the rigid-body plant (`cfg.rigid`, the Gazebo
     stand-in: Lagrangian dynamics, penalty contact at the 8 sole corners,
     servos, 2 substeps a tick), joystick -> MANN -> MPC -> IK -> dynamics:
     `initial_state` settles the plant (total corner fz within 10 % of mg,
     |nu| < 0.1); RIGID_TICKS standing at B = 1 on the fused MPC (K3, K5)
     against the port on the CPU in f64 from the same settled state (contact flags, fixed feet and
     active corners identical on every tick, every channel within RIGID_TOL
     over the first MPC period); 60 ticks at B = 256 on the lifted weights
     with random joysticks and per-item contact_mu and servo_kp (4 items
     against the CPU f64); on every tick base_act_up > 0.8, base z > 0.55 m,
     mpc_prim < 1e-2 and every channel finite; K5 must launch sqp_iters
     times per MPC tick and a rigid WBC tick must not wait for the card;
     printed: the settle's wall, the rigid WBC tick's wall at B = 1 and 256,
     its launches, and one profiled B = 256 rigid WBC tick by span (the MPC
     stage's spans are phase 9's);
 11. the push-recovery sweep and the walk through their command lines: a
     512-scenario sweep by `cmw_tpu_torch.apps.sweep.main` (SWEEP_ARGS: two
     chunks of 256, 0.6 s, the dense MPC, the kinematic plant, the synthetic
     weights written as an ONNX file by `mann_onnx_bytes`) printing exactly
     the JAX CLI's keys, survival_rate in [0, 1], finite statistics, K3 and
     K4 launched once and sqp_iters x admm_iters times per MPC stage, K5
     never; its largest pushes (SWEEP_CHECKED) against the port on the CPU
     in f64 (survival identical, each metric within SWEEP_TOL); the walk CLI
     at B = 1 split by a checkpoint (--save-state, --resume-state) ending
     where the straight run ends (bitwise, else within CLOSED_TOL), its
     telemetry files loading; printed: the sweep's wall and scenario-s/s,
     the survivors and the recoverable-push radii;
 12. the remaining entry points, each part with its wall: the dense KKT's
     bf16 option (kkt_dtype="bf16", kkt_f32_tail in BF16_TAILS) as the
     B = 512 x KB = 4 chain, its solves/s beside the f32 dense chain's, and
     on B = 4 converged solves (BF16_ENVELOPE) within JAX's envelope against
     f32 (prim_res < 5e-2, cost within 8 %), K3 launched and K4 and K5 not;
     the parity CLI (`apps.parity.main([])`: the solve on the card, the scipy
     oracle beside it) with parity_ok true; the walk CLI with `--robot-dir`
     on a directory written from ergocub_gazebo_v1() (`write_robot_dir`,
     which must load back to that config) for ROBOT_DIR_SECONDS, finite; a
     headless `RealtimeWalker` on the native scheduler for WALKER_SECONDS
     with the stick changed mid-run (no failure, ticks, finite; both tasks'
     stats and deadline misses printed); `entry()`, `dryrun_multichip(1)`
     (NCCL, one rank) and `apps.scaling.main(["--devices", "1"])`;
 13. the benchmark entry points at B = 512, stdout captured: `apps.bench.main
     (["--full", ...])` printing exactly one line with bench.py's keys
     (BENCH_KEYS), numerics_ok true, a finite positive value, mfu_est and
     hbm_bw_util_est in (0, 1.05], its extras file printed;
     `apps.bench_kkt` both and fused; `apps.breakdown`; each call's launches
     held exactly (the Riccati headline none, dense K3 once and K4
     sqp x admm times a solve, fused K5 sqp times a solve and K4 never).
     BENCH_REPS and BENCH_SAMPLES cut the CLIs' repetitions for time.

It imports nothing of JAX. Without a CUDA device it fails. The last two
lines are the kernels' JSON record and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

from cmw_tpu_torch import convert
from cmw_tpu_torch.apps import bench as BENCH
from cmw_tpu_torch.cmpc import CentroidalMPCSolver, ergocub_mpc_config
from cmw_tpu_torch.cmpc import formulation as F
from cmw_tpu_torch.core import contacts
from cmw_tpu_torch.core import kinematics as kin
from cmw_tpu_torch.core.centroidal import centroidal_dynamics
from cmw_tpu_torch.core.integrators import rk4_step
from cmw_tpu_torch.dist import sweep as DS
from cmw_tpu_torch.dist.sweep import items_of
from cmw_tpu_torch.mann import generator as G
from cmw_tpu_torch.mann import input_builder as IB
from cmw_tpu_torch.mann import network as N
from cmw_tpu_torch.ops import _build
from cmw_tpu_torch.ops import admm_fused as K5
from cmw_tpu_torch.ops import roofline as R
from cmw_tpu_torch.ops import spd_inverse as K3
from cmw_tpu_torch.ops import symv as K4
from cmw_tpu_torch.runtime import checkpoint
from cmw_tpu_torch.runtime import loop as RL
from cmw_tpu_torch.runtime import telemetry as RT
from cmw_tpu_torch.runtime.config import ergocub_gazebo_v1
from cmw_tpu_torch.sim import rigid_body as RB

RESID_TOL = 1e-4  # ||I - M X||_inf, the inverse's done-check
INV_RTOL = 1e-4  # kernel vs twin, atol INV_RTOL * max|X| (tests/test_torch_ops.py)
K3_SIZES = (1, 24, 33, 100, 504)  # one tile, full + 1-wide, ragged 4-wide last tile, production n
# K3's kernels by name in csrc/spd_inverse.cu, with the stage each runs
K3_STAGES = (("diagonal_kernel", "diagonal factor"), ("panel_kernel", "panel"), ("trailing_kernel", "trailing update"),
             ("triinv_kernel", "triangular inverse"), ("output_kernel", "output S X^T X S"))
K4_STAGES = (("partials_kernel", "row and column partials"), ("reduce_kernel", "fixed-order reduce"))  # csrc/symv.cu
K5_STAGES = (("compact_kernel", "compaction of A"), ("loop_kernel", "cluster loop"))  # csrc/admm_fused.cu
SYMV_RTOL, SYMV_ATOL = 2e-5, 1e-4  # f32 sums in another order (tests/test_ops.py:138)
# K4's (B, nb): one item and the bench batch at one, two and four blocks a
# side (n = 512 is the main path's), and nb = 9 past the old cap of 8
K4_SHAPES = tuple((B, nb) for B in (1, 512) for nb in (1, 2, 4)) + ((3, 9),)
ADMM_ITERS = 24  # the production admm_iters
WARM_TICKS = 12  # phase 7's timed B = 1 warm ticks a path, after a cold one (cut from 20 for the script's time)
# horizons (T at dt = 0.06) past the production T = 20 whose sizes take K5's
# other launches: 16 blocks a cluster (T = 22), one block per scenario with the
# lists (T = 33) and without them, every scenario on the dense branch (T = 60)
K5_HORIZONS = (22, 33, 60)
# At those sizes one flipped bf16 rounding grows over 24 iterations past
# ADMM_TOL's median even between the twin with f32 and with f64 sums (sparse
# random A at n = 816: bf16x2 median 1.5e-2; walking QPs at T = 60 even in
# f32: 3.5e-4; CPU), so their bf16 modes are held over 4 iterations (that gap
# 2e-7), and the walking QPs there are printed beside their own gap
K5_SHORT_ITERS = 4
# Fused ADMM kernel vs twin, 24 iterations: per scenario, max |diff| /
# (max |twin| + 1) over (x, zc, y); the tolerances bound the largest and the
# median over the scenarios. The noise, from the twin in f32 against the twin
# in f64 on 128 walking QPs like these (CPU): f32 at most 1.2e-5 (sums in
# another order; KKT rows span rho 10..1e4). In the bf16 modes each side
# rounds its own vector operand, whose entries reach ~1e4, to bf16: an f32 ulp
# flips a rounding and the loop carries it on, in a few scenarios up to 0.12,
# with a median of 2.5e-4; a scenario run in another mode differs by a median
# of 3.6e-2 or more. So the median tells the modes apart and the largest only
# bounds the drift.
ADMM_TOL = {"f32": (1e-4, 1e-4), "bf16": (0.5, 2e-3), "bf16x2": (0.5, 2e-3)}  # (largest, median)


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def params_at(cfg, pushes, t0, x0=None, device="cuda"):
    """apps.bench's parameters (one item per push row [B, 3]) moved to start
    time `t0`, a float or a tensor [B] of one start time per item, the CoM
    reference moved with it, and starting from x0 [B, 9] where given."""
    p = BENCH.make_params(cfg, pushes, device=device)
    B = pushes.shape[0]
    plan = contacts.snap_to_grid(contacts.make_alternating_gait(n_steps=8, device=device), cfg.dt)
    if isinstance(t0, torch.Tensor):
        plan = type(plan)(*[a.expand((B,) + a.shape) for a in plan])
        stage = contacts.mpc_stage_params(plan, t0.to(device), cfg.T, cfg.dt, cfg.n_slots)
        stage = type(stage)(*[a.contiguous() for a in stage])
        shift = (t0.to(device) - BENCH.T0)[:, None, None]
    else:
        stage = contacts.mpc_stage_params(plan, t0, cfg.T, cfg.dt, cfg.n_slots)
        stage = type(stage)(*[a.expand((B,) + a.shape) for a in stage])
        shift = t0 - BENCH.T0
    ahead = torch.tensor([1.0, 0.0, 0.0], device=device)
    return p._replace(stage=stage, com_ref=p.com_ref + 0.08 * shift * ahead, x0=p.x0 if x0 is None else x0)


def lateral(values, device="cuda"):
    """[n, 3]: pushes along y at the given values (apps.bench.lateral_pushes
    builds the linspace(-1, 1) ones)."""
    v = torch.as_tensor(values, dtype=torch.float32, device=device)
    return torch.stack([torch.zeros_like(v), v, torch.zeros_like(v)], dim=-1)


def cold_linearisation(cfg, params):
    """What the dense solve builds at its cold-start point z0: the KKT matrix
    M = H0 + sigma I + A^T rho A, and the fused ADMM kernel's inputs other
    than minv: (A dense, q = g - H0 z0, l, u, rho, z0, zc0 = clip(A z0), y0 = 0)."""
    solver = CentroidalMPCSolver(cfg)
    B, device = params.x0.shape[0], params.x0.device
    z0 = solver._initial_z(params, solver.cold_start(B, device=device))
    J = torch.func.vmap(torch.func.jacfwd(lambda p, z: F.residuals(cfg, p, z), argnums=1))(params, z0)
    r = F.residuals(cfg, params, z0)
    l, u, rho = F.constraint_bounds(cfg, params.stage)
    eye = torch.eye(cfg.n_vars, device=device)
    Jt = J.transpose(-1, -2)
    H = Jt @ J + cfg.levenberg * eye
    M = H + cfg.admm_sigma * eye + F.ata_blockdiag(cfg, params.stage, rho)
    q = (Jt @ r[..., None] - H @ z0[..., None])[..., 0]
    A = F.constraint_dense(cfg, params.stage)
    zc0 = torch.clamp((A @ z0[..., None])[..., 0], l, u)
    return M.contiguous(), (A, q.contiguous(), l, u, rho, z0, zc0, torch.zeros_like(zc0))


def resid(M, X):
    eye = torch.eye(M.shape[-1], device=M.device, dtype=torch.float64)
    return float((eye - M.double() @ X.double()).abs().max())


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scaled_spd(B, n, gen, device="cuda"):
    """A badly scaled SPD matrix (tests/test_torch_ops.py scaled_spd, drawn on the card)."""
    A = torch.randn(B, n, n, device=device, generator=gen) * 0.02
    H = A @ A.transpose(1, 2) + torch.eye(n, device=device)
    k = min(n, 50)
    H[:, :k, :k] += 1e4 * torch.eye(k, device=device)  # rho_eq-like rows
    return H


def check_spd_inverse(name, M):
    """K3 against its twin: the residual of both and the largest difference;
    fails unless the kernel meets the done-check and agrees with the twin."""
    X = K3.spd_inverse(M)
    torch.cuda.synchronize()
    Xr = K3.spd_inverse_ref(M)
    torch.cuda.synchronize()
    rk, rr = resid(M, X), resid(M, Xr)
    err = float((X - Xr).abs().max())
    rel = err / float(Xr.abs().max())
    print(f"phase 2 K3 spd_inverse {name} {list(M.shape)}: ||I-MX||_inf kernel {rk:.3e} twin {rr:.3e}; "
          f"max|X-Xref| {err:.3e} (rel {rel:.3e})")
    require(rk < RESID_TOL, f"K3 residual {rk} >= {RESID_TOL} on {name}")
    require(rel <= INV_RTOL, f"K3 differs from its twin by {rel} of max|X| on {name}")
    return err


# A torch.profiler session in this long script loses the kernel records of
# its first moments (on an H100, torch 2.11: the first 4 of K3's 48 launches
# in every pass, all of K4's, K5's and torch.matmul's; once every record of a
# K3 call), though a fresh process records them. So every session is fenced:
# FENCE_PADS torch.cuda._sleep kernels and a FENCE_WAIT_S wait before the
# profiled call, one more after it, and a pass counts only where the first
# and the last kernel it recorded are fences, i.e. where it kept the whole
# call; a pass that does not is taken again, up to PROFILE_PASSES times.
# What is still not recorded reads "not measured": the profiles are timings
# and nothing held reads them (the launches are the wrappers' counts, the
# times CUDA events'). Where phase 1's probe finds that the profiler records
# nothing, no profile is taken.
PROFILE_PASSES = 3
FENCE, FENCE_PADS, FENCE_WAIT_S = "spin_kernel(", 64, 0.02
PROFILER_RECORDS = [True]


@contextlib.contextmanager
def fenced_profile():
    """A torch.profiler session (host and card) around the body, fenced."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(FENCE_PADS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(FENCE_WAIT_S)
        yield prof
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()


def whole(names):
    """Whether a fenced session kept its body: its card events' names in
    the order they started begin and end with a fence."""
    return bool(names) and FENCE in names[0] and FENCE in names[-1]


def profile(fn):
    """One fenced torch.profiler pass over one call of `fn`: [(event key,
    launches, device ms)] of the kernels, copies and fills it ran on the
    card; empty where the pass did not keep the whole call."""
    from torch.autograd import DeviceType

    if not PROFILER_RECORDS[0]:
        return []
    fn()
    with fenced_profile() as prof:
        fn()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)),
                    key=lambda e: e.time_range.start)
    if not whole([e.name for e in events]):
        return []
    rows = {}
    for e in events:
        if FENCE not in e.name:
            row = rows.setdefault(e.name, [0, 0.0])
            row[0] += 1
            row[1] += e.time_range.elapsed_us() / 1e3
    return [(key, count, ms) for key, (count, ms) in rows.items()]


def device_time(fn):
    """(device ms of every kernel, copy and fill one call of `fn` ran, their
    count, (name, ms) of the largest), or None where PROFILE_PASSES passes
    kept none."""
    for _ in range(PROFILE_PASSES):
        rows = profile(fn)
        if rows:
            key, _, top = max(rows, key=lambda r: r[2])
            return sum(ms for _, _, ms in rows), sum(count for _, count, _ in rows), (key, top)
    return None


def profile_stages(fn, stages):
    """{stage: (launches, device ms)} of one call of `fn` for each (kernel
    name, stage) of `stages`, from the first of up to PROFILE_PASSES passes
    that kept the whole call; None where none did."""
    for _ in range(PROFILE_PASSES):
        got = {stage: (count, ms) for key, count, ms in profile(fn) for kernel, stage in stages
               if f"{kernel}(" in key or f"{kernel}<" in key}
        if len(got) == len(stages):
            return got
    return None


NOT_PROFILED = f"not measured (no profiler pass of {PROFILE_PASSES} kept the whole call)"


def bound_spd_inverse(M):
    return R.bound(*R.spd_inverse_work(M.shape[0], M.shape[-1]))


def bound_symv(packed, v):
    return R.bound(*R.symv_work(v.shape[0], packed.shape[1], v.shape[1], packed.shape[-1]))


def bound_admm_fused(args, iters):
    # nnz counted on these A
    B, m, n = args[1].shape  # A
    return R.bound(*R.admm_fused_work(B, n, m, int(torch.count_nonzero(args[1])), iters))


def qp_around(A, gen):
    """The fused ADMM kernel's inputs around constraint matrices A [B, m, n]
    (tests/test_torch_admm_fused_schedule.py `_qp`, drawn on the card): minv
    of G G^T + I + A^T rho A (inverted in float64), rho in [0.1, 10], bounds
    around 0, q random, a cold start."""
    B, m, n = A.shape
    dev = A.device
    rho = 0.1 + 9.9 * torch.rand(B, m, device=dev, generator=gen)
    G = torch.randn(B, n, n, device=dev, generator=gen).double() * 0.05
    At = A.transpose(1, 2).double()
    M = G @ G.transpose(1, 2) + torch.eye(n, device=dev, dtype=torch.float64) + (At * rho[:, None, :]) @ At.transpose(1, 2)
    l = -torch.randn(B, m, device=dev, generator=gen).abs()
    u = torch.randn(B, m, device=dev, generator=gen).abs()
    q = torch.randn(B, n, device=dev, generator=gen)
    zeros_n, zeros_m = torch.zeros(B, n, device=dev), torch.zeros(B, m, device=dev)
    return torch.linalg.inv(M).float().contiguous(), A.contiguous(), q, l, u, rho, zeros_n, zeros_m, zeros_m.clone()


def sparse_constraints(gen, B=4, n=37, m=50):
    """A sparse random A: identity rows, then rows of 3 entries (columns
    3 k .. 3 k + 2 mod n); the odd items' last row has 4 entries, past the
    kernel's row cap of 3, so they take the dense branch."""
    dev = gen.device
    A = torch.zeros(B, m, n, device=dev)
    A[:, torch.arange(n), torch.arange(n)] = 1.0
    k = torch.arange(m - n, device=dev)
    cols = (3 * k[:, None] + torch.arange(3, device=dev)) % n
    A[:, (n + k)[:, None], cols] = torch.randn(B, m - n, 3, device=dev, generator=gen)
    A[1::2, m - 1, :4] = torch.randn(B // 2, 4, device=dev, generator=gen)
    return A


def scenario_gap(got, want):
    """Per scenario, max |got - want| / (max |want| + 1) over (x, zc, y)."""
    return torch.stack([(g - w).abs().amax(-1) / (w.abs().amax(-1) + 1.0) for g, w in zip(got, want)]).amax(0)


def check_admm_fused(name, args, modes, iters=ADMM_ITERS):
    """K5 against its twin in each of `modes`, launched twice; fails unless it
    is within ADMM_TOL and the two launches are bitwise equal. Returns the
    largest f32 |diff|."""
    B, n, m = args[0].shape[0], args[0].shape[1], args[1].shape[1]
    err = 0.0
    for mode in modes:
        tol_max, tol_median = ADMM_TOL[mode]
        got = K5.admm_fused(*args, iters=iters, mxu_dtype=mode)
        again = K5.admm_fused(*args, iters=iters, mxu_dtype=mode)
        torch.cuda.synchronize()
        want = K5.admm_fused_ref(*args, iters=iters, mxu_dtype=mode)
        diff = [float((g - w).abs().max()) for g, w in zip(got, want)]
        rel = scenario_gap(got, want)
        worst, median = float(rel.max()), float(rel.median())
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        print(f"phase 2 K5 admm_fused {name} B={B} {K5.plan(n, m)} iters={iters} {mode}: max|diff| x "
              f"{diff[0]:.3e} zc {diff[1]:.3e} y {diff[2]:.3e}; per scenario / (max|twin| + 1): largest {worst:.3e} "
              f"(tol {tol_max:g}), median {median:.3e} (tol {tol_median:g}); two launches bitwise equal {same}")
        require(finite and worst <= tol_max and median <= tol_median,
                f"K5 {mode} on {name} at B={B} disagrees with its twin")
        require(same, f"K5 gives two results on the same inputs ({name}, {mode})")
        if mode == "f32":
            err = max(err, max(diff))
    return err


def chaos_witness(name, args, modes=("bf16", "bf16x2")):
    """`modes` on inputs where they are not held: the kernel's gap to the twin
    beside the twin's own gap between f32 and f64 sums on the same inputs,
    the input's measure of how far one rounding carries (printed)."""
    for mode in modes:
        got = K5.admm_fused(*args, iters=ADMM_ITERS, mxu_dtype=mode)
        want = K5.admm_fused_ref(*args, iters=ADMM_ITERS, mxu_dtype=mode)
        want64 = K5.admm_fused_ref(*(a.double() for a in args), iters=ADMM_ITERS, mxu_dtype=mode)
        kernel, chaos = scenario_gap(got, want), scenario_gap(want, want64)
        print(f"phase 2 K5 admm_fused {name} {mode}, not held: per scenario / (max|twin| + 1), kernel vs twin "
              f"median {float(kernel.median()):.3e} largest {float(kernel.max()):.3e}; twin f32 vs twin f64 sums "
              f"median {float(chaos.median()):.3e} largest {float(chaos.max()):.3e}")


def tick_chain(solver, cfg, ticks, push=0.0):
    """B = 1: a cold solve, then `ticks` warm-started receding-horizon ticks
    (t0 advances by dt, x0 is the previous solve's predicted next state).
    Returns the solutions and the per-solve wall times in ms."""
    params = BENCH.make_params(cfg, lateral([push]))
    warm = solver.cold_start(1)
    sols, times = [], []
    for k in range(ticks + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        sol = solver.solve(params, warm)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        require(float(sol.prim_res.max()) < 1e-2, f"tick {k}: prim_res {float(sol.prim_res.max())}")
        require(bool(torch.isfinite(sol.z).all()), f"tick {k}: non-finite z")
        sols.append(sol)
        nxt = params_at(cfg, lateral([push]), BENCH.T0 + (k + 1) * cfg.dt, x0=sol.states[:, 1])
        warm = solver.warm_from(nxt, sol)
        params = nxt
    return sols, times


def bench_chain(solver, cfg, prim_max=1e-2):
    """apps.bench's chain on its shape (B = 512 pushes in linspace(-1, 1),
    KB = 4 warm-started solves), once. Returns (costs [KB, B], prim [KB, B],
    seconds). The costs must be finite and, unless prim_max is None,
    prim_res below it."""
    params = BENCH.make_params(cfg, BENCH.lateral_pushes(512))
    torch.cuda.synchronize()
    t = time.perf_counter()
    costs, prims = BENCH.chain(solver, params, solver.cold_start(512), 4)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    require(bool(torch.isfinite(costs).all()), "bench chain: non-finite cost")
    require(prim_max is None or float(prims.max()) < prim_max, f"bench chain: prim_res {float(prims.max())}")
    return costs, prims, seconds


def push_saturates_box(solver, cfg):
    """ext_force [0, 1.2, 0] moves the left foot's next step to the +y edge of
    its box (dy = bbox_upper[0][1] = 0.05) and stays inside every box."""
    params = BENCH.make_params(cfg, lateral([1.2]))
    sol = solver.solve(params, solver.cold_start(1))
    stage = params.stage
    adj = (stage.slot_adjustable * stage.slot_valid)[..., None]
    d = ((sol.positions - stage.slot_pos_nom) * adj)[0].cpu()
    bl = torch.tensor(cfg.bbox_lower)[:, None, :]
    bu = torch.tensor(cfg.bbox_upper)[:, None, :]
    dy = float(d[0, :, 1].max())
    require(abs(dy - cfg.bbox_upper[0][1]) < 1e-3, f"push: left-foot dy {dy}, expected the box edge")
    require(bool(((d <= bu + 1e-4) & (d >= bl - 1e-4)).all()), "push: footstep outside its box")
    return dy


# --- MANN -> MPC: the MPC stage of the walking controller ---------------------
# (cmw_tpu/runtime/loop.py:508-1053 on the kinematic plant, while moving)

MANN_SPEED = 0.05  # m/s: the synthetic weights' forward base motion
RECEDING_TICKS = 6  # phase 8's B = 1 receding fused ticks (cut from 11 for the script's time)
# card f32 vs the port's CPU f64, per generator channel after 40 steps; the
# CPU's own f32-vs-f64 gap on the same rollouts is ~1e-7 (com) and ~4e-7
# (angular momentum), so these allow two orders of magnitude for the card's
# other libm and summation orders
GEN_TOL = {"com": 1e-5, "ang_mom": 1e-4, "joints": 1e-5, "base_xy_yaw": 1e-5, "base_height": 1e-5,
           "foot_pose_xy_yaw": 1e-5}


def synthetic_mann_numpy(seed: int = 0) -> dict:
    """MANN weights at the published mann4 shapes (124 -> 32 -> 32 -> 4 gate,
    4 experts of 124 -> 128 -> 128 -> 91), as numpy from a seed: small random
    weights, and an output bias that holds the walk-ready joints and a slow
    forward base motion, so that the rollout stays physical. Not the shipped
    ONNX weights, which are not in the repository."""
    rng = np.random.default_rng(seed)

    def lin(*shape):
        return rng.standard_normal(shape) / np.sqrt(shape[-1])

    def bias(*shape):
        return 0.1 * rng.standard_normal(shape)

    E, lead = 4, 0.8 / G.N_FUTURE  # experts; lead time of each future point
    b_out = np.zeros(91)
    b_out[0:12:2] = MANN_SPEED * lead * np.arange(1, G.N_FUTURE + 1)  # future positions, x
    b_out[12:24:2] = 1.0  # future facing [1, 0]
    b_out[24:36:2] = MANN_SPEED  # future velocities, x
    b_out[36:62] = kin.reference_initial_pose()  # joints; velocities and momentum terms 0
    return dict(
        w_in=np.eye(124) + 0.05 * lin(124, 124), b_in=0.01 * rng.standard_normal(124),
        gate_w=(lin(32, 124), lin(32, 32), lin(4, 32)), gate_b=(bias(32), bias(32), bias(4)),
        expert_w=(lin(E, 128, 124), lin(E, 128, 128), lin(E, 91, 128)),
        expert_b=(bias(E, 128), bias(E, 128), bias(E, 91)),
        w_out=1e-4 * rng.standard_normal((91, 91)), b_out=b_out,
    )


def lifted(W: dict) -> dict:
    """The synthetic weights with the left leg folded (hip pitch +0.4, knee
    -0.6, ankle pitch -0.2 rad in the output bias): the left sole rises
    ~3 cm with its corners level, so its contact trigger switches off and
    the foot swings."""
    b = W["b_out"].copy()
    b[36 + 0] += 0.4
    b[36 + 3] -= 0.6
    b[36 + 4] -= 0.2
    return dict(W, b_out=b)


def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num, wire, payload):
    key = _varint((num << 3) | wire)
    if wire == 0:
        return key + _varint(payload)
    return key + _varint(len(payload)) + payload


def _tensor(name, a, packed_dims=False):
    """TensorProto: dims (1), data_type float (2), name (8), raw_data (9); or
    the values as packed float_data (4) for packed_dims."""
    a = np.asarray(a, np.float32)
    if packed_dims:
        dims = _field(1, 2, b"".join(_varint(d) for d in a.shape))
        data = _field(4, 2, a.tobytes())
    else:
        dims = b"".join(_field(1, 0, d) for d in a.shape)
        data = _field(9, 2, a.tobytes())
    return dims + _field(2, 0, 1) + _field(8, 2, name.encode()) + data


def mann_onnx_bytes(W: dict) -> bytes:
    """The MANN weights W (numpy, as `synthetic_mann_numpy` gives them) as an
    ONNX file in the protobuf wire format: a ModelProto holding a graph (7)
    with the initializers (5) under the names the ONNX export gives them
    (the second layers' dims and data packed, the other way of writing
    them), and an input and output (11, 12)."""
    inits = {"0.weight": W["w_in"], "0.bias": W["b_in"], "2.weight": W["w_out"], "2.bias": W["b_out"]}
    for k in range(3):
        inits[f"1.gn.w{k}"] = W["gate_w"][k]
        inits[f"1.gn.b{k}"] = W["gate_b"][k][:, None]
        inits[f"1.mpn.w{k}"] = W["expert_w"][k]
        inits[f"1.mpn.b{k}"] = W["expert_b"][k][..., None]
    graph = b"".join(_field(5, 2, _tensor(n, a, packed_dims=n.endswith("w1"))) for n, a in inits.items())
    graph += _field(11, 2, _field(1, 2, b"input")) + _field(12, 2, _field(1, 2, b"output"))
    return _field(1, 0, 7) + _field(7, 2, graph)  # ir_version, graph


def joysticks(B, device="cuda"):
    """[B, 4] joystick commands (motion, facing): item 0 walks forward, the
    rest are random sticks in all four quadrants, each motion stick pushed at
    least 0.2 (past the stand-mode threshold of 0.05, so the controller is
    moving)."""
    joy = np.random.default_rng(3).uniform(-1.0, 1.0, size=(B, 4))
    norm = np.linalg.norm(joy[:, :2], axis=-1, keepdims=True)
    joy[:, :2] *= np.maximum(norm, 0.2) / np.maximum(norm, 1e-9)
    joy[0] = [0.8, 0.0, 1.0, 0.0]
    return torch.as_tensor(joy, dtype=torch.float32, device=device)


def coast(ctl, s):
    """s one MPC period on, as the kinematic loop's WBC ticks carry the MPC's
    plant (runtime/loop.py `_wbc_stage`) without a push: gait time one MPC
    interval on, tick mpc_every on, x9 integrated under the held
    first-interval forces by mpc_every RK4 steps of wbc_dt. The joints and
    the base stay where they are (phase 9 runs the WBC stage itself)."""
    cfg = ctl.cfg
    zero = torch.zeros_like(s.x9[:, 0:3])
    x9 = s.x9
    for _ in range(cfg.mpc_every):
        x9 = rk4_step(lambda x: centroidal_dynamics(x, s.forces0, s.corner0, s.active0, zero, zero), x9, cfg.wbc_dt)
    return s._replace(t=s.t + cfg.mpc.dt, tick=s.tick + cfg.mpc_every, x9=x9)


KERNELS = {"spd_inverse": K3, "symv_packed": K4, "admm_fused": K5}


def zero_launches():
    for mod in KERNELS.values():
        mod.launches = 0


def read_launches():
    return {name: mod.launches for name, mod in KERNELS.items()}


def main_path(name, solver, cfg):
    """One main path with the launch counts zeroed just before it and read
    just after: 11 B = 1 solves, the push check, 4 B = 512 solves. Returns the
    B = 1 solutions, the bench chain's costs and the launches."""
    zero_launches()
    ticks, _ = tick_chain(solver, cfg, ticks=10)
    dy = push_saturates_box(solver, cfg)
    costs, prims, _ = bench_chain(solver, cfg)
    launches = read_launches()
    print(f"{name} main path: 11 B=1 solves (last cost {float(ticks[-1].cost):.4f}, "
          f"max prim {max(float(s.prim_res) for s in ticks):.2e}), push dy {dy:.5f}, "
          f"B=512 x KB=4 (max prim {float(prims.max()):.2e}); launches {launches}")
    return ticks, costs, launches


def phase_mann_mpc(tag):
    """Phase 8: joystick -> MANN -> MPC on the card. Returns the launches of
    its main path (the B = 256 ticks and the B = 1 tick chain) and the
    synthetic weights on the card."""
    dev = "cuda"
    model = kin.ergocub_urdf()
    gen_cfg = G.GeneratorConfig()
    W = synthetic_mann_numpy()
    print("phase 8 MANN weights: SYNTHETIC, from numpy seed 0, at the published mann4 shapes (124 -> 32 -> 32 -> 4 "
          "gate, 4 experts 124 -> 128 -> 128 -> 91); the shipped ONNX weights are not in the repository")
    net = N.MANN(convert.mann_weights_from_numpy(W, device="cpu")).to(dev)
    weights = net.weights
    x = torch.randn(8, 124, device=dev, generator=torch.Generator(device=dev).manual_seed(8))
    require(torch.equal(net(x), N.mann_forward(weights, x)), "the MANN module and mann_forward disagree")
    q_ready = torch.as_tensor(kin.walk_ready_pose()[0], dtype=torch.float32)

    # --- the generator: card f32 against the port's CPU f64 ----------------
    # the walking weights keep both feet down; the lifted ones switch the left
    # foot's trigger off, so the flags are held where they change
    wall = {}
    for wname, B, Wc in (("walk", 1, W), ("walk", 256, W), ("lift", 256, lifted(W))):
        w32 = weights if wname == "walk" else convert.mann_weights_from_numpy(Wc, device=dev)
        w64 = convert.mann_weights_from_numpy(Wc, device="cpu", dtype=torch.float64)
        joy = joysticks(B)
        state = G.initial_state(gen_cfg, model, q_ready.to(dev).expand(B, -1).contiguous())
        desired = IB.build_desired_trajectory(joy[:, 0:2], joy[:, 2:4])
        _, out, _ = G.generate_with_states(gen_cfg, model, w32, state, desired)
        joy64 = joy.cpu().double()
        state64 = G.initial_state(gen_cfg, model, q_ready.double().expand(B, -1).contiguous())
        desired64 = IB.build_desired_trajectory(joy64[:, 0:2], joy64[:, 2:4])
        _, out64, _ = G.generate_with_states(gen_cfg, model, w64, state64, desired64)
        same_flags = torch.equal(out.contact.cpu().double(), out64.contact)
        gaps = {f: float((getattr(out, f).cpu().double() - getattr(out64, f)).abs().max()) for f in GEN_TOL}
        swings = int((out64.contact < 0.5).sum())
        case = f"generator {wname} B={B}"
        print(f"phase 8 {case} x {gen_cfg.n_steps} steps, card f32 vs CPU f64: contact flags identical "
              f"{same_flags} ({swings} foot-steps in swing); max|diff| "
              + ", ".join(f"{f} {g:.2e} (tol {GEN_TOL[f]:g})" for f, g in gaps.items())
              + f"; final CoM item 0 {out64.com[0, -1].tolist()}")
        require(same_flags, f"{case}: contact flags differ between the card and the CPU")
        require(all(g <= GEN_TOL[f] for f, g in gaps.items()), f"{case}: card vs CPU f64 {gaps}")
        require(all(bool(torch.isfinite(a).all()) for a in out), f"{case}: non-finite output")
        require(wname == "walk" or swings > 0, f"{case}: the lifted foot never swings")
        if wname == "lift":
            continue

        def call():
            return G.generate_with_states(gen_cfg, model, weights, state, desired)

        call()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        wall[B] = (time.perf_counter() - t) / 3 * 1e3
        print(f"phase 8 time generator B={B}: {wall[B]:.1f} ms per generate_with_states call "
              f"({gen_cfg.n_steps} steps, wall, mean of 3) {tag}")
        if B == 1:
            d = device_time(call)
            if d is None:
                print(f"phase 8 profile generator B=1: {NOT_PROFILED} {tag}")
            else:
                dev_ms, count, (key, top) = d
                print(f"phase 8 profile generator B=1: device {dev_ms:.3f} ms in {count} kernels, copies and fills; "
                      f"wall {wall[1]:.1f} ms (unprofiled, above), idle share {1 - dev_ms / wall[1]:.3f}; largest "
                      f"{key[:60]} {top:.3f} ms {tag}")

    # --- the controller's MPC stage: fused (K3 + K5) and Riccati, B = 256, then a
    # B = 1 chain, from the walk-ready pose (an explicit start: no IK polish of q0)
    cfg_fused = ergocub_mpc_config(kkt_impl="dense", admm_impl="fused")
    fused = RL.WalkingController(ergocub_gazebo_v1(mpc=cfg_fused), model, weights)
    ric = RL.WalkingController(ergocub_gazebo_v1(mpc=ergocub_mpc_config()), model, weights)
    cpu = RL.WalkingController(ergocub_gazebo_v1(mpc=ergocub_mpc_config()), model,
                               convert.mann_weights_from_numpy(W, device="cpu", dtype=torch.float64), device="cpu")
    q0, rot0 = kin.walk_ready_pose()
    zero_launches()
    s0 = fused.initial_state(256, q0=q0, base_rot0=rot0)  # both MPCs' state: the same sizes
    zeros = torch.zeros(256, 3, device=dev)
    inp = RL.TickInput(joysticks(256), zeros, zeros)
    nxt = {name: ctl._mpc_stage(s0, inp) for name, ctl in (("fused", fused), ("riccati", ric))}
    for name, s in nxt.items():
        require(bool(torch.isfinite(s.warm.z).all()), f"MANN -> MPC {name} B=256: non-finite z")
    n_fused = 1
    s_f, s_r = nxt["fused"], nxt["riccati"]

    def swinging(s, foot):  # items whose foot lifts within the horizon
        stage = contacts.mpc_stage_params(s.plan, s0.t, cfg_fused.T, cfg_fused.dt, cfg_fused.n_slots)
        return int((stage.active[:, foot] < 0.5).any(-1).sum())

    print(f"phase 8 MANN -> MPC B=256 (WalkingController._mpc_stage): the two paths' references differ by "
          f"max|com_mann| {float((s_f.com_mann - s_r.com_mann).abs().max()):.2e}, first-interval contacts "
          f"{int((s_f.active0 != s_r.active0).sum())}; left foot swinging in {swinging(s_f, 0)} items, right in "
          f"{swinging(s_f, 1)}")
    items = torch.arange(4)
    s_cpu = cpu._mpc_stage(to_cpu64(items_of(s0, items.to(dev))),
                           RL.TickInput(*(a[items].cpu().double() for a in inp)))
    for name, a, b in (("fused gpu vs riccati gpu", s_f, s_r), ("fused gpu vs riccati cpu f64", s_f, s_cpu),
                       ("riccati gpu vs riccati cpu f64", s_r, s_cpu)):
        cb = b.mpc_cost.cpu().double()
        ca = a.mpc_cost.cpu().double()[: cb.shape[0]]
        dc = (ca - cb).abs()
        prim = float(a.mpc_prim.max())
        good = bool((dc <= 0.005 * (cb.abs() + 1.0)).all()) and prim < 1e-2
        print(f"phase 8 sentinel MANN -> MPC {name} (B={ca.shape[0]}): max|dcost| {float(dc.max()):.3e} "
              f"(max |cost| {float(cb.abs().max()):.3f}), prim {prim:.2e}: {'ok' if good else 'FAIL'}")
        require(good, f"MANN -> MPC sentinel failed: {name}")

    s = fused.initial_state(1, q0=q0, base_rot0=rot0)
    inp1 = RL.TickInput(joysticks(1), zeros[:1], zeros[:1])
    t_tick = []
    for k in range(RECEDING_TICKS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        s = fused._mpc_stage(s, inp1)
        torch.cuda.synchronize()
        t_tick.append((time.perf_counter() - t) * 1e3)
        n_fused += 1
        require(float(s.mpc_prim.max()) < 1e-2, f"MANN -> MPC tick {k}: prim_res {float(s.mpc_prim.max())}")
        require(bool(torch.isfinite(s.warm.z).all()), f"MANN -> MPC tick {k}: non-finite z")
        cost = float(s.mpc_cost[0])
        s = coast(fused, s)
    launches = read_launches()
    com = s.x9[0, :3].tolist()
    print(f"phase 8 MANN -> MPC main path: 2 B=256 MPC stages (fused, riccati) and {RECEDING_TICKS} B=1 fused "
          f"stages, each calling the generator and re-rooting it {fused.cfg.mann_advance} knots in (t = "
          f"{float(s.t[0]):.2f} s, CoM {[round(c, 4) for c in com]}, last cost {cost:.4f}); launches {launches}")
    require(launches["spd_inverse"] > 0 and launches["admm_fused"] == cfg_fused.sqp_iters * n_fused,
            f"MANN -> MPC launches {launches}, expected admm_fused {cfg_fused.sqp_iters} x {n_fused} fused solves")
    lat = np.array(t_tick[1:])
    print(f"phase 8 time MANN -> MPC fused B=1 MPC stage (generator + solve, warm): p50 {np.percentile(lat, 50):.1f} "
          f"ms, p90 {np.percentile(lat, 90):.1f} ms, max {lat.max():.1f} ms ({len(lat)} stages) {tag}")
    return launches, weights


# --- the closed loop: joystick -> MANN -> MPC -> IK, tick after tick -----------
# (cmw_tpu/runtime/loop.py WalkingController.step on the kinematic plant)

CLOSED_TICKS = 90  # 0.18 s of gait: 3 MPC ticks, each a generator call (cut from 150 for the script's time)
CLOSED_PERIOD = 30  # ticks of one MPC period (mpc_every at the 60 ms MPC, 2 ms WBC)
# card f32 against the port's CPU f64 over the first MPC period, per channel,
# of max(1, max |CPU value|): the CPU's own f32-vs-f64 gap there is at most
# 1.5e-5 (forces0, dq_cmd), 7.6e-5 (mpc_cost) and 2.6e-6 elsewhere (B = 1,
# and 4 lifted items); these allow ~10-100x that for the card's kernels and
# summation orders
CLOSED_TOL = {"forces0": 1e-3, "dq_cmd": 1e-3, "mpc_cost": 1e-3}
CLOSED_TOL_DEFAULT = 1e-4
FLAG_CHANNELS = ("foot_contact", "fixed_foot_idx")  # identical on every tick
COM_TRACK_TOL = 0.09  # max |com_meas - com_mpc|_xy, the closed-loop bound of tests/test_runtime.py:40
PRIM_TOL = 1e-2
SPANS = ("mann", "mpc.solve", "mpc.other", "wbc.plant", "wbc.estimation", "wbc.ik", "wbc.other")  # runtime/loop.py


def tick_inputs(joy, S):
    """TickInput [B, S, ...]: the joystick joy [B, 4] on every tick, no push."""
    zeros = torch.zeros(joy.shape[0], S, 3, dtype=joy.dtype, device=joy.device)
    return RL.TickInput(joy[:, None].expand(-1, S, 4), zeros, zeros.clone())


def closed_invariants(name, tel):
    """Finite channels, mpc_prim < PRIM_TOL, CoM tracking within COM_TRACK_TOL
    over the episode. Returns (max prim, max |com_meas - com_mpc|_xy)."""
    bad = [n for n, v in tel._asdict().items() if not bool(torch.isfinite(v).all())]
    prim = float(tel.mpc_prim.max())
    err = float((tel.com_meas - tel.com_mpc)[..., 0:2].abs().max())
    require(not bad, f"{name}: non-finite channels {bad}")
    require(prim < PRIM_TOL and err < COM_TRACK_TOL, f"{name}: mpc_prim {prim}, |com_meas - com_mpc|_xy {err}")
    return prim, err


def closed_vs_cpu(name, tel, tel64, items=None):
    """The card's telemetry (items of it) against the CPU f64 run: FLAG_CHANNELS
    identical on every tick the CPU ran, every channel over the first MPC
    period within CLOSED_TOL. Returns the largest gap and its channel."""
    got = {n: (v if items is None else v[items]).cpu().double() for n, v in tel._asdict().items()}
    ticks = tel64.q.shape[1]
    for n in FLAG_CHANNELS:
        require(torch.equal(got[n][:, :ticks], getattr(tel64, n)), f"{name}: {n} differs between the card and the CPU")
    worst = (0.0, "")
    for n, want in tel64._asdict().items():
        want = want[:, :CLOSED_PERIOD]
        gap = float((got[n][:, :CLOSED_PERIOD] - want).abs().max()) / max(1.0, float(want.abs().max()))
        require(gap <= CLOSED_TOL.get(n, CLOSED_TOL_DEFAULT), f"{name}: {n} card vs CPU f64 {gap}")
        worst = max(worst, (gap, n))
    return worst


def count_syncs(fn):
    """(fn's result, {"file:line": count} of the operations in it that waited
    for the card), by torch.cuda's sync debug mode."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = {}
    for w in caught:  # (the mode's own first call warns that it is a prototype: not a sync)
        if "called a synchronizing CUDA operation" in str(w.message):
            key = f"{w.filename.split('/')[-1]}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    return out, where


def wbc_walls(ctl, s, inp, n, n_checked=3):
    """n_checked WBC ticks from s under torch.cuda's sync debug mode, then n
    more with the mode off, each timed alone (synchronised before and after).
    Returns (state, ms of the n timed ticks, {"file:line": count} of the
    operations inside the checked ticks that waited for the card)."""
    syncs = {}
    for _ in range(n_checked):
        (s, _), where = count_syncs(lambda: ctl._wbc_stage(s, inp))
        for key, count in where.items():
            syncs[key] = syncs.get(key, 0) + count
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        s, _ = ctl._wbc_stage(s, inp)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return s, np.array(times), syncs


def mpc_period(ctl, s, inputs, tick0):
    """One MPC period from s at tick0 (an MPC tick): 1 MPC + mpc_every WBC ticks."""
    for k in range(ctl.cfg.mpc_every):
        s, _ = ctl.step(s, RL.TickInput(*(a[:, k] for a in inputs)), tick0 + k)
    return s


def span_profile(fn):
    """One torch.profiler pass over one call of `fn` (controller stages):
    {span: [device ms, kernels, host ms]}: the device time and count of the
    kernels, copies and fills launched while each span of runtime/loop.py was
    open (by the launch's time on the host, so that the work of the autograd
    engine's own thread, the rigid plant's backward passes, counts in the
    span that waits for it), the span's host time under the profiler, and
    (device ms, kernels) of the whole pass; or None where the fenced pass did
    not keep the whole call (one pass only: a kinematic MPC period takes
    ~15 s under the profiler)."""
    import bisect

    from torch.autograd import DeviceType

    if not PROFILER_RECORDS[0]:
        return None
    with fenced_profile() as prof:
        fn()
    spans = {name: [0.0, 0, 0.0] for name in SPANS + ("outside the spans",)}
    # the launch times of the kernels' host calls are in the profiler's raw
    # events (kineto_results, not a public API); the averaged events only link
    # a kernel to its op, not to a span open on another thread
    results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    require(results is not None and hasattr(results, "events"),
            f"span_profile: torch {torch.__version__}'s profiler has no kineto_results.events(), which this "
            f"attribution by launch time reads")
    events = results.events()
    on_card = sorted((e.start_ns(), e.name()) for e in events
                     if e.device_type() == DeviceType.CUDA and not e.is_user_annotation())
    if not whole([name for _, name in on_card]):
        return None
    opened = sorted((e.start_ns(), e.end_ns(), e.name()) for e in events
                    if e.device_type() == DeviceType.CPU and e.name() in SPANS)
    starts = [o[0] for o in opened]
    for t0, t1, name in opened:
        spans[name][2] += (t1 - t0) / 1e6
    launched = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() == DeviceType.CPU and e.correlation_id() > 0}
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation() or FENCE in e.name():
            continue
        t = launched.get(e.linked_correlation_id(), e.start_ns())  # (unlinked: its own start)
        i = bisect.bisect_right(starts, t) - 1
        slot = spans[opened[i][2] if i >= 0 and t <= opened[i][1] else "outside the spans"]
        slot[0] += e.duration_ns() / 1e6
        slot[1] += 1
    return spans, (sum(v[0] for v in spans.values()), sum(v[1] for v in spans.values()))


def phase_closed_loop(tag, weights, dev="cuda"):
    """Phase 9: the walking controller, joystick -> MANN -> MPC -> swing foot
    / ZMP / CoM-ZMP / IK -> integration, tick after tick on the card.
    Returns the launches of its main path (the fused B = 1 and B = 256
    episodes and the dense B = 1 episode)."""
    t_phase = time.perf_counter()
    model = kin.ergocub_urdf()
    W = synthetic_mann_numpy()
    cfg = ergocub_gazebo_v1(mpc=ergocub_mpc_config(kkt_impl="dense", admm_impl="fused"))
    cfg_dense = ergocub_gazebo_v1(mpc=ergocub_mpc_config(kkt_impl="dense"))
    ctl = RL.WalkingController(cfg, model, weights, device=dev)
    ctl64 = RL.WalkingController(cfg, model, convert.mann_weights_from_numpy(W, device="cpu", dtype=torch.float64),
                                 device="cpu")
    every = cfg.mpc_every
    sqp = cfg.mpc.sqp_iters
    launches = {name: 0 for name in KERNELS}

    def add(got):
        for name, n in got.items():
            launches[name] += n

    # --- B = 1, fused MPC (K3 + K5), CLOSED_TICKS, against the CPU in f64 ------
    joy1 = joysticks(1, device=dev)
    inputs = tick_inputs(joy1, CLOSED_TICKS)
    s0 = ctl.initial_state(1)
    zero_launches()
    t = time.perf_counter()
    s_end, tel = ctl.run_episode(s0, inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got = read_launches()
    add(got)
    n_mpc = -(-CLOSED_TICKS // every)
    require(got["spd_inverse"] >= n_mpc and got["admm_fused"] == sqp * n_mpc,
            f"closed loop B=1 launches {got}, expected admm_fused {sqp} x {n_mpc} MPC ticks")
    prim, err = closed_invariants("closed loop B=1 fused", tel)
    _, tel64 = ctl64.run_episode(ctl64.initial_state(1, dtype=torch.float64), tick_inputs(joy1.cpu().double(),
                                                                                           CLOSED_TICKS))
    gap, chan = closed_vs_cpu("closed loop B=1 fused", tel, tel64)
    print(f"phase 9 closed loop B=1 fused (K3 + K5), {CLOSED_TICKS} ticks ({n_mpc} MPC ticks, each a generator call) "
          f"in {wall:.2f} s: launches {got}; contact flags and fixed feet identical to the CPU f64 run on every "
          f"tick; first MPC period, largest gap / max(1, |value|) {gap:.2e} ({chan}); mpc_prim max {prim:.2e} (< "
          f"{PRIM_TOL:g}), |com_meas - com_mpc|_xy max {err:.2e} (< {COM_TRACK_TOL}); final t {float(s_end.t):.4f} s, "
          f"CoM {[round(c, 4) for c in s_end.x9[0, :3].tolist()]} {tag}")

    # --- B = 1, dense MPC (K3 + K4), 30 ticks ---------------------------------
    ctl_dense = RL.WalkingController(cfg_dense, model, weights, device=dev)
    zero_launches()
    _, tel_d = ctl_dense.run_episode(ctl_dense.initial_state(1), tick_inputs(joy1, CLOSED_PERIOD))
    got = read_launches()
    add(got)
    require(got["spd_inverse"] >= 1 and got["symv_packed"] > 0 and got["admm_fused"] == 0,
            f"closed loop dense launches {got}")
    prim_d, err_d = closed_invariants("closed loop B=1 dense", tel_d)
    n = min(tel_d.q.shape[1], tel.q.shape[1])
    dc = float((tel_d.com_mpc[:, :n] - tel.com_mpc[:, :n]).abs().max())
    print(f"phase 9 closed loop B=1 dense (K3 + K4), {CLOSED_PERIOD} ticks: launches {got}; mpc_prim max "
          f"{prim_d:.2e}, |com_meas - com_mpc|_xy max {err_d:.2e}; com_mpc within {dc:.2e} of the fused run {tag}")

    # --- B = 256, the lifted weights, random joysticks, 60 ticks --------------
    Wl = lifted(W)
    ctl_l = RL.WalkingController(cfg, model, convert.mann_weights_from_numpy(Wl, device=dev), device=dev)
    ctl_l64 = RL.WalkingController(cfg, model, convert.mann_weights_from_numpy(Wl, device="cpu", dtype=torch.float64),
                                   device="cpu")
    joy = joysticks(256, device=dev)
    S = 2 * CLOSED_PERIOD
    zero_launches()
    s_l = ctl_l.initial_state(256)
    s60, tel_l = ctl_l.run_episode(s_l, tick_inputs(joy, S))
    got = read_launches()
    add(got)
    require(got["admm_fused"] == sqp * 2, f"closed loop B=256 launches {got}")
    prim_l, err_l = closed_invariants("closed loop B=256 lifted", tel_l)
    swinging = int((tel_l.foot_contact < 0.5).any(-1).any(-1).sum())
    require(swinging > 0, "closed loop B=256 lifted: no foot ever leaves the ground")
    items = torch.arange(4)
    _, tel_l64 = ctl_l64.run_episode(ctl_l64.initial_state(4, dtype=torch.float64),
                                     tick_inputs(joy[items].cpu().double(), S))
    gap_l, chan_l = closed_vs_cpu("closed loop B=256 lifted", tel_l, tel_l64, items=items.to(dev))
    print(f"phase 9 closed loop B=256 lifted, {S} ticks: launches {got}; {swinging} of 256 items with a foot in "
          f"swing; mpc_prim max {prim_l:.2e}, |com_meas - com_mpc|_xy max {err_l:.2e}; items 0-3 against the CPU f64: "
          f"flags identical on all {S} ticks, first MPC period largest gap {gap_l:.2e} ({chan_l}) {tag}")

    # --- times: WBC ticks alone, the MPC stage, an MPC period by span ---------
    inp1 = RL.TickInput(*(a[:, 0] for a in inputs))
    inp256 = RL.TickInput(*(a[:, 0] for a in tick_inputs(joy, 1)))
    _, w1, sync1 = wbc_walls(ctl, s_end, inp1, 29)
    _, w256, sync256 = wbc_walls(ctl_l, s60, inp256, 29)
    for B, w, n_sync in ((1, w1, sync1), (256, w256, sync256)):
        print(f"phase 9 time WBC tick B={B}: p50 {np.percentile(w, 50):.2f} ms, p90 {np.percentile(w, 90):.2f} ms, "
              f"max {w.max():.2f} ms ({len(w)} ticks, wall, synchronised, sync debug mode off); operations that "
              f"waited for the card in 3 ticks under the mode: {sum(n_sync.values())} {n_sync or ''} {tag}")
        require(not n_sync, f"WBC tick B={B}: operations waited for the card: {n_sync}")
    for B, c, s_at, inp in ((1, ctl, s_end, inp1), (256, ctl_l, s60, inp256)):
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            c._mpc_stage(s_at, inp)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        print(f"phase 9 time MPC stage B={B} (generator call + fused solve + glue): "
              f"{', '.join(f'{x:.1f}' for x in walls)} ms (wall, 3 calls) {tag}")
    period_in = tick_inputs(joy, every)
    mpc_period(ctl_l, s60, period_in, S)  # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    mpc_period(ctl_l, s60, period_in, S)
    torch.cuda.synchronize()
    period_wall = (time.perf_counter() - t) * 1e3
    prof = span_profile(lambda: mpc_period(ctl_l, s60, period_in, S))
    if prof is None:
        print(f"phase 9 profile MPC period B=256: wall {period_wall:.1f} ms (unprofiled); device {NOT_PROFILED} {tag}")
    else:
        spans, (dev_ms, kernels) = prof
        print(f"phase 9 profile MPC period B=256 ({every} ticks: 1 MPC stage + {every} WBC stages): wall "
              f"{period_wall:.1f} ms (unprofiled), device {dev_ms:.3f} ms in {kernels} kernels, idle share "
              f"{1 - dev_ms / period_wall:.3f} {tag}")
        for name, (ms, count, host) in spans.items():
            print(f"phase 9 profile MPC period B=256 span {name}: device {ms:.3f} ms ({100 * ms / dev_ms:.1f} %), "
                  f"{count} kernels, host {host:.1f} ms under the profiler {tag}")
    print(f"phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# --- the closed loop on the rigid-body plant ----------------------------------
# (cmw_tpu/runtime/loop.py WalkingController with cfg.rigid, sim/rigid_body.py)

RIGID_TICKS = 60  # 2 MPC ticks standing at B = 1 (cut from 90 for the script's time)
RIGID_WALL_TICKS = 15  # timed rigid WBC ticks at B = 1 and 256 (cut from 29 for the script's time)
RIGID_SWEEP_B = 256
RIGID_SWEEP_TICKS = 60  # 2 MPC ticks at B = 256; the lifted left foot swings from tick 30
RIGID_CHECKED = 4  # items of the B = 256 sweep held against the CPU
# the sweep's push on the base, mass-normalised (m/s^2), over the first MPC
# period, on the odd items: ~0.7 m/s of impulse at full strength, the impulse
# of the push sweep's largest push (2 m/s^2 for 0.4 s). Checked items 1 and 3
# get it at full strength toward RIGID_PUSH_DIRS (degrees from +x), the other
# odd items in a random direction at a random strength up to it; the even
# items, 0 and 2 among them, are not pushed. The fused MPC's 24 ADMM
# iterations leave mpc_prim above PRIM_TOL while it measures a push this
# strong (up to ~0.2 at the pushed tick 0, on the CPU), so the pushed items
# are held upright and finite, the unpushed ones to PRIM_TOL as well.
RIGID_PUSH = 12.0
RIGID_PUSH_DIRS = (0.0, 270.0)
# card f32 against CPU f64 over the first MPC period, per channel, of
# max(1, max |CPU value|): 20 times the port's own CPU f32-vs-f64 gap
# (`rigid_cpu_gap`), rounded up, and never below phase 9's 1e-4. On the B = 1
# stand episode: ft_act 2.4e-3 (the stiff friction anchors turning ulps of
# position into newtons), fz_act 6.6e-5, dq_cmd 8.6e-6, forces0 7.0e-6, every
# other channel at most 4.0e-6. On the pushed sweep's checked items (B = 256)
# every channel is below that but vcom_zmp, 6.0e-6.
RIGID_TOL = {"ft_act": 5e-2, "fz_act": 2e-3, "dq_cmd": 2e-4, "forces0": 2e-4}
RIGID_TOL_DEFAULT = 1e-4
RIGID_PUSH_TOL = dict(RIGID_TOL, vcom_zmp=2e-4)
# the settled plant (initial_state), card f32 against the CPU's f64 settle,
# per field of the rigid-body state and the CoM state x9, of max(1, max |CPU
# value|): 20 times the port's own CPU f32-vs-f64 gap of the same settle
# (`rigid_cpu_gap`: corner_forces 5.9e-4, nu 1.6e-5, servo_int 1.4e-5, every
# other field at most 1.1e-6), rounded up, and never below 1e-4
SETTLE_TOL = {"corner_forces": 2e-2, "nu": 4e-4, "servo_int": 3e-4}
SETTLE_TOL_DEFAULT = 1e-4
RIGID_UP = 0.8  # base_act_up: cos of the base tilt (tests/test_rigid_loop.py:106)
RIGID_Z = 0.55  # m, the lowest base height (tests/test_rigid_loop.py:108)


def to_cpu64(s):
    """A LoopState on the CPU in float64, through the numpy converters."""
    return convert.loop_state_from_numpy(convert.loop_state_to_numpy(s), device="cpu", dtype=torch.float64)


def with_plant_params(s, **values):
    """s with the rigid plant's parameters set per item (values [B] each)."""
    return s._replace(rb=s.rb._replace(params=s.rb.params._replace(**values)))


def sweep_pushes(B, gen):
    """[B, 3] mass-normalised pushes: none on the even items, RIGID_PUSH
    toward RIGID_PUSH_DIRS on items 1 and 3, a random direction and strength
    up to it on the other odd items."""
    ang = torch.rand(B, generator=gen, dtype=torch.float64) * 2.0 * np.pi
    mag = torch.rand(B, generator=gen, dtype=torch.float64) * RIGID_PUSH
    ang[[1, 3]] = torch.deg2rad(torch.tensor(RIGID_PUSH_DIRS, dtype=torch.float64))
    mag[[1, 3]] = RIGID_PUSH
    mag[0::2] = 0.0
    return torch.stack([mag * torch.cos(ang), mag * torch.sin(ang), torch.zeros_like(ang)], dim=-1)


def pushed_inputs(joy, push, S):
    """TickInput [B, S, ...]: the joystick joy [B, 4] on every tick, the push
    [B, 3] over the first MPC period (CLOSED_PERIOD ticks)."""
    inputs = tick_inputs(joy, S)
    ext = inputs.ext_force.clone()
    ext[:, :CLOSED_PERIOD] = push[:, None].to(ext)
    return inputs._replace(ext_force=ext)


def rigid_run(ctl, s, inputs):
    """inputs [B, S, ...] tick by tick from tick 0. Returns (state, Telemetry
    [B, S, ...], active corners [B, S, nc, ncor] (bool, after each tick))."""
    tels, active = [], []
    for k in range(inputs.joypad.shape[1]):
        s, tel = ctl.step(s, RL.TickInput(*(a[:, k] for a in inputs)), k)
        tels.append(tel)
        active.append(s.rb.corner_forces[..., 2] > 0)
    return s, RL.Telemetry(*(torch.stack(parts, dim=1) for parts in zip(*tels))), torch.stack(active, dim=1)


def rigid_invariants(name, tel, solved=True):
    """Every channel finite, and on every tick base_act_up > RIGID_UP, base z
    > RIGID_Z and, if `solved`, mpc_prim < PRIM_TOL. Returns (min up, min z,
    max prim)."""
    bad = [n for n, v in tel._asdict().items() if not bool(torch.isfinite(v).all())]
    require(not bad, f"{name}: non-finite channels {bad}")
    up, z, prim = float(tel.base_act_up.min()), float(tel.base_act_pos[..., 2].min()), float(tel.mpc_prim.max())
    require(up > RIGID_UP and z > RIGID_Z and (prim < PRIM_TOL or not solved),
            f"{name}: base_act_up min {up}, base z min {z}, mpc_prim max {prim}")
    return up, z, prim


def rigid_vs_cpu(name, tel, active, tel64, active64, tol, items=None):
    """The card's run (items of it) against the CPU f64 run: contact flags,
    fixed feet and active corners identical on every tick the CPU ran, every
    channel within tol (else RIGID_TOL_DEFAULT) over the first MPC period.
    Returns the largest gap and its channel."""
    pick = (lambda v: v) if items is None else (lambda v: v[items])
    ticks = tel64.q.shape[1]
    for n in FLAG_CHANNELS:
        require(torch.equal(pick(getattr(tel, n))[:, :ticks].cpu().double(), getattr(tel64, n)),
                f"{name}: {n} differs between the card and the CPU")
    require(torch.equal(pick(active)[:, :ticks].cpu(), active64), f"{name}: active corners differ")
    worst = (0.0, "")
    for n, want in tel64._asdict().items():
        want = want[:, :CLOSED_PERIOD]
        got = pick(getattr(tel, n))[:, :CLOSED_PERIOD].cpu().double()
        gap = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
        require(gap <= tol.get(n, RIGID_TOL_DEFAULT), f"{name}: {n} card vs CPU f64 {gap}")
        worst = max(worst, (gap, n))
    return worst


def settle_gaps(s, s64):
    """{field: |s - s64| / max(1, |s64|)} over the rigid-body state's fields
    (its parameters aside) and x9, s on any device, s64 the CPU f64 one."""
    pairs = [(n, getattr(s.rb, n), getattr(s64.rb, n)) for n in RB.RigidBodyState._fields if n != "params"]
    return {n: float((a.cpu().double() - b).abs().max()) / max(1.0, float(b.abs().max()))
            for n, a, b in pairs + [("x9", s.x9, s64.x9)]}


@contextlib.contextmanager
def beside(fn: str, *args: str):
    """Runs chip_smoke.<fn>(*args) in a process of its own, with no card,
    while the block runs: a CPU reference that reads nothing the card
    computes. The block's end waits for it (at most 600 s) and requires exit
    0, and writes the seconds it waited into the yielded dict ("waited");
    the process is killed if the block fails."""
    proc = subprocess.Popen([sys.executable, "-c", f"import sys, chip_smoke; chip_smoke.{fn}(*sys.argv[1:])", *args],
                            cwd=os.path.dirname(os.path.abspath(__file__)), env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    out = {}
    try:
        yield out
        t = time.perf_counter()
        require(proc.wait(timeout=600) == 0, f"the CPU reference {fn} exited {proc.returncode}")
        out["waited"] = time.perf_counter() - t
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def rigid_setup():
    """Phase 10's configuration, model and the synthetic weights, plain and
    lifted."""
    W = synthetic_mann_numpy()
    cfg = ergocub_gazebo_v1(rigid=RB.RigidBodyConfig(), mpc=ergocub_mpc_config(kkt_impl="dense", admm_impl="fused"))
    return cfg, kin.ergocub_urdf(), W, lifted(W)


def rigid_settle_reference(path):
    """Writes phase 10's CPU f64 settle (initial_state(1) on rigid_setup()'s
    plain weights) to the checkpoint file path, its wall in the meta."""
    torch.set_num_threads(2)
    cfg, model, W, _ = rigid_setup()
    ctl64 = RL.WalkingController(cfg, model, convert.mann_weights_from_numpy(W, device="cpu", dtype=torch.float64),
                                 device="cpu")
    t = time.perf_counter()
    s = ctl64.initial_state(1, dtype=torch.float64)
    checkpoint.save(path, s, {"wall": time.perf_counter() - t})


def rigid_cpu_gap():
    """The port's own f32-vs-f64 gaps on the CPU behind SETTLE_TOL, RIGID_TOL
    and RIGID_PUSH_TOL: the settle of initial_state, phase 10's B = 1 stand
    episode (RIGID_TICKS) and its pushed sweep's checked items (lifted
    weights, RIGID_SWEEP_TICKS) with their plant parameters. Prints, per
    field or telemetry channel, the largest difference / max(1, |f64 value|)
    (episodes: over the first MPC period and over the rest), and whether the
    flags and active corners agree. Run it as
    python3 -c 'import chip_smoke; chip_smoke.rigid_cpu_gap()'."""
    cfg, model, W, Wl = rigid_setup()
    gen = torch.Generator().manual_seed(10)
    mu, kp, push = (a[:RIGID_CHECKED] for a in (*sweep_params(RIGID_SWEEP_B, gen), sweep_pushes(RIGID_SWEEP_B, gen)))
    joy = joysticks(RIGID_CHECKED, device="cpu")
    runs = {}
    for dt in (torch.float32, torch.float64):
        ctl, ctl_l = (RL.WalkingController(cfg, model, convert.mann_weights_from_numpy(w, device="cpu", dtype=dt),
                                           device="cpu") for w in (W, Wl))
        t = time.perf_counter()
        s0 = ctl.initial_state(1, dtype=dt)
        print(f"{dt} initial state (polish and settle) {time.perf_counter() - t:.1f} s")
        stand = torch.tensor([[0.0, 0.0, 1.0, 0.0]], dtype=dt)
        stood = rigid_run(ctl, s0, tick_inputs(stand, RIGID_TICKS))[1:]
        s_l = with_plant_params(items_of(s0, torch.zeros(RIGID_CHECKED, dtype=torch.long)),
                                contact_mu=mu.to(dt), servo_kp=kp.to(dt))
        swept = rigid_run(ctl_l, s_l, pushed_inputs(joy.to(dt), push, RIGID_SWEEP_TICKS))[1:]
        runs[dt] = (s0, stood, swept)
    (s0, *eps32), (s0_64, *eps64) = runs[torch.float32], runs[torch.float64]
    for n, gap in settle_gaps(s0, s0_64).items():
        print(f"settle {n}: {gap:.3e}")
    print(f"settle active corners identical "
          f"{torch.equal(s0.rb.corner_forces[..., 2] > 0, s0_64.rb.corner_forces[..., 2] > 0)}")
    for name, (tel, active), (tel64, active64) in zip(("stand B=1", "pushed sweep items"), eps32, eps64):
        same = all(torch.equal(getattr(tel, n).double(), getattr(tel64, n)) for n in FLAG_CHANNELS)
        print(f"{name}: flags identical {same}, active corners identical {torch.equal(active, active64)}")
        ticks = tel64.q.shape[1]
        for n, want in tel64._asdict().items():
            got = getattr(tel, n).double()
            gaps = [float((got[:, a:b] - want[:, a:b]).abs().max()) / max(1.0, float(want[:, a:b].abs().max()))
                    for a, b in ((0, CLOSED_PERIOD), (CLOSED_PERIOD, ticks))]
            print(f"{name} {n}: first MPC period {gaps[0]:.3e}, after {gaps[1]:.3e}")


def sweep_params(B, gen):
    """Per-item plant parameters of the sweep ([B] float64 each): contact_mu
    in [0.6, 1.0], servo_kp in [2500, 3500]."""
    mu = 0.6 + 0.4 * torch.rand(B, generator=gen, dtype=torch.float64)
    kp = 2500.0 + 1000.0 * torch.rand(B, generator=gen, dtype=torch.float64)
    return mu, kp


def phase_rigid_loop(tag, dev="cuda"):
    """Phase 10: the walking controller on the rigid-body plant, joystick ->
    MANN -> MPC -> IK -> Lagrangian dynamics, tick after tick on the card.
    Returns the launches of its main path (the B = 1 and B = 256 episodes)."""
    t_phase = time.perf_counter()
    cfg, model, W, Wl = rigid_setup()
    ctl = RL.WalkingController(cfg, model, convert.mann_weights_from_numpy(W, device=dev), device=dev)
    ctl64 = RL.WalkingController(cfg, model, convert.mann_weights_from_numpy(W, device="cpu", dtype=torch.float64),
                                 device="cpu")
    ctl_l = RL.WalkingController(cfg, model, convert.mann_weights_from_numpy(Wl, device=dev), device=dev)
    ctl_l64 = RL.WalkingController(cfg, model, convert.mann_weights_from_numpy(Wl, device="cpu", dtype=torch.float64),
                                   device="cpu")
    every, sqp = cfg.mpc_every, cfg.mpc.sqp_iters
    n_settle = int(round(cfg.rigid_settle_s / cfg.wbc_dt))
    mg = model.total_mass * 9.80665
    B = RIGID_SWEEP_B
    launches = {name: 0 for name in KERNELS}

    def add(got):
        for name, n in got.items():
            launches[name] += n

    # --- initial_state(256): the settle, against the CPU's f64 settle ---------
    ctl_l.polished_initial_pose()  # the IK polish, timed apart from the settle
    ctl_l.polished_initial_pose(drop=0.0)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        settle64 = os.path.join(tmp, "settle64.npz")
        with beside("rigid_settle_reference", settle64) as ref:
            zero_launches()
            t = time.perf_counter()
            s_init = ctl_l.initial_state(B)  # initial_state reads no weights: item 0 starts the B = 1 run too
            torch.cuda.synchronize()
            settle_s = time.perf_counter() - t
        s0 = items_of(s_init, slice(0, 1))
        s0_cpu = checkpoint.load(settle64, to_cpu64(s0))
        cpu_settle_s = checkpoint.load_meta(settle64)["wall"]
    fz = float(s0.rb.corner_forces[..., 2].sum())
    nu = float(s0.rb.nu.abs().max())
    require(abs(fz - mg) / mg < 0.1 and nu < 0.1, f"rigid settle: corner fz {fz} N against mg {mg} N, max|nu| {nu}")
    gaps = settle_gaps(s0, s0_cpu)
    worst = max((g, n) for n, g in gaps.items())
    for n, g in gaps.items():
        require(g <= SETTLE_TOL.get(n, SETTLE_TOL_DEFAULT), f"rigid settle: {n} card vs CPU f64 {g}")
    require(torch.equal(s0.rb.corner_forces[..., 2].cpu() > 0, s0_cpu.rb.corner_forces[..., 2] > 0),
            "rigid settle: active corners differ between the card and the CPU")
    print(f"phase 10 rigid settle: initial_state({B}), {n_settle} control ticks ({cfg.rigid.substeps} substeps "
          f"each) on one item, {settle_s:.2f} s on the card (f32; the CPU's f64 settle {cpu_settle_s:.2f} s in a process "
          f"beside it, {ref['waited']:.1f} s waited for after it); total "
          f"corner fz {fz:.1f} N against mg {mg:.1f} N ({100 * (fz - mg) / mg:+.2f} %), max|nu| {nu:.2e}; against "
          f"the CPU f64 settle: active corners identical, largest gap / max(1, |value|) {worst[0]:.2e} ({worst[1]}) "
          f"{tag}")

    # --- B = 1: RIGID_TICKS standing against the CPU in f64 ---------------------
    # (the CPU run starts from the card's settled state, in f64)
    stand = torch.tensor([[0.0, 0.0, 1.0, 0.0]], device=dev)
    zero_launches()
    t = time.perf_counter()
    s_stand, tel, active = rigid_run(ctl, s0, tick_inputs(stand, RIGID_TICKS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got = read_launches()
    add(got)
    n_mpc = -(-RIGID_TICKS // every)
    require(got["spd_inverse"] >= n_mpc and got["admm_fused"] == sqp * n_mpc,
            f"rigid loop B=1 launches {got}, expected admm_fused {sqp} x {n_mpc} MPC ticks")
    up, z, prim = rigid_invariants("rigid loop B=1", tel)
    t = time.perf_counter()
    _, tel64, active64 = rigid_run(ctl64, to_cpu64(s0), tick_inputs(stand.cpu().double(), RIGID_TICKS))
    cpu_s = time.perf_counter() - t
    gap, chan = rigid_vs_cpu("rigid loop B=1", tel, active, tel64, active64, RIGID_TOL)
    print(f"phase 10 rigid loop B=1 stand, fused (K3 + K5), {RIGID_TICKS} ticks ({n_mpc} MPC ticks) in {wall:.2f} s "
          f"(the CPU f64 run {cpu_s:.2f} s): launches {got}; contact flags, fixed feet and active corners identical "
          f"to the CPU f64 run on every tick; first MPC period, largest gap / max(1, |value|) {gap:.2e} ({chan}); "
          f"base_act_up min {up:.4f} (> {RIGID_UP}), base z min {z:.4f} m (> {RIGID_Z}), mpc_prim max {prim:.2e}; "
          f"final fz per foot {[round(f, 1) for f in tel.fz_act[0, -1].tolist()]} N {tag}")

    # --- B = 256: lifted weights, random sticks, per-item plant, pushed ------
    gen = torch.Generator().manual_seed(10)
    mu, kp = sweep_params(B, gen)
    push = sweep_pushes(B, gen)
    joy = joysticks(B, device=dev)
    S = RIGID_SWEEP_TICKS
    s_l = with_plant_params(s_init, contact_mu=mu.float().to(dev), servo_kp=kp.float().to(dev))
    inputs = pushed_inputs(joy, push.float().to(dev), S)
    zero_launches()
    t = time.perf_counter()
    s60, tel_l, active_l = rigid_run(ctl_l, s_l, inputs)
    torch.cuda.synchronize()
    wall_l = time.perf_counter() - t
    got = read_launches()
    add(got)
    require(got["admm_fused"] == sqp * (-(-S // every)), f"rigid loop B=256 launches {got}")
    up_l, z_l, prim_l = rigid_invariants("rigid loop B=256, unpushed items", items_of(tel_l, slice(0, None, 2)))
    up_p, z_p, prim_p = rigid_invariants("rigid loop B=256, pushed items", items_of(tel_l, slice(1, None, 2)),
                                         solved=False)
    swinging = int((tel_l.foot_contact < 0.5).any(-1).any(-1).sum())
    require(swinging > 0, "rigid loop B=256: no foot ever leaves the ground")
    rushed = (tel_l.gait_rush > 0).any(-1)
    items = torch.arange(RIGID_CHECKED)
    require(bool(rushed[[1, 3]].any()), "rigid loop B=256: the push runs neither checked pushed item's gait rush")
    _, tel_l64, active_l64 = rigid_run(ctl_l64, to_cpu64(items_of(s_l, items.to(dev))),
                                       RL.TickInput(*(a[items.to(dev)].cpu().double() for a in inputs)))
    gap_l, chan_l = rigid_vs_cpu("rigid loop B=256", tel_l, active_l, tel_l64, active_l64, RIGID_PUSH_TOL,
                                 items=items.to(dev))
    print(f"phase 10 rigid loop B=256 lifted, per-item contact_mu in [0.6, 1.0] and servo_kp in [2500, 3500], "
          f"the odd items pushed over the first MPC period (items 1 and 3: {RIGID_PUSH} m/s^2 toward "
          f"{RIGID_PUSH_DIRS} degrees, the others random up to it), {S} ticks in {wall_l:.2f} s: launches {got}; "
          f"{swinging} of {B} items with a foot in swing, {int(rushed.sum())} with the gait rush on (items 0-3: "
          f"{rushed[:RIGID_CHECKED].tolist()}); unpushed: base_act_up min {up_l:.4f}, base z min {z_l:.4f} m, "
          f"mpc_prim max {prim_l:.2e}; pushed: base_act_up min {up_p:.4f}, base z min {z_p:.4f} m, mpc_prim max "
          f"{prim_p:.2e} (not held); items 0-3 against the CPU f64: flags and active corners identical on all {S} "
          f"ticks, first MPC period largest gap {gap_l:.2e} ({chan_l}) {tag}")

    # --- times: rigid WBC ticks alone, their launches, a B = 256 tick by span ---
    inp1 = RL.TickInput(*(a[:, 0] for a in tick_inputs(stand, 1)))
    inp256 = RL.TickInput(*(a[:, 0] for a in tick_inputs(joy, 1)))
    for b, c, s_at, inp in ((1, ctl, s_stand, inp1), (B, ctl_l, s60, inp256)):
        _, w, n_sync = wbc_walls(c, s_at, inp, RIGID_WALL_TICKS)
        d = device_time(lambda: c._wbc_stage(s_at, inp))
        profiled = NOT_PROFILED if d is None else (f"{d[1]} kernels, copies and fills, device {d[0]:.3f} ms, largest "
                                                   f"{d[2][0][:60]} {d[2][1]:.3f} ms")
        print(f"phase 10 time rigid WBC tick B={b}: p50 {np.percentile(w, 50):.2f} ms, p90 {np.percentile(w, 90):.2f} "
              f"ms, max {w.max():.2f} ms ({len(w)} ticks, wall, synchronised, sync debug mode off); one tick "
              f"profiled: {profiled}; operations that waited for the card in 3 ticks under the mode: "
              f"{sum(n_sync.values())} {n_sync or ''} {tag}")
        require(not n_sync, f"rigid WBC tick B={b}: operations waited for the card: {n_sync}")
    # the MPC stage's spans are phase 9's (the same stage); here the WBC
    # tick's, where the rigid plant sits (a whole rigid period took a minute
    # under the profiler)
    t = time.perf_counter()
    prof = span_profile(lambda: ctl_l._wbc_stage(s60, inp256))
    print(f"phase 10 profile pass {time.perf_counter() - t:.1f} s")
    tick_wall = float(np.percentile(w, 50))  # the B = 256 ticks' p50 above
    if prof is None:
        print(f"phase 10 profile rigid WBC tick B={B}: wall {tick_wall:.1f} ms (unprofiled p50); device {NOT_PROFILED} "
              f"{tag}")
    else:
        spans, (dev_ms, kernels) = prof
        print(f"phase 10 profile rigid WBC tick B={B}: wall {tick_wall:.1f} ms (unprofiled p50), device {dev_ms:.3f} "
              f"ms in {kernels} kernels, idle share {1 - dev_ms / tick_wall:.3f} {tag}")
        for name, (ms, count, host) in spans.items():
            print(f"phase 10 profile rigid WBC tick B={B} span {name}: device {ms:.3f} ms ({100 * ms / dev_ms:.1f} %), "
                  f"{count} kernels, host {host:.1f} ms under the profiler {tag}")
    print(f"phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# --- the push-recovery sweep and the walk through their command lines ---------
# (cmw_tpu/dist/sweep.py, cmw_tpu/apps/sweep.py, cmw_tpu/apps/walk.py)

# the CLI's flags: 512 scenarios in two chunks of 256, 0.6 s (300 ticks, 10
# MPC periods), the push window from 0.06 s for 0.4 s (ticks 29-228, JAX's
# truncation), magnitudes in [-2, 2] m/s^2, the dense KKT (K3 once and K4 48
# times an MPC stage); the production ergocub_gazebo_v1() on the CLI's
# default model, kin.ergocub_approx()
SWEEP_B, SWEEP_CHUNK, SWEEP_SECONDS = 512, 256, 0.6
SWEEP_ARGS = ["--batch", str(SWEEP_B), "--chunk", str(SWEEP_CHUNK), "--seconds", str(SWEEP_SECONDS),
              "--push-t0", "0.06", "--push-duration", "0.4", "--push-max", "2.0", "--kkt", "dense", "--per-scenario"]
# what the JAX CLI prints with --per-scenario (cmw_tpu/dist/sweep.py:235-252,
# cmw_tpu/apps/sweep.py:183-190)
SWEEP_KEYS = {"batch", "survival_rate", "mean_supp_dev", "max_supp_dev", "survived", "recoverable_push_x",
              "recoverable_push_y", "push_mags", "push_dirs", "survived_mask", "step_adjustment", "wall_seconds",
              "scenario_seconds_per_s", "devices"}
SWEEP_CHECKED = (0, 1, 510, 511)  # the largest pushes: -x, -y, +x, +y
SWEEP_METRICS = ("supp_dev", "z_dev", "track_err", "finite", "up_min", "bz_min", "zb0")  # dist/sweep._episode_metrics
# card f32 against the port's CPU f64 on SWEEP_CHECKED, per metric, of
# max(1, |CPU value|): 20x the largest of the CPU's own f32-vs-f64 gaps on the
# same items over SWEEP_ORDERS (`sweep_flip()`: supp_dev 3.7e-5, z_dev 3.0e-5,
# track_err 5.6e-7, up_min 4.9e-6, bz_min 2.4e-6, zb0 7.0e-8), rounded
# up; `finite` identical. supp_dev's and z_dev's largest gaps are discrete:
# an item's MPC solution jumps at one MPC tick (mpc_cost ~0.3 % apart) in
# some f32 orders and batches and not in others (`sweep_flip`'s parting ticks)
SWEEP_TOL = {"supp_dev": 8e-4, "z_dev": 7e-4, "track_err": 2e-5, "finite": 0.0, "up_min": 1e-4, "bz_min": 5e-5,
             "zb0": 2e-6}
# the walk CLI at B = 1: 0.12 s pushed and saved, 0.06 s resumed, against 0.18
# s straight; the push inside the first 0.12 s
WALK_ARGS = ["--joystick", "0:0.6,0,1,0"]
WALK_PUSH = ["--push", "0.02,0.08,1.5,-1.0,0"]


@contextlib.contextmanager
def recorded_sweep(run: bool = True):
    """Records, into the yielded dict, each run_sweep call of the sweep CLI
    ("calls": its controller and keywords) and what each call of
    dist/sweep._episode_metrics returns ("metrics": the per-scenario metrics
    of a sweep). With run False, run_sweep only records (and returns {})."""
    from cmw_tpu_torch.apps import sweep as sweep_app

    rec, real_run, real_metrics = {"calls": [], "metrics": []}, sweep_app.run_sweep, DS._episode_metrics

    def recording_run(ctl, **kw):
        rec["calls"].append((ctl, kw))
        return real_run(ctl, **kw) if run else {}

    def recording_metrics(*args):
        rec["metrics"].append(real_metrics(*args))
        return rec["metrics"][-1]

    sweep_app.run_sweep, DS._episode_metrics = recording_run, recording_metrics
    try:
        yield rec
    finally:
        sweep_app.run_sweep, DS._episode_metrics = real_run, real_metrics


def write_mann(directory) -> str:
    """The synthetic mann4 weights as an ONNX file in directory (f32, as the
    CLIs read them); returns its path."""
    path = os.path.join(directory, "mann4.onnx")
    with open(path, "wb") as f:
        f.write(mann_onnx_bytes(synthetic_mann_numpy()))
    return path


def sweep_call_cpu(mann):
    """The run_sweep call the sweep CLI makes under SWEEP_ARGS with --cpu,
    recorded and not run: (controller, keywords)."""
    from cmw_tpu_torch.apps import sweep as sweep_app

    with recorded_sweep(run=False) as rec, contextlib.redirect_stdout(io.StringIO()):
        sweep_app.main(SWEEP_ARGS + ["--mann", mann, "--cpu"])
    return rec["calls"][0]


def sweep_scenarios(dtype, mann, call, device="cpu", **mpc):
    """The scenarios of a recorded run_sweep call (controller, keywords)
    rebuilt on device in dtype, on its configuration (with the MPCConfig
    fields mpc replaced) and the weights in the ONNX file mann:
    (controller, initial LoopState, TickInput)."""
    ctl, kw = call
    cfg = dataclasses.replace(ctl.cfg, mpc=dataclasses.replace(ctl.cfg.mpc, **mpc))
    ctl = RL.WalkingController(cfg, ctl.model, N.load_mann_weights(mann, device=device, dtype=dtype), device=device)
    s0, inputs = DS.build_scenarios(ctl, kw["batch"], kw["seconds"], kw["push_max"], kw["push_duration"], kw["vx"],
                                    kw["ramp"], kw["push_t0"], dtype=dtype)
    return ctl, s0, inputs


def sweep_items(dtype, mann, call, device="cpu", **mpc):
    """sweep_scenarios' items SWEEP_CHECKED run alone (B = 4): (survived,
    per-scenario metrics through dist/sweep._shard_metrics, mpc_cost [4, S]
    of every tick), as numpy arrays."""
    ctl, s0, inputs = sweep_scenarios(dtype, mann, call, device, **mpc)
    idx = torch.tensor(SWEEP_CHECKED, device=device)
    costs, fold_episode = [], ctl.run_episode_fold
    ctl.run_episode_fold = lambda s, inp, fold, acc0: fold_episode(
        s, inp, lambda acc, tel: costs.append(tel.mpc_cost) or fold(acc, tel), acc0)
    with recorded_sweep() as rec:
        survived, _ = DS._shard_metrics(ctl, items_of(s0, idx), items_of(inputs, idx), False,
                                        up_thresh=call[1]["up_thresh"], model_guards=call[1]["model_guards"])
    return (survived.cpu().numpy(), [m.cpu().numpy() for m in rec["metrics"][0]],
            torch.stack(costs, dim=1).cpu().double().numpy())


def sweep_reference(mann, path):
    """Writes the CPU f64 reference of SWEEP_CHECKED to the npz file path:
    sweep_items on the run_sweep call the sweep CLI makes with --cpu,
    that call's keywords and configuration, and the wall. Phase 11 runs it
    in a process of its own beside the card's sweep, whose results it does
    not read."""
    torch.set_num_threads(2)
    t = time.perf_counter()
    call = sweep_call_cpu(mann)
    survived, metrics, _ = sweep_items(torch.float64, mann, call)
    np.savez(path, survived=survived, kw=json.dumps(call[1]), cfg=repr(call[0].cfg), wall=time.perf_counter() - t,
             **dict(zip(SWEEP_METRICS, metrics)))


def metric_gaps(got, want):
    """{metric: |got - want| / max(1, |want|)} over the items (numpy),
    `finite` as 0 or 1 (identical or not)."""
    gaps = {}
    for name, a, b in zip(SWEEP_METRICS, got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        gaps[name] = float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
    return gaps


# the f32 orders of the dense KKT path whose gaps to f64 set SWEEP_TOL (MPCConfig
# fields replaced): the x-update packed (K4 and its twin: the lower blocks
# mirrored; the card's default) or the full matrix (the CPU's default), and
# the Cholesky + triangular-solve inverse in K3's place
SWEEP_ORDERS = {"packed x-update": {"xupdate_impl": "symv"}, "full-matrix x-update": {"xupdate_impl": "dense"},
                "xla inverse, packed x-update": {"inverse_impl": "xla", "xupdate_impl": "symv"}}


def sweep_flip(device="cpu"):
    """The port's own f32-vs-f64 gaps behind SWEEP_TOL, and where they come
    from: SWEEP_CHECKED alone (B = 4) in f32 on device in each of
    SWEEP_ORDERS against the CPU f64: each metric's gap, per item the first
    tick at which mpc_cost parts from f64's by more than 1e-4 of max(1,
    |cost|) with both costs there, and the largest gaps over the orders. Run
    it as python3 -c 'import chip_smoke; chip_smoke.sweep_flip()', or with
    "cuda" on the card."""
    with tempfile.TemporaryDirectory() as tmp:
        mann = write_mann(tmp)
        call = sweep_call_cpu(mann)
        surv64, m64, cost64 = sweep_items(torch.float64, mann, call)
        print(f"f64 survived {surv64.tolist()}; " + "; ".join(f"{n} {m.tolist()}" for n, m in zip(SWEEP_METRICS, m64)))
        worst = dict.fromkeys(SWEEP_METRICS, 0.0)
        for order, mpc in SWEEP_ORDERS.items():
            t = time.perf_counter()
            surv32, m32, cost = sweep_items(torch.float32, mann, call, device, **mpc)
            gaps = metric_gaps(m32, m64)
            worst = {n: max(worst[n], g) for n, g in gaps.items()}
            parted = []
            for i, item in enumerate(SWEEP_CHECKED):
                far = np.nonzero(np.abs(cost[i] - cost64[i]) > 1e-4 * max(1.0, np.abs(cost64[i]).max()))[0]
                if len(far):
                    parted.append(f"item {item} at tick {far[0]} ({cost[i, far[0]]:.6g} against "
                                  f"{cost64[i, far[0]]:.6g})")
            print(f"sweep_flip {device} f32 {order} ({time.perf_counter() - t:.1f} s): survived {surv32.tolist()}; "
                  f"gap / max(1, |f64|) {', '.join(f'{n} {g:.3e}' for n, g in gaps.items())}; mpc_cost parts from "
                  f"f64's: {', '.join(parted) or 'never'}")
    print(f"largest f32 gap over the orders: {', '.join(f'{n} {g:.3e}' for n, g in worst.items())}")


def checkpoint_gap(a, b):
    """Two checkpoint files of one layout: (largest |a - b| / max(1, |b|) over
    the float leaves, whether every leaf is bitwise equal)."""
    with np.load(a) as fa, np.load(b) as fb:
        require(fa.files == fb.files, f"{a} and {b} hold other leaves")
        worst, same = 0.0, True
        for name in fa.files:
            x, y = fa[name], fb[name]
            require(x.dtype == y.dtype and x.shape == y.shape, f"checkpoint leaf {name}: {x.dtype}{x.shape} vs "
                                                               f"{y.dtype}{y.shape}")
            same = same and np.array_equal(x, y)
            if x.dtype.kind == "f":
                worst = max(worst, float(np.abs(x - y).max(initial=0.0)) / max(1.0, float(np.abs(y).max(initial=0.0))))
    return worst, same


def phase_sweep(tag):
    """Phase 11: the push-recovery sweep through `apps.sweep.main` on the
    card (SWEEP_ARGS), its largest pushes against the port on the CPU in
    f64, and the walk CLI split by a checkpoint against a straight run.
    Returns the launches of the sweep."""
    from cmw_tpu_torch.apps import sweep as sweep_app
    from cmw_tpu_torch.apps import walk as walk_app

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mann = write_mann(tmp)
        reference = os.path.join(tmp, "reference.npz")
        with beside("sweep_reference", mann, reference) as ref:
            # --- 512 scenarios through the CLI ----------------------------------
            printed = io.StringIO()
            zero_launches()
            t = time.perf_counter()
            with recorded_sweep() as rec, contextlib.redirect_stdout(printed):
                sweep_app.main(SWEEP_ARGS + ["--mann", mann])
            wall = time.perf_counter() - t
            launches = read_launches()
        out = json.loads(printed.getvalue().strip().splitlines()[-1])
        require(set(out) == SWEEP_KEYS, f"sweep CLI keys {sorted(out)} are not the JAX CLI's {sorted(SWEEP_KEYS)}")
        stats = [out[k] for k in ("survival_rate", "mean_supp_dev", "max_supp_dev")]
        require(0.0 <= out["survival_rate"] <= 1.0 and all(math.isfinite(v) for v in stats),
                f"sweep CLI statistics {stats}")
        cfg = ergocub_gazebo_v1()
        stages = SWEEP_B // SWEEP_CHUNK * round(SWEEP_SECONDS / cfg.wbc_dt) // cfg.mpc_every
        want = {"spd_inverse": stages, "symv_packed": cfg.mpc.sqp_iters * cfg.mpc.admm_iters * stages,
                "admm_fused": 0}
        require(launches == want, f"sweep CLI launches {launches}, expected {want} (10 MPC stages x 2 chunks)")
        print(f"phase 11 sweep CLI (apps.sweep.main {' '.join(SWEEP_ARGS)}), {SWEEP_B} scenarios in chunks of "
              f"{SWEEP_CHUNK}: launches {launches}; wall {wall:.2f} s (the CLI's own {out['wall_seconds']} s), "
              f"{out['scenario_seconds_per_s']} scenario-s/s; survived {out['survived']} of {SWEEP_B} "
              f"(survival_rate {out['survival_rate']}), mean_supp_dev {out['mean_supp_dev']}, max_supp_dev "
              f"{out['max_supp_dev']}, recoverable push x {out['recoverable_push_x']} y {out['recoverable_push_y']} "
              f"m/s^2 {tag}")

        # --- the largest pushes against the CPU in f64 ---------------------------
        ctl, kw = rec["calls"][0]
        with np.load(reference) as f:
            require(json.loads(str(f["kw"])) == kw and str(f["cfg"]) == repr(ctl.cfg),
                    "the CPU reference's run_sweep call is not the card's")
            surv64, m64, cpu_wall = f["survived"], [f[n] for n in SWEEP_METRICS], float(f["wall"])
        idx = list(SWEEP_CHECKED)
        card = [m[idx].cpu().numpy() for m in rec["metrics"][0]]
        surv_card = [out["survived_mask"][i] for i in SWEEP_CHECKED]
        require(surv_card == surv64.tolist(), f"sweep items {SWEEP_CHECKED} survived {surv_card} on the card, "
                                              f"{surv64.tolist()} on the CPU f64")
        gaps = metric_gaps(card, m64)
        for name, gap in gaps.items():
            require(gap <= SWEEP_TOL[name], f"sweep {name} card vs CPU f64 {gap} (limit {SWEEP_TOL[name]})")
        print(f"phase 11 sweep items {idx} card f32 vs CPU f64 ({cpu_wall:.1f} s on the CPU in a process beside the "
              f"sweep, {ref['waited']:.1f} s waited for after it): survived {surv_card} on both; gap / max(1, |value|) "
              f"{', '.join(f'{n} {g:.2e}' for n, g in gaps.items())}; supp_dev {card[0].tolist()} {tag}")

        # --- the walk CLI split by a checkpoint ----------------------------------
        files = {name: os.path.join(tmp, f"{name}.npz") for name in ("a", "b", "c", "ta", "tb", "tc")}
        common = ["--mann", mann] + WALK_ARGS
        t = time.perf_counter()
        walk_app.main(common + WALK_PUSH + ["--seconds", "0.12", "--save-state", files["a"], "--out", files["ta"]])
        walk_app.main(common + ["--seconds", "0.06", "--resume-state", files["a"], "--save-state", files["b"],
                                "--out", files["tb"]])
        walk_app.main(common + WALK_PUSH + ["--seconds", "0.18", "--save-state", files["c"], "--out", files["tc"]])
        walk_wall = time.perf_counter() - t
        gap, same = checkpoint_gap(files["b"], files["c"])
        require(same or gap <= CLOSED_TOL_DEFAULT, f"walk CLI: the split run ends {gap} from the straight one")
        for name, ticks in (("ta", 60), ("tb", 30), ("tc", 90)):
            chans, _ = RT.load(files[name])
            require(chans["com_mpc"].shape == (ticks, 3), f"walk telemetry {name}: {chans['com_mpc'].shape}")
        print(f"phase 11 walk CLI B=1 (Riccati MPC), 0.12 s pushed + checkpoint + 0.06 s resumed against 0.18 s "
              f"straight in {walk_wall:.1f} s: final states bitwise equal {same}, largest gap {gap:.2e}; the "
              f"three telemetry files load {tag}")
    print(f"phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# --------------------------------------------------------------------------
# phase 12: the remaining entry points
# --------------------------------------------------------------------------

BF16_TAILS = (0, 8)  # kkt_f32_tail of the bf16 runs
BF16_PRIM_MAX, BF16_COST_RTOL = 5e-2, 0.08  # JAX's envelope against f32 (tests/test_cmpc.py:211-235)
BF16_ENVELOPE = dict(sqp_iters=6, admm_iters=80, refactor_every_sqp=True)  # converged solves, as there
BF16_PUSHES = (0.0, 1.2, -1.2, 0.6)
ROBOT_DIR_SECONDS = 0.3  # the walk CLI's run on the written robot directory
WALKER_SECONDS, WALKER_SCALE = 6.0, 0.05  # the headless real-time walker: wall seconds, virtual-clock rate
WALKER_JOYPADS = ((0.5, 0.0), (0.0, 0.3))  # the stick before and after mid-run


def write_robot_dir(directory, cfg) -> str:
    """A reference-style robot directory holding every key that
    runtime/ini.load_robot_config reads, with the values of the
    WalkingConfig `cfg`, under directory/robot; returns its path. For
    ergocub_gazebo_v1() it loads back to that config."""
    m, g, ib = cfg.mpc, cfg.gen, cfg.input_builder

    def tup(v):
        return "(" + ", ".join(repr(float(x)) for x in v) + ")"

    def contact(i):
        return (f"[CONTACT_{i}]\nnumber_of_corners {len(m.corners[i])}\n"
                + "".join(f"corner_{k} {tup(c)}\n" for k, c in enumerate(m.corners[i]))
                + f"bounding_box_lower_limit {tup(m.bbox_lower[i])}\nbounding_box_upper_limit {tup(m.bbox_upper[i])}\n")

    kp = cfg.ik.kp_posture
    files = {
        "centroidal_mpc_walking.ini": f"[WHOLE_BODY_RUNNER]\nsampling_time {cfg.wbc_dt}\n\n[COM_ZMP_CONTROLLER]\n"
                                      f"com_gain {tup(cfg.gains.com_gain)}\nzmp_gain {tup(cfg.gains.zmp_gain)}\n",
        "centroidal_mpc.ini": f"sampling_time {m.dt}\ntime_horizon {m.horizon}\nnumber_of_maximum_contacts "
                              f"{m.n_contacts}\nstatic_friction_coefficient {m.mu}\ncom_weight {tup(m.com_weight)}\n"
                              f"contact_position_weight {m.contact_position_weight}\nforce_rate_of_change_weight "
                              f"{tup(m.force_rate_weight)}\nangular_momentum_weight {m.angular_momentum_weight}\n"
                              f"contact_force_symmetry_weight {m.force_symmetry_weight}\n\n{contact(0)}\n{contact(1)}",
        "mann.ini": f"sampling_time {g.dt}\ntime_horizon {g.time_horizon}\npast_projected_base_horizon "
                    f"{g.past_horizon}\nslow_down_factor {g.slow_down_factor}\nbase_vel_norm {ib.base_vel_norm}\n"
                    f"ellipsoid_forward_axis {ib.ellipsoid_forward_axis}\nellipsoid_side_axis "
                    f"{ib.ellipsoid_side_axis}\nellipsoid_backward_axis {ib.ellipsoid_backward_axis}\n"
                    f"ellipsoid_scaling_factor {ib.ellipsoid_scaling_factor}\nmax_facing_direction_angle_forward "
                    f"{ib.max_facing_angle_forward}\nmax_facing_direction_angle_backward "
                    f"{ib.max_facing_angle_backward}\nmax_facing_direction_angle_side_opposite_sign "
                    f"{ib.max_facing_angle_side_opposite_sign}\nmax_facing_direction_angle_side_same_sign "
                    f"{ib.max_facing_angle_side_same_sign}\nnumber_of_knots {ib.number_of_knots}\n\n[LEFT_FOOT]\n"
                    f"on_threshold {g.on_threshold}\noff_threshold {g.off_threshold}\nswitch_on_after "
                    f"{g.switch_on_after}\nswitch_off_after {g.switch_off_after}\n",
        "swing_foot_planner.ini": f"step_height {cfg.swing.step_height}\nfoot_apex_time {cfg.swing.foot_apex_time}\n"
                                  f"foot_landing_velocity {cfg.swing.landing_velocity}\nfoot_landing_acceleration "
                                  f"{cfg.swing.landing_acceleration}\n",
        "ik.ini": f"[LEFT_FOOT]\nkp_linear {cfg.ik.kp_foot_lin}\nkp_angular {cfg.ik.kp_foot_ang}\n\n[COM]\nkp_linear "
                  f"{cfg.ik.kp_com}\n\n[ROOT_TASK]\nkp_linear {cfg.ik.kp_root}\n\n[CHEST]\nkp_angular "
                  f"{cfg.ik.kp_chest}\nframe_name \"{cfg.ik.chest_frame}\"\nweight {tup(cfg.ik.chest_weight)}\n\n"
                  f"[JOINT_REGULARIZATION]\nkp {tup(kp) if isinstance(kp, tuple) else kp}\nweight "
                  f"{tup(cfg.ik.posture_weight)}\n",
        "legged_odometry.ini": "".join(
            ["[ModelInfo]\n"] + [f"{k} \"{getattr(cfg.odom, k)}\"\n" for k in
                                ("base_link", "base_link_imu", "left_foot_contact_frame", "right_foot_contact_frame")]
            + ["\n[LeggedOdom]\n"] + [f"{k} \"{getattr(cfg.odom, k)}\"\n" for k in
                                      ("initial_fixed_frame", "switching_pattern")]),
    }
    robot = os.path.join(directory, "robot")
    os.makedirs(robot, exist_ok=True)
    for name, text in files.items():
        with open(os.path.join(robot, name), "w") as f:
            f.write(text)
    return robot


def phase_remaining(tag, cfg_dense):
    """Phase 12: the bf16 KKT option of the dense branch, the parity CLI, the
    walk CLI on a written robot directory, a headless real-time walker,
    `entry()`, `dryrun_multichip(1)` and the scaling CLI. Returns the
    launches of the bf16 runs."""
    from cmw_tpu_torch import entry as E
    from cmw_tpu_torch.apps import parity as parity_app
    from cmw_tpu_torch.apps import scaling as scaling_app
    from cmw_tpu_torch.apps import walk as walk_app
    from cmw_tpu_torch.runtime.ini import load_robot_config
    from cmw_tpu_torch.runtime.realtime import RealtimeWalker

    t_phase = time.perf_counter()
    # --- the bf16 KKT: the B = 512 x KB = 4 chain and the envelope against f32 -
    t = time.perf_counter()
    _, _, s32 = bench_chain(CentroidalMPCSolver(cfg_dense), cfg_dense)
    env32 = dataclasses.replace(cfg_dense, **BF16_ENVELOPE)
    params = BENCH.make_params(env32, lateral(BF16_PUSHES))
    ref = CentroidalMPCSolver(env32)
    ref = ref.solve(params, ref.cold_start(len(BF16_PUSHES)))
    zero_launches()  # the f32 runs above launch K4; the bf16 runs below must not
    rates = {}
    for tail in BF16_TAILS:  # bench.py's bf16_kkt_solves_per_s; the chain is not converged: prim_res printed
        cfg16 = dataclasses.replace(cfg_dense, kkt_dtype="bf16", kkt_f32_tail=tail)
        _, prims, s16 = bench_chain(CentroidalMPCSolver(cfg16), cfg16, prim_max=None)
        rates[tail] = (512 * 4 / s16, float(prims.max()))
    envelope = {}
    for tail in BF16_TAILS:
        solver = CentroidalMPCSolver(dataclasses.replace(env32, kkt_dtype="bf16", kkt_f32_tail=tail))
        sol = solver.solve(params, solver.cold_start(len(BF16_PUSHES)))
        off, prim = float(((sol.cost - ref.cost) / ref.cost).abs().max()), float(sol.prim_res.max())
        envelope[tail] = (off, prim)
        require(prim < BF16_PRIM_MAX and off < BF16_COST_RTOL,
                f"bf16 tail {tail}: prim_res {prim}, cost offset {off} against f32, outside JAX's envelope")
    launches = read_launches()
    require(launches["spd_inverse"] > 0 and launches["symv_packed"] == 0 and launches["admm_fused"] == 0,
            f"bf16 runs' launches {launches}: K3 must launch, K4 and K5 not")
    for tail in BF16_TAILS:
        print(f"phase 12 bf16 KKT tail {tail}: B=512 x KB=4 dense chain {rates[tail][0]:.1f} solves/s "
              f"(bf16_kkt_solves_per_s; f32 dense {512 * 4 / s32:.1f}), chain max prim {rates[tail][1]:.2e}; "
              f"B={len(BF16_PUSHES)} converged solves (sqp 6 x admm 80) against f32: max cost offset "
              f"{envelope[tail][0]:.2e}, max prim {envelope[tail][1]:.2e} (limits {BF16_COST_RTOL}, "
              f"{BF16_PRIM_MAX}) {tag}")
    print(f"phase 12 bf16 KKT launches {launches} ({time.perf_counter() - t:.1f} s)")

    # --- the parity CLI on the card ------------------------------------------------
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = parity_app.main([])
    require(out["parity_ok"], f"parity CLI: {out}")
    print(f"phase 12 parity CLI (apps.parity.main([]), solve on the card, SLSQP oracle in processes beside it): "
          f"parity_ok {out['parity_ok']}; " + "; ".join(
              f"{c['case']} ratio {c['ratio']} (cost {c['jax_cost']} vs {c['oracle_cost']}, prim {c['prim_res']:.2e})"
              for c in out["cases"]) + f" ({time.perf_counter() - t:.1f} s) {tag}")

    with tempfile.TemporaryDirectory() as tmp:
        mann = write_mann(tmp)
        # --- the walk CLI on a written robot directory ---------------------------------
        t = time.perf_counter()
        cfg = ergocub_gazebo_v1()
        robot = write_robot_dir(tmp, cfg)
        loaded = load_robot_config(robot)
        require(loaded == cfg, "the written robot directory does not load to ergocub_gazebo_v1()")
        with contextlib.redirect_stdout(io.StringIO()):
            summary = walk_app.main(["--robot-dir", robot, "--mann", mann, "--seconds", str(ROBOT_DIR_SECONDS),
                                     "--out", os.path.join(tmp, "walk.npz")])
        chans, _ = RT.load(os.path.join(tmp, "walk.npz"))
        ticks = round(ROBOT_DIR_SECONDS / cfg.wbc_dt)
        require(summary["finite"] and chans["com_mpc"].shape == (ticks, 3)
                and all(np.isfinite(v).all() for v in chans.values()), f"walk --robot-dir: {summary}")
        print(f"phase 12 walk CLI --robot-dir (a written ergoCubGazeboV1 directory), {ticks} ticks: finite, "
              f"{summary['wall_seconds']} s, com travel {summary['com_travel_xy']}, mpc_prim max "
              f"{summary['mpc_prim_max']:.2e} ({time.perf_counter() - t:.1f} s) {tag}")

        # --- the headless real-time walker ---------------------------------------------
        t = time.perf_counter()
        ctl = RL.WalkingController(cfg, kin.ergocub_approx(), N.load_mann_weights(mann))
        rw = RealtimeWalker(ctl, time_scale=WALKER_SCALE)
        rw.set_joypad(*WALKER_JOYPADS[0])
        change = threading.Timer(WALKER_SECONDS / 2, rw.set_joypad, WALKER_JOYPADS[1])
        change.start()
        try:
            stats = rw.run(duration_s=WALKER_SECONDS)
        finally:
            change.cancel()
        require(not stats["failed"] and stats["ticks"] > 0 and stats.get("finite", False)
                and bool(torch.isfinite(rw.state.q).all()), f"real-time walker: {stats}")
        print(f"phase 12 RealtimeWalker {WALKER_SECONDS} s headless at time scale {WALKER_SCALE} (MPC period "
              f"{cfg.mpc.dt / WALKER_SCALE:.2f} s, WBC {cfg.wbc_dt / WALKER_SCALE:.3f} s), stick "
              f"{WALKER_JOYPADS[0]} then {WALKER_JOYPADS[1]} mid-run: ticks {stats['ticks']}, sim time "
              f"{stats['sim_time']:.3f} s, MPC task {stats['mpc']}, WBC task {stats['wbc']}, com {stats['com_final']}, "
              f"slewed stick {[round(v, 3) for v in rw.state.joypad_lp[0].tolist()]} "
              f"({time.perf_counter() - t:.1f} s) {tag}")
        del rw, ctl

        # --- entry(), dryrun_multichip(1), the scaling CLI -----------------------------
        t = time.perf_counter()
        fn, args = E.entry()
        sol = fn(*args)
        require(bool(torch.isfinite(sol.cost).all()) and float(sol.prim_res[0]) < 1e-2, "entry(): solve")
        dry = E.dryrun_multichip(1, mann=mann)
        require(math.isfinite(dry["mean_cost"]) and dry["com_max"] < 10.0, f"dryrun_multichip: {dry}")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rows = scaling_app.main(["--devices", "1"])
        require(rows[0]["solves_per_s"] > 0, f"scaling: {rows}")
        print(f"phase 12 entry(): cost {float(sol.cost[0]):.4f}, prim {float(sol.prim_res[0]):.2e}; "
              f"dryrun_multichip(1) (NCCL, one rank): mean cost {dry['mean_cost']:.3f}, max|com| "
              f"{dry['com_max']:.3f}; scaling N=1: {rows[0]['solves_per_s']} solves/s at batch {rows[0]['batch']} "
              f"({time.perf_counter() - t:.1f} s) {tag}")
    print(f"phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# --- the benchmark entry points: apps.bench, apps.bench_kkt, apps.breakdown ----

# bench.py's keys (bench.py:173-190; tests/test_torch_bench.py ties them to it)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
BENCH_EXTRA_KEYS = {"batch", "sqp_iters", "admm_iters", "compile_s", "model_flops_per_solve", "mfu_est",
                    "hbm_bytes_per_solve", "hbm_bw_util_est", "numerics_ok", "device"}
BENCH_REPS = 2  # timed chains after the first, in each bench line (the CLIs' 5, cut for the script's time)
BENCH_SAMPLES = 1  # B = 1 latency dispatches of 10 solves (bench.py's 200, cut for the script's time)


def captured(main, argv):
    """(the lines main(argv) printed on stdout, the launches in the call),
    the counts zeroed just before it."""
    out = io.StringIO()
    zero_launches()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines(), read_launches()


def phase_benchmarks(tag):
    """Phase 13: the port's benchmark line (apps.bench --full), the KKT
    paths' A/B (apps.bench_kkt both, fused) and the stage breakdown
    (apps.breakdown), at B = 512, each with its launches held. Returns the
    launches of the phase."""
    from cmw_tpu_torch.apps import bench_kkt, breakdown

    t_phase = time.perf_counter()
    solves = (1 + BENCH_REPS) * BENCH.KB  # B = 512 solves of one path in one bench line
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench_extra.json")
        t = time.perf_counter()
        lines, l_bench = captured(BENCH.main, ["--full", "--reps", str(BENCH_REPS), "--samples", str(BENCH_SAMPLES),
                                              "--extra-out", path])
        with open(path) as f:
            extras = json.load(f)
    print(f"phase 13 apps.bench --full ({time.perf_counter() - t:.1f} s, launches {l_bench}): {lines}")
    print(f"phase 13 apps.bench extras: {json.dumps(extras['extra'])} {tag}")
    require(len(lines) == 1, f"apps.bench printed {len(lines)} lines, not one")
    rec = json.loads(lines[0])
    require(set(rec) == BENCH_KEYS and set(rec["extra"]) == BENCH_EXTRA_KEYS,
            f"apps.bench keys {sorted(rec)} / {sorted(rec['extra'])} are not bench.py's")
    ex = rec["extra"]
    require(ex["numerics_ok"] is True, "apps.bench: numerics_ok false")
    require(math.isfinite(rec["value"]) and rec["value"] > 0, f"apps.bench value {rec['value']}")
    require(0 < ex["mfu_est"] <= 1.05 and 0 < ex["hbm_bw_util_est"] <= 1.05,
            f"apps.bench mfu_est {ex['mfu_est']}, hbm_bw_util_est {ex['hbm_bw_util_est']} outside (0, 1.05]")
    # the Riccati headline and B = 1 chains launch nothing; the sentinel's dense
    # Cholesky solve takes K4 every ADMM iteration; the bf16 chain K3 once a solve
    cfg = ergocub_mpc_config()
    want = {"spd_inverse": solves, "symv_packed": cfg.sqp_iters * cfg.admm_iters, "admm_fused": 0}
    require(l_bench == want, f"apps.bench launches {l_bench}, expected {want}")

    for which, per_solve in (("both", {"spd_inverse": 1, "symv_packed": cfg.sqp_iters * cfg.admm_iters,
                                        "admm_fused": 0}),
                             ("fused", {"spd_inverse": 1, "symv_packed": 0, "admm_fused": cfg.sqp_iters})):
        t = time.perf_counter()
        lines, launches = captured(bench_kkt.main, [which, "--reps", str(BENCH_REPS)])
        for line in lines:
            print(f"phase 13 apps.bench_kkt {which} B=512: {line} {tag}")
        print(f"phase 13 apps.bench_kkt {which}: launches {launches} ({time.perf_counter() - t:.1f} s)")
        want = {name: n * solves for name, n in per_solve.items()}  # "both": its riccati line launches nothing
        require(launches == want, f"apps.bench_kkt {which} launches {launches}, expected {want}")
        l_bench = {name: l_bench[name] + launches[name] for name in l_bench}

    t = time.perf_counter()
    lines, launches = captured(breakdown.main, ["--reps", str(BENCH_REPS)])
    for line in lines:
        print(f"phase 13 apps.breakdown B=512: {line} {tag}")
    print(f"phase 13 apps.breakdown: launches {launches} ({time.perf_counter() - t:.1f} s)")
    want = {"spd_inverse": 1 + BENCH_REPS, "symv_packed": 0, "admm_fused": 0}  # the inverse alone; Riccati solves
    require(launches == want, f"apps.breakdown launches {launches}, expected {want}")
    print(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return {name: l_bench[name] + launches[name] for name in l_bench}


def main():
    require(torch.cuda.is_available(), "no CUDA device: this smoke run needs a GPU")
    t_start = time.perf_counter()
    card = BENCH.device_name("cuda")
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; tf32 matmul {torch.backends.cuda.matmul.allow_tf32}")
    tag = f"[{card}]"
    dev = "cuda"
    cfg_dense = ergocub_mpc_config(kkt_impl="dense")
    cfg_fused = ergocub_mpc_config(kkt_impl="dense", admm_impl="fused")
    cfg_ric = ergocub_mpc_config()

    # --- 1. build ------------------------------------------------------------
    t = time.perf_counter()
    _build.library()
    print(f"phase 1 build: {len(_build.sources())} sources, nvcc {_build.build_seconds:.2f} s, "
          f"load {time.perf_counter() - t:.2f} s")
    # whether torch.profiler records the card's work here (the profiles of
    # phases 7-10 read "not measured" where it does not)
    x = torch.ones(1 << 20, device=dev)
    probe = device_time(lambda: x.sum())
    PROFILER_RECORDS[0] = probe is not None
    print("phase 1 profiler probe: " + (NOT_PROFILED if probe is None else
                                        f"{probe[1]} kernels, {probe[0]:.4f} ms device recorded"))
    if probe is None:  # what may hold CUPTI or configure the profiler here
        env = sorted((k, v) for k, v in os.environ.items() if any(w in k for w in ("KINETO", "CUPTI", "INJECTION")))
        print(f"phase 1 profiler environment: {env}")

    # --- 2. kernels vs plain twins on the card ------------------------------
    M_real, qp4 = cold_linearisation(cfg_dense, BENCH.make_params(cfg_dense, lateral([-1.0, 0.0, 0.6, 1.2])))
    gen = torch.Generator(device=dev).manual_seed(7)
    errs = {"spd_inverse": 0.0, "symv_packed": 0.0, "admm_fused": 0.0}
    for name, M in (("walking KKT", M_real), ("scaled random SPD", scaled_spd(4, 504, gen))):
        errs["spd_inverse"] = max(errs["spd_inverse"], check_spd_inverse(name, M))
    for n in K3_SIZES:  # the tiled kernel's masked edge
        for B in (1, 8):
            errs["spd_inverse"] = max(errs["spd_inverse"], check_spd_inverse(f"ragged n={n}", scaled_spd(B, n, gen)))

    # K4 on random SPD matrices over K4_SHAPES, then on the main path's
    # operand: the packed inverse of real KKT matrices
    cases = []
    for B, nb in K4_SHAPES:
        n = nb * K4.BLK
        P = torch.randn(B, n, n, device=dev, generator=gen)
        cases.append((f"random SPD B={B} nb={nb}", K4.pack_symmetric(P @ P.transpose(1, 2) / n),
                      torch.randn(B, n, device=dev, generator=gen)))
        del P
    Minv = K3.spd_inverse(M_real)
    pk_real = K4.pack_symmetric(torch.nn.functional.pad(Minv, (0, 8, 0, 8)))
    v_real = torch.nn.functional.pad(torch.randn(4, 504, device=dev, generator=gen), (0, 8))
    cases.append(("KKT inverse B=4 nb=4", pk_real, v_real))
    for name, packed, v in cases:
        out = K4.symv_packed(packed, v)
        again = K4.symv_packed(packed, v)
        torch.cuda.synchronize()
        ref = K4.symv_packed_ref(packed, v)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok, same = bool(torch.allclose(out, ref, rtol=SYMV_RTOL, atol=SYMV_ATOL)), bool(torch.equal(out, again))
        errs["symv_packed"] = max(errs["symv_packed"], err)
        print(f"phase 2 K4 symv_packed {name} {list(packed.shape)}: max|out-ref| {err:.3e}, allclose(rtol {SYMV_RTOL}, atol {SYMV_ATOL}) {ok}, two launches bitwise equal {same}")
        require(ok, f"K4 disagrees with its twin on {name}")
        require(same, f"K4 gives two results on the same inputs ({name})")
    del cases

    # real walking QPs at B = 512: pushes in linspace(-1, 1), start times over 8 ticks of the gait
    B512 = 512
    M512, qp512 = cold_linearisation(
        cfg_dense,
        params_at(cfg_dense, BENCH.lateral_pushes(B512),
                  BENCH.T0 + cfg_dense.dt * (torch.arange(B512) % 8).float()),
    )
    Minv512 = K3.spd_inverse(M512)
    items = torch.arange(0, B512, B512 // 8, device=dev)
    r512 = resid(M512[items], Minv512[items])
    print(f"phase 2 K3 spd_inverse walking KKT [512, 504, 504], items {items.tolist()}: ||I-MX||_inf {r512:.3e}")
    require(r512 < RESID_TOL, f"K3 residual {r512} >= {RESID_TOL} on the B = 512 walking KKT matrices")
    k5_args = {4: (Minv, *qp4), B512: (Minv512, *qp512)}
    # a dense random A takes the kernel's dense branch. At n = 504, m = 1,304
    # its bf16 modes are chaotic by the input's own measure (the twin with f32
    # sums against the twin with f64 sums, printed by chaos_witness), so those
    # modes are held to ADMM_TOL at n = 40, m = 56 and the production size in f32
    dense_big = qp_around(torch.randn(4, 1304, 504, device=dev, generator=gen) / 504**0.5, gen)
    k5_long = {}  # walking QPs at B = 4 of the horizons that take the other launches
    for T in K5_HORIZONS:
        cfg_T = ergocub_mpc_config(kkt_impl="dense", horizon=round(T * cfg_dense.dt, 6))
        M_T, qp_T = cold_linearisation(cfg_T, BENCH.make_params(cfg_T, lateral([-1.0, 0.0, 0.6, 1.2])))
        k5_long[T] = (torch.linalg.inv(M_T.double()).float().contiguous(), *qp_T)
        del M_T
    k5_cases = [("walking QPs", k5_args[4], tuple(ADMM_TOL)), ("walking QPs", k5_args[B512], tuple(ADMM_TOL)),
                ("dense random A n=504 m=1304", dense_big, ("f32",)),
                ("dense random A n=40 m=56", qp_around(torch.randn(4, 56, 40, device=dev, generator=gen) / 40**0.5,
                                                       gen), tuple(ADMM_TOL)),
                ("ragged n=37 m=50", qp_around(sparse_constraints(gen), gen), tuple(ADMM_TOL))]
    for name, args, modes in k5_cases:
        errs["admm_fused"] = max(errs["admm_fused"], check_admm_fused(name, args, modes))
    chaos_witness("dense random A n=504 m=1304 B=4", dense_big)
    for T, args in k5_long.items():  # the other launches, on a sparse random A at their sizes
        n, m = args[0].shape[1], args[1].shape[1]
        sparse = qp_around(sparse_constraints(gen, n=n, m=m), gen)
        name = f"sparse random A n={n} m={m}"
        errs["admm_fused"] = max(errs["admm_fused"], check_admm_fused(name, sparse, ("f32",)))
        check_admm_fused(name, sparse, ("bf16", "bf16x2"), iters=K5_SHORT_ITERS)
        chaos_witness(f"walking QPs T={T} B=4", args, modes=tuple(ADMM_TOL))
    del k5_cases, dense_big

    # --- 3. dense main path: K3 + K4 ----------------------------------------
    dense = CentroidalMPCSolver(cfg_dense)
    dense_ticks, dense_costs, l_dense = main_path("phase 3 dense", dense, cfg_dense)
    require(l_dense["spd_inverse"] > 0 and l_dense["symv_packed"] > 0 and l_dense["admm_fused"] == 0,
            f"dense path launches {l_dense}")

    # --- 4. fused main path: K3 + K5 ----------------------------------------
    fused = CentroidalMPCSolver(cfg_fused)
    fused_ticks, fused_costs, l_fused = main_path("phase 4 fused", fused, cfg_fused)
    n_solves = 11 + 1 + 4
    require(l_fused["admm_fused"] == cfg_fused.sqp_iters * n_solves and l_fused["spd_inverse"] > 0
            and l_fused["symv_packed"] == 0, f"fused path launches {l_fused}, expected admm_fused "
            f"{cfg_fused.sqp_iters} x {n_solves} solves")

    # --- 5. default main path: Riccati, plain PyTorch ------------------------
    ric = CentroidalMPCSolver(cfg_ric)
    ric_ticks, ric_costs, _ = main_path("phase 5 riccati", ric, cfg_ric)

    # --- 6. numerics sentinel -----------------------------------------------
    pushes = [0.0, -1.0, 1.0, 1.2]
    p_gpu = BENCH.make_params(cfg_dense, lateral(pushes))
    s_dense = dense.solve(p_gpu, dense.cold_start(4))
    s_fused = fused.solve(p_gpu, fused.cold_start(4))
    s_ric = ric.solve(p_gpu, ric.cold_start(4))
    p_cpu = BENCH.make_params(cfg_dense, lateral(pushes, device="cpu"), device="cpu")
    s_cpu = dense.solve(p_cpu, dense.cold_start(4, device="cpu"))
    for name, a, b in (("dense gpu vs dense cpu", s_dense, s_cpu), ("riccati gpu vs dense gpu", s_ric, s_dense),
                       ("fused gpu vs dense gpu", s_fused, s_dense), ("fused gpu vs riccati gpu", s_fused, s_ric)):
        ca, cb = a.cost.cpu(), b.cost.cpu()
        dc = (ca - cb).abs()
        good = bool((dc <= 0.005 * (cb.abs() + 1.0)).all()) and float(a.prim_res.max()) < 1e-2
        print(f"phase 6 sentinel {name}: costs {ca.tolist()} vs {cb.tolist()}, max|dcost| {float(dc.max()):.3e}, "
              f"prim {float(a.prim_res.max()):.2e}: {'ok' if good else 'FAIL'}")
        require(good, f"numerics sentinel failed: {name}")
    # the same chains on the three paths land on the same costs
    for name, a, b in (("riccati vs dense", ric_costs, dense_costs), ("fused vs dense", fused_costs, dense_costs),
                       ("fused vs riccati", fused_costs, ric_costs)):
        dc = (a - b).abs()
        print(f"phase 6 bench chain {name}: max|dcost| {float(dc.max()):.3e} (max |cost| {float(b.abs().max()):.2f})")
        require(bool((dc <= 0.005 * (b.abs() + 1.0)).all()), f"bench chain: {name} disagree")
    for name, a, b in (("fused vs dense", fused_ticks, dense_ticks), ("riccati vs dense", ric_ticks, dense_ticks)):
        dc = max(abs(float(x.cost) - float(y.cost)) / (abs(float(y.cost)) + 1.0) for x, y in zip(a, b))
        print(f"phase 6 B=1 tick chain {name}: max |dcost| / (|cost| + 1) {dc:.3e}")
        require(dc <= 0.005, f"B=1 tick chain: {name} disagree")
    # P2: does K4 carry the dense chain's distance from the other two paths?
    # The same chain with the batched-matmul x-update (xupdate_impl="dense", no K4).
    cfg_mm = ergocub_mpc_config(kkt_impl="dense", xupdate_impl="dense")
    mm_costs, _, _ = bench_chain(CentroidalMPCSolver(cfg_mm), cfg_mm)
    for name, b in (("dense (K4)", dense_costs), ("riccati", ric_costs), ("fused", fused_costs)):
        dc = (mm_costs - b).abs()
        print(f"phase 6 P2 bench chain dense (matmul x-update) vs {name}: max|dcost| {float(dc.max()):.3e} "
              f"(at item {int(dc.amax(0).argmax())})")
        require(bool((dc <= 0.005 * (b.abs() + 1.0)).all()), f"bench chain: dense (matmul) vs {name} disagree")

    print(f"phases 1-6 took {time.perf_counter() - t_start:.1f} s")
    t_phase = time.perf_counter()

    # --- 7. timings (not asserted) ------------------------------------------
    times, bounds = {}, {}
    for B in (1, B512):
        Mb = M_real[:1].expand(B, 504, 504).contiguous()
        pb = pk_real[:1].expand(B, 10, 128, 128).contiguous()
        vb = v_real[:1].expand(B, 512).contiguous()
        dense_b = K4.unpack_symmetric(pb)
        ab = tuple(a[:B].contiguous() for a in k5_args[B512])
        times[("spd_inverse", B)] = (cuda_ms(lambda: K3.spd_inverse(Mb), 5), cuda_ms(lambda: K3.spd_inverse_ref(Mb), 5),
                                     cuda_ms(lambda: torch.linalg.inv(Mb), 5))
        times[("symv_packed", B)] = (cuda_ms(lambda: K4.symv_packed(pb, vb), 50),
                                     cuda_ms(lambda: K4.symv_packed_ref(pb, vb), 50),
                                     cuda_ms(lambda: torch.matmul(dense_b, vb[..., None]), 50))
        reps = 20 if B == 1 else 5
        times[("admm_fused", B)] = (cuda_ms(lambda: K5.admm_fused(*ab, iters=ADMM_ITERS), reps),
                                    cuda_ms(lambda: K5.admm_fused_ref(*ab, iters=ADMM_ITERS), reps), None)
        bounds[("spd_inverse", B)] = bound_spd_inverse(Mb)
        bounds[("symv_packed", B)] = bound_symv(pb, vb)
        bounds[("admm_fused", B)] = bound_admm_fused(ab, ADMM_ITERS)
    for (name, B), (ms, plain, lib) in times.items():
        b_ms, b_by, t_bytes, t_ops = bounds[(name, B)]
        lib_s = "none" if lib is None else f"{lib:.4f} ms"
        rate = f", {b_ms * R.HBM_BYTES_PER_S / ms / 1e9:.1f} GB/s on the bound's bytes" if b_by == "bytes" else ""
        print(f"phase 7 time {name} B={B}: kernel {ms:.4f} ms, plain twin {plain:.4f} ms, library {lib_s}, "
              f"bound {b_ms:.4f} ms ({b_by}; bytes {t_bytes:.4f} ms, operations {t_ops:.4f} ms), kernel at "
              f"{100 * b_ms / ms:.1f} % of the bound{rate} {tag}")
    # K5's launch at each horizon, and its time at the longer ones (B = 512
    # only where its inputs take a few GB: the last reads a dense A of 22 MB
    # per scenario)
    for T, args in [(cfg_dense.T, k5_args[B512])] + list(k5_long.items()):
        n, m = args[0].shape[1], args[1].shape[1]
        print(f"phase 7 admm_fused T={T} n={n} m={m}: {K5.plan(n, m)}, {K5.active_clusters(n, m)} clusters at once "
              f"(cudaOccupancyMaxActiveClusters) {tag}")
        if T == cfg_dense.T:
            continue  # timed above
        for B in (1,) if T == K5_HORIZONS[-1] else (1, B512):
            ab = tuple(a[:1].expand(B, *a.shape[1:]).contiguous() for a in args)
            reps = 20 if B == 1 else 5
            ms = cuda_ms(lambda: K5.admm_fused(*ab, iters=ADMM_ITERS), reps)
            plain = cuda_ms(lambda: K5.admm_fused_ref(*ab, iters=ADMM_ITERS), reps)
            b_ms, b_by, t_bytes, t_ops = bound_admm_fused(ab, ADMM_ITERS)
            print(f"phase 7 time admm_fused T={T} B={B}: kernel {ms:.4f} ms, plain twin {plain:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}; bytes {t_bytes:.4f} ms, operations {t_ops:.4f} ms), kernel at "
                  f"{100 * b_ms / ms:.1f} % of the bound {tag}")
            del ab
    for B in (1, B512):  # where K3's, K4's and K5's time goes, kernel by kernel
        Mb = M_real[:1].expand(B, 504, 504).contiguous()
        pb = pk_real[:1].expand(B, 10, 128, 128).contiguous()
        vb = v_real[:1].expand(B, 512).contiguous()
        ab = tuple(a[:B].contiguous() for a in k5_args[B512])
        for name, fn, kernel_stages in (("spd_inverse", lambda: K3.spd_inverse(Mb), K3_STAGES),
                                        ("symv_packed", lambda: K4.symv_packed(pb, vb), K4_STAGES),
                                        ("admm_fused", lambda: K5.admm_fused(*ab, iters=ADMM_ITERS), K5_STAGES)):
            stages = profile_stages(fn, kernel_stages)
            if stages is None:
                print(f"phase 7 profile {name} B={B}: {NOT_PROFILED} {tag}")
                continue
            total = sum(ms for _, ms in stages.values())
            for stage, (count, ms) in stages.items():
                print(f"phase 7 profile {name} B={B} {stage}: {count} launches, {ms:.4f} ms device "
                      f"({100 * ms / total:.1f} %) {tag}")
        # the library call's device time beside K4's: at B = 1 both calls are set by the host
        dense_b = K4.unpack_symmetric(pb)
        for _ in range(PROFILE_PASSES):
            mm = profile(lambda: torch.matmul(dense_b, vb[..., None]))
            if mm:
                break
        print(f"phase 7 profile torch.matmul on the unpacked matrix B={B}: " + (
            f"{sum(c for _, c, _ in mm)} launches ({', '.join(key[:60] for key, _, _ in mm)}), "
            f"{sum(ms for _, _, ms in mm):.4f} ms device" if mm else NOT_PROFILED) + f" {tag}")
    # the B = 512 x KB = 4 chains' rates are phase 13's (apps.bench_kkt)
    for name, solver, cfg in (("dense", dense, cfg_dense), ("fused", fused, cfg_fused), ("riccati", ric, cfg_ric)):
        _, t1 = tick_chain(solver, cfg, ticks=WARM_TICKS)
        lat = np.array(t1[1:])  # warm-started ticks
        print(f"phase 7 time {name} B=1 warm tick: p50 {np.percentile(lat, 50):.2f} ms, "
              f"p90 {np.percentile(lat, 90):.2f} ms, max {lat.max():.2f} ms ({len(lat)} ticks) {tag}")
        if name == "fused":  # its device time per warm solve against the wall of a warm solve
            for B in (1, B512):
                params = BENCH.make_params(cfg, BENCH.lateral_pushes(B) if B > 1 else lateral([0.0]))
                warm = solver.warm_from(params, solver.solve(params, solver.cold_start(B)))
                torch.cuda.synchronize()
                t = time.perf_counter()
                solver.solve(params, warm)
                torch.cuda.synchronize()
                wall = float(np.percentile(lat, 50)) if B == 1 else (time.perf_counter() - t) * 1e3
                d = device_time(lambda: solver.solve(params, warm))
                if d is None:
                    print(f"phase 7 profile fused solve B={B}: {NOT_PROFILED} {tag}")
                    continue
                dev_ms, count, (key, top) = d
                print(f"phase 7 profile fused solve B={B}: device {dev_ms:.3f} ms in {count} kernels, copies and "
                      f"fills; wall {wall:.2f} ms (unprofiled, {'the p50 above' if B == 1 else 'one warm solve'}), "
                      f"idle share {1 - dev_ms / wall:.3f}; largest {key[:70]} {top:.3f} ms {tag}")

    print(f"phase 7 took {time.perf_counter() - t_phase:.1f} s")

    # --- 8. joystick -> MANN -> MPC ----------------------------------------
    t_phase = time.perf_counter()
    l_mann, mann_weights = phase_mann_mpc(tag)
    print(f"phase 8 took {time.perf_counter() - t_phase:.1f} s")

    # --- 9. the closed loop -------------------------------------------------
    l_closed = phase_closed_loop(tag, mann_weights)

    # --- 10. the closed loop on the rigid-body plant -------------------------
    l_rigid = phase_rigid_loop(tag)

    # --- 11. the push-recovery sweep and the walk through their CLIs ---------
    l_sweep = phase_sweep(tag)

    # --- 12. the remaining entry points ---------------------------------------
    l_rest = phase_remaining(tag, cfg_dense)

    # --- 13. the benchmark entry points ---------------------------------------
    l_bench = phase_benchmarks(tag)
    print(f"phases 1-13 took {time.perf_counter() - t_start:.1f} s")

    sources = {"spd_inverse": ("cmw_tpu_torch/csrc/spd_inverse.cu", "cmw_tpu/ops/spd_inverse.py:132"),
               "symv_packed": ("cmw_tpu_torch/csrc/symv.cu", "cmw_tpu/ops/symv.py:77"),
               "admm_fused": ("cmw_tpu_torch/csrc/admm_fused.cu", "cmw_tpu/ops/admm_fused.py:143")}
    record = {"kernels": []}
    for name, (source, replaces) in sources.items():
        ms, plain, lib = times[(name, B512)]
        b_ms, b_by, _, _ = bounds[(name, B512)]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": (l_dense[name] + l_fused[name] + l_mann[name] + l_closed[name] + l_rigid[name] + l_sweep[name]
                         + l_rest[name] + l_bench[name]),
            "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        })
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

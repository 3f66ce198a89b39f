#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`cmw_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives `CentroidalMPCSolver.solve` of the port at the production
configuration (ergocub_mpc_config(): T = 20, 504 variables, 1,304 constraint
rows, sqp 2 x admm 24) on the card, through the same entry points a user
calls, and checks it:

  1. the card's name and power limit; the kernels' build from csrc/*.cu;
  2. each hand-written kernel against its plain PyTorch twin on the card:
     the SPD inverse (||I - M X||_inf < 1e-4 on real walking KKT matrices
     and on a badly scaled random SPD matrix) and the packed symv
     (rtol 2e-5 / atol 1e-4);
  3. the dense-KKT main path (the kernels): a cold solve and 10 warm-started
     receding-horizon ticks at B = 1, the lateral-push footstep check, then
     the bench shape (B = 512 pushes, KB = 4 warm-started solves); both
     kernels' launch counts must rise during this phase;
  4. the default Riccati main path (plain PyTorch), the same chains;
  5. numerics sentinel: the card's dense solve vs the port's plain CPU solve,
     and the card's Riccati solve vs its dense solve, each within
     |dcost| <= 0.005 (|cost| + 1) and prim_res < 1e-2;
  6. timings (printed, not asserted).

It imports nothing of JAX. Without a CUDA device it fails. The last two
lines are the kernels' JSON record and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from cmw_tpu_torch.cmpc import CentroidalMPCSolver, MPCParams, ergocub_mpc_config
from cmw_tpu_torch.cmpc import formulation as F
from cmw_tpu_torch.core import contacts
from cmw_tpu_torch.ops import _build
from cmw_tpu_torch.ops import spd_inverse as K3
from cmw_tpu_torch.ops import symv as K4

T0 = 1.02  # left foot swinging: its next footstep is adjustable
RESID_TOL = 1e-4  # ||I - M X||_inf, the inverse's done-check
SYMV_RTOL, SYMV_ATOL = 2e-5, 1e-4  # f32 sums in another order (tests/test_ops.py:138)


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def make_params(cfg, pushes, t0=T0, x0=None, device="cuda"):
    """Bench-shaped walking parameters, one item per push row [B, 3]."""
    B = pushes.shape[0]
    plan = contacts.snap_to_grid(contacts.make_alternating_gait(n_steps=8, device=device), cfg.dt)
    stage = contacts.mpc_stage_params(plan, t0, cfg.T, cfg.dt, cfg.n_slots)
    stage = type(stage)(*[a.expand((B,) + a.shape).contiguous() for a in stage])
    N = cfg.N
    j = torch.arange(N, device=device, dtype=torch.float32)[:, None]
    com_ref = torch.tensor([0.0, 0.0, 0.7], device=device) + 0.08 * (cfg.dt * j + (t0 - T0)) * torch.tensor(
        [1.0, 0.0, 0.0], device=device
    )
    if x0 is None:
        x0 = torch.tensor([0.0, 0.0, 0.7, 0, 0, 0, 0, 0, 0], device=device).expand(B, 9)
    return MPCParams(
        x0=x0.contiguous(),
        com_ref=com_ref.expand(B, N, 3).contiguous(),
        ang_mom_ref=torch.zeros(B, N, 3, device=device),
        stage=stage,
        ext_force=pushes.to(device),
        ext_torque=torch.zeros(B, 3, device=device),
    )


def lateral(values, device="cuda"):
    v = torch.as_tensor(values, dtype=torch.float32, device=device)
    return torch.stack([torch.zeros_like(v), v, torch.zeros_like(v)], dim=-1)


def kkt_matrix(cfg, params):
    """The KKT matrix H0 + sigma I + A^T rho A that the dense solve builds at
    its cold-start point."""
    solver = CentroidalMPCSolver(cfg)
    B = params.x0.shape[0]
    z0 = solver._initial_z(params, solver.cold_start(B, device=params.x0.device))
    J = torch.func.vmap(torch.func.jacfwd(lambda p, z: F.residuals(cfg, p, z), argnums=1))(params, z0)
    _, _, rho = F.constraint_bounds(cfg, params.stage)
    eye = torch.eye(cfg.n_vars, device=z0.device)
    M = J.transpose(-1, -2) @ J + cfg.levenberg * eye + cfg.admm_sigma * eye + F.ata_blockdiag(cfg, params.stage, rho)
    return M.contiguous()


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


def tick_chain(solver, cfg, ticks, push=0.0):
    """B = 1: a cold solve, then `ticks` warm-started receding-horizon ticks
    (t0 advances by dt, x0 is the previous solve's predicted next state).
    Returns the solutions and the per-solve wall times in ms."""
    params = make_params(cfg, lateral([push]))
    warm = solver.cold_start(1, device="cuda")
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
        nxt = make_params(cfg, lateral([push]), t0=T0 + (k + 1) * cfg.dt, x0=sol.states[:, 1])
        warm = solver.warm_from(nxt, sol)
        params = nxt
    return sols, times


def bench_chain(solver, cfg, B=512, KB=4):
    """bench.py's shape: B lateral pushes in linspace(-1, 1), KB warm-started
    solves of the same parameters. Returns (costs [KB, B], prim [KB, B], s)."""
    params = make_params(cfg, lateral(torch.linspace(-1.0, 1.0, B)))
    warm = solver.cold_start(B, device="cuda")
    costs, prims = [], []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(KB):
        sol = solver.solve(params, warm)
        warm = solver.warm_from(params, sol)
        costs.append(sol.cost)
        prims.append(sol.prim_res)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    costs, prims = torch.stack(costs), torch.stack(prims)
    require(bool(torch.isfinite(costs).all()), "bench chain: non-finite cost")
    require(float(prims.max()) < 1e-2, f"bench chain: prim_res {float(prims.max())}")
    return costs, prims, seconds


def push_saturates_box(solver, cfg):
    """ext_force [0, 1.2, 0] moves the left foot's next step to the +y edge of
    its box (dy = bbox_upper[0][1] = 0.05) and stays inside every box."""
    params = make_params(cfg, lateral([1.2]))
    sol = solver.solve(params, solver.cold_start(1, device="cuda"))
    stage = params.stage
    adj = (stage.slot_adjustable * stage.slot_valid)[..., None]
    d = ((sol.positions - stage.slot_pos_nom) * adj)[0].cpu()
    bl = torch.tensor(cfg.bbox_lower)[:, None, :]
    bu = torch.tensor(cfg.bbox_upper)[:, None, :]
    dy = float(d[0, :, 1].max())
    require(abs(dy - cfg.bbox_upper[0][1]) < 1e-3, f"push: left-foot dy {dy}, expected the box edge")
    require(bool(((d <= bu + 1e-4) & (d >= bl - 1e-4)).all()), "push: footstep outside its box")
    return dy


def main():
    require(torch.cuda.is_available(), "no CUDA device: this smoke run needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; tf32 matmul {torch.backends.cuda.matmul.allow_tf32}")
    tag = f"[{card}]"
    dev = "cuda"
    cfg_dense = ergocub_mpc_config(kkt_impl="dense")
    cfg_ric = ergocub_mpc_config()

    # --- 1. build ------------------------------------------------------------
    t = time.perf_counter()
    _build.library()
    print(f"phase 1 build: {len(_build.sources())} sources, nvcc {_build.build_seconds:.2f} s, "
          f"load {time.perf_counter() - t:.2f} s")

    # --- 2. kernels vs plain twins on the card ------------------------------
    M_real = kkt_matrix(cfg_dense, make_params(cfg_dense, lateral([-1.0, 0.0, 0.6, 1.2])))
    rng = np.random.default_rng(0)
    A = rng.normal(size=(4, 504, 504)).astype(np.float32) * 0.02
    H = np.einsum("bij,bkj->bik", A, A) + np.eye(504, dtype=np.float32)
    H[:, :50, :50] += 1e4 * np.eye(50, dtype=np.float32)  # rho_eq-like scale spread
    M_rand = torch.tensor(H, device=dev)
    k3_err = 0.0
    for name, M in (("walking KKT", M_real), ("scaled random SPD", M_rand)):
        X = K3.spd_inverse(M)
        torch.cuda.synchronize()
        Xr = K3.spd_inverse_ref(M)
        torch.cuda.synchronize()
        rk, rr = resid(M, X), resid(M, Xr)
        err = float((X - Xr).abs().max())
        rel = err / float(Xr.abs().max())
        print(f"phase 2 K3 spd_inverse {name} [4, 504, 504]: ||I-MX||_inf kernel {rk:.3e} twin {rr:.3e}; "
              f"max|X-Xref| {err:.3e} (rel {rel:.3e})")
        require(rk < RESID_TOL, f"K3 residual {rk} >= {RESID_TOL} on {name}")
        k3_err = max(k3_err, err)

    gen = torch.Generator(device=dev).manual_seed(7)
    P = torch.randn(512, 512, 512, device=dev, generator=gen)
    Msym = P @ P.transpose(1, 2) / 512
    packed = K4.pack_symmetric(Msym)
    v = torch.randn(512, 512, device=dev, generator=gen)
    out = K4.symv_packed(packed, v)
    torch.cuda.synchronize()
    ref = K4.symv_packed_ref(packed, v)
    torch.cuda.synchronize()
    k4_err = float((out - ref).abs().max())
    ok = torch.allclose(out, ref, rtol=SYMV_RTOL, atol=SYMV_ATOL)
    # the main path's operand: the packed inverse of real KKT matrices
    Minv = K3.spd_inverse(M_real)
    pk_real = K4.pack_symmetric(torch.nn.functional.pad(Minv, (0, 8, 0, 8)))
    v_real = torch.nn.functional.pad(torch.randn(4, 504, device=dev, generator=gen), (0, 8))
    out_real = K4.symv_packed(pk_real, v_real)
    torch.cuda.synchronize()
    ref_real = K4.symv_packed_ref(pk_real, v_real)
    ok_real = torch.allclose(out_real, ref_real, rtol=SYMV_RTOL, atol=SYMV_ATOL)
    k4_err = max(k4_err, float((out_real - ref_real).abs().max()))
    print(f"phase 2 K4 symv_packed [512, 10, 128, 128] random SPD and [4, 10, 128, 128] KKT inverse: "
          f"max|out-ref| {k4_err:.3e}, allclose(rtol {SYMV_RTOL}, atol {SYMV_ATOL}) {ok} / {ok_real}")
    require(ok and ok_real, "K4 disagrees with its twin")

    # --- 3. dense main path: the kernels ------------------------------------
    dense = CentroidalMPCSolver(cfg_dense)
    K3.launches = 0
    K4.launches = 0
    dense_ticks, dense_t1 = tick_chain(dense, cfg_dense, ticks=10)
    dy = push_saturates_box(dense, cfg_dense)
    dense_costs, dense_prims, dense_s = bench_chain(dense, cfg_dense)
    launches = {"spd_inverse": K3.launches, "symv_packed": K4.launches}
    print(f"phase 3 dense main path: 11 B=1 solves (last cost {float(dense_ticks[-1].cost):.4f}, "
          f"max prim {max(float(s.prim_res) for s in dense_ticks):.2e}), push dy {dy:.5f}, "
          f"B=512 x KB=4 (max prim {float(dense_prims.max()):.2e}); launches {launches}")
    require(all(n > 0 for n in launches.values()), f"a kernel of the dense path never launched: {launches}")

    # --- 4. default main path: Riccati, plain PyTorch ------------------------
    ric = CentroidalMPCSolver(cfg_ric)
    ric_ticks, ric_t1 = tick_chain(ric, cfg_ric, ticks=10)
    push_saturates_box(ric, cfg_ric)
    ric_costs, ric_prims, ric_s = bench_chain(ric, cfg_ric)
    print(f"phase 4 riccati main path: 11 B=1 solves (last cost {float(ric_ticks[-1].cost):.4f}), "
          f"B=512 x KB=4 (max prim {float(ric_prims.max()):.2e})")

    # --- 5. numerics sentinel -----------------------------------------------
    pushes = [0.0, -1.0, 1.0, 1.2]
    p_gpu = make_params(cfg_dense, lateral(pushes))
    s_dense = dense.solve(p_gpu, dense.cold_start(4, device=dev))
    s_ric = ric.solve(p_gpu, ric.cold_start(4, device=dev))
    p_cpu = make_params(cfg_dense, lateral(pushes, device="cpu"), device="cpu")
    s_cpu = dense.solve(p_cpu, dense.cold_start(4))
    for name, a, b in (("dense gpu vs dense cpu", s_dense, s_cpu), ("riccati gpu vs dense gpu", s_ric, s_dense)):
        ca, cb = a.cost.cpu(), b.cost.cpu()
        dc = (ca - cb).abs()
        good = bool((dc <= 0.005 * (cb.abs() + 1.0)).all()) and float(a.prim_res.max()) < 1e-2
        print(f"phase 5 sentinel {name}: costs {ca.tolist()} vs {cb.tolist()}, max|dcost| {float(dc.max()):.3e}, "
              f"prim {float(a.prim_res.max()):.2e}: {'ok' if good else 'FAIL'}")
        require(good, f"numerics sentinel failed: {name}")
    # the same B=512 x KB=4 chain on both branches lands on the same costs
    dc = (ric_costs - dense_costs).abs()
    print(f"phase 5 bench chain riccati vs dense: max|dcost| {float(dc.max()):.3e} "
          f"(max |cost| {float(dense_costs.abs().max()):.2f})")
    require(bool((dc <= 0.005 * (dense_costs.abs() + 1.0)).all()), "bench chain: branches disagree")

    # --- 6. timings (not asserted) ------------------------------------------
    times = {}
    for B in (1, 512):
        Mb = M_real[:1].expand(B, 504, 504).contiguous()
        pb = pk_real[:1].expand(B, 10, 128, 128).contiguous()
        vb = v_real[:1].expand(B, 512).contiguous()
        times[("spd_inverse", B)] = (cuda_ms(lambda: K3.spd_inverse(Mb), 5), cuda_ms(lambda: K3.spd_inverse_ref(Mb), 5))
        times[("symv_packed", B)] = (cuda_ms(lambda: K4.symv_packed(pb, vb), 50),
                                     cuda_ms(lambda: K4.symv_packed_ref(pb, vb), 50))
    for (name, B), (ms, plain) in times.items():
        print(f"phase 6 time {name} B={B}: kernel {ms:.4f} ms, plain twin {plain:.4f} ms {tag}")
    for name, solver, cfg in (("dense", dense, cfg_dense), ("riccati", ric, cfg_ric)):
        _, t1 = tick_chain(solver, cfg, ticks=30)
        lat = np.array(t1[1:])  # warm-started ticks
        _, _, s = bench_chain(solver, cfg)
        print(f"phase 6 time {name} B=1 warm tick: p50 {np.percentile(lat, 50):.2f} ms, "
              f"p90 {np.percentile(lat, 90):.2f} ms, max {lat.max():.2f} ms ({len(lat)} ticks) {tag}")
        print(f"phase 6 time {name} B=512 x KB=4: {s:.3f} s, {512 * 4 / s:.1f} solves/s {tag}")

    record = {"kernels": [
        {"name": "spd_inverse", "route": "cuda", "source": "cmw_tpu_torch/csrc/spd_inverse.cu",
         "replaces": "cmw_tpu/ops/spd_inverse.py:132", "launches": launches["spd_inverse"],
         "max_abs_err": k3_err, "ms": times[("spd_inverse", 512)][0], "plain_ms": times[("spd_inverse", 512)][1]},
        {"name": "symv_packed", "route": "cuda", "source": "cmw_tpu_torch/csrc/symv.cu",
         "replaces": "cmw_tpu/ops/symv.py:77", "launches": launches["symv_packed"],
         "max_abs_err": k4_err, "ms": times[("symv_packed", 512)][0], "plain_ms": times[("symv_packed", 512)][1]},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

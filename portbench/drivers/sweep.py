"""Driver `sweep`: a push-recovery sweep's chunk, one MPC period at a time.

The entry is `WalkingController.run_episode_fold` with the sweep's fold
(`cmw_tpu_torch.dist.sweep.fold`), called on one MPC period of inputs at a
time: on the card one replay of the fold period's CUDA graph a period, each
ended by a read of the scenarios' finiteness. Episodes of `episode_s` run
back to back, each from the settled start built in set-up. Traffic
(`traffic/<name>.json`): `batch` scenarios on the `plant`, joystick forward
at `vx`; each episode's pushes from the seed: the even items pushed along
x, the odd along y, |push| ~ U(0, push_max) m/s^2 with a random sign, for
`push_duration` s from `push_t0` s. Survival is a result, not a failure.

Set-up builds the controller, its settled start and one period (which
captures the period's graph). End to end: scenario_s_per_s, batch x the
simulated seconds of the periods completed in the window over the window.

Compared, from the program's own state (the loop is chaotic): `sample`
periods drawn from the seed over the window, each period's next state and
folded accumulator against the reference's `_period` from the program's
state before it (period_gap, the largest `common.leaf_gap`), and the
survival verdicts and other integer and bool elements (flags_differ). The
start (the rigid settle) is not worked out again in each run: eagerly it
takes ~40 s.
"""

from __future__ import annotations

import math
import time
import traceback

import numpy as np
import torch

from portbench import common, trace, weights
from portbench.controller import Controller

TRACE_PERIODS = 1  # periods in the profiled sub-window (~311k kernels each on the rigid plant)
# survival thresholds of the sweep (cmw_tpu_torch/dist/sweep.py, frozen here)
SUPP_DEV_MAX, Z_DEV_MAX, TRACK_ERR_MAX, UP_MIN, BASE_Z_FRAC_MIN = 0.4, 0.25, 0.15, 0.9, 0.75


def episode_inputs(sut: Controller, cell, episode: int, device):
    """TickInput [B, S, ...] of one episode from the seed."""
    tr, cfg = cell.traffic, sut.cfg
    B = tr["batch"]
    S = int(round(tr["episode_s"] / cfg.wbc_dt))
    S -= S % cfg.mpc_every
    rng = np.random.default_rng([cell.seed, 3, episode])
    mags = rng.uniform(0.0, tr["push_max"], B) * rng.choice([-1.0, 1.0], B)
    even = np.arange(B) % 2 == 0
    dirs = np.stack([even, ~even, np.zeros(B, bool)], axis=-1).astype(np.float64)
    win = np.zeros(S)
    win[int(tr["push_t0"] / cfg.wbc_dt):int((tr["push_t0"] + tr["push_duration"]) / cfg.wbc_dt)] = 1.0
    push = torch.as_tensor(win[None, :, None] * (mags[:, None] * dirs)[:, None, :], dtype=torch.float32,
                           device=device)
    joy = torch.tensor([tr["vx"], 0.0, 1.0, 0.0], dtype=torch.float32, device=device).expand(B, S, 4)
    return sut.tick_input(joy, push, torch.zeros_like(push))


def acc0(s0):
    """The fold's start: (supp_dev, z_dev, track_err, finite, up_min, bz_min, z0) [B]."""
    z0 = s0.x9[:, 2]
    zeros = torch.zeros_like(z0)
    return (zeros, zeros, zeros, torch.ones_like(z0, dtype=torch.bool), torch.ones_like(z0),
            torch.full_like(z0, 10.0), z0)


def survived(acc, zb0, rigid: bool):
    """The sweep's verdict [B] bool from a folded accumulator."""
    supp, dz, trk, fin, up, bz, _ = acc
    if rigid:
        return fin & (up > UP_MIN) & (bz > BASE_Z_FRAC_MIN * zb0) & (supp < SUPP_DEV_MAX) & (dz < Z_DEV_MAX)
    return fin & (supp < SUPP_DEV_MAX) & (dz < Z_DEV_MAX) & (trk < TRACK_ERR_MAX)


def _blocks(inputs, every: int):
    S = inputs.joypad.shape[1]
    return [type(inputs)(*(a[:, j:j + every] for a in inputs)) for j in range(0, S, every)]


def run(cell) -> dict:
    tr, dev, B = cell.traffic, cell.device, cell.traffic["batch"]
    rigid = tr["plant"] == "rigid"
    w = weights.synthetic(cell.seed, dev)
    if cell.control:
        from portbench.reference.sweep import fold
    else:
        from cmw_tpu_torch.dist.sweep import fold
    sut = Controller("reference" if cell.control else "program", cell.config, tr["plant"], w, dev, tf32=cell.control)
    every, dt = sut.cfg.mpc_every, sut.cfg.mpc.dt
    s0 = sut.initial_state(B)
    a0 = acc0(s0)
    zb0 = (s0.rb.base_pos if rigid else s0.base_pos)[:, 2]
    blocks = _blocks(episode_inputs(sut, cell, 0, dev), every)
    common.sync_read(sut.period_fold(s0, blocks[0], fold, a0)[1][3])  # captures the period's graph

    # --- the window ------------------------------------------------------------
    res = common.Reservoir(tr["sample"], cell.seed)
    periods, failed, episode, j, s, acc = 0, 0, 0, 0, s0, a0
    verdicts = []
    cell.note(f"card before the window: {common.nvidia_smi()}")
    t_first = time.perf_counter()
    while True:
        try:
            s1, acc1 = sut.period_fold(s, blocks[j], fold, acc)
            finite = common.sync_read(acc1[3])
        except Exception:  # a period that raises fails every scenario in it; nothing to go on from
            traceback.print_exc()
            failed += B
            periods += 1
            break
        t1 = time.perf_counter()
        failed += int((~finite).sum())
        res.offer(lambda s=s, b=blocks[j], acc=acc, s1=s1, acc1=acc1, e=episode, j=j: (s, b, acc, s1, acc1, e, j))
        periods += 1
        s, acc, j = s1, acc1, j + 1
        if j == len(blocks):  # the episode's end: its verdicts, then the next from the start
            verdicts.append(float(survived(acc, zb0, rigid).float().mean()))
            episode, j, s, acc = episode + 1, 0, s0, a0
            blocks = _blocks(episode_inputs(sut, cell, episode, dev), every)
        if t1 - t_first >= cell.seconds:
            break
    elapsed = time.perf_counter() - t_first
    cell.note(f"card after the window: {common.nvidia_smi()}")
    rate = B * periods * dt / elapsed
    out = {"attempted": B * periods, "failed": failed, "device": common.device_info(dev),
           "e2e": {"scenario_s_per_s": rate, "setup_s": t_first - cell.t_start}}
    cell.note(f"sweep: {periods} periods of B {B} in {elapsed:.4f} s ({1e3 * elapsed / periods:.3f} ms a period), "
              f"{rate:.4f} scenario-s/s; episodes completed {len(verdicts)}, survival {verdicts}; setup "
              f"{t_first - cell.t_start:.3f} s; failed {failed}")

    # --- the traced sub-window: whole periods ---------------------------------------
    if cell.trace and failed == 0:
        out["trace"] = {"capture_s": common.capture_seconds(cell)}
        if dev != "cpu":
            with trace.fenced_profile() as prof:
                for _ in range(TRACE_PERIODS):
                    s, acc = sut.period_fold(s, blocks[j % len(blocks)], fold, acc)
                    common.sync_read(acc[3])
                    j += 1
            sess = trace.Session(prof)
            if sess.whole:
                out["busy_s"], out["window_s"] = sess.busy_ns() / 1e9, sess.window_ns() / 1e9
                out["trace"].update(period_device_ms=1e3 * out["busy_s"] / TRACE_PERIODS)
                out["breakdown"] = sess.breakdown()
            cell.note(f"traced {TRACE_PERIODS} period(s): {len(sess.card)} device ops, whole {sess.whole}; "
                      f"{out['trace']}")

    # --- the comparison, once the program's state is freed -------------------
    sut.free()
    from portbench.reference.sweep import fold as ref_fold

    with common.reference_place(cell) as ref_dev:
        ref = Controller("reference", cell.config, tr["plant"], weights.moved(w, ref_dev), ref_dev)
        types = common.reference_types()
        gap, at, flags = (math.inf, "no period sampled", 0) if not res.items else (0.0, "", 0)
        for s_b, blk, acc_b, s_a, acc_a, e, k in res.items:
            r_s, r_acc = ref.period_eager(common.convert(s_b, types, ref_dev), common.convert(blk, types, ref_dev),
                                          ref_fold, common.convert(acc_b, types, ref_dev))
            for got, want in ((s_a, r_s), (tuple(acc_a), tuple(r_acc))):
                g, path, f = common.compare_trees(got, want)
                flags += f
                if not g <= gap:
                    gap, at = g, f"episode {e} period {k} {path}"
            verdict = survived(acc_a, zb0, rigid).to(ref_dev)
            flags += int((verdict != survived(r_acc, zb0.to(ref_dev), rigid)).sum())
    cell.note(f"compared at: period_gap {gap:.3e} ({at}); flags_differ {flags}")
    lim = tr["limits"]
    out["checks"] = [("period_gap", gap, lim["period_gap"]), ("flags_differ", flags, lim["flags_differ"])]
    return out

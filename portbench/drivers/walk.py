"""Driver `walk`: the walking controller, tick by tick, closed loop.

The entry is `WalkingController.step` (on the card the MPC stage's two
graphs and the WBC stage's graph, replayed), one robot (B = `batch`) on the
kinematic plant. Each tick starts when the last tick's joint command
(`Telemetry.q`) is on the host, which is what the robot's actuators wait
for; its wall runs from the call of `step` until then. A tick with
`tick % mpc_every == 0` is an MPC tick (the MPC stage and that tick's WBC
stage); every other tick is a WBC tick. Traffic (`traffic/<name>.json`): a
joystick held for U(hold_min_s, hold_max_s) of gait time, then a new one,
each from the seed: motion of magnitude U(motion_min, motion_max) (never
below the stand-mode threshold) in a heading U(-pi, pi), facing forward; no
push, no sensor noise.

Set-up builds the controller and its start (the polished walk-ready pose),
captures the MPC stage's graphs (the generator called and not) and runs one
MPC period, which captures the WBC stage's. End to end: mpc_tick_p90_ms and
wbc_tick_p99_ms over every tick of the window.

Compared, from the program's own state (the loop is chaotic: a difference
of rounding grows over ticks): the start (`initial_state`, which the
reference works out itself), and `sample_mpc` MPC ticks and `sample_wbc`
WBC ticks drawn from the seed over the window, each tick's Telemetry and
next state against the reference's `step` from the program's state before
it. The numbers: start_gap, mpc_tick_gap and wbc_tick_gap (the largest
`common.leaf_gap` over the floating leaves) and flags_differ (integer and
bool elements that differ: contact flags, fixed foot, tick).
"""

from __future__ import annotations

import math
import time
import traceback

import numpy as np
import torch
from torch.profiler import record_function

from portbench import common, trace, weights
from portbench.controller import Controller

TRACE_PERIODS = 2  # MPC periods in the profiled sub-window (~80-100k kernels each)


class Joystick:
    """The seed's joystick: segments of gait time, each one command."""

    def __init__(self, cell):
        self.tr, self.rng = cell.traffic, np.random.default_rng([cell.seed, 2])
        self.until, self.cmd = -1.0, None

    def at(self, t: float):
        """(changed, [mx, my, 1, 0]) at gait time t (seconds)."""
        if t < self.until:
            return False, self.cmd
        tr = self.tr
        hold = self.rng.uniform(tr["hold_min_s"], tr["hold_max_s"])
        mag = self.rng.uniform(tr["motion_min"], tr["motion_max"])
        head = self.rng.uniform(-math.pi, math.pi)
        self.until = max(self.until, t) + hold
        self.cmd = [mag * math.cos(head), mag * math.sin(head), 1.0, 0.0]
        return True, self.cmd


def _inputs(sut: Controller, cmd, B: int, device):
    joy = torch.tensor(cmd, dtype=torch.float32, device=device).expand(B, 4).contiguous()
    zero = torch.zeros(B, 3, dtype=torch.float32, device=device)
    return sut.tick_input(joy, zero, zero.clone())


def run(cell) -> dict:
    tr, dev, B = cell.traffic, cell.device, cell.traffic["batch"]
    w = weights.synthetic(cell.seed, dev)
    side = "reference" if cell.control else "program"
    sut = Controller(side, cell.config, tr["plant"], w, dev, tf32=cell.control)
    every, wbc_dt = sut.cfg.mpc_every, sut.cfg.wbc_dt
    joystick = Joystick(cell)
    s0 = sut.initial_state(B)
    _, cmd = joystick.at(0.0)
    inp = _inputs(sut, cmd, B, dev)
    sut.warm(s0, inp)
    s, tick = s0, 0
    for _ in range(every):  # one MPC period: captures the WBC stage's graph, replays each graph once
        s, tel = sut.step(s, inp, tick)
        common.sync_read(tel.q)
        tick += 1

    # --- the window ------------------------------------------------------------
    mpc_res, wbc_res = common.Reservoir(tr["sample_mpc"], cell.seed), common.Reservoir(tr["sample_wbc"], cell.seed + 1)
    mpc_walls, wbc_walls, failed, attempted, changes = [], [], 0, 0, []
    cell.note(f"card before the window: {common.nvidia_smi()}")
    t_first = time.perf_counter()
    while True:
        changed, cmd = joystick.at(tick * wbc_dt)
        if changed:
            inp = _inputs(sut, cmd, B, dev)
            changes.append(len(mpc_walls))
        t0 = time.perf_counter()
        try:
            s1, tel = sut.step(s, inp, tick)
            q = common.sync_read(tel.q)
        except Exception:  # a tick that raises is a failed tick; the loop has no state to go on from
            traceback.print_exc()
            failed += 1
            attempted += 1
            break
        t1 = time.perf_counter()
        attempted += 1
        failed += int(not bool(torch.isfinite(q).all()))
        is_mpc = tick % every == 0
        (mpc_walls if is_mpc else wbc_walls).append(t1 - t0)
        record = (lambda s=s, inp=inp, tick=tick, s1=s1, tel=tel: (s, inp, tick, s1, tel))
        (mpc_res if is_mpc else wbc_res).offer(record)
        s, tick = s1, tick + 1
        if t1 - t_first >= cell.seconds:
            break
    elapsed = time.perf_counter() - t_first
    cell.note(f"card after the window: {common.nvidia_smi()}")
    out = {"attempted": attempted, "failed": failed, "device": common.device_info(dev),
           "e2e": {"mpc_tick_p90_ms": 1e3 * common.percentile(mpc_walls, 90),
                   "wbc_tick_p99_ms": 1e3 * common.percentile(wbc_walls, 99),
                   "setup_s": t_first - cell.t_start}}
    cell.note(f"walk: {attempted} ticks in {elapsed:.4f} s ({len(mpc_walls)} MPC, {len(wbc_walls)} WBC), gait time "
              f"{tick * wbc_dt:.3f} s; MPC tick p50 {1e3 * common.percentile(mpc_walls, 50):.3f} ms, p90 "
              f"{out['e2e']['mpc_tick_p90_ms']:.3f} ms; WBC tick p50 {1e3 * common.percentile(wbc_walls, 50):.3f} ms, "
              f"p99 {out['e2e']['wbc_tick_p99_ms']:.3f} ms; setup {t_first - cell.t_start:.3f} s; failed {failed}")
    cell.note(f"walk: MPC tick walls (ms) {[round(1e3 * x, 1) for x in mpc_walls]}; a new joystick before MPC tick "
              f"{changes}")

    # --- the traced sub-window: whole MPC periods ---------------------------------
    if cell.trace and failed == 0:
        out["trace"] = {"capture_s": common.capture_seconds(cell)}
        if dev != "cpu":
            while tick % every:  # to the next MPC tick, unprofiled
                s, tel = sut.step(s, inp, tick)
                common.sync_read(tel.q)
                tick += 1
            with trace.fenced_profile() as prof:
                for _ in range(TRACE_PERIODS * every):
                    with record_function("portbench.mpc_tick" if tick % every == 0 else "portbench.wbc_tick"):
                        s, tel = sut.step(s, inp, tick)
                        common.sync_read(tel.q)
                    tick += 1
            sess = trace.Session(prof)
            if sess.whole:
                dev_ms = {k: [sess.device_ns_in(a, b) / 1e6 for a, b in sess.named(f"portbench.{k}")]
                          for k in ("mpc_tick", "wbc_tick")}
                traced_wbc_wall = [(b - a) / 1e6 for a, b in sess.named("portbench.wbc_tick")]
                out["busy_s"], out["window_s"] = sess.busy_ns() / 1e9, sess.window_ns() / 1e9
                # the share of a tick the card idles: the traced device time over the WBC ticks' mean
                # wall in the measured window, since the profiler slows the host's dispatch of a
                # traced tick some threefold
                out["trace"].update(mpc_tick_device_ms=float(np.mean(dev_ms["mpc_tick"])),
                                    wbc_tick_device_ms=float(np.mean(dev_ms["wbc_tick"])),
                                    wbc_tick_wall_ms=1e3 * float(np.mean(wbc_walls)))
                out["breakdown"] = sess.breakdown()
                cell.note(f"traced MPC ticks: device ms {[round(x, 2) for x in dev_ms['mpc_tick']]}, wall ms "
                          f"{[round((b - a) / 1e6, 2) for a, b in sess.named('portbench.mpc_tick')]}; traced WBC "
                          f"ticks' mean wall {float(np.mean(traced_wbc_wall)):.4f} ms")
            cell.note(f"traced {TRACE_PERIODS} MPC periods: {len(sess.card)} device ops, whole {sess.whole}; "
                      f"{out['trace']}")

    # --- the comparison, once the program's state is freed -------------------
    sut.free()
    with common.reference_place(cell) as ref_dev:
        ref = Controller("reference", cell.config, tr["plant"], weights.moved(w, ref_dev), ref_dev)
        types = common.reference_types()
        ref_s0 = ref.initial_state(B)
        start_gap, where, flags = common.compare_trees(s0, ref_s0)
        worst = {"start_gap": (start_gap, where)}
        for name, res in (("mpc_tick_gap", mpc_res), ("wbc_tick_gap", wbc_res)):
            gap, at = (math.inf, "no tick sampled") if not res.items else (0.0, "")
            for s_b, inp_b, k, s_a, tel_a in res.items:
                r_s, r_tel = ref.step(common.convert(s_b, types, ref_dev), common.convert(inp_b, types, ref_dev), k)
                for got, want in ((s_a, r_s), (tel_a, r_tel)):
                    g, path, f = common.compare_trees(got, want)
                    flags += f
                    if not g <= gap:
                        gap, at = g, f"tick {k} {path}"
            worst[name] = (gap, at)
    cell.note("compared at: " + "; ".join(f"{n} {v[0]:.3e} ({v[1]})" for n, v in worst.items()))
    lim = tr["limits"]
    out["checks"] = [(n, worst[n][0], lim[n]) for n in ("start_gap", "mpc_tick_gap", "wbc_tick_gap")]
    out["checks"].append(("flags_differ", flags, lim["flags_differ"]))
    return out


"""A cell of the port's benchmark with the program's own tracing on: the
per-layer readings that the program's spans, stage marks and graph-cache
counters give (`cmw_tpu_torch/runtime/trace.py`), beside the profiler-read
ones of the benchmark's traced run.

  python tools/trace_cells.py --workload <cell> --seed <n> --seconds <s> \\
      [--program-trace 0|1] [--profile 0|1] [--out FILE]

It runs on the card, on a cell of `BENCHMARK.json`, with the set-up, traffic
and measured window of the cell's driver (`portbench/drivers/`, whose pieces
it reuses). With `--program-trace 1` (the default) `trace.enable()` comes
before the set-up, so every graph carries its stages' marks, and after the
window a program-traced sub-window runs with no profiler (the walks 4 MPC
periods, the chain 4 chains, the sweep 2 periods), read by `trace.collect()`
into the seven readings of `METRICS` and the program's summary. With
`--profile 1` the driver's profiled sub-window follows (`portbench/trace.py`,
the benchmark's ranges around each call), with its profiler-read metrics
and its breakdown of the card's idle gaps by the host op running, which with
tracing on names the program's spans. `--program-trace 0` times the same
window with tracing off: the two give tracing's cost. Prints one JSON line
(and appends it to `--out`).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SUB_WINDOW = {"walk": 4, "solve_chain": 4, "sweep": 2}  # MPC periods / chains / periods traced by the program
DISPATCH = ("cache.lookup", "cache.lock_wait", "cache.copy_in", "cache.launch", "cache.clone_out")


# --- the readings of a collected trace (None where it holds nothing to read) ----

def _marks_ms(tr, stage: str, per: int):
    total = sum(b - a for r in tr.replays for name, a, b, _ in r.marks if name == stage)
    return total / 1e6 / per if per and any(name == stage for r in tr.replays for name, *_ in r.marks) else None


def _count(tr, name: str) -> int:
    return sum(1 for sp in tr.spans if sp.name == name)


def mann_device_ms(tr, **_):
    """The generator's in-graph marks (`mann`), device ms per MPC tick."""
    return _marks_ms(tr, "mann", _count(tr, "loop.mpc_stage"))


def solve_device_ms(tr, **_):
    """The solve's in-graph marks (`mpc.solve`), device ms per MPC tick."""
    return _marks_ms(tr, "mpc.solve", _count(tr, "loop.mpc_stage"))


def dispatch_host_ms_wbc_tick(tr, **_):
    """Host ms per WBC tick (a `loop.step` without an MPC stage) in the
    graph cache's dispatch spans under its `loop.wbc_stage`."""
    steps = {sp.id for sp in tr.spans if sp.name == "loop.step"}
    with_mpc = {sp.parent for sp in tr.spans if sp.name == "loop.mpc_stage"}
    stages = {sp.id for sp in tr.spans if sp.name == "loop.wbc_stage" and sp.parent in steps - with_mpc}
    if not stages:
        return None
    return sum(sp.ns for sp in tr.spans if sp.name in DISPATCH and sp.parent in stages) / 1e6 / len(stages)


def launch_ns_per_node(tr, nodes=None, **_):
    """Host ns in `cache.launch` under `bench.chain` over the chain graph's
    node count, per replay: the launch's cost per node."""
    chains = {sp.id for sp in tr.spans if sp.name == "bench.chain"}
    launches = [sp.ns for sp in tr.spans if sp.name == "cache.launch" and sp.parent in chains]
    if not launches or not nodes:
        return None
    return sum(launches) / len(launches) / nodes


def _idle_share(tr, graph: str, wall_ns):
    device = sum(r.ns for r in tr.replays if r.graph == graph)
    if not wall_ns or not any(r.graph == graph for r in tr.replays):
        return None
    return 100.0 * (1.0 - device / wall_ns)


def idle_share_solve(tr, wall_ns=None, **_):
    """1 - the chains' replay device time / the sub-window's wall, %."""
    return _idle_share(tr, "bench.chain", wall_ns)


def idle_share_sweep(tr, wall_ns=None, **_):
    """1 - the periods' replay device time / the sub-window's wall, %."""
    return _idle_share(tr, "period", wall_ns)


def plant_device_ms(tr, **_):
    """The rigid plant's in-graph marks (`wbc.plant`), device ms per period
    summed over its ticks."""
    return _marks_ms(tr, "wbc.plant", sum(1 for r in tr.replays if r.graph == "period"))


METRICS = {  # the benchmark's name -> (reader, the cells' driver)
    "mann_device_ms": (mann_device_ms, "walk"),
    "solve_device_ms": (solve_device_ms, "walk"),
    "dispatch_host_ms.wbc_tick": (dispatch_host_ms_wbc_tick, "walk"),
    "launch_ns_per_node": (launch_ns_per_node, "solve_chain"),
    "idle_share.solve": (idle_share_solve, "solve_chain"),
    "idle_share.sweep": (idle_share_sweep, "sweep"),
    "plant_device_ms": (plant_device_ms, "sweep"),
}


def replay_ms_by_tick(tr, graphs) -> dict:
    """{request id: device ms of the replays of these graphs}."""
    out = {}
    for r in tr.replays:
        if r.graph in graphs:
            out[r.rid] = out.get(r.rid, 0.0) + r.ns / 1e6
    return out


def walk_sides(tr, every: int) -> dict:
    """The walks' stage times from the program's replay events: the MPC
    stage's (pre + post) and the WBC stage's device ms, per MPC tick and per
    WBC tick, and an MPC tick's whole (its MPC stage and its WBC stage)."""
    mpc = replay_ms_by_tick(tr, ("mpc_pre", "mpc_post"))
    wbc = replay_ms_by_tick(tr, ("wbc_stage",))
    if not mpc or not wbc:
        return {}
    wbc_only = [v for k, v in wbc.items() if k % every]
    stage = statistics.fmean(mpc.values())
    marked = (mann_device_ms(tr) or 0.0) + (solve_device_ms(tr) or 0.0)
    return {"mpc_stage_device_ms": stage, "mpc_stage_unmarked_ms": stage - marked,
            "mpc_tick_device_ms": statistics.fmean(mpc[k] + wbc.get(k, 0.0) for k in mpc),
            "wbc_tick_device_ms": statistics.fmean(wbc_only) if wbc_only else None}


def replay_ms(tr, graph: str):
    """The mean device ms of the graph's replays, or None."""
    ns = [r.ns for r in tr.replays if r.graph == graph]
    return statistics.fmean(ns) / 1e6 if ns else None


def host_ranges(prof, name: str) -> list:
    """[(start, end)] of the host-side ranges called name: the ranges a
    profiled thread opened, without the device-side annotations the
    profiler may add for them."""
    from torch.autograd import DeviceType

    return [(e.start_ns(), e.end_ns()) for e in prof.kineto_results.events()
            if e.is_user_annotation() and e.device_type() == DeviceType.CPU and e.name() == name]


# --- the cells ------------------------------------------------------------------

def _walls(values) -> dict:
    from portbench import common

    return {f"p{q}": 1e3 * common.percentile(values, q) for q in (50, 90, 99)} | {"n": len(values)}


def run_walk(cell, out):
    import torch

    from cmw_tpu_torch.runtime import trace
    from portbench import common, trace as ptrace, weights
    from portbench.controller import Controller
    from portbench.drivers import walk as W

    tr, dev, B = cell.traffic, cell.device, cell.traffic["batch"]
    sut = Controller("program", cell.config, tr["plant"], weights.synthetic(cell.seed, dev), dev)
    every, wbc_dt = sut.cfg.mpc_every, sut.cfg.wbc_dt
    joystick = W.Joystick(cell)
    s = sut.initial_state(B)
    _, cmd = joystick.at(0.0)
    inp = W._inputs(sut, cmd, B, dev)
    sut.warm(s, inp)
    tick = 0

    def step():
        nonlocal s, tick
        s, tel = sut.step(s, inp, tick)
        common.sync_read(tel.q)
        tick += 1

    for _ in range(every):
        step()
    mpc_walls, wbc_walls = [], []
    t_first = time.perf_counter()
    while time.perf_counter() - t_first < cell.seconds:
        changed, cmd = joystick.at(tick * wbc_dt)
        if changed:
            inp = W._inputs(sut, cmd, B, dev)
        t0 = time.perf_counter()
        is_mpc = tick % every == 0
        step()
        (mpc_walls if is_mpc else wbc_walls).append(time.perf_counter() - t0)
    out["setup_s"] = t_first - cell.t_start
    out["window"] = {"mpc_tick_ms": _walls(mpc_walls), "wbc_tick_ms": _walls(wbc_walls)}
    while tick % every:
        step()
    if out["program_trace"]:
        trace.collect()
        t0 = time.perf_counter_ns()
        for _ in range(SUB_WINDOW["walk"] * every):
            step()
        wall = time.perf_counter_ns() - t0
        rec = trace.collect()
        program(out, rec, wall_ns=wall)
        sides = walk_sides(rec, every)
        if sides.get("wbc_tick_device_ms"):
            sides["idle_share.wbc_tick"] = 100.0 * (1.0 - sides["wbc_tick_device_ms"] / (1e3 * statistics.fmean(
                wbc_walls)))
        out["program_side"] = sides
    if cell.trace:
        if out["program_trace"]:
            trace.collect()
        with ptrace.fenced_profile() as prof:
            for _ in range(W.TRACE_PERIODS * every):
                with torch.profiler.record_function("portbench.mpc_tick" if tick % every == 0 else
                                                    "portbench.wbc_tick"):
                    step()
        if out["program_trace"]:  # the same replays, read by their events under the profiler
            out["program_side_profiled"] = walk_sides(trace.collect(), every)
        sess = ptrace.Session(prof)
        if sess.whole:
            side = {"ops_per_period": len(sess.card) / W.TRACE_PERIODS}
            for how, ranges in (("", sess.named), ("host_ranges.", lambda n: host_ranges(prof, n))):
                dev_ms = {k: [sess.device_ns_in(a, b) / 1e6 for a, b in ranges(f"portbench.{k}")]
                          for k in ("mpc_tick", "wbc_tick")}
                wbc_ms = statistics.fmean(dev_ms["wbc_tick"])
                side |= {f"{how}mpc_tick_device_ms": statistics.fmean(dev_ms["mpc_tick"]),
                         f"{how}wbc_tick_device_ms": wbc_ms, f"{how}ranges": {k: len(v) for k, v in dev_ms.items()},
                         f"{how}idle_share.wbc_tick": 100.0 * (1.0 - wbc_ms / (1e3 * statistics.fmean(wbc_walls)))}
            out["profiler_side"] = side
            out["breakdown"] = sess.breakdown(top=16)
        out["profile_whole"] = sess.whole
    sut.free()


def run_solve_chain(cell, out):
    from cmw_tpu_torch.runtime import cache, trace
    from portbench import common, presets, trace as ptrace
    from portbench.drivers import solve_chain as S

    tr, dev = cell.traffic, cell.device
    B, KB = tr["batch"], tr["chain"]
    sut = S.Program(presets.walking_config(cell.config, "kinematic", "program").mpc, dev)
    params, warm = sut.inputs(S.pushes(cell, B), tr["t0"])

    def chain():
        common.sync_read(sut.chain(params, warm, KB)[0])

    for _ in range(tr.get("warm_chains", 2)):
        chain()
    walls = []
    t_first = time.perf_counter()
    while time.perf_counter() - t_first < cell.seconds:
        t0 = time.perf_counter()
        chain()
        walls.append(time.perf_counter() - t0)
    out["setup_s"] = t_first - cell.t_start
    out["window"] = {"chain_ms": _walls(walls), "solves_per_s": len(walls) * B * KB / sum(walls)}
    if out["program_trace"]:
        trace.collect()
        t0 = time.perf_counter_ns()
        for _ in range(SUB_WINDOW["solve_chain"]):
            chain()
        wall = time.perf_counter_ns() - t0
        rec = trace.collect()
        nodes = next((e.traced.nodes for e in cache.entries().values()
                      if e.traced is not None and e.traced.name == "bench.chain"), None)
        out["chain_nodes"] = nodes
        program(out, rec, wall_ns=wall, nodes=nodes)
        out["program_side"] = {"chain_device_ms": replay_ms(rec, "bench.chain")}
    if cell.trace:
        if out["program_trace"]:
            trace.collect()
        with ptrace.fenced_profile() as prof:
            chain()
        if out["program_trace"]:  # the same replay, read by its events under the profiler
            out["program_side_profiled"] = {"chain_device_ms": replay_ms(trace.collect(), "bench.chain")}
        sess = ptrace.Session(prof)
        if sess.whole:
            out["profiler_side"] = {"chain_device_ms": sess.busy_ns() / 1e6, "ops_per_chain": len(sess.card),
                                    "window_ms": sess.window_ns() / 1e6}
            out["breakdown"] = sess.breakdown(top=16)
        out["profile_whole"] = sess.whole
    sut.free()


def run_sweep(cell, out):
    from cmw_tpu_torch.dist.sweep import fold
    from cmw_tpu_torch.runtime import cache, trace
    from portbench import common, trace as ptrace, weights
    from portbench.controller import Controller
    from portbench.drivers import sweep as SW

    tr, dev, B = cell.traffic, cell.device, cell.traffic["batch"]
    sut = Controller("program", cell.config, tr["plant"], weights.synthetic(cell.seed, dev), dev)
    s0 = sut.initial_state(B)
    a0 = SW.acc0(s0)
    state = {"s": s0, "acc": a0, "j": 0, "episode": 0,
             "blocks": SW._blocks(SW.episode_inputs(sut, cell, 0, dev), sut.cfg.mpc_every)}

    def period():
        st = state
        st["s"], st["acc"] = sut.period_fold(st["s"], st["blocks"][st["j"]], fold, st["acc"])
        common.sync_read(st["acc"][3])
        st["j"] += 1
        if st["j"] == len(st["blocks"]):
            st["episode"] += 1
            st["j"], st["s"], st["acc"] = 0, s0, a0
            st["blocks"] = SW._blocks(SW.episode_inputs(sut, cell, st["episode"], dev), sut.cfg.mpc_every)

    common.sync_read(sut.period_fold(s0, state["blocks"][0], fold, a0)[1][3])
    walls = []
    t_first = time.perf_counter()
    while time.perf_counter() - t_first < cell.seconds:
        t0 = time.perf_counter()
        period()
        walls.append(time.perf_counter() - t0)
    out["setup_s"] = t_first - cell.t_start
    out["window"] = {"period_ms": _walls(walls),
                     "scenario_s_per_s": B * len(walls) * sut.cfg.mpc.dt / sum(walls)}
    if out["program_trace"]:
        trace.collect()
        t0 = time.perf_counter_ns()
        for _ in range(SUB_WINDOW["sweep"]):
            period()
        wall = time.perf_counter_ns() - t0
        rec = trace.collect()
        out["period_nodes"] = next((e.traced.nodes for e in cache.entries().values()
                                    if e.traced is not None and e.traced.name == "period"), None)
        program(out, rec, wall_ns=wall)
        out["program_side"] = {"period_device_ms": replay_ms(rec, "period")}
    if cell.trace:
        if out["program_trace"]:
            trace.collect()
        with ptrace.fenced_profile() as prof:
            period()
        if out["program_trace"]:  # the same replay, read by its events under the profiler
            out["program_side_profiled"] = {"period_device_ms": replay_ms(trace.collect(), "period")}
        sess = ptrace.Session(prof)
        if sess.whole:
            out["profiler_side"] = {"period_device_ms": sess.busy_ns() / 1e6, "ops_per_period": len(sess.card)}
            out["breakdown"] = sess.breakdown(top=16)
        out["profile_whole"] = sess.whole
    sut.free()


def program(out: dict, rec, **context) -> None:
    """The readings of METRICS that apply to the cell, the program's summary
    and the graph cache's counters, into out."""
    from cmw_tpu_torch.runtime import cache, trace

    out["metrics"] = {name: fn(rec, **context) for name, (fn, driver) in METRICS.items()
                      if driver == out["driver"]}
    out["summary"] = trace.summary(rec)
    out["sub_window_ms"] = context["wall_ns"] / 1e6
    graphs = [e.traced for e in cache.entries().values() if e.traced is not None]
    nodes = {g.name: g.nodes for g in graphs if [h.name for h in graphs].count(g.name) == 1}
    out["replay_ns_per_node"] = {  # a replay's device span over its graph's nodes (names of one graph only)
        name: 1e6 * replay_ms(rec, name) / nodes[name] for name in {r.graph for r in rec.replays} if nodes.get(name)}
    out["graphs"] = {e.traced.name + f"#{i}": {"replays": e.traced.replays, "nodes": e.traced.nodes,
                                               "device_ms": e.traced.device_ns / 1e6,
                                               "host_ms": {k: v / 1e6 for k, v in e.traced.host_ns.items()},
                                               "pool_bytes": e.traced.pool_bytes,
                                               "pool_growth": e.traced.pool_growth, "capture_s": e.capture_s}
                     for i, e in enumerate(cache.entries().values()) if e.traced is not None}


RUNS = {"walk": run_walk, "solve_chain": run_solve_chain, "sweep": run_sweep}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--program-trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--profile", type=int, choices=(0, 1), default=0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    from portbench import common
    from portbench.run import load_cell

    cell = load_cell(args.workload, args.seed, args.seconds, bool(args.profile))
    import torch

    if not torch.cuda.is_available():
        print("trace_cells: runs on the card only", file=sys.stderr)
        return 2
    driver = cell.traffic["driver"]
    out = {"workload": args.workload, "seed": args.seed, "driver": driver, "program_trace": bool(args.program_trace),
           "card": common.nvidia_smi()}
    if args.program_trace:
        from cmw_tpu_torch.runtime import trace

        trace.enable()
    RUNS[driver](cell, out)
    line = json.dumps(out, default=float)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

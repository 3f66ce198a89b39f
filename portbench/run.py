"""One run of one cell of the port's benchmark.

  python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell from `BENCHMARK.json`, its configuration
(`portbench/configs/<config>.json`) and its traffic
(`portbench/traffic/<traffic>.json`, which names the driver,
`portbench/drivers/<driver>.py`), then the driver sets up, measures for
`--seconds`, with `--trace 1` profiles a bounded sub-window afterwards, and
holds what the timed path produced against the plain reference
(`portbench/reference/`). The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end metrics,
or with --trace 1 its per-layer ones, each read by
`portbench/metrics/<metric>.py`), device, with --trace 1 breakdown, and
last `compared`: each number compared with its limit, also printed as the
last lines of standard error.

It runs on the card only: without CUDA, or with fewer cards than the cell
asks for, it exits with code 2 and prints no result. It exits with code 3
and prints no result if jax, jaxlib, flax or the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # the process's start, as near as Python gets: setup_s counts from here

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]  # the checkout
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cmw_tpu")  # top-level module names, compared whole


def _cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths, so
    that only a cell's first run there builds. (The program's own kernels
    build into `cmw_tpu_torch/csrc/build`, inside the checkout too.)"""
    base = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


@dataclasses.dataclass
class Cell:
    """What a driver is handed: the cell's manifest entry, its configuration
    and traffic files, the run's arguments, and the device."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = T_START
    control: bool = False  # the reference in the program's place, in TF32 (portbench/tests only)
    reference_on: str = "card"  # or "cpu", "magma": the reference's rounding changed (portbench/tests only)

    def note(self, msg: str) -> None:
        """A line on standard error, before the result."""
        print(msg, file=sys.stderr, flush=True)


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda") -> Cell:
    """The cell called name, its files found by the names the manifest gives."""
    man = manifest()
    entries = {w["name"]: w for w in man["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(entries)})")
    entry = entries[name]
    cfg_entry = {c["name"]: c for c in man["configs"]}[entry["config"]]
    with open(ROOT / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name, entry, config, traffic, seed, seconds, trace, device)


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    return importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")


def reader(metric: str):
    """The per-layer metric's reader, `portbench/metrics/<metric>.py`."""
    return _load_file(HERE / "metrics" / f"{metric}.py", f"portbench.metrics.{metric}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def result(cell: Cell, out: dict) -> dict:
    """The last line's object from the driver's outcome (see drivers/)."""
    from portbench.common import finite_or_none

    man = manifest()
    metrics = {}
    if not cell.trace:
        for m in man["end_to_end"]:
            if _applies(m, cell.name):
                metrics[m["name"]] = {"value": finite_or_none(out["e2e"].get(m["name"])), "unit": m["unit"]}
    else:
        for m in man["per_layer"]:
            if _applies(m, cell.name):
                value = finite_or_none(reader(m["name"]).read(out.get("trace", {})))
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    compared = {name: {"value": finite_or_none(v), "limit": lim} for name, v, lim in out["checks"]}
    correct = out["failed"] == 0 and bool(compared) and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in compared.values())
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
            "device": dict(out["device"])}
    if cell.trace:
        line["device"]["busy_s"] = finite_or_none(out.get("busy_s"))
        line["device"]["window_s"] = finite_or_none(out.get("window_s"))
        if out.get("breakdown"):
            line["breakdown"] = out["breakdown"]
    line["compared"] = compared
    return line


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    cell = load_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    import torch

    chips = cell.entry.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s), found {n}; it runs on the card only",
              file=sys.stderr)
        return 2
    out = driver(cell).run(cell)
    line = result(cell, out)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded in this process: {bad}", file=sys.stderr)
        return 3
    for name, c in line["compared"].items():
        print(f"compared {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The manifest and every file it names are found by name, and hold the
benchmark's rules: names, units, bounds, sources, the metrics each cell
reports, and the configurations' sizes against both sides' presets."""

import json
import re
from pathlib import Path

import pytest

from portbench import presets, run

ROOT = Path(run.__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = run.manifest()


def test_manifest_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"] and 1 <= MAN["run_seconds"] <= 51
    assert len(MAN["command"]) <= 32 and not any(w.startswith("/") or ".." in w for w in MAN["command"])
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in MAN[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_found_by_name(cell):
    entry = {w["name"]: w for w in MAN["workloads"]}[cell]
    assert set(entry) == {"name", "config", "traffic", "chips", "why"} and entry["chips"] == 1
    assert len(entry["why"]) <= 200
    c = run.load_cell(cell, 1, 1.0, False, device="cpu")
    driver = run.driver(c)
    assert callable(driver.run)
    e2e = [m["name"] for m in MAN["end_to_end"] if run._applies(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = [m["name"] for m in MAN["per_layer"] if run._applies(m, cell)]
    assert layers
    for m in layers:
        assert callable(run.reader(m).read)
        moves = {x["name"]: x["moves"] for x in MAN["per_layer"]}[m]
        assert moves in e2e, f"{m} moves {moves}, which {cell} does not report"


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
@pytest.mark.parametrize("side", ["program", "reference"])
def test_config_sizes_hold_on_both_sides(config, side):
    entry = {c["name"]: c for c in MAN["configs"]}[config]
    assert entry["file"].startswith("portbench/configs/")
    with open(ROOT / entry["file"]) as f:
        cfg = json.load(f)
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    for plant in ("kinematic", "rigid"):
        presets.walking_config(cfg, plant, side)  # raises where a size differs


def test_a_changed_size_is_refused():
    entry = MAN["configs"][0]
    with open(ROOT / entry["file"]) as f:
        cfg = json.load(f)
    cfg["sizes"] = dict(cfg["sizes"], **{"mpc.admm_iters": 7})
    with pytest.raises(ValueError, match="admm_iters"):
        presets.walking_config(cfg, "kinematic", "program")


def test_every_metric_has_a_reader_and_every_file_a_use():
    readers = {p.stem for p in (ROOT / "portbench" / "metrics").glob("*.py")} - {"__init__"}
    assert readers == {m["name"] for m in MAN["per_layer"]}
    traffic = {p.stem for p in (ROOT / "portbench" / "traffic").glob("*.json")}
    assert traffic == {w["traffic"] for w in MAN["workloads"]}
    drivers = {p.stem for p in (ROOT / "portbench" / "drivers").glob("*.py")} - {"__init__"}
    for t in traffic:
        with open(ROOT / "portbench" / "traffic" / f"{t}.json") as f:
            assert json.load(f)["driver"] in drivers

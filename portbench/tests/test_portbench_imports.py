"""Nothing the benchmark runs imports jax, jaxlib, flax or the JAX package
(`cmw_tpu`): top-level module names are compared whole, since the port's
name, `cmw_tpu_torch`, begins with the JAX package's."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench import run

HERE = Path(run.__file__).resolve().parent


def test_no_source_of_the_benchmark_imports_them():
    found = {}
    for path in HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            bad = {n.split(".")[0] for n in names} & set(run.FORBIDDEN)
            if bad:
                found[str(path.relative_to(HERE))] = sorted(bad)
    assert not found, found


REHEARSAL = """
import json, sys
from portbench import run
small = {"gz_solve_b512": dict(batch=2, chain=1, warm_chains=1), "gz_walk_b1": {}, "sn000_walk_b1": {},
         "gz_push_sweep_rigid_b256": dict(batch=2, plant="kinematic", episode_s=0.06)}
for name in [w["name"] for w in run.manifest()["workloads"]]:
    cell = run.load_cell(name, 7, 0.05, True, device="cpu")
    cell.traffic = dict(cell.traffic, **small.get(name, {}))
    run.result(cell, run.driver(cell).run(cell))
    for m in [m["name"] for m in run.manifest()["per_layer"]]:
        run.reader(m)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_module_is_loaded_by_a_rehearsal_of_every_cell():
    proc = subprocess.run([sys.executable, "-c", REHEARSAL], cwd=HERE.parent, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "cmw_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & set(run.FORBIDDEN), sorted(loaded & set(run.FORBIDDEN))

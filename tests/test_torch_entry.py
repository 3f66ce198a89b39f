"""The port's entry points (`cmw_tpu_torch.entry`, the twin of
`__graft_entry__.py`) and its scaling harness (`cmw_tpu_torch.apps.scaling`)
on the CPU:

  - `entry()`: one production-config solve against JAX's `entry()` (its
    Riccati solve, f32), within the solver tests' tolerances;
  - `dryrun_multichip` on 2 gloo ranks: the all-reduced mean cost equals the
    mean of the same 4 items solved in one batch in this process (rtol 1e-4:
    the batch's size moves f32 sums by ulps), and the episode stays near its
    0.7 m CoM;
  - `scaling.measure` on 2 gloo ranks, and `scaling.main` printing the rows
    and report line with the keys the JAX CLI prints (its `measure` swapped
    for a constant, so that JAX compiles nothing);
  - without `device="cpu"` / `--cpu`, on a machine without a card, each
    raises."""

import json

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
import chip_smoke
from cmw_tpu.apps import scaling as JScaling
from cmw_tpu_torch import entry
from cmw_tpu_torch.apps import scaling
from cmw_tpu_torch.cmpc import ergocub_mpc_config

torch.set_num_threads(2)

COST_RTOL = 2e-3  # tests/test_torch_solver.py
FORCE_ATOL = 1e-3


@pytest.fixture(scope="module")
def mann_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("mann") / "mann4.onnx"
    path.write_bytes(chip_smoke.mann_onnx_bytes(chip_smoke.synthetic_mann_numpy()))
    return str(path)


def test_entry_matches_jax():
    fn, args = entry.entry(device="cpu")
    sol = fn(*args)
    jfn, jargs = jentry.entry()
    want = jax.jit(jfn)(*jargs)
    assert sol.cost.shape == (1,)
    np.testing.assert_allclose(float(sol.cost[0]), float(want.cost), rtol=COST_RTOL)
    np.testing.assert_allclose(sol.forces[0].numpy(), np.asarray(want.forces), atol=FORCE_ATOL)
    assert float(sol.prim_res[0]) < 1e-2 and float(want.prim_res) < 1e-2


def test_dryrun_multichip_on_two_gloo_ranks(mann_file, capsys):
    out = entry.dryrun_multichip(2, mann=mann_file, device="cpu")
    printed = capsys.readouterr().out
    assert "dryrun_multichip solver OK: 2 ranks" in printed and "dryrun_multichip episode OK" in printed
    solver, params = entry.example(ergocub_mpc_config(), torch.linspace(-1.0, 1.0, 4), "cpu")
    want = float(solver.solve(params, solver.cold_start(4, device="cpu")).cost.mean())
    np.testing.assert_allclose(out["mean_cost"], want, rtol=1e-4)
    assert 0.6 < out["com_max"] < 0.8, out


def test_scaling_on_two_gloo_ranks(capsys):
    assert scaling.measure(2, per_device=2, reps=1, chain=1, device="cpu") > 0
    argv = ["--cpu", "--devices", "1,2", "--per-device", "2", "--reps", "1", "--chain", "1"]
    capsys.readouterr()
    rows = scaling.main(argv)
    got = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["devices"] for r in rows] == [1, 2] and all(r["solves_per_s"] > 0 for r in rows)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JScaling, "measure", lambda n, per_device, reps, chain: 100.0 * n)
        JScaling.main(argv)
    want = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [set(r) for r in got] == [set(r) for r in want]
    assert set(got[-1]["rows"][0]) == set(want[-1]["rows"][0]) and got[-1]["metric"] == "scaling_report"


def test_without_a_card_they_raise(mann_file):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises((AssertionError, RuntimeError)):
        entry.entry()
    with pytest.raises(RuntimeError, match="cards"):
        entry.dryrun_multichip(1, mann=mann_file)
    with pytest.raises(RuntimeError, match="cards"):
        scaling.main(["--devices", "1", "--per-device", "2"])

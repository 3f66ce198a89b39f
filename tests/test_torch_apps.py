"""The port's command-line entry points on the CPU (`--cpu`), on the
synthetic MANN weights at the published mann4 shapes that
ergocub_gazebo_v1() expects, written as an ONNX file by
`chip_smoke.mann_onnx_bytes`:

  - `apps.sweep --ablation` over one MPC period prints the keys the JAX CLI
    prints (`cmw_tpu.apps.sweep.main` run with the same flags, its
    `run_sweep` computing on the loop tests' small configuration, so that
    the JAX side compiles in about a minute, not on the production
    horizon), which are the keys chip_smoke.py's phase 11 requires;
  - `apps.sweep --mesh` on two gloo ranks set up as torchrun sets them up
    prints the summary once, over both ranks, and refuses to run without
    them;
  - `apps.walk` split by `--save-state` / `--resume-state` ends where the
    straight run ends, bit for bit, and its telemetry loads;
  - `apps.walk`'s telemetry file has JAX's layout ([S, ...] channels, JAX's
    metadata keys), which JAX's loader reads;
  - `apps.walk --robot-dir` and `--interactive` run (tests/test_torch_ini.py,
    tests/test_torch_realtime.py), and like every mode refuse to run without
    a card unless `--cpu` is given."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from cmw_tpu.apps import sweep as JApp
from cmw_tpu.cmpc import formulation as JF
from cmw_tpu.core import kinematics as JK
from cmw_tpu.dist import sweep as JS
from cmw_tpu.runtime import config as JCfg
from cmw_tpu.runtime import loop as JL
from cmw_tpu.runtime import telemetry as JT
from cmw_tpu_torch.apps import sweep as TApp
from cmw_tpu_torch.apps import walk as TWalk
from cmw_tpu_torch.runtime import checkpoint, telemetry
from test_torch_ini import write_robot
from test_torch_runtime import jax_weights

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mann_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("mann") / "mann4.onnx"
    path.write_bytes(chip_smoke.mann_onnx_bytes(chip_smoke.synthetic_mann_numpy()))
    return str(path)


def printed_json(capsys, main, argv):
    capsys.readouterr()
    main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


def keys(d):
    """The key paths of a nested dict."""
    return {k for k in d} | {f"{k}.{sub}" for k, v in d.items() if isinstance(v, dict) for sub in keys(v)}


def test_sweep_cli_prints_the_jax_keys(capsys, mann_file):
    argv = ["--cpu", "--batch", "2", "--seconds", "0.06", "--push-t0", "0.01", "--per-scenario", "--ablation",
            "--mann", mann_file]
    got = printed_json(capsys, TApp.main, argv)
    assert got["adjust_on"]["step_adjustment"] and not got["adjust_off"]["step_adjustment"]
    assert len(got["adjust_on"]["survived_mask"]) == 2 and got["adjust_on"]["devices"] == 1
    small = JL.WalkingController(JCfg.ergocub_gazebo_v1(mpc=JF.ergocub_mpc_config(horizon=0.6)),
                                 JK.ergocub_approx(), jax_weights(chip_smoke.synthetic_mann_numpy(), np.float32))
    summaries, real = {}, JS.run_sweep

    def small_sweep(ctl, **kw):
        if "summary" not in summaries:
            summaries["summary"] = real(small, **kw)
        return dict(summaries["summary"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "run_sweep", small_sweep)
        want = printed_json(capsys, JApp.main, argv)
    assert keys(got) == keys(want)
    assert set(want["adjust_on"]) == chip_smoke.SWEEP_KEYS  # what chip_smoke.py phase 11 requires of the card's run


def test_sweep_cli_mesh(capsys, mann_file):
    """`--mesh` under a launcher's environment (two gloo ranks on this host,
    as torchrun sets them up): rank 0 alone prints the summary, with devices
    2 and every scenario's survival; without the environment, --mesh
    raises."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = ["--cpu", "--mesh", "--batch", "2", "--seconds", "0.06", "--push-t0", "0.01", "--per-scenario",
            "--mann", mann_file]
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, PYTHONPATH=root, WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-m", "cmw_tpu_torch.apps.sweep"] + argv, cwd=root, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
    summary = json.loads(outs[0][0].strip().splitlines()[-1])
    assert summary["devices"] == 2 and len(summary["survived_mask"]) == 2 and outs[1][0].strip() == ""
    with pytest.raises(RuntimeError, match="process group"):
        TApp.main(argv)


def test_walk_cli_resumes_bit_for_bit(tmp_path, mann_file):
    """0.12 s pushed and saved, then 0.06 s resumed, against 0.18 s straight
    with the same push: the same final state file; the telemetry loads."""
    common = ["--cpu", "--mann", mann_file, "--joystick", "0:0.6,0,1,0"]
    push = ["--push", "0.02,0.08,1.5,-1.0,0"]
    files = {name: str(tmp_path / f"{name}.npz") for name in ("a", "b", "c", "ta", "tb", "tc")}
    TWalk.main(common + push + ["--seconds", "0.12", "--save-state", files["a"], "--out", files["ta"]])
    TWalk.main(common + ["--seconds", "0.06", "--resume-state", files["a"], "--save-state", files["b"],
                         "--out", files["tb"]])
    TWalk.main(common + push + ["--seconds", "0.18", "--save-state", files["c"], "--out", files["tc"]])
    with np.load(files["b"]) as split, np.load(files["c"]) as straight:
        assert split.files == straight.files
        for name in split.files:
            np.testing.assert_array_equal(split[name], straight[name], err_msg=name)
    assert checkpoint.load_meta(files["c"])["t"] == pytest.approx(0.18)
    for name, ticks in (("ta", 60), ("tb", 30), ("tc", 90)):
        chans, meta = telemetry.load(files[name])
        assert chans["com_mpc"].shape == (ticks, 3) and meta["robot"] == "ergoCubGazeboV1"


def test_walk_telemetry_has_jax_layout(tmp_path, mann_file):
    """The walk's file against what cmw_tpu.runtime.telemetry.save writes for
    a JAX Telemetry of the same S: the same channels, each [S, ...] (the
    batch-first episode's item 0), the same metadata keys; JAX's loader reads
    the port's file as it reads its own."""
    path, jpath = str(tmp_path / "walk.npz"), str(tmp_path / "jax.npz")
    TWalk.main(["--cpu", "--mann", mann_file, "--seconds", "0.02", "--out", path])
    chans, meta = telemetry.load(path)
    JT.save(jpath, JL.Telemetry(**chans), 0.002, extra={"robot": "ergoCubGazeboV1"})
    jchans, jmeta = JT.load(jpath)
    assert list(meta) == list(jmeta) and meta == jmeta
    assert chans.keys() == jchans.keys() == set(JL.Telemetry._fields)
    for name, value in chans.items():
        assert value.shape[0] == 10 and value.shape == jchans[name].shape, name
    rchans, rmeta = JT.load(path)
    assert rmeta == jmeta and all(np.array_equal(rchans[k], chans[k]) for k in chans)


@pytest.mark.parametrize("flag", [["--robot-dir", "config/robots/ergoCubGazeboV1"], ["--interactive"]])
def test_walk_cli_refuses_what_is_not_ported(flag, tmp_path, mann_file):
    """Both modes are ported (their tests: tests/test_torch_ini.py,
    tests/test_torch_realtime.py). What the CLI still refuses is a run
    without a card and without --cpu: it raises, it does not fall back."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    d = write_robot(tmp_path, "current")
    argv = ["--mann", mann_file] + (["--robot-dir", d] if flag[0] == "--robot-dir" else flag)
    with pytest.raises((AssertionError, RuntimeError)):
        TWalk.main(argv)

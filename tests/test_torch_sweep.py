"""The batched sweep path of the port on the kinematic plant
(`cmw_tpu_torch.runtime.loop` blocked and folded episodes,
`cmw_tpu_torch.dist.sweep`) against itself and against `cmw_tpu`, at the
loop tests' configuration (ergocub_gazebo_v1(mpc=ergocub_mpc_config(horizon=
0.6)), the synthetic MANN weights whose left foot swings, B = 2 over 2 MPC
periods):

  - `run_episode_blocked` equals `run_episode` bit for bit, in f32 and f64,
    and refuses a start off an MPC tick or a length off whole periods;
  - `run_episode_fold` with a fold that keeps every tick equals the blocked
    telemetry, and a running maximum its reduction;
  - `build_scenarios` gives JAX's inputs exactly (f32), with a ramp and a
    length that is not whole periods;
  - `_episode_metrics` and `_shard_metrics` (both threshold settings) match
    JAX's on the same converted state and inputs within F64_TOL, survival
    identical;
  - the chunked sweep equals the unchunked one, and `use_mesh` on a gloo
    group of 2 processes equals one process; `use_mesh` without a group
    raises.

The rigid plant's metrics are in tests/test_torch_sweep_rigid.py."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_tpu.dist import sweep as JS
from cmw_tpu.runtime import loop as JL
from cmw_tpu_torch import convert
from cmw_tpu_torch.dist import sweep as TS
from cmw_tpu_torch.runtime import loop as TL
from test_torch_runtime import DTYPES, F64_TOL, controllers, jax_initial_state, np_tree, to_jax

torch.set_num_threads(2)

B = 2
SECONDS = 0.12  # 60 ticks: 2 MPC periods
# the sweep's scenarios, pushed inside the episode: 2 m/s^2 (the CLI's
# push_max) from tick 5 for 40 ticks, the stick walking forward
SCENARIO = dict(push_max=2.0, push_duration=0.08, vx=0.8, push_t0=0.01)
METRICS = ("supp_dev", "z_dev", "track_err", "finite", "up_min", "bz_min", "zb0")
SETTINGS = ((JS.UP_MIN, True), (0.7, False))  # (up_thresh, model_guards)
PUSH_ULPS = 2


@pytest.fixture(scope="module")
def ctls():
    return controllers()


@pytest.fixture(scope="module")
def blocked(ctls):
    """{dtype: (s0, inputs, run_episode's (state, telemetry), run_episode_blocked's)}."""
    out = {}
    for dt, (_, tctl) in ctls.items():
        s0, inputs = TS.build_scenarios(tctl, B, SECONDS, dtype=DTYPES[dt][1], **SCENARIO)
        out[dt] = (s0, inputs, tctl.run_episode(s0, inputs), tctl.run_episode_blocked(s0, inputs))
    return out


def assert_trees_equal(a, b, path=""):
    """Two port NamedTuples bit for bit (the noise generators aside)."""
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f"{path}.{name}"
        elif isinstance(x, tuple):
            assert_trees_equal(x, y, f"{path}.{name}")


@pytest.mark.parametrize("dt", list(DTYPES))
def test_blocked_equals_run_episode(blocked, dt):
    s0, inputs, (s1, tel1), (s2, tel2) = blocked[dt]
    assert tel2.q.shape[:2] == (B, 60) and int(s2.tick[0]) == 60
    assert_trees_equal(tel1, tel2)
    assert_trees_equal(s1, s2)
    assert (tel2.foot_contact[:, :, 0] < 0.5).any()  # the left foot swings
    assert inputs.ext_force.abs().max() > 0


def test_blocked_preconditions(ctls, blocked):
    """Off an MPC tick, or not whole MPC periods: ValueError, before any
    stage runs."""
    _, tctl = ctls["f64"]
    s0, inputs = blocked["f64"][:2]
    with pytest.raises(ValueError, match="MPC tick"):
        tctl.run_episode_blocked(s0._replace(tick=s0.tick + 1), inputs)
    with pytest.raises(ValueError, match="multiple of 30"):
        tctl.run_episode_fold(s0, TL.TickInput(*(a[:, :45] for a in inputs)), lambda acc, tel: acc, None)


def test_fold_equals_blocked_telemetry(ctls, blocked):
    """A fold that keeps each tick's com_mpc and a running maximum of
    mpc_prim: the kept ticks equal the blocked telemetry bit for bit, the
    maximum its reduction over the episode."""
    _, tctl = ctls["f64"]
    s0, inputs, _, (s_blk, tel) = blocked["f64"]

    def fold(acc, t):
        kept, prim = acc
        return kept + (t.com_mpc,), torch.maximum(prim, t.mpc_prim)

    sN, (kept, prim) = tctl.run_episode_fold(s0, inputs, fold, ((), torch.zeros(B, dtype=torch.float64)))
    assert len(kept) == 60
    assert torch.equal(torch.stack(kept, dim=1), tel.com_mpc)
    assert torch.equal(prim, tel.mpc_prim.amax(dim=1))
    assert_trees_equal(sN, s_blk)


def test_build_scenarios_matches_jax(ctls):
    """JAX's inputs in f32: a ramp, an episode of 0.07 s (35 ticks, cut to
    one period), a push window from 0.01 s, a push_max that f32 does not
    hold exactly, an odd batch. The joystick, the torque and the window
    (its ticks, truncated as JAX truncates them) exactly; the pushes within
    PUSH_ULPS f32 ulps of push_max (XLA fuses jnp.linspace's two products
    into FMAs where its compiler chooses, which plain f32 arithmetic does not
    reproduce)."""
    jctl, tctl = ctls["f32"]
    kw = dict(batch=5, seconds=0.07, push_max=0.7, push_duration=0.03, vx=0.5, ramp=0.05, push_t0=0.01)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jctl, "initial_state", lambda: {"x": jnp.zeros(1)})  # only the inputs are compared here
        _, jinp = JS.build_scenarios(jctl, **kw)
    s0, inp = TS.build_scenarios(tctl, **kw)
    assert inp.joypad.shape == (5, 30, 4) and s0.x9.shape == (5, 9) and s0.x9.dtype == torch.float32
    for name, got, want in zip(inp._fields, inp, jinp):
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape, name
        if name == "ext_force":
            got = got.numpy()
            np.testing.assert_array_equal(got.any(axis=(0, 2)), want.any(axis=(0, 2)), err_msg="push window")
            np.testing.assert_array_equal(got[..., 2], want[..., 2])
            assert not got[0::2, :, 1].any() and not got[1::2, :, 0].any()  # x on the even items, y on the odd
            ulp = np.spacing(np.float32(kw["push_max"]))
            np.testing.assert_allclose(got, want, rtol=0, atol=PUSH_ULPS * ulp, err_msg=name)
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    window = inp.ext_force.abs().sum(dim=(0, 2)) > 0
    assert window.nonzero().flatten().tolist() == list(range(5, 20))  # ticks int(0.01 / 0.002) to int(0.04 / 0.002)
    assert (inp.joypad[:, 0, 0] == 0).all() and (inp.joypad[:, 25:, 0] == 0.5).all()  # the ramp


def metrics_vs_jax(jctl, tctl, s0, inputs, template):
    """(the port's, JAX's) per-scenario metrics in f64 from the port's state
    s0 and inputs, converted for JAX; template: JAX's initial state, for the
    leaves the port does not carry."""
    got = TS._episode_metrics(tctl, s0, inputs, 0)
    with jax.enable_x64(True):
        js0 = to_jax(convert.loop_state_to_numpy(s0), template, s0.t.shape[0])
        jinp = JL.TickInput(*(jnp.asarray(a.numpy()) for a in inputs))
        want = np_tree(JS._episode_metrics(jctl, js0, jinp, 0))
    return got, want


def check_episode_metrics(got, want):
    """Each metric within F64_TOL of max(1, |JAX's|), `finite` identical."""
    for name, g, w in zip(METRICS, got, want):
        assert g.shape == w.shape, name
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=F64_TOL * max(1.0, np.abs(w).max()), err_msg=name)


def check_shard_metrics(jctl, tctl, metrics, up_thresh, model_guards):
    """_shard_metrics' thresholds and statistics in both packages on the
    metrics (port's, JAX's), each package's _episode_metrics returning its
    own: survival identical, the statistics within F64_TOL. Returns the
    survived mask."""
    got_m, want_m = metrics
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TS, "_episode_metrics", lambda *a: got_m)
        mp.setattr(JS, "_episode_metrics", lambda *a: tuple(jnp.asarray(w) for w in want_m))
        survived, stats = TS._shard_metrics(tctl, None, None, False, 0, up_thresh, model_guards)
        with jax.enable_x64(True):
            jsurv, jstats = JS._shard_metrics(jctl, None, None, False, 0, up_thresh, model_guards)
    np.testing.assert_array_equal(survived.numpy(), np.asarray(jsurv))
    assert set(stats) == set(jstats)
    for name, v in stats.items():
        assert abs(float(v) - float(jstats[name])) <= F64_TOL, name
    return survived


@pytest.fixture(scope="module")
def metrics(ctls, blocked):
    jctl, tctl = ctls["f64"]
    with jax.enable_x64(True):
        _, template = jax_initial_state(jctl, jnp.float64)
    return metrics_vs_jax(jctl, tctl, *blocked["f64"][:2], template)


def test_episode_metrics_match_jax(metrics):
    check_episode_metrics(*metrics)
    supp_dev, _, track_err = metrics[0][:3]
    assert supp_dev.min() > 0 and track_err.min() > 0  # the support and tracking deviations moved


@pytest.mark.parametrize("up_thresh,model_guards", SETTINGS)
def test_shard_metrics_match_jax(ctls, metrics, up_thresh, model_guards):
    check_shard_metrics(*ctls["f64"], metrics, up_thresh, model_guards)


def test_chunked_equals_unchunked(ctls):
    """B = 4 in chunks of 2 against one batch: the same per-item metrics;
    a batch that does not divide into chunks raises."""
    _, tctl = ctls["f64"]
    s0, inputs = TS.build_scenarios(tctl, 4, 0.06, dtype=torch.float64, **SCENARIO)
    whole = TS._episode_metrics(tctl, s0, inputs, 0)
    chunked = TS._episode_metrics(tctl, s0, inputs, 2)
    for name, a, b in zip(METRICS, whole, chunked):
        assert a.shape == (4,) and torch.equal(a, b), name
    with pytest.raises(ValueError, match="chunks of 3"):
        TS._episode_metrics(tctl, s0, inputs, 3)


MESH_SCRIPT = r"""
import json, sys
import torch
import torch.distributed as dist
import chip_smoke
from cmw_tpu_torch import convert
from cmw_tpu_torch.cmpc import ergocub_mpc_config
from cmw_tpu_torch.core import kinematics
from cmw_tpu_torch.dist import sweep
from cmw_tpu_torch.runtime import loop
from cmw_tpu_torch.runtime.config import ergocub_gazebo_v1

world, rank, init, scenario = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], json.loads(sys.argv[4])
torch.set_num_threads(1)
weights = convert.mann_weights_from_numpy(chip_smoke.lifted(chip_smoke.synthetic_mann_numpy()), device="cpu")
ctl = loop.WalkingController(ergocub_gazebo_v1(mpc=ergocub_mpc_config(horizon=0.6)), kinematics.ergocub_urdf(),
                             weights, device="cpu")
if world:
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
try:
    out = sweep.run_sweep(ctl, 4, 0.06, use_mesh=bool(world), per_scenario=True, **scenario)
finally:
    if world:
        dist.destroy_process_group()
print("RESULT", json.dumps(out))
"""


def test_mesh_equals_one_process(tmp_path):
    """run_sweep at B = 4 over one MPC period (f32, every scenario's
    survival in the summary) on two gloo ranks (file:// rendezvous), each
    running 2 of the scenarios, and in one process without a group: the
    same summary on both ranks and alone."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    init = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, PYTHONPATH=root)
    runs = ((2, 0), (2, 1), (0, 0))  # (world, rank); world 0: no process group
    procs = [subprocess.Popen([sys.executable, "-c", MESH_SCRIPT, str(world), str(rank), init, json.dumps(SCENARIO)],
                              cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for world, rank in runs]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
    ranks0, rank1, alone = (json.loads(out.split("RESULT ", 1)[1]) for out, _ in outs)
    assert ranks0 == rank1 == alone
    assert len(alone["survived_mask"]) == 4 and alone["batch"] == 4


def test_mesh_needs_a_process_group(ctls):
    _, tctl = ctls["f64"]
    with pytest.raises(RuntimeError, match="process group"):
        TS.run_sweep(tctl, 2, 0.06, use_mesh=True)

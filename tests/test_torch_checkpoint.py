"""Checkpoints of the port's loop state (`cmw_tpu_torch.runtime.checkpoint`):
an episode split at an MPC tick through a file equals the straight episode
bit for bit, on the kinematic and the rigid-body plant (the loop tests'
configuration, B = 2, pushed, f32), and a round trip restores every leaf's
dtype, shape and values, the `None` of the kinematic plant's rigid body, the
plant's noise generator and the metadata; a file of another layout is
refused."""

import numpy as np
import pytest
import torch

import chip_smoke
from cmw_tpu_torch import convert
from cmw_tpu_torch.cmpc import ergocub_mpc_config
from cmw_tpu_torch.core import kinematics as TK
from cmw_tpu_torch.dist.sweep import build_scenarios
from cmw_tpu_torch.runtime import checkpoint
from cmw_tpu_torch.runtime import loop as TL
from cmw_tpu_torch.runtime.config import ergocub_gazebo_v1
from cmw_tpu_torch.sim.rigid_body import RigidBodyConfig
from test_torch_sweep import assert_trees_equal

torch.set_num_threads(2)

PLANTS = {"kinematic": {}, "rigid": dict(rigid=RigidBodyConfig(), rigid_settle_s=0.01)}
SCENARIO = dict(push_max=6.0, push_duration=0.06, vx=0.5, push_t0=0.02)  # pushed across the split


def controller(plant):
    weights = convert.mann_weights_from_numpy(chip_smoke.lifted(chip_smoke.synthetic_mann_numpy()), device="cpu")
    cfg = ergocub_gazebo_v1(mpc=ergocub_mpc_config(horizon=0.6), **PLANTS[plant])
    return TL.WalkingController(cfg, TK.ergocub_urdf(), weights, device="cpu")


@pytest.mark.parametrize("plant", list(PLANTS))
def test_split_episode_equals_straight(tmp_path, plant):
    """60 ticks straight, and 30 ticks, a checkpoint, a load into a fresh
    initial state, 30 ticks: the second half's telemetry and the final state
    bit for bit."""
    ctl = controller(plant)
    s0, inputs = build_scenarios(ctl, 2, 0.12, **SCENARIO)
    first, second = (TL.TickInput(*(a[:, sl] for a in inputs)) for sl in (slice(0, 30), slice(30, 60)))
    s_end, tel = ctl.run_episode(s0, inputs)
    s_mid, _ = ctl.run_episode(s0, first)
    path = str(tmp_path / "state.npz")
    checkpoint.save(path, s_mid, meta={"t": float(s_mid.t[0])})
    resumed = checkpoint.load(path, ctl.initial_state(2))
    assert int(resumed.tick[0]) == 30 and checkpoint.load_meta(path) == {"t": float(s_mid.t[0])}
    s_split, tel_split = ctl.run_episode(resumed, second)
    assert_trees_equal(TL.Telemetry(*(a[:, 30:] for a in tel)), tel_split)
    assert_trees_equal(s_end, s_split)
    assert (s_split.rb is None) == (plant == "kinematic")
    assert inputs.ext_force[:, 25:35].abs().max() > 0  # the push spans the split


def test_round_trip(tmp_path):
    """Every leaf restored (dtype, shape, values, the template's device), the
    None leaf kept, the noise generator's state carried; a checkpoint of a
    rigid-plant state does not load into a kinematic template."""
    ctl = controller("kinematic")
    s = ctl.initial_state(3, dtype=torch.float64)
    s.plant.rng.manual_seed(11)
    torch.randn(5, generator=s.plant.rng)  # advance the stream past its seed
    path = str(tmp_path / "kin.npz")
    checkpoint.save(path, s)
    back = checkpoint.load(path, ctl.initial_state(1))  # the template's batch and dtype do not matter
    assert back.rb is None and checkpoint.load_meta(path) == {}
    assert_trees_equal(s, back)  # dtypes, shapes and values
    np.testing.assert_array_equal(torch.randn(4, generator=back.plant.rng, dtype=torch.float64).numpy(),
                                  torch.randn(4, generator=s.plant.rng, dtype=torch.float64).numpy())
    assert back.tick.dtype == torch.long and back.t.dtype == torch.float64 and back.q.shape == (3, TK.ergocub_urdf().nj)
    rigid = s._replace(rb=controller("rigid").initial_state(3, dtype=torch.float64).rb)
    checkpoint.save(str(tmp_path / "rigid.npz"), rigid)
    with pytest.raises(ValueError, match="layout"):
        checkpoint.load(str(tmp_path / "rigid.npz"), s)

"""The sweep's metrics on the rigid-body plant: `_episode_metrics` and
`_shard_metrics` of `cmw_tpu_torch.dist.sweep` against `cmw_tpu.dist.sweep`
in f64 on the same converted state and inputs, at the rigid loop tests'
configuration (ergocub_gazebo_v1(rigid=RigidBodyConfig(),
mpc=ergocub_mpc_config(horizon=0.6), rigid_settle_s=0.01), the synthetic
MANN weights whose left foot swings), B = 2 over 2 MPC periods, the
joystick ramped in and both items pushed hard over the first period; both
threshold settings (the standing one, and up_thresh 0.7 without the model
guards). JAX's blocked episode of the rigid stages compiles in ~1-2 min on
a 2-core host."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from cmw_tpu.cmpc import formulation as JF
from cmw_tpu.runtime import config as JCfg
from cmw_tpu.sim import rigid_body as JRB
from cmw_tpu_torch import convert
from cmw_tpu_torch.dist import sweep as TS
from cmw_tpu_torch.runtime import config as TCfg
from cmw_tpu_torch.sim import rigid_body as TRB
from test_torch_runtime import HORIZON, controllers, jax_initial_state
from test_torch_sweep import SETTINGS, check_episode_metrics, check_shard_metrics, metrics_vs_jax

torch.set_num_threads(2)

SETTLE_S = 0.01  # 5 WBC ticks of settling in initial_state (tests/test_torch_rigid_loop.py)
# 12 m/s^2 over the first MPC period (~0.7 m/s of impulse, the CLI sweep's
# largest: 2 m/s^2 for 0.4 s), item 0 back against its forward stick, item 1
# sideways; the stick ramped in over 0.05 s
SCENARIO = dict(push_max=12.0, push_duration=0.06, vx=0.5, ramp=0.05, push_t0=0.0)


@pytest.fixture(scope="module")
def rig():
    jcfg = JCfg.ergocub_gazebo_v1(mpc=JF.ergocub_mpc_config(horizon=HORIZON), rigid=JRB.RigidBodyConfig(),
                                  rigid_settle_s=SETTLE_S)
    tcfg = TCfg.ergocub_gazebo_v1(mpc=convert.config_from_dict(dataclasses.asdict(jcfg.mpc)),
                                  rigid=TRB.RigidBodyConfig(), rigid_settle_s=SETTLE_S)
    jctl, tctl = controllers({"jax": jcfg, "port": tcfg})["f64"]
    s0, inputs = TS.build_scenarios(tctl, 2, 0.12, dtype=torch.float64, **SCENARIO)
    with jax.enable_x64(True):
        _, template = jax_initial_state(jctl, jnp.float64)
    return jctl, tctl, metrics_vs_jax(jctl, tctl, s0, inputs, template)


def test_rigid_episode_metrics_match_jax(rig):
    _, _, metrics = rig
    check_episode_metrics(*metrics)
    got = dict(zip(("supp_dev", "z_dev", "track_err", "finite", "up_min", "bz_min", "zb0"), metrics[0]))
    assert (got["up_min"] < 1.0).all() and (got["bz_min"] < got["zb0"]).all()  # the physical base tilted and sank


@pytest.mark.parametrize("up_thresh,model_guards", SETTINGS)
def test_rigid_shard_metrics_match_jax(rig, up_thresh, model_guards):
    jctl, tctl, metrics = rig
    check_shard_metrics(jctl, tctl, metrics, up_thresh, model_guards)

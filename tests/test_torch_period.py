"""The port's blocked and folded episodes, which run each MPC period with
the generator called for the whole batch and each item keeping its choice
(`WalkingController._period`), against JAX's `run_episode_blocked` under
vmap (its per-item `lax.cond` a select), in f64 on the CPU at B = 2.

The sim preset with the MANN gait slowed 2.5x (mannCallingTime lcm(50, 60)
ms = 300 ms: a generator call every 5th MPC tick, mann_advance 6), the WBC at
12 ms (mpc_every 5) and the short horizon (0.6 s), on the synthetic weights
whose left foot swings: six MPC periods in 30 ticks, the generator called
at the first and the sixth. Held within F64_TOL of max(1, |value|), the
contact flags exactly, as tests/test_torch_runtime.py holds the episode:
the blocked telemetry and final state, the sweep's fold (`dist/sweep.fold`)
against the same fold over JAX's telemetry, and `run_episode` tick by tick
(its MPC stages without a call run `_mpc_post(called=False)`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cmw_tpu.cmpc import formulation as JF
from cmw_tpu.core import kinematics as JK
from cmw_tpu.mann import generator as JG
from cmw_tpu.runtime import config as JCfg
from cmw_tpu.runtime import loop as JL
from cmw_tpu_torch import convert
from cmw_tpu_torch.dist import sweep as TS
from cmw_tpu_torch.mann.generator import GeneratorConfig
from cmw_tpu_torch.runtime import config as TCfg
from cmw_tpu_torch.runtime import loop as TL
from test_torch_runtime import F64_TOL, W_LIFT, compare, jax_initial_state, jax_weights, np_tree, to_jax

torch.set_num_threads(2)

B = 2
S = 30  # six MPC periods
SLOW = 2.5
WBC_DT = 0.012


@pytest.fixture(scope="module")
def rig():
    """The port's controller and initial state, the joystick inputs, and
    JAX's blocked episode from the converted state."""
    with jax.enable_x64(True):
        jcfg = JCfg.ergocub_gazebo_v1(mpc=JF.ergocub_mpc_config(horizon=0.6),
                                      gen=JG.GeneratorConfig(slow_down_factor=SLOW), wbc_dt=WBC_DT)
        jm = JK.ergocub_urdf()
        jctl = JL.WalkingController(jcfg, jm, jax_weights(W_LIFT, jnp.float64))
        _, template = jax_initial_state(jctl, jnp.float64)
        tcfg = TCfg.ergocub_gazebo_v1(mpc=convert.config_from_dict(dataclasses.asdict(jcfg.mpc)),
                                      gen=GeneratorConfig(slow_down_factor=SLOW), wbc_dt=WBC_DT)
        tctl = TL.WalkingController(tcfg, convert.robot_model_from_numpy(jm),
                                    convert.mann_weights_from_numpy(W_LIFT, device="cpu", dtype=torch.float64),
                                    device="cpu")
        s0 = tctl.initial_state(B, dtype=torch.float64)
        joy = np.repeat(chip_smoke.joysticks(B, device="cpu").numpy().astype(np.float64)[:, None], S, axis=1)
        zeros = np.zeros((B, S, 3))
        jinp = JL.TickInput(*(jnp.asarray(a) for a in (joy, zeros, zeros)))
        jsN, jtel = jax.jit(jax.vmap(jctl.run_episode_blocked))(to_jax(convert.loop_state_to_numpy(s0), template, B),
                                                                jinp)
    tinp = TL.TickInput(*(torch.from_numpy(a) for a in (joy, zeros, zeros)))
    return dict(tctl=tctl, s0=s0, tinp=tinp, jsN=np_tree(jsN), jtel=np_tree(jtel))


def test_cadence(rig):
    tcfg = rig["tctl"].cfg
    assert (tcfg.mpc_every, tcfg.mann_call_every, tcfg.mann_advance) == (5, 5, 6)
    np.testing.assert_allclose(rig["jsN"].mann.t0, 5 * tcfg.mpc_every * WBC_DT)  # JAX's last call: the sixth period
    contact = rig["jtel"].foot_contact
    assert contact[:, :10, 0].min() == 1.0 and contact[:, 10:, 0].max() == 0.0  # the left foot lifts


def check_telemetry(got, jtel, ticks):
    for k in range(ticks):
        compare({n: v[:, k] for n, v in convert.solution_to_numpy(got).items()},
                jax.tree_util.tree_map(lambda a: a[:, k], jtel), F64_TOL, path=f"tick {k}")


@pytest.mark.parametrize("entry", ["blocked", "tick by tick"])
def test_episode_matches_jax(rig, entry):
    tctl = rig["tctl"]
    run = tctl.run_episode_blocked if entry == "blocked" else tctl.run_episode
    sN, tel = run(rig["s0"], rig["tinp"])
    check_telemetry(tel, rig["jtel"], S)
    compare(convert.loop_state_to_numpy(sN), rig["jsN"], F64_TOL)
    assert int(sN.tick[0]) == S


def test_fold_matches_jax(rig):
    """The sweep's fold through run_episode_fold against the same fold over
    JAX's telemetry, tick by tick."""
    tctl, s0 = rig["tctl"], rig["s0"]
    z = s0.x9[:, 2]
    acc0 = (z * 0, z * 0, z * 0, torch.ones_like(z, dtype=torch.bool), torch.ones_like(z), z + 10.0, z)
    sN, acc = tctl.run_episode_fold(s0, rig["tinp"], TS.fold, acc0)
    want = acc0
    for k in range(S):
        want = TS.fold(want, TL.Telemetry(*(torch.from_numpy(np.array(a[:, k])) for a in rig["jtel"])))
    for name, g, w in zip(("supp_dev", "z_dev", "track_err", "finite", "up_min", "bz_min", "z0"), acc, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert float((g.double() - w.double()).abs().max()) <= F64_TOL * max(1.0, float(w.double().abs().max())), name
    compare(convert.loop_state_to_numpy(sN), rig["jsN"], F64_TOL)

"""Port parity for the MPC tick of the walking controller, joystick -> MANN ->
MPC (cmw_tpu/runtime/loop.py:508-1053 on the kinematic plant, while
moving): `chip_smoke.mpc_tick` on the port against the same seven steps
composed from `cmw_tpu` under `jax.vmap`, at ergocub_mpc_config(horizon=0.6)
on the default (Riccati) path, f32 on the CPU. Two receding ticks from the
walk-ready start, each package carrying its own chain; on the synthetic
weights and on the variant whose left foot swings."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cmw_tpu.cmpc import CentroidalMPCSolver as JaxSolver
from cmw_tpu.cmpc import formulation as JF
from cmw_tpu.core import contacts as JC
from cmw_tpu.core import kinematics as JK
from cmw_tpu.core import lie as JL
from cmw_tpu.core.splines import linear_spline
from cmw_tpu.mann import generator as JG
from cmw_tpu.mann import input_builder as JIB
from cmw_tpu_torch import convert
from cmw_tpu_torch.cmpc import CentroidalMPCSolver
from cmw_tpu_torch.mann import generator as TG
from test_torch_mann import WEIGHTS, _jax_weights
from test_torch_solver import COST_RTOL, FORCE_ATOL, POS_ATOL, PRIM_MAX

torch.set_num_threads(2)

B = 2
REF_ATOL = 1e-5  # references and footstep poses from two f32 generator rollouts
# snap_to_grid's t / dt: under jit, XLA multiplies by the reciprocal of the
# constant instead, an f32 ulp away (64 s on an open phase's BIG_TIME)
TIME_RTOL = 2e-7


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_tick(jm, solver, gcfg, adv, w, gen_state, plan, warm, x0, t, joy, com_z_ref):
    """The seven steps for one item, in cmw_tpu (loop.py line by line)."""
    mpc = solver.cfg
    dtype = x0.dtype
    desired = JIB.build_desired_trajectory(joy[0:2], joy[2:4])  # loop.py:724
    _, outs, states = JG.generate_with_states(gcfg, jm, w, gen_state, desired)  # :785-790
    gen_next = jax.tree_util.tree_map(lambda a: a[adv - 1], states)
    gen_times = (jnp.arange(gcfg.n_steps, dtype=dtype) + 1.0) * (gcfg.dt * gcfg.slow_down_factor)  # :762
    flags = jnp.concatenate([gen_state.contact[None], outs.contact], axis=0)  # :794-812
    pose_tl = jnp.concatenate([gen_state.foot_pose_xy_yaw[None], outs.foot_pose_xy_yaw], axis=0)
    tl_times = t + jnp.concatenate([jnp.zeros(1, dtype), gen_times])
    foot_pos = jnp.concatenate([pose_tl[..., 0:2], jnp.zeros(pose_tl.shape[:-1] + (1,), dtype)], axis=-1)
    mann_plan = JC.plan_from_timeline(flags, tl_times, foot_pos, JL.rotz(pose_tl[..., 2]),
                                      P=chip_smoke.PLAN_PHASES)
    knot_times = jnp.arange(mpc.N, dtype=dtype) * mpc.dt  # :765, 831 (a call tick: offset 0)
    com_ref, _ = linear_spline(gen_times, outs.com, knot_times)
    com_ref = com_ref.at[:, 2].set(com_z_ref)  # :833
    L_ref, _ = linear_spline(gen_times, outs.ang_mom, knot_times)
    L_ref = L_ref * (1.0 / (jm.total_mass * gcfg.slow_down_factor))  # :852
    plan = JC.snap_to_grid(JC.merge_plans(mann_plan, plan, t), mpc.dt)  # :856-857
    stage = JC.mpc_stage_params(plan, t, mpc.T, mpc.dt, mpc.n_slots)  # :996-1009
    params = JF.MPCParams(x0=x0, com_ref=com_ref, ang_mom_ref=L_ref, stage=stage, ext_force=jnp.zeros(3, dtype),
                          ext_torque=jnp.zeros(3, dtype))
    sol = solver.solve(params, warm)
    plan = JC.write_back_adjusted(plan, t, mpc.n_slots, sol.positions, stage.slot_valid)  # :1012
    return (gen_next, plan, solver.warm_from(params, sol), sol.states[1], t + mpc.dt), sol, params


@pytest.fixture(scope="module")
def setup():
    jm = JK.ergocub_urdf()
    tm = convert.robot_model_from_numpy(jm)
    jcfg = JF.ergocub_mpc_config(horizon=0.6)
    js, ts = JaxSolver(jcfg), CentroidalMPCSolver(convert.config_from_dict(dataclasses.asdict(jcfg)))
    gcfg = JG.GeneratorConfig()
    adv = chip_smoke.mann_advance(gcfg, jcfg.dt)
    tick = jax.jit(jax.vmap(lambda w, *a: jax_tick(jm, js, gcfg, adv, w, *a),
                            in_axes=(None, 0, 0, 0, 0, 0, 0, 0)))
    return jm, tm, js, ts, adv, tick


@pytest.mark.parametrize("wname", list(WEIGHTS))
def test_mann_mpc_ticks_match_jax(setup, wname):
    jm, tm, js, ts, adv, tick = setup
    W = WEIGHTS[wname]
    tw = convert.mann_weights_from_numpy(W, device="cpu")
    joy = chip_smoke.joysticks(B, device="cpu")
    chain, z_ref = chip_smoke.walk_ready_chain(ts, tm, TG.GeneratorConfig(), B, device="cpu")
    # the JAX side starts from the same chain
    jchain = (JG.GeneratorState(**convert.generator_state_to_numpy(chain.gen)),
              JC.ContactPlan(**convert.solution_to_numpy(chain.plan)),
              jax.vmap(lambda _: js.cold_start())(jnp.arange(B)), chain.x0.numpy(), chain.t.numpy())
    jw = _jax_weights(W, jnp.float32)
    for k in range(2):
        chain, sol, params = chip_smoke.mpc_tick(ts, TG.GeneratorConfig(), tm, tw, chain, joy, z_ref, adv)
        jchain, jsol, jparams = tick(jw, *jchain, joy.numpy(), z_ref.numpy())
        g, w = convert.solution_to_numpy(sol), _np(jsol)._asdict()
        np.testing.assert_allclose(g["cost"], w["cost"], rtol=COST_RTOL, err_msg=f"tick {k}")
        assert g["prim_res"].max() < PRIM_MAX and w["prim_res"].max() < PRIM_MAX
        np.testing.assert_allclose(g["forces"], w["forces"], atol=FORCE_ATOL, err_msg=f"tick {k}")
        np.testing.assert_allclose(g["positions"], w["positions"], atol=POS_ATOL, err_msg=f"tick {k}")
        np.testing.assert_allclose(params.com_ref.numpy(), np.asarray(jparams.com_ref), atol=REF_ATOL)
        np.testing.assert_allclose(params.ang_mom_ref.numpy(), np.asarray(jparams.ang_mom_ref), atol=REF_ATOL)
        for name in ("active", "slot_onehot", "slot_valid", "slot_adjustable"):
            np.testing.assert_array_equal(getattr(params.stage, name).numpy(), np.asarray(getattr(jparams.stage, name)),
                                          err_msg=f"tick {k} {name}")
        for name in ("slot_act", "slot_deact"):
            np.testing.assert_allclose(getattr(params.stage, name).numpy(), np.asarray(getattr(jparams.stage, name)),
                                       rtol=TIME_RTOL, atol=0, err_msg=f"tick {k} {name}")
        # the next chain: the re-rooted generator state, the written-back plan
        jgen, jplan = _np(jchain[0]), _np(jchain[1])
        np.testing.assert_array_equal(chain.gen.contact.numpy(), jgen.contact)
        np.testing.assert_allclose(chain.gen.q.numpy(), jgen.q, atol=REF_ATOL)
        np.testing.assert_array_equal(chain.plan.valid.numpy(), jplan.valid)
        for name in ("act", "deact"):
            np.testing.assert_allclose(getattr(chain.plan, name).numpy(), getattr(jplan, name), rtol=TIME_RTOL, atol=0,
                                       err_msg=name)
        np.testing.assert_allclose(chain.plan.pos.numpy(), jplan.pos, atol=POS_ATOL)
        np.testing.assert_allclose(chain.t.numpy(), np.asarray(jchain[4]), rtol=0, atol=0)
    if wname == "lift":  # the left foot swings: one contact on the later intervals
        assert float(params.stage.active[:, 0, 1:].max()) == 0.0 and float(params.stage.active[:, 1].min()) == 1.0

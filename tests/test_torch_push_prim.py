"""The fused MPC stage under a 12 m/s^2 push, the port against JAX, at the
production configuration of the rigid-plant loop
(ergocub_gazebo_v1(rigid=RigidBodyConfig(), mpc=ergocub_mpc_config(
kkt_impl="dense", admm_impl="fused")), f32 on the CPU, JAX's fused kernel in
interpret mode), on the synthetic lifted weights at B = 2, from the port's
settled rigid state converted to JAX's (a 0.05 s settle):

  - tick 0 with the push on (item 0: 12 m/s^2 against its stick; item 1:
    (6, -10) m/s^2), tick 0 without it, and tick 30 after a pushed MPC
    period: each package's `_mpc_stage` on the same state and input.

The 24 ADMM iterations end far from feasibility under the push (mpc_prim
~0.19 on item 0, ~2e-3 unpushed): this is the reference's own figure, and
the port's agrees with it within the solver tests' tolerances. The test
prints both packages' mpc_prim."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cmw_tpu.cmpc import formulation as JF
from cmw_tpu.runtime import config as JCfg
from cmw_tpu.runtime import loop as JL
from cmw_tpu.sim import rigid_body as JRB
from cmw_tpu_torch import convert
from cmw_tpu_torch.runtime import config as TCfg
from cmw_tpu_torch.runtime import loop as TL
from cmw_tpu_torch.sim import rigid_body as TRB
from test_torch_runtime import controllers, jax_initial_state, np_tree, to_jax

torch.set_num_threads(2)

B = 2
PUSH = np.array([[-12.0, 0.0, 0.0], [6.0, -10.0, 0.0]])  # tests/test_torch_rigid_loop.py's, mass-normalised
SETTLE_S = 0.05
PRIM_ATOL = 1e-4
COST_RTOL = 2e-3  # tests/test_torch_solver.py


@pytest.fixture(scope="module")
def rig():
    jcfg = JCfg.ergocub_gazebo_v1(mpc=JF.ergocub_mpc_config(kkt_impl="dense", admm_impl="fused"),
                                  rigid=JRB.RigidBodyConfig(), rigid_settle_s=SETTLE_S)
    tcfg = TCfg.ergocub_gazebo_v1(mpc=convert.config_from_dict(dataclasses.asdict(jcfg.mpc)),
                                  rigid=TRB.RigidBodyConfig(), rigid_settle_s=SETTLE_S)
    jctl, tctl = controllers({"jax": jcfg, "port": tcfg})["f32"]
    joy = chip_smoke.joysticks(B, device="cpu").numpy()

    def inp(push):
        j = JL.TickInput(*(jnp.asarray(a, jnp.float32) for a in (joy, push, np.zeros((B, 3)))))
        return convert.tick_input_from_numpy(np_tree(j), device="cpu", dtype=torch.float32), j

    s0 = tctl.initial_state(B, dtype=torch.float32)
    _, template = jax_initial_state(jctl, jnp.float32)
    pushed, still = inp(PUSH), inp(np.zeros((B, 3)))
    S = tcfg.mpc_every
    period = TL.TickInput(*(a[:, None].expand(B, S, *a.shape[1:]).contiguous() for a in pushed[0]))
    s30, _ = tctl.run_episode(s0, period)
    return dict(tctl=tctl, jmpc=jax.jit(jax.vmap(jctl._mpc_stage)), template=template,
                cases={"tick 0 pushed": (s0, pushed), "tick 0 unpushed": (s0, still), "tick 30": (s30, still)})


@pytest.mark.parametrize("case", ["tick 0 pushed", "tick 0 unpushed", "tick 30"])
def test_pushed_fused_mpc_stage_matches_jax(rig, case):
    s, (tinp, jinp) = rig["cases"][case]
    got = rig["tctl"]._mpc_stage(s, tinp)
    want = rig["jmpc"](to_jax(convert.loop_state_to_numpy(s), rig["template"], B), jinp)
    prim, jprim = got.mpc_prim.numpy(), np.asarray(want.mpc_prim)
    print(f"{case}: mpc_prim port {prim.tolist()} JAX {jprim.tolist()}; cost port {got.mpc_cost.tolist()} "
          f"JAX {np.asarray(want.mpc_cost).tolist()}")
    np.testing.assert_allclose(prim, jprim, atol=PRIM_ATOL)
    np.testing.assert_allclose(got.mpc_cost.numpy(), np.asarray(want.mpc_cost), rtol=COST_RTOL)
    if case == "tick 0 pushed":
        assert jprim[0] > 0.1  # JAX's own: the 24 iterations do not reach feasibility under the push

"""Port dense solve vs the independent numpy/scipy f64 oracle
(`cmw_tpu.cmpc.oracle`, imported here only), at horizon 0.6 with
sqp 10 x admm 150 so that both sides are at convergence: the port's cost
must be within 1% of the oracle's (tests/test_cmpc.py:67-111)."""

import numpy as np
import pytest
import torch

from cmw_tpu.cmpc import oracle
from cmw_tpu_torch.cmpc import CentroidalMPCSolver, MPCParams, ergocub_mpc_config
from cmw_tpu_torch.core import contacts

torch.set_num_threads(2)

COST_RTOL = 0.01


def standing_plan():
    """Both feet in contact forever at +-0.08 m."""
    plan = contacts.empty_plan(nc=2, P=8, device="cpu")
    act, deact, pos, valid = plan.act.clone(), plan.deact.clone(), plan.pos.clone(), plan.valid.clone()
    act[:, 0] = 0.0
    deact[:, 0] = 1e6
    pos[0, 0] = torch.tensor([0.0, 0.08, 0.0])
    pos[1, 0] = torch.tensor([0.0, -0.08, 0.0])
    valid[:, 0] = 1.0
    return plan._replace(act=act, deact=deact, pos=pos, valid=valid)


def make_params(cfg, plan, t0, com0, drift, push):
    stage = contacts.mpc_stage_params(plan, t0, cfg.T, cfg.dt, cfg.n_slots)
    N = cfg.N
    com_ref = torch.tensor([0.0, 0.0, 0.7]).expand(N, 3) + drift * cfg.dt * torch.arange(N)[:, None] * torch.tensor(
        [1.0, 0.0, 0.0]
    )
    params = MPCParams(
        x0=torch.cat([torch.tensor(com0), torch.zeros(6)]),
        com_ref=com_ref,
        ang_mom_ref=torch.zeros(N, 3),
        stage=stage,
        ext_force=torch.tensor(push),
        ext_torque=torch.zeros(3),
    )
    return params


@pytest.mark.parametrize("scenario", ["standing", "walking_push"])
def test_dense_solve_matches_oracle(scenario):
    cfg = ergocub_mpc_config(horizon=0.6, sqp_iters=10, admm_iters=150, kkt_impl="dense")
    if scenario == "standing":
        p = make_params(cfg, standing_plan(), 0.0, [0.03, 0.01, 0.69], 0.0, [0.0, 0.0, 0.0])
    else:
        plan = contacts.snap_to_grid(contacts.make_alternating_gait(n_steps=8, device="cpu"), cfg.dt)
        p = make_params(cfg, plan, 1.02, [0.0, 0.0, 0.7], 0.08, [0.0, 1.0, 0.0])
    solver = CentroidalMPCSolver(cfg)
    batched = MPCParams(*[a[None] for a in p[:3]], type(p.stage)(*[a[None] for a in p.stage]),
                        p.ext_force[None], p.ext_torque[None])
    sol = solver.solve(batched, solver.cold_start(1, device="cpu"))
    z_o, c_o, res = oracle.solve_oracle(cfg, p)
    assert res.status == 0, res.message
    cost = float(sol.cost[0])
    assert abs(cost - c_o) <= COST_RTOL * abs(c_o) + 1e-6, (cost, c_o)
    assert float(sol.prim_res[0]) < 1e-2
    # adjusted footsteps agree to 2 mm (tests/test_cmpc.py:107-111)
    _, Po = oracle._unpack(cfg, z_o)
    adj = (p.stage.slot_adjustable * p.stage.slot_valid)[..., None].numpy()
    np.testing.assert_allclose(sol.positions[0].numpy() * adj, Po * adj, atol=2e-3)

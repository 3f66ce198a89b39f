"""The port's copy of the scipy-f64 oracle (`cmw_tpu_torch.cmpc.oracle`) and
its solver-parity command line (`cmw_tpu_torch.apps.parity`) on the CPU:

  - the copy gives exactly what `cmw_tpu.cmpc.oracle` gives (both numpy in
    f64 on the same values): the rollout, the cost and an SLSQP solve on one
    item of the port's params and on the JAX params it came from;
  - `apps.parity.main(["--cpu"])` gives parity_ok true (every cost ratio at
    most 1.02, every oracle status 0) with the keys the JAX CLI prints (the
    JAX CLI run at a 0.3 s horizon, where it compiles in seconds: the keys do
    not depend on the horizon)."""

import json

import jax
import numpy as np
import torch

from cmw_tpu.apps import parity as JParity
from cmw_tpu.cmpc import oracle as joracle
from cmw_tpu_torch.apps import parity
from cmw_tpu_torch.cmpc import CentroidalMPCSolver, ergocub_mpc_config, oracle
from cmw_tpu_torch.core import contacts
from test_torch_oracle import make_params

torch.set_num_threads(2)


def test_oracle_copy_equals_jax_oracle():
    cfg = ergocub_mpc_config(horizon=0.3)
    plan = contacts.snap_to_grid(contacts.make_alternating_gait(n_steps=8, device="cpu"), cfg.dt)
    p = make_params(cfg, plan, 1.02, [0.0, 0.0, 0.7], 0.08, [0.0, 1.0, 0.0])
    rng = np.random.default_rng(0)
    F = rng.standard_normal((cfg.T, cfg.n_contacts, cfg.n_corners, 3))
    P = rng.standard_normal((cfg.n_contacts, cfg.n_slots, 3))
    np.testing.assert_array_equal(oracle.rollout_np(cfg, p, F, P), joracle.rollout_np(cfg, p, F, P))
    z = np.concatenate([F.ravel(), P.ravel()])
    assert oracle.cost_np(cfg, p, z) == joracle.cost_np(cfg, p, z)
    z_o, c_o, res = oracle.solve_oracle(cfg, p, maxiter=20)
    z_j, c_j, res_j = joracle.solve_oracle(cfg, p, maxiter=20)
    np.testing.assert_array_equal(z_o, z_j)
    assert c_o == c_j and res.status == res_j.status
    # the port's one-item params read from a batched solve's inputs
    solver = CentroidalMPCSolver(cfg)
    assert np.isfinite(float(solver.solve(type(p)(*[a[None] for a in p[:3]], type(p.stage)(*[a[None] for a in p.stage]),
                                                    p.ext_force[None], p.ext_torque[None]),
                                          solver.cold_start(1, device="cpu")).cost[0]))


def test_parity_cli_on_the_cpu(capsys):
    out = parity.main(["--cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    assert out["parity_ok"], out
    assert [c["case"] for c in out["cases"]] == ["standing_offset", "walking", "walking_push"]
    JParity.main(["--cpu", "--horizon", "0.3", "--sqp-iters", "2", "--admm-iters", "10"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == set(want)
    assert [set(c) for c in out["cases"]] == [set(c) for c in want["cases"]]
    assert jax.default_backend() == "cpu"

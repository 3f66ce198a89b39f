"""Capture safety of the graphed functions (`runtime/cache.py`) on the CPU.

Inside a CUDA graph's capture nothing may make a tensor from host data (a
pageable host-to-device copy is not legal while a stream captures, and would
replay a stale host buffer) or read the card (a sync). After one warm-up
call, which fills the constant caches as the cache's warm-up does, a second
call of each graphed function runs with `torch.tensor` / `torch.as_tensor`
on non-tensor data, and `Tensor.item`, `.cpu`, `.tolist`, `.numpy` and the
conversions to bool, int and float, made to raise: the solve on the Riccati,
dense and fused paths, the rigid plant's `dynamics_step`, the WBC stage,
the MPC stage's two halves (`_mpc_pre`, `_mpc_post` with the generator
called and not) and one MPC period through `run_episode_blocked` and
`run_episode_fold` on both plants, and the generator's rollout
(`generate_with_states`), at T = 20 and B = 2. Syncs inside library calls
(a status check on the card) are not visible here; phase 14 of
chip_smoke.py captures each function on the card."""

import contextlib

import pytest
import torch

import chip_smoke
from cmw_tpu_torch import convert
from cmw_tpu_torch.apps import bench as BENCH
from cmw_tpu_torch.cmpc import CentroidalMPCSolver, ergocub_mpc_config
from cmw_tpu_torch.core import kinematics as TK
from cmw_tpu_torch.dist import sweep as TS
from cmw_tpu_torch.mann import generator as G
from cmw_tpu_torch.mann.input_builder import build_desired_trajectory
from cmw_tpu_torch.runtime import loop
from cmw_tpu_torch.runtime.config import ergocub_gazebo_v1
from cmw_tpu_torch.sim import rigid_body as RB

torch.set_num_threads(2)

B = 2
READS = ("item", "cpu", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__")


@contextlib.contextmanager
def no_host_data():
    def from_host(name, make):
        def guarded(data, *args, **kwargs):
            if not isinstance(data, torch.Tensor):
                raise AssertionError(f"torch.{name} made a tensor from host data ({type(data).__name__})")
            return make(data, *args, **kwargs)
        return guarded

    def read(name):
        def guarded(self, *args, **kwargs):
            raise AssertionError(f"Tensor.{name} read a tensor back")
        return guarded

    with pytest.MonkeyPatch.context() as mp:
        for name in ("tensor", "as_tensor"):
            mp.setattr(torch, name, from_host(name, getattr(torch, name)))
        for name in READS:
            mp.setattr(torch.Tensor, name, read(name))
        yield


def test_guard_raises():
    with no_host_data():
        for bad in (lambda: torch.tensor(1.0), lambda: torch.as_tensor((1.0, 2.0)), lambda: torch.ones(2).tolist(),
                    lambda: bool(torch.ones(1)), lambda: float(torch.ones(())), lambda: torch.ones(1).item()):
            with pytest.raises(AssertionError):
                bad()
        torch.as_tensor(torch.ones(2), dtype=torch.float64)  # a tensor in: no host data


def twice(fn):
    fn()
    with no_host_data():
        fn()


@pytest.mark.parametrize("path", [{}, {"kkt_impl": "dense"}, {"kkt_impl": "dense", "admm_impl": "fused"}],
                         ids=["riccati", "dense", "fused"])
def test_solve(path):
    cfg = ergocub_mpc_config(**path)
    solver = CentroidalMPCSolver(cfg)
    params = BENCH.make_params(cfg, BENCH.lateral_pushes(B), device="cpu")
    warm = solver.warm_from(params, solver.solve(params, solver.cold_start(B, device="cpu")))
    twice(lambda: solver.solve(params, warm))


@pytest.fixture(scope="module")
def ticks():
    """Per plant: the controller, its state after the tick-0 MPC stage, the
    tick's input, and the initial state (at the tick-0 MPC stage)."""
    weights = convert.mann_weights_from_numpy(chip_smoke.synthetic_mann_numpy(), device="cpu")
    model = TK.ergocub_approx()
    inp = loop.TickInput(*(a[:, 0] for a in loop.constant_inputs(1, batch=B, device="cpu")))
    out = {}
    for plant, rigid in (("kinematic", None), ("rigid", RB.RigidBodyConfig())):
        ctl = loop.WalkingController(ergocub_gazebo_v1(rigid=rigid, rigid_settle_s=0.01), model, weights, device="cpu")
        s0 = ctl.initial_state(B)
        out[plant] = ctl, ctl._mpc_stage(s0, inp), inp, s0
    return out


def test_dynamics_step(ticks):
    ctl, s, inp, _ = ticks["rigid"]
    twice(lambda: RB.dynamics_step(ctl.cfg.rigid, ctl.model, s.rb, s.q, ctl.cfg.wbc_dt,
                                   ext_force_base=inp.ext_force * ctl.mass))


@pytest.mark.parametrize("plant", ["kinematic", "rigid"])
def test_wbc_stage(ticks, plant):
    ctl, s, inp, _ = ticks[plant]
    twice(lambda: ctl._wbc_stage(s, inp))


def test_generate_with_states(ticks):
    ctl, s, inp, _ = ticks["kinematic"]
    desired = build_desired_trajectory(inp.joypad[:, 0:2], inp.joypad[:, 2:4], ctl.cfg.input_builder)
    twice(lambda: G.generate_with_states(ctl.cfg.gen, ctl.model, ctl._weights_as(s.x9), s.gen_state, desired))


@pytest.mark.parametrize("plant", ["kinematic", "rigid"])
def test_mpc_pre(ticks, plant):
    ctl, _, inp, s0 = ticks[plant]
    twice(lambda: ctl._mpc_pre(s0, inp))


@pytest.mark.parametrize("called", [True, False])
@pytest.mark.parametrize("plant", ["kinematic", "rigid"])
def test_mpc_post(ticks, plant, called):
    ctl, _, inp, s0 = ticks[plant]
    pre = ctl._mpc_pre(s0, inp)
    twice(lambda: ctl._mpc_post(s0, inp, pre, called))


@pytest.mark.parametrize("entry", ["blocked", "fold"])
@pytest.mark.parametrize("plant", ["kinematic", "rigid"])
def test_period(ticks, plant, entry, monkeypatch):
    """One MPC period; the episode's precondition check reads s0's tick
    once before any period, so the guarded call is handed it."""
    ctl, _, _, s0 = ticks[plant]
    inputs = loop.constant_inputs(ctl.cfg.mpc_every, (0.3, 0.0, 1.0, 0.0), batch=B, device="cpu")
    if entry == "blocked":
        run = lambda: ctl.run_episode_blocked(s0, inputs)  # noqa: E731
    else:
        z = s0.x9[:, 2]
        acc0 = (z * 0, z * 0, z * 0, torch.ones_like(z, dtype=torch.bool), torch.ones_like(z), z + 10.0, z)
        run = lambda: ctl.run_episode_fold(s0, inputs, TS.fold, acc0)  # noqa: E731
    run()
    monkeypatch.setattr(ctl, "_blocked_tick", lambda s, i: 0)
    with no_host_data():
        run()

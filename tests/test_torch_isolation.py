"""The port runs without JAX: importing `cmw_tpu_torch` (and `chip_smoke.py`),
running a solve, a MANN rollout, a few ticks of the walking controller, a
step of the rigid-body plant, a push sweep at B = 2 over one MPC period, a
checkpoint round trip, importing the command-line entry points, the ini
loader, the oracle copies (the MPC's, the MANN generator's and its ONNX
interpreter's), the parity CLI at a short horizon, the real-time walker's
two tasks, the native runtime, the joypad, `entry()` and one scaling
measurement on one gloo rank, loads neither `jax` nor the JAX package
`cmw_tpu`."""

import os
import subprocess
import sys

SCRIPT = r"""
import sys
import torch
import cmw_tpu_torch
from cmw_tpu_torch.cmpc import CentroidalMPCSolver, MPCParams, ergocub_mpc_config
from cmw_tpu_torch.core import contacts

torch.set_num_threads(1)
assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
cfg = ergocub_mpc_config(horizon=0.6, kkt_impl="dense")
plan = contacts.snap_to_grid(contacts.make_alternating_gait(n_steps=8, device="cpu"), cfg.dt)
stage = contacts.mpc_stage_params(plan, 1.02, cfg.T, cfg.dt, cfg.n_slots)
params = MPCParams(
    x0=torch.tensor([[0.0, 0.0, 0.7, 0, 0, 0, 0, 0, 0]]),
    com_ref=torch.tensor([0.0, 0.0, 0.7]).expand(1, cfg.N, 3),
    ang_mom_ref=torch.zeros(1, cfg.N, 3),
    stage=type(stage)(*[a[None] for a in stage]),
    ext_force=torch.zeros(1, 3),
    ext_torque=torch.zeros(1, 3),
)
for kkt in ("dense", "riccati"):
    solver = CentroidalMPCSolver(ergocub_mpc_config(horizon=0.6, kkt_impl=kkt))
    sol = solver.solve(params, solver.cold_start(1, device="cpu"))
    assert bool(torch.isfinite(sol.z).all()) and float(sol.prim_res[0]) < 1e-2
import chip_smoke
from cmw_tpu_torch import convert
from cmw_tpu_torch.core import integrators, kinematics, lie, splines
from cmw_tpu_torch.mann import generator, input_builder, network, onnx_import

model = kinematics.ergocub_urdf()
weights = convert.mann_weights_from_numpy(chip_smoke.synthetic_mann_numpy(), device="cpu")
state = generator.initial_state(generator.GeneratorConfig(), model,
                                torch.tensor(kinematics.walk_ready_pose()[0], dtype=torch.float32)[None])
desired = input_builder.build_desired_trajectory(torch.tensor([[0.8, 0.0]]), torch.tensor([[1.0, 0.0]]))
_, out = generator.generate(generator.GeneratorConfig(), model, weights, state, desired)
assert out.com.shape == (1, 40, 3) and bool(torch.isfinite(out.com).all())
from cmw_tpu_torch.cmpc import qp
from cmw_tpu_torch.estimation import fixed_foot, legged_odom
from cmw_tpu_torch.runtime import config, loop, telemetry
from cmw_tpu_torch.sim import plant
from cmw_tpu_torch.wbc import com_zmp, diff_ik, swing_foot, zmp

ctl = loop.WalkingController(config.ergocub_gazebo_v1(mpc=ergocub_mpc_config(horizon=0.6)), model, weights,
                             device="cpu")
s, tel = ctl.run_episode(ctl.initial_state(1), loop.constant_inputs(3, (0.8, 0.0, 1.0, 0.0), device="cpu"))
assert tel.q.shape == (1, 3, 26) and bool(torch.isfinite(tel.com_mpc).all()) and int(s.tick[0]) == 3
from cmw_tpu_torch.sim import rigid_body

rb = rigid_body.initial_state(model, s.q, s.base_rot, s.base_pos, rigid_body.RigidBodyConfig(), device="cpu")
rb = rigid_body.dynamics_step(rigid_body.RigidBodyConfig(), model, rb, s.q, 0.002)
assert rb.nu.shape == (1, 32) and bool(torch.isfinite(rb.nu).all())
import os, tempfile
from cmw_tpu_torch.apps import sweep as sweep_app, walk as walk_app
from cmw_tpu_torch.dist import sweep
from cmw_tpu_torch.runtime import checkpoint

out = sweep.run_sweep(ctl, 2, 0.06, push_t0=0.01, per_scenario=True)
assert out["batch"] == 2 and len(out["survived_mask"]) == 2 and 0.0 <= out["survival_rate"] <= 1.0
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "state.npz")
    checkpoint.save(path, s, meta={"t": float(s.t[0])})
    back = checkpoint.load(path, ctl.initial_state(1))
assert back.rb is None and torch.equal(back.q, s.q) and int(back.tick[0]) == 3
from cmw_tpu_torch import entry
from cmw_tpu_torch.apps import joypad, parity, scaling
from cmw_tpu_torch.cmpc import oracle
from cmw_tpu_torch.mann import gen_oracle, onnx_ref
from cmw_tpu_torch.runtime import ini, native, realtime

with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "a.ini")
    with open(path, "w") as f:
        f.write("x (1, 2)\n[G]\ny 3\n")
    assert ini.parse_ini(path) == {"x": (1, 2), "G": {"y": 3}}
    assert ini.load_ik_config(os.path.join(tmp, "absent.ini")) == ini.IKConfig()
p1 = type(params)(*[a[0] for a in params[:3]], type(stage)(*[a[0] for a in params.stage]), params.ext_force[0],
                  params.ext_torque[0])
assert oracle.cost_np(cfg, p1, sol.z[0].double().numpy()) > 0.0
out = parity.main(["--cpu", "--horizon", "0.12", "--sqp-iters", "1", "--admm-iters", "2"])
assert [c["case"] for c in out["cases"]] == ["standing_offset", "walking", "walking_push"]
rw = realtime.RealtimeWalker(ctl)
rw.set_joypad(0.5, 0.0)
assert rw._mpc_task(0.0) and rw._wbc_task(0.0) and rw.errors == [] and rw._tick_input().joypad[0, 0] == 0.5
assert native.Mailbox().read() == (0, b"") and joypad.TerminalJoypad(lambda *a: None).handle_key("w")
fn, args = entry.entry(device="cpu")
assert bool(torch.isfinite(fn(*args).cost).all())
assert scaling.measure(1, 1, 1, 1, device="cpu") > 0
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cmw_tpu"))
print("LOADED", loaded)
assert not loaded, loaded
"""


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout

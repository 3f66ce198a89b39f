"""The port's copies of the numpy MANN oracles (`cmw_tpu_torch.mann.onnx_ref`,
`cmw_tpu_torch.mann.gen_oracle`) on the synthetic mann4 weights at the
published shapes (the shipped ONNX files are not in the repository), as a
graph of ONNX nodes built here (`mann_graph`: Gemm, Elu, Softmax, Einsum,
MatMul, Add), since the file `chip_smoke.mann_onnx_bytes` writes holds the
initializers alone:

  - the ONNX interpreter and the 5-step oracle rollout equal the JAX
    package's copies exactly, on the same graph, state and desired path (both
    numpy in f64 on the same values);
  - the oracle holds the port's generator (f32, B = 1, from the walk-ready
    pose on the ergoCub URDF, the forward stick, on the plain and the lifted
    weights) over the 40-step horizon with
    tests/test_mann.py:140's tolerances: the contact sequence identical,
    joints, base and CoM within 2e-3, the angular momentum within 5e-2."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import lifted, mann_onnx_bytes, synthetic_mann_numpy
from cmw_tpu.core import kinematics as JK
from cmw_tpu.mann import gen_oracle as JO
from cmw_tpu.mann import generator as JG
from cmw_tpu.mann import input_builder as JIB
from cmw_tpu.mann import onnx_ref as JR
from cmw_tpu_torch import convert
from cmw_tpu_torch.core import kinematics as TK
from cmw_tpu_torch.mann import gen_oracle as TO
from cmw_tpu_torch.mann import generator as TG
from cmw_tpu_torch.mann import input_builder as TIB
from cmw_tpu_torch.mann import network as TN
from cmw_tpu_torch.mann import onnx_ref as TR
from cmw_tpu_torch.mann.onnx_import import OnnxGraph, OnnxNode

torch.set_num_threads(2)

STICK = ([0.8, 0.0], [1.0, 0.0])


def mann_graph(W) -> OnnxGraph:
    """network.mann_forward of the weights W as ONNX nodes over [1, 124]."""
    nodes, inits = [], {}

    def node(op, inputs, out, **attributes):
        nodes.append(OnnxNode(op_type=op, inputs=inputs, outputs=[out], attributes=attributes))
        return out

    def param(name, a):
        inits[name] = np.asarray(a, np.float32)
        return name

    def linear(x, w, b, name):
        return node("Gemm", [x, param(f"{name}.w", w), param(f"{name}.b", b)], f"{name}.y", transB=1)

    h = linear("input", W["w_in"], W["b_in"], "in")
    g = node("Elu", [linear(h, W["gate_w"][0], W["gate_b"][0], "g0")], "g0.a")
    g = node("Elu", [linear(g, W["gate_w"][1], W["gate_b"][1], "g1")], "g1.a")
    om = node("Softmax", [linear(g, W["gate_w"][2], W["gate_b"][2], "g2")], "omega", axis=-1)
    z = h
    for k in range(3):
        ze = node("Einsum", [om, param(f"e{k}.w", W["expert_w"][k]), z], f"e{k}.z", equation="be,eoi,bi->bo")
        z = node("Add", [ze, node("MatMul", [om, param(f"e{k}.b", W["expert_b"][k])], f"e{k}.bias")], f"e{k}.y")
        if k < 2:
            z = node("Elu", [z], f"e{k}.a")
    linear(z, W["w_out"], W["b_out"], "out")
    nodes[-1].outputs = ["output"]
    return OnnxGraph(nodes=nodes, initializers=inits, input_names=["input"], output_names=["output"])


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    W = synthetic_mann_numpy()
    path = tmp_path_factory.mktemp("mann") / "mann4.onnx"
    path.write_bytes(mann_onnx_bytes(W))
    graph = mann_graph(W)
    return str(path), graph, graph


def test_onnx_interpreter_equals_jax_copy(graphs):
    _, tg, jg = graphs
    x = np.random.default_rng(3).standard_normal((2, 124)).astype(np.float32)
    got, want = TR.run_graph(tg, {"input": x}), JR.run_graph(jg, {"input": x})
    assert got.keys() == want.keys() and got["output"].shape == (2, 91)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # the graph computes the network the generator runs
    net = TN.mann_forward(TN.load_mann_weights(graphs[0], device="cpu", dtype=torch.float64), torch.tensor(x).double())
    np.testing.assert_allclose(got["output"], net.numpy(), rtol=1e-5, atol=1e-5)


def test_rollout_oracle_equals_jax_copy(graphs):
    _, tg, jg = graphs
    jm = JK.ergocub_urdf()
    cfg = JG.GeneratorConfig()
    jstate = JG.initial_state(cfg, jm, jnp.asarray(JK.walk_ready_pose()[0], jnp.float32))
    jdes = JIB.build_desired_trajectory(jnp.asarray(STICK[0]), jnp.asarray(STICK[1]))
    want, want_s = JO.rollout_oracle(cfg, jm, jg, jstate, jdes, n_steps=5)
    tstate = convert.generator_state_from_numpy({k: np.asarray(v) for k, v in jstate._asdict().items()},
                                                device="cpu")
    tdes = types.SimpleNamespace(**{k: torch.tensor(np.asarray(getattr(jdes, k)))
                                    for k in ("positions", "facing", "velocities")})
    got, got_s = TO.rollout_oracle(TG.GeneratorConfig(), convert.robot_model_from_numpy(jm), tg, tstate, tdes,
                                   n_steps=5)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in want_s:
        np.testing.assert_array_equal(got_s[name], want_s[name], err_msg=name)


@pytest.mark.parametrize("lift", [False, True], ids=["walk", "lift"])
def test_oracle_holds_the_port_generator(tmp_path, lift):
    """On the plain weights (double support throughout) and on the lifted
    ones (`chip_smoke.lifted`: the left foot's trigger switches off)."""
    W = lifted(synthetic_mann_numpy()) if lift else synthetic_mann_numpy()
    path = tmp_path / "mann4.onnx"
    path.write_bytes(mann_onnx_bytes(W))
    model = TK.ergocub_urdf()
    cfg = TG.GeneratorConfig()
    state = TG.initial_state(cfg, model, torch.tensor(TK.walk_ready_pose()[0], dtype=torch.float32)[None])
    desired = TIB.build_desired_trajectory(torch.tensor([STICK[0]]), torch.tensor([STICK[1]]))
    _, outs = TG.generate(cfg, model, TN.load_mann_weights(str(path), device="cpu"), state, desired)
    item = TG.GeneratorState(*(a[0] for a in state))
    des = types.SimpleNamespace(**{k: v[0] for k, v in desired._asdict().items()})
    rec, _ = TO.rollout_oracle(cfg, model, mann_graph(W), item, des)
    np.testing.assert_array_equal(outs.contact[0].double().numpy(), rec["contact"])
    assert rec["contact"][:, 0].min() == (0.0 if lift else 1.0)
    for name, tol in (("joints", 2e-3), ("base_xy_yaw", 2e-3), ("com", 2e-3), ("ang_mom", 5e-2)):
        np.testing.assert_allclose(getattr(outs, name)[0].double().numpy(), rec[name], atol=tol, err_msg=name)

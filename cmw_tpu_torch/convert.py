"""Numpy <-> tensor converters for the port's containers.

These converters carry state between the JAX package and the port: each
`*_from_numpy` takes the JAX container (its NamedTuple, or a dict of the
same field names) holding numpy arrays with a leading batch axis, and
returns the port's container of tensors on the given device (the card
unless the caller passes another) and dtype. The solver's containers are
the per-solve parameters, the contact plan and the warm start; the MANN
generator's are its weights (no batch axis) and its state; the walking
controller's are its `LoopState` (with the plant's state but not its noise
stream, and the rigid-body plant's `RigidBodyState`) and `TickInput`.
`solution_to_numpy`, `generator_state_to_numpy`, `rigid_state_to_numpy` and
`loop_state_to_numpy` go back, to a dict of numpy arrays. `config_from_dict` inverts `dataclasses.asdict` of the JAX
`MPCConfig` (lists, as from JSON, become tuples again).
`robot_model_from_numpy` copies the numpy fields of a JAX `RobotModel`, so
that both packages run the identical model.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from cmw_tpu_torch.cmpc.formulation import MPCConfig, MPCParams
from cmw_tpu_torch.cmpc.solver import WarmStart
from cmw_tpu_torch.core.contacts import ContactPlan, MPCStageParams
from cmw_tpu_torch.core.kinematics import RobotModel
from cmw_tpu_torch.mann.generator import GeneratorState
from cmw_tpu_torch.estimation.legged_odom import OdometryState
from cmw_tpu_torch.mann.network import MANNWeights
from cmw_tpu_torch.runtime.loop import DynConfig, LoopState, StoredMann, TickInput
from cmw_tpu_torch.sim.plant import PlantState
from cmw_tpu_torch.sim.rigid_body import RigidBodyState, RigidDynParams


def _get(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _convert(cls, obj, device, dtype, nested=None):
    nested = nested or {}
    fields = {}
    for name in cls._fields:
        if name in nested:
            value = obj.get(name) if isinstance(obj, Mapping) else getattr(obj, name, None)
            fields[name] = nested[name](value, device=device, dtype=dtype)
        else:
            value = _get(obj, name)
            fields[name] = torch.as_tensor(np.array(value), dtype=dtype, device=device)
    return cls(**fields)


def stage_from_numpy(stage, *, device="cuda", dtype=torch.float32) -> MPCStageParams:
    return _convert(MPCStageParams, stage, device, dtype)


def plan_from_numpy(plan, *, device="cuda", dtype=torch.float32) -> ContactPlan:
    return _convert(ContactPlan, plan, device, dtype)


def params_from_numpy(params, *, device="cuda", dtype=torch.float32) -> MPCParams:
    return _convert(MPCParams, params, device, dtype, nested={"stage": stage_from_numpy})


def warm_from_numpy(warm, *, device="cuda", dtype=torch.float32) -> WarmStart:
    return _convert(WarmStart, warm, device, dtype)


def _per_layer(arrays, *, device, dtype):
    return tuple(torch.as_tensor(np.array(a), dtype=dtype, device=device) for a in arrays)


def mann_weights_from_numpy(weights, *, device="cuda", dtype=torch.float32) -> MANNWeights:
    """A JAX `MANNWeights` (or a dict of its fields; the gate and expert
    fields are tuples of arrays, one a layer) -> the port's MANNWeights."""
    layers = dict.fromkeys(("gate_w", "gate_b", "expert_w", "expert_b"), _per_layer)
    return _convert(MANNWeights, weights, device, dtype, nested=layers)


def generator_state_from_numpy(state, *, device="cuda", dtype=torch.float32) -> GeneratorState:
    return _convert(GeneratorState, state, device, dtype)


def generator_state_to_numpy(state: GeneratorState) -> dict:
    return solution_to_numpy(state)


def robot_model_from_numpy(model) -> RobotModel:
    """A JAX `RobotModel` (a frozen dataclass of numpy arrays) -> the port's,
    with copies of the same arrays."""
    fields = {}
    for f in dataclasses.fields(RobotModel):
        if f.init:
            value = getattr(model, f.name)
            fields[f.name] = np.array(value) if isinstance(value, np.ndarray) else value
    return RobotModel(**fields)


def solution_to_numpy(sol) -> dict:
    """A port NamedTuple (an `MPCSolution`, or any other, nested ones too) ->
    a dict of numpy arrays with the same field names; fields that hold no
    tensor (None, a noise generator) are left out."""
    out = {}
    for name, value in sol._asdict().items():
        if hasattr(value, "_asdict"):
            out[name] = solution_to_numpy(value)
        elif isinstance(value, torch.Tensor):
            out[name] = value.detach().cpu().numpy()
    return out


def _long(value, *, device, dtype):
    return torch.as_tensor(np.array(value), dtype=torch.long, device=device)


def _plant_from_numpy(plant, *, device, dtype) -> PlantState:
    q_act = torch.as_tensor(np.array(_get(plant, "q_act")), dtype=dtype, device=device)
    rng = torch.Generator(device=device)
    rng.manual_seed(0)
    return PlantState(q_act=q_act, dq_act=torch.as_tensor(np.array(_get(plant, "dq_act")), dtype=dtype,
                                                          device=device), rng=rng)


def rigid_state_from_numpy(state, *, device="cuda", dtype=torch.float32) -> RigidBodyState:
    """A JAX `RigidBodyState` (or a dict of its fields) with a leading batch
    axis -> the port's; its plant parameters become tensors [B]."""
    def params(value, *, device, dtype):
        return _convert(RigidDynParams, value, device, dtype)

    return _convert(RigidBodyState, state, device, dtype, nested={"params": params})


def rigid_state_to_numpy(state: RigidBodyState) -> dict:
    return solution_to_numpy(state)


def loop_state_from_numpy(state, *, device="cuda", dtype=torch.float32) -> LoopState:
    """A JAX `LoopState` (or a dict of its fields, nested containers as
    dicts or NamedTuples) with a leading batch axis -> the port's LoopState.
    The plant's noise key cannot carry over: a new generator seeded with 0
    takes its place. The rigid-body state carries over where there is one."""
    def odo(value, *, device, dtype):
        return _convert(OdometryState, value, device, dtype, nested={"fixed_index": _long})

    def mann(value, *, device, dtype):
        return _convert(StoredMann, value, device, dtype, nested={"plan": plan_from_numpy})

    nested = {"tick": _long, "warm": warm_from_numpy, "plan": plan_from_numpy,
              "gen_state": generator_state_from_numpy, "plant": _plant_from_numpy,
              "rb": lambda value, **kw: None if value is None else rigid_state_from_numpy(value, **kw),
              "mann": mann, "odo": odo, "dyn": lambda value, **kw: _convert(DynConfig, value, **kw)}
    return _convert(LoopState, state, device, dtype, nested=nested)


def loop_state_to_numpy(state: LoopState) -> dict:
    """The port's LoopState -> nested dicts of numpy arrays (no noise
    generator; the rigid-body state where there is one)."""
    return solution_to_numpy(state)


def tick_input_from_numpy(inp, *, device="cuda", dtype=torch.float32) -> TickInput:
    return _convert(TickInput, inp, device, dtype)


def _tuples(value):
    if isinstance(value, (list, tuple)):
        return tuple(_tuples(v) for v in value)
    return value


def config_from_dict(d: Mapping) -> MPCConfig:
    """`dataclasses.asdict(jax_cfg)` (or its JSON round trip) -> MPCConfig."""
    return MPCConfig(**{k: _tuples(v) for k, v in d.items()})

"""Synthetic MANN weights, made on the device from the seed.

At mann4's published shapes (124 -> 32 -> 32 -> 4 gate, 4 experts of
124 -> 128 -> 128 -> 91): small random weights from one `torch.Generator`
draw on the device, and an output bias that holds the walk-ready joints and
a slow forward base motion, so that the rollout stays physical, with the
left leg folded in the output bias (hip pitch +0.4, knee -0.6, ankle
pitch -0.2 rad): the left sole rises ~3 cm, its contact trigger switches
off and the foot swings, so the contact plan switches. The shipped ONNX
weights are not in the repository. The same tensors are handed to the
program and to the reference.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.core import kinematics as ref_kin
from portbench.reference.mann import generator as ref_gen

MANN_SPEED = 0.05  # m/s: the weights' forward base motion
E = 4  # experts
SHAPES = dict(  # name -> shape
    w_in=(124, 124), b_in=(124,),
    gate_w0=(32, 124), gate_w1=(32, 32), gate_w2=(4, 32), gate_b0=(32,), gate_b1=(32,), gate_b2=(4,),
    expert_w0=(E, 128, 124), expert_w1=(E, 128, 128), expert_w2=(E, 91, 128),
    expert_b0=(E, 128), expert_b1=(E, 128), expert_b2=(E, 91),
    w_out=(91, 91),
)


def synthetic(seed: int, device) -> dict:
    """{field: tensor or tuple of tensors} in MANNWeights' layout, float32
    on device, from one normal draw of a generator seeded with seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**64)
    sizes = [math.prod(s) for s in SHAPES.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    parts = dict(zip(SHAPES, (p.reshape(s) for p, s in zip(flat.split(sizes), SHAPES.values()))))
    scaled = {}
    for name, a in parts.items():
        if name == "w_in":
            scaled[name] = torch.eye(124, device=device) + 0.05 * a / math.sqrt(124)
        elif name == "b_in":
            scaled[name] = 0.01 * a
        elif name == "w_out":
            scaled[name] = 1e-4 * a
        elif "_w" in name:
            scaled[name] = a / math.sqrt(a.shape[-1])
        else:
            scaled[name] = 0.1 * a
    lead = 0.8 / ref_gen.N_FUTURE  # lead time of each future point
    b_out = torch.zeros(91, dtype=torch.float64)
    b_out[0:12:2] = MANN_SPEED * lead * torch.arange(1, ref_gen.N_FUTURE + 1, dtype=torch.float64)  # positions, x
    b_out[12:24:2] = 1.0  # future facing [1, 0]
    b_out[24:36:2] = MANN_SPEED  # future velocities, x
    b_out[36:62] = torch.as_tensor(ref_kin.reference_initial_pose(), dtype=torch.float64)  # joints
    b_out[36 + 0] += 0.4  # the left leg lifted
    b_out[36 + 3] -= 0.6
    b_out[36 + 4] -= 0.2
    return dict(
        w_in=scaled["w_in"], b_in=scaled["b_in"],
        gate_w=tuple(scaled[f"gate_w{k}"] for k in range(3)), gate_b=tuple(scaled[f"gate_b{k}"] for k in range(3)),
        expert_w=tuple(scaled[f"expert_w{k}"] for k in range(3)),
        expert_b=tuple(scaled[f"expert_b{k}"] for k in range(3)),
        w_out=scaled["w_out"], b_out=b_out.to(device=device, dtype=torch.float32),
    )



def moved(w: dict, device) -> dict:
    """The same weights on device (the reference's, where it runs apart)."""
    return {k: tuple(t.to(device) for t in v) if isinstance(v, tuple) else v.to(device) for k, v in w.items()}

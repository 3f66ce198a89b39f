"""Simulated kinematic plant + sensor bridge: the robot side of the loop.

PyTorch counterpart of `cmw_tpu/sim/plant.py`, batch-first. The reference
reads the robot through YarpSensorBridge (WholeBodyQPBlock.cpp:195-229,
898-934), streams PositionDirect joint commands (:1251-1257) and gets
contact wrenches from an external estimator (:351-458). Here:

  - joint servos: a first-order lag of the actual joints toward the
    command (time constant `servo_tau`; 0 = ideal robot),
  - encoders with Gaussian noise,
  - wrench sensors: the held MPC corner forces plus Gaussian noise, giving
    a measured ZMP distinct from the desired one.

With the default config the plant is ideal: no random number is drawn and
the loop reduces exactly to the reference's adherent topology.

The noise comes from a `torch.Generator` on the state's device, seeded from
`PlantConfig.seed`; one generator draws for the whole batch, in place. Its
streams cannot match JAX's counter-based keys, so noisy runs agree with the
JAX package only in their statistics.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from portbench.reference.wbc.zmp import desired_zmp_from_corners


@dataclasses.dataclass(frozen=True)
class PlantConfig:
    """Static plant parameters (hashable, part of WalkingConfig)."""

    servo_tau: float = 0.0  # s; first-order joint-servo time constant
    encoder_noise: float = 0.0  # rad std on measured joint positions
    velocity_noise: float = 0.0  # rad/s std on measured joint velocities
    wrench_noise: float = 0.0  # mass-normalized force std on foot wrenches
    seed: int = 0

    @property
    def enabled(self) -> bool:
        return self.servo_tau > 0.0 or self.encoder_noise > 0.0 or self.velocity_noise > 0.0 or self.wrench_noise > 0.0


class PlantState(NamedTuple):
    q_act: torch.Tensor  # [B, nj] actual joint positions
    dq_act: torch.Tensor  # [B, nj] actual joint velocities
    rng: torch.Generator  # the sensor models' noise stream (advanced in place)


def initial_state(pcfg: PlantConfig, q0: torch.Tensor) -> PlantState:
    rng = torch.Generator(device=q0.device)
    rng.manual_seed(pcfg.seed)
    return PlantState(q_act=q0, dq_act=torch.zeros_like(q0), rng=rng)


def servo_step(pcfg: PlantConfig, ps: PlantState, q_cmd: torch.Tensor, dt: float) -> PlantState:
    """Track the PositionDirect command with a first-order servo (exact
    discretisation; tau = 0 passes the command through)."""
    if pcfg.servo_tau <= 0.0:
        q_new = q_cmd
    else:
        # the factor in the state's dtype, on the host (a scalar operand)
        alpha = 1.0 - torch.exp(torch.tensor(-dt / pcfg.servo_tau, dtype=q_cmd.dtype))
        q_new = ps.q_act + alpha * (q_cmd - ps.q_act)
    return ps._replace(q_act=q_new, dq_act=(q_new - ps.q_act) / dt)


def _normal(ps: PlantState, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(like.shape, generator=ps.rng, dtype=like.dtype, device=like.device)


def read_joints(pcfg: PlantConfig, ps: PlantState):
    """Encoder reads: (q_meas, dq_meas, PlantState)."""
    if pcfg.encoder_noise <= 0.0 and pcfg.velocity_noise <= 0.0:
        return ps.q_act, ps.dq_act, ps
    q_meas = ps.q_act + pcfg.encoder_noise * _normal(ps, ps.q_act)
    dq_meas = ps.dq_act + pcfg.velocity_noise * _normal(ps, ps.dq_act)
    return q_meas, dq_meas, ps


def read_zmp(pcfg: PlantConfig, ps: PlantState, forces0, corner0, centers):
    """Measured ZMP [B, 3] from the wrench sensors (evaluateZMP,
    WholeBodyQPBlock.cpp:737-803): the force-weighted corner average of the
    sensed forces, the applied (mass-normalised) corner forces forces0
    [B, nc, ncor, 3] at corner0 plus noise; centers [B, nc, 3] are the
    per-foot centres of the support clamp."""
    if pcfg.wrench_noise <= 0.0:
        return desired_zmp_from_corners(forces0, corner0, centers=centers), ps
    sensed = forces0 + pcfg.wrench_noise * _normal(ps, forces0)
    return desired_zmp_from_corners(sensed, corner0, centers=centers), ps


def deadband_wrench(force, torque, mass: float, thresh_n: float = 0.7):
    """Reject small measured external wrenches [B, 3] (WholeBodyQPBlock.cpp:
    1018-1021: below 0.7 N is sensor noise, not a push). Inputs are
    mass-normalised; the threshold is in newtons."""
    keep = (torch.linalg.vector_norm(force, dim=-1, keepdim=True) * mass >= thresh_n).to(force.dtype)
    return keep * force, keep * torque

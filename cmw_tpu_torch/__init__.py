"""cmw_tpu_torch — PyTorch/CUDA port of the cmw_tpu centroidal-MPC stack.

A second implementation of `cmw_tpu` (the MANN trajectory generator,
`cmw_tpu.cmpc.CentroidalMPCSolver.solve`, the whole-body level and the
closed-loop walking controller on the kinematic plant) for one NVIDIA
H100, written batch-first (`[B, ...]` tensors) in plain PyTorch, with
the three Pallas TPU kernels of the dense-KKT path rewritten by hand in CUDA
C++ for `sm_90a` (`csrc/`). Its entry points put their tensors on the card
(`device="cuda"`) unless the caller passes `device="cpu"`:

  core/        centroidal dynamics, contact plans, Lie groups, splines,
               integrators, floating-base kinematics (+ models/ergocub.urdf)
  mann/        MANN network, ONNX reader, joystick input builder, generator
  cmpc/        formulation, ADMM QP, the IK's equality (+ box) QPs,
               parametric Riccati x-update, SQP solver
  wbc/         swing foot, ZMP, CoM-ZMP stabilizer, differential IK
  estimation/  fixed-foot detector, legged odometry
  sim/         the kinematic plant (servo lag, sensor noise)
  runtime/     config presets, the closed-loop WalkingController, telemetry
  ops/         hand-written Hopper kernels (SPD inverse, packed symv, fused
               ADMM), each with a plain PyTorch twin and a launch counter
  convert.py   numpy <-> tensor converters for the port's containers

Module paths mirror `cmw_tpu`, so each counterpart sits at the same path.
This package never imports jax or cmw_tpu.
"""

import torch as _torch

__version__ = "0.1.0"

# Control numerics: TF32 keeps ~3 decimal digits, far too coarse for the
# KKT solve (a reduced-precision KKT operator moved the ADMM fixed point in
# the reference). Keep every float32 product in full float32 on the card.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

# Captured dispatch (runtime/cache.py): for batched LU (the IK's 47-row KKT
# solve and inverse at B > 1) PyTorch's default picks MAGMA, whose batched
# factorisation cannot be captured in a CUDA graph; cuSOLVER / cuBLAS's can,
# and the eager calls take the same route so that a replay equals them.
if _torch.backends.cuda.is_built():
    _torch.backends.cuda.preferred_linalg_library("cusolver")

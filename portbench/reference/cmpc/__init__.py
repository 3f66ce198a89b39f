"""Non-linear centroidal MPC with online step adjustment, in PyTorch.

Counterpart of `cmw_tpu.cmpc`: a Gauss-Newton SQP over corner forces and
contact-location decision variables with a fixed-iteration ADMM QP inner
loop, batch-first on [B, ...] tensors.
"""

from portbench.reference.cmpc.formulation import MPCConfig, MPCParams, ergocub_mpc_config
from portbench.reference.cmpc.solver import CentroidalMPCSolver, MPCSolution

__all__ = [
    "MPCConfig",
    "MPCParams",
    "ergocub_mpc_config",
    "CentroidalMPCSolver",
    "MPCSolution",
]

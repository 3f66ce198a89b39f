"""Simulated plants (PyTorch counterpart of `cmw_tpu/sim/`): the kinematic
plant with servo lag and sensor noise (`plant`) and the rigid-body dynamics
plant, the Gazebo stand-in (`rigid_body`)."""

from portbench.reference.sim.plant import PlantConfig, PlantState  # noqa: F401
from portbench.reference.sim.rigid_body import RigidBodyConfig, RigidBodyState, RigidDynParams  # noqa: F401

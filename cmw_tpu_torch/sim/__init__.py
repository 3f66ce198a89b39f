"""Simulated plants (PyTorch counterpart of `cmw_tpu/sim/`): the kinematic
plant with servo lag and sensor noise (`plant`). The rigid-body plant is
not ported yet."""

from cmw_tpu_torch.sim.plant import PlantConfig, PlantState  # noqa: F401

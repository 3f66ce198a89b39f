"""Core math: centroidal dynamics, contact plans, Lie groups, splines,
integrators, kinematics."""

from cmw_tpu_torch.core import centroidal, contacts, integrators, kinematics, lie, splines

__all__ = ["centroidal", "contacts", "integrators", "kinematics", "lie", "splines"]

"""Core math: centroidal dynamics, contact plans, Lie groups, splines,
integrators, kinematics."""

from portbench.reference.core import centroidal, contacts, integrators, kinematics, lie, splines

__all__ = ["centroidal", "contacts", "integrators", "kinematics", "lie", "splines"]

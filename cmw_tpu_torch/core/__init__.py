"""Core math used by the solver: centroidal dynamics, contact plans."""

from cmw_tpu_torch.core import centroidal, contacts

__all__ = ["centroidal", "contacts"]

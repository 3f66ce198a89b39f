"""Mass-normalized centroidal dynamics with per-corner contact forces.

PyTorch counterpart of `cmw_tpu/core/centroidal.py`:

    dcom/dt = v
    dv/dt   = g + sum_{i,j} m_ik f_ijk + f_ext
    dL/dt   = sum_{i,j} m_ik (p_ik + R_ik c_ij - com) x f_ijk + tau_ext

State is a flat tensor [..., 9] = [com(3), vcom(3), ang_mom(3)]; every
function takes any number of leading batch dimensions.
"""

from __future__ import annotations

import torch

from portbench.reference.core.consts import constant_like

GRAVITY = 9.80665


def cross(a, b):
    """Cross product over the last axis, broadcasting the leading axes
    (written out so that it batches under `torch.func` transforms)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def gravity_vector(like):
    """[0, 0, -GRAVITY] with the dtype and device of `like`."""
    return constant_like((0.0, 0.0, -GRAVITY), like)


def pack_state(com, vcom, ang_mom):
    return torch.cat([com, vcom, ang_mom], dim=-1)


def unpack_state(x):
    return x[..., 0:3], x[..., 3:6], x[..., 6:9]


def centroidal_dynamics(x, forces, corner_pos, active, ext_force, ext_torque):
    """Continuous-time mass-normalized centroidal dynamics.

    x [..., 9]; forces, corner_pos [..., nc, ncor, 3]; active [..., nc];
    ext_force, ext_torque [..., 3]. Returns [..., 9] time derivative.
    """
    com, vcom, _ = unpack_state(x)
    f = forces * active[..., :, None, None]
    dv = gravity_vector(vcom) + f.sum(dim=(-3, -2)) + ext_force
    arm = corner_pos - com[..., None, None, :]
    dL = cross(arm, f).sum(dim=(-3, -2)) + ext_torque
    return torch.cat([vcom, dv, dL], dim=-1)


def corner_world_positions(contact_pos, contact_rot, corners_local):
    """World corner positions p_i + R_i c_ij.

    contact_pos [..., nc, 3]; contact_rot [..., nc, 3, 3];
    corners_local [nc, ncor, 3]. Returns [..., nc, ncor, 3].
    """
    return contact_pos[..., :, None, :] + torch.einsum(
        "...iab,ijb->...ija", contact_rot, corners_local
    )

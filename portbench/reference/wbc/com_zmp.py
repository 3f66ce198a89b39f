"""CoM-ZMP stabilizer.

PyTorch counterpart of `cmw_tpu/wbc/com_zmp.py` (BLF
`SimplifiedModelControllers::CoMZMPController`, reference
WholeBodyQPBlock.cpp:560-565,1161-1184; gains
centroidal_mpc_walking.ini:26-28):

  v_cmd = v_des + R(yaw) Kc R(yaw)^T (com_des - com)
                + R(yaw) Kz R(yaw)^T (zmp_meas - zmp_des)

The ZMP term has the unstable-pendulum sign; the gains act in a frame
yaw-aligned with the robot's walking direction.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference.core.consts import constant_like


@dataclasses.dataclass(frozen=True)
class CoMZMPGains:
    com_gain: tuple = (4.0, 4.0)
    zmp_gain: tuple = (0.5, 0.5)


def com_zmp_control(dcom_des, com_des, zmp_des, com_meas, zmp_meas, yaw, gains: CoMZMPGains = CoMZMPGains()):
    """Planar [..., 2] quantities and yaw [...]; returns the commanded CoM xy
    velocity [..., 2]."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    R = torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)
    Kc = constant_like(tuple(gains.com_gain), dcom_des)
    Kz = constant_like(tuple(gains.zmp_gain), dcom_des)

    def rot_gain(K, e):
        e_local = torch.einsum("...ji,...j->...i", R, e)
        return torch.einsum("...ij,...j->...i", R, K * e_local)

    return dcom_des + rot_gain(Kc, com_des - com_meas) + rot_gain(Kz, zmp_meas - zmp_des)

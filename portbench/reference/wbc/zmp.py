"""ZMP computation: measured (from contact wrenches) and desired (from MPC
corner forces).

PyTorch counterpart of `cmw_tpu/wbc/zmp.py` (the reference's
`WholeBodyQPBlock::evaluateZMP`, WholeBodyQPBlock.cpp:737-803, and
`computeDesiredZMP`, :805-873): each foot's local ZMP is computed from its
wrench (x = -tau_y/fz, y = tau_x/fz), moved to the world through the foot
pose, and the global ZMP is the fz-weighted average over loaded feet; the
desired ZMP is the force-weighted average of the MPC's corner positions,
each foot's corners clamped to a box around its centre (+-0.08 m /
+-0.03 m, :837-838). Every function takes leading batch dimensions.
"""

from __future__ import annotations

import torch

from portbench.reference.core.consts import constant_like

MIN_FZ = 0.1  # minimum vertical load to count a foot (WholeBodyQPBlock.cpp:745-777)


def foot_zmp(wrench, foot_rot, foot_pos):
    """Local ZMP of foot wrenches [..., 6] = [f(3), tau(3)] in the sole frame;
    returns (world position [..., 3], validity [...], fz [...])."""
    fz = wrench[..., 2]
    valid = (fz > MIN_FZ).to(wrench.dtype)
    safe_fz = torch.clamp(fz, min=MIN_FZ)
    x = -wrench[..., 4] / safe_fz
    y = wrench[..., 3] / safe_fz
    local = torch.stack([x, y, torch.zeros_like(x)], dim=-1)
    world = foot_pos + torch.einsum("...ij,...j->...i", foot_rot, local)
    return world, valid, fz


def global_zmp(wrenches, foot_rot, foot_pos):
    """fz-weighted world ZMP over feet. wrenches [..., nc, 6]."""
    world, valid, fz = foot_zmp(wrenches, foot_rot, foot_pos)
    w = valid * torch.clamp(fz, min=0.0)
    wsum = torch.clamp(w.sum(dim=-1, keepdim=True), min=MIN_FZ)
    return (world * w[..., None]).sum(dim=-2) / wsum


def desired_zmp_from_corners(forces, corner_pos, clamp_xy=(0.08, 0.03), centers=None):
    """MPC corner forces -> desired ZMP (force-weighted corner average).

    forces, corner_pos [..., nc, ncor, 3]. If `centers` [..., nc, 3] is
    given, each foot's corners are clamped to the box +-clamp_xy around its
    centre before averaging (reference :837-838).
    """
    fz = torch.clamp(forces[..., 2], min=0.0)
    tot = torch.clamp(fz.sum(dim=(-2, -1), keepdim=True), min=1e-6)
    if centers is not None:
        cx, cy = clamp_xy
        lo = centers[..., None, :] + constant_like((-cx, -cy, 0.0), forces)
        hi = centers[..., None, :] + constant_like((cx, cy, 0.0), forces)
        corner_pos = torch.minimum(torch.maximum(corner_pos, lo), hi)
    zmp = (corner_pos * fz[..., None]).sum(dim=(-3, -2)) / tot[..., 0, :]
    return torch.cat([zmp[..., 0:2], torch.zeros_like(zmp[..., 2:3])], dim=-1)

"""The sweep's per-tick fold, as the reference computes it (a copy of the
program's `dist/sweep.fold`)."""

from __future__ import annotations

import torch


def fold(acc, tel):
    """A scenario's Telemetry [B, ...] folded into (supp_dev, z_dev,
    track_err, finite, up_min, bz_min, z0) [B]."""
    lat, dz, trk, fin, up, bz, zz0 = acc
    com = tel.com_mpc
    fc = tel.foot_contact
    w = fc / torch.clamp_min(fc.sum(-1, keepdim=True), 1e-6)
    supp = (w[..., None] * tel.foot_pos_des).sum(1)
    rel = torch.linalg.vector_norm(com[:, 0:2] - supp[:, 0:2], dim=-1)
    track = torch.linalg.vector_norm(com[:, 0:2] - tel.com_meas[:, 0:2], dim=-1)
    return (
        torch.maximum(lat, rel),
        torch.maximum(dz, (com[:, 2] - zz0).abs()),
        torch.maximum(trk, track),
        fin & torch.isfinite(com).all(-1) & torch.isfinite(tel.base_act_up),
        torch.minimum(up, tel.base_act_up),
        torch.minimum(bz, tel.base_act_pos[:, 2]),
        zz0,
    )

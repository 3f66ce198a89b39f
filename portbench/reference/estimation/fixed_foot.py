"""Fixed-foot detector: which foot anchors odometry at time t.

PyTorch counterpart of `cmw_tpu/estimation/fixed_foot.py` (BLF
`Contacts::FixedFootDetector`, reference WholeBodyQPBlock.cpp:121-126,
267-299). The fixed foot is the stance foot whose contact extends furthest
into the future: in single support the stance foot; in double support the
foot that stays planted through the other's upcoming swing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.core import contacts as C


class FixedFoot(NamedTuple):
    index: torch.Tensor  # [B] long: 0 = left, 1 = right
    pos: torch.Tensor  # [B, 3] planned contact position
    rot: torch.Tensor  # [B, 3, 3]
    switch_time: torch.Tensor  # [B] activation time of the fixed contact


def _take(a, idx, trailing: int):
    """a [B, nc, *trailing dims] at the contact idx [B]."""
    i = idx.reshape(idx.shape + (1,) * (trailing + 1)).expand(idx.shape + (1,) + a.shape[a.dim() - trailing:])
    return torch.take_along_dim(a, i, dim=-1 - trailing).squeeze(-1 - trailing)


def detect(plan: C.ContactPlan, t, prefer: int = 0) -> FixedFoot:
    """`prefer` breaks exact double-support ties (both feet planted with the
    same deactivation time): the reference's `initial_fixed_frame`
    (legged_odometry.ini; l_sole = 0 on every shipped robot)."""
    idx, in_contact = C.active_phase(plan, t)
    act, deact, pos, rot, _ = C.gather_phase(plan, idx)
    # score: remaining stance; swinging feet score -inf
    score = torch.where(in_contact > 0, deact, -torch.inf)
    fixed = torch.where(score[..., prefer] >= score.amax(dim=-1), prefer, torch.argmax(score, dim=-1))
    return FixedFoot(index=fixed, pos=_take(pos, fixed, 1), rot=_take(rot, fixed, 2), switch_time=_take(act, fixed, 0))

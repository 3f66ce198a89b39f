"""Linear and quintic splines on tensors.

PyTorch counterpart of `cmw_tpu/core/splines.py`: the linear spline of the
50 Hz MANN -> MPC-knot frequency adapters and the quintic interpolation of
the swing-foot planner. Every function takes leading batch dimensions.
"""

from __future__ import annotations

import torch


def linear_spline(knot_times, knot_values, query_times):
    """Piecewise-linear interpolation (clamped at the ends).

    knot_times [..., K] strictly increasing; knot_values [..., K, D];
    query_times [..., Q]. The leading dimensions broadcast. Returns
    ([..., Q, D] values, [..., Q, D] derivatives).
    """
    K, D, Q = knot_times.shape[-1], knot_values.shape[-1], query_times.shape[-1]
    lead = torch.broadcast_shapes(knot_times.shape[:-1], query_times.shape[:-1])
    # torch.searchsorted needs the knots' leading dimensions to match the query's
    kt = knot_times.expand(lead + (K,)).contiguous()
    qt = query_times.expand(lead + (Q,)).contiguous()
    idx = torch.clamp(torch.searchsorted(kt, qt, right=True) - 1, 0, K - 2)  # [*lead, Q]
    t0 = torch.take_along_dim(kt, idx, dim=-1)
    t1 = torch.take_along_dim(kt, idx + 1, dim=-1)
    vlead = torch.broadcast_shapes(lead, knot_values.shape[:-2])
    vals = knot_values.expand(vlead + (K, D))
    iv = idx.expand(vlead + (Q,))[..., None].expand(vlead + (Q, D))
    y0 = torch.take_along_dim(vals, iv, dim=-2)
    y1 = torch.take_along_dim(vals, iv + 1, dim=-2)
    denom = torch.clamp(t1 - t0, min=1e-9)
    s = torch.clamp((qt - t0) / denom, 0.0, 1.0)[..., None]
    dy = (y1 - y0) / denom[..., None]
    return y0 + s * (y1 - y0), dy


def _as(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def quintic_hermite(t, t0, t1, p0, v0, a0, p1, v1, a1):
    """Quintic Hermite segment with full boundary conditions.

    Evaluates position, velocity, acceleration at time t (clamped to
    [t0, t1]). p*, v*, a* are [..., D]; t, t0, t1 floats or [...].
    """
    t, t0, t1 = (_as(x, p0) for x in (t, t0, t1))
    T = torch.clamp(t1 - t0, min=1e-9)
    s = torch.clamp((t - t0) / T, 0.0, 1.0)[..., None]
    T = T[..., None]  # broadcast against the channel dim
    V0, V1 = v0 * T, v1 * T
    A0, A1 = a0 * T * T, a1 * T * T
    # Coefficients of p(s) = c0 + c1 s + c2 s^2 + c3 s^3 + c4 s^4 + c5 s^5
    c0 = p0
    c1 = V0
    c2 = 0.5 * A0
    c3 = 10.0 * (p1 - p0) - 6.0 * V0 - 4.0 * V1 - 1.5 * A0 + 0.5 * A1
    c4 = -15.0 * (p1 - p0) + 8.0 * V0 + 7.0 * V1 + 1.5 * A0 - A1
    c5 = 6.0 * (p1 - p0) - 3.0 * (V0 + V1) - 0.5 * (A0 - A1)
    p = c0 + s * (c1 + s * (c2 + s * (c3 + s * (c4 + s * c5))))
    dp = c1 + s * (2 * c2 + s * (3 * c3 + s * (4 * c4 + s * 5 * c5)))
    ddp = 2 * c2 + s * (6 * c3 + s * (12 * c4 + s * 20 * c5))
    return p, dp / T, ddp / (T * T)


def quintic_timescale(t, t0, t1):
    """Quintic time-scaling s(t): 0 -> 1 with zero vel/acc at both ends.
    t a tensor [...]; t0, t1 floats or tensors broadcasting against it."""
    T = torch.clamp(_as(t1, t) - t0, min=1e-9)
    x = torch.clamp((t - t0) / T, 0.0, 1.0)
    s = x * x * x * (10.0 + x * (-15.0 + 6.0 * x))
    ds = x * x * (30.0 + x * (-60.0 + 30.0 * x)) / T
    return s, ds

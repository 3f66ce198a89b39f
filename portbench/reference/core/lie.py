"""SO(3)/SE(3) Lie-group operations on tensors.

PyTorch counterpart of `cmw_tpu/core/lie.py`. Rotations are 3x3 matrices
(or unit quaternions [w, x, y, z] where noted); poses are (R, p) pairs.
Every function takes any number of leading batch dimensions.
"""

from __future__ import annotations

import torch

from portbench.reference.core.centroidal import cross

_EPS = 1e-8


def hat(w):
    """so(3) hat map: R^3 -> 3x3 skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W):
    """Inverse of hat: 3x3 skew -> R^3."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w):
    """Exponential map so(3) -> SO(3), Taylor-safe near zero."""
    theta2 = (w * w).sum(dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    # sin(t)/t and (1-cos t)/t^2 with series fallback. Both branches of each
    # where() are evaluated, so the untaken one divides by a guarded
    # denominator and never makes a NaN.
    big = theta2 > _EPS
    theta2_s = torch.where(big, theta2, 1.0)
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2_s, 0.5 - theta2 / 24.0)
    return _eye_like(W) + a * W + b * W2


def so3_log(R):
    """Log map SO(3) -> so(3). Safe for angles in [0, pi)."""
    tr = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos_t = torch.clamp((tr - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_t)[..., None, None]
    # theta/(2 sin theta), series for small theta
    s = torch.sin(theta)
    big = s.abs() > _EPS
    s_safe = torch.where(big, s, 1.0)
    coeff = torch.where(big, theta / (2.0 * s_safe), 0.5 + theta * theta / 12.0)
    return vee(coeff * (R - R.transpose(-1, -2)))


def so3_distance(R1, R2):
    """Geodesic angle between two rotations."""
    return torch.linalg.norm(so3_log(R1.transpose(-1, -2) @ R2), dim=-1)


def rotz(yaw):
    """Rotation about world z by yaw (vectorized)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, -s, z], dim=-1),
            torch.stack([s, c, z], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )


def yaw_of(R):
    """Extract yaw (rotation about z) of a rotation matrix."""
    return torch.atan2(R[..., 1, 0], R[..., 0, 0])


# --- quaternions [w, x, y, z] -------------------------------------------------


def quat_to_mat(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = w * w + x * x + y * y + z * z
    s = 2.0 / torch.clamp(n, min=_EPS)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack(
        [
            torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
            torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
            torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def mat_to_quat(R):
    """Rotation matrix -> unit quaternion [w,x,y,z], branch-free (Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # four candidate quaternions (un-normalized), pick by largest pivot
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], dim=-1)
    idx = torch.argmax(pivots, dim=-1)  # first maximum, as jnp.argmax
    cand = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4 candidates, 4]
    q = torch.take_along_dim(cand, idx[..., None, None].expand(idx.shape + (1, 4)), dim=-2)[..., 0, :]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    # canonical sign: w >= 0
    return torch.where(q[..., :1] < 0, -q, q)


def quat_mul(q1, q2):
    w1, v1 = q1[..., :1], q1[..., 1:]
    w2, v2 = q2[..., :1], q2[..., 1:]
    w = w1 * w2 - (v1 * v2).sum(dim=-1, keepdim=True)
    v = w1 * v2 + w2 * v1 + cross(v1, v2)
    return torch.cat([w, v], dim=-1)


# --- SE(3) as (R, p) ----------------------------------------------------------


def _apply(R, x):
    return torch.einsum("...ij,...j->...i", R, x)


def se3_compose(R1, p1, R2, p2):
    return R1 @ R2, p1 + _apply(R1, p2)


def se3_inverse(R, p):
    Rt = R.transpose(-1, -2)
    return Rt, -_apply(Rt, p)


def se3_apply(R, p, x):
    return _apply(R, x) + p


def se3_exp(xi):
    """se(3) exp: xi = [v(3), w(3)] -> (R, p) with left Jacobian on v."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    theta2 = (w * w).sum(dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    big = theta2 > _EPS
    theta2_s = torch.where(big, theta2, 1.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2_s, 0.5 - theta2 / 24.0)
    c = torch.where(big, (theta - torch.sin(theta)) / (theta2_s * theta), 1.0 / 6.0 - theta2 / 120.0)
    V = _eye_like(W) + b * W + c * W2
    return R, _apply(V, v)


def integrate_mixed_velocity(R, p, v_lin, w_ang, dt):
    """Integrate a mixed-representation twist (world-frame linear and
    angular velocity) over dt: p += dt v; R <- exp(dt w) R."""
    p_new = p + dt * v_lin
    R_new = so3_exp(dt * w_ang) @ R
    return R_new, p_new


def project_to_so3(R):
    """Re-orthonormalize a rotation matrix (polar projection via SVD). U and
    V are not unique, but U diag(1, 1, det) V^T is."""
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(u @ vt)
    one = torch.ones_like(det)[..., None]
    d = torch.cat([one, one, det[..., None]], dim=-1)
    return (u * d[..., None, :]) @ vt

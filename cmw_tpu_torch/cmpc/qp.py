"""Fixed-iteration OSQP-style ADMM for the SQP subproblems, batch-first.

PyTorch counterpart of `cmw_tpu/cmpc/qp.py` (`ADMMState`, `spd_inverse`,
`admm_solve`, `solve_eq_qp`, `solve_eq_box_qp`). Solves, per batch item,

    min 1/2 x^T H x + q^T x   s.t.   l <= A x <= u

with a matrix-free constraint operator and the KKT operator
M = H + sigma I + A^T rho A applied through one of three x-updates: the
dense inverse `minv` (a batched matmul), its packed lower triangle
`minv_packed` (`ops/symv.py`), or a factored `apply_fn` (the Riccati
sweeps, `cmpc/riccati.py`). With the Riccati sweeps this loop is the plain
twin of the Riccati ADMM kernel (`ops/riccati_admm.py`), which runs it on the
card. The dense equality (and box) QPs of the differential IK are solved
through their KKT system.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from cmw_tpu_torch.core.consts import eye_like
from cmw_tpu_torch.ops.symv import BLK, n_blocks, symv_packed


class ADMMState(NamedTuple):
    x: torch.Tensor  # [B, n] primal
    zc: torch.Tensor  # [B, m] constraint-space auxiliary
    y: torch.Tensor  # [B, m] dual


def spd_inverse(M: torch.Tensor) -> torch.Tensor:
    """Plain inverse of SPD matrices [..., n, n]: M^-1 = L^-T L^-1 from a
    Cholesky factor and a wide triangular solve (the `inverse_impl="xla"`
    route of the solver). `cholesky_ex` reads nothing back from the card: a
    matrix that is not SPD gives NaN, as JAX's Cholesky does."""
    L, _ = torch.linalg.cholesky_ex(M)
    eye = eye_like(M.shape[-1], M).expand(M.shape)
    Li = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.einsum("...ki,...kj->...ij", Li, Li)


def admm_solve(
    minv: torch.Tensor | None,
    q: torch.Tensor,
    matvec: Callable[[torch.Tensor], torch.Tensor],
    rmatvec: Callable[[torch.Tensor], torch.Tensor],
    l: torch.Tensor,
    u: torch.Tensor,
    rho: torch.Tensor,
    state: ADMMState,
    iters: int,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    minv_packed: torch.Tensor | None = None,
    apply_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> tuple[ADMMState, torch.Tensor]:
    """Run `iters` ADMM iterations from `state` (warm-startable).

    Exactly one x-update is used: `apply_fn` if given (then `minv` is
    ignored), else `minv_packed` if given, else the dense `minv` [B, n, n].
    Returns (state, primal residual inf-norm [B]).
    """
    if apply_fn is not None:
        apply_minv = apply_fn
    elif minv_packed is not None:
        npack = n_blocks(minv_packed.shape[1]) * BLK

        def apply_minv(rhs):
            # the matrix was zero-padded to the 128 grid, so padded lanes stay zero
            n = rhs.shape[-1]
            rhs_p = torch.nn.functional.pad(rhs, (0, npack - n))
            return symv_packed(minv_packed, rhs_p)[:, :n]

    else:

        def apply_minv(rhs):
            return torch.matmul(minv, rhs[..., None])[..., 0]

    s = state
    for _ in range(iters):
        rhs = sigma * s.x - q + rmatvec(rho * s.zc - s.y)
        x = apply_minv(rhs)
        ax = matvec(x)
        zh = alpha * ax + (1.0 - alpha) * s.zc
        zc = torch.clamp(zh + s.y / rho, l, u)
        y = s.y + rho * (zh - zc)
        s = ADMMState(x, zc, y)
    prim_res = (matvec(s.x) - s.zc).abs().amax(dim=-1)
    return s, prim_res


def _kkt(H, A, dual_reg: float):
    """[[H, A^T], [A, -dual_reg I]] for batches H [..., n, n], A [..., m, n]."""
    m = A.shape[-2]
    lower = -dual_reg * eye_like(m, A).expand(A.shape[:-2] + (m, m))
    return torch.cat([torch.cat([H, A.transpose(-1, -2)], dim=-1), torch.cat([A, lower], dim=-1)], dim=-2)


def solve_eq_qp(H, g, A, b, dual_reg: float = 1e-6):
    """Dense equality-constrained QP via the KKT system, per batch item:
        min 1/2 v^T H v - g^T v   s.t.  A v = b
    with H [B, n, n], g [B, n], A [B, m, n], b [B, m]; returns v [B, n].
    Used by the differential IK (`wbc/diff_ik.py`).

    The dual block carries a -dual_reg I proximal term: at kinematic
    singularities (straight knees) the constraint rows lose rank and the
    exact KKT matrix is singular; the regularised one stays invertible and
    moves feasible solutions by O(dual_reg) (cmw_tpu/cmpc/qp.py:122-146).
    """
    n = H.shape[-1]
    # solve_ex: no check of the factorisation's info, which would wait for the card
    sol, _ = torch.linalg.solve_ex(_kkt(H, A, dual_reg), torch.cat([g, b], dim=-1))
    return sol[..., :n]


def solve_eq_box_qp(
    H, g, A, b, box_mask, l, u,
    iters: int = 30, rho: float = 50.0, sigma: float = 1e-6, dual_reg: float = 1e-6,
):
    """Equality + box-constrained dense QP via ADMM on the box rows:
        min 1/2 v^T H v - g^T v   s.t.  A v = b,  l <= v[box] <= u[box]
    `box_mask` [n] (or [B, n]) is 1 on box-constrained coordinates and 0
    elsewhere; l, u are full length (unmasked entries are ignored).

    The KKT matrix with sigma and rho on the box diagonal is inverted once;
    each of the `iters` ADMM steps is one [n + m] mat-vec and the clip and
    dual updates, starting from the equality-only solution (the same
    straight-line structure as cmw_tpu/cmpc/qp.py:149-205, whose `lax.scan`
    becomes a loop of the same trip count)."""
    n = H.shape[-1]
    d_rho = rho * box_mask
    diag = (sigma * torch.ones_like(g) + d_rho)[..., None, :] * eye_like(n, H)
    Kinv, _ = torch.linalg.inv_ex(_kkt(H + diag, A, dual_reg))

    x = solve_eq_qp(H, g, A, b, dual_reg)
    z = torch.minimum(torch.maximum(x, l), u)
    y = torch.zeros_like(x)
    for _ in range(iters):
        rhs = torch.cat([g + sigma * x + d_rho * z - box_mask * y, b], dim=-1)
        x = torch.matmul(Kinv, rhs[..., None])[..., :n, 0]
        z = torch.minimum(torch.maximum(x + y / rho, l), u)
        y = y + rho * box_mask * (x - z)
    return x

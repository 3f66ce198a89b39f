"""Fixed-iteration OSQP-style ADMM for the SQP subproblems, batch-first.

PyTorch counterpart of `cmw_tpu/cmpc/qp.py` (`ADMMState`, `spd_inverse`,
`admm_solve`). Solves, per batch item,

    min 1/2 x^T H x + q^T x   s.t.   l <= A x <= u

with a matrix-free constraint operator and the KKT operator
M = H + sigma I + A^T rho A applied through one of three x-updates: the
dense inverse `minv` (a batched matmul), its packed lower triangle
`minv_packed` (`ops/symv.py`), or a factored `apply_fn` (the Riccati
sweeps, `cmpc/riccati.py`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from cmw_tpu_torch.ops.symv import BLK, n_blocks, symv_packed


class ADMMState(NamedTuple):
    x: torch.Tensor  # [B, n] primal
    zc: torch.Tensor  # [B, m] constraint-space auxiliary
    y: torch.Tensor  # [B, m] dual


def spd_inverse(M: torch.Tensor) -> torch.Tensor:
    """Plain inverse of SPD matrices [..., n, n]: M^-1 = L^-T L^-1 from a
    Cholesky factor and a wide triangular solve (the `inverse_impl="xla"`
    route of the solver)."""
    L = torch.linalg.cholesky(M)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand(M.shape)
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

"""The card's peaks and the work of each kernel call, in one place.

A kernel's least time on the card (its "bound") is the larger of the bytes
it must move (each input read once, each output written once) over the
memory rate and the operations it does over the float32 rate. The
benchmark's roofline shares (`apps/bench.py` `work_per_solve`) count the
same calls with the same functions, so the kernel table and the bench line
read the same work.

The peaks are those of one NVIDIA H100 SXM (data sheet, dense, at the
700 W power limit). The solver's products run in float32 outside the
tensor cores (the package keeps TF32 off), so float32's rate applies.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores


def bound(nbytes: float, flops: float):
    """(least ms on the card, what sets it, ms of the bytes, ms of the
    operations)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), t_bytes, t_ops


def spd_inverse_work(B: int, n: int) -> tuple[int, int]:
    """(bytes, flops) of one SPD inverse of [B, n, n] float32: M read and X
    written once; Cholesky n^3/3, triangular inverse n^3/3 and the symmetric
    X^T X n^3/3."""
    return 2 * B * n * n * 4, B * n**3


def symv_work(B: int, n_packed: int, n: int, blk: int = 128) -> tuple[int, int]:
    """(bytes, flops) of one packed symv: the n_packed stored blk x blk
    blocks and v [B, n] read once, out [B, n] written once; 2 n^2 a row."""
    return (B * n_packed * blk * blk + 2 * B * n) * 4, 2 * B * n * n


def admm_fused_work(B: int, n: int, m: int, nnz: int, iters: int) -> tuple[int, int]:
    """(bytes, flops) of one fused ADMM call: its inputs (minv [n, n], A
    [m, n], q, l, u, rho, x0, zc0, y0) read once and (x, zc, y) written once;
    per iteration the minv product (2 n^2), A^T w and A x (2 nnz each, nnz
    counted over the batch's A) and the vector updates (12 m + 3 n)."""
    inputs = B * (n * n + m * n + 2 * n + 5 * m)
    return (inputs + B * (n + 2 * m)) * 4, iters * (B * (2 * n * n + 12 * m + 3 * n) + 4 * nnz)


def riccati_admm_work(B: int, T: int, nc: int, ncor: int, nslot: int, iters: int, elem: int = 4) -> tuple[int, int]:
    """(bytes, flops) of one Riccati ADMM call (K2): its inputs (the gains A,
    B, C, K, KP, D1 of T stages and Sinv, the cone coefficients and slot
    rotations, q, x0 [n] and l, u, rho, zc0, y0 [m]) read once and (x, zc, y,
    prim_res) written once; per iteration each gain element once in the
    backward sweep and A, B, C, K, KP once more in the forward one, Sinv once
    (2 flops an element), A^T w and A x (2 nnz each; nnz = 3 + 15 per corner
    and 9 per slot) and the vector updates (3 n + 10 m)."""
    nu, np_ = 3 * nc * ncor, 3 * nc * nslot
    ns, ncg = 9 + nu, T * nc * ncor
    n, m = T * nu + np_, 8 * ncg + np_
    forward = 81 + 9 * nu + 9 * np_ + nu * ns + nu * np_
    stage = forward + nu * nu
    gains = T * stage + np_ * np_
    nnz = 18 * ncg + 9 * nc * nslot
    inputs = gains + T * nc * 15 + nc * nslot * 9 + 2 * n + 5 * m
    per_iter = 2 * T * (stage + forward) + 2 * np_ * np_ + 4 * nnz + 3 * n + 10 * m
    return B * (inputs + n + 2 * m + 1) * elem, B * iters * per_iter


def rigid_step_work(B: int, ndof: int, nlinks: int, ncorners: int, substeps: int, elem: int = 4) -> tuple[int, int]:
    """(bytes, flops) of one rigid plant tick (K6): the state read once (base
    pose, q, nu, the corners' forces and anchors, the servo integral, the 12
    plant parameters, q_cmd and the push) and written once; per substep the
    FK with the joints' rotations (~240 flops a joint), each link's inertia
    and Newton-Euler terms (~400 a link), M's entries (12 an entry) and M nu,
    the corner Jacobians (9 a corner and joint), and one implicit solve: J^T D
    J over the lower triangle (3 a row and entry), the Cholesky (n^3 / 3), both
    substitutions (2 n^2), J^T f and J nu (4 n a row). The kernel solves a
    second time only for an item where a corner drops out of the active set;
    that solve is not counted, so the count is the least work of a tick."""
    n, nj, rows = ndof, ndof - 6, 3 * ncorners
    solve = n * (n + 1) // 2 * rows * 3 + n**3 // 3 + 2 * n * n + 4 * n * rows
    substep = 240 * nj + 400 * nlinks + 14 * n * n + 9 * ncorners * nj + solve
    state_in = 12 + 3 * nj + n + 5 * ncorners + 12 + 3
    state_out = 12 + 2 * nj + n + 5 * ncorners
    return B * (state_in + state_out) * elem, B * substeps * substep

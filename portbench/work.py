"""The yardstick's work counts and the card's peaks, frozen with the
benchmark (copied from the repository's `bench.py:143-154`, the program's
`apps/bench.work_per_solve` and `ops/roofline.py` when the benchmark was
defined). A later change of the program's path or of its own counts changes
the rate these are multiplied by, never the counts.

The peaks are those of one NVIDIA H100 SXM (data sheet, dense, at the
700 W power limit): the solver's products run in float32 outside the tensor
cores, so float32's rate applies.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores


def riccati_solve_work(T: int, n_con: int, n_vars: int, sqp_iters: int, admm_iters: int) -> tuple[int, int]:
    """(operations, bytes) of one solve, the algorithm's work as bench.py
    counts it for the Riccati recursion: per SQP iteration a factorisation
    of T stages (24 state + control, 33 wide), per ADMM iteration a forward
    and backward sweep over the stage matrices plus the constraint products
    (4 m n / 8); the stage matrices read once an ADMM iteration."""
    stage_floats = 2 * (24 * 33) + 3 * (24 * 24) + 81 + 2 * (9 * 24)
    flops = (T * 12 * 2 * 33**3 + 57 * T * 600
             + sqp_iters * admm_iters * (T * 2 * 2 * stage_floats + 4 * n_con * (n_vars // 8)))
    nbytes = sqp_iters * admm_iters * T * stage_floats * 4 + T * stage_floats * 4 * 3
    return flops, nbytes


def spd_inverse_work(B: int, n: int) -> tuple[int, int]:
    """(bytes, flops) of one SPD inverse of [B, n, n] float32 (K3): M read and
    X written once; Cholesky n^3/3, triangular inverse n^3/3, X^T X n^3/3."""
    return 2 * B * n * n * 4, B * n**3


def symv_work(B: int, n_packed: int, n: int, blk: int = 128) -> tuple[int, int]:
    """(bytes, flops) of one packed symv (K4): the n_packed stored blk x blk
    blocks and v [B, n] read once, out [B, n] written once; 2 n^2 a row."""
    return (B * n_packed * blk * blk + 2 * B * n) * 4, 2 * B * n * n


def admm_fused_work(B: int, n: int, m: int, nnz: int, iters: int) -> tuple[int, int]:
    """(bytes, flops) of one fused ADMM call (K5): its inputs (minv [n, n],
    A [m, n], q, l, u, rho, x0, zc0, y0) read once and (x, zc, y) written
    once; per iteration the minv product (2 n^2), A^T w and A x (2 nnz each,
    nnz over the batch's A) and the vector updates (12 m + 3 n)."""
    inputs = B * (n * n + m * n + 2 * n + 5 * m)
    return (inputs + B * (n + 2 * m)) * 4, iters * (B * (2 * n * n + 12 * m + 3 * n) + 4 * nnz)


def dense_solve_work(n: int, nr: int, nnz: int, sqp_iters: int, admm_iters: int, blk: int = 128) -> tuple[int, int]:
    """(operations, bytes) of one solve on the dense KKT (K3 + K4), as the
    program's bench line counted it: one SPD inverse, 2 nr n^2 for J^T J, and
    sqp x admm packed symv calls plus the constraint products (4 nnz(A))."""
    nbytes, flops = spd_inverse_work(1, n)
    flops += 2 * nr * n * n
    nb = -(-n // blk)
    b, f = symv_work(1, nb * (nb + 1) // 2, nb * blk, blk)
    iters = sqp_iters * admm_iters
    return flops + iters * (f + 4 * nnz), nbytes + iters * b


def fused_solve_work(n: int, m: int, nr: int, nnz: int, sqp_iters: int, admm_iters: int) -> tuple[int, int]:
    """(operations, bytes) of one solve on the fused path (K3 + K5): one SPD
    inverse, J^T J, and one fused ADMM call an SQP iteration."""
    nbytes, flops = spd_inverse_work(1, n)
    flops += 2 * nr * n * n
    b, f = admm_fused_work(1, n, m, nnz, admm_iters)
    return flops + sqp_iters * f, nbytes + sqp_iters * b

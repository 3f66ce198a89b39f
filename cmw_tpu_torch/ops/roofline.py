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

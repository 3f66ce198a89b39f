"""The tile schedule of the SPD-inverse kernel (`cmw_tpu_torch/csrc/spd_inverse.cu`).

The kernel runs only on a CUDA card. This file holds a plain PyTorch model of
its schedule: the same tile width T = 32, the same panel order (diagonal
factor, panel, trailing update per round; then the column-panel triangular
inverse; then the lower output tiles), the same ragged last tile and the same
two-level output sums (a 32-term tile partial, then the partials in order).
The model is held against the Pallas kernel in interpret mode and against the
port's plain twin at ragged sizes, so an index slip in the schedule shows up
here on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_tpu.cmpc import ergocub_mpc_config
from cmw_tpu.ops.spd_inverse import spd_inverse_pallas
from cmw_tpu_torch.ops import spd_inverse as K3

torch.set_num_threads(2)

T = 32  # the kernel's tile width (kT)
RESID_TOL = 1e-4  # ||I - M X||_inf, the inverse's done-check (tests/test_ops.py:24)
INV_RTOL = 1e-4  # as tests/test_torch_ops.py: Pallas block LDL^T vs a Cholesky inverse


def scaled_spd(B, n, seed=0):
    """The badly scaled SPD matrix of tests/test_ops.py:9-24, for any n."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n)).astype(np.float32) * 0.02
    H = np.einsum("bij,bkj->bik", A, A) + np.eye(n, dtype=np.float32)
    k = min(n, 50)
    H[:, :k, :k] += 1e4 * np.eye(k, dtype=np.float32)  # rho_eq-like rows
    return H


def resid(H, X):
    return np.abs(np.einsum("bij,bjk->bik", H.astype(np.float64), X.astype(np.float64)) - np.eye(H.shape[-1])).max()


def _tile_cholesky(D):
    """One warp's factor of a diagonal tile: column by column, lower part read."""
    L = torch.tril(D).clone()
    for j in range(L.shape[-1]):
        d = torch.sqrt(L[:, j, j])
        L[:, j, j] = d
        L[:, j + 1 :, j] = L[:, j + 1 :, j] / d[:, None]
        L[:, j + 1 :, j + 1 :] -= torch.tril(L[:, j + 1 :, j, None] * L[:, None, j + 1 :, j])
    return L


def _tile_lower_inverse(L):
    """X = L^-1 of a diagonal tile, row by row (lane c of the warp holds column c)."""
    w = L.shape[-1]
    X = torch.zeros_like(L)
    for r in range(w):
        e = torch.zeros_like(L[:, r])
        e[:, r] = 1.0
        X[:, r] = (e - (L[:, r, None, :r] @ X[:, :r])[:, 0]) / L[:, r, r, None]
    return X


def tiled_inverse_model(M):
    """The kernel's schedule on [B, n, n] f32: returns M^-1."""
    B, n, _ = M.shape
    nt = -(-n // T)
    tile = [slice(t * T, min(n, (t + 1) * T)) for t in range(nt)]
    s = 1.0 / torch.sqrt(torch.diagonal(M, dim1=-2, dim2=-1))
    A = (M * s[:, :, None]) * s[:, None, :]  # 1. Jacobi scaling
    X = torch.zeros_like(M)
    for k in range(nt):  # 2. one round per panel
        Xkk = _tile_lower_inverse(_tile_cholesky(A[:, tile[k], tile[k]]))
        X[:, tile[k], tile[k]] = Xkk
        for i in range(k + 1, nt):  # panel: L_ik = A_ik X_kk^T
            A[:, tile[i], tile[k]] = A[:, tile[i], tile[k]] @ Xkk.transpose(-1, -2)
        for i in range(k + 1, nt):  # trailing update of the lower tiles
            for j in range(k + 1, i + 1):
                A[:, tile[i], tile[j]] -= A[:, tile[i], tile[k]] @ A[:, tile[j], tile[k]].transpose(-1, -2)
    for k in range(nt):  # 3. column panel k of X = L^-1, walking down the row tiles
        for i in range(k + 1, nt):
            acc = torch.zeros(B, tile[i].stop - tile[i].start, tile[k].stop - tile[k].start)
            for j in range(k, i):
                acc = acc + A[:, tile[i], tile[j]] @ X[:, tile[j], tile[k]]
            X[:, tile[i], tile[k]] = -(X[:, tile[i], tile[i]] @ acc)
    out = torch.empty_like(M)
    for a in range(nt):  # 4. S X^T X S over the lower output tiles, two-level sums, mirrored
        for b in range(a + 1):
            acc = torch.zeros(B, tile[a].stop - tile[a].start, tile[b].stop - tile[b].start)
            for K in range(a, nt):
                acc = acc + X[:, tile[K], tile[a]].transpose(-1, -2) @ X[:, tile[K], tile[b]]
            blk = (acc * s[:, tile[a], None]) * s[:, None, tile[b]]
            out[:, tile[a], tile[b]] = blk
            out[:, tile[b], tile[a]] = blk.transpose(-1, -2)
    return out


def test_tiled_model_matches_pallas():
    """n = 504: 16 tiles, the last 24 wide, against the Pallas kernel in interpret mode."""
    H = scaled_spd(2, 504)
    X_pallas = np.asarray(spd_inverse_pallas(jnp.asarray(H), ns_iters=ergocub_mpc_config().ns_iters, interpret=True))
    X_model = tiled_inverse_model(torch.tensor(H)).numpy()
    assert resid(H, X_model) < RESID_TOL
    np.testing.assert_allclose(X_model, X_pallas, rtol=0, atol=INV_RTOL * np.abs(X_pallas).max())


@pytest.mark.parametrize("n", [1, 24, 33, 100])
def test_tiled_model_matches_twin_at_ragged_sizes(n):
    """One tile (1, 24), one full tile and a 1-wide one (33), four tiles with a ragged
    4-wide last one (100), against the port's plain twin."""
    H = scaled_spd(2, n, seed=n)
    M = torch.tensor(H)
    X_model = tiled_inverse_model(M).numpy()
    X_twin = K3.spd_inverse_ref(M).numpy()
    assert resid(H, X_model) < RESID_TOL
    np.testing.assert_allclose(X_model, X_twin, rtol=0, atol=INV_RTOL * np.abs(X_twin).max())

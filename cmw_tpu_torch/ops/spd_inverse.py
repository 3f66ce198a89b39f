"""Batched SPD matrix inverse: the KKT inverse of the dense x-update.

Counterpart of `cmw_tpu/ops/spd_inverse.py` (`spd_inverse_pallas`). On a
CUDA tensor `spd_inverse` launches the hand-written kernel in
`csrc/spd_inverse.cu` (Jacobi-scaled Cholesky, triangular inverse,
S X^T X S, each cut into 32x32 tiles over many blocks: 2 ceil(n / 32) + 1
launches from one C entry point; see the note at the top of that file). On
a CPU tensor it uses the plain twin `spd_inverse_ref`, the same
factorisation in PyTorch.

The contract of both is accuracy: ||I - M X||_inf < 1e-4 on a real walking
KKT matrix (the TPU kernel's done-check).
"""

from __future__ import annotations

import torch

from cmw_tpu_torch.ops import _build

MAX_N = 1696  # the triangular inverse holds an n x 33 column panel in 227 KB of shared memory
launches = 0  # kernel launches in this process (the plain twin never counts)


def _jacobi_scale(M):
    return torch.rsqrt(torch.diagonal(M, dim1=-2, dim2=-1))


def spd_inverse_ref(M: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: Jacobi-scaled Cholesky + `cholesky_inverse`."""
    s = _jacobi_scale(M)
    L = torch.linalg.cholesky(M * s[..., :, None] * s[..., None, :])
    return torch.cholesky_inverse(L) * s[..., :, None] * s[..., None, :]


def spd_inverse(M: torch.Tensor) -> torch.Tensor:
    """Inverse of a batch of SPD matrices [B, n, n] (f32 on the card)."""
    if M.device.type == "cpu":
        return spd_inverse_ref(M)
    if M.device.type != "cuda":
        raise ValueError(f"spd_inverse: unsupported device {M.device}")
    if M.dtype != torch.float32:
        raise TypeError(f"spd_inverse: the kernel takes float32, got {M.dtype}")
    if M.dim() != 3 or M.shape[1] != M.shape[2] or not 0 < M.shape[1] <= MAX_N:
        raise ValueError(f"spd_inverse: expected [B, n, n] with n <= {MAX_N}, got {tuple(M.shape)}")
    if not M.is_contiguous():
        raise ValueError("spd_inverse: M must be contiguous")
    B, n, _ = M.shape
    out = torch.empty_like(M)
    if B == 0:
        return out
    scratch = torch.empty_like(M)  # X = L^-1
    scale = torch.empty(B, n, device=M.device, dtype=M.dtype)  # Jacobi scale 1 / sqrt(m_ii)
    fn = _build.kernel("cmw_spd_inverse", 4, 2)
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream(M.device).cuda_stream
        code = fn(M.data_ptr(), out.data_ptr(), scratch.data_ptr(), scale.data_ptr(), B, n, stream)
    _build.check("spd_inverse", code)
    global launches
    launches += 1
    return out

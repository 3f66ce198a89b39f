"""Batched symmetric matrix-vector product from a packed lower triangle.

Counterpart of `cmw_tpu/ops/symv.py` (`symv_packed`), the dense path's ADMM
x-update when `xupdate_impl="symv"`. `tri_index` and `pack_symmetric` are
plain PyTorch, as they are plain jnp in JAX. On a CUDA tensor `symv_packed`
launches the hand-written kernel in `csrc/symv.cu` (each stored block read
once and applied as itself and as its mirror, partials added by a second
launch in a fixed order; see the note at the top of that file); on a CPU
tensor it uses the plain twin `symv_packed_ref`, which unpacks the blocks and
applies them with `einsum`.
"""

from __future__ import annotations

import functools

import torch

from cmw_tpu_torch.ops import _build

BLK = 128
MAX_CTAS = 2**31 - 1  # the partials launch is a 1-D grid of B * T blocks, one per stored block
launches = 0  # kernel launches in this process (the plain twin never counts)


def tri_index(nb: int):
    """Lower-triangle block coordinates [(i, j) with j <= i], row-major."""
    return [(i, j) for i in range(nb) for j in range(i + 1)]


@functools.lru_cache(maxsize=64)
def n_blocks(n_packed: int) -> int:
    """nb from the packed block count nb (nb + 1) / 2."""
    nb = int(round((-1 + (1 + 8 * n_packed) ** 0.5) / 2))
    if nb * (nb + 1) // 2 != n_packed:
        raise ValueError(f"{n_packed} is not a triangular block count")
    return nb


def scratch_floats(B: int, nb: int) -> int:
    """The kernel's partials: B (T + T_off) 128 floats, a row partial per
    stored block and a column partial per off-diagonal one."""
    return B * nb * nb * BLK


def pack_symmetric(M: torch.Tensor) -> torch.Tensor:
    """[B, n, n] symmetric (n % 128 == 0) -> packed [B, nb(nb+1)/2, 128, 128]
    of the lower-triangle blocks."""
    nb = M.shape[-1] // BLK
    blocks = [M[:, i * BLK:(i + 1) * BLK, j * BLK:(j + 1) * BLK] for (i, j) in tri_index(nb)]
    return torch.stack(blocks, dim=1)


def unpack_symmetric(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_symmetric`: the dense symmetric [B, n, n]."""
    nb = n_blocks(packed.shape[1])
    rows = []
    for i in range(nb):
        row = []
        for j in range(nb):
            if j <= i:
                row.append(packed[:, i * (i + 1) // 2 + j])
            else:
                row.append(packed[:, j * (j + 1) // 2 + i].transpose(-1, -2))
        rows.append(torch.cat(row, dim=-1))
    return torch.cat(rows, dim=-2)


def symv_packed_ref(packed: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: unpack, then out = M v by `einsum`."""
    return torch.einsum("bij,bj->bi", unpack_symmetric(packed), v)


def symv_packed(packed: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """out = M v from the packed lower triangle: packed [B, T, 128, 128]
    (`pack_symmetric`), v [B, n] -> [B, n]."""
    if packed.device.type == "cpu":
        return symv_packed_ref(packed, v)
    if packed.device.type != "cuda" or v.device != packed.device:
        raise ValueError(f"symv_packed: unsupported devices {packed.device}, {v.device}")
    if packed.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"symv_packed: the kernel takes float32, got {packed.dtype}, {v.dtype}")
    if packed.dim() != 4 or packed.shape[2:] != (BLK, BLK):
        raise ValueError(f"symv_packed: expected [B, T, {BLK}, {BLK}], got {tuple(packed.shape)}")
    B, T = packed.shape[:2]
    nb = n_blocks(T)
    if v.shape != (B, nb * BLK):
        raise ValueError(f"symv_packed: v {tuple(v.shape)} does not match packed {tuple(packed.shape)}")
    if B * T > MAX_CTAS:
        raise ValueError(f"symv_packed: B = {B}, nb = {nb} needs more than {MAX_CTAS} thread blocks")
    if not (packed.is_contiguous() and v.is_contiguous()) or (packed.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("symv_packed: inputs must be contiguous and 16-byte aligned")
    out = torch.empty_like(v)
    if B == 0:
        return out
    scratch = v.new_empty(scratch_floats(B, nb))
    fn = _build.kernel("cmw_symv_packed", 4, 2)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        code = fn(packed.data_ptr(), v.data_ptr(), scratch.data_ptr(), out.data_ptr(), B, nb, stream)
    _build.check("symv_packed", code)
    global launches
    launches += 1
    return out

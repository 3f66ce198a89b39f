"""The schedule of the packed-symv kernel (`cmw_tpu_torch/csrc/symv.cu`).

The kernel runs only on a CUDA card. This file holds a plain PyTorch model of
its schedule: one thread block per stored block (i, j), four warps a block,
each warp on 32 consecutive rows; from the same rows the row partials
B_ij v_j and, off the diagonal, the column partials B_ij^T v_i (the warps
added in order); then the fixed-order reduction
    out_i = sum_{j <= i} rowpart(i, j) + sum_{k > i} colpart(k, i).
The model is held against the Pallas kernel in interpret mode and against the
port's plain twin, on a random symmetric matrix and on one zero-padded to the
128 grid as the dense path pads its inverse, so an index slip in the schedule
shows up here on the CPU.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_tpu.ops.symv import pack_symmetric as jpack_symmetric
from cmw_tpu.ops.symv import symv_packed as jsymv_packed
from cmw_tpu_torch.ops import symv as K4

torch.set_num_threads(2)

BLK = K4.BLK
WARPS = 4  # warps of a thread block in the partials launch
PAD = 8  # the dense path's n = 504 padded to 512
RTOL, ATOL = 2e-5, 1e-4  # f32 sums in another order (tests/test_ops.py:138)


@functools.lru_cache(maxsize=None)
def problem(B, nb, padded=False, seed=5):
    """Symmetric M = A A^T / n packed, v, and the Pallas kernel's M v (numpy).
    `padded`: the last PAD rows and columns of M and entries of v are zero."""
    rng = np.random.default_rng(seed + 100 * nb + B)
    n = nb * BLK
    A = rng.normal(size=(B, n, n)).astype(np.float32)
    M = np.einsum("bij,bkj->bik", A, A) / n
    v = rng.normal(size=(B, n)).astype(np.float32)
    if padded:
        M[:, n - PAD:], M[:, :, n - PAD:], v[:, n - PAD:] = 0.0, 0.0, 0.0
    packed = np.asarray(jpack_symmetric(jnp.asarray(M)))
    want = np.asarray(jsymv_packed(jnp.asarray(packed), jnp.asarray(v), interpret=True))
    return packed, v, want


def schedule_model(packed, v):
    """The kernel's two launches on [B, T, 128, 128], [B, n]."""
    B, T = packed.shape[:2]
    nb = K4.n_blocks(T)
    per_warp = BLK // WARPS
    rowbuf = torch.full((B, T, BLK), float("nan"))
    colbuf = torch.full((B, nb * (nb - 1) // 2, BLK), float("nan"))
    for t, (i, j) in enumerate(K4.tri_index(nb)):  # 1. partials: one thread block per stored block
        blk = packed[:, t]
        vi, vj = v[:, i * BLK:(i + 1) * BLK], v[:, j * BLK:(j + 1) * BLK]
        col = torch.zeros(B, BLK)
        for w in range(WARPS):
            r = slice(w * per_warp, (w + 1) * per_warp)
            rowbuf[:, t, r] = torch.einsum("brc,bc->br", blk[:, r], vj)
            col = col + torch.einsum("brc,br->bc", blk[:, r], vi[:, r])
        if i != j:
            colbuf[:, i * (i - 1) // 2 + j] = col
    assert not rowbuf.isnan().any() and not colbuf.isnan().any(), "a partial was never written"
    out = torch.empty(B, nb * BLK)
    for i in range(nb):  # 2. reduce, in the fixed order
        acc = torch.zeros(B, BLK)
        for j in range(i + 1):
            acc = acc + rowbuf[:, i * (i + 1) // 2 + j]
        for k in range(i + 1, nb):
            acc = acc + colbuf[:, k * (k - 1) // 2 + i]
        out[:, i * BLK:(i + 1) * BLK] = acc
    return out, rowbuf.numel() + colbuf.numel()


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("nb", [1, 2, 4, 9])
def test_schedule_matches_pallas_and_twin(nb, B, padded):
    packed, v, want = problem(B, nb, padded)
    got, n_scratch = schedule_model(torch.tensor(packed), torch.tensor(v))
    assert n_scratch == K4.scratch_floats(B, nb)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    twin = K4.symv_packed_ref(torch.tensor(packed), torch.tensor(v)).numpy()
    np.testing.assert_allclose(got.numpy(), twin, rtol=RTOL, atol=ATOL)
    if padded:
        assert not got[:, -PAD:].any(), "padded lanes must stay zero"


def test_twin_past_the_old_cap_matches_pallas():
    """nb = 9 (n = 1152), past the first kernel's cap of 8: the twin and the
    wrapper on a CPU tensor agree with the Pallas kernel."""
    packed, v, want = problem(3, 9)
    for fn in (K4.symv_packed_ref, K4.symv_packed):
        np.testing.assert_allclose(fn(torch.tensor(packed), torch.tensor(v)).numpy(), want, rtol=RTOL, atol=ATOL)

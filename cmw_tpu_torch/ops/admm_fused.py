"""Fused fixed-iteration ADMM: all iterations of one SQP step in one kernel.

Counterpart of `cmw_tpu/ops/admm_fused.py` (`admm_fused_pallas`), the ADMM
loop of the dense KKT path with `admm_impl="fused"`. For each scenario it runs
`iters` OSQP-style iterations on the dense KKT inverse `minv` [n, n]
(symmetric) and the dense constraint matrix `A` [m, n]
(`formulation.constraint_dense`):

    w   = rho zc - y
    rhs = sigma x - q + A^T w
    x   = minv rhs
    ax  = A x
    zh  = alpha ax + (1 - alpha) zc
    zc  = clip(zh + y rinv, l, u),  rinv = 1 / rho computed once
    y   = y + rho (zh - zc)

On a CUDA tensor `admm_fused` launches the hand-written kernels in
`csrc/admm_fused.cu` (see the note at the top of that file), two per call:
a compaction of A to row lists of a few non-zeros, then the loop, one
thread-block cluster per scenario that holds minv in its shared memory, a
row slice of it in each block. The kernel chooses the launch from n and m
alone (`plan`): 8 blocks a cluster at the production sizes, 16 at somewhat
longer horizons, then one block per scenario that streams minv from device
memory, and past that one block without the lists. A scenario whose A is
beyond the lists' caps runs the A products on the dense A in the same kernel
(the walking A never is). On a CPU tensor it uses the plain twin
`admm_fused_ref`, the same loop with batched matmuls.

`mxu_dtype` is the TPU kernel's operand precision: "f32" (the solver's),
"bf16" (matrices and vector operand rounded to bf16, f32 sums) or "bf16x2"
(each matrix split into bf16 hi + lo halves, the vector operand in bf16, the
two products summed in f32).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from cmw_tpu_torch.ops import _build

MXU_DTYPES = ("f32", "bf16", "bf16x2")  # the kernel's mode flag is the index
launches = 0  # calls that launched the kernels (two launches each, one without the lists; the twin never counts)


def _mode(mxu_dtype: str) -> int:
    if mxu_dtype not in MXU_DTYPES:
        raise ValueError(f"admm_fused: mxu_dtype={mxu_dtype!r}, expected one of {MXU_DTYPES}")
    return MXU_DTYPES.index(mxu_dtype)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


class Plan(NamedTuple):
    """The loop launch the kernel takes for n and m (`plan` in the source)."""

    cluster: int  # blocks a cluster; 1: one block per scenario, minv streamed from device memory
    lists: bool  # the blocks hold A's lists; False: every scenario takes the dense branch
    smem_bytes: int  # shared memory of one block
    scratch_bytes: int  # the compaction's output, per scenario


@functools.cache
def plan(n: int, m: int) -> Plan | None:
    """The kernel's launch for n and m, or None where no launch holds them."""
    out = (ctypes.c_int * 4)()
    _build.check("admm_fused plan", _build.kernel("cmw_admm_fused_plan", 1, 2)(ctypes.addressof(out), n, m, None))
    return Plan(out[0], bool(out[1]), out[2], out[3]) if out[0] else None


def admm_fused_ref(minv, A, q, l, u, rho, x0, zc0, y0, *, iters: int, sigma: float = 1e-6, alpha: float = 1.6,
                   mxu_dtype: str = "f32"):
    """Plain PyTorch twin of the kernel: the same loop with batched matmuls on
    the dense `minv` [B, n, n] and `A` [B, m, n]. Returns (x [B, n], zc [B, m],
    y [B, m])."""
    _mode(mxu_dtype)
    operand = _bf16 if mxu_dtype != "f32" else (lambda t: t)
    m_parts, a_parts = (operand(minv),), (operand(A),)
    if mxu_dtype == "bf16x2":  # the lo halves: bf16(M - hi)
        m_parts += (_bf16(minv - m_parts[0]),)
        a_parts += (_bf16(A - a_parts[0]),)

    def mv(parts, v):  # sum over parts of M v
        v = operand(v)[..., None]
        out = torch.matmul(parts[0], v)
        for p in parts[1:]:
            out = out + torch.matmul(p, v)
        return out[..., 0]

    at_parts = tuple(p.transpose(-1, -2) for p in a_parts)
    rinv = 1.0 / rho
    x, zc, y = x0, zc0, y0
    for _ in range(iters):
        w = rho * zc - y
        rhs = sigma * x - q + mv(at_parts, w)
        x = mv(m_parts, rhs)
        ax = mv(a_parts, x)
        zh = alpha * ax + (1.0 - alpha) * zc
        zc = torch.clamp(zh + y * rinv, l, u)
        y = y + rho * (zh - zc)
    return x, zc, y


def admm_fused(minv, A, q, l, u, rho, x0, zc0, y0, *, iters: int, sigma: float = 1e-6, alpha: float = 1.6,
               mxu_dtype: str = "f32"):
    """`iters` ADMM iterations per scenario: minv [B, n, n], A [B, m, n],
    q / x0 [B, n], l / u / rho / zc0 / y0 [B, m] -> (x [B, n], zc [B, m],
    y [B, m]). f32 on the card."""
    mode = _mode(mxu_dtype)
    if minv.device.type == "cpu":
        return admm_fused_ref(minv, A, q, l, u, rho, x0, zc0, y0, iters=iters, sigma=sigma, alpha=alpha,
                              mxu_dtype=mxu_dtype)
    ins = (minv, A, q, l, u, rho, x0, zc0, y0)
    if minv.device.type != "cuda" or any(t.device != minv.device for t in ins):
        raise ValueError(f"admm_fused: unsupported devices {[str(t.device) for t in ins]}")
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError(f"admm_fused: the kernel takes float32, got {[t.dtype for t in ins]}")
    if minv.dim() != 3 or A.dim() != 3:
        raise ValueError(f"admm_fused: expected minv [B, n, n] and A [B, m, n], got {tuple(minv.shape)}, "
                         f"{tuple(A.shape)}")
    B, n, m = minv.shape[0], minv.shape[1], A.shape[1]
    want = ((B, n, n), (B, m, n), (B, n), (B, m), (B, m), (B, m), (B, n), (B, m), (B, m))
    if any(tuple(t.shape) != s for t, s in zip(ins, want)):
        raise ValueError(f"admm_fused: shapes {[tuple(t.shape) for t in ins]}, expected {list(want)}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("admm_fused: inputs must be contiguous")
    if iters < 0:
        raise ValueError(f"admm_fused: iters={iters} < 0")
    launch = plan(n, m)
    if launch is None:
        raise ValueError(f"admm_fused: no launch holds n={n}, m={m}: empty, or its vectors pass one block's "
                         "shared memory")
    outs = (torch.empty_like(x0), torch.empty_like(zc0), torch.empty_like(y0))
    if B == 0:
        return outs
    scratch = torch.empty(B * launch.scratch_bytes, dtype=torch.uint8, device=minv.device)
    fn = _build.kernel("cmw_admm_fused", 13, 5, 2)
    with torch.cuda.device(minv.device):
        stream = torch.cuda.current_stream(minv.device).cuda_stream
        code = fn(*(t.data_ptr() for t in ins + outs + (scratch,)), B, n, m, iters, mode, sigma, alpha, stream)
    _build.check("admm_fused", code)
    global launches
    launches += 1
    return outs


def active_clusters(n: int, m: int) -> int:
    """How many clusters of the loop launch for n and m the current card runs
    at once (`cudaOccupancyMaxActiveClusters`, f32)."""
    code = _build.kernel("cmw_admm_fused_active_clusters", 0, 2)(n, m, None)
    if code < 0:
        raise RuntimeError(f"admm_fused: occupancy query failed with CUDA error {-code}")
    return code

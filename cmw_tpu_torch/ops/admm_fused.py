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

On a CUDA tensor `admm_fused` launches the hand-written kernel in
`csrc/admm_fused.cu` (see the note at the top of that file); on a CPU tensor
it uses the plain twin `admm_fused_ref`, the same loop with batched matmuls.

`mxu_dtype` is the TPU kernel's operand precision: "f32" (the solver's),
"bf16" (matrices and vector operand rounded to bf16, f32 sums) or "bf16x2"
(each matrix split into bf16 hi + lo halves, the vector operand in bf16, the
two products summed in f32).
"""

from __future__ import annotations

import torch

from cmw_tpu_torch.ops import _build

MXU_DTYPES = ("f32", "bf16", "bf16x2")  # the kernel's mode flag is the index
SMEM_BYTES = 232_448  # shared memory one H100 block may use; the kernel keeps every vector there
launches = 0  # kernel launches in this process (the plain twin never counts)


def _mode(mxu_dtype: str) -> int:
    if mxu_dtype not in MXU_DTYPES:
        raise ValueError(f"admm_fused: mxu_dtype={mxu_dtype!r}, expected one of {MXU_DTYPES}")
    return MXU_DTYPES.index(mxu_dtype)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


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
    if (3 * n + 7 * m) * 4 > SMEM_BYTES:
        raise ValueError(f"admm_fused: n={n}, m={m} needs more than {SMEM_BYTES} bytes of shared memory")
    if iters < 0:
        raise ValueError(f"admm_fused: iters={iters} < 0")
    outs = (torch.empty_like(x0), torch.empty_like(zc0), torch.empty_like(y0))
    if B == 0:
        return outs
    fn = _build.kernel("cmw_admm_fused", 12, 5, 2)
    with torch.cuda.device(minv.device):
        stream = torch.cuda.current_stream(minv.device).cuda_stream
        code = fn(*(t.data_ptr() for t in ins + outs), B, n, m, iters, mode, sigma, alpha, stream)
    _build.check("admm_fused", code)
    global launches
    launches += 1
    return outs

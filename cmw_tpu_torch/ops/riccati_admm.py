"""The Riccati path's ADMM loop, all iterations of one SQP step in one kernel (K2).

Replaces no TPU kernel: the JAX package runs this loop as XLA
(`cmw_tpu/cmpc/qp.py` `admm_solve` with `cmw_tpu/cmpc/riccati.py`
`riccati_apply` as the x-update). Per scenario it computes

    admm_solve(None, q, matvec, rmatvec, l, u, rho, ADMMState(x, zc, y), iters,
               sigma, alpha, apply_fn=lambda r: riccati_apply(cfg, fac, r))

with matvec / rmatvec the block-local constraint operator
(`formulation.op_matvec` / `op_rmatvec` on a `ConstraintOp`), and returns
that call's (state, prim_res). Each iteration is one backward and one forward
sweep over the T stages with the operator's rows folded in.

On a CUDA tensor `riccati_admm` launches `csrc/riccati_admm.cu` (see the note
at the top of that file): one thread block per scenario, float32 or float64,
the gains in shared memory where they fit. On a CPU tensor it runs the plain
twin `riccati_admm_ref`, which is the solver's loop line for line, so the CPU
path computes exactly what it computed before the kernel existed.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from cmw_tpu_torch.cmpc import formulation as F
from cmw_tpu_torch.cmpc.qp import ADMMState, admm_solve
from cmw_tpu_torch.cmpc.riccati import RiccatiFactor, riccati_apply
from cmw_tpu_torch.ops import _build

ENTRIES = {torch.float32: "cmw_riccati_admm_f32", torch.float64: "cmw_riccati_admm_f64"}
launches = 0  # kernel launches in this process, one per call (the plain twin never counts)


class Plan(NamedTuple):
    """The launch the kernel takes for its sizes (`plan` in the source)."""

    threads: int  # a block's threads, one a row group (corner or slot)
    staged: bool  # the gains in shared memory; False: read from device memory
    smem_bytes: int


@functools.cache
def plan(T: int, nc: int, ncor: int, nslot: int, dtype: torch.dtype) -> Plan | None:
    """The kernel's launch for these sizes and dtype, or None where none holds them."""
    out = (ctypes.c_int * 3)()
    fn = _build.kernel("cmw_riccati_admm_plan", 1, 5)
    _build.check("riccati_admm plan", fn(ctypes.addressof(out), T, nc, ncor, nslot, dtype.itemsize, None))
    return Plan(out[0], bool(out[1]), out[2]) if out[0] else None


def riccati_admm_ref(cfg: F.MPCConfig, fac: RiccatiFactor, op: F.ConstraintOp, q, l, u, rho, x, zc, y, *,
                     iters: int, sigma: float, alpha: float) -> tuple[ADMMState, torch.Tensor]:
    """Plain PyTorch twin: the batched ADMM loop with the Riccati sweeps as
    its x-update. Returns (ADMMState, prim_res [B])."""
    return admm_solve(
        None, q, lambda v: F.op_matvec(cfg, op, v), lambda v: F.op_rmatvec(cfg, op, v), l, u, rho,
        ADMMState(x, zc, y), iters=iters, sigma=sigma, alpha=alpha, apply_fn=lambda r: riccati_apply(cfg, fac, r),
    )


def riccati_admm(cfg: F.MPCConfig, fac: RiccatiFactor, op: F.ConstraintOp, q, l, u, rho, x, zc, y, *,
                 iters: int, sigma: float, alpha: float) -> tuple[ADMMState, torch.Tensor]:
    """`iters` ADMM iterations per scenario on the factored KKT operator:
    fac (`riccati_factor`), op (`constraint_op`), q / x [B, n], l / u / rho /
    zc / y [B, m] -> (ADMMState(x, zc, y), prim_res [B]). float32 or float64
    on the card; D1 must be symmetric, as `riccati_factor` makes it."""
    if q.device.type == "cpu":
        return riccati_admm_ref(cfg, fac, op, q, l, u, rho, x, zc, y, iters=iters, sigma=sigma, alpha=alpha)
    # A, B, C (jacfwd's) and Sinv (cholesky_solve's) come strided from
    # riccati_factor, the operator's tensors may be views: each is copied
    # where it is not contiguous, a no-op for the others
    ins = tuple(t.contiguous() for t in (*fac, *op, q, l, u, rho, x, zc, y))
    if q.device.type != "cuda" or any(t.device != q.device for t in ins):
        raise ValueError(f"riccati_admm: unsupported devices {[str(t.device) for t in ins]}")
    if q.dtype not in ENTRIES or any(t.dtype != q.dtype for t in ins):
        raise TypeError(f"riccati_admm: the kernel takes one of {list(ENTRIES)}, got {[t.dtype for t in ins]}")
    if fac.K.dim() != 4 or op.cone_coeff.dim() != 5 or op.slot_rot.dim() != 5:
        raise ValueError(f"riccati_admm: expected K [B, T, nu, ns], cone_coeff [B, T, nc, 5, 3] and slot_rot "
                         f"[B, nc, K, 3, 3], got {tuple(fac.K.shape)}, {tuple(op.cone_coeff.shape)}, "
                         f"{tuple(op.slot_rot.shape)}")
    B, T, nu, ns = fac.K.shape
    nc, nslot = op.slot_rot.shape[1:3]
    ncor = nu // (3 * nc) if nc else 0
    np_ = 3 * nc * nslot
    n, m = T * nu + np_, T * nc * ncor * 8 + np_
    want = ((B, T, 9, 9), (B, T, 9, nu), (B, T, 9, np_), (B, T, nu, ns), (B, T, nu, np_), (B, T, nu, nu),
            (B, np_, np_), (B, T, nc, 5, 3), (B, nc, nslot, 3, 3), (B, n), (B, m), (B, m), (B, m), (B, n), (B, m),
            (B, m))
    if ns != 9 + nu or nu != 3 * nc * ncor or any(tuple(t.shape) != s for t, s in zip(ins, want)):
        raise ValueError(f"riccati_admm: shapes {[tuple(t.shape) for t in ins]}, expected {list(want)}")
    if (T, nc, ncor, nslot, n, m) != (cfg.T, cfg.n_contacts, cfg.n_corners, cfg.n_slots, cfg.n_vars, cfg.n_con):
        raise ValueError(f"riccati_admm: sizes T={T}, nc={nc}, ncor={ncor}, K={nslot} do not match the config")
    if iters < 0:
        raise ValueError(f"riccati_admm: iters={iters} < 0")
    if plan(T, nc, ncor, nslot, q.dtype) is None:
        raise ValueError(f"riccati_admm: no launch holds T={T}, nc={nc}, ncor={ncor}, K={nslot}: more row groups "
                         "than a block's threads, or vectors past one block's shared memory")
    outs = (q.new_empty(B, n), q.new_empty(B, m), q.new_empty(B, m), q.new_empty(B))
    if B == 0:
        return ADMMState(*outs[:3]), outs[3]
    fn = _build.kernel(ENTRIES[q.dtype], 20, 6, 0, 2)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(*(t.data_ptr() for t in ins + outs), B, T, nc, ncor, nslot, iters, sigma, alpha, stream)
    _build.check("riccati_admm", code)
    global launches
    launches += 1
    return ADMMState(*outs[:3]), outs[3]

"""Which order of operations the Riccati ADMM loop's plain twin takes on the card.

    python tools/k2_order_probe.py

The Riccati ADMM kernel (`cmw_tpu_torch/csrc/riccati_admm.cu`) takes the
order of operations of its twin (`ops/riccati_admm.riccati_admm_ref`), so
that at B = 1 (and, measured, 256) a launch is bitwise the twin and the
walking controller's MPC tick bitwise its eager path. The twin's order is
that of the libraries it calls: cuBLAS's gemv for each product of
`riccati_apply`, PyTorch's reductions for the constraint operator's sums.
This tool measures both on the card at B = 1, on a recorded walking QP's
tensors (their real strides) and on dense random operators, against
candidate orders emulated in float64 with float32 rounding after each
operation, and prints which candidates match bit for bit. The kernel's
choices: products `halves` (two contiguous halves, the first ceil(k / 2),
each a chain of fused multiply-adds from zero, then added); sums over the
last axis `(0+2)+1`, over an inner axis `(0+1)+2`, the five cone rows `v4`.
Rerun it after a change of the CUDA or PyTorch version: where it no longer
prints those, the kernel's order has to follow.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

r32 = np.float32


def fma_chain(M, v, idx):
    """[m] float32: per row, acc = fl(acc + M[r, i] v[i]) over idx from zero
    (the product is exact in float64: a fused multiply-add)."""
    out = np.zeros(M.shape[0], np.float32)
    for r in range(M.shape[0]):
        acc = np.float32(0)
        for i in idx:
            acc = r32(np.float64(acc) + M[r, i] * v[i])
        out[r] = acc
    return out


def product_orders(M, v):
    M, v = M.astype(np.float64), v.astype(np.float64)
    k = M.shape[1]
    h = (k + 1) // 2
    return {
        "halves": r32(fma_chain(M, v, range(h)).astype(np.float64) + fma_chain(M, v, range(h, k))),
        "chain": fma_chain(M, v, range(k)),
        "chain reversed": fma_chain(M, v, range(k - 1, -1, -1)),
    }


def sum3_orders(p):
    a, b, c = (p[..., j].astype(np.float64) for j in range(3))
    return {"(0+1)+2": r32(r32(a + b) + c), "0+(1+2)": r32(a + r32(b + c)), "(0+2)+1": r32(r32(a + c) + b)}


def report(name, got, cands):
    hits = [n for n, c in cands.items() if np.array_equal(c, got)]
    print(f"{name}: bitwise {hits or 'none'}", flush=True)


def main() -> None:
    dev = "cuda"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the orders are the card's")
    gen = torch.Generator(device=dev).manual_seed(1)
    cfg = chip_smoke.K2_CASES[0][1]
    fac, _, _ = chip_smoke.riccati_qps(cfg, 1)[0]
    t = 5
    At, Bt, Ct, Kt, KPt, D1t = fac.A[:, t], fac.B[:, t], fac.C[:, t], fac.K[:, t], fac.KP[:, t], fac.D1[:, t]
    tr = lambda a: a.transpose(-1, -2)  # noqa: E731
    for name, Mt in (("B' gam9", tr(Bt)), ("A' gam9", tr(At)), ("C' gam9", tr(Ct)), ("K' gv", tr(Kt)),
                     ("KP' gv", tr(KPt)), ("D1 gv", D1t), ("Sinv d", fac.Sinv), ("K s", Kt), ("KP P", KPt),
                     ("A y", At), ("B u", Bt), ("C P", Ct)):
        hits = None
        for _ in range(4):
            v = torch.randn(1, Mt.shape[-1], device=dev, generator=gen) * 10
            got = torch.matmul(Mt, v[..., None])[0, :, 0].cpu().numpy()
            ok = {n: np.array_equal(c, got) for n, c in product_orders(Mt[0].cpu().numpy(), v[0].cpu().numpy()).items()}
            hits = ok if hits is None else {n: hits[n] and ok[n] for n in ok}
        print(f"product {name} {tuple(Mt.shape)}: bitwise {[n for n, h in hits.items() if h] or 'none'}", flush=True)

    # the operator's sums, as formulation.op_matvec / op_rmatvec write them, on dense coefficients
    T = cfg.T
    coeff = torch.randn(1, T, 2, 5, 3, device=dev, generator=gen)
    F = torch.randn(1, T, 2, 4, 3, device=dev, generator=gen)
    prod = coeff[..., :, :, None, :, :] * F[..., :, :, :, None, :]
    report("op_matvec cone rows, the last axis", prod.sum(dim=-1).cpu().numpy(), sum3_orders(prod.cpu().numpy()))
    y2 = torch.randn(1, T, 2, 4, 5, device=dev, generator=gen) * 100
    prod = y2[..., :, None] * coeff[..., :, :, None, :, :]
    p = [prod.cpu().numpy().astype(np.float64)[..., d, :] for d in range(5)]
    report("op_rmatvec cone rows, five", prod.sum(dim=-2).cpu().numpy(),
           {"v4": r32(r32(r32(r32(p[0] + p[4]) + p[1]) + p[2]) + p[3]),
            "sequential": r32(r32(r32(r32(p[0] + p[1]) + p[2]) + p[3]) + p[4])})
    rot = torch.randn(1, 2, 4, 3, 3, device=dev, generator=gen)
    P = torch.randn(1, 2, 4, 3, device=dev, generator=gen)
    prod = rot * P[..., :, :, :, None]
    report("op_matvec slot rows, an inner axis", prod.sum(dim=-2).cpu().numpy(),
           sum3_orders(np.moveaxis(prod.cpu().numpy(), -2, -1)))
    y3 = torch.randn(1, 2, 4, 3, device=dev, generator=gen) * 100
    prod = rot * y3[..., :, :, None, :]
    report("op_rmatvec slot rows, the last axis", prod.sum(dim=-1).cpu().numpy(), sum3_orders(prod.cpu().numpy()))


if __name__ == "__main__":
    main()

"""A/B of the KKT x-update paths on the benchmark's shape.

The counterpart of the repository's `tools/bench_kkt.py`: B = 512 scenarios
(`apps.bench.make_params`), KB = 4 warm-started solves a chain, 5 timed
chains after a first one, one line per path: solves/s, the first chain's
seconds, the mean cost and the largest prim_res of the first chain's last
solves. The paths:

  dense    kkt_impl="dense": the SPD inverse kernel once a solve, the
           packed symv kernel every ADMM iteration
  riccati  kkt_impl="riccati": the stage-wise factor (plain PyTorch)
  fused    kkt_impl="dense", admm_impl="fused": the SPD inverse kernel once
           a solve, the fused ADMM kernel once an SQP iteration
  both     dense, then riccati, then their speedup and cost agreement

Example:
  python -m cmw_tpu_torch.apps.bench_kkt both
  python -m cmw_tpu_torch.apps.bench_kkt fused -b 256
  python -m cmw_tpu_torch.apps.bench_kkt both --cpu -b 4 --reps 1
"""

from __future__ import annotations

import argparse

import torch

from cmw_tpu_torch.apps.bench import KB, lateral_pushes, make_params, measure
from cmw_tpu_torch.cmpc import CentroidalMPCSolver, ergocub_mpc_config

PATHS = {"dense": dict(kkt_impl="dense"), "riccati": dict(kkt_impl="riccati"),
         "fused": dict(kkt_impl="dense", admm_impl="fused")}


def bench(cfg, label: str, B: int, reps: int, device: str):
    """One path: prints its line, returns (solves/s, the first chain's last costs [B])."""
    params = make_params(cfg, lateral_pushes(B), device=device)
    first_s, chain_s, (costs, prims) = measure(CentroidalMPCSolver(cfg), params, KB, reps)
    rate = B / (chain_s / KB)
    cost, prim = costs[-1].cpu(), prims[-1].cpu()
    print(f"{label:10s} {rate:10.1f} solves/s  compile {first_s:6.1f}s  "
          f"mean cost {float(cost.mean()):9.3f}  max prim {float(prim.max()):.2e}", flush=True)
    return rate, cost


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("which", nargs="?", default="both", choices=("dense", "riccati", "both", "fused"))
    p.add_argument("-b", type=int, default=512, dest="batch", help="scenarios B")
    p.add_argument("--reps", type=int, default=5, help="timed chains after the first")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: bench_kkt runs on the card (pass --cpu for the CPU)")
    names = ("dense", "riccati") if args.which == "both" else (args.which,)
    out = {name: bench(ergocub_mpc_config(**PATHS[name]), name, args.batch, args.reps, device) for name in names}
    if args.which == "both":
        (r_d, c_d), (r_r, c_r) = out["dense"], out["riccati"]
        print(f"speedup: {r_r / r_d:.3f}x   cost agreement: "
              f"{float((c_r - c_d).abs().max()) / (1 + float(c_d.abs().max())):.2e}")
    return {name: rate for name, (rate, _) in out.items()}


if __name__ == "__main__":
    main()

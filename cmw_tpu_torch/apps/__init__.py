"""Command-line entry points of the port (counterparts of `cmw_tpu/apps/`
and of the repository's benchmark scripts):

  python -m cmw_tpu_torch.apps.walk       -- closed-loop walking demo
  python -m cmw_tpu_torch.apps.sweep      -- batched push-recovery sweep
  python -m cmw_tpu_torch.apps.parity     -- the solve against the f64 oracle
  python -m cmw_tpu_torch.apps.scaling    -- solves/s over 1..N ranks
  python -m cmw_tpu_torch.apps.bench      -- the benchmark line (bench.py's)
  python -m cmw_tpu_torch.apps.bench_kkt  -- dense / Riccati / fused A/B
  python -m cmw_tpu_torch.apps.breakdown  -- the batched solve by stage

They run on the card; `--cpu` runs them on the CPU.
"""

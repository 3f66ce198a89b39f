"""Command-line entry points of the port (counterparts of `cmw_tpu/apps/`):

  python -m cmw_tpu_torch.apps.walk   -- closed-loop walking demo
  python -m cmw_tpu_torch.apps.sweep  -- batched push-recovery sweep

Both run on the card; `--cpu` runs them on the CPU.
"""

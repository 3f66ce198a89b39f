"""Closed-loop runtime, batch-first (PyTorch counterpart of
`cmw_tpu/runtime/`): config presets (`config`), the walking controller's
multi-rate loop on the kinematic plant (`loop`) and telemetry files
(`telemetry`)."""

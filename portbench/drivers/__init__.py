"""One module per driver kind, found by the name a traffic file gives.

Each has `run(cell) -> outcome`, the outcome a dict: attempted, failed, e2e
{end-to-end metric: value}, device (`common.device_info` read after the
window), checks [(name, number, limit)], and with cell.trace: trace {what
the per-layer readers read}, busy_s, window_s, breakdown."""

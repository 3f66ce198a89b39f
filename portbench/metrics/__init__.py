"""One reader per per-layer metric, `<metric>.py`, loaded by the name
`BENCHMARK.json` gives: `read(trace) -> number or None`, where trace is the
dict of readings the cell's driver took in its traced run. A reader that
finds nothing to read returns None, and the metric is left out."""

"""The benchmark of `cmw_tpu_torch`, the port on one NVIDIA H100.

One run is one cell of `BENCHMARK.json`:

  python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It is driven by data: a configuration is `configs/<config>.json`, a traffic
mix is `traffic/<traffic>.json` and names the driver that runs it
(`drivers/<driver>.py`), and a per-layer metric is read by
`metrics/<metric>.py`. Each is found by the name the manifest gives it.

Everything here is frozen with the benchmark: the traffic generation, the
statistics, the profiler read, the work counts and peaks
(`work.py`), the synthetic MANN weights (`weights.py`) and the plain
reference (`reference/`, a frozen copy of the program's eager code), which
decides `correct`. From the program the benchmark takes only the system
under test. Nothing here imports jax, jaxlib, flax or the JAX package.
"""

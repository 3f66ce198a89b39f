"""solve_mfu (%): the solves' share of the card's float32 peak: solves/s of
the run's window x the frozen count of one solve's operations
(`portbench/work.riccati_solve_work`, the algorithm's work whatever path
the program runs) / 67 TFLOP/s."""

from portbench.work import F32_FLOP_PER_S


def read(trace):
    rate, flops = trace.get("solves_per_s"), trace.get("solve_flops")
    if not rate or not flops:
        return None
    return 100.0 * rate * flops / F32_FLOP_PER_S

"""capture_s: seconds the program's graph cache (`runtime/cache.py`) spent
in set-up on warm-up, capture and instantiation, summed over its entries."""


def read(trace):
    return trace.get("capture_s")

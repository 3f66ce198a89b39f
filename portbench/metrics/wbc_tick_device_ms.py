"""wbc_tick_device_ms: device time of the operations that ran inside the
benchmark's range around each WBC tick of the traced sub-window, the mean a
tick."""


def read(trace):
    return trace.get("wbc_tick_device_ms")

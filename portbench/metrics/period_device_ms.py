"""period_device_ms: device time (the union of its operations) of one
fold period's replay in the traced sub-window, the mean a period."""


def read(trace):
    return trace.get("period_device_ms")

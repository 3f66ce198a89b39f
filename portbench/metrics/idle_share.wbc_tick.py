"""idle_share.wbc_tick (%): 1 - wbc_tick_device_ms / the mean wall of every
WBC tick of the measured window: the share of a tick in which the card
waits for the host's dispatch. The device time comes from the traced
ticks, the wall from the unprofiled ones, since the profiler slows the
host's side of a traced tick some threefold."""

from portbench.common import idle_share


def read(trace):
    return idle_share(trace.get("wbc_tick_device_ms"), trace.get("wbc_tick_wall_ms"))

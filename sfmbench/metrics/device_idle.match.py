"""Share of the traced window in which the device ran nothing, in %."""

from sfmbench.record import busy_s


def read(record):
    busy = busy_s(record)
    if busy is None:
        return None
    return 100.0 * (1.0 - busy / record["trace"]["window_s"])

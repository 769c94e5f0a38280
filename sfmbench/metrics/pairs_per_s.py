"""Image pairs matched (every pair of the job's key files) in every job
of the window, over the window's wall time."""

from sfmbench.record import total


def read(record):
    return total(record, "pairs") / record["window_s"]

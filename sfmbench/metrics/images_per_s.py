"""Cameras registered in the bundle.out of every job in the window, over
the window's wall time."""

from sfmbench.record import total


def read(record):
    return total(record, "images") / record["window_s"]

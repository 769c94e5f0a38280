"""The least time the H100 could take for the window's 2-NN work
(`sfmbench/roofline.py`, from each pair's real key counts) over the
time in which any kernel ran in the traced window (copies left out), in
%: every kernel the matcher ran counts against it."""

from sfmbench.record import busy_s, total


def read(record):
    busy = busy_s(record, "kernel_busy_s")
    least = total(record, "two_nn_least_s")
    if busy is None or least <= 0:
        return None
    return 100.0 * least / busy

"""Share of the `match` spans in which the device ran nothing: 1 less
the device-busy time of the traced window over the summed `match`
spans, in %."""

from sfmbench.record import busy_s


def read(record):
    busy = busy_s(record)
    spans = sum(j["stages"].get("match", 0.0) for j in record["jobs"])
    if busy is None or spans <= 0:
        return None
    return 100.0 * (1.0 - busy / spans)

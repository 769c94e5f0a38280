"""Helpers the metric readers share, over a run's record:

    record = {"setup_s", "window_s",
              "jobs": [{"wall_s", "stages": {name: s}, "counters": {...},
                        "peak_bytes", "launches", <the job kind's work>}],
              "trace": None or {"busy_s", "kernel_busy_s", "window_s",
                                "device_events", ...}}
"""

from __future__ import annotations

from typing import Optional


def per_job_mean(record, *stages: str) -> Optional[float]:
    """Mean over the window's jobs of the sum of `stages`' seconds; None
    where no job ran any of them."""
    jobs = [j for j in record["jobs"] if any(s in j["stages"] for s in stages)]
    if not jobs:
        return None
    return sum(sum(j["stages"].get(s, 0.0) for s in stages)
               for j in jobs) / len(jobs)


def total(record, quantity: str) -> float:
    return sum(j.get(quantity, 0) for j in record["jobs"])


def busy_s(record, key: str = "busy_s") -> Optional[float]:
    """Device-busy seconds of the traced window (`kernel_busy_s`: kernels
    alone, copies left out); None when the run was not traced or the
    trace holds no device operation."""
    t = record["trace"]
    if not t or not t["device_events"]:
        return None
    return t[key]

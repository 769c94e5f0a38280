"""Structured stage timing + counters.

The reference self-reports wall-clock per stage via printf (`clock()`
deltas: key reading/matching `src/KeyMatchFull.cpp:101-103,145-147`,
`run_sfm took %0.3fs` `src/Bundle.cpp:643-657`, BA totals
`src/BundleFast.cpp:440-443`).  Here the same signals land in one registry
that can be printed, asserted on in tests, or dumped as JSON — plus derived
rates (pairs/s, images-registered/s: the BASELINE.json reporting metrics).

`trace(name)` additionally opens a torch.profiler range so stages show up
in profiler timelines.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, Optional

import torch


class Telemetry:
    def __init__(self):
        self.stage_seconds: Dict[str, float] = {}
        self.stage_calls: Dict[str, int] = {}
        self.counters: Dict[str, float] = {}

    def add_time(self, name: str, seconds: float) -> None:
        self.stage_seconds[name] = self.stage_seconds.get(name, 0.0) + seconds
        self.stage_calls[name] = self.stage_calls.get(name, 0) + 1

    def add(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def rate(self, counter_name: str, stage_name: str) -> Optional[float]:
        t = self.stage_seconds.get(stage_name, 0.0)
        if t <= 0 or counter_name not in self.counters:
            return None
        return self.counters[counter_name] / t

    def report(self) -> Dict:
        out = {
            "stages_s": {k: round(v, 4) for k, v in
                         self.stage_seconds.items()},
            "stage_calls": dict(self.stage_calls),
            "counters": dict(self.counters),
        }
        rates = {}
        for cname, sname in (("pairs_matched", "match"),
                             ("pairs_verified", "verify"),
                             ("images_registered", "total"),
                             ("ba_observations", "ba")):
            r = self.rate(cname, sname)
            if r is not None:
                rates[f"{cname}_per_s"] = round(r, 2)
        out["rates"] = rates
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=1)

    def reset(self) -> None:
        self.stage_seconds.clear()
        self.stage_calls.clear()
        self.counters.clear()


_GLOBAL = Telemetry()


def get_telemetry() -> Telemetry:
    return _GLOBAL


@contextlib.contextmanager
def stage(name: str, verbose: bool = False):
    """Time a pipeline stage (the reference's `clock()` bracket)."""
    t0 = time.perf_counter()
    try:
        yield _GLOBAL
    finally:
        dt = time.perf_counter() - t0
        _GLOBAL.add_time(name, dt)
        if verbose:
            print(f"[{name}] took {dt:0.3f}s", flush=True)


def counter(name: str, value: float = 1.0) -> None:
    _GLOBAL.add(name, value)


def rate_report() -> Dict:
    return _GLOBAL.report()


@contextlib.contextmanager
def trace(name: str):
    """stage() + a torch.profiler range, so the stage shows up in profiler
    timelines."""
    with torch.profiler.record_function(name), stage(name):
        yield

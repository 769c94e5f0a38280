"""Spans and counters of the port's host steps.

The reference self-reports wall-clock per stage via printf (`clock()`
deltas: key reading/matching `src/KeyMatchFull.cpp:101-103,145-147`,
`run_sfm took %0.3fs` `src/Bundle.cpp:643-657`, BA totals
`src/BundleFast.cpp:440-443`).  Here the same signals land in one registry
that can be printed, asserted on in tests, or dumped as JSON.

`stage(name)` is a span.  Its start and end are `time.time_ns()` readings,
the clock of torch.profiler's (kineto's) events, so spans can be laid
over a device trace.  Every span adds its seconds under its name
(`stage_seconds`, `stage_calls`) through exactly one call of
`Telemetry.add_time` on the global instance: a caller may wrap that
method to see each span's end.  With the span log on (`log_spans`),
every span is also appended to `spans` as it opens, and its end is filled
in when it closes; its `parent` is the log index of the enclosing open
span (-1 at the top).  Spans nest on one stack: open them from one
thread.  No span synchronizes the device, so a span's seconds are host
time: work queued inside a span may run on the device after it closed.

`counter(name, value)` adds to `counters`.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, List, Optional


class Span:
    """One entry of the span log; `end_ns` is None while it is open."""

    __slots__ = ("name", "start_ns", "end_ns", "parent")

    def __init__(self, name: str, start_ns: int, parent: int):
        self.name = name
        self.start_ns = start_ns
        self.end_ns: Optional[int] = None
        self.parent = parent

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def as_list(self) -> List:
        return [self.name, self.start_ns, self.end_ns, self.parent]


class Telemetry:
    def __init__(self):
        self.stage_seconds: Dict[str, float] = {}
        self.stage_calls: Dict[str, int] = {}
        self.counters: Dict[str, float] = {}
        self.spans: Optional[List[Span]] = None     # None: the log is off
        self._open: List[int] = []    # log indices of open spans

    def add_time(self, name: str, seconds: float) -> None:
        self.stage_seconds[name] = self.stage_seconds.get(name, 0.0) + seconds
        self.stage_calls[name] = self.stage_calls.get(name, 0) + 1

    def add(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def log_spans(self, on: bool = True) -> None:
        """Turn the span log on (empty) or off."""
        self.spans = [] if on else None
        self._open = []

    def report(self) -> Dict:
        out = {
            "stages_s": {k: round(v, 4) for k, v in
                         self.stage_seconds.items()},
            "stage_calls": dict(self.stage_calls),
            "counters": dict(self.counters),
        }
        if self.spans is not None:
            out["spans"] = [s.as_list() for s in self.spans]
        return out

    def dump(self, path: str) -> None:
        """The seconds, calls and counters, and the span log when it is on
        (`spans`: [name, start_ns, end_ns, parent] each), as JSON."""
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=1)

    def reset(self) -> None:
        self.stage_seconds.clear()
        self.stage_calls.clear()
        self.counters.clear()
        if self.spans is not None:
            self.log_spans(True)


_GLOBAL = Telemetry()


def get_telemetry() -> Telemetry:
    return _GLOBAL


@contextlib.contextmanager
def stage(name: str, verbose: bool = False):
    """A span around a pipeline stage (the reference's `clock()` bracket);
    yields the `Span`, whose `seconds` are set once it closed."""
    tel = _GLOBAL
    span = Span(name, time.time_ns(), tel._open[-1] if tel._open else -1)
    if tel.spans is not None:
        tel._open.append(len(tel.spans))
        tel.spans.append(span)
    try:
        yield span
    finally:
        span.end_ns = time.time_ns()
        if tel._open and tel.spans[tel._open[-1]] is span:
            tel._open.pop()
        tel.add_time(name, span.seconds)
        if verbose:
            print(f"[{name}] took {span.seconds:0.3f}s", flush=True)


def counter(name: str, value: float = 1.0) -> None:
    _GLOBAL.add(name, value)


@contextlib.contextmanager
def span_log(path: Optional[str]):
    """The span log on for the block and written to `path` (`dump`) at its
    end, then off again; nothing when `path` is None.  The seconds and
    counters written are the process's since the last `reset()`."""
    if path is None:
        yield
        return
    _GLOBAL.log_spans(True)
    try:
        yield
    finally:
        _GLOBAL.dump(path)
        _GLOBAL.log_spans(False)

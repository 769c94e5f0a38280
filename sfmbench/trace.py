"""The traced run's device timeline, from `torch.profiler`.

Only the device is traced (CUDA activity: kernels, copies, sets), which
keeps the profiler's cost on the host small; recording every host
operation as well made a `full` job 59 % slower.  What the host was doing
comes from the program's own spans instead: while the window is traced,
the telemetry's `add_time` (which every `stage()` span and `match_full`'s
match timer end in) also notes each span's end on the host clock, and the
harness notes each job's start and end.

After the window, the device's operations are merged into busy intervals
inside the window (all operations, and kernels alone); the device ops
that took most time and the longest idle gaps, each named by the
innermost span that covers its middle, make the result line's
`breakdown`.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

TOP = 10
NAME_CHARS = 120
COPY_PREFIXES = ("Memcpy", "Memset")


class Tracer:
    """A device profiler around the measured window when `enabled`; a
    no-op otherwise."""

    def __init__(self, enabled: bool, device: torch.device, telemetry):
        self.enabled = enabled
        self.device = device
        self.tel = telemetry
        self.prof = None
        self.spans: List[Tuple[str, int, int]] = []
        self.w0 = self.w1 = 0

    def __enter__(self):
        if self.enabled:
            acts = [torch.profiler.ProfilerActivity.CUDA
                    if self.device.type == "cuda"
                    else torch.profiler.ProfilerActivity.CPU]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            add_time = self.tel.add_time

            def noting(name, seconds):
                end = time.time_ns()
                self.spans.append((name, end - int(seconds * 1e9), end))
                add_time(name, seconds)
            self.tel.add_time = noting
            self.w0 = time.time_ns()
        return self

    def job(self, start_ns: int, end_ns: int) -> None:
        if self.enabled:
            self.spans.append(("sfmbench job", start_ns, end_ns))

    def __exit__(self, *exc):
        if self.enabled:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.w1 = time.time_ns()
            del self.tel.add_time            # the method again
            self.prof.__exit__(*exc)
        return False

    def read(self) -> Optional[Dict]:
        """busy_s, kernel_busy_s, window_s, device_ops and idle_gaps of
        the traced window (None when not traced)."""
        if not self.enabled:
            return None
        names, starts, ends = [], [], []
        cuda = torch.autograd.DeviceType.CUDA
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() == cuda and not ev.is_user_annotation():
                names.append(ev.name())
                starts.append(ev.start_ns())
                ends.append(ev.end_ns())
        self.prof = None
        return summarize(self.w0, self.w1, names,
                         np.array(starts, np.int64),
                         np.array(ends, np.int64), self.spans)


def merge(starts: np.ndarray, ends: np.ndarray, w0: int, w1: int):
    """Union of [start, end) intervals clipped to [w0, w1), sorted."""
    s = np.clip(starts, w0, w1)
    e = np.clip(ends, w0, w1)
    keep = e > s
    s, e = s[keep], e[keep]
    order = np.argsort(s, kind="stable")
    out = []
    for a, b in zip(s[order].tolist(), e[order].tolist()):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def summarize(w0: int, w1: int, names: List[str], starts, ends,
              spans: List[Tuple[str, int, int]]) -> Dict:
    busy = merge(starts, ends, w0, w1)
    kernel = np.array([not n.startswith(COPY_PREFIXES) for n in names],
                      bool)
    kernel_busy = merge(starts[kernel], ends[kernel], w0, w1) \
        if len(names) else []
    per_op: Dict[str, int] = {}
    for name, a, b in zip(names, starts.tolist(), ends.tolist()):
        per_op[name] = per_op.get(name, 0) + (b - a)
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP]
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    named = []
    for a, b in gaps:
        mid = (a + b) // 2
        inside = [s for s in spans if s[1] <= mid < s[2]]
        name = max(inside, key=lambda s: s[1])[0] if inside \
            else "outside every span"
        named.append([name, (b - a) / 1e9])
    outside = int(((starts < w0) | (ends > w1)).sum()) if len(names) else 0
    return {"busy_s": sum(b - a for a, b in busy) / 1e9,
            "kernel_busy_s": sum(b - a for a, b in kernel_busy) / 1e9,
            "window_s": (w1 - w0) / 1e9,
            "device_ops": [[n[:NAME_CHARS], t / 1e9] for n, t in ops],
            "idle_gaps": named, "device_events": len(names),
            "events_outside_window": outside}

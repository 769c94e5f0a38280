"""`ba_graph_share` on hand-made records: the share of the window's LM
iterations replayed as CUDA graphs, and None where no job has the counter
(a program without the graphs)."""

from __future__ import annotations

import pytest

from sfmbench import harness


def _record(*counters):
    return {"setup_s": 1.0, "window_s": 2.0, "trace": None,
            "jobs": [{"wall_s": 1.0, "stages": {}, "counters": dict(c)}
                     for c in counters]}


@pytest.mark.parametrize("counters,want", [
    (({"lm_iters": 384.0, "ba_graph_iters": 384.0},) * 3, 100.0),
    (({"lm_iters": 300.0, "ba_graph_iters": 100.0},
      {"lm_iters": 100.0}), 25.0),
    (({"lm_iters": 0.0, "ba_graph_iters": 0.0},), None),
    (({"lm_iters": 384.0},) * 2, None),
    ((), None),
])
def test_ba_graph_share(counters, want):
    mod = harness.load_module(harness.PKG, "metrics", "ba_graph_share")
    got = mod.read(_record(*counters))
    assert got == (None if want is None else pytest.approx(want))

"""The per-layer metrics read from the program's spans and counters, on
hand-made records: each returns its value where the span or counter is
there, and None where it is not."""

from __future__ import annotations

import pytest

from sfmbench import harness

SFM_STAGES = {"total": 10.0, "init_pair": 1.0, "ba_build": 0.5, "ba": 3.0,
              "ba_apply": 0.25, "candidates": 0.125, "register": 4.0,
              "add_points": 0.5, "prune": 0.25, "round_outputs": 0.125,
              "write_bundle": 0.0625, "resection": 0.5,
              "refine_camera": 3.0, "triangulate": 0.25, "sift": 0.6}
SFM_COUNTERS = {"refine_lm_iters": 300.0, "lm_iters": 388.0}
MATCH_STAGES = {"read_keys": 0.75, "match": 0.375, "match_table": 0.0625,
                "match_fetch": 0.25, "match_decode": 0.0625}


def _record(stages, counters, jobs=2):
    return {"setup_s": 1.0, "window_s": 2.0, "trace": None,
            "jobs": [{"wall_s": 1.0, "stages": dict(stages),
                      "counters": dict(counters)} for _ in range(jobs)]}


CASES = {
    "refine_lm_iters": (SFM_STAGES, SFM_COUNTERS, 300.0),
    "refine_ms_per_iter": (SFM_STAGES, SFM_COUNTERS, 10.0),
    "ba_build_s": (SFM_STAGES, SFM_COUNTERS, 0.5),
    "sfm_self_s": (SFM_STAGES, SFM_COUNTERS, 0.1875),
    "read_keys_s": (MATCH_STAGES, {}, 0.75),
    "match_decode_s": (MATCH_STAGES, {}, 0.0625),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reads_its_value(name):
    stages, counters, want = CASES[name]
    mod = harness.load_module(harness.PKG, "metrics", name)
    assert mod.read(_record(stages, counters)) == pytest.approx(want)


@pytest.mark.parametrize("name,drop", [
    ("refine_lm_iters", "refine_lm_iters"),
    ("refine_ms_per_iter", "refine_lm_iters"),
    ("ba_build_s", "ba_build"),
    ("sfm_self_s", "ba_build"),
    ("sfm_self_s", "total"),
    ("read_keys_s", "read_keys"),
    ("match_decode_s", "match_decode"),
])
def test_silent_without_its_span(name, drop):
    stages, counters, _ = CASES[name]
    stages = {k: v for k, v in stages.items() if k != drop}
    counters = {k: v for k, v in counters.items() if k != drop}
    mod = harness.load_module(harness.PKG, "metrics", name)
    assert mod.read(_record(stages, counters)) is None
    assert mod.read(_record(stages, counters, jobs=0)) is None


def test_sfm_self_s_subtracts_only_direct_children():
    """Spans nested deeper (resection, refine_camera, triangulate) and
    spans outside `total` (sift) are not subtracted."""
    mod = harness.load_module(harness.PKG, "metrics", "sfm_self_s")
    direct = sum(SFM_STAGES[c] for c in mod.CHILDREN if c in SFM_STAGES)
    assert set(mod.CHILDREN).isdisjoint({"resection", "refine_camera",
                                         "triangulate", "sift", "total"})
    assert mod.read(_record(SFM_STAGES, {})) == \
        pytest.approx(SFM_STAGES["total"] - direct)

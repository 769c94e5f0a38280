"""The port's span log and counters (`utils/telemetry.py`): nesting and
parents, the log off by default, one `add_time` call a span (the hook the
benchmark's tracer wraps), the clock shared with torch.profiler, the
refine LM's iteration counter, and the spans of both jobs written by
`--telemetry`, against the set of spans `sfmbench/metrics/sfm_self_s.py`
subtracts."""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from bundler_sfm_tpu_torch.ops import lm as T_lm
from bundler_sfm_tpu_torch.utils import get_telemetry, span_log, stage
from tests.synthetic import Scene, random_rotation


@pytest.fixture
def tel():
    t = get_telemetry()
    t.reset()
    t.log_spans(False)
    yield t
    t.log_spans(False)
    t.reset()


def _nested():
    with stage("a"):
        with stage("b"):
            with stage("c"):
                pass
        with stage("d"):
            pass
    with stage("e"):
        pass


def test_spans_nest_with_parents(tel):
    tel.log_spans(True)
    _nested()
    got = [s.as_list() for s in tel.spans]
    assert [(n, p) for n, _, _, p in got] == [
        ("a", -1), ("b", 0), ("c", 1), ("d", 0), ("e", -1)]
    for name, start, end, parent in got:
        assert start <= end
        if parent >= 0:
            assert got[parent][1] <= start and end <= got[parent][2]
    assert tel.stage_calls == {k: 1 for k in "abcde"}
    assert tel.report()["spans"] == got
    tel.reset()                          # the log stays on, emptied
    assert tel.spans == [] and tel.stage_seconds == {}


def test_log_is_off_by_default(tel):
    assert tel.spans is None
    _nested()
    assert tel.spans is None and "spans" not in tel.report()
    assert set(tel.stage_seconds) == set("abcde")


@pytest.mark.parametrize("log", [False, True], ids=["log_off", "log_on"])
def test_wrapped_add_time_sees_every_span_once(tel, log):
    """`sfmbench/trace.py` replaces the instance's `add_time` while a
    window is traced; every span must end in exactly one call of it."""
    tel.log_spans(log)
    seen = []
    add_time = tel.add_time

    def noting(name, seconds):
        seen.append((name, seconds))
        add_time(name, seconds)
    tel.add_time = noting
    try:
        _nested()
    finally:
        del tel.add_time
    assert [n for n, _ in seen] == ["c", "b", "d", "a", "e"]
    assert all(s >= 0 for _, s in seen)
    assert tel.stage_calls == {k: 1 for k in "abcde"}
    if log:
        by_name = {s.name: s.seconds for s in tel.spans}
        assert dict(seen) == by_name


def test_spans_share_the_profilers_clock(tel):
    """A torch.profiler event opened inside a span lies inside the
    span's [start_ns, end_ns]: both read the same clock."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with stage("outer") as span:
            with torch.profiler.record_function("inside_span"):
                torch.ones(64).sum()
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "inside_span"]
    assert len(ev) == 1
    assert span.start_ns <= ev[0].start_ns() <= ev[0].end_ns() \
        <= span.end_ns


def test_refine_lm_iters_counts_the_iterations_run(tel, rng, monkeypatch):
    """One count a pass of camera_refine_batch's loop that does work: each
    such pass solves its damped system once."""
    B, N = 3, 80
    sc = Scene(rng, num_cams=B, num_pts=N, noise=0.4)
    cam0 = np.zeros((B, 9))
    R0 = np.stack([random_rotation(rng, 0.02) @ sc.R[b] for b in range(B)])
    cam0[:, 0:3] = sc.centers + rng.normal(size=(B, 3)) * 0.05
    cam0[:, 6] = sc.f * np.array([1.0, 1.05, 0.95])
    pts = np.broadcast_to(sc.points, (B, N, 3)).copy()
    projs = np.stack([sc.obs[b] for b in range(B)])
    projs[:, :8] += rng.normal(0.0, 30.0, (B, 8, 2))      # outliers to trim
    mask = rng.random((B, N)) < 0.95
    solves = []
    real = T_lm.cholesky_solve

    def counting(*a, **k):
        solves.append(1)
        return real(*a, **k)
    monkeypatch.setattr(T_lm, "cholesky_solve", counting)
    t = torch.from_numpy
    T_lm.camera_refine_trim_batch(
        t(cam0), t(R0), t(pts), t(projs), t(mask), True, False,
        t(np.zeros(B)), t(np.zeros(B)), 100.0, 50, 1e-3, 2.0, 8.0, 16.0)
    assert len(solves) > 2
    assert tel.counters["refine_lm_iters"] == len(solves)


def test_refine_on_cpu_takes_the_plain_path(tel, rng):
    """camera_refine_batch on CPU tensors runs the plain version: no kernel
    launch is counted, and each lane's iteration count comes back (0 for
    a lane outside `active`); the kernel's wrapper refuses CPU tensors."""
    from bundler_sfm_tpu_torch.ops import lm_cuda
    B, N = 2, 40
    sc = Scene(rng, num_cams=B, num_pts=N, noise=0.4)
    cam0 = np.zeros((B, 9))
    cam0[:, 0:3] = sc.centers + rng.normal(size=(B, 3)) * 0.05
    cam0[:, 6] = sc.f
    t = torch.from_numpy
    args = (t(cam0), t(sc.R), t(np.broadcast_to(sc.points, (B, N, 3)).copy()),
            t(np.stack(sc.obs)), torch.ones((B, N), dtype=torch.bool))
    before = dict(lm_cuda.LAUNCHES)
    cam, R, cost, iters = T_lm.camera_refine_batch(
        *args, active=torch.tensor([True, False]))
    assert lm_cuda.LAUNCHES == before
    assert "refine_lm_launches" not in tel.counters
    assert iters.dtype == torch.int32 and iters[0] > 0 and iters[1] == 0
    assert torch.equal(cam[1], args[0][1]) and torch.equal(R[1], args[1][1])
    with pytest.raises(ValueError, match="needs CUDA"):
        lm_cuda.refine_lm(*args, True, False, 0.0, 0.0, 100.0, 50, 1e-3)


def _self_s():
    from sfmbench import harness
    return harness.load_module(harness.PKG, "metrics", "sfm_self_s")


def test_run_bundler_telemetry_names_stage_5s_steps(tel, tmp_path,
                                                     monkeypatch):
    """`run_bundler --telemetry` on an 8-view render: the spans directly
    inside `total` are the ones `sfm_self_s` subtracts (of those that
    ran), none of them holds another, and the log is off again after."""
    from bundler_sfm_tpu_torch import run_bundler
    from bundler_sfm_tpu_torch.utils.render_scene import render_box_room
    monkeypatch.chdir(tmp_path)
    render_box_room("imgs", n=8, W=320, H=240, f=160.0)
    with contextlib.redirect_stdout(io.StringIO()):
        assert run_bundler.main(["imgs", "--device", "cpu", "--init_focal",
                                 "160", "--max_keys", "1024",
                                 "--telemetry", "tel.json"]) == 0
    assert tel.spans is None
    rep = json.loads((tmp_path / "tel.json").read_text())
    spans = rep["spans"]
    names = {s[0] for s in spans}
    assert {"focal", "sift", "match", "write_matches", "key_colors",
            "verify", "total"} <= names
    for name, start, end, parent in spans:
        assert start <= end and parent < len(spans)
    (total,) = [k for k, s in enumerate(spans) if s[0] == "total"]
    direct = {s[0] for s in spans if s[3] == total}
    children = _self_s().CHILDREN
    assert direct == {c for c in children if c in rep["stages_s"]}
    assert {"ba_build", "ba", "ba_apply", "candidates", "round_outputs",
            "write_bundle"} <= direct
    assert not any(s[3] >= 0 and spans[s[3]][0] in children
                   for s in spans if s[0] in children)
    # The reader on the job's stage seconds: total less its children.
    self_s = _self_s().read({"jobs": [{"stages": tel.stage_seconds}]})
    inner = sum(s[2] - s[1] for s in spans if s[3] == total) / 1e9
    assert self_s == pytest.approx(tel.stage_seconds["total"] - inner,
                                   abs=1e-6)
    assert 0 <= self_s < 0.05 * tel.stage_seconds["total"]
    assert rep["counters"]["refine_lm_iters"] > 0
    assert rep["counters"]["ba_host_syncs"] > 0


def test_keymatch_telemetry_names_the_match_jobs_steps(tel, tmp_path):
    from bundler_sfm_tpu_torch import keymatch
    from bundler_sfm_tpu_torch.io.keyfile import write_key_file
    rng = np.random.default_rng(1)
    base = rng.integers(0, 256, (40, 128))
    files = []
    for i in range(3):
        info = np.zeros((40, 4), np.float32)
        info[:, :2] = rng.random((40, 2)) * 100
        desc = np.clip(base + rng.integers(-3, 4, base.shape), 0, 255)
        files.append(str(tmp_path / f"img{i}.key"))
        write_key_file(files[-1], info, desc.astype(np.uint8))
    (tmp_path / "list.txt").write_text("\n".join(files) + "\n")
    with contextlib.redirect_stdout(io.StringIO()):
        keymatch.main([str(tmp_path / "list.txt"), str(tmp_path / "m.txt"),
                       "--device", "cpu", "--telemetry",
                       str(tmp_path / "tel.json")])
    assert tel.spans is None
    spans = json.loads((tmp_path / "tel.json").read_text())["spans"]
    parents = {s[0]: (spans[s[3]][0] if s[3] >= 0 else None) for s in spans}
    assert parents == {"read_keys": None, "match": None,
                       "match_table": "match", "match_fetch": "match",
                       "match_decode": "match"}
    assert (tmp_path / "m.txt").read_text().count("\n") > 3


def test_span_log_writes_nothing_without_a_path(tel, tmp_path):
    with span_log(None):
        _nested()
    assert tel.spans is None and not os.listdir(tmp_path)

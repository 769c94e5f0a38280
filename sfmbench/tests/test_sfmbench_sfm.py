"""Job kind `sfm` on the CPU: the frozen arc generator against the
program's, set-up's matches.init.txt against the port's keymatch CLI, a
tiny `sfm` cell (`tinyarc.s8`: 8 arc views of 768 keys) end to end,
traced and not, a moved camera, the skip_full_bundle control and a bfloat16
stage-5 state read not correct, the float32 control computes stage 5 in
float32, and the cell's four span readers silent on a record without
their spans (a program that lacks them)."""

from __future__ import annotations

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from bundler_sfm_tpu_torch.io import bundlefile
from bundler_sfm_tpu_torch.probes.e2e_synthetic import synthesize

from sfmbench import harness
from sfmbench.gen import arc

from .conftest import make_tree

CELL, REAL = "tinyarc.s8", "arc2048.sfm32"
# The readers the cell shares with room800.full24 that read on the CPU
# (device_idle.sfm and peak_gib.sfm need the card).
SHARED = {"verify_s", "tracks_s", "register_s", "points_s",
          "ba_ms_per_iter", "lm_iters", "refine_lm_iters",
          "refine_ms_per_iter", "ba_build_s", "sfm_self_s"}
READERS = {"load_keys_s": ("load_keys",),
           "key_colors_s": ("key_colors",),
           "read_matches_s": ("read_matches",),
           "verify_io_s": ("match_snapshots", "write_constraints")}
TINY_FILES = {
    "configs/tinyarc.json": {"width": 1024, "height": 768, "focal": 900.0,
                             "pixel_noise": 0.4, "scene_seed": 0,
                             "ratio": 0.6, "min_matches": 16},
    "traffic/s8.json": {"job": "sfm", "views": 8, "keys": 768,
                        "track_ratio": 0.6, "warmup_jobs": 0},
    # The program reads 0.2952 / 0.3105 px, ate 0.00202 / 0.00370 (float32
    # 0.2952 / 0.3105, 0.00201 / 0.00369); skip_full_bundle 0.4173 /
    # 0.7608 px, ate 0.00989 / 0.01906; a bfloat16 state 0.9764 / 1.6747
    # px, ate 0.00459 / 0.00714.
    "cells/tinyarc.s8.json": {"limits": {"cameras_missing": 0,
                                         "reproj_px": 0.35,
                                         "reproj_cam_max_px": 0.5,
                                         "ate_rel": 0.005,
                                         "ate_max_rel": 0.01}},
}


@pytest.fixture(scope="module")
def arc_tree(tmp_path_factory):
    """The benchmark copied with the tiny cell beside `arc2048.sfm32`."""
    root = tmp_path_factory.mktemp("arcbench")
    data = make_tree(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "tinyarc",
                               "traffic": "s8", "chips": 1,
                               "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        wl = m.get("workloads")
        if wl and REAL in wl:
            wl.append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for rel, obj in TINY_FILES.items():
        (data / rel).write_text(json.dumps(obj))
    return data


def _run(data, trace=False):
    return harness.run_cell(CELL, 2 ** 31 + 11, 0.0, trace, device="cpu",
                            bench_path=str(data.parent / "BENCHMARK.json"),
                            data_root=str(data))


def test_arc_copy_draws_the_same():
    a = synthesize(6, 256, 0.6, seed=3)
    b = arc.synthesize(6, 256, 0.6, seed=3)
    for x, y in zip(a[:2], b[:2]):
        assert len(x) == len(y) == 6
        for u, v in zip(x, y):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)
    for k in ("centers", "Rs"):
        np.testing.assert_array_equal(a[2][k], b[2][k])


def test_match_table_equals_keymatch_cli(tmp_path):
    from bundler_sfm_tpu_torch import keymatch
    job = harness.load_module(harness.PKG, "jobs", "sfm")
    infos, descs, _ = arc.synthesize(6, 256, 0.6, seed=5)
    pairs = job.write_collection(str(tmp_path), infos, descs, 900.0, 0.6,
                                 16, torch.device("cpu"))
    assert 0 < pairs <= 15
    (tmp_path / "list_keys.txt").write_text("".join(
        f"{tmp_path}/images/img{i:04d}.key\n" for i in range(6)))
    with contextlib.redirect_stdout(io.StringIO()):
        assert keymatch.main([str(tmp_path / "list_keys.txt"),
                              str(tmp_path / "km.txt"), "--device",
                              "cpu"]) == 0
    assert (tmp_path / "km.txt").read_bytes() == \
        (tmp_path / "matches.init.txt").read_bytes()
    assert (tmp_path / "options.txt").read_text().splitlines() == \
        list(job.OPTIONS)


def test_tiny_cell_end_to_end(arc_tree):
    r = _run(arc_tree)
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"images_per_s", "setup_s"}
    assert r["metrics"]["images_per_s"]["value"] > 0
    t = _run(arc_tree, trace=True)
    assert t["correct"] is True
    assert set(t["metrics"]) == set(READERS) | SHARED
    assert all(m["value"] > 0 for m in t["metrics"].values())


def test_moved_camera_is_not_correct(arc_tree, monkeypatch):
    orig = bundlefile.write_bundle_file

    def moved(path, b):
        cam = next(c for c in b.cameras if c.f != 0)
        cam.t = np.asarray(cam.t) + 0.2
        orig(path, b)
    import bundler_sfm_tpu_torch.pipeline.incremental as inc
    monkeypatch.setattr(inc, "write_bundle_file", moved)
    assert _run(arc_tree)["correct"] is False


def _control_checks(arc_tree, tmp_path, kind):
    root = str(arc_tree)
    job = harness.load_module(root, "jobs", "sfm")
    limits = harness.load_json(root, "cells", CELL)["limits"]
    dev = torch.device("cpu")
    inputs = job.prepare(harness.load_json(root, "configs", "tinyarc"),
                         harness.load_json(root, "traffic", "s8"), 3,
                         str(tmp_path), dev)
    (tmp_path / "ctl").mkdir()
    with contextlib.redirect_stdout(io.StringIO()):
        answer = getattr(job, kind)(inputs, str(tmp_path / "ctl"), dev, 3)
    return {c["name"]: c["value"] > c["limit"]
            for c in job.judge(inputs, [answer], limits, 3, dev)}


def test_skip_full_bundle_is_not_correct(arc_tree, tmp_path):
    assert any(_control_checks(arc_tree, tmp_path,
                               "control_skip_full_bundle").values())


def test_bfloat16_state_fails_the_reprojection_limits(arc_tree, tmp_path):
    failed = _control_checks(arc_tree, tmp_path, "control_bfloat16")
    assert failed["reproj_px"] and failed["reproj_cam_max_px"]


def test_float32_control_computes_stage5_in_float32():
    from bundler_sfm_tpu_torch.ops import lm, rotations
    from bundler_sfm_tpu_torch.pipeline import incremental as inc
    job = harness.load_module(harness.PKG, "jobs", "sfm")
    before = (inc._T, inc.build_problem, lm.camera_refine_batch,
              rotations.rodrigues, inc._np)
    with job._float32_stage5(torch.bfloat16):
        assert inc._T(np.ones(2), "cpu").dtype == torch.float32
        assert inc._T(np.ones(2), "cpu", torch.int64).dtype == torch.int64
        prob = inc.build_problem(np.eye(3)[None], np.zeros((1, 9)),
                                 np.ones((1, 3)), [0], [0],
                                 np.zeros((1, 2)), device="cpu")
        floats = [v.dtype for v in vars(prob).values()
                  if isinstance(v, torch.Tensor) and v.is_floating_point()]
        assert floats and set(floats) == {torch.float32}
        assert lm.camera_refine_batch is lm.camera_refine_batch_plain
        R = torch.eye(3).expand(2, 3, 3)
        assert rotations.rot_update(R, torch.full((2, 3), 0.1)).dtype == \
            torch.float32
        third = torch.tensor([1 / 3])
        assert inc._np(third)[0] == third.to(torch.bfloat16).float()[0]
    assert (inc._T, inc.build_problem, lm.camera_refine_batch,
            rotations.rodrigues, inc._np) == before


def _record(stages):
    return {"setup_s": 1.0, "window_s": 2.0, "trace": None,
            "jobs": [{"wall_s": 1.0, "stages": dict(stages),
                      "counters": {}} for _ in range(2)]}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_its_spans_and_none_without(name):
    mod = harness.load_module(harness.PKG, "metrics", name)
    spans = READERS[name]
    stages = {s: 0.25 * (k + 1) for k, s in enumerate(spans)}
    want = sum(stages.values())
    # What the program without these spans records in the same job.
    parent = {"verify": 1.0, "verify_fmatrix": 0.5, "total": 4.0,
              "ba": 2.0}
    assert mod.read(_record({**parent, **stages})) == pytest.approx(want)
    assert mod.read(_record(parent)) is None
    assert mod.read(_record({})) is None

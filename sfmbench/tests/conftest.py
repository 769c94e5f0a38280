"""A copy of the benchmark in a temporary directory with tiny cells that
the CPU runs in seconds: `tinyroom.f16` (16 views at 320x240, the port's
smallest render that registers every view) and `tinyroom.m6`
(KeyMatchFull over the SIFT keys of 6 of its views).  The copy's
BENCHMARK.json adds them to the metrics' workloads beside the real
cells."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
FULL, MATCH = "room800.full24", "room800.match128"
TINY_FULL, TINY_MATCH = "tinyroom.f16", "tinyroom.m6"

TINY_FILES = {
    "configs/tinyroom.json": {"width": 320, "height": 240, "focal": 160.0,
                              "max_keys": 1024, "ratio": 0.6,
                              "min_matches": 16, "scene_seed": 4,
                              "sheet_size": 512, "contrast_thr": 0.02},
    "traffic/f16.json": {"job": "full", "views": 16, "warmup_jobs": 0},
    "traffic/m6.json": {"job": "match", "views": 6, "checked_pairs": 12,
                        "warmup_jobs": 1},
    "cells/tinyroom.f16.json": {"limits": {"cameras_missing": 0,
                                           "reproj_px": 0.5,
                                           "reproj_cam_max_px": 1.0,
                                           "ate_rel": 0.06,
                                           "ate_max_rel": 0.15}},
    "cells/tinyroom.m6.json": {"limits": {"pairs_differing": 0}},
}


def make_tree(root: Path) -> Path:
    """The benchmark copied under `root` with the tiny cells; returns the
    copy's data root (`root/sfmbench`)."""
    shutil.copytree(REPO / "sfmbench", root / "sfmbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"] += [
        {"name": TINY_FULL, "config": "tinyroom", "traffic": "f16",
         "chips": 1, "why": "CPU test"},
        {"name": TINY_MATCH, "config": "tinyroom", "traffic": "m6",
         "chips": 1, "why": "CPU test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        wl = m.get("workloads")
        if wl and FULL in wl:
            wl.append(TINY_FULL)
        if wl and MATCH in wl:
            wl.append(TINY_MATCH)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for rel, obj in TINY_FILES.items():
        (root / "sfmbench" / rel).write_text(json.dumps(obj))
    return root / "sfmbench"


@pytest.fixture(scope="session")
def tree(tmp_path_factory) -> Path:
    return make_tree(tmp_path_factory.mktemp("bench"))


def run_tiny(tree: Path, cell: str, seed: int = 3, trace: bool = False):
    from sfmbench import harness
    return harness.run_cell(cell, seed, 0.0, trace, device="cpu",
                            bench_path=str(tree.parent / "BENCHMARK.json"),
                            data_root=str(tree))


@pytest.fixture(scope="session")
def full_job(tree, tmp_path_factory):
    """One tiny `full` job run directly: (inputs, bundle.out path)."""
    import contextlib
    import io

    import torch

    from sfmbench import harness
    job = harness.load_module(str(tree), "jobs", "full")
    work = tmp_path_factory.mktemp("fulljob")
    inputs = job.prepare(harness.load_json(str(tree), "configs", "tinyroom"),
                         harness.load_json(str(tree), "traffic", "f16"), 3,
                         str(work), torch.device("cpu"))
    (work / "job").mkdir()
    with contextlib.redirect_stdout(io.StringIO()):
        path = job.run(inputs, str(work / "job"), torch.device("cpu"))
    return inputs, path


@pytest.fixture(scope="session")
def match_inputs(tree, tmp_path_factory):
    """The tiny `match` cell's inputs (SIFT keys of 6 views on the CPU)."""
    import torch

    from sfmbench import harness
    job = harness.load_module(str(tree), "jobs", "match")
    return job.prepare(harness.load_json(str(tree), "configs", "tinyroom"),
                       harness.load_json(str(tree), "traffic", "m6"), 3,
                       str(tmp_path_factory.mktemp("matchinputs")),
                       torch.device("cpu"))

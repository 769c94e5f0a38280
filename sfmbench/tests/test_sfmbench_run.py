"""Whole runs of the tiny cells on the CPU (the harness's look for a card
skipped): the result line's keys, cells, traffic and metrics found by
name, the traced run, and the command's refusal without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from sfmbench import harness

from .conftest import REPO, TINY_FULL, TINY_MATCH, make_tree, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell,e2e", [(TINY_MATCH, "pairs_per_s"),
                                      (TINY_FULL, "images_per_s")])
def test_result_line(tree, cell, e2e):
    r = run_tiny(tree, cell)
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {e2e, "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    json.loads(json.dumps(r))


def test_traced_run_reports_per_layer_metrics(tree):
    r = run_tiny(tree, TINY_MATCH, trace=True)
    # The CPU has no device trace: the device metrics stay silent.
    assert set(r["metrics"]) == {"key_read_s", "match_s"}
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_new_files_are_found_by_name(tmp_path):
    data = make_tree(tmp_path)
    (data / "configs" / "room64.json").write_text(json.dumps(
        {"width": 128, "height": 96, "focal": 64.0, "max_keys": 256,
         "ratio": 0.6, "min_matches": 4, "scene_seed": 1, "sheet_size": 256,
         "contrast_thr": 0.02}))
    (data / "traffic" / "m5.json").write_text(json.dumps(
        {"job": "match", "views": 5, "checked_pairs": 10,
         "warmup_jobs": 0}))
    (data / "cells" / "room64.m5.json").write_text(json.dumps(
        {"limits": {"pairs_differing": 0}}))
    (data / "metrics" / "jobs_run.py").write_text(
        "def read(record):\n    return float(len(record['jobs']))\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "room64.m5", "config": "room64",
                               "traffic": "m5", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "jobs_run", "unit": "jobs",
                               "better": "higher", "source": "host_clock",
                               "layer": "harness", "moves": "pairs_per_s",
                               "workloads": ["room64.m5"]})
    bench["end_to_end"][1]["workloads"].append("room64.m5")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    r = harness.run_cell("room64.m5", 9, 0.0, True, device="cpu",
                         bench_path=str(tmp_path / "BENCHMARK.json"),
                         data_root=str(data))
    assert r["correct"] and r["metrics"]["jobs_run"]["value"] == 1.0


def test_command_refuses_without_a_card(tmp_path):
    make_tree(tmp_path)
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    env.pop("PYTHONSAFEPATH", None)
    p = subprocess.run([sys.executable, "-m", "sfmbench.run", "--workload",
                        TINY_MATCH, "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_command_on_the_card(tmp_path):
    """The command end to end on a card, a tiny cell (skips on a CPU
    host)."""
    if not __import__("torch").cuda.is_available():
        pytest.skip("needs a CUDA card")
    make_tree(tmp_path)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    p = subprocess.run([sys.executable, "-m", "sfmbench.run", "--workload",
                        TINY_MATCH, "--seed", str(2 ** 31 + 9), "--seconds",
                        "2", "--trace", "1"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0
    assert 0 < r["metrics"]["two_nn_roofline"]["value"] <= 100

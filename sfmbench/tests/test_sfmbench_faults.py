"""Runs with the timed path broken underneath, and the lower-precision
or guarantee-breaking controls: each must come out not correct.

Faults a cell can have (none of these cells spans cards, so no exchange
between chips can be left out):
  full   a bundle adjustment that returns its state unchanged; an answer
         (one camera of bundle.out) altered where it is written
  match  half of the pairs left out; an answer (one match a pair)
         altered where it is produced
"""

from __future__ import annotations

import contextlib
import io

import numpy as np
import pytest
import torch

from bundler_sfm_tpu_torch.io import bundlefile
from bundler_sfm_tpu_torch.ops import ba, matching

from sfmbench import harness

from .conftest import TINY_FULL, TINY_MATCH, run_tiny


def test_match_half_the_pairs_left_out(tree, monkeypatch):
    orig = matching.DescriptorTable.match_pairs

    def half(self, pairs, *a, **kw):
        return orig(self, pairs[: len(pairs) // 2], *a, **kw)
    monkeypatch.setattr(matching.DescriptorTable, "match_pairs", half)
    r = run_tiny(tree, TINY_MATCH)
    assert r["correct"] is False
    assert r["checks"]["pairs_differing"]["value"] > 0


def test_match_answer_altered(tree, monkeypatch):
    orig = matching.decode_masked_rows

    def altered(*a, **kw):
        out = orig(*a, **kw)
        for m in out.values():
            m[0, 1] += 1
        return out
    monkeypatch.setattr(matching, "decode_masked_rows", altered)
    assert run_tiny(tree, TINY_MATCH)["correct"] is False


def test_full_bundle_adjustment_returns_its_state_unchanged(
        tree, monkeypatch):
    orig = ba._lm_loop

    def unchanged(prob, *a, **kw):
        cam, pts, cost, cost0, it, mu = orig(prob, *a, **kw)
        return prob.cam0, prob.pts0, cost0, cost0, it, mu
    monkeypatch.setattr(ba, "_lm_loop", unchanged)
    assert run_tiny(tree, TINY_FULL)["correct"] is False


def test_full_answer_altered(tree, monkeypatch):
    orig = bundlefile.write_bundle_file

    def altered(path, b):
        cam = next(c for c in b.cameras if c.f != 0)
        cam.t = np.asarray(cam.t) + 0.2
        orig(path, b)
    monkeypatch.setattr(bundlefile, "write_bundle_file", altered)
    import bundler_sfm_tpu_torch.pipeline.incremental as inc
    monkeypatch.setattr(inc, "write_bundle_file", altered)
    assert run_tiny(tree, TINY_FULL)["correct"] is False


@pytest.mark.parametrize("cell,kind,config,traffic,control", [
    (TINY_FULL, "full", "tinyroom", "f16", "control_skip_full_bundle"),
    (TINY_MATCH, "match", "tinyroom", "m6", "control")])
def test_control_is_not_correct(tree, tmp_path, cell, kind, config, traffic,
                                control):
    """The controls that `sfmbench/control.py` reads on the card, at a size
    the CPU holds: `full` with the port's skip_full_bundle, `match` with
    the reference at 4 bits an entry."""
    root = str(tree)
    job = harness.load_module(root, "jobs", kind)
    limits = harness.load_json(root, "cells", cell)["limits"]
    dev = torch.device("cpu")
    inputs = job.prepare(harness.load_json(root, "configs", config),
                         harness.load_json(root, "traffic", traffic), 3,
                         str(tmp_path), dev)
    (tmp_path / "ctl").mkdir()
    with contextlib.redirect_stdout(io.StringIO()):
        answer = getattr(job, control)(inputs, str(tmp_path / "ctl"), dev, 3)
    checks = job.judge(inputs, [answer], limits, 3, dev)
    assert not all(c["value"] <= c["limit"] for c in checks)

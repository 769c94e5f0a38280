"""The plain reference against the program's plain CPU path on the same
inputs, and the lower-precision control against the reference."""

from __future__ import annotations

import numpy as np

from bundler_sfm_tpu_torch.ops.matching import DescriptorTable
from bundler_sfm_tpu_torch.probes.e2e_synthetic import model_quality

from sfmbench.reference import bundle, matching


def _pairs(n):
    return [(j, i) for i in range(n) for j in range(i)]


def test_reference_matches_the_program_on_the_cpu(match_inputs):
    descs, pairs = match_inputs["descs"], match_inputs["pairs"]
    got = DescriptorTable(descs, device="cpu").match_pairs(
        pairs, ratio=0.6, min_matches=16)
    for a, b in pairs:
        want = matching.match_pair(descs[a], descs[b], 0.6, 16)
        assert (want is None) == ((a, b) not in got)
        if want is not None:
            np.testing.assert_array_equal(got[(a, b)], want)
    assert len(got) >= len(pairs) // 3


def test_reference_ties_go_to_the_lowest_index():
    q = np.zeros((1, 128), np.uint8)
    db = np.full((3, 128), 200, np.uint8)
    db[1] = 0
    db[2] = 0
    m = matching.match_pair(q, db, 0.6, 0)
    assert m is None or len(m) == 0          # d0 == d1: the ratio fails
    db[2] = 1
    m = matching.match_pair(q, db, 0.99, 0)
    np.testing.assert_array_equal(m, [[0, 1]])


def test_int4_changes_matches_on_sift_keys(match_inputs):
    """On real SIFT descriptors many decisions lie near the ratio test's
    edge: keeping 4 bits an entry changes pairs (the match cell's
    control)."""
    descs = match_inputs["descs"]
    differing = 0
    for a, b in match_inputs["pairs"]:
        want = matching.match_pair(descs[a], descs[b], 0.6, 16)
        ctl = matching.match_pair(descs[a], descs[b], 0.6, 16, bits=4)
        differing += (want is None) != (ctl is None) or (
            want is not None and not np.array_equal(want, ctl))
    assert differing > 0


def test_similarity_recovers_a_known_transform():
    rng = np.random.default_rng(0)
    gt = rng.normal(size=(10, 3))
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R *= np.sign(np.linalg.det(R))
    est = 0.3 * gt @ R.T + 2.0
    s, Rs, muA, muB, ate = bundle.similarity(est, gt)
    assert ate < 1e-12
    np.testing.assert_allclose(muB + s * (est - muA) @ Rs.T, gt, atol=1e-12)


def test_scores_agree_with_the_programs_scoring(full_job):
    inputs, path = full_job
    mine = bundle.score(path, inputs["gt_centers"])
    theirs = model_quality(path, {"centers": inputs["gt_centers"]})
    assert mine["cameras"] == theirs["cameras"] == inputs["views"]
    assert mine["points"] == theirs["points"]
    assert abs(mine["reproj_px"] - theirs["mean_reproj_px"]) < 1e-4
    assert abs(mine["ate_rel"] - theirs["ate_rel"]) < 1e-5

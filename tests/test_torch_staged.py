"""The port's incremental-loop options against the JAX package's on
`make_pipeline_scene` (6 views, 250 points, 5% outlier matches, 0.3 px
noise), on the CPU in f64, with every RANSAC draw replayed from jax.random
(`JaxStageReplay`, the one-image "resection_one" draw included).

Held:
  * `bundle_adjust_slow`, by default and with construct_max_connectivity:
    the same registration order, 6/6 cameras, as many points (or the 1-ulp
    rule of tests/test_torch_recon.py), centres within 1e-6 of the JAX
    package's and within 0.02 of ground truth (similarity-aligned);
  * from one shared state: `fix_necker_reversal` within 1e-8,
    `estimate_ignored_cameras` recovering as many cameras, the panorama
    branch of `add_all_new_points` adding the same tracks with points
    within 1e-12, `run_sfm` with point constraints within 1e-8 with the
    same removed set and every anchored point kept, `refine_camera_iterative`
    within 1e-8;
  * `write_match_table`: byte-identical files.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import copy
import dataclasses

import numpy as np
import pytest

from tests.test_pipeline import similarity_align
from tests.test_torch_recon import (
    BUNDLE_SEED, JaxStageReplay, _port_scene, _scenes, _summary,
)

from bundler_sfm_tpu.pipeline import incremental as J_inc
from bundler_sfm_tpu.pipeline.scene import Scene as JaxScene

from bundler_sfm_tpu_torch.convert import (
    reconstruction_from_numpy, scene_from_numpy,
)
from bundler_sfm_tpu_torch.pipeline import incremental as T_inc


def _close(a, b, tol):
    a, b = np.stack(a), np.stack(b)
    assert np.abs(a - b).max() <= tol * np.abs(a).max()


def _same_state(jrec, trec, tol):
    assert list(trec.added_order) == list(jrec.added_order)
    assert [len(v) for v in trec.pt_views] == [len(v) for v in jrec.pt_views]
    for a, b in ((jrec.cam_params, trec.cam_params), (jrec.cam_R, trec.cam_R),
                 (jrec.points, trec.points)):
        _close(a, b, tol)


def _port(jrec):
    return reconstruction_from_numpy(**dataclasses.asdict(jrec))


@pytest.fixture(scope="module")
def base():
    js, syn, raw = _scenes()
    ts = _port_scene(js, raw)
    return dict(js=js, ts=ts, syn=syn, raw=raw)


@pytest.fixture(scope="module")
def pair_state(base):
    """The JAX package's initial pair after its first bundle."""
    js = copy.deepcopy(base["js"])
    i, j = J_inc.pick_initial_pair(js, True)
    jrec = J_inc.setup_initial_pair(js, i, j, seed=BUNDLE_SEED)
    J_inc.run_sfm(jrec, js, verbose=False)
    return jrec


@pytest.fixture(scope="module")
def three_state(base, pair_state):
    """pair_state with the best-connected third image registered by the
    JAX package's `bundle_initialize_image`."""
    js = copy.deepcopy(base["js"])
    jrec = copy.deepcopy(pair_state)
    counts = J_inc.find_candidate_images(jrec, js)
    img = max(counts.items(), key=lambda kv: kv[1])[0]
    assert J_inc.bundle_initialize_image(jrec, js, img, 2, seed=BUNDLE_SEED)
    return jrec


@pytest.mark.parametrize("connectivity", [False, True],
                         ids=["most_points", "max_connectivity"])
def test_bundle_adjust_slow(base, connectivity):
    js, ts = copy.deepcopy(base["js"]), copy.deepcopy(base["ts"])
    js.config.construct_max_connectivity = connectivity
    ts.config.construct_max_connectivity = connectivity
    jr = J_inc.bundle_adjust_slow(js, seed=BUNDLE_SEED)
    tr = T_inc.bundle_adjust_slow(ts, seed=BUNDLE_SEED,
                                  sampler=JaxStageReplay(BUNDLE_SEED))
    j, t = _summary(jr), _summary(tr)
    assert t["order"] == j["order"] and len(t["order"]) == 6
    if t["points"] != j["points"]:
        js2, _, _ = _scenes(1.0 + 2.0 ** -52)
        js2.config.construct_max_connectivity = connectivity
        j2 = _summary(J_inc.bundle_adjust_slow(js2, seed=BUNDLE_SEED))
        assert abs(j2["points"] - j["points"]) >= \
            abs(t["points"] - j["points"]), (j, t, j2)
    assert t["points"] > 120
    gt = np.stack([base["syn"].centers[i] for i in t["order"]])
    assert similarity_align(t["centers"], gt) < 0.02
    scale = np.abs(j["centers"]).max()
    assert np.abs(t["centers"] - j["centers"]).max() < 1e-6 * scale


def test_find_camera_with_most_connectivity(base, pair_state):
    js, ts = base["js"], base["ts"]
    trec = _port(pair_state)
    for fmin in (32, 0):
        assert T_inc.find_camera_with_most_connectivity(trec, ts, fmin) == \
            J_inc.find_camera_with_most_connectivity(pair_state, js, fmin)


def test_fix_necker_reversal(base, pair_state):
    js, ts = copy.deepcopy(base["js"]), copy.deepcopy(base["ts"])
    jrec, trec = copy.deepcopy(pair_state), _port(pair_state)
    J_inc.fix_necker_reversal(jrec, js)
    T_inc.fix_necker_reversal(trec, ts)
    _same_state(jrec, trec, 1e-8)
    # The pair was swapped: camera 0 now sits where camera 1 was.
    assert np.abs(trec.cam_params[1][0:3]).max() < 1e-2 * \
        np.abs(trec.cam_params[0][0:3]).max()


def test_estimate_ignored_cameras(base, pair_state):
    """Every image but the initial pair ignored: the port recovers as many
    as the JAX package, in the same order, at the same centres."""
    js, ts = copy.deepcopy(base["js"]), copy.deepcopy(base["ts"])
    jrec, trec = copy.deepcopy(pair_state), _port(pair_state)
    for s in (js, ts):
        s.ignore_in_bundle[:] = True
        s.ignore_in_bundle[list(pair_state.added_order)] = False
    nj = J_inc.estimate_ignored_cameras(jrec, js, seed=BUNDLE_SEED)
    nt = T_inc.estimate_ignored_cameras(trec, ts, seed=BUNDLE_SEED,
                                        sampler=JaxStageReplay(BUNDLE_SEED))
    assert nt == nj >= 3
    assert trec.added_order == jrec.added_order
    _close([c[0:3] for c in jrec.cam_params],
           [c[0:3] for c in trec.cam_params], 1e-6)


def _project(cam, R, X):
    """Snavely projection of X by camera params cam (c, w, f, k1, k2)."""
    p = R @ (X - cam[0:3])
    u = -p[0:2] / p[2]
    r2 = u @ u
    return cam[6] * (1.0 + cam[7] * r2 + cam[8] * r2 * r2) * u


def _panorama_keys(rec, scenes):
    """Move the keys of each candidate track's later views onto the
    projection of the point one unit along its first view's ray (the
    point panorama mode places), so that those points pass the gates."""
    ref = scenes[0]
    cand = {}
    for slot, img in enumerate(rec.added_order):
        for tr, key in zip(ref.visible_points[img], ref.visible_keys[img]):
            if rec.track_extra[tr] == -1 and \
                    rec.key_extra[img].get(key, -1) == -1:
                cand.setdefault(tr, []).append((slot, key))
    for views in cand.values():
        s0, k0 = views[0]
        cam, R = rec.cam_params[s0], rec.cam_R[s0]
        x = ref.key_xy[rec.added_order[s0]][k0]
        ray = R.T @ np.array([x[0] / cam[6], x[1] / cam[6], -1.0])
        X = cam[0:3] + ray / np.linalg.norm(ray)
        for s, k in views[1:]:
            xy = _project(rec.cam_params[s], rec.cam_R[s], X)
            for sc in scenes:
                sc.key_xy[rec.added_order[s]][k] = xy


def _forget_points(rec, pts):
    """Turn points back into tracks that add_all_new_points may add."""
    for p in pts:
        for slot, key in rec.pt_views[p]:
            rec.key_extra[rec.added_order[slot]][key] = -1
        rec.pt_views[p] = []
        rec.track_extra[rec.track_extra == p] = -1


def test_add_all_new_points_panorama(base, three_state):
    js, ts = copy.deepcopy(base["js"]), copy.deepcopy(base["ts"])
    js.config.panorama_mode = ts.config.panorama_mode = True
    jrec = copy.deepcopy(three_state)
    _forget_points(jrec, range(0, len(jrec.points), 5))
    trec = _port(jrec)
    _panorama_keys(jrec, [js, ts])
    n0 = len(jrec.points)
    nj = J_inc.add_all_new_points(jrec, js)
    nt = T_inc.add_all_new_points(trec, ts)
    assert nt == nj > 10
    assert np.array_equal(trec.track_extra, jrec.track_extra)
    assert trec.pt_views == [list(v) for v in jrec.pt_views]
    assert np.abs(np.stack(trec.points[n0:]) - np.stack(jrec.points[n0:])
                  ).max() <= 1e-12


def test_run_sfm_point_constraints(base, three_state):
    """Anchors 0.3 scene units off their points with a weight that
    dominates the reprojection terms: the anchored points' reprojection
    errors go past the outlier threshold, yet they are kept."""
    js, ts = copy.deepcopy(base["js"]), copy.deepcopy(base["ts"])
    jrec = copy.deepcopy(three_state)
    J_inc.add_all_new_points(jrec, js)
    trec = _port(jrec)
    live = [p for p, v in enumerate(jrec.pt_views) if v]
    rng = np.random.default_rng(1)
    chosen = rng.choice(live, 12, replace=False)
    pc = {int(p): jrec.points[p] + rng.normal(size=3) * 0.3 for p in chosen}
    J_inc.run_sfm(jrec, js, pt_constraints=pc, pt_weight=1e6, verbose=False)
    T_inc.run_sfm(trec, ts, pt_constraints=pc, pt_weight=1e6, verbose=False)
    _same_state(jrec, trec, 1e-8)
    assert all(trec.pt_views[p] for p in pc)
    # The anchors pull their points off their rays: without the exemption
    # most would be removed (an observation above the 16 px ceiling).
    far = 0
    for p in pc:
        errs = [np.linalg.norm(_project(trec.cam_params[s], trec.cam_R[s],
                                        trec.points[p])
                               - ts.key_xy[trec.added_order[s]][k])
                for s, k in trec.pt_views[p]]
        far += max(errs) > js.config.max_proj_error_threshold
    assert far >= len(chosen) // 2, far


def test_refine_camera_iterative(base, three_state):
    """One camera refined against fixed points from a perturbed start (a
    few observations turned into gross outliers to exercise the trim)."""
    js, ts = base["js"], base["ts"]
    s = 2
    img = three_state.added_order[s]
    pts, projs = [], []
    for p, views in enumerate(three_state.pt_views):
        for slot, key in views:
            if slot == s:
                pts.append(three_state.points[p])
                projs.append(js.key_xy[img][key])
    pts, projs = np.stack(pts), np.stack(projs)
    projs[::17] += 60.0
    rng = np.random.default_rng(2)
    cam0 = three_state.cam_params[s].copy()
    cam0[0:3] += rng.normal(size=3) * 0.02
    cam0[6] *= 1.02
    R0 = three_state.cam_R[s]
    jc, jR, ji = J_inc.refine_camera_iterative(js, img, cam0, R0, pts, projs,
                                               True)
    tc, tR, ti = T_inc.refine_camera_iterative(ts, img, cam0, R0, pts, projs,
                                               True, device="cpu")
    assert np.array_equal(ti, ji) and len(ti) < len(pts)
    _close([jc], [tc], 1e-8)
    _close([jR], [tR], 1e-8)


def test_write_match_table(base, tmp_path):
    raw, js = base["raw"], base["js"]
    jscene = JaxScene(config=js.config, entries=js.entries, dims=js.dims,
                      key_xy=js.key_xy, matches=copy.deepcopy(raw))
    tscene = scene_from_numpy(js.entries, js.dims, js.key_xy, raw,
                              dataclasses.asdict(js.config), device="cpu")
    jscene.matches[(0, 1)] = np.zeros((0, 2), np.int32)
    tscene.matches[(0, 1)] = np.zeros((0, 2), np.int32)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    J_inc.write_match_table(jscene, ".test", str(tmp_path / "j"))
    T_inc.write_match_table(tscene, ".test", str(tmp_path / "t"))
    for f in ("nmatches.test.txt", "matches.test.txt"):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()
        assert len((tmp_path / "t" / f).read_bytes()) > 100

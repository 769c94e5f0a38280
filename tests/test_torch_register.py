"""The port's registration helpers (`bundler_sfm_tpu_torch/pipeline/
register.py`) that no path of either package calls — `refine_camera_and_points`,
`refine_points`, `match_points_to_keys` (and `match_keys_to_points`) —
against the JAX package's, on the CPU; and the two public names of
`pipeline/incremental.py` that only the API carries.

The scene is the JAX package's own (`tests/test_resume_register.py::
test_refine_camera_and_points`): 60 points near the origin, two existing
cameras, a new camera guessed 5 cm and 3 % of focal off.  Here a third of
the points is seen from one existing view only: the port pads
`refine_points` to M = the largest view count (3 here), the JAX package
to at least 4 and to 64-point buckets, so those are the rows whose padding
differs.  Over four seeds, required:

  * refine_camera_and_points: the same inlier set; the camera within 1e-6
    relative (of each parameter's magnitude, focal 700 included; the
    rotation within 1e-9); points within 1e-9;
  * refine_points from the JAX refinement's camera: points within 1e-9,
    the RMS error within 1e-9 px;
  * match_points_to_keys / match_keys_to_points: identical match rows.

Measured when the test was written (every point an inlier in both):
cameras within 2.7e-10 relative (1.5e-7 absolute, on focal 700), points
within 1.5e-10, RMS error within 4.1e-10 px.  The camera refine is a
trimmed LM whose stopping step is chaotic under rounding (ROADMAP section
3), hence its wider 1e-6.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import numpy as np
import pytest

from bundler_sfm_tpu.config import BundlerConfig as JaxConfig
from bundler_sfm_tpu.pipeline import incremental as jax_incremental
from bundler_sfm_tpu.pipeline import register as jax_register
from bundler_sfm_tpu_torch.config import BundlerConfig
from bundler_sfm_tpu_torch.pipeline import incremental, register
from tests.synthetic import look_at_rotation, project

SEEDS = [0, 1, 2, 3]
FOCAL = 700.0
N_POINTS = 60


def _shim(config_cls):
    class Shim:
        config = config_cls()

        @staticmethod
        def has_init_focal(_):
            return False

        @staticmethod
        def init_focal(_):
            return 0.0
    return Shim


def make_scene(seed):
    """The JAX test's scene; every third point seen from the first
    existing camera only."""
    rng = np.random.default_rng(seed)
    pts_gt = rng.normal(size=(N_POINTS, 3)) * 0.5
    centers = [np.array([4.0, 0.2, 0.1]), np.array([-0.2, 4.0, 0.3]),
               np.array([2.5, 2.5, 0.5])]
    Rs = [look_at_rotation(c, np.zeros(3)) for c in centers]
    projs_new = project(Rs[2], centers[2], FOCAL, 0, 0, pts_gt)
    views_pv, views_R, views_c = [], [], []
    for i, X in enumerate(pts_gt):
        cams = [0] if i % 3 == 0 else [0, 1]
        views_pv.append(np.array([
            -project(Rs[c], centers[c], FOCAL, 0, 0, X[None])[0] / FOCAL
            for c in cams]))
        views_R.append(np.stack([Rs[c] for c in cams]))
        views_c.append(np.stack([centers[c] for c in cams]))
    pts_noisy = pts_gt + rng.normal(size=pts_gt.shape) * 0.02
    cam0 = np.concatenate([centers[2] + rng.normal(size=3) * 0.05,
                           np.zeros(3), [FOCAL * 1.03], np.zeros(2)])
    return dict(R0=Rs[2], pts=pts_noisy, projs=projs_new, views_pv=views_pv,
                views_R=views_R, views_c=views_c, cam0=cam0, pts_gt=pts_gt)


def _refine_both(s):
    args = (s["cam0"], s["R0"], s["pts"], s["projs"], s["views_pv"],
            s["views_R"], s["views_c"])
    want = jax_register.refine_camera_and_points(_shim(JaxConfig), *args,
                                                 adjust_focal=True)
    got = register.refine_camera_and_points(_shim(BundlerConfig), *args,
                                            adjust_focal=True, device="cpu")
    return got, want


@pytest.mark.parametrize("seed", SEEDS)
def test_refine_camera_and_points_matches_jax(seed):
    s = make_scene(seed)
    (cam, R, pts, inl), (jcam, jR, jpts, jinl) = _refine_both(s)
    jcam, jR, jpts = (np.asarray(a) for a in (jcam, jR, jpts))
    np.testing.assert_array_equal(inl, jinl)
    assert len(inl) > 40
    assert any(i % 3 == 0 for i in inl)          # one-view points kept
    np.testing.assert_allclose(cam, jcam, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(R, jR, rtol=0, atol=1e-9)
    np.testing.assert_allclose(pts, jpts, rtol=0, atol=1e-9)
    # The refinement did its job in both packages.
    assert np.linalg.norm(pts[inl] - s["pts_gt"][inl], axis=1).mean() < 5e-3


@pytest.mark.parametrize("seed", SEEDS)
def test_refine_points_matches_jax(seed):
    """From the JAX refinement's camera and inliers, on the noisy points:
    the re-triangulated points and the new camera's RMS error."""
    s = make_scene(seed)
    _, (jcam, jR, _, jinl) = _refine_both(s)
    jcam, jR = np.asarray(jcam), np.asarray(jR)
    args = (s["pts"][jinl], s["projs"][jinl],
            [s["views_pv"][i] for i in jinl], [s["views_R"][i] for i in jinl],
            [s["views_c"][i] for i in jinl], jcam, jR)
    want_pts, want_err = jax_register.refine_points(*args)
    got_pts, got_err = register.refine_points(*args, device="cpu")
    assert got_pts.shape == (len(jinl), 3)
    np.testing.assert_allclose(got_pts, np.asarray(want_pts), rtol=0,
                               atol=1e-9)
    assert abs(got_err - want_err) <= 1e-9
    assert got_err < 1.0


@pytest.mark.parametrize("seed", SEEDS)
def test_match_points_to_keys_matches_jax(seed):
    """The JAX test's descriptors: 40 point descriptors, 50 keys of which
    30 are shuffled copies of points; both directions identical."""
    rng = np.random.default_rng(seed)
    point_descs = rng.integers(0, 255, (40, 128)).astype(np.uint8)
    perm = rng.permutation(30)
    new_desc = np.concatenate([
        point_descs[perm], rng.integers(0, 255, (20, 128)).astype(np.uint8)])
    got = register.match_points_to_keys(point_descs, new_desc, device="cpu")
    want = np.asarray(jax_register.match_points_to_keys(point_descs,
                                                        new_desc))
    np.testing.assert_array_equal(got, want)
    assert sum(int(perm[k]) == p for p, k in got if k < 30) >= 28
    np.testing.assert_array_equal(
        register.match_keys_to_points(new_desc, point_descs, device="cpu"),
        np.asarray(jax_register.match_keys_to_points(new_desc, point_descs)))


def test_public_names_match_jax():
    """INIT_REPROJECTION_ERROR and Reconstruction.num_points."""
    assert incremental.INIT_REPROJECTION_ERROR == \
        jax_incremental.INIT_REPROJECTION_ERROR == 16.0
    fields = dict(added_order=[0, 2], cam_R=[np.eye(3)] * 2,
                  cam_params=[np.zeros(9)] * 2,
                  points=[np.zeros(3), np.ones(3), np.full(3, 2.0)],
                  colors=[np.zeros(3)] * 3, pt_views=[[], [], []],
                  track_extra=np.array([0, 1, 2, -1]), key_extra=[{}, {}, {}])
    got = incremental.Reconstruction(**fields)
    want = jax_incremental.Reconstruction(**fields)
    assert (got.num_points, got.num_cameras) == \
        (want.num_points, want.num_cameras) == (3, 2)

"""The port's camera models (`bundler_sfm_tpu_torch/models/`) against the
JAX package's, on the CPU in f64.

Tolerances: `models/camera.py` (host numpy) exact — every function gives
bit-identical outputs on the same inputs; the projection models within
1e-12 of the largest coordinate, and their `torch.func.jacfwd` Jacobians
within 1e-10 of the largest entry of `jax.jacfwd`'s.  The assertions of
`tests/test_camera_utils.py` and `tests/test_models_utils.py` run as port
cases too.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundler_sfm_tpu import models as JM
from bundler_sfm_tpu.models import camera as jcam
from bundler_sfm_tpu.ops.fisheye import FisheyeParams as JFisheyeParams
from bundler_sfm_tpu_torch import models as TM
from bundler_sfm_tpu_torch.models import camera as cam
from bundler_sfm_tpu_torch.ops.fisheye import FisheyeParams, undistort_points
from bundler_sfm_tpu_torch.ops.rotations import rodrigues
from tests.synthetic import look_at_rotation, project
from tests.test_camera_utils import look_at_R, make_cam

FISHEYE = dict(fCx=2.0, fCy=-3.0, fRad=600.0, fAngle=180.0, fFocal=400.0)


def t(x):
    return torch.from_numpy(np.array(x, np.float64))


def roll(theta):
    return rodrigues(t([0.0, 0.0, theta])).numpy()


# --- models/camera.py: the cases of tests/test_camera_utils.py ------------

def test_fov_roundtrip():
    f = cam.focal_from_fov(60.0, 1024.0)
    assert np.degrees(cam.fov(f, 1024.0)) == pytest.approx(60.0)
    assert cam.fov_max(f, 1024.0, 768.0) == pytest.approx(cam.fov(f, 1024.0))
    assert cam.fov_max(f, 768.0, 1024.0) == pytest.approx(cam.fov(f, 768.0))


def test_project_in_front_and_distortion_guard():
    R, tt = make_cam([0.0, 0.0, 5.0])
    f = 700.0
    u, ok = cam.project(R, tt, f, -0.05, 0.01, np.array([0.2, 0.1, 0.0]))
    assert ok
    p = R @ np.array([0.2, 0.1, 0.0]) + tt
    u0 = -f * p[:2] / p[2]
    rsq = (u0 @ u0) / f**2
    np.testing.assert_allclose(u, u0 * (1 - 0.05 * rsq + 0.01 * rsq**2),
                               rtol=1e-12)
    _, ok_behind = cam.project(R, tt, f, 0.0, 0.0, np.array([0.0, 0.0, 99.0]))
    assert not ok_behind
    far = np.array([40.0, 0.0, 4.0])
    u_g, _ = cam.project(R, tt, f, -0.5, 0.0, far)
    u_n, _ = cam.project(R, tt, f, 0.0, 0.0, far)
    np.testing.assert_allclose(u_g, u_n)


def test_point_in_front_and_inside_image():
    R, tt = make_cam([0.0, 0.0, 5.0])
    assert cam.point_in_front(R, tt, np.zeros(3))
    assert not cam.point_in_front(R, tt, np.array([0.0, 0.0, 9.0]))
    assert cam.point_inside_image(R, tt, 700.0, 0.0, 0.0, np.zeros(3),
                                  640, 480)
    assert not cam.point_inside_image(R, tt, 700.0, 0.0, 0.0,
                                      np.array([4.0, 0.0, 0.0]), 640, 480)


def test_essential_fundamental_epipolar_constraint(rng):
    f1, f2 = 650.0, 800.0
    R1, t1 = make_cam([0.0, 0.5, 6.0])
    R2, t2 = make_cam([2.0, -0.3, 5.5])
    F = cam.fundamental_between(R1, t1, f1, R2, t2, f2)
    E = cam.essential_between(R1, t1, R2, t2)
    X = rng.uniform(-1.5, 1.5, (50, 3))
    u1, ok1 = cam.project(R1, t1, f1, 0.0, 0.0, X)
    u2, ok2 = cam.project(R2, t2, f2, 0.0, 0.0, X)
    assert ok1.all() and ok2.all()
    h1 = np.concatenate([u1, np.ones((50, 1))], axis=1)
    h2 = np.concatenate([u2, np.ones((50, 1))], axis=1)
    resid = np.einsum("ni,ij,nj->n", h2, F, h1)
    assert np.abs(resid).max() < 1e-9 * np.abs(F).max() * f1 * f2
    n1 = h1 / np.array([f1, f1, 1.0])
    n2 = h2 / np.array([f2, f2, 1.0])
    resid_e = np.einsum("ni,ij,nj->n", n2, E, n1)
    assert np.abs(resid_e).max() < 1e-12 * np.abs(E).max() * 100


def test_reflect():
    R, tt = make_cam([1.0, 0.2, 5.0])
    R2, t2 = cam.reflect(R, tt)
    c, c2 = cam.camera_center(R, tt), cam.camera_center(R2, t2)
    np.testing.assert_allclose(c2, c * np.array([1.0, 1.0, -1.0]),
                               atol=1e-12)
    np.testing.assert_allclose(R2 @ R2.T, np.eye(3), atol=1e-12)
    assert np.linalg.det(R2) == pytest.approx(1.0)


def test_distance_view_dir_halfspace():
    R1, t1 = make_cam([0.0, 0.0, 5.0])
    R2, t2 = make_cam([3.0, 4.0, 5.0])
    assert cam.camera_distance(R1, t1, R2, t2) == pytest.approx(5.0)
    np.testing.assert_allclose(cam.view_direction(R1), [0.0, 0.0, -1.0],
                               atol=1e-12)
    plane = cam.front_halfspace(R1, t1)
    assert plane[:3] @ np.zeros(3) + plane[3] > 0
    assert plane[:3] @ np.array([0, 0, 9.0]) + plane[3] < 0


def test_twist_angle():
    R, _ = make_cam([0.0, 0.0, 5.0])
    assert abs(cam.twist_angle(R)) < 2e-4
    assert cam.twist_angle(roll(0.3) @ R) == pytest.approx(-0.3, abs=1e-6)


def test_pixel_rays():
    R, tt = make_cam([0.0, 0.0, 5.0])
    f = 700.0
    np.testing.assert_allclose(cam.pixel_to_camera_ray(0.0, 0.0, f),
                               [0.0, 0.0, -1.0], atol=1e-12)
    X = np.array([0.4, -0.2, 1.0])
    u, _ = cam.project(R, tt, f, 0.0, 0.0, X)
    r = cam.pixel_to_camera_ray_absolute(u[0], u[1], f, R)
    d = X - cam.camera_center(R, tt)
    np.testing.assert_allclose(r, d / np.linalg.norm(d), atol=1e-12)


def test_horizon_line():
    R = look_at_R([0.0, 2.0, 5.0], [0.0, 2.0, 0.0])
    f = 700.0
    horizon = cam.horizon_line(R, f, np.array([0.0, 1.0, 0.0]),
                               np.array([0.0, 1.0, 0.0]))
    assert cam.point_above_horizon(horizon, np.array([0.0, 50.0]))
    assert not cam.point_above_horizon(horizon, np.array([0.0, -50.0]))
    assert abs(horizon[0]) < 1e-9 and abs(horizon[2]) < 1e-9
    tt = -R @ np.array([0.0, 2.0, 5.0])
    u, ok = cam.project(R, tt, f, 0.0, 0.0, np.array([0.0, 0.0, -500.0]))
    assert ok and not cam.point_above_horizon(horizon, u)
    u2, _ = cam.project(R, tt, f, 0.0, 0.0, np.array([0.0, 100.0, -500.0]))
    assert cam.point_above_horizon(horizon, u2)


def test_vanishing_line_tilted_camera():
    R0 = look_at_R([0.0, 2.0, 5.0], [0.0, 0.0, 0.0])
    f = 500.0
    line = cam.vanishing_line(R0, f, np.array([0.0, 1.0, 0.0]))
    for v in (np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0]),
              np.array([1.0, 0.0, -2.0])):
        p = R0 @ v
        h = np.array([f * p[0], f * p[1], -p[2]])
        assert abs(line @ h) < 1e-6 * f * np.linalg.norm(h)


def test_interpolate_cameras():
    R1, t1 = make_cam([0.0, 0.0, 5.0])
    R2, t2 = make_cam([5.0, 0.0, 0.0])
    Ra, ta = cam.interpolate_cameras(R1, t1, R2, t2, 0.0)
    np.testing.assert_allclose(Ra, R1, atol=1e-9)
    np.testing.assert_allclose(ta, t1, atol=1e-9)
    Rb, _ = cam.interpolate_cameras(R1, t1, R2, t2, 1.0)
    np.testing.assert_allclose(Rb, R2, atol=1e-9)
    Rm, tm = cam.interpolate_cameras(R1, t1, R2, t2, 0.5)
    np.testing.assert_allclose(cam.camera_center(Rm, tm), [2.5, 0.0, 2.5],
                               atol=1e-9)
    np.testing.assert_allclose(Rm @ Rm.T, np.eye(3), atol=1e-12)
    assert np.linalg.det(Rm) == pytest.approx(1.0)


def test_up_camera():
    R, tt = make_cam([0.0, 1.0, 5.0])
    Rr = roll(0.4) @ R
    tr = -Rr @ cam.camera_center(R, tt)
    R2, t2 = cam.up_camera(Rr, tr, np.array([0.0, 1.0, 0.0]))
    up_img = R2 @ np.array([0.0, 1.0, 0.0])
    assert abs(up_img[0]) < 1e-9 and up_img[1] > 0
    np.testing.assert_allclose(cam.camera_center(R2, t2),
                               cam.camera_center(R, tt), atol=1e-9)


# --- models/camera.py: the same outputs as the JAX package's --------------

def _camera_calls(rng):
    """(function name, args) over random cameras, points and planes."""
    Rs = [look_at_rotation(rng.normal(size=3) * 4, rng.normal(size=3) * 0.3)
          for _ in range(2)]
    ts = [rng.normal(size=3) for _ in range(2)]
    X = rng.normal(size=(40, 3)) * 2
    n = rng.normal(size=3)
    up = np.array([0.05, 1.0, -0.1])
    return [
        ("intrinsics", (712.5,)), ("fov", (712.5, 1024.0)),
        ("fov_max", (712.5, 768.0, 1024.0, 1)),
        ("focal_from_fov", (53.0, 1024.0)),
        ("project", (Rs[0], ts[0], 700.0, -0.07, 0.02, X)),
        ("point_in_front", (Rs[0], ts[0], X)),
        ("point_inside_image", (Rs[0], ts[0], 700.0, -0.07, 0.02, X, 640,
                                480)),
        ("essential_between", (Rs[0], ts[0], Rs[1], ts[1])),
        ("fundamental_between", (Rs[0], ts[0], 650.0, Rs[1], ts[1], 810.0)),
        ("reflect", (Rs[1], ts[1])), ("camera_center", (Rs[1], ts[1])),
        ("camera_distance", (Rs[0], ts[0], Rs[1], ts[1])),
        ("view_direction", (Rs[0],)), ("twist_angle", (Rs[1],)),
        ("front_halfspace", (Rs[0], ts[0])),
        ("pixel_to_camera_ray", (31.5, -12.25, 700.0)),
        ("pixel_to_camera_ray_absolute", (31.5, -12.25, 700.0, Rs[1])),
        ("vanishing_line", (Rs[0], 700.0, n)),
        ("horizon_line", (Rs[0], 700.0, n, up)),
        ("point_above_horizon", (np.array([0.1, 0.9, -3.0]), X[:, :2] * 9)),
        ("interpolate_cameras", (Rs[0], ts[0], Rs[1], ts[1], 0.37)),
        ("up_camera", (Rs[1], ts[1], up)),
    ]


def test_camera_functions_match_jax_exactly(rng):
    for name, args in _camera_calls(rng):
        want = getattr(jcam, name)(*args)
        got = getattr(cam, name)(*args)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for g, w in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(w)), name


# --- the projection models -------------------------------------------------

def test_registry():
    assert TM.get_camera_model("snavely") is TM.SnavelyModel
    with pytest.raises(ValueError):
        TM.get_camera_model("nope")
    assert set(TM.CAMERA_MODELS) == set(JM.CAMERA_MODELS)
    for name, model in TM.CAMERA_MODELS.items():
        assert model.name == name
        assert model.num_params == JM.CAMERA_MODELS[name].num_params


def test_quaternion_matches_angle_axis(rng):
    """Both parameterizations project identically
    (snavely_reprojection_error.h:53-96 vs :103-151)."""
    c = np.array([1.0, -2.0, 5.0])
    R = look_at_rotation(c, np.zeros(3))
    f, k1, k2 = 700.0, -0.04, 0.06
    X = rng.normal(size=(20, 3))
    cam9 = TM.SnavelyModel.pack(c, np.zeros(3), f, k1, k2)
    camq = TM.SnavelyQuaternionModel.from_rt(R, -R @ c, f, k1, k2)
    camq_scaled = camq.clone()
    camq_scaled[0:4] *= 1.7          # an unnormalized quaternion
    gt = project(R, c, f, k1, k2, X)
    np.testing.assert_allclose(TM.SnavelyModel.project(cam9, t(R), t(X)),
                               gt, atol=1e-9)
    for q in (camq, camq_scaled):
        np.testing.assert_allclose(
            TM.SnavelyQuaternionModel.project(q, None, t(X)), gt, atol=1e-8)


def test_known_intrinsics_model(rng):
    c = np.array([0.5, 0.1, 4.0])
    R = look_at_rotation(c, np.zeros(3))
    X = rng.normal(size=3)
    p6 = torch.cat([t(c), torch.zeros(3, dtype=torch.float64)])
    out = TM.KnownIntrinsicsModel.project(p6, (t(R), 650.0, 0.0, 0.0), t(X))
    np.testing.assert_allclose(out, project(R, c, 650.0, 0, 0, X[None])[0],
                               atol=1e-9)


def test_fisheye_model_roundtrip(rng):
    fp = FisheyeParams(**FISHEYE)
    c = np.array([0.0, 0.0, 6.0])
    R = look_at_rotation(c, np.zeros(3))
    cam9 = TM.SnavelyModel.pack(c, np.zeros(3), 400.0, 0.0, 0.0)
    X = rng.normal(size=(10, 3)) * 0.5
    d = TM.FisheyeModel.project(cam9, (t(R), fp), t(X))
    # Undistorting the fisheye pixel recovers the pinhole projection.
    np.testing.assert_allclose(undistort_points(d, fp),
                               project(R, c, 400.0, 0, 0, X), atol=1e-6)


def _model_case(rng, name, n=8):
    """n points' (params, aux, X) for one model: a list of JAX triples, the
    port's triples of the same values, and the port's batched triple."""
    C = rng.normal(size=(n, 3)) * 0.3 + np.array([0.4, -0.2, 5.0])
    R0 = np.stack([look_at_rotation(c, rng.normal(size=3) * 0.2) for c in C])
    w = rng.normal(size=(n, 3)) * 0.02
    fk = np.stack([rng.uniform(500, 900, n), rng.normal(size=n) * 0.05,
                   rng.normal(size=n) * 0.02], 1)
    X = rng.normal(size=(n, 3)) * 0.8
    if name == "snavely_quaternion":
        P = np.stack([np.asarray(JM.SnavelyQuaternionModel.from_rt(
            jnp.asarray(R), jnp.asarray(-R @ c), *f)) for R, c, f
            in zip(R0, C, fk)])
        P[:, :4] *= rng.uniform(0.5, 2.0, (n, 1))
        jaux, taux, batched = [None] * n, [None] * n, None
    elif name == "known_intrinsics":
        P = np.concatenate([C, w], 1)
        jaux = [(jnp.asarray(R), *f) for R, f in zip(R0, fk)]
        taux = [(t(R), *f) for R, f in zip(R0, fk)]
        batched = (t(R0), t(fk[:, 0]), t(fk[:, 1]), t(fk[:, 2]))
    elif name == "fisheye":
        P = np.concatenate([C, w, fk[:, :1], np.zeros((n, 2))], 1)
        jaux = [(jnp.asarray(R), JFisheyeParams(**FISHEYE)) for R in R0]
        taux = [(t(R), FisheyeParams(**FISHEYE)) for R in R0]
        batched = (t(R0), FisheyeParams(**FISHEYE))
    else:
        P = np.concatenate([C, w, fk], 1)
        jaux = [jnp.asarray(R) for R in R0]
        taux = [t(R) for R in R0]
        batched = t(R0)
    jpts = [(jnp.asarray(p), a, jnp.asarray(x)) for p, a, x in zip(P, jaux, X)]
    tpts = [(t(p), a, t(x)) for p, a, x in zip(P, taux, X)]
    return jpts, tpts, (t(P), batched, t(X))


MODELS = ["snavely", "snavely_quaternion", "known_intrinsics", "fisheye"]


@pytest.mark.parametrize("name", MODELS)
def test_projection_matches_jax(rng, name):
    jpts, tpts, batched = _model_case(rng, name)
    jf = JM.get_camera_model(name).project
    tf = TM.get_camera_model(name).project
    want = np.stack([np.asarray(jf(*a)) for a in jpts])
    scale = np.abs(want).max()
    got = np.stack([tf(*a).numpy() for a in tpts])
    assert np.abs(got - want).max() <= 1e-12 * scale
    # The same points in one batched call.
    assert np.abs(tf(*batched).numpy() - want).max() <= 1e-12 * scale


@pytest.mark.parametrize("name", MODELS)
def test_jacobian_matches_jax(rng, name):
    """d project / d (params, X): torch.func.jacfwd against jax.jacfwd."""
    jpts, tpts, _ = _model_case(rng, name, n=4)
    jf = JM.get_camera_model(name).project
    tf = TM.get_camera_model(name).project
    for ja, ta in zip(jpts, tpts):
        want = jax.jacfwd(jf, argnums=(0, 2))(*ja)
        got = torch.func.jacfwd(tf, argnums=(0, 2))(*ta)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= 1e-10 * np.abs(w).max()

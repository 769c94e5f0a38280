"""The port's reconstruction geometry against the JAX package on the CPU in
f64: rotations, projection, triangulation, essential decomposition, the
5-point and resection RANSAC (with the JAX package's draw replayed) and the
batched camera refine-and-trim.

Tolerances (relative to the largest entry unless stated):
  * closed-form functions (rotations, projection, rays): 1e-13;
  * triangulation (linear DLT + Gauss-Newton polish): 1e-9;
  * RANSAC (5-point, resection) with the same draw: identical inlier
    masks and counts, models within 1e-8 (E up to sign: its null-space
    basis comes from another eigensolver);
  * camera refine-and-trim: identical inlier masks, cameras within 1e-8.
The synthetic scenes below were checked for knife-edge samples: their
masks do not move under a 1-ulp scaling of the inputs in the JAX package.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic import Scene, random_rotation

from bundler_sfm_tpu.ops import essential as J_ess
from bundler_sfm_tpu.ops import fivepoint as J_5pt
from bundler_sfm_tpu.ops import lm as J_lm
from bundler_sfm_tpu.ops import projection as J_proj
from bundler_sfm_tpu.ops import resection as J_res
from bundler_sfm_tpu.ops import rotations as J_rot
from bundler_sfm_tpu.ops import triangulate as J_tri
from bundler_sfm_tpu.ops.ransac import sample_indices

from bundler_sfm_tpu_torch.ops import essential as T_ess
from bundler_sfm_tpu_torch.ops import fivepoint as T_5pt
from bundler_sfm_tpu_torch.ops import lm as T_lm
from bundler_sfm_tpu_torch.ops import projection as T_proj
from bundler_sfm_tpu_torch.ops import resection as T_res
from bundler_sfm_tpu_torch.ops import rotations as T_rot
from bundler_sfm_tpu_torch.ops import triangulate as T_tri


def t(x):
    return torch.from_numpy(np.array(x))


def close(a, b, rel):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(a).max(), 1e-300)
    assert np.abs(a - b).max() <= rel * scale, np.abs(a - b).max() / scale


def corrupt(rng, xy, frac, scale=80.0):
    xy = xy.copy()
    bad = rng.choice(len(xy), int(len(xy) * frac), replace=False)
    xy[bad] += rng.normal(size=(len(bad), 2)) * scale
    return xy


def test_rotations(rng):
    w = np.concatenate([rng.normal(size=(6, 3)) * 0.7,
                        rng.normal(size=(3, 3)) * 1e-9, np.zeros((1, 3))])
    R0 = np.stack([random_rotation(rng) for _ in range(10)])
    close(J_rot.rodrigues(jnp.asarray(w)), T_rot.rodrigues(t(w)), 1e-15)
    close(jax.vmap(J_rot.rot_update)(jnp.asarray(R0), jnp.asarray(w)),
          T_rot.rot_update(t(R0), t(w)), 1e-14)
    close(J_rot.log_rotation(jnp.asarray(R0)), T_rot.log_rotation(t(R0)),
          1e-13)
    M = rng.normal(size=(10, 3, 3))
    M *= np.sign(np.linalg.det(M))[:, None, None]
    jK, jQ = jax.vmap(J_rot.rq3)(jnp.asarray(M))
    tK, tQ = T_rot.rq3(t(M))
    close(jK, tK, 1e-13)
    close(jQ, tQ, 1e-13)
    jK, jQ = jax.vmap(J_rot.fix_intrinsics_sign)(jK, jQ)
    tK, tQ = T_rot.fix_intrinsics_sign(tK, tQ)
    close(jK, tK, 1e-13)
    close(jQ, tQ, 1e-13)
    np.testing.assert_allclose(tK.numpy() @ tQ.numpy(), M, atol=1e-12)


def test_projection(rng):
    sc = Scene(rng, num_cams=3, num_pts=40, k1=-0.05, k2=0.02)
    cams = np.zeros((3, 9))
    cams[:, 0:3] = sc.centers
    cams[:, 3:6] = rng.normal(size=(3, 3)) * 0.01
    cams[:, 6] = sc.f
    cams[:, 7:9] = sc.k
    oc = np.repeat(np.arange(3), 40)
    op = np.tile(np.arange(40), 3)
    args = (cams, sc.R, sc.points, oc, op)
    close(J_proj.project_obs(*map(jnp.asarray, args)),
          T_proj.project_obs(*map(t, args)), 1e-13)
    close(J_proj.camera_depths(*map(jnp.asarray, args)),
          T_proj.camera_depths(*map(t, args)), 1e-13)
    xy = sc.obs[0][:5]
    close(J_proj.ray_angle(jnp.asarray(xy), 700.0, jnp.asarray(sc.R[0]),
                           jnp.asarray(sc.obs[1][:5]), 700.0,
                           jnp.asarray(sc.R[1])),
          T_proj.ray_angle(t(xy), 700.0, t(sc.R[0]), t(sc.obs[1][:5]), 700.0,
                           t(sc.R[1])), 1e-13)


def test_triangulation(rng):
    sc = Scene(rng, num_cams=5, num_pts=60, noise=0.5, k1=-0.05, k2=0.02)
    T, M = 60, 5
    xy = np.stack([np.stack([sc.obs[c][i] for c in range(M)])
                   for i in range(T)])
    fs = np.broadcast_to(sc.f, (T, M)).copy()
    ks = np.broadcast_to(sc.k, (T, M, 2)).copy()
    Rs = np.broadcast_to(sc.R, (T, M, 3, 3)).copy()
    cs = np.broadcast_to(sc.centers, (T, M, 3)).copy()
    # Tracks of 2..5 views: padded slots as the pipelines pad them.
    mask = np.arange(M)[None] < rng.integers(2, M + 1, T)[:, None]
    xy[~mask], fs[~mask], ks[~mask], cs[~mask] = 0.0, 1.0, 0.0, 0.0
    Rs[~mask] = np.eye(3)
    args = (xy, fs, ks, Rs, cs, mask)
    jX, jerr = J_tri.triangulate_tracks_pixels(*map(jnp.asarray, args))
    tX, terr = T_tri.triangulate_tracks_pixels(*map(t, args))
    close(jX, tX, 1e-9)
    close(jerr, terr, 1e-9)
    p, q = -sc.obs[0] / sc.f[0], -sc.obs[1] / sc.f[1]
    jX2, jerr2 = jax.vmap(lambda a, b: J_tri.triangulate_two_view(
        a, b, jnp.asarray(sc.R[0]), jnp.asarray(sc.w2c_t(0)),
        jnp.asarray(sc.R[1]), jnp.asarray(sc.w2c_t(1))))(jnp.asarray(p),
                                                          jnp.asarray(q))
    tX2, terr2 = T_tri.triangulate_two_view(
        t(p), t(q), t(sc.R[0]), t(sc.w2c_t(0)), t(sc.R[1]), t(sc.w2c_t(1)))
    close(jX2, tX2, 1e-9)
    close(jerr2, terr2, 1e-9)


def _pair(rng, n=150, noise=0.3, outliers=0.25):
    sc = Scene(rng, num_cams=2, num_pts=n, noise=noise)
    return sc, sc.obs[0].copy(), corrupt(rng, sc.obs[1], outliers, 100.0)


def test_essential_decomposition(rng):
    sc, x1, x2 = _pair(rng, outliers=0.0, noise=0.0)
    R_rel = sc.R[1] @ sc.R[0].T
    t_rel = -R_rel @ (sc.R[0] @ (sc.centers[1] - sc.centers[0]))
    tx = np.array([[0, -t_rel[2], t_rel[1]], [t_rel[2], 0, -t_rel[0]],
                   [-t_rel[1], t_rel[0], 0]])
    E = tx @ R_rel
    # Ray coords in camera 0's frame (camera 0 moved to the identity).
    p1 = -x1 / sc.f[0]
    p2 = -x2 / sc.f[1]
    mask = np.ones(len(p1), bool)
    jR, jt, jok = J_ess.decompose_essential_multipt(
        jnp.asarray(E), jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask))
    tR, tt, tok = T_ess.decompose_essential_multipt(t(E), t(p1), t(p2),
                                                    t(mask))
    assert bool(jok) and bool(tok)
    close(jR, tR, 1e-12)
    close(jt, tt, 1e-12)
    np.testing.assert_allclose(tR.numpy(), R_rel, atol=1e-9)
    jR1, jt1, _ = J_ess.decompose_essential(jnp.asarray(E), jnp.asarray(p1[0]),
                                            jnp.asarray(p2[0]))
    tR1, tt1, _ = T_ess.decompose_essential(t(E), t(p1[0]), t(p2[0]))
    close(jR1, tR1, 1e-12)
    close(jt1, tt1, 1e-12)


def test_minimal_solver_finds_true_essential(rng):
    sc, x1, x2 = _pair(rng, outliers=0.0, noise=0.0)
    q1, q2 = -x1 / sc.f[0], -x2 / sc.f[1]
    idx = np.array([3, 10, 22, 37, 51])
    Es, ok = T_5pt.generate_ematrix_hypotheses(t(q1[idx]), t(q2[idx]))
    h1 = np.concatenate([q1, np.ones((len(q1), 1))], 1)
    h2 = np.concatenate([q2, np.ones((len(q2), 1))], 1)
    res = [np.abs(np.einsum("ni,ij,nj->n", h2, E, h1)).max()
           for E, o in zip(Es.numpy(), ok.numpy()) if o]
    assert min(res) < 1e-8


@pytest.mark.parametrize("seed", [0, 1])
def test_fivepoint_with_jax_draw(seed):
    rng = np.random.default_rng(100 + seed)
    sc, x1, x2 = _pair(rng)
    n, pad, f = len(x1), 192, float(sc.f[0])
    key = jax.random.PRNGKey(seed)
    x1p = np.zeros((pad, 2)); x1p[:n] = x1
    x2p = np.zeros((pad, 2)); x2p[:n] = x2
    jE, jcnt, jinl = J_5pt.compute_pose_ransac_5pt(
        key, jnp.asarray(x1p), jnp.asarray(x2p), jnp.int32(n), f, f,
        jnp.float64(2.25), num_rounds=256)
    jR, jt, jc, jok = J_5pt.estimate_pose_5point(
        key, jnp.asarray(x1p), jnp.asarray(x2p), jnp.int32(n), f, f,
        jnp.float64(2.25), num_rounds=256)
    samples = t(sample_indices(key, 256, 5, jnp.int32(n), pad)).long()
    tE, tcnt, tinl = T_5pt.compute_pose_ransac_5pt(
        samples, t(x1), t(x2), n, f, f, 2.25)
    tR, tt, tc, tok = T_5pt.estimate_pose_5point(samples, t(x1), t(x2), n,
                                                 f, f, 2.25)
    assert int(jcnt) == int(tcnt) == int(jc) == int(tc) > 90
    np.testing.assert_array_equal(np.asarray(jinl)[:n], tinl.numpy())
    jE = np.asarray(jE)
    sign = np.sign((jE * tE.numpy()).sum())
    close(jE, sign * tE.numpy(), 1e-8)
    assert bool(jok) and bool(tok)
    close(jR, tR, 1e-8)
    close(jt, tt, 1e-8)


def _resection_batch(rng, B=3, n=150):
    Xs, xs, nv = [], [], []
    for b in range(B):
        sc = Scene(rng, num_cams=1, num_pts=n - 20 * b, noise=0.3)
        Xs.append(sc.points)
        xs.append(corrupt(rng, sc.obs[0], 0.2))
        nv.append(n - 20 * b)
    pad = 192
    X = np.zeros((B, pad, 3))
    x = np.zeros((B, pad, 2))
    for b in range(B):
        X[b, :nv[b]], x[b, :nv[b]] = Xs[b], xs[b]
    return X, x, np.array(nv)


def test_resection_with_jax_draw(rng):
    X, x, nv = _resection_batch(rng)
    keys = jax.random.split(jax.random.PRNGKey(3), len(nv))
    R = 1024
    jv = jax.vmap(lambda k, a, b, c: J_res.find_and_verify_camera(
        k, a, b, c, 4.0, 64.0, num_rounds=R))(
            keys, jnp.asarray(X), jnp.asarray(x), jnp.asarray(nv, jnp.int32))
    samples = torch.stack([t(sample_indices(k, R, 6, jnp.int32(c), X.shape[1]))
                           for k, c in zip(keys, nv)]).long()
    tv = T_res.find_and_verify_camera(samples, t(X), t(x), t(nv), 4.0, 64.0)
    np.testing.assert_array_equal(np.asarray(jv.ok), tv.ok.numpy())
    assert tv.ok.all()
    np.testing.assert_array_equal(np.asarray(jv.inliers), tv.inliers.numpy())
    np.testing.assert_array_equal(np.asarray(jv.inliers_weak),
                                  tv.inliers_weak.numpy())
    for f in ("K", "R", "t"):
        close(getattr(jv, f), getattr(tv, f), 1e-8)


def test_camera_refine_trim_batch(rng):
    B, N = 3, 120
    sc = Scene(rng, num_cams=B, num_pts=N, noise=0.4, k1=-0.03)
    cam0 = np.zeros((B, 9))
    R0 = np.stack([random_rotation(rng, 0.02) @ sc.R[b] for b in range(B)])
    cam0[:, 0:3] = sc.centers + rng.normal(size=(B, 3)) * 0.05
    cam0[:, 6] = sc.f * np.array([1.0, 1.05, 0.95])
    pts = np.broadcast_to(sc.points, (B, N, 3)).copy()
    projs = np.stack([corrupt(rng, sc.obs[b], 0.1, 30.0) for b in range(B)])
    mask = rng.random((B, N)) < 0.95
    fcs = np.array([0.0, 700.0, 700.0])
    fws = np.array([0.0, 1e-4, 100.0])
    args = (cam0, R0, pts, projs, mask)
    for est_dist in (False, True):
        jc, jR, jm = J_lm.camera_refine_trim_batch(
            *map(jnp.asarray, args), True, est_dist, jnp.asarray(fcs),
            jnp.asarray(fws), 100.0, 50, 1e-3, 2.0, 8.0, 16.0)
        tc, tR, tm = T_lm.camera_refine_trim_batch(
            *map(t, args), True, est_dist, t(fcs), t(fws), 100.0, 50, 1e-3,
            2.0, 8.0, 16.0)
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
        assert 0 < tm.sum() < mask.sum()
        close(jc, tc, 1e-8)
        close(jR, tR, 1e-8)

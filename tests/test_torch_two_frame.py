"""The port's two-frame models, relative pose and camera covariance against
the JAX package's, on the CPU in f64, every RANSAC draw replayed from
jax.random (`JaxDrawReplay`: the JAX package's key and padding).

Held:
  * `estimate_ematrix`: the same inlier set and count, E within 1e-9
    (max abs difference after scaling each to unit Frobenius norm) and
    the pixel F within 1e-8;
    `refine_fmatrix_nonlinear` within 1e-9 (same scaling) where it
    converges, and the same F = 0 where it collapses;
  * `homography_decompose`: both planar-scene checks of
    tests/test_hdecompose.py, and every output within 1e-12 of the JAX
    package's;
  * `camera_covariance` / `scene_covariance` on a bundle written from
    tests/synthetic.py: the full inverse within rtol 1e-8 (atol 1e-8 of
    its largest entry), every 3x3 block SPD, covariance.txt byte-identical,
    and the same through both `bundler --bundle --compute_covariance`;
  * `compute_model_table` / `bundle_two_frame` / `write_relative_poses` on
    `make_pipeline_scene(num_cams=3, num_pts=150)`: the same pairs, kept
    keys and point counts; relative rotation and unit translation within
    1e-5, points and focals within 1e-5 relative, error and angle within
    1e-8, covariance blocks within 3e-5 relative (the differences measured
    on this scene are in TOL's comment);
  * `estimate_relative_pose` on a general pair (the E branch) and on a
    planar pair (the homography branch): the same pose within 1e-8.

Knife-edge cases (ROADMAP section 3, item 5): every inlier set and kept
key set is compared for equality, so a rounding flip at a threshold
shows as a failure, not inside a tolerance; none flips on these scenes.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import dataclasses
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic import Scene as SynScene
from tests.test_hdecompose import make_planar_scene
from tests.test_pipeline import make_pipeline_scene

from bundler_sfm_tpu import bundler as J_bundler
from bundler_sfm_tpu.io import bundlefile as J_bf
from bundler_sfm_tpu.ops import ba as J_ba
from bundler_sfm_tpu.ops import fmatrix as JF
from bundler_sfm_tpu.ops import homography_decompose as JD
from bundler_sfm_tpu.ops import ransac as JR
from bundler_sfm_tpu.pipeline import two_frame as JT
from bundler_sfm_tpu.pipeline.scene import Scene as JaxScene
from bundler_sfm_tpu.pipeline.verify import compute_geometric_constraints

from bundler_sfm_tpu_torch import bundler as T_bundler
from bundler_sfm_tpu_torch.convert import scene_from_numpy
from bundler_sfm_tpu_torch.io import bundlefile as T_bf
from bundler_sfm_tpu_torch.ops import ba as T_ba
from bundler_sfm_tpu_torch.ops import fmatrix as TF
from bundler_sfm_tpu_torch.ops import homography as TH
from bundler_sfm_tpu_torch.ops import homography_decompose as TD
from bundler_sfm_tpu_torch.pipeline import two_frame as TT

KEY = jax.random.PRNGKey(7)

# Largest differences measured between the packages' model tables on
# make_pipeline_scene(num_cams=3, num_pts=150), relative to each
# quantity's largest entry: relative pose 4.6e-7, points 1.2e-6, focals
# 9.1e-7, position covariance blocks 3.7e-6, error 1.6e-9, angle 1.8e-10
# (the two-camera LM stops at another iteration in the two packages and
# the extra steps move along the 7-dof gauge; relposes.txt 2.6e-6).  The
# tolerances leave a factor of ~8 over them.
TOL = dict(pose=1e-5, points=1e-5, cov=3e-5, stats=1e-8)


def t(x):
    return torch.from_numpy(np.array(x, np.float64))


def pad2(x, n):
    out = np.zeros((n, x.shape[1]), dtype=np.float64)
    out[:len(x)] = x
    return out


def unit(M):
    M = np.asarray(M, np.float64)
    return M / np.linalg.norm(M)


def _bucket(n):
    pad = 64
    while pad < n:
        pad *= 2
    return pad


class JaxDrawReplay:
    """The JAX package's draw for the two-frame stages: the rounds of
    PRNGKey(seed) over the pair's padded length (the power of two >= 64
    that `pipeline/two_frame.py` pads to)."""

    def __call__(self, stage, seed, n_valid, num_rounds, k):
        n = int(n_valid[0])
        s = JR.sample_indices(jax.random.PRNGKey(seed), num_rounds, k,
                              jnp.int32(n), _bucket(n))
        return torch.from_numpy(np.asarray(s))[None].long()


def _corrupt(rng, xy, frac, scale=80.0):
    xy = xy.copy()
    bad = rng.choice(len(xy), int(len(xy) * frac), replace=False)
    xy[bad] += rng.normal(size=(len(bad), 2)) * scale
    return xy


# --------------------------------------------------------------------------
# ops/fmatrix.py: estimate_ematrix, refine_fmatrix_nonlinear
# --------------------------------------------------------------------------

def test_estimate_ematrix_matches_jax(rng):
    sc = SynScene(rng, num_cams=2, num_pts=250, noise=0.3)
    x1, x2 = sc.obs[0], _corrupt(rng, sc.obs[1], 0.2)
    n = len(x1)
    E, F, inl, cnt = JF.estimate_ematrix(
        KEY, jnp.asarray(pad2(x1, 256)), jnp.asarray(pad2(x2, 256)),
        jnp.int32(n), sc.f[0], sc.f[1], jnp.float64(81.0), num_rounds=512)
    s = JR.sample_indices(KEY, 512, 8, jnp.int32(n), 256)
    tE, tF, tinl, tcnt = TF.estimate_ematrix(
        torch.from_numpy(np.asarray(s)).long(), t(x1), t(x2), n,
        float(sc.f[0]), float(sc.f[1]), 81.0)
    np.testing.assert_array_equal(np.asarray(inl)[:n], tinl.numpy())
    assert int(cnt) == int(tcnt) > 0.75 * n
    assert np.abs(unit(E) - unit(tE)).max() < 1e-9
    # F = K2⁻ᵀ·(M E M)·K1⁻¹ rescales E's entries by 1 to f² ≈ 5e5 against
    # each other, so at unit norm it carries E's difference magnified
    # (3.3e-9 measured here).
    assert np.abs(unit(F) - unit(tF)).max() < 1e-8
    sv = np.linalg.svd(tE.numpy(), compute_uv=False)
    assert sv[2] < 1e-6 * sv[0] and abs(sv[0] - sv[1]) < 1e-6 * sv[0]


@pytest.mark.parametrize("scale", [1.0 / 700.0, 1.0],
                         ids=["focal_normalized", "pixels"])
def test_refine_fmatrix_nonlinear_matches_jax(rng, scale):
    """On focal-normalized coordinates the polish converges and lowers the
    inliers' cost; on raw pixels (|J| ~ 1e5) both packages' Gauss-Newton
    takes an unbounded step on its third iteration and settles on F = 0
    (the residual's 1e-300 clamps make 0 a minimum) — the port keeps the
    JAX package's result either way."""
    sc = SynScene(rng, num_cams=2, num_pts=300, noise=0.5)
    x1, x2 = sc.obs[0] * scale, _corrupt(rng, sc.obs[1], 0.3) * scale
    n = len(x1)
    F, inl, _ = JF.estimate_fmatrix_ransac(
        KEY, jnp.asarray(pad2(x1, 512)), jnp.asarray(pad2(x2, 512)),
        jnp.int32(n), jnp.float64(9.0 * scale * scale), num_rounds=256)
    mask = np.asarray(inl)[:n]
    assert mask.sum() > 0.5 * n
    want = np.asarray(JF.refine_fmatrix_nonlinear(
        F, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask)))
    got = TF.refine_fmatrix_nonlinear(t(F), t(x1), t(x2),
                                      torch.from_numpy(mask)).numpy()
    if scale == 1.0:
        assert np.abs(want).max() == np.abs(got).max() == 0.0
        return
    assert np.abs(unit(want) - unit(got)).max() < 1e-9
    m = torch.from_numpy(mask)
    cost0 = TF.fmatrix_residual(t(unit(F)), t(x2), t(x1))[m].sum()
    cost1 = TF.fmatrix_residual(t(got), t(x2), t(x1))[m].sum()
    assert float(cost1) < float(cost0)


# --------------------------------------------------------------------------
# ops/homography_decompose.py
# --------------------------------------------------------------------------

def test_decompose_homography_planar_matches_jax(rng):
    pts, (R0, c0, x0), (R1, c1, x1), f = make_planar_scene(rng)
    H = TH.fit_homography_dlt(t(x0), t(x1), torch.ones(len(x0),
                                                       dtype=torch.bool))
    H = H.numpy()
    ph = np.concatenate([x0, np.ones((len(x0), 1))], 1) @ H.T
    assert np.abs(ph[:, :2] / ph[:, 2:3] - x1).max() < 1e-6
    H_ray = TD.homography_pixel_to_ray(H, f, f)
    np.testing.assert_allclose(H_ray, JD.homography_pixel_to_ray(H, f, f),
                               rtol=0, atol=1e-12 * np.abs(H_ray).max())
    sols = TD.decompose_homography(H_ray)
    for got, want in zip(sols, JD.decompose_homography(H_ray)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    R_rel = R1 @ R0.T
    t_rel = -R_rel @ (R0 @ (c1 - c0))
    t_dir = t_rel / np.linalg.norm(t_rel)
    best = np.inf
    for R, tt, _ in sols:
        errR = np.abs(R - R_rel).max()
        tn = tt / max(np.linalg.norm(tt), 1e-12)
        errt = min(np.abs(tn - t_dir).max(), np.abs(tn + t_dir).max())
        best = min(best, errR + errt)
    assert best < 1e-6, best


def test_fundamental_from_pose_matches_jax(rng):
    pts, (R0, c0, x0), (R1, c1, x1), f = make_planar_scene(rng, n=40)
    R_rel = R1 @ R0.T
    t_rel = -R_rel @ (R0 @ (c1 - c0))
    F = TD.fundamental_from_pose(R_rel, t_rel, f, f)
    np.testing.assert_allclose(F, JD.fundamental_from_pose(R_rel, t_rel, f, f),
                               rtol=0, atol=1e-12 * np.abs(F).max())
    h0 = np.concatenate([x0, np.ones((40, 1))], 1)
    h1 = np.concatenate([x1, np.ones((40, 1))], 1)
    resid = np.abs(np.einsum("ni,ij,nj->n", h1, F, h0))
    assert resid.max() / max(np.abs(F).max(), 1e-12) < 1e-4


# --------------------------------------------------------------------------
# Covariance
# --------------------------------------------------------------------------

def _synthetic_bundle(path, num_cams=4, num_pts=120, seed=3):
    """A bundle.out written from tests/synthetic.py: noisy observations of
    every point in every camera, small radial distortion, one camera left
    unregistered (f = 0)."""
    rng = np.random.default_rng(seed)
    syn = SynScene(rng, num_cams=num_cams, num_pts=num_pts, noise=0.3,
                   k1=-0.02, k2=0.003)
    cams = [J_bf.BundleCamera(f=float(syn.f[i]), k1=-0.02, k2=0.003,
                              R=syn.R[i], t=syn.w2c_t(i))
            for i in range(num_cams)]
    cams.append(J_bf.BundleCamera(f=0.0, k1=0.0, k2=0.0, R=np.eye(3),
                                  t=np.zeros(3)))
    pts = []
    for p in range(num_pts):
        views = np.array([(c, p, *syn.obs[c][p]) for c in range(num_cams)])
        pts.append(J_bf.BundlePoint(pos=syn.points[p],
                                    color=np.array([128, 128, 128]),
                                    views=views))
    J_bf.write_bundle_file(str(path), J_bf.BundleFile(cameras=cams,
                                                      points=pts))
    return str(path)


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("distortion", [True, False],
                         ids=["distortion", "no_distortion"])
def test_scene_covariance_matches_jax(distortion, tmp_path):
    path = _synthetic_bundle(tmp_path / "bundle.out")
    jregs, jcov, jblocks = JT.scene_covariance(
        J_bf.read_bundle_file(path), estimate_distortion=distortion)
    tregs, tcov, tblocks = TT.scene_covariance(
        T_bf.read_bundle_file(path), estimate_distortion=distortion,
        device="cpu")
    assert tregs == jregs == [0, 1, 2, 3]
    _close(tcov, np.asarray(jcov), 1e-8)
    for C in tblocks:
        assert np.allclose(C, C.T, atol=1e-12)
        assert (np.linalg.eigvalsh(C) > 0).all()
    JT.write_covariance_file(str(tmp_path / "j.txt"), jregs, jblocks)
    TT.write_covariance_file(str(tmp_path / "t.txt"), tregs, tblocks)
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()


def test_camera_covariance_matches_jax(tmp_path):
    """camera_covariance at a non-default anchor weight with the focal
    frozen (its diagonal entry of U set to 1)."""
    b = J_bf.read_bundle_file(_synthetic_bundle(tmp_path / "b.out",
                                                num_cams=3, num_pts=60))
    regs = [i for i, c in enumerate(b.cameras) if c.registered]
    R0 = np.stack([b.cameras[i].R for i in regs])
    cam0 = np.zeros((len(regs), 9))
    for s, i in enumerate(regs):
        cam0[s, 0:3] = b.cameras[i].center
        cam0[s, 6:9] = b.cameras[i].f, b.cameras[i].k1, b.cameras[i].k2
    pts = np.stack([p.pos for p in b.points])
    obs = np.array([v for p in b.points for v in p.views])
    obs = obs[obs[:, 0] < len(regs)]
    args = (R0, cam0, pts, obs[:, 0].astype(np.int32),
            obs[:, 1].astype(np.int32), obs[:, 2:4])
    jp = J_ba.build_problem(*args, est_focal=False, est_distortion=True)
    tp = T_ba.build_problem(*args, est_focal=False, est_distortion=True,
                            device="cpu")
    want = JT.camera_covariance(jp, jp.cam0, jp.pts0, pt_constraint_weight=5.0)
    got = TT.camera_covariance(tp, tp.cam0, tp.pts0, pt_constraint_weight=5.0)
    assert got.shape == (27, 27)
    _close(got, np.asarray(want), 1e-8)
    np.testing.assert_allclose(np.diag(got)[6::9], 1.0, rtol=1e-12)


def test_compute_covariance_cli_matches_jax(tmp_path, monkeypatch):
    path = _synthetic_bundle(tmp_path / "b.out")
    (tmp_path / "list.txt").write_text(
        "".join(f"img{i}.jpg 0 700.0\n" for i in range(5)))
    monkeypatch.chdir(tmp_path)
    base = ["list.txt", "--bundle", path, "--compute_covariance",
            "--estimate_distortion"]
    assert J_bundler.main(base + ["--output_dir", "j"]) == 0
    assert T_bundler.main(base + ["--output_dir", "t", "--device",
                                  "cpu"]) == 0
    for name in ("covariance.txt", "bundle.processed.out"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    lines = (tmp_path / "t" / "covariance.txt").read_text().splitlines()
    assert len(lines) == 12 and lines[0] == "0"


# --------------------------------------------------------------------------
# Two-frame models
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipeline_scenes():
    rng = np.random.default_rng(0)
    js, syn = make_pipeline_scene(rng, num_cams=3, num_pts=150)
    compute_geometric_constraints(js, seed=2)
    ts = scene_from_numpy(js.entries, js.dims, js.key_xy, js.matches,
                          dataclasses.asdict(js.config), device="cpu")
    ts.tracks = [list(v) for v in js.tracks]
    ts.visible_points = [list(v) for v in js.visible_points]
    return js, ts, syn


@pytest.fixture(scope="module")
def model_tables(pipeline_scenes):
    js, ts, _ = pipeline_scenes
    return (JT.compute_model_table(js, seed=9),
            TT.compute_model_table(ts, seed=9, sampler=JaxDrawReplay()))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_compute_model_table_matches_jax(model_tables, pipeline_scenes,
                                         tmp_path):
    jm, tm = model_tables
    _, _, syn = pipeline_scenes
    assert sorted(tm) == sorted(jm) == [(0, 1), (0, 2), (1, 2)]
    for key in jm:
        j, m = jm[key], tm[key]
        assert m.num_points == j.num_points > 80
        np.testing.assert_array_equal(m.keys1, j.keys1)
        np.testing.assert_array_equal(m.keys2, j.keys2)
        assert _rel(m.R1 @ m.R0.T, j.R1 @ j.R0.T) < TOL["pose"]
        assert _rel(unit(m.c1 - m.c0), unit(j.c1 - j.c0)) < TOL["pose"]
        assert _rel(m.points, j.points) < TOL["points"]
        assert abs(m.error / j.error - 1) < TOL["stats"]
        assert abs(m.angle / j.angle - 1) < TOL["stats"]
        assert _rel(m.f1, j.f1) < TOL["points"]
        for C, Cj in ((m.C0, j.C0), (m.C1, j.C1)):
            assert _rel(C, Cj) < TOL["cov"]
            assert np.allclose(C, C.T, atol=1e-9)
            assert np.all(np.linalg.eigvalsh(C) > -1e-9)
        # tests/test_two_frame.py's bounds.
        assert m.error < 1.5 and m.angle > 1.0
    m = tm[(0, 1)]
    assert np.abs(m.R1 @ m.R0.T - syn.R[1] @ syn.R[0].T).max() < 0.05
    buf = io.StringIO()
    m.write(buf)
    lines = buf.getvalue().splitlines()
    assert int(lines[0]) == m.num_points
    assert len(lines) == 3 + m.num_points + 2 * 3 + 2
    JT.write_relative_poses(str(tmp_path / "j.txt"), jm)
    TT.write_relative_poses(str(tmp_path / "t.txt"), tm)
    jl = (tmp_path / "j.txt").read_text().split()
    tl = (tmp_path / "t.txt").read_text().split()
    assert len(tl) == len(jl) and int(tl[0]) == 3
    np.testing.assert_allclose(np.array(tl, float), np.array(jl, float),
                               rtol=TOL["pose"], atol=TOL["pose"])


def test_bundle_two_frame_matches_jax(model_tables, pipeline_scenes):
    """One pair through bundle_two_frame alone, with the seed the model
    table gave it."""
    js, ts, _ = pipeline_scenes
    jm, _ = model_tables
    m = TT.bundle_two_frame(ts, 0, 2, seed=9 + 0 * 3 + 2,
                            sampler=JaxDrawReplay())
    j = jm[(0, 2)]
    assert m.num_points == j.num_points
    assert _rel(m.R1 @ m.R0.T, j.R1 @ j.R0.T) < TOL["pose"]
    assert _rel(m.C1, j.C1) < TOL["cov"]


def _planar_scenes(rng):
    """Two views of a plane (tests/test_hdecompose.py), as one track per
    point, in both packages' Scene types."""
    pts, (R0, c0, x0), (R1, c1, x1), f = make_planar_scene(rng, n=120)
    x1 = x1 + rng.normal(size=x1.shape) * 0.2
    from bundler_sfm_tpu.config import BundlerConfig
    from bundler_sfm_tpu.io.listfile import ImageEntry
    js = JaxScene(config=BundlerConfig(),
                  entries=[ImageEntry(f"p{i}.jpg", False, f) for i in (0, 1)],
                  dims=[(1024, 768)] * 2, key_xy=[x0, x1])
    js.tracks = [[(0, k), (1, k)] for k in range(len(x0))]
    ts = scene_from_numpy(js.entries, js.dims, js.key_xy, {},
                          dataclasses.asdict(js.config), device="cpu")
    ts.tracks = js.tracks
    return js, ts, R1 @ R0.T


@pytest.mark.parametrize("kind", ["general", "planar"])
def test_estimate_relative_pose_matches_jax(kind, pipeline_scenes,
                                            monkeypatch):
    if kind == "general":
        js, ts, syn = pipeline_scenes
        R_true = syn.R[1] @ syn.R[0].T
    else:
        js, ts, R_true = _planar_scenes(np.random.default_rng(1))
    calls = []
    real = TT.decompose_homography
    monkeypatch.setattr(TT, "decompose_homography",
                        lambda H: calls.append(1) or real(H))
    want = JT.estimate_relative_pose(js, 0, 1, seed=5)
    got = TT.estimate_relative_pose(ts, 0, 1, seed=5,
                                    sampler=JaxDrawReplay())
    assert want is not None and got is not None
    assert bool(calls) == (kind == "planar")
    assert np.abs(got[0] - want[0]).max() < 1e-8
    assert np.abs(unit(got[1]) - unit(want[1])).max() < 1e-8
    assert np.abs(got[0] - R_true).max() < 0.05

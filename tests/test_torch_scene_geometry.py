"""The port's plane fits (`ops/plane.py`), scene geometry
(`export/scene_geometry.py`) and XML writers (`io/xmlfile.py`) against the
JAX package's, on the CPU in f64, with the JAX package's RANSAC draw (its
Gumbel top-k over the mask) passed in as the port's samples.

Tolerances: RANSAC fits (plane, line, `fit_plane_to_points`, the ground
plane) give the same inlier masks and models within 1e-10 (a 2D line up to
its sign, which is the eigensolver's in both packages); kNN normals
|n_port · n_jax| >= 1 - 1e-10, `estimate_point_normals` (oriented) within
1e-10 with its sign; `remove_bad_images`, `images_part_of_panorama`,
`compute_image_rotations`, the host-numpy functions and both XML writers
(bytes) exact.  Every scene is checked to keep its points at least 1e-9
from each RANSAC threshold, so rounding cannot flip an inlier.  The
assertions of `tests/test_scene_geometry.py` run as port cases too.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import xml.dom.minidom as minidom

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundler_sfm_tpu.export import scene_geometry as JS
from bundler_sfm_tpu.io import bundlefile as JB
from bundler_sfm_tpu.io import xmlfile as JX
from bundler_sfm_tpu.ops import plane as JP
from bundler_sfm_tpu_torch.export import scene_geometry as TS
from bundler_sfm_tpu_torch.io import bundlefile as TB
from bundler_sfm_tpu_torch.io import xmlfile as TX
from bundler_sfm_tpu_torch.ops import plane as TP
from tests.synthetic import look_at_rotation
from tests.test_scene_geometry import plane_points


def t(x):
    return torch.from_numpy(np.array(x, np.float64))


def jax_draw(seed, rounds, n, k, mask=None):
    """The samples JAX's fit_plane_ransac / fit_line_2d_ransac draw from
    PRNGKey(seed) (`bundler_sfm_tpu/ops/plane.py:69-71`)."""
    m = np.ones(n) if mask is None else mask
    logits = jnp.where(jnp.asarray(m) > 0, 0.0, -jnp.inf)
    g = jax.random.gumbel(jax.random.PRNGKey(seed), (rounds, n),
                          dtype=jnp.float64) + logits[None]
    return np.array(jax.lax.top_k(g, k)[1])


def assert_margin(dist, threshold):
    """No point within 1e-9 of the threshold (no knife edge)."""
    assert np.abs(np.asarray(dist) - threshold).min() > 1e-9


def make_bundles(rng, n_cams=8, n_pts=60, up=(0.0, 1.0, 0.0), radius=4.0,
                 height=0.0):
    """Cameras on a ring in the plane perpendicular to `up` (raised by
    `height` along it), looking at the origin; points near the origin.
    Returns the same scene as a JAX-package and a port BundleFile, and the
    camera centres."""
    up = np.asarray(up, float)
    up /= np.linalg.norm(up)
    a = np.cross(up, [1.0, 0.0, 0.0])
    if np.linalg.norm(a) < 1e-6:
        a = np.cross(up, [0.0, 0.0, 1.0])
    a /= np.linalg.norm(a)
    b = np.cross(up, a)
    cams, centers = [], []
    for i in range(n_cams):
        th = 2 * np.pi * i / n_cams
        c = radius * (np.cos(th) * a + np.sin(th) * b) + height * up
        c += up * rng.normal() * 0.02
        R = look_at_rotation(c, np.zeros(3), up=up)
        cams.append((R, c))
        centers.append(c)
    pos = rng.normal(size=(n_pts, 3)) * 0.5
    views = np.array([[i, 0, 0.0, 0.0] for i in range(n_cams)])

    def build(mod):
        return mod.BundleFile(
            cameras=[mod.BundleCamera(f=700.0, k1=0.0, k2=0.0, R=R.copy(),
                                      t=-R @ c) for R, c in cams],
            points=[mod.BundlePoint(pos=p.copy(),
                                    color=np.array([128, 128, 128.0]),
                                    views=views.copy()) for p in pos])
    return build(JB), build(TB), np.stack(centers)


def set_point(bundles, i, **kw):
    for bf in bundles:
        p = bf.points[i]
        fields = dict(pos=p.pos, color=p.color, views=p.views)
        fields.update(kw)
        bf.points[i] = type(p)(**fields)


# --- ops/plane.py ----------------------------------------------------------

def test_fit_plane_ortho_matches_jax(rng):
    normal = np.array([1.0, 2.0, -0.5])
    pts = plane_points(rng, 50, normal, d=-3.0, noise=0.01)
    mask = (rng.uniform(size=50) > 0.2).astype(np.float64)
    for m in (None, mask):
        want = np.asarray(JP.fit_plane_ortho(
            jnp.asarray(pts), None if m is None else jnp.asarray(m)))
        got = TP.fit_plane_ortho(t(pts), None if m is None else t(m))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-10)
    # The exact case of tests/test_scene_geometry.py.
    pts = plane_points(rng, 50, normal, d=-3.0)
    plane = TP.fit_plane_ortho(t(pts)).numpy()
    gt = normal / np.linalg.norm(normal)
    assert min(np.linalg.norm(plane[:3] - gt),
               np.linalg.norm(plane[:3] + gt)) < 1e-8
    assert np.abs(pts @ plane[:3] + plane[3]).max() < 1e-8
    assert plane[3] <= 0.0
    np.testing.assert_allclose(TP.plane_point_distance(t(plane), t(pts)),
                               np.asarray(JP.plane_point_distance(
                                   jnp.asarray(plane), jnp.asarray(pts))),
                               rtol=0, atol=1e-15)


@pytest.mark.parametrize("masked", [False, True])
def test_fit_plane_ransac_matches_jax(rng, masked):
    pts = plane_points(rng, 200, [0.0, 1.0, 0.2], d=-1.0, noise=0.01)
    allpts = np.concatenate([pts, rng.uniform(-5, 5, (60, 3))])
    mask = np.ones(len(allpts))
    if masked:
        mask[:100] = 0.0
    key = jax.random.PRNGKey(0)
    jplane, jn, jinl = JP.fit_plane_ransac(key, jnp.asarray(allpts),
                                           jnp.asarray(mask), 0.05,
                                           rounds=512)
    samples = jax_draw(0, 512, len(allpts), 3, mask)
    plane, n, inl = TP.fit_plane_ransac(torch.from_numpy(samples), t(allpts),
                                        t(mask), 0.05)
    assert_margin(np.abs(allpts @ np.asarray(jplane)[:3]
                         + np.asarray(jplane)[3]), 0.05)
    assert int(n) == int(jn)
    assert np.array_equal(inl.numpy(), np.asarray(jinl))
    np.testing.assert_allclose(plane.numpy(), np.asarray(jplane), atol=1e-10)
    # tests/test_scene_geometry.py: >180 inliers, close fit, mask respected.
    if masked:
        assert not inl[:100].any()
    else:
        assert int(n) > 180
        assert np.median(np.abs(pts @ plane[:3].numpy()
                                + float(plane[3]))) < 0.02


def test_fit_line_2d_ransac_matches_jax(rng):
    s = rng.uniform(-4, 4, 150)
    pts = np.stack([s, 0.5 * s + 2.0], axis=1)
    pts += rng.normal(size=pts.shape) * 0.01
    allp = np.concatenate([pts, rng.uniform(-4, 4, (40, 2))])
    jline, jn, jinl = JP.fit_line_2d_ransac(
        jax.random.PRNGKey(1), jnp.asarray(allp), jnp.ones(len(allp)), 0.05,
        rounds=256)
    jline = np.asarray(jline)
    samples = jax_draw(1, 256, len(allp), 2)
    line, n, inl = TP.fit_line_2d_ransac(torch.from_numpy(samples), t(allp),
                                         torch.ones(len(allp)), 0.05)
    line = line.numpy()
    assert_margin(np.abs(allp @ jline[:2] + jline[2]), 0.05)
    assert int(n) == int(jn) and int(n) > 130
    assert np.array_equal(inl.numpy(), np.asarray(jinl))
    sign = np.sign(line @ jline)
    np.testing.assert_allclose(sign * line, jline, atol=1e-10)
    np.testing.assert_allclose(
        TP.fit_line_2d_ortho(t(allp), inl).numpy() * sign,
        np.asarray(JP.fit_line_2d_ortho(jnp.asarray(allp),
                                        jnp.asarray(jinl, jnp.float64))),
        atol=1e-10)
    assert np.median(np.abs(pts @ line[:2] + line[2])) < 0.03


def test_draw_samples(rng):
    mask = torch.from_numpy((rng.uniform(size=40) > 0.5).astype(np.float64))
    gen = torch.Generator().manual_seed(3)
    s = TP.draw_samples(gen, 500, 3, mask)
    assert s.shape == (500, 3)
    assert bool((mask[s] > 0).all())
    assert bool((s[:, 0] != s[:, 1]).all() & (s[:, 1] != s[:, 2]).all()
                & (s[:, 0] != s[:, 2]).all())
    # Every valid entry drawn.
    assert set(s.flatten().tolist()) == set(
        torch.nonzero(mask > 0)[:, 0].tolist())
    with pytest.raises(ValueError, match="at least 3 points"):
        TP.draw_samples(gen, 4, 3, torch.ones(2))


@pytest.mark.parametrize("blocks", [1, 7])
def test_knn_plane_normals_matches_jax(rng, blocks, monkeypatch):
    """Up to sign; the port's row blocks (7 here) give the same normals."""
    n = 300
    pts = plane_points(rng, n, [0.2, 1.0, 0.0], d=-1.0, noise=0.002)
    pts[200:] = rng.normal(size=(100, 3)) + 20.0  # a blob: ill-posed normals
    mask = np.ones(n)
    mask[[5, 77, 250]] = 0.0
    monkeypatch.setattr(TP, "_KNN_BLOCK_ELEMS", -(-n // blocks) * n)
    want = np.asarray(JP.knn_plane_normals(jnp.asarray(pts),
                                           jnp.asarray(mask), k=16))
    got = TP.knn_plane_normals(pts, mask, k=16, device="cpu").numpy()
    dots = np.abs((got * want).sum(1))
    # Well-posed rows (a clear smallest eigenvalue) to 1e-10.
    assert (dots[:200] >= 1 - 1e-10).all()
    # tests/test_scene_geometry.py: normals of the plane's points.
    gt = np.array([0.2, 1.0, 0.0]) / np.linalg.norm([0.2, 1.0, 0.0])
    assert (np.abs(got[:200] @ gt) > 0.99).mean() > 0.95


# --- export/scene_geometry.py ----------------------------------------------

@pytest.mark.parametrize("mode", ["free", "perp_to_up", "par_to_up"])
def test_fit_plane_to_points_matches_jax(rng, mode):
    up = np.array([0.0, 1.0, 0.0])
    if mode == "par_to_up":
        s = rng.uniform(-3, 3, 80)
        pts = np.stack([s, rng.uniform(0, 2, 80), 0.3 * s + 1.0], axis=1)
        pts[:, [0, 2]] += rng.normal(size=(80, 2)) * 0.005
        pts = np.concatenate([pts, rng.uniform(-3, 3, (20, 3))])
    else:
        pts = plane_points(rng, 120, [0.0, 1.0, 0.0], d=-2.0, noise=0.005)
        pts = np.concatenate([pts, rng.uniform(-5, 5, (30, 3))])
    idx = np.sort(rng.choice(len(pts), len(pts) - 10, replace=False))
    kw = dict(ransac_threshold=0.05, ransac_rounds=256, up=up,
              par_to_up=mode == "par_to_up", perp_to_up=mode == "perp_to_up")
    jplane, jinl = JS.fit_plane_to_points(pts, idx, seed=4, **kw)
    samples = jax_draw(4, 256, len(idx), 2 if mode == "par_to_up" else 3)
    plane, inl = TS.fit_plane_to_points(pts, idx, samples=samples,
                                        device="cpu", **kw)
    assert np.array_equal(inl, jinl)
    if mode == "par_to_up":
        assert plane[1] == 0.0 and len(inl) > 70
        plane = plane * np.sign(plane @ jplane)
    else:
        assert_margin(np.abs(pts[idx] @ jplane[:3] + jplane[3]), 0.05)
        assert len(inl) > 100
        assert abs(plane[1]) > 0.999
    if mode == "perp_to_up":
        assert np.allclose(plane[:3], up)
    np.testing.assert_allclose(plane, jplane, atol=1e-10)


@pytest.mark.parametrize("up_image", [-1, 2])
def test_setup_scene_ground_plane_matches_jax(rng, up_image):
    up_gt = np.array([0.1, 1.0, -0.05])
    up_gt /= np.linalg.norm(up_gt)
    jb, tb, centers = make_bundles(rng, up=up_gt)
    want = JS.setup_scene_ground_plane(jb, up_image=up_image, seed=2)
    samples = jax_draw(2, 1024, 8, 3)
    got = TS.setup_scene_ground_plane(tb, up_image=up_image, samples=samples,
                                      device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-10)
    center, up, x_axis, z_axis, scale = got
    # tests/test_scene_geometry.py's assertions.
    assert np.allclose(center, centers.mean(axis=0))
    assert abs(up @ up_gt) > 0.999 and up @ up_gt > 0
    assert abs(x_axis @ up) < 1e-8
    assert np.allclose(np.cross(x_axis, up), z_axis)
    assert scale == pytest.approx(np.sqrt(
        ((centers - centers.mean(0)) ** 2).sum(1).mean()), rel=1e-6)
    # setup_scene with and without the Szeliski axes.
    for szeliski in (False, True):
        w = JS.setup_scene(jb, up_image=up_image, seed=2,
                           estimate_up_vector_szeliski=szeliski)
        g = TS.setup_scene(tb, up_image=up_image, samples=samples,
                           device="cpu", estimate_up_vector_szeliski=szeliski)
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, atol=1e-10)


def test_estimate_axes(rng):
    jb, tb, _ = make_bundles(rng)
    x_axis, y_axis, z_axis = TS.estimate_axes(tb)
    for g, w in zip((x_axis, y_axis, z_axis), JS.estimate_axes(jb)):
        assert np.array_equal(g, w)
    assert abs(y_axis @ np.array([0.0, 1.0, 0.0])) > 0.99
    assert abs(x_axis @ y_axis) < 1e-8
    assert np.allclose(np.cross(x_axis, y_axis), z_axis, atol=1e-8)


def test_compute_image_rotations_matches_jax(rng):
    jb, tb, _ = make_bundles(rng)
    samples = jax_draw(0, 1024, 8, 3)
    rots = TS.compute_image_rotations(tb, samples=samples, device="cpu")
    assert rots == JS.compute_image_rotations(jb) == [0] * 8
    # Roll camera 0 by 90 degrees about its optical axis -> quarter turn.
    Rz = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    for bf in (jb, tb):
        c0 = bf.cameras[0]
        bf.cameras[0] = type(c0)(f=c0.f, k1=0, k2=0, R=Rz @ c0.R,
                                 t=Rz @ c0.t)
    rots = TS.compute_image_rotations(tb, samples=samples, device="cpu")
    assert rots == JS.compute_image_rotations(jb)
    assert rots[0] in (1, 3) and rots[1] == 0


def test_point_normals_confidence_matches_jax(rng):
    jb, tb, _ = make_bundles(rng, n_cams=8, n_pts=10)
    set_point((jb, tb), 0, views=jb.points[0].views[:2])
    normals, conf = TS.estimate_point_normals_confidence(tb)
    jn, jc = JS.estimate_point_normals_confidence(jb)
    assert np.array_equal(normals, jn) and np.array_equal(conf, jc)
    assert np.allclose(np.linalg.norm(normals, axis=1), 1.0)
    assert (conf[1:] > 0.9).all() and conf[0] == 0.0


def test_remove_bad_images_matches_jax(rng):
    jb, tb, _ = make_bundles(rng, n_cams=4, n_pts=30)
    for i in range(5, 30):
        set_point((jb, tb), i, views=jb.points[i].views[
            jb.points[i].views[:, 0] != 3])
    out = TS.remove_bad_images(tb, min_num_points=24)
    want = JS.remove_bad_images(jb, min_num_points=24)
    assert [c.registered for c in out.cameras] == \
        [c.registered for c in want.cameras] == [True, True, True, False]
    for a, b in zip(out.cameras, want.cameras):
        assert np.array_equal(a.R, b.R) and np.array_equal(a.t, b.t)
    for p, q in zip(out.points, want.points):
        assert np.array_equal(p.views, q.views)
        assert 3 not in p.views[:, 0].astype(int)
    assert TS.remove_bad_images(tb, min_num_points=5) is tb


def test_images_part_of_panorama_matches_jax(rng):
    jb, tb, _ = make_bundles(rng, n_cams=4, n_pts=30)
    for i, j in ((0, 1), (1, 3)):
        assert not TS.images_part_of_panorama(tb, i, j)
        assert not JS.images_part_of_panorama(jb, i, j)
    c = np.array([0.0, 0.0, 10.0])
    R1 = look_at_rotation(c, np.zeros(3))
    R2 = look_at_rotation(c + 1e-4, np.zeros(3))
    pos = rng.normal(size=(10, 3)) * 0.5
    views = np.array([[0, 0, 0, 0], [1, 0, 0, 0.0]])
    pano = [mod.BundleFile(
        cameras=[mod.BundleCamera(f=700.0, k1=0, k2=0, R=R1, t=-R1 @ c),
                 mod.BundleCamera(f=700.0, k1=0, k2=0, R=R2,
                                  t=-R2 @ (c + 1e-4))],
        points=[mod.BundlePoint(pos=p, color=np.zeros(3), views=views)
                for p in pos]) for mod in (JB, TB)]
    assert TS.images_part_of_panorama(pano[1], 0, 1)
    assert JS.images_part_of_panorama(pano[0], 0, 1)


def test_get_point_projections_matches_jax(rng):
    jb, tb, _ = make_bundles(rng, n_cams=4, n_pts=30)
    for w, h in ((10000, 10000), (2, 2), (0, 0)):
        projs, kept = TS.get_point_projections(tb, 0, width=w, height=h)
        wp, wk = JS.get_point_projections(jb, 0, width=w, height=h)
        assert np.array_equal(projs, wp) and np.array_equal(kept, wk)
    assert len(TS.get_point_projections(tb, 0, width=10000,
                                        height=10000)[1]) == 30
    projs, kept = TS.get_point_projections(tb, 0, width=2, height=2)
    assert len(kept) < 30 and (np.abs(projs) <= 1.0).all()


def test_estimate_point_normals_matches_jax(rng):
    """Signed: the cameras look down on a wavy surface, so every normal's
    orientation against its mean viewing ray is far from a knife edge."""
    jb, tb, _ = make_bundles(rng, n_cams=6, n_pts=80, height=3.0)
    for i, p in enumerate(jb.points):
        pos = p.pos.copy()
        pos[1] = 0.05 * np.sin(2.0 * pos[0]) + 0.01 * rng.normal()
        set_point((jb, tb), i, pos=pos)
    want = JS.estimate_point_normals(jb, k=12)
    got = TS.estimate_point_normals(tb, k=12, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-10)
    assert (got[:, 1] > 0.9).all()          # toward the cameras above


def test_estimate_point_normals_flat(rng):
    """tests/test_scene_geometry.py's case: points flattened onto y = 0."""
    _, tb, _ = make_bundles(rng, n_cams=6, n_pts=40)
    for i, p in enumerate(tb.points):
        pos = p.pos.copy()
        pos[1] = 0.0
        set_point((tb,), i, pos=pos)
    normals = TS.estimate_point_normals(tb, k=12, device="cpu")
    assert np.allclose(np.abs(normals[:, 1]), 1.0, atol=1e-2)
    assert TS.estimate_point_normals(TB.BundleFile(cameras=[], points=[]),
                                     device="cpu").shape == (0, 3)


# --- io/xmlfile.py -----------------------------------------------------------

def test_xml_writers_byte_identical(rng, tmp_path):
    jb, tb, _ = make_bundles(rng, n_cams=3, n_pts=8)
    set_point((jb, tb), 2, views=jb.points[2].views[:2])
    names = [f"img{i}.key" for i in range(3)]
    dims = [(1024, 768), (800, 600)]           # camera 2 has no size
    for plane in (None, np.array([0.0, 1.0, 0.0, 5.0]),
                  np.array([0.0, 1.0, 0.0, -50.0])):
        JX.write_cameras_xml(str(tmp_path / "j.xml"), jb, names, dims,
                             fit_plane=plane)
        TX.write_cameras_xml(str(tmp_path / "t.xml"), tb, names, dims,
                             fit_plane=plane)
        txt = (tmp_path / "t.xml").read_text()
        assert txt == (tmp_path / "j.xml").read_text()
        assert txt.count("<camera>") == 3 and "img0.jpg" in txt
        assert ("<p1>" in txt) == (plane is not None)
    for mv in (2, 3):
        JX.write_points_xml(str(tmp_path / "jp.xml"), jb, min_views=mv)
        TX.write_points_xml(str(tmp_path / "tp.xml"), tb, min_views=mv)
        body = (tmp_path / "tp.xml").read_text()
        assert body == (tmp_path / "jp.xml").read_text()
        assert body.count("<point>") == (8 if mv == 2 else 7)
        minidom.parseString(body[body.index("<points>"):])

"""The port's post-bundle tools against the JAX package's, on the CPU:
`export/undistort.py` (+ `radialundistort`), `export/pmvs.py`
(+ `bundle2pmvs`), `export/vis.py` (+ `bundle2vis`) and `bundle2ply`, on
a bundle and images the test writes itself.

Held byte-identical: `undistort_image` (the identity and radial cases of
tests/test_export.py), `radial_undistort`'s images, `bundle.rd.out` and
`list.rd.txt`, `write_pmvs`'s `txt/*.txt` and `pmvs_options.txt`,
`vis.dat` and the PLY; `prep_pmvs.sh` once the two module names it runs
are swapped.  The PMVS projections map every point to its observations.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import os
import shutil

import numpy as np
import pytest

from tests.synthetic import Scene as SynScene

from bundler_sfm_tpu import bundle2ply as J_b2ply
from bundler_sfm_tpu import bundle2pmvs as J_b2pmvs
from bundler_sfm_tpu import bundle2vis as J_b2vis
from bundler_sfm_tpu import radialundistort as J_ru
from bundler_sfm_tpu.export import pmvs as J_pmvs
from bundler_sfm_tpu.export import undistort as J_und
from bundler_sfm_tpu.export import vis as J_vis
from bundler_sfm_tpu.io import bundlefile as J_bf

from bundler_sfm_tpu_torch import bundle2ply as T_b2ply
from bundler_sfm_tpu_torch import bundle2pmvs as T_b2pmvs
from bundler_sfm_tpu_torch import bundle2vis as T_b2vis
from bundler_sfm_tpu_torch import radialundistort as T_ru
from bundler_sfm_tpu_torch.export import pmvs as T_pmvs
from bundler_sfm_tpu_torch.export import undistort as T_und
from bundler_sfm_tpu_torch.export import vis as T_vis
from bundler_sfm_tpu_torch.io.bundlefile import read_bundle_file

W, H = 160, 120


def test_undistort_image_identity():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    out = T_und.undistort_image(img, f=100.0, k1=0.0, k2=0.0, device="cpu")
    # k=0: interior pixels unchanged.
    assert np.array_equal(out[1:-2, 1:-2], img[1:-2, 1:-2])
    np.testing.assert_array_equal(
        out, J_und.undistort_image(img, f=100.0, k1=0.0, k2=0.0))


@pytest.mark.parametrize("k", [(-0.2, 0.0), (0.15, -0.05)],
                         ids=["barrel", "pincushion"])
def test_undistort_image_radial(k):
    img = np.zeros((101, 101, 3), dtype=np.uint8)
    img[48:53, 48:53] = 255  # center block
    img[10:20, 70:95] = 90
    out = T_und.undistort_image(img, f=50.0, k1=k[0], k2=k[1], device="cpu")
    # Center is a fixed point of radial distortion.
    assert out[50, 50, 0] == 255
    np.testing.assert_array_equal(
        out, J_und.undistort_image(img, f=50.0, k1=k[0], k2=k[1]))


@pytest.fixture
def scene_dir(tmp_path):
    """A bundle.out written from tests/synthetic.py (5 cameras, one
    unregistered, radial distortion, 200 points seen by every registered
    camera), list.txt and one random JPEG per image."""
    from PIL import Image
    rng = np.random.default_rng(4)
    syn = SynScene(rng, num_cams=4, num_pts=200, f=150.0, k1=-0.05, k2=0.01,
                   noise=0.1)
    cams = [J_bf.BundleCamera(f=150.0, k1=-0.05, k2=0.01, R=syn.R[i],
                              t=syn.w2c_t(i)) for i in range(4)]
    cams.insert(2, J_bf.BundleCamera(f=0.0, k1=0.0, k2=0.0, R=np.eye(3),
                                     t=np.zeros(3)))
    slot = [0, 1, 3, 4]
    pts = []
    for p in range(len(syn.points)):
        views = np.array([(slot[c], p, *syn.obs[c][p]) for c in range(4)])
        col = rng.integers(0, 256, 3)
        if p % 17 == 0:
            col = np.array([0, 0, 255])     # an outlier colour PLY skips
        pts.append(J_bf.BundlePoint(pos=syn.points[p], color=col,
                                    views=views))
    J_bf.write_bundle_file(str(tmp_path / "bundle.out"),
                           J_bf.BundleFile(cameras=cams, points=pts))
    names = [f"view{i}.jpg" for i in range(5)]
    for n in names:
        Image.fromarray(rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
                        ).save(tmp_path / n, quality=95)
    (tmp_path / "list.txt").write_text("".join(f"{n} 0 150.0\n"
                                               for n in names))
    return tmp_path


def _twin_dirs(scene_dir):
    """Two copies of the scene directory, for the two packages' runs with
    the same relative paths."""
    out = []
    for name in ("j", "t"):
        d = scene_dir / name
        d.mkdir()
        for f in os.listdir(scene_dir):
            if os.path.isfile(scene_dir / f):
                shutil.copy(scene_dir / f, d / f)
        out.append(d)
    return out


def _same_tree(a, b, rename=None):
    files = sorted(os.path.relpath(os.path.join(r, f), a)
                   for r, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), b)
                           for r, _, fs in os.walk(b) for f in fs)
    for f in files:
        x = open(os.path.join(a, f), "rb").read()
        y = open(os.path.join(b, f), "rb").read()
        if rename and f.endswith(".sh"):
            for old, new in rename:
                x = x.replace(old, new)
        assert x == y, f
    return files


@pytest.mark.parametrize("missing", [False, True],
                         ids=["all_images", "one_image_missing"])
def test_radial_undistort_matches_jax(scene_dir, monkeypatch, missing):
    """A listed image that is absent is still listed in list.rd.txt (and
    bundle.rd.out), only its .rd.jpg is not written."""
    jd, td = _twin_dirs(scene_dir)
    if missing:
        for d in (jd, td):
            os.remove(d / "view4.jpg")
    monkeypatch.chdir(jd)
    assert J_ru.main(["list.txt", "bundle.out", "rd"]) == 0
    monkeypatch.chdir(td)
    assert T_ru.main(["list.txt", "bundle.out", "rd", "--device", "cpu"]) == 0
    files = _same_tree(jd / "rd", td / "rd")
    assert sorted(files) == ["bundle.rd.out", "list.rd.txt", "view0.rd.jpg",
                             "view1.rd.jpg", "view3.rd.jpg"] + \
        ([] if missing else ["view4.rd.jpg"])
    b = read_bundle_file(str(td / "rd" / "bundle.rd.out"))
    assert all(c.k1 == 0.0 and c.k2 == 0.0 for c in b.cameras)
    kept, _ = T_und.radial_undistort("list.txt", "bundle.out", "rd2",
                                     device="cpu")
    assert kept == [os.path.join("rd2", f"view{i}.rd.jpg")
                    for i in (0, 1, 3, 4)]


SWAP = [(b"bundler_sfm_tpu_torch.radialundistort",
         b"bundler_sfm_tpu.radialundistort"),
        (b"bundler_sfm_tpu_torch.bundle2vis", b"bundler_sfm_tpu.bundle2vis")]


def test_bundle2pmvs_matches_jax(scene_dir, monkeypatch):
    jd, td = _twin_dirs(scene_dir)
    monkeypatch.chdir(jd)
    assert J_b2pmvs.main(["list.txt", "bundle.out", "pmvs"]) == 0
    monkeypatch.chdir(td)
    assert T_b2pmvs.main(["list.txt", "bundle.out", "pmvs"]) == 0
    # The script differs only in the two module names it runs.
    tsh = (td / "pmvs" / "prep_pmvs.sh").read_bytes()
    jsh = (jd / "pmvs" / "prep_pmvs.sh").read_bytes()
    assert tsh != jsh and len([1 for a, b in zip(tsh.splitlines(),
                                                 jsh.splitlines())
                               if a != b]) == 2
    files = _same_tree(td / "pmvs", jd / "pmvs", rename=SWAP)
    assert [f for f in files if f.startswith("txt")] == \
        [os.path.join("txt", f"{i:08d}.txt") for i in range(4)]
    assert "timages -1 0 4" in (td / "pmvs" / "pmvs_options.txt").read_text()


def test_write_pmvs_with_dims_matches_jax(scene_dir, tmp_path, monkeypatch):
    dims = [(W, H)] * 5
    args = (str(scene_dir / "list.txt"), str(scene_dir / "bundle.out"))
    counts = []
    for name, write in (("t", T_pmvs.write_pmvs), ("j", J_pmvs.write_pmvs)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        counts.append(write("pmvs", *args, image_dims=dims))
    assert counts == [4, 4]
    _same_tree(tmp_path / "t", tmp_path / "j", rename=SWAP)


def test_pmvs_projection_projects_points(scene_dir):
    """P from pmvs_projection projects the bundle's points onto their
    observations (top-left origin, -f convention), up to the radial
    distortion P leaves out."""
    b = read_bundle_file(str(scene_dir / "bundle.out"))
    for ci, cam in enumerate(b.cameras):
        if not cam.registered:
            continue
        P = T_pmvs.pmvs_projection(cam.f, cam.R, cam.t, W, H)
        np.testing.assert_array_equal(
            P, J_pmvs.pmvs_projection(cam.f, cam.R, cam.t, W, H))
        errs = []
        for p in b.points:
            v = next(v for v in p.views if int(v[0]) == ci)
            q = P @ np.append(p.pos, 1.0)
            x_img = v[2] + 0.5 * (W - 1)
            y_img = (H - 1) - (v[3] + 0.5 * (H - 1))
            errs.append(np.hypot(q[0] / q[2] - x_img, q[1] / q[2] - y_img))
        assert np.median(errs) < 4.0


def test_bundle2vis_matches_jax(scene_dir, tmp_path):
    assert T_b2vis.main([str(scene_dir / "bundle.out"),
                         str(tmp_path / "t.dat")]) == 0
    assert J_b2vis.main([str(scene_dir / "bundle.out"),
                         str(tmp_path / "j.dat")]) == 0
    assert (tmp_path / "t.dat").read_bytes() == \
        (tmp_path / "j.dat").read_bytes()
    b = read_bundle_file(str(scene_dir / "bundle.out"))
    counts = T_vis.covisibility_counts(b)
    np.testing.assert_array_equal(counts, J_vis.covisibility_counts(b))
    lines = (tmp_path / "t.dat").read_text().splitlines()
    assert lines[0] == "VISDATA" and int(lines[1]) == 5 and len(lines) == 7
    # Threshold: pairs with >= 32 shared points are listed.
    T_vis.write_vis_file(str(scene_dir / "bundle.out"),
                         str(tmp_path / "t2.dat"), threshold=201)
    assert (tmp_path / "t2.dat").read_text().splitlines()[2] == "0 0"


def test_bundle2ply_matches_jax(scene_dir, tmp_path):
    assert T_b2ply.main([str(scene_dir / "bundle.out"),
                         str(tmp_path / "t.ply")]) == 0
    assert J_b2ply.main([str(scene_dir / "bundle.out"),
                         str(tmp_path / "j.ply")]) == 0
    data = (tmp_path / "t.ply").read_bytes()
    assert data == (tmp_path / "j.ply").read_bytes()
    # 200 points less the 12 outlier-coloured ones, 2 vertices a camera.
    assert b"element vertex 196\n" in data


@pytest.mark.parametrize("main", [T_b2pmvs.main, T_b2vis.main, T_b2ply.main],
                         ids=["bundle2pmvs", "bundle2vis", "bundle2ply"])
def test_tools_print_usage(main, capsys):
    assert main([]) == 1
    assert "python -m bundler_sfm_tpu_torch." in capsys.readouterr().out

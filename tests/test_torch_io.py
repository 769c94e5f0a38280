"""The port's copies of the host I/O modules write byte-identical files to
the JAX package's, from the same data."""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import gzip

import numpy as np
import pytest
from PIL import Image

from bundler_sfm_tpu.config import default_pipeline_config as jax_config
from bundler_sfm_tpu.io import bundlefile as J_bundlefile
from bundler_sfm_tpu.io import constraints as J_constraints
from bundler_sfm_tpu.io import exif as J_exif
from bundler_sfm_tpu.io import keyfile as J_keyfile
from bundler_sfm_tpu.io import listfile as J_listfile
from bundler_sfm_tpu.io import matchfile as J_matchfile
from bundler_sfm_tpu.io import plyfile as J_plyfile
from bundler_sfm_tpu.pipeline import scene as J_scene
from bundler_sfm_tpu.pipeline import tracks as J_tracks
from bundler_sfm_tpu_torch.config import default_pipeline_config as port_config
from bundler_sfm_tpu_torch.io import bundlefile as T_bundlefile
from bundler_sfm_tpu_torch.io import constraints as T_constraints
from bundler_sfm_tpu_torch.io import exif as T_exif
from bundler_sfm_tpu_torch.io import keyfile as T_keyfile
from bundler_sfm_tpu_torch.io import listfile as T_listfile
from bundler_sfm_tpu_torch.io import matchfile as T_matchfile
from bundler_sfm_tpu_torch.io import plyfile as T_plyfile
from bundler_sfm_tpu_torch.pipeline import scene as T_scene
from bundler_sfm_tpu_torch.pipeline import tracks as T_tracks


def _keys(rng, n):
    info = np.stack([rng.uniform(0, 640, n), rng.uniform(0, 480, n),
                     rng.uniform(1, 20, n), rng.uniform(-np.pi, np.pi, n)],
                    1).astype(np.float32)
    return info, rng.integers(0, 256, (n, 128)).astype(np.uint8)


def _matches(rng):
    return {(i, j): rng.integers(0, 300, (int(rng.integers(0, 40)), 2)
                                 ).astype(np.int32)
            for i in range(4) for j in range(i + 1, 4)}


def _write_both(tmp_path, name, jax_fn, port_fn):
    a, b = tmp_path / f"jax_{name}", tmp_path / f"port_{name}"
    jax_fn(str(a))
    port_fn(str(b))
    return a.read_bytes(), b.read_bytes()


def test_list_file_identical(tmp_path):
    rows = [("img0.jpg", False, 0.0), ("dir/img1.jpg", False, 532.25),
            ("img2.jpg", True, 1234.5678)]
    a, b = _write_both(
        tmp_path, "list.txt",
        lambda p: J_listfile.write_list_file(
            p, [J_listfile.ImageEntry(*r) for r in rows]),
        lambda p: T_listfile.write_list_file(
            p, [T_listfile.ImageEntry(*r) for r in rows]))
    assert a == b and len(a) > 0


def test_match_file_identical(tmp_path, rng):
    m = _matches(rng)
    a, b = _write_both(tmp_path, "matches.init.txt",
                       lambda p: J_matchfile.write_match_file(p, m),
                       lambda p: T_matchfile.write_match_file(p, m))
    assert a == b
    back = T_matchfile.read_match_file(str(tmp_path / "jax_matches.init.txt"))
    assert back.keys() == m.keys()
    assert all(np.array_equal(back[k], m[k]) for k in m)


@pytest.mark.parametrize("suffix", [".key", ".key.gz"])
def test_key_file_identical(tmp_path, rng, suffix):
    info, desc = _keys(rng, 57)
    a, b = _write_both(tmp_path, "k" + suffix,
                       lambda p: J_keyfile.write_key_file(p, info, desc),
                       lambda p: T_keyfile.write_key_file(p, info, desc))
    if suffix.endswith(".gz"):        # the gzip header carries a timestamp
        a, b = gzip.decompress(a), gzip.decompress(b)
    assert a == b
    ji, jd = J_keyfile.read_key_file(str(tmp_path / ("port_k" + suffix)))
    ti, td = T_keyfile.read_key_file(str(tmp_path / ("jax_k" + suffix)))
    np.testing.assert_array_equal(ji, ti)
    np.testing.assert_array_equal(jd, td)


def test_key_file_float_descriptors(tmp_path, rng):
    """A key file whose descriptors are written `v.0`: the native tokenizer
    refuses it, and both packages fall back to their numpy parser and read
    the same [n, 4] / [n, 128] arrays."""
    from bundler_sfm_tpu_torch import native
    info, desc = _keys(rng, 3)
    lines = [f"{len(info)} 128"]
    for (x, y, s, o), d in zip(info, desc):
        lines.append(f"{y:.2f} {x:.2f} {s:.3f} {o:.3f}")
        lines.append(" ".join(f"{v}.0" for v in d))
    path = tmp_path / "float.key"
    path.write_text("\n".join(lines) + "\n")
    if native.available():
        with pytest.raises(ValueError):
            native.parse_key_bytes(path.read_bytes())
    ji, jd = J_keyfile.read_key_file(str(path))
    ti, td = T_keyfile.read_key_file(str(path))
    assert ti.shape == (3, 4) and td.shape == (3, 128)
    np.testing.assert_array_equal(ji, ti)
    np.testing.assert_array_equal(jd, td)
    np.testing.assert_array_equal(td, desc)


def _scenes(rng):
    """The same transforms and tracks in a scene of each package."""
    n = 4
    transforms, tracks = {}, []
    for i in range(n):
        for j in range(n):
            if i != j and rng.random() < 0.7:
                transforms[(i, j)] = dict(
                    fmatrix=rng.normal(size=(3, 3)) if rng.random() < 0.8
                    else None,
                    hmatrix=rng.normal(size=(3, 3)) if rng.random() < 0.5
                    else None,
                    num_inliers=int(rng.integers(0, 500)),
                    inlier_ratio=float(rng.random()))
    for _ in range(30):
        imgs = rng.choice(n, int(rng.integers(2, n + 1)), replace=False)
        tracks.append([(int(i), int(rng.integers(0, 100))) for i in imgs])
    out = []
    for S, cfg in ((J_scene, jax_config()), (T_scene, port_config())):
        entries = [J_listfile.ImageEntry(f"img{i}.jpg") for i in range(n)]
        sc = S.Scene(config=cfg, entries=entries, dims=[(640, 480)] * n,
                     key_xy=[np.zeros((100, 2))] * n)
        sc.transforms = {k: S.TransformInfo(**v) for k, v in transforms.items()}
        sc.tracks = tracks
        out.append(sc)
    return out


@pytest.mark.parametrize("name", ["pairwise_scores", "constraints"])
def test_constraint_files_identical(tmp_path, rng, name):
    js, ts = _scenes(rng)
    if name == "pairwise_scores":
        jw, tw = (J_constraints.write_pairwise_scores,
                  T_constraints.write_pairwise_scores)
    else:
        jw, tw = (J_constraints.write_geometric_constraints,
                  T_constraints.write_geometric_constraints)
    a, b = _write_both(tmp_path, name + ".txt", lambda p: jw(p, js),
                       lambda p: tw(p, ts))
    assert a == b and len(a) > 0


def _symmetric_one_to_one(rng):
    m = {}
    for (i, j), mm in _matches(rng).items():
        _, first = np.unique(mm[:, 1], return_index=True)
        mm = mm[np.sort(first)]
        _, first = np.unique(mm[:, 0], return_index=True)
        m[(i, j)] = mm[np.sort(first)]
        m[(j, i)] = m[(i, j)][:, ::-1].copy()
    return m


def test_track_tables_identical(rng):
    m = _symmetric_one_to_one(rng)
    jt = J_tracks.build_tracks(m, 4)
    tt = T_tracks.build_tracks(m, 4)
    assert jt == tt and len(jt) > 0
    assert J_tracks.tracks_to_image_tables(jt, 4) == \
        T_tracks.tracks_to_image_tables(tt, 4)


def test_native_tracks_identical(rng):
    """The port's loader of native/libbundler_native.so builds the JAX
    package's tracks exactly, and the same track sets as the Python BFS."""
    from bundler_sfm_tpu import native as J_native
    from bundler_sfm_tpu_torch import native
    assert native.available(), "native/libbundler_native.so does not load"
    m = _symmetric_one_to_one(rng)
    got = native.build_tracks_native(m, 4)
    assert got == J_native.build_tracks_native(m, 4) and len(got) > 0
    assert sorted(tuple(sorted(t)) for t in got) == \
        sorted(tuple(sorted(t)) for t in T_tracks.build_tracks(m, 4))


@pytest.mark.parametrize("tags", [
    {},
    {0x010F: "Canon", 0x0110: "Canon PowerShot S100", 0x920A: (5400, 1000)},
    {0xA405: 35},
])
def test_exif_focal_identical(tmp_path, tags):
    img = Image.new("RGB", (640, 480), (120, 60, 30))
    ex = Image.Exif()
    ifd = ex.get_ifd(0x8769)
    for k, v in tags.items():
        (ex if k in (0x010F, 0x0110) else ifd)[k] = v
    path = str(tmp_path / "x.jpg")
    img.save(path, exif=ex)
    a = J_exif.extract_focal_pixels(path)
    b = T_exif.extract_focal_pixels(path)
    assert a == b
    assert (a > 0) == bool(tags and (0x920A in tags or 0xA405 in tags))


def _bundle(M, rng):
    """A bundle of 5 images (image 2 unregistered) and 40 points with 0-4
    views each, as objects of module M."""
    cams = []
    for i in range(5):
        if i == 2:
            cams.append(M.BundleCamera(0.0, 0.0, 0.0, np.zeros((3, 3)),
                                       np.zeros(3)))
            continue
        cams.append(M.BundleCamera(float(rng.uniform(500, 900)),
                                   float(rng.normal() * 0.1),
                                   float(rng.normal() * 0.01),
                                   rng.normal(size=(3, 3)),
                                   rng.normal(size=3)))
    pts = []
    for _ in range(40):
        nv = int(rng.integers(0, 5))
        views = np.stack([rng.integers(0, 5, nv), rng.integers(0, 900, nv),
                          rng.uniform(-400, 400, nv),
                          rng.uniform(-300, 300, nv)], 1)
        pts.append(M.BundlePoint(rng.normal(size=3) * 10,
                                 rng.integers(0, 256, 3).astype(float), views))
    return M.BundleFile(cams, pts)


def test_bundle_file_identical(tmp_path):
    jb = _bundle(J_bundlefile, np.random.default_rng(5))
    tb = _bundle(T_bundlefile, np.random.default_rng(5))
    a, b = _write_both(tmp_path, "bundle.out",
                       lambda p: J_bundlefile.write_bundle_file(p, jb),
                       lambda p: T_bundlefile.write_bundle_file(p, tb))
    assert a == b and len(a) > 0
    back = T_bundlefile.read_bundle_file(str(tmp_path / "jax_bundle.out"))
    assert back.num_registered == jb.num_registered == 4
    assert len(back.points) == sum(len(p.views) > 0 for p in jb.points)


def test_points_ply_identical(tmp_path, rng):
    pts = rng.normal(size=(30, 3)) * 5
    colors = rng.integers(0, 256, (30, 3)).astype(float)
    colors[::7] = [0, 0, 255]                  # removed points are skipped
    Rs = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0]
                   for _ in range(3)])
    cs = rng.normal(size=(3, 3))
    a, b = _write_both(
        tmp_path, "points.ply",
        lambda p: J_plyfile.write_points_ply(p, pts, colors, Rs, cs),
        lambda p: T_plyfile.write_points_ply(p, pts, colors, Rs, cs))
    assert a == b and b"element vertex 31" in a


def test_io_package_exports_match_jax():
    """`bundler_sfm_tpu_torch.io` re-exports what `bundler_sfm_tpu.io` does
    (the bundle and PLY writers included), each from the port's copy."""
    import bundler_sfm_tpu.io as J_io
    import bundler_sfm_tpu_torch.io as T_io
    names = [n for n in vars(J_io) if not n.startswith("_")
             and not isinstance(getattr(J_io, n), type(J_io))]
    assert names and "write_bundle_file" in names
    for n in names:
        obj = getattr(T_io, n)
        assert obj.__module__.startswith("bundler_sfm_tpu_torch.io."), n
        assert obj.__name__ == getattr(J_io, n).__name__

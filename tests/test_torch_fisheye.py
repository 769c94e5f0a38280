"""The port's fisheye model (`ops/fisheye.py`), its `bundler --fisheye`
load and the `fisheyeundistort` tool against the JAX package's, on the CPU
in f64 — every case of tests/test_fisheye.py, mirrored.

Held: the point maps within 1e-9 px of the JAX package's (the round trip
within 1e-6 px, the centre a fixed point within 1e-9); the parameter file
parsed the same; the rectified keypoints `bundler --fisheye` loads within
1e-9 px of the JAX load; `undistort_image` equal to the JAX package's on
every pixel, or off by 1 on at most 1e-6 of the values (tan / arctan may
round differently by an ulp between XLA and torch; the count is in the
message); the fisheye end-to-end run registering every camera at the true
focal within 5 %.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundler_sfm_tpu import bundler as J_bundler
from bundler_sfm_tpu import fisheyeundistort as J_fu
from bundler_sfm_tpu.ops import fisheye as JF

from bundler_sfm_tpu_torch import bundler as T_bundler
from bundler_sfm_tpu_torch import fisheyeundistort as T_fu
from bundler_sfm_tpu_torch.io.keyfile import centered_to_image, write_key_file
from bundler_sfm_tpu_torch.ops import fisheye as TF


def t(x):
    return torch.from_numpy(np.array(x, np.float64))


@pytest.fixture
def params():
    # A slightly decentered fisheye circle (tests/test_fisheye.py).
    return dict(fCx=2.5, fCy=-1.5, fRad=300.0, fAngle=180.0, fFocal=280.0)


def test_distort_undistort_roundtrip(params, rng):
    jp, tp = JF.FisheyeParams(**params), TF.FisheyeParams(**params)
    ang = rng.uniform(0, 2 * np.pi, 50)
    r = rng.uniform(5, 250, 50)
    pts = np.stack([tp.fCx + r * np.cos(ang), tp.fCy + r * np.sin(ang)], 1)
    rect = TF.undistort_points(t(pts), tp).numpy()
    np.testing.assert_allclose(
        rect, np.asarray(JF.undistort_points(jnp.asarray(pts), jp)),
        rtol=0, atol=1e-9)
    back = TF.distort_points(t(rect), tp).numpy()
    np.testing.assert_allclose(
        back, np.asarray(JF.distort_points(jnp.asarray(rect), jp)),
        rtol=0, atol=1e-9)
    assert np.allclose(back, pts, atol=1e-6)


def test_center_is_fixed_point(params):
    tp = TF.FisheyeParams(**params)
    rect = TF.undistort_points(t([[tp.fCx, tp.fCy]]), tp).numpy()
    assert np.allclose(rect, 0.0, atol=1e-9)


def test_read_fisheye_file(tmp_path):
    f = tmp_path / "fisheye.txt"
    f.write_text("FisheyeCenter: 1.5 -0.5\nFisheyeRadius: 289.0\n"
                 "FisheyeAngle: 171.0\nFisheyeFocal: 260.0\n")
    p = TF.read_fisheye_file(str(f))
    assert p.fCx == 1.5 and p.fCy == -0.5
    assert p.fRad == 289.0 and p.fAngle == 171.0 and p.fFocal == 260.0
    assert vars(p) == vars(JF.read_fisheye_file(str(f)))


def _assert_images_match(got, want, what):
    """Equal on every value, or off by 1 on at most 1e-6 of them."""
    assert got.shape == want.shape and got.dtype == want.dtype
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    n_off = int((d > 0).sum())
    assert d.max() <= 1 and n_off <= 1e-6 * d.size, \
        f"{what}: {n_off} of {d.size} values differ (max {d.max()})"


@pytest.mark.parametrize("content", ["center_block", "random"])
def test_undistort_image_matches_jax(content, rng):
    p = dict(fCx=0.0, fCy=0.0, fRad=300.0, fAngle=180.0, fFocal=280.0)
    if content == "center_block":
        img = np.zeros((480, 640, 3), dtype=np.uint8)
        img[238:243, 318:323] = 200
    else:
        img = rng.integers(0, 256, (480, 640, 3)).astype(np.uint8)
    got = TF.undistort_image(img, TF.FisheyeParams(**p), device="cpu")
    _assert_images_match(got, JF.undistort_image(img, JF.FisheyeParams(**p)),
                         content)
    if content == "center_block":
        # The image centre is a fixed point of the resampling
        # (src/FisheyeUndistort.cpp:131-139 re-adds 0.5·w/h).
        assert got[240, 320, 0] > 150
    gray = TF.undistort_image(img[..., 0], TF.FisheyeParams(**p),
                              device="cpu")
    np.testing.assert_array_equal(gray, got[..., 0])


def test_fisheyeundistort_cli_matches_jax(tmp_path, monkeypatch, rng):
    from PIL import Image
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (60, 80, 3)).astype(np.uint8)
                        ).save(tmp_path / f"im{i}.jpg", quality=95)
    (tmp_path / "list.txt").write_text("im0.jpg\nim1.jpg\nmissing.jpg\n")
    (tmp_path / "fisheye.txt").write_text(
        "FisheyeCenter: 0 0\nFisheyeRadius: 60\nFisheyeAngle: 160\n"
        "FisheyeFocal: 50\n")
    monkeypatch.chdir(tmp_path)
    assert J_fu.main(["list.txt", "fisheye.txt", "j"]) == 0
    assert T_fu.main(["list.txt", "fisheye.txt", "t", "--device",
                      "cpu"]) == 0
    assert sorted(os.listdir("t")) == sorted(os.listdir("j")) == \
        ["im0.fd.jpg", "im1.fd.jpg"]
    for name in os.listdir("j"):
        with Image.open(os.path.join("t", name)) as a, \
                Image.open(os.path.join("j", name)) as b:
            _assert_images_match(np.asarray(a), np.asarray(b), name)


def _fisheye_scene(rng, d):
    """tests/test_fisheye.py's end-to-end inputs: rectilinear observations
    pushed through the fisheye model, written as .key files, list.txt with
    fisheye flags, fisheye.txt and a match table."""
    from PIL import Image
    from tests.synthetic import Scene as SynScene
    f = 700.0
    W, H = 1024, 768
    p = TF.FisheyeParams(fCx=0.0, fCy=0.0, fRad=480.0, fAngle=160.0,
                         fFocal=420.0)
    syn = SynScene(rng, num_cams=4, num_pts=160, f=f, noise=0.2)
    keymap = []
    for c in range(4):
        xy = syn.obs[c]
        inside = (np.abs(xy[:, 0]) < W / 2 - 40) & \
            (np.abs(xy[:, 1]) < H / 2 - 40)
        fish = TF.distort_points(t(xy[inside]), p).numpy()
        info = np.zeros((len(fish), 4))
        info[:, 0:2] = centered_to_image(fish, W, H)
        info[:, 2] = 2.0
        Image.new("L", (W, H), 128).save(str(d / f"img{c:02d}.jpg"))
        write_key_file(str(d / f"img{c:02d}.key"), info,
                       np.zeros((len(fish), 128), np.uint8))
        keymap.append({int(pt): k for k, pt in
                       enumerate(np.nonzero(inside)[0])})
    (d / "list.txt").write_text(
        "".join(f"img{c:02d}.jpg 1 {f:.2f}\n" for c in range(4)))
    (d / "fisheye.txt").write_text(
        f"FisheyeCenter: {p.fCx} {p.fCy}\nFisheyeRadius: {p.fRad}\n"
        f"FisheyeAngle: {p.fAngle}\nFisheyeFocal: {p.fFocal}\n")
    lines = []
    for i in range(4):
        for j in range(i + 1, 4):
            shared = [q for q in keymap[i] if q in keymap[j]]
            lines.append(f"{i} {j}\n{len(shared)}\n" + "".join(
                f"{keymap[i][q]} {keymap[j][q]}\n" for q in shared))
    (d / "matches.init.txt").write_text("".join(lines))
    return f


ARGV = ["list.txt", "--run_bundle", "--fisheye", "fisheye.txt",
        "--match_table", "matches.init.txt", "--output_dir", "out",
        "--output", "bundle.out", "--variable_focal_length",
        "--use_focal_estimate", "--constrain_focal",
        "--constrain_focal_weight", "0.0001"]


def test_fisheye_keys_rectified_like_jax(rng, tmp_path, monkeypatch):
    _fisheye_scene(rng, tmp_path)
    monkeypatch.chdir(tmp_path)
    js = J_bundler.scene_from_args(J_bundler.parse_with_options_file(ARGV))
    ts = T_bundler.scene_from_args(T_bundler.parse_with_options_file(
        ARGV + ["--device", "cpu"]))
    assert ts.config.fisheye and js.config.fisheye
    for a, b in zip(ts.key_xy, js.key_xy):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    # Entries not flagged fisheye are loaded as they are.
    (tmp_path / "list.txt").write_text(
        "".join(f"img{c:02d}.jpg 0 700.00\n" for c in range(4)))
    plain = T_bundler.scene_from_args(T_bundler.parse_with_options_file(
        ARGV + ["--device", "cpu"]))
    assert np.abs(plain.key_xy[0] - ts.key_xy[0]).max() > 1.0


def test_fisheye_bundler_cli_e2e(rng, tmp_path, monkeypatch):
    """The port's bundler with --fisheye registers every camera at the true
    focal (tests/test_fisheye.py's end-to-end bounds)."""
    from bundler_sfm_tpu_torch.io.bundlefile import read_bundle_file
    f = _fisheye_scene(rng, tmp_path)
    monkeypatch.chdir(tmp_path)
    assert T_bundler.main(ARGV + ["--device", "cpu"]) == 0
    b = read_bundle_file(str(tmp_path / "out" / "bundle.out"))
    assert b.num_registered == 4
    for c in b.cameras:
        if c.registered:
            assert c.f == pytest.approx(f, rel=0.05)

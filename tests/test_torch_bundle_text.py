"""The native text of `bundle.out` and of the points PLY
(`csrc/bundle_text.cc` through `io/bundle_text.py`) byte for byte against
the JAX package's writers: ragged bundles with unregistered cameras and
every awkward double, the PLY, a reconstruction's round outputs and final
`bundle.out`; a failed build raising; non-finite colours raising as the
JAX writers do; arrays that disagree refused."""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import types

import numpy as np
import pytest

from bundler_sfm_tpu.io import bundlefile as J_bundlefile
from bundler_sfm_tpu.io import plyfile as J_plyfile
from bundler_sfm_tpu.pipeline import incremental as J_inc
from bundler_sfm_tpu_torch.io import bundle_text
from bundler_sfm_tpu_torch.io import bundlefile as T_bundlefile
from bundler_sfm_tpu_torch.io import plyfile as T_plyfile
from bundler_sfm_tpu_torch.pipeline import incremental as inc

# Doubles whose text is easy to get wrong: signed zeros and NaNs,
# infinities, subnormals, 3-digit exponents, halves, values that round up
# at the 4th decimal or the 10th digit, the largest double.
SPECIAL = np.array([
    0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 5e-324, -2.5e-310,
    2.2250738585072014e-308, 1e300, -1e-300, 1.7976931348623157e308,
    0.5, -0.5, 2.5, 0.00005, -0.00005, 0.99999999999, 9.99999999995e99,
    123456.78905, 1e16, 255.0])
# Colours: finite, at x.5 both ways, signed zero, huge and subnormal.
COLOURS = np.array([0.0, -0.0, 0.5, 1.5, 2.5, -0.5, -1.5, 254.5, 255.0,
                    127.49999999999999, 1e300, -1e300, 5e-324, 17.3,
                    2.0 ** 62, 3.0e18, 9.3e18])


def _pick(rng, base):
    """`base` with about a third of its entries replaced by SPECIAL ones."""
    out = np.array(base, dtype=np.float64)
    hit = rng.random(out.shape) < 0.35
    out[hit] = rng.choice(SPECIAL, int(hit.sum()))
    return out


def _bundle(M, rng):
    cams = []
    for i in range(9):
        if i % 4 == 2:
            cams.append(M.BundleCamera(0.0, 0.0, 0.0, np.zeros((3, 3)),
                                       np.zeros(3)))
            continue
        cams.append(M.BundleCamera(
            float(_pick(rng, [rng.uniform(100, 3000)])[0]),
            float(_pick(rng, [rng.normal() * 0.1])[0]),
            float(rng.normal() * 1e-3),
            _pick(rng, rng.normal(size=(3, 3))),
            _pick(rng, rng.normal(size=3) * 10.0 ** rng.integers(-5, 5))))
    # f = ±0 makes a camera unregistered whatever else it holds; k = 0
    # does not.
    for f, k in ((0.0, 0.3), (-0.0, -0.2), (700.0, 0.0)):
        cams.append(M.BundleCamera(f, k, k, rng.normal(size=(3, 3)),
                                   rng.normal(size=3)))
    pts = []
    for _ in range(160):
        nv = int(rng.integers(0, 41)) if rng.random() < 0.3 else \
            int(rng.integers(0, 4))
        views = np.stack([rng.integers(0, 12, nv), rng.integers(0, 90000, nv),
                          _pick(rng, rng.uniform(-600, 600, nv)),
                          _pick(rng, rng.uniform(-400, 400, nv))], 1)
        pos = _pick(rng, rng.normal(size=3)
                    * 10.0 ** rng.integers(-320, 300, 3))
        pts.append(M.BundlePoint(pos, rng.choice(COLOURS, 3), views))
    pts.append(M.BundlePoint(np.array([-0.0, -np.nan, 5e-324]),
                             np.array([2.5, -0.0, 1e300]),
                             np.array([[0, 7, np.inf, -np.inf],
                                       [3, 8, -0.00004, 1e300]])))
    return M.BundleFile(cams, pts)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bundle_text_equals_jax_writer(tmp_path, seed):
    tb = _bundle(T_bundlefile, np.random.default_rng(seed))
    jb = _bundle(J_bundlefile, np.random.default_rng(seed))
    T_bundlefile.write_bundle_file(str(tmp_path / "native.out"), tb)
    T_bundlefile.write_bundle_file(str(tmp_path / "arrays.out"),
                                   T_bundlefile.bundle_arrays(tb))
    J_bundlefile.write_bundle_file(str(tmp_path / "jax.out"), jb)
    want = (tmp_path / "jax.out").read_bytes()
    for name in ("native.out", "arrays.out"):
        assert (tmp_path / name).read_bytes() == want, name
    text = want.decode()
    for s in ("nan", "inf", "-inf", "e+300", "e-324", "-0.0000000000e+00"):
        assert s in text
    assert "-nan" not in text


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_points_ply_equals_jax_writer(tmp_path, seed):
    rng = np.random.default_rng(seed)
    n = 400
    pts = _pick(rng, rng.normal(size=(n, 3))
                * 10.0 ** rng.integers(-320, 300, (n, 1)))
    colors = rng.choice(COLOURS, (n, 3))
    colors[::9] = [0, 0, 255]                  # removed points are skipped
    colors[1::9] = [-0.0, 0.0, 255.0]
    Rs = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0]
                   for _ in range(5)])
    cs = rng.normal(size=(5, 3)) * 100
    T_plyfile.write_points_ply(str(tmp_path / "native.ply"), pts, colors, Rs,
                               cs)
    T_plyfile.write_points_ply(str(tmp_path / "nocams.ply"), pts, colors)
    J_plyfile.write_points_ply(str(tmp_path / "jax.ply"), pts, colors, Rs, cs)
    J_plyfile.write_points_ply(str(tmp_path / "jaxnocams.ply"), pts, colors)
    want = (tmp_path / "jax.ply").read_bytes()
    assert (tmp_path / "native.ply").read_bytes() == want
    assert (tmp_path / "nocams.ply").read_bytes() == \
        (tmp_path / "jaxnocams.ply").read_bytes()
    kept = ~((colors[:, 0] == 0) & (colors[:, 1] == 0) & (colors[:, 2] == 255))
    assert f"element vertex {kept.sum() + 10}\n".encode() in want


def _reconstruction(rng):
    """A small stage-5 state: 8 images, 5 registered, tracks of 0-5 views
    (0: emptied by pruning), colours at halves and pruned blue."""
    n_img, order = 8, [3, 0, 6, 1, 5]
    key_xy = [rng.uniform(-500, 500, (int(rng.integers(50, 300)), 2))
              for _ in range(n_img)]
    recon = inc.Reconstruction(
        added_order=order,
        cam_R=[np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in order],
        cam_params=[np.concatenate([rng.normal(size=3), np.zeros(3),
                                    [rng.uniform(400, 900)],
                                    rng.normal(size=2) * 0.01])
                    for _ in order],
        points=[], colors=[], pt_views=[], track_extra=np.zeros(0),
        key_extra=[{} for _ in range(n_img)])
    for p in range(300):
        nv = [0, 2, 3, int(rng.integers(2, 6)), 5][p % 5]
        slots = rng.choice(len(order), nv, replace=False)
        views = [(int(s), int(rng.integers(0, len(key_xy[order[s]]))))
                 for s in slots] if nv else []
        recon.pt_views.append(views)
        recon.points.append(rng.normal(size=3) * 5)
        recon.colors.append(rng.choice(COLOURS[:10], 3) if p % 7 else
                            np.array([0.0, 0.0, 255.0]))
    cfg = types.SimpleNamespace(output_all=True, bundle_output_base="bundle_")
    scene = types.SimpleNamespace(config=cfg, num_images=n_img, key_xy=key_xy)
    return recon, scene


def _outputs(M, recon, scene, out):
    """Two rounds of outputs and the final bundle.out, as M's
    bundle_adjust_fast writes them; returns {file name: bytes}."""
    out.mkdir()
    M.dump_round(recon, scene, str(out), 4)
    M.dump_round(recon, scene, str(out), 5)
    final = (M.to_bundle_arrays(recon, scene) if M is inc
             else M.to_bundle_file(recon, scene))
    M.write_bundle_file(str(out / "bundle.out"), final)
    return {p.name: p.read_bytes() for p in sorted(out.iterdir())}


def test_round_outputs_equal_jax(tmp_path):
    recon, scene = _reconstruction(np.random.default_rng(7))
    files = _outputs(inc, recon, scene, tmp_path / "native")
    assert sorted(files) == ["bundle.out", "bundle_004.out",
                             "bundle_005.out", "points004.ply",
                             "points005.ply"]
    assert files == _outputs(J_inc, recon, scene, tmp_path / "jax")
    assert files["bundle.out"].decode().split("\n")[1] == "8 240"


def test_failed_build_raises(tmp_path, monkeypatch):
    def broken(source, *a, **kw):
        raise RuntimeError(f"c++ failed (1): {source}")
    monkeypatch.setattr(bundle_text, "_lib", None)
    monkeypatch.setattr(bundle_text, "build", broken)
    tb = _bundle(T_bundlefile, np.random.default_rng(11))
    with pytest.raises(RuntimeError, match="bundle_text.cc"):
        T_bundlefile.write_bundle_file(str(tmp_path / "b.out"), tb)
    with pytest.raises(RuntimeError, match="bundle_text.cc"):
        T_plyfile.write_points_ply(str(tmp_path / "p.ply"), np.ones((3, 3)),
                                   np.ones((3, 3)))


@pytest.mark.parametrize("bad,error", [(np.nan, ValueError),
                                       (np.inf, OverflowError)])
def test_non_finite_colour_raises_as_before(tmp_path, bad, error):
    for M in (T_bundlefile, J_bundlefile):
        b = _bundle(M, np.random.default_rng(3))
        b.points[0].color = np.array([1.0, bad, 2.0])
        b.points[0].views = np.array([[0, 1, 2.0, 3.0]])
        with pytest.raises(error):
            M.write_bundle_file(str(tmp_path / "b.out"), b)
        # A point without views is not written, so its colour is not read.
        b.points[0].views = np.zeros((0, 4))
        M.write_bundle_file(str(tmp_path / f"{M.__name__}.out"), b)
    assert (tmp_path / f"{T_bundlefile.__name__}.out").read_bytes() == \
        (tmp_path / f"{J_bundlefile.__name__}.out").read_bytes()
    for M in (T_plyfile, J_plyfile):
        with pytest.raises(error):
            M.write_points_ply(str(tmp_path / "p.ply"), np.ones((2, 3)),
                               np.array([[1.0, 2.0, 3.0], [bad, 0, 0]]))


def test_arrays_that_disagree_are_refused(tmp_path):
    cams = np.zeros((2, 15))
    with open(tmp_path / "b.out", "w") as f, pytest.raises(ValueError):
        bundle_text.write_bundle(f, cams, np.zeros((2, 3)), np.zeros((2, 3)),
                                 [1, 2], np.zeros((2, 2)), np.zeros((2, 2)))
    with open(tmp_path / "p.ply", "w") as f, pytest.raises(ValueError):
        bundle_text.write_ply(f, np.zeros((2, 3)), np.zeros((3, 3)))

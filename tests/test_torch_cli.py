"""The port's command-line tools against the JAX package's, on the CPU:
`bundler`'s option table and --options_file expansion, `keymatch` and
`keymatchsingle` outputs, `creatematchscript`, `io/intrinsics` and the
`export/process` bundle-surgery operations (also through `bundler --bundle`
surgery mode, --estimate_up_vector_szeliski, --output_relposes and
--optimize_for_fisheye included).  Files are held byte-identical;
--num_devices other than 1 parses, and on a host without a card `main`
stops where it would start the ranks on CUDA."""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import io
import os

import numpy as np
import pytest

from bundler_sfm_tpu import bundler as J_bundler
from bundler_sfm_tpu import creatematchscript as J_cms
from bundler_sfm_tpu import keymatch as J_keymatch
from bundler_sfm_tpu import keymatchsingle as J_kms
from bundler_sfm_tpu.export import process as J_proc
from bundler_sfm_tpu.io import bundlefile as J_bf
from bundler_sfm_tpu.io import intrinsics as J_intr

from bundler_sfm_tpu_torch import bundler as T_bundler
from bundler_sfm_tpu_torch import creatematchscript as T_cms
from bundler_sfm_tpu_torch import keymatch as T_keymatch
from bundler_sfm_tpu_torch import keymatchsingle as T_kms
from bundler_sfm_tpu_torch.export import process as T_proc
from bundler_sfm_tpu_torch.io import bundlefile as T_bf
from bundler_sfm_tpu_torch.io import intrinsics as T_intr
from bundler_sfm_tpu_torch.io.keyfile import write_key_file


MULTIHOST = ("multihost_coordinator", "num_processes", "process_id")


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_option_table_matches_jax():
    jax_opts = _actions(J_bundler.build_parser())
    port_opts = _actions(T_bundler.build_parser())
    assert set(port_opts) == set(jax_opts) | {"device"} | set(MULTIHOST)
    for dest, ja in jax_opts.items():
        ta = port_opts[dest]
        for attr in ("option_strings", "default", "type", "nargs", "const",
                     "required"):
            assert getattr(ta, attr) == getattr(ja, attr), (dest, attr)
        assert type(ta) is type(ja), dest
    dev = port_opts["device"]
    assert dev.option_strings == ["--device"] and dev.default == "cuda"
    # run_bundler's multihost options, with the same table entries.
    from bundler_sfm_tpu_torch import run_bundler as T_rb
    rb_opts = _actions(T_rb.build_parser())
    for dest in MULTIHOST:
        for attr in ("option_strings", "default", "type"):
            assert getattr(port_opts[dest], attr) == \
                getattr(rb_opts[dest], attr), (dest, attr)


def test_options_file_recursion(tmp_path):
    inner = tmp_path / "inner.txt"
    inner.write_text("fmatrix_rounds 512\nestimate_distortion\n"
                     "# a comment\n\nup_image 2\n")
    outer = tmp_path / "options.txt"
    outer.write_text(f"--match_table matches.init.txt\noutput bundle.out\n"
                     f"variable_focal_length\nconstrain_focal_weight 0.0001\n"
                     f"options_file {inner}\nrun_bundle\n")
    argv = ["list.txt", "--options_file", str(outer), "--seed", "3"]
    j = vars(J_bundler.parse_with_options_file(argv))
    t = vars(T_bundler.parse_with_options_file(argv))
    assert t.pop("device") == "cuda"
    assert [t.pop(k) for k in MULTIHOST] == [None, None, None]
    assert t == j
    assert t["fmatrix_rounds"] == 512 and t["up_image"] == 2
    assert t["run_bundle"] and t["estimate_distortion"]


@pytest.mark.parametrize("argv,module", [
    (["--num_devices", "4"], "multi-device"),
    (["--num_devices", "0"], "multi-device"),
])
def test_unported_options_exit_nonzero(argv, module, tmp_path, capsys):
    """The multi-device options parse (no exit at parse time); with no
    process group `main` would start the ranks on CUDA, which this host
    lacks, so it raises there."""
    opts = tmp_path / "options.txt"
    opts.write_text(" ".join(argv) + "\n")
    for args in (["list.txt"] + argv,
                 ["list.txt", "--options_file", str(opts)]):
        assert T_bundler.parse_with_options_file(args).num_devices == \
            int(argv[1])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T_bundler.main(args)
        assert module not in capsys.readouterr().err


def _write_keys(root, n_images=6, n_keys=300, seed=0):
    """Seeded key files: shared descriptor clusters with per-view jitter,
    so pairs pass the ratio test (one image without keys)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n_keys, 128))
    paths = []
    for i in range(n_images):
        n = 0 if i == 3 else n_keys - 7 * i
        desc = np.clip(base[:n] + rng.integers(-9, 10, (n, 128)), 0, 255
                       ).astype(np.uint8)[rng.permutation(n)]
        info = np.stack([rng.uniform(0, 640, n), rng.uniform(0, 480, n),
                         rng.uniform(1, 4, n), rng.uniform(-3, 3, n)], 1)
        path = os.path.join(root, f"img{i}.key")
        write_key_file(path, info, desc)
        paths.append(path)
    return paths


@pytest.mark.parametrize("window", [None, 2], ids=["all_pairs", "window2"])
def test_keymatch_main_identical(tmp_path, window):
    keys = _write_keys(str(tmp_path))
    lst = tmp_path / "list_keys.txt"
    lst.write_text("".join(k + "\n" for k in keys))
    extra = [] if window is None else [str(window)]
    assert J_keymatch.main([str(lst), str(tmp_path / "j.txt")] + extra) == 0
    assert T_keymatch.main([str(lst), str(tmp_path / "t.txt")] + extra
                           + ["--device", "cpu"]) == 0
    want = (tmp_path / "j.txt").read_bytes()
    assert (tmp_path / "t.txt").read_bytes() == want
    pairs = want.decode().split("\n")
    assert want.count(b"\n") > 500 and "0 1" in pairs
    assert ("0 5" in pairs) == (window is None)


def test_keymatchsingle_identical(tmp_path):
    keys = _write_keys(str(tmp_path), n_images=2)
    assert J_kms.main([keys[0], keys[1], str(tmp_path / "j.txt")]) == 0
    assert T_kms.main([keys[0], keys[1], str(tmp_path / "t.txt"),
                       "--device", "cpu"]) == 0
    want = (tmp_path / "j.txt").read_bytes()
    assert (tmp_path / "t.txt").read_bytes() == want and len(want) > 1000


@pytest.mark.parametrize("dirs", [(None, None), ("keys", "matches")])
def test_creatematchscript_identical(dirs):
    names = ["a.jpg\n", "b.jpg 0 700\n", "\n", "c.JPG\n", "d.jpg\n"]
    out = []
    for mod in (J_cms, T_cms):
        buf = io.StringIO()
        mod.create_match_script(names, *dirs, keymatch_cmd="KeyMatch",
                                out=buf)
        out.append(buf.getvalue())
    assert out[0] == out[1] and out[0].count("\n") == 6


def test_intrinsics_identical(tmp_path):
    path = tmp_path / "intrinsics.txt"
    path.write_text("2\n700 0 512 0 702 384 0 0 1\n-0.1 0.01 0 0 0\n"
                    "1400 0 512 0 1390 384 0 0 1\n0 0 0.001 0 0\n")
    j = J_intr.read_intrinsics_file(str(path))
    t = T_intr.read_intrinsics_file(str(path))
    assert len(t) == len(j) == 2
    for a, b in zip(j, t):
        assert np.array_equal(a.K, b.K) and np.array_equal(a.k, b.k)
    focals = [0.0, 650.0, 1200.0, 1e5]
    ja, ta = (m.assign_intrinsics(r, focals)
              for m, r in ((J_intr, j), (T_intr, t)))
    assert [None if r is None else r.focal for r in ta] == \
        [None if r is None else r.focal for r in ja] == [None, 701, 1395, 1395]


def _toy_bundle(mod, num_cams=4, num_pts=40, seed=0):
    """A bundle of `mod`'s classes: num_cams cameras (one unregistered)
    viewing random points, plus one point seen once (pruned)."""
    rng = np.random.default_rng(seed)
    cams, pts = [], []
    centers = rng.normal(size=(num_cams, 3))
    for i in range(num_cams):
        a = rng.normal(size=3) * 0.2
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        R = np.eye(3) + np.sin(0.3) * K + (1 - np.cos(0.3)) * K @ K
        R, _ = np.linalg.qr(R)
        R = R * np.sign(np.linalg.det(R))
        if i == 2:
            cams.append(mod.BundleCamera(f=0.0, k1=0.0, k2=0.0,
                                         R=np.zeros((3, 3)), t=np.zeros(3)))
        else:
            cams.append(mod.BundleCamera(f=700.0 + 10 * i, k1=-0.01 * i,
                                         k2=0.001, R=R, t=-R @ centers[i]))
    for p in range(num_pts):
        X = rng.normal(size=3) + [0, 0, 8]
        seen = [0, 1, 3] if p else [1]
        views = np.array([[c, p, *rng.uniform(-300, 300, 2)] for c in seen])
        pts.append(mod.BundlePoint(pos=X, color=rng.integers(0, 256, 3)
                                   .astype(float), views=views))
    return mod.BundleFile(cameras=cams, points=pts)


OPS = {
    "scale_focal": lambda P, b: P.scale_focal_lengths(b, 1.5),
    "scale_focal_per_image": lambda P, b: P.scale_focal_lengths(
        b, np.array([1.0, 2.0, 3.0, 0.5])),
    "zero_distortion": lambda P, b: P.zero_distortion_params(b),
    "prune_bad_points": lambda P, b: P.prune_bad_points(b),
    "rotate_cameras_roll": lambda P, b: P.rotate_cameras_roll(
        b, [0.0, 90.0, 10.0, -45.5]),
    "rotate_cameras": lambda P, b: P.rotate_cameras(
        b, np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])),
    "reposition_scene": lambda P, b: P.reposition_scene(b),
    "transform_scene_canonical": lambda P, b: P.transform_scene_canonical(b),
    "compress": lambda P, b: P.compress(b, ["a", "b", "c", "d"])[0],
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_process_op_bundle_identical(op, tmp_path):
    out = []
    for P, B, name in ((J_proc, J_bf, "j.out"), (T_proc, T_bf, "t.out")):
        B.write_bundle_file(str(tmp_path / name), OPS[op](P, _toy_bundle(B)))
        out.append((tmp_path / name).read_bytes())
    assert out[0] == out[1] and len(out[0]) > 1000


def test_bundler_surgery_mode_identical(tmp_path, monkeypatch):
    """`bundler --bundle ... --scale_focal --prune_bad_points
    --zero_distortion_params --rotate_cameras --reposition_scene
    --compress_list --write_tracks` in both packages: every file written is
    byte-identical."""
    J_bf.write_bundle_file(str(tmp_path / "in.out"), _toy_bundle(J_bf))
    (tmp_path / "list.txt").write_text("".join(f"img{i}.jpg\n"
                                               for i in range(4)))
    (tmp_path / "rot.txt").write_text("img0.jpg 0\nimg1.jpg 30\nimg2.jpg 0\n"
                                      "img3.jpg -12.5\n")
    argv = ["list.txt", "--bundle", "in.out", "--scale_focal", "1.25",
            "--prune_bad_points", "--zero_distortion_params",
            "--rotate_cameras", "rot.txt", "--reposition_scene",
            "--compress_list", "--write_tracks", "tracks.txt"]
    monkeypatch.chdir(tmp_path)
    for main, out in ((J_bundler.main, "j"), (T_bundler.main, "t")):
        dev = [] if out == "j" else ["--device", "cpu"]
        assert main(argv + ["--output_dir", out] + dev) == 0
        os.replace("tracks.txt", os.path.join(out, "tracks.txt"))
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 6
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes(), n


@pytest.mark.parametrize("extra", [
    ["--estimate_up_vector_szeliski"],
    ["--estimate_up_vector_szeliski", "--up_image", "1"],
    ["--output_relposes", "relposes.txt"],
    ["--optimize_for_fisheye", "--reposition_scene"],
], ids=["up_vector", "up_vector_up_image", "output_relposes",
        "optimize_for_fisheye"])
def test_bundler_surgery_options_identical(extra, tmp_path, monkeypatch):
    """`bundler --bundle in.out` with the options the JAX package runs in
    surgery mode: both exit 0 and write byte-identical
    bundle.processed.out (and nothing else)."""
    J_bf.write_bundle_file(str(tmp_path / "in.out"), _toy_bundle(J_bf))
    (tmp_path / "list.txt").write_text("".join(f"img{i}.jpg\n"
                                               for i in range(4)))
    monkeypatch.chdir(tmp_path)
    argv = ["list.txt", "--bundle", "in.out"] + extra
    assert J_bundler.main(argv + ["--output_dir", "j"]) == 0
    assert T_bundler.main(argv + ["--output_dir", "t", "--device", "cpu"]) == 0
    assert os.listdir("j") == os.listdir("t") == ["bundle.processed.out"]
    want = (tmp_path / "j" / "bundle.processed.out").read_bytes()
    assert (tmp_path / "t" / "bundle.processed.out").read_bytes() == want
    changed = want != (tmp_path / "in.out").read_bytes()
    assert changed == (extra[0] != "--output_relposes")


def test_estimate_up_vector_keeps_failure_modes(tmp_path, monkeypatch):
    """An --up_image past the cameras raises in both packages, and the port
    carries --optimize_for_fisheye into its config as the JAX package does
    (nothing reads it); with no --bundle and no --run_bundle both exit 0."""
    J_bf.write_bundle_file(str(tmp_path / "in.out"), _toy_bundle(J_bf))
    (tmp_path / "list.txt").write_text("img0.jpg\n")
    monkeypatch.chdir(tmp_path)
    argv = ["list.txt", "--bundle", "in.out", "--estimate_up_vector_szeliski",
            "--up_image", "9"]
    for main, dev in ((J_bundler.main, []), (T_bundler.main, ["--device",
                                                              "cpu"])):
        with pytest.raises(IndexError):
            main(argv + dev)
        assert main(["list.txt", "--optimize_for_fisheye"] + dev) == 0
    args = T_bundler.parse_with_options_file(
        ["list.txt", "--optimize_for_fisheye", "--device", "cpu"])
    assert T_bundler.scene_from_args(args).config.optimize_for_fisheye

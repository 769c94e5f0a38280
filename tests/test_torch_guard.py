"""The PyTorch port stands alone: no JAX, no import of the JAX package, and
its entry points run on the card unless asked for the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "bundler_sfm_tpu_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden(mod: str) -> bool:
    root = mod.split(".")[0]
    return root == "jax" or root == "jaxlib" or root == "bundler_sfm_tpu"


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_out():
    mods = ["bundler_sfm_tpu_torch." + m for m in (
        "run_bundler", "convert", "native", "features.sift", "ops.matching",
        "ops.matching_cuda", "ops.matching_variants", "ops.fmatrix",
        "ops.homography", "probes.probe_two_nn_variants",
        "pipeline.verify", "pipeline.tracks", "io.constraints", "io.exif",
        "utils.render_scene", "ops.ba", "ops.lm", "ops.fivepoint",
        "ops.resection", "ops.triangulate", "ops.essential",
        "pipeline.incremental", "io.bundlefile", "io.plyfile", "bundler",
        "keymatch", "keymatchsingle", "creatematchscript", "io.intrinsics",
        "export.process", "export.scene_geometry", "pipeline.resume",
        "pipeline.register", "pipeline.two_frame", "ops.fisheye",
        "ops.homography_decompose", "ops.resample", "export.undistort",
        "export.pmvs", "export.vis", "radialundistort", "fisheyeundistort",
        "bundle2pmvs", "bundle2vis", "bundle2ply", "models", "models.camera",
        "models.snavely", "models.fisheye", "ops.plane", "ops.horn",
        "io.xmlfile", "parallel.mesh", "parallel.ba_sharded",
        "parallel.matching_sharded", "bench", "probes.e2e_synthetic",
        "probes.e2e_pixels", "probes.scaling", "probes.scaling_mesh_cpu")]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'bundler_sfm_tpu')]\n"
              "assert not bad, bad\n"
              "import torch\n"
              "assert not torch.backends.cuda.matmul.allow_tf32\n"
              "assert not torch.backends.cudnn.allow_tf32\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def _entry_points(tmp_path):
    from bundler_sfm_tpu_torch import (
        bundler, fisheyeundistort, keymatch, radialundistort, run_bundler,
    )
    from bundler_sfm_tpu_torch.export.undistort import undistort_image
    from bundler_sfm_tpu_torch.ops.fisheye import FisheyeParams
    from bundler_sfm_tpu_torch.ops.fisheye import (
        undistort_image as fisheye_undistort_image,
    )
    from bundler_sfm_tpu_torch.pipeline.two_frame import scene_covariance
    from bundler_sfm_tpu_torch.config import BundlerConfig
    from bundler_sfm_tpu_torch.convert import (
        ba_problem_from_numpy, scene_from_numpy,
    )
    from bundler_sfm_tpu_torch.features.sift import extract_sift_batch
    from bundler_sfm_tpu_torch.io.bundlefile import BundleFile
    from bundler_sfm_tpu_torch.io.listfile import ImageEntry
    from bundler_sfm_tpu_torch.ops.matching import DescriptorTable, match_pair
    from bundler_sfm_tpu_torch.pipeline.incremental import bundle_adjust_fast
    from bundler_sfm_tpu_torch.pipeline.register import register_image
    from bundler_sfm_tpu_torch.pipeline.scene import Scene
    from bundler_sfm_tpu_torch.probes import (
        e2e_pixels, probe_two_nn_variants, scaling,
    )
    from bundler_sfm_tpu_torch.ops.matching import match_pairs_batched
    from bundler_sfm_tpu_torch.ops.plane import knn_plane_normals
    from bundler_sfm_tpu_torch.ops.horn import estimate_similarity_ransac
    from bundler_sfm_tpu_torch.export import scene_geometry
    from bundler_sfm_tpu_torch.parallel.mesh import (
        initialize_multihost, launch, make_mesh,
    )
    d = np.zeros((4, 128), np.uint8)
    img = np.zeros((64, 64), np.float32)
    from PIL import Image
    Image.fromarray(img.astype(np.uint8)).save(tmp_path / "a.jpg")
    (tmp_path / "list.txt").write_text("a.jpg\na.jpg\n")
    return {
        "DescriptorTable": lambda: DescriptorTable([d, d]),
        "match_pair": lambda: match_pair(d, d),
        "extract_sift_batch": lambda: extract_sift_batch([img]),
        "scene_from_numpy": lambda: scene_from_numpy(
            [ImageEntry("a.jpg")], [(64, 64)], [np.zeros((0, 2))], {},
            BundlerConfig()),
        "run_bundler": lambda: run_bundler.main([str(tmp_path)]),
        "probe_two_nn_variants": lambda: probe_two_nn_variants.main(["4",
                                                                     "256"]),
        "ba_problem_from_numpy": lambda: ba_problem_from_numpy(
            np.eye(3)[None], np.zeros((1, 9)), np.zeros((1, 3)), [0], [0],
            np.zeros((1, 2))),
        "bundle_adjust_fast": lambda: bundle_adjust_fast(Scene(
            config=BundlerConfig(), entries=[ImageEntry("a.jpg")] * 2,
            dims=[(64, 64)] * 2, key_xy=[np.zeros((0, 2))] * 2)),
        "keymatch.match_full": lambda: keymatch.match_full(["a.key",
                                                            "b.key"]),
        "bundler.main": lambda: bundler.main(["list.txt", "--run_bundle"]),
        "register_image": lambda: register_image(
            BundleFile(cameras=[], points=[]), d, d, np.zeros((4, 2))),
        "radialundistort": lambda: radialundistort.main(
            ["list.txt", "bundle.out", "rd"]),
        "fisheyeundistort": lambda: fisheyeundistort.main(
            ["list.txt", "fisheye.txt", "fd"]),
        "bundler --compute_covariance": lambda: bundler.main(
            ["list.txt", "--bundle", "bundle.out", "--compute_covariance"]),
        "bundler --fisheye": lambda: bundler.main(
            ["list.txt", "--run_bundle", "--fisheye", "fisheye.txt"]),
        "scene_covariance": lambda: scene_covariance(
            BundleFile(cameras=[], points=[])),
        "undistort_image": lambda: undistort_image(img[..., None], 1.0, 0.0,
                                                   0.0),
        "fisheye.undistort_image": lambda: fisheye_undistort_image(
            img, FisheyeParams(0.0, 0.0, 1.0, 90.0, 1.0)),
        "match_pairs_batched": lambda: match_pairs_batched([d, d], [(0, 1)]),
        "knn_plane_normals": lambda: knn_plane_normals(np.eye(3),
                                                       np.ones(3), k=2),
        "fit_plane_to_points": lambda: scene_geometry.fit_plane_to_points(
            np.eye(3)),
        "setup_scene_ground_plane": lambda:
            scene_geometry.setup_scene_ground_plane(_three_cameras()),
        "compute_image_rotations": lambda:
            scene_geometry.compute_image_rotations(_three_cameras()),
        "estimate_point_normals": lambda:
            scene_geometry.estimate_point_normals(_three_cameras()),
        "estimate_similarity_ransac": lambda: estimate_similarity_ransac(
            np.eye(3)[:, :2], np.eye(3)[:, :2], 3, 1.0),
        "make_mesh": lambda: make_mesh(),
        "launch": lambda: launch(_rank_fn, 2),
        "initialize_multihost": lambda: initialize_multihost(
            "localhost:29500", 1, 0),
        "run_bundler --num_devices 2": lambda: run_bundler.main(
            [str(tmp_path), "--num_devices", "2"]),
        "bundler --num_devices 2": lambda: bundler.main(
            ["list.txt", "--run_bundle", "--num_devices", "2"]),
        "e2e_pixels": lambda: e2e_pixels.main([str(tmp_path)]),
        "scaling": lambda: scaling.main([]),
    }


def _rank_fn(mesh):
    return mesh.rank


def _three_cameras():
    from bundler_sfm_tpu_torch.io.bundlefile import (
        BundleCamera, BundleFile, BundlePoint,
    )
    cams = [BundleCamera(f=1.0, k1=0.0, k2=0.0, R=np.eye(3),
                         t=np.array([float(i), 0.0, 0.0])) for i in range(3)]
    pts = [BundlePoint(pos=np.eye(3)[i], color=np.zeros(3),
                       views=np.zeros((1, 4))) for i in range(3)]
    return BundleFile(cameras=cams, points=pts)


@pytest.mark.parametrize("name", ["DescriptorTable", "match_pair",
                                  "extract_sift_batch", "scene_from_numpy",
                                  "run_bundler", "probe_two_nn_variants",
                                  "ba_problem_from_numpy",
                                  "bundle_adjust_fast", "keymatch.match_full",
                                  "bundler.main", "register_image",
                                  "radialundistort", "fisheyeundistort",
                                  "bundler --compute_covariance",
                                  "bundler --fisheye", "scene_covariance",
                                  "undistort_image",
                                  "fisheye.undistort_image",
                                  "match_pairs_batched", "knn_plane_normals",
                                  "fit_plane_to_points",
                                  "setup_scene_ground_plane",
                                  "compute_image_rotations",
                                  "estimate_point_normals",
                                  "estimate_similarity_ransac", "make_mesh",
                                  "launch", "initialize_multihost",
                                  "run_bundler --num_devices 2",
                                  "bundler --num_devices 2", "e2e_pixels",
                                  "scaling"])
def test_entry_points_default_to_cuda(name, tmp_path, monkeypatch):
    """Without a card, the default device raises instead of falling back
    (each entry point runs on the CPU only when asked: see the other
    tests)."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points(tmp_path)[name]()


def test_launch_refuses_more_ranks_than_cards(monkeypatch):
    """launch on "cuda" gives rank r cuda:r, so it raises (before starting
    any rank) when more ranks are asked for than there are cards, and
    ranks sharing one indexed card need gloo named."""
    from bundler_sfm_tpu_torch.parallel.mesh import launch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks asked for, 1 cards"):
        launch(_rank_fn, 2, "cuda")
    with pytest.raises(ValueError, match="backend='gloo'"):
        launch(_rank_fn, 2, "cuda:0")


def test_two_nn_pairs_rejects_non_cuda_accelerators():
    from bundler_sfm_tpu_torch.ops.matching_cuda import two_nn_pairs
    t = torch.zeros((1, 128, 128), dtype=torch.int8, device="meta")
    c = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        two_nn_pairs(t, t, c, c, c)


def test_new_entry_points_run_on_cpu_when_asked(tmp_path, monkeypatch):
    """keymatch.match_full, bundler.main and register_image given the CPU
    run there (no card needed)."""
    from bundler_sfm_tpu_torch import bundler, keymatch
    from bundler_sfm_tpu_torch.io.bundlefile import BundleFile
    from bundler_sfm_tpu_torch.pipeline.register import register_image
    monkeypatch.chdir(tmp_path)
    (tmp_path / "list.txt").write_text("a.jpg\nb.jpg\n")
    d = np.zeros((4, 128), np.uint8)
    assert keymatch.match_full(["a.key", "b.key"], device="cpu") == {}
    assert bundler.main(["list.txt", "--device", "cpu"]) == 0
    assert register_image(BundleFile(cameras=[], points=[]), d, d,
                          np.zeros((4, 2)), device="cpu") is None

"""The port's `bundler` entry point, resume path and image registration
against the JAX package's, on the CPU in f64, on a tiny on-disk scene: the
`make_pipeline_scene` views (6 images, 1024x768, f = 700) written as key
files, list.txt and a match table, every RANSAC draw replayed from
jax.random (`JaxStageReplay`).

Held:
  * `bundler.main` with RunBundler.sh's options and images 4 and 5 held out
    (--ignore_file): the same cameras registered and points kept; focal and
    distortion within 1e-6, centres and points within 1e-6 after one
    similarity alignment (the BA's gauge, see `_hold_state`); the
    verification files byte-identical;
  * `resume_from_bundle` from that one bundle.out: equal state;
  * `bundler.main --bundle --rerun_bundle --add_images
    --point_constraint_file` from it (resume, anchored re-bundle,
    `continue_reconstruction`): all 6 cameras, parameters within 1e-6 as
    above, every anchored point kept;
  * `register_image` of a held-out image (with and without a position
    guess): the same matches and inliers, camera within 1e-6.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import os
import shutil

import numpy as np
import pytest

from tests.test_pipeline import make_pipeline_scene
from tests.test_torch_recon import JaxStageReplay

from bundler_sfm_tpu import bundler as J_bundler
from bundler_sfm_tpu.io.bundlefile import read_bundle_file as J_read
from bundler_sfm_tpu.pipeline import register as J_reg
from bundler_sfm_tpu.pipeline import resume as J_res
from bundler_sfm_tpu.pipeline.verify import (
    compute_geometric_constraints as J_verify,
)

from bundler_sfm_tpu_torch import bundler as T_bundler
from bundler_sfm_tpu_torch.io.bundlefile import read_bundle_file as T_read
from bundler_sfm_tpu_torch.io.keyfile import centered_to_image, write_key_file
from bundler_sfm_tpu_torch.io.listfile import ImageEntry, write_list_file
from bundler_sfm_tpu_torch.io.matchfile import write_match_file
from bundler_sfm_tpu_torch.pipeline import register as T_reg
from bundler_sfm_tpu_torch.pipeline import resume as T_res
from bundler_sfm_tpu_torch.pipeline.verify import (
    compute_geometric_constraints as T_verify,
)

W, H, SEED = 1024, 768, 0
OPTIONS = ("--match_table matches.init.txt\n--output bundle.out\n"
           "--variable_focal_length\n--use_focal_estimate\n--constrain_focal\n"
           "--constrain_focal_weight 0.0001\n--estimate_distortion\n"
           "--run_bundle\n--fmatrix_rounds 512\n--homography_rounds 128\n")


def _in_dir(path, fn, *args, **kw):
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return fn(*args, **kw)
    finally:
        os.chdir(cwd)


def _aligned_error(Cj, Pj, Ct, Pt):
    """Largest difference of the port's camera centres and points from the
    JAX package's after one similarity alignment of all of them, over the
    JAX package's extent."""
    A, B = np.concatenate([Ct, Pt]), np.concatenate([Cj, Pj])
    A0, B0 = A - A.mean(0), B - B.mean(0)
    U, S, Vt = np.linalg.svd(B0.T @ A0)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    s = (S * np.diag(D)).sum() / (A0 ** 2).sum()
    return np.abs(B0 - s * A0 @ R.T).max() / np.abs(B0).max()


def _hold_state(jcams, jpts, tcams, tpts):
    """Cameras [C, 9] (c, w, f, k1, k2) and points of both packages: focal
    within 1e-6 relative, distortion within 1e-6, centres and points within
    1e-6 after a similarity alignment.  The BA is free in its 7-dof gauge,
    and where the LM stopping iteration differs (it is chaotic at the
    rounding floor: here the JAX package runs to its 150-iteration cap
    while the port stops after ~25) the extra accepted steps drift along
    it (0.6 degrees on this scene), so raw parameters are not comparable."""
    jc, tc = np.stack(jcams), np.stack(tcams)
    assert np.abs(tc[:, 6] / jc[:, 6] - 1).max() < 1e-6
    assert np.abs(tc[:, 7:9] - jc[:, 7:9]).max() < 1e-6
    assert _aligned_error(jc[:, 0:3], np.stack(jpts),
                          tc[:, 0:3], np.stack(tpts)) < 1e-6


def _bundle_state(path, read):
    b = read(str(path))
    reg = [i for i, c in enumerate(b.cameras) if c.registered]
    cams = [np.concatenate([c.center, np.zeros(3), [c.f, c.k1, c.k2]])
            for c in (b.cameras[i] for i in reg)]
    return reg, cams, [p.pos for p in b.points]


def _hold(jpath, tpath, ncams):
    jreg, jc, jp = _bundle_state(jpath, J_read)
    treg, tc, tp = _bundle_state(tpath, T_read)
    assert treg == jreg and len(treg) == ncams
    assert len(tp) == len(jp)
    _hold_state(jc, jp, tc, tp)


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """The scene on disk, and both packages' first run with 4 and 5 held
    out, each in its own directory (constraints.txt is written to the
    working directory)."""
    root = tmp_path_factory.mktemp("scene")
    scene, syn = make_pipeline_scene(np.random.default_rng(0))
    rng = np.random.default_rng(1)
    entries = [ImageEntry(str(root / f"img{i}.jpg"), init_focal=700.0)
               for i in range(6)]
    write_list_file(str(root / "list.txt"), entries)
    for i, xy in enumerate(scene.key_xy):
        info = np.concatenate([centered_to_image(xy, W, H),
                               np.ones((len(xy), 2))], 1)
        write_key_file(str(root / f"img{i}.key"), info,
                       rng.integers(0, 256, (len(xy), 128)).astype(np.uint8))
    write_match_file(str(root / "matches.init.txt"), scene.matches)
    (root / "options.txt").write_text(OPTIONS)
    (root / "ignore.txt").write_text("4\n5\n")
    (root / "held_out.txt").write_text("img4.jpg\nimg5.jpg\n")
    dirs = {}
    for name in ("jax", "port"):
        d = root / name
        d.mkdir()
        for f in ("list.txt", "matches.init.txt", "options.txt"):
            shutil.copy(root / f, d / f)
        dirs[name] = d
    argv = ["list.txt", "--options_file", "options.txt", "--key_dir",
            str(root), "--ignore_file", str(root / "ignore.txt"),
            "--output_dir", "bundle"]
    assert _in_dir(dirs["jax"], J_bundler.main, argv) == 0
    assert _in_dir(dirs["port"], T_bundler.main, argv + ["--device", "cpu"],
                   sampler=JaxStageReplay(SEED)) == 0
    return dict(root=root, syn=syn, **dirs)


def test_bundler_main_matches_jax(disk):
    _hold(disk["jax"] / "bundle" / "bundle.out",
          disk["port"] / "bundle" / "bundle.out", 4)
    for f in ("constraints.txt", "pairwise_scores.txt", "nmatches.ransac.txt",
              "matches.ransac.txt"):
        assert (disk["port"] / f).read_bytes() == \
            (disk["jax"] / f).read_bytes(), f


def _scenes(disk):
    """Both packages' scenes of the first run, tracks loaded from the JAX
    package's constraints.txt."""
    argv = ["list.txt", "--options_file", "options.txt", "--key_dir",
            str(disk["root"])]
    out = []
    for mod, verify, extra in ((J_bundler, J_verify, []),
                               (T_bundler, T_verify, ["--device", "cpu"])):
        args = _in_dir(disk["jax"], mod.parse_with_options_file, argv + extra)
        scene = _in_dir(disk["jax"], mod.scene_from_args, args)
        verify(scene, cache_path=str(disk["jax"] / "constraints.txt"))
        out.append(scene)
    return out


@pytest.fixture(scope="module")
def resumed(disk):
    js, ts = _scenes(disk)
    path = str(disk["jax"] / "bundle" / "bundle.out")
    jrec = J_res.resume_from_bundle(js, J_read(path))
    trec = T_res.resume_from_bundle(ts, T_read(path))
    return dict(js=js, ts=ts, jrec=jrec, trec=trec)


def test_resume_from_bundle_equal_state(resumed):
    jrec, trec = resumed["jrec"], resumed["trec"]
    assert trec.added_order == jrec.added_order and trec.num_cameras == 4
    for f in ("cam_R", "cam_params", "points", "colors"):
        assert np.array_equal(np.stack(getattr(trec, f)),
                              np.stack(getattr(jrec, f))), f
    assert trec.pt_views == jrec.pt_views
    assert np.array_equal(trec.track_extra, jrec.track_extra)
    assert trec.key_extra == jrec.key_extra
    assert (trec.track_extra >= 0).sum() > 150


def test_bundler_main_resume_with_point_constraints(disk):
    """--bundle + --rerun_bundle + --add_images + --point_constraint_file
    from the JAX package's bundle.out, in both packages: resume_from_bundle,
    the anchored run_sfm, then continue_reconstruction registering the two
    held-out images one at a time."""
    path = disk["jax"] / "bundle" / "bundle.out"
    pts = np.stack([p.pos for p in J_read(str(path)).points])
    anchors = pts[::40] + 0.01
    (disk["root"] / "pc.txt").write_text("".join(
        " ".join(f"{v:.6f}" for v in np.concatenate([a - 0.01, a])) + "\n"
        for a in anchors))
    shutil.copy(disk["jax"] / "constraints.txt",
                disk["port"] / "constraints.txt")
    argv = ["list.txt", "--options_file", "options.txt", "--key_dir",
            str(disk["root"]), "--bundle", str(path), "--rerun_bundle",
            "--add_images", str(disk["root"] / "held_out.txt"),
            "--point_constraint_file", str(disk["root"] / "pc.txt"),
            "--point_constraint_weight", "1.0", "--output_dir", "resumed"]
    assert _in_dir(disk["jax"], J_bundler.main, argv) == 0
    assert _in_dir(disk["port"], T_bundler.main, argv + ["--device", "cpu"],
                   sampler=JaxStageReplay(SEED)) == 0
    out = disk["port"] / "resumed" / "bundle.out"
    _hold(disk["jax"] / "resumed" / "bundle.out", out, 6)
    final = np.stack([p.pos for p in T_read(str(out)).points])
    for a in anchors:
        assert ((final - a) ** 2).sum(1).min() ** 0.5 < 5e-3


def _descriptors(resumed, held=5):
    """Key descriptors that match across views: each resumed point's keys
    (and the held-out image's keys of its track) get that point's base
    descriptor plus noise; every other key is random."""
    js, jrec = resumed["js"], resumed["jrec"]
    rng = np.random.default_rng(3)
    descs = [rng.integers(0, 256, (len(x), 128)).astype(np.uint8)
             for x in js.key_xy]
    base = rng.integers(0, 256, (len(jrec.points), 128))

    def noisy(p):
        return np.clip(base[p] + rng.integers(-2, 3, 128), 0, 255)
    for p, views in enumerate(jrec.pt_views):
        for slot, key in views:
            descs[jrec.added_order[slot]][key] = noisy(p)
    for tr, views in enumerate(js.tracks):
        pt = jrec.track_extra[tr]
        for img, key in views:
            if pt >= 0 and img == held:
                descs[held][key] = noisy(pt)
    return descs


@pytest.mark.parametrize("guess", [False, True], ids=["all", "drop_pt"])
def test_register_image(disk, resumed, guess):
    path = str(disk["jax"] / "bundle" / "bundle.out")
    jb, tb = J_read(path), T_read(path)
    descs = _descriptors(resumed)
    jd = J_reg.coalesce_point_descriptors(jb, descs)
    td = T_reg.coalesce_point_descriptors(tb, descs)
    assert np.array_equal(td, jd)
    drop = None
    if guess:
        drop = np.mean([c.center for c in jb.cameras if c.registered], 0)
    kw = dict(config=resumed["js"].config, seed=11, drop_pt=drop, num_nns=3)
    j = J_reg.register_image(jb, jd, descs[5], resumed["js"].key_xy[5], **kw)
    t = T_reg.register_image(tb, td, descs[5], resumed["ts"].key_xy[5],
                             device="cpu", sampler=JaxStageReplay(SEED), **kw)
    assert j is not None and t is not None
    assert np.array_equal(t["matches"], j["matches"])
    assert np.array_equal(t["inlier_idx"], j["inlier_idx"])
    assert t["num_inliers"] == j["num_inliers"] > 30
    assert np.abs(t["R"] - j["R"]).max() < 1e-6
    assert np.abs(t["center"] - j["center"]).max() < \
        1e-6 * np.abs(j["center"]).max()
    assert t["f"] == pytest.approx(j["f"], rel=1e-6)

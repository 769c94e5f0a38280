"""Our side of `benchmarks/e2e_synthetic.py` on the port
(`bundler_sfm_tpu_torch/probes/e2e_synthetic.py`) against the JAX script,
on the CPU:

  * `model_quality` and `similarity_ate` equal to the JAX script's on the
    same bundle.out / centres;
  * keys -> bundle.out (tier c): both packages' `run_ours` on the CPU
    from the same 8 images x 768 keys (seed 0).  The RANSAC draws differ
    between the packages (ROADMAP section 3 item 3), so this scene was
    picked for having no knife-edge pair: the port's run gives the same
    cameras, points, reprojection and ATE to every printed digit under
    five verification / reconstruction seeds (0-4), where 8 x 512 keys,
    for one, registers 8 or 6 cameras depending on the draw.  Required:
    the same registered cameras (all 8), points within 1 %, mean
    reprojection within 0.01 px and ate_rel within 5e-4 of the JAX run's;
  * the printed line's keys, its copy in --out, and no kernel launched on
    the CPU; without --workdir the run leaves no directory behind.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import contextlib
import io
import json
import math
import tempfile

import numpy as np
import pytest

from bundler_sfm_tpu_torch.io.bundlefile import (
    BundleCamera, BundleFile, BundlePoint, write_bundle_file,
)
from bundler_sfm_tpu_torch.probes import e2e_synthetic as E
from tests.test_torch_bench import load_jax_program

N_IMAGES, N_KEYS = 8, 768


@pytest.fixture(scope="module")
def je2e():
    return load_jax_program("benchmarks/e2e_synthetic.py", "jax_e2e")


@pytest.fixture(scope="module")
def runs(tmp_path_factory, je2e):
    """The JAX script's run_ours and the port's main on the same keys."""
    infos, descs, gt = je2e.synthesize(N_IMAGES, N_KEYS, 0.6)
    jdir = tmp_path_factory.mktemp("jax")
    with contextlib.redirect_stdout(io.StringIO()):
        _, _, jax_bundle = je2e.run_ours(str(jdir), infos, descs)
    pdir = tmp_path_factory.mktemp("port")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        line = E.main([str(N_IMAGES), str(N_KEYS), "--device", "cpu",
                       "--workdir", str(pdir), "--out",
                       str(pdir / "line.json")])
    return dict(gt=gt, jax_bundle=jax_bundle,
                jax=je2e.model_quality(jax_bundle, gt), line=line,
                stdout=buf.getvalue(), out=pdir / "line.json", pdir=pdir)


def _noisy_bundle(path, gt, rng):
    """bundle.out of the generator's cameras and a few points, moved by
    noise, one camera unregistered."""
    cams = []
    for i, (c, R) in enumerate(zip(gt["centers"], gt["Rs"])):
        if i == 2:
            cams.append(BundleCamera(f=0.0, k1=0.0, k2=0.0, R=np.eye(3),
                                     t=np.zeros(3)))
            continue
        c = c + rng.normal(0, 0.01, 3)
        cams.append(BundleCamera(f=900.0 + rng.normal(), k1=1e-8, k2=0.0,
                                 R=R, t=-R @ c))
    pts = []
    for _ in range(40):
        views = np.array([[v, rng.integers(0, 100), *rng.normal(0, 200, 2)]
                          for v in rng.choice([0, 1, 3, 4, 5], 3,
                                              replace=False)])
        pts.append(BundlePoint(pos=rng.uniform(-3, 3, 3),
                               color=np.array([128, 128, 128]), views=views))
    write_bundle_file(str(path), BundleFile(cameras=cams, points=pts))


def test_model_quality_equals_jax(tmp_path, je2e):
    _, _, gt = E.synthesize(6, 64, 0.6, seed=3)
    path = tmp_path / "bundle.out"
    _noisy_bundle(path, gt, np.random.default_rng(0))
    got, want = E.model_quality(str(path), gt), je2e.model_quality(
        str(path), gt)
    assert got == want and got["cameras"] == 5


@pytest.mark.parametrize("seed", [0, 1])
def test_similarity_ate_equals_jax(seed, je2e):
    rng = np.random.default_rng(seed)
    gt = rng.normal(size=(7, 3))
    est = 2.5 * gt @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 1.0 \
        + rng.normal(0, 0.05, (7, 3))
    assert E.similarity_ate(est, gt) == je2e.similarity_ate(est, gt)


def test_run_ours_matches_jax(runs, je2e):
    """Tier (c) from the same keys: the tolerances of the module
    docstring.  The port's model_quality on the JAX run's bundle.out is
    also the JAX script's."""
    got, want = runs["line"]["ours"], runs["jax"]
    assert E.model_quality(runs["jax_bundle"], runs["gt"]) == want
    assert got["cameras"] == want["cameras"] == N_IMAGES
    assert abs(got["points"] - want["points"]) <= 0.01 * want["points"]
    assert abs(got["mean_reproj_px"] - want["mean_reproj_px"]) <= 0.01
    assert abs(got["ate_rel"] - want["ate_rel"]) <= 5e-4
    assert got["mean_reproj_px"] < 1.0 and got["ate_rel"] < 0.02


def test_main_line(runs):
    line = runs["line"]
    assert json.loads(runs["stdout"].splitlines()[-1]) == line
    assert json.loads(runs["out"].read_text()) == line
    assert line["images"] == N_IMAGES and line["keys_per_image"] == N_KEYS
    assert line["workdir"] == str(runs["pdir"])
    assert (runs["pdir"] / "ours" / "bundle.out").is_file()
    assert (runs["pdir"] / "ours_telemetry.json").is_file()
    ours = line["ours"]
    assert set(ours) == {"device", "match_s", "bundle_s", "total_s",
                         "stages_s", "counters", "launches", "cameras",
                         "points", "mean_reproj_px", "ate_rel"}
    assert ours["device"]["name"] == "cpu"
    assert not any(ours["launches"].values())
    assert {"verify", "ba", "register", "total"} <= set(ours["stages_s"])
    assert ours["counters"]["lm_iters"] > 0
    assert "ba_schur_windowed" not in ours["counters"]
    assert ours["total_s"] == ours["match_s"] + ours["bundle_s"]
    assert all(math.isfinite(v) and v >= 0 for v in
               [ours["match_s"], ours["bundle_s"],
                *ours["stages_s"].values()])


def test_main_without_workdir_leaves_nothing(tmp_path, monkeypatch):
    """Without --workdir the run works in a temporary directory and
    removes it at its end; the line says so with a null workdir."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with contextlib.redirect_stdout(io.StringIO()):
        line = E.main([str(N_IMAGES), str(N_KEYS), "--device", "cpu"])
    assert line["workdir"] is None
    assert line["ours"]["cameras"] == N_IMAGES
    assert not list(tmp_path.iterdir())

"""The port's run_bundler front end as a whole against the JAX package's:
the same rendered JPEGs go through list.txt, SIFT, matching and
verification in both packages, on the CPU.

Tolerances:
  * list.txt, matches.init.txt, pairwise_scores.txt: byte-identical;
    tracks and per-image track tables identical.  Matching and
    verification are fed the JAX package's keys and descriptors, and the
    port's verification replays the JAX package's RANSAC draw.
  * SIFT: the agreement of tests/test_torch_sift.py (>= 97% of JAX keys
    within 1e-3, descriptors within 1).

The verification's outcome is sensitive to rounding: minimal-sample
8-point fits solve ill-conditioned 8x8 normal equations, so a 1-ulp change
of the inputs can move a pair's best hypothesis (measured: 3 of 24 pairs
of a 12-view 480x360 render change inlier sets under a 1-ulp scaling of
the keypoints; 3 of 8 small renders searched had such a pair).  The
collection below (8 views, 320x240, texture seed 4) has none: its port
verification with the JAX draw equals the JAX package's unchanged under
+-1 and 2-ulp scalings of the keypoints, so byte-identity is a stable
check.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_sift import agreement

from bundler_sfm_tpu.config import default_pipeline_config as jax_config
from bundler_sfm_tpu.features.sift import extract_sift_batch as jax_sift
from bundler_sfm_tpu.io.keyfile import keys_to_centered
from bundler_sfm_tpu.io.listfile import ImageEntry, write_list_file
from bundler_sfm_tpu.io.matchfile import write_match_file
from bundler_sfm_tpu.ops.matching import DescriptorTable as JaxTable
from bundler_sfm_tpu.ops.ransac import sample_indices
from bundler_sfm_tpu.pipeline import verify as jax_verify
from bundler_sfm_tpu.pipeline.scene import Scene as JaxScene

from bundler_sfm_tpu_torch import run_bundler
from bundler_sfm_tpu_torch.convert import config_from_dict, scene_from_numpy
from bundler_sfm_tpu_torch.features.sift import extract_sift_batch, load_grayscale
from bundler_sfm_tpu_torch.io.matchfile import write_match_file as port_write_matches
from bundler_sfm_tpu_torch.ops.matching import DescriptorTable
from bundler_sfm_tpu_torch.pipeline.verify import compute_geometric_constraints
from bundler_sfm_tpu_torch.utils.render_scene import render_box_room

FOCAL = 280.0
MAX_KEYS = 1024
CONTRAST = 0.02     # run_bundler's default


class JaxReplaySampler:
    """Replays the JAX package's RANSAC draw for each pair: F rounds from
    split(fold_in(PRNGKey(seed), start), batch)[b] and H rounds the same
    with PRNGKey(seed + 7777), where start is the offset of the pair's
    batch under the JAX package's `_auto_batch` (pipeline/verify.py)."""

    def __init__(self, seed):
        self.seed = seed

    def __call__(self, stage, positions, num_pairs, n_valid, n_pad,
                 num_rounds, sample_size):
        seed = self.seed + (0 if stage == "fmatrix" else 7777)
        base = jax.random.PRNGKey(seed)
        jb = jax_verify._auto_batch(num_pairs, None, pad=n_pad,
                                    rounds=num_rounds)
        keys, out = {}, []
        for pos, n in zip(positions, n_valid.cpu().numpy()):
            start = (pos // jb) * jb
            if start not in keys:
                keys[start] = jax.random.split(
                    jax.random.fold_in(base, start), jb)
            out.append(np.asarray(sample_indices(
                keys[start][pos - start], num_rounds, sample_size,
                jnp.int32(n), n_pad)))
        return torch.from_numpy(np.stack(out)).long()


@pytest.fixture(scope="module")
def collection(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("views"))
    render_box_room(d, n=8, W=320, H=240, seed=4, f=FOCAL, sheet_size=512)
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".jpg"))


@pytest.fixture(scope="module")
def jax_run(collection, tmp_path_factory):
    """The JAX package's stages 1-4 (run_bundler.py:92-176) on the CPU."""
    out = tmp_path_factory.mktemp("jax")
    entries = [ImageEntry(p, init_focal=FOCAL) for p in collection]
    write_list_file(str(out / "list.txt"), entries)
    grays = [load_grayscale(p) for p in collection]
    dims = [(g.shape[1], g.shape[0]) for g in grays]
    sift = jax_sift(grays, max_keys_total=MAX_KEYS, contrast_thr=CONTRAST)
    infos = [r[0] for r in sift]
    descs = [r[1] for r in sift]
    n = len(collection)
    pairs = [(j, i) for i in range(n) for j in range(i)]
    matches = JaxTable(descs).match_pairs(pairs, min_matches=16)
    write_match_file(str(out / "matches.init.txt"), matches)
    key_xy = [keys_to_centered(info, w, h)[:, :2].astype(np.float64)
              for info, (w, h) in zip(infos, dims)]
    scene = JaxScene(config=jax_config(), entries=entries, dims=dims,
                     key_xy=key_xy, matches=copy.deepcopy(matches))
    jax_verify.compute_geometric_constraints(
        scene, seed=0, scores_path=str(out / "pairwise_scores.txt"))
    return dict(out=out, entries=entries, grays=grays, dims=dims,
                infos=infos, descs=descs, pairs=pairs, matches=matches,
                key_xy=key_xy, scene=scene)


def test_run_bundler_cli_writes_reference_files(collection, jax_run,
                                                tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc = run_bundler.main([os.path.dirname(collection[0]), "--device", "cpu",
                           "--init_focal", str(FOCAL), "--max_keys",
                           str(MAX_KEYS), "--write_keys"])
    assert rc == 0
    assert (tmp_path / "list.txt").read_bytes() == \
        (jax_run["out"] / "list.txt").read_bytes()
    for f in ["matches.init.txt", "pairwise_scores.txt"] + [
            os.path.basename(p)[:-4] + ".key.gz" for p in collection]:
        assert (tmp_path / f).stat().st_size > 0, f
    from bundler_sfm_tpu_torch.io.bundlefile import read_bundle_file
    bundle = read_bundle_file(str(tmp_path / "bundle" / "bundle.out"))
    assert len(bundle.cameras) == len(collection)
    assert bundle.num_registered >= 2 and len(bundle.points) > 0


def test_sift_agrees(jax_run):
    port = extract_sift_batch(jax_run["grays"], max_keys_total=MAX_KEYS,
                              contrast_thr=CONTRAST, device="cpu")
    for (ji, jd), (ti, td) in zip(zip(jax_run["infos"], jax_run["descs"]),
                                  port):
        assert abs(len(ti) - len(ji)) <= 0.01 * len(ji)
        share, worst = agreement(ji, jd, ti, td)
        assert share >= 0.97 and worst <= 1, (share, worst)


def test_matches_identical(jax_run, tmp_path):
    matches = DescriptorTable(jax_run["descs"], device="cpu").match_pairs(
        jax_run["pairs"], min_matches=16)
    port_write_matches(str(tmp_path / "matches.init.txt"), matches)
    want = (jax_run["out"] / "matches.init.txt").read_bytes()
    assert (tmp_path / "matches.init.txt").read_bytes() == want
    assert len(matches) >= 5


def test_verification_identical(jax_run, tmp_path):
    cfg = config_from_dict(dataclasses.asdict(jax_run["scene"].config))
    scene = scene_from_numpy(jax_run["entries"], jax_run["dims"],
                             jax_run["key_xy"], jax_run["matches"], cfg,
                             device="cpu")
    compute_geometric_constraints(
        scene, seed=0, scores_path=str(tmp_path / "pairwise_scores.txt"),
        sampler=JaxReplaySampler(0))
    want = (jax_run["out"] / "pairwise_scores.txt").read_bytes()
    assert (tmp_path / "pairwise_scores.txt").read_bytes() == want
    js = jax_run["scene"]
    assert scene.tracks == js.tracks and len(scene.tracks) > 100
    assert scene.visible_points == js.visible_points
    assert scene.visible_keys == js.visible_keys
    assert scene.key_track == js.key_track
    for p, t in js.transforms.items():
        assert scene.transforms[p].num_inliers == t.num_inliers

"""Tier (c): the port's reconstruction (`bundle_adjust_fast`) against the
JAX package's on `make_pipeline_scene` (6 views, 250 points, 5% outlier
matches, 0.3 px noise), on the CPU in f64.  The port replays the JAX
package's RANSAC draws: verification (F, H), the 5-point initial pair and
every registration round's resection.

Held: identical tracks, the same initial pair and registration order, 6/6
cameras, the same number of points; camera centres similarity-aligned to
ground truth within 0.02 relative (the bound of
`tests/test_pipeline.py::test_end_to_end_synthetic`) and to the JAX
package's within 1e-6; `run_sfm` from one shared state within 1e-8 with the
same surviving points.  Should a count ever differ, the test requires the
JAX package to differ at least as much from itself when the keypoints are
scaled by 1 + 2^-52 (the decisions downstream of BA — reprojection and f32
ray-angle gates — are as sensitive to rounding as verification is).
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_pipeline import make_pipeline_scene, similarity_align
from tests.test_torch_slice import JaxReplaySampler

from bundler_sfm_tpu.io.bundlefile import read_bundle_file
from bundler_sfm_tpu.ops.ransac import sample_indices
from bundler_sfm_tpu.pipeline import incremental as J_inc
from bundler_sfm_tpu.pipeline.verify import compute_geometric_constraints

from bundler_sfm_tpu_torch.convert import (
    reconstruction_from_numpy, scene_from_numpy,
)
from bundler_sfm_tpu_torch.pipeline import incremental as T_inc
from bundler_sfm_tpu_torch.pipeline.verify import (
    compute_geometric_constraints as port_verify,
)

VERIFY_SEED, BUNDLE_SEED = 3, 5


class JaxStageReplay(JaxReplaySampler):
    """JaxReplaySampler extended to the reconstruction's draws, with the
    JAX package's padding: the 5-point draw and the one-image resection
    draw ("resection_one": `bundle_initialize_image`, `register_image`) over
    `_bucket(n, 64)` entries from PRNGKey(seed); each lane of a batched
    resection round from split(PRNGKey(seed), _bucket(B, 4))[b] over
    `_bucket(max n, 64)` entries."""

    def __call__(self, stage, *args):
        if stage not in ("fivepoint", "resection", "resection_one"):
            return super().__call__(stage, *args)
        seed, n_valid, num_rounds, k = args
        nv = [int(n) for n in n_valid]
        pad = J_inc._bucket(max(nv), 64)
        key = jax.random.PRNGKey(seed)
        keys = jax.random.split(key, J_inc._bucket(len(nv), 4)) \
            if stage == "resection" else [key]
        import torch
        return torch.stack([torch.from_numpy(np.asarray(sample_indices(
            kb, num_rounds, k, jnp.int32(n), pad))).long()
            for kb, n in zip(keys, nv)])


def _scenes(scale=1.0):
    rng = np.random.default_rng(0)
    js, syn = make_pipeline_scene(rng)
    js.key_xy = [k * scale for k in js.key_xy]
    raw = copy.deepcopy(js.matches)
    compute_geometric_constraints(js, seed=VERIFY_SEED)
    return js, syn, raw


def _port_scene(js, raw):
    ts = scene_from_numpy(js.entries, js.dims, js.key_xy, raw,
                          dataclasses.asdict(js.config), device="cpu")
    port_verify(ts, seed=VERIFY_SEED, sampler=JaxStageReplay(VERIFY_SEED))
    return ts


def _summary(recon):
    centers = np.stack([c[0:3] for c in recon.cam_params])
    return dict(order=list(recon.added_order),
                points=sum(1 for v in recon.pt_views if v), centers=centers)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    js, syn, raw = _scenes()
    ts = _port_scene(js, raw)
    verified = copy.deepcopy(js)
    jout = tmp_path_factory.mktemp("jax")
    tout = tmp_path_factory.mktemp("port")
    jr = J_inc.bundle_adjust_fast(js, out_dir=str(jout), seed=BUNDLE_SEED)
    tr = T_inc.bundle_adjust_fast(ts, out_dir=str(tout), seed=BUNDLE_SEED,
                                  sampler=JaxStageReplay(BUNDLE_SEED))
    return dict(js=verified, ts=ts, syn=syn, raw=raw, jr=jr, tr=tr,
                jout=jout, tout=tout)


def test_tracks_identical(runs):
    js, ts = runs["js"], runs["ts"]
    assert ts.tracks == js.tracks and len(ts.tracks) > 150
    assert ts.visible_points == js.visible_points
    assert T_inc.pick_initial_pair(ts, True) == \
        J_inc.pick_initial_pair(js, True)


def test_reconstruction_matches_jax(runs):
    j, t = _summary(runs["jr"]), _summary(runs["tr"])
    assert t["order"] == j["order"] and len(t["order"]) == 6
    if t["points"] != j["points"]:
        js2, _, _ = _scenes(1.0 + 2.0 ** -52)
        j2 = _summary(J_inc.bundle_adjust_fast(js2, seed=BUNDLE_SEED))
        assert abs(j2["points"] - j["points"]) >= \
            abs(t["points"] - j["points"]), (j, t, j2)
    assert t["points"] > 120
    syn = runs["syn"]
    gt = np.stack([syn.centers[i] for i in t["order"]])
    assert similarity_align(t["centers"], gt) < 0.02
    scale = np.abs(j["centers"]).max()
    assert np.abs(t["centers"] - j["centers"]).max() < 1e-6 * scale
    for s in range(6):
        assert runs["tr"].cam_params[s][6] == pytest.approx(700.0, rel=0.05)


def test_bundle_file_written(runs):
    bf = read_bundle_file(str(runs["tout"] / "bundle.out"))
    assert bf.num_registered == 6
    assert len(bf.points) == _summary(runs["tr"])["points"]
    plys = sorted(p.name for p in runs["tout"].glob("points*.ply"))
    assert plys == sorted(p.name for p in runs["jout"].glob("points*.ply"))


def test_run_sfm_from_shared_state(runs):
    """Both packages' run_sfm from the JAX package's initial-pair state."""
    js = copy.deepcopy(runs["js"])
    i, j = J_inc.pick_initial_pair(js, True)
    jrec = J_inc.setup_initial_pair(js, i, j, seed=BUNDLE_SEED)
    trec = reconstruction_from_numpy(**dataclasses.asdict(jrec))
    J_inc.run_sfm(jrec, js)
    T_inc.run_sfm(trec, runs["ts"])
    assert [len(v) for v in trec.pt_views] == [len(v) for v in jrec.pt_views]
    for a, b in ((jrec.cam_params, trec.cam_params), (jrec.cam_R, trec.cam_R),
                 (jrec.points, trec.points)):
        a, b = np.stack(a), np.stack(b)
        assert np.abs(a - b).max() <= 1e-8 * np.abs(a).max()

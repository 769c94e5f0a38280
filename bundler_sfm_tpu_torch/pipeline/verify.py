"""Pairwise geometric verification — port of
`bundler_sfm_tpu/pipeline/verify.py`, the `ComputeGeometricConstraints`
stage (`src/BundlerGeometry.cpp:99-194`): per-pair F-matrix RANSAC
filtering of match lists, homography RANSAC scoring, symmetric lists, then
tracks.

Pairs are padded to a common size and the RANSAC estimators run batched
over the pair dimension on the scene's device; the keypoint table is
device-resident and each batch gathers its coordinates on the device from
int32 match indices.

The RANSAC draw comes from a sampler: `sampler(stage, positions,
num_pairs, n_valid, n_pad, num_rounds, sample_size)` returns int64
[B, num_rounds, sample_size] indices for the pairs at `positions` of the
stage's sorted pair list (`stage` is "fmatrix" or "homography").  The
default, `TorchSampler`, draws distinct valid indices from a seeded
`torch.Generator` on the device.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from bundler_sfm_tpu_torch.ops.fmatrix import estimate_fmatrix_ransac
from bundler_sfm_tpu_torch.ops.homography import estimate_homography_ransac
from bundler_sfm_tpu_torch.ops.matching import symmetrize
from bundler_sfm_tpu_torch.ops.ransac import sample_indices
from bundler_sfm_tpu_torch.pipeline.scene import Scene, TransformInfo
from bundler_sfm_tpu_torch.pipeline.tracks import (
    build_tracks, tracks_to_image_tables,
)
from bundler_sfm_tpu_torch.utils import counter, stage

# Seed offset of the homography stage's draw (the JAX package keys it
# PRNGKey(seed + 7777)).
_H_SEED_OFFSET = 7777


class TorchSampler:
    """Default RANSAC sampler: one seeded `torch.Generator` per stage on the
    scene's device (F from `seed`, H from `seed + 7777`)."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generators = {}
        for name, s in (("fmatrix", seed), ("homography",
                                           seed + _H_SEED_OFFSET)):
            g = torch.Generator(device=self.device)
            g.manual_seed(s)
            self.generators[name] = g

    def __call__(self, stage_name, positions, num_pairs, n_valid, n_pad,
                 num_rounds, sample_size):
        return sample_indices(self.generators[stage_name], num_rounds,
                              sample_size, n_valid.to(self.device), n_pad)


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def _device_key_table(scene: Scene, pairs, device):
    """[N, K, 2] device-resident padded keypoint table for the images in
    `pairs` + image→row map (each image uploads once, not once per pair)."""
    dt = torch.float32 if scene.config.ba_dtype == "float32" else torch.float64
    imgs = sorted({i for p in pairs for i in p})
    K = _round_up(max((len(scene.key_xy[i]) for i in imgs), default=1), 64)
    tab = np.zeros((len(imgs), K, 2), np.float64)
    for li, i in enumerate(imgs):
        k = scene.key_xy[i]
        tab[li, :len(k)] = k
    return (torch.from_numpy(tab).to(device=device, dtype=dt),
            {i: li for li, i in enumerate(imgs)})


def _batch_coords(scene: Scene, pairs, pad: int, local, table):
    """Gather the batch's [B, pad, 2] coordinates on the device."""
    B = len(pairs)
    pi = np.zeros(B, np.int64)
    pj = np.zeros(B, np.int64)
    midx = np.zeros((B, pad, 2), np.int64)
    n = np.zeros(B, np.int64)
    for b, (i, j) in enumerate(pairs):
        m = scene.matches[(i, j)]
        cnt = min(len(m), pad)
        midx[b, :cnt] = m[:cnt]
        pi[b] = local[i]
        pj[b] = local[j]
        n[b] = cnt
    dev = table.device
    pi, pj, midx, n = (torch.from_numpy(a).to(dev) for a in (pi, pj, midx, n))
    x1 = table[pi[:, None], midx[:, :, 0]]
    x2 = table[pj[:, None], midx[:, :, 1]]
    return x1, x2, n


def remove_border_matches(scene: Scene) -> None:
    """Drop matches whose keypoints fall within `keypoint_border_width` px
    of any edge, or within `keypoint_border_bottom` px of the bottom
    (centered coords; `RemoveMatchesNearBorder`,
    `src/BundlerGeometry.cpp:752-845`)."""
    cfg = scene.config
    bw = cfg.keypoint_border_width
    bb = cfg.keypoint_border_bottom

    def ok(img, keys):
        w, h = scene.dims[img]
        xy = scene.key_xy[img][keys]
        good = np.ones(len(keys), dtype=bool)
        if bw > 0:
            good &= (xy[:, 0] >= -0.5 * w + bw) & (xy[:, 0] <= 0.5 * w - bw)
            good &= (xy[:, 1] >= -0.5 * h + bw) & (xy[:, 1] <= 0.5 * h - bw)
        if bb > 0:
            good &= xy[:, 1] >= -0.5 * h + bb   # bottom = most-negative y
        return good

    for (i, j), m in list(scene.matches.items()):
        keep = ok(i, m[:, 0]) & ok(j, m[:, 1])
        scene.matches[(i, j)] = m[keep]


def _auto_batch(num_pairs: int, batch, pad: int = 0,
                rounds: int = 2048) -> int:
    """Pairs per batch: 16 for small collections, 128 / 256 for large ones,
    CAPPED by the RANSAC scoring temporaries: ~7 live [B, rounds, pad] f64
    arrays (~56 bytes per entry, twice the JAX package's f32 estimate) must
    stay within 8 GB."""
    if batch is not None:
        return batch
    if num_pairs <= 64:
        return 16
    b = 128 if num_pairs <= 4096 else 256
    if pad:
        cap = max(16, int(8e9 / (56.0 * pad * max(rounds, 1))))
        p = 16
        while p * 2 <= cap:
            p *= 2
        b = min(b, p)
    return b


def _run_batches(scene, todo, pad, rounds, sample_size, stage_name, sampler,
                 estimate, threshold, batch):
    """Run `estimate` over `todo` in batches; yields (chunk, outputs)."""
    table, local = _device_key_table(scene, todo, scene.device)
    batch = _auto_batch(len(todo), batch, pad=pad, rounds=rounds)
    for start in range(0, len(todo), batch):
        chunk = todo[start:start + batch]
        x1, x2, n = _batch_coords(scene, chunk, pad, local, table)
        samples = sampler(stage_name, list(range(start, start + len(chunk))),
                          len(todo), n, pad, rounds, sample_size)
        out = estimate(samples.to(table.device), x1, x2, n, threshold)
        yield chunk, [o.cpu().numpy() for o in out]


def compute_epipolar_geometry(scene: Scene, seed: int = 0, batch: int = None,
                              sampler: Callable = None) -> None:
    """F-RANSAC every matched pair; filter match lists to inliers; drop pairs
    with < min_num_feat_matches inliers (`ComputeEpipolarGeometry`,
    `src/BundlerGeometry.cpp:330-439`; removeBadMatches=True on this path,
    `:142`)."""
    cfg = scene.config
    pairs = sorted(scene.matches.keys())
    if not pairs:
        return
    sampler = sampler or TorchSampler(seed, scene.device)
    # Reference requires >= 20 matches to even try (src/Epipolar.cpp:127).
    todo = [p for p in pairs if len(scene.matches[p]) >= 20]
    drop = [p for p in pairs if len(scene.matches[p]) < 20]
    pad_all = _round_up(max((len(scene.matches[p]) for p in todo),
                            default=8), 64)
    for chunk, (F, inl, cnt) in _run_batches(
            scene, todo, pad_all, cfg.fmatrix_rounds, 8, "fmatrix", sampler,
            estimate_fmatrix_ransac, cfg.fmatrix_threshold, batch):
        for b, (i, j) in enumerate(chunk):
            m = scene.matches[(i, j)]
            kept = m[inl[b, :len(m)]]
            if int(cnt[b]) >= cfg.min_num_feat_matches:
                scene.matches[(i, j)] = kept
                ti = scene.transforms.setdefault((i, j), TransformInfo())
                ti.fmatrix = F[b]
                tj = scene.transforms.setdefault((j, i), TransformInfo())
                tj.fmatrix = F[b].T
            else:
                drop.append((i, j))
    for p in drop:
        scene.matches.pop(p, None)
        scene.transforms.pop(p, None)
        scene.transforms.pop((p[1], p[0]), None)


def compute_transforms(scene: Scene, seed: int = 1, batch: int = None,
                       sampler: Callable = None) -> None:
    """Homography per surviving pair; records inlier count/ratio for initial
    -pair scoring (`ComputeTransform`, `src/BundlerGeometry.cpp:197-263`;
    called with removeBadMatches=false, `:146`; MIN_INLIERS=10)."""
    cfg = scene.config
    pairs = sorted(scene.matches.keys())
    # The reference default-constructs a TransformInfo for EVERY matched
    # pair before attempting the fit (BundlerGeometry.cpp:283-284), so pairs
    # whose homography fails still appear (ratio 0) in pairwise_scores.txt.
    for (i, j) in pairs:
        if i < j:
            scene.transforms.setdefault((i, j), TransformInfo())
            scene.transforms.setdefault((j, i), TransformInfo())
    todo = [p for p in pairs if len(scene.matches[p]) >= 4]
    if not todo:
        return
    sampler = sampler or TorchSampler(seed, scene.device)
    pad_all = _round_up(max(len(scene.matches[p]) for p in todo), 64)
    for chunk, (H, _inl, cnt) in _run_batches(
            scene, todo, pad_all, cfg.homography_rounds, 4, "homography",
            sampler, estimate_homography_ransac, cfg.homography_threshold,
            batch):
        for b, (i, j) in enumerate(chunk):
            m = scene.matches[(i, j)]
            num_inl = int(cnt[b])
            if num_inl >= 10:
                ti = scene.transforms.setdefault((i, j), TransformInfo())
                ti.hmatrix = H[b]
                ti.num_inliers = num_inl
                ti.inlier_ratio = num_inl / max(len(m), 1)


def compute_geometric_constraints(scene: Scene, seed: int = 0,
                                  cache_path=None,
                                  overwrite: bool = False,
                                  snapshot_dir=None,
                                  scores_path=None,
                                  sampler: Callable = None) -> None:
    """The full verification stage (`ComputeGeometricConstraints`,
    `src/BundlerGeometry.cpp:99-194`): F filter → H score → symmetric lists
    → tracks → per-image track tables, on `scene.device`.

    With `cache_path` set, behaves like the reference's constraints.txt
    checkpoint (`:105-108`): load it if present (unless overwrite), write it
    after computing.  With `snapshot_dir` set, dumps the match table at the
    .prune / .ransac / .corresp stages (`WriteMatchTable`,
    `src/BundlerGeometry.cpp:113,152,188`).  `sampler` replaces both
    stages' RANSAC draws (default: `TorchSampler(seed, scene.device)`)."""
    from bundler_sfm_tpu_torch import native
    from bundler_sfm_tpu_torch.io.constraints import (
        read_geometric_constraints, write_geometric_constraints,
        write_pairwise_scores,
    )
    from bundler_sfm_tpu_torch.io.matchfile import write_match_table
    if cache_path and not overwrite and os.path.exists(cache_path):
        read_geometric_constraints(cache_path, scene)
        return
    cfg = scene.config
    sampler = sampler or TorchSampler(seed, scene.device)
    with stage("verify"):
        if snapshot_dir is not None:
            with stage("match_snapshots"):
                write_match_table(scene.num_images, scene.matches, ".prune",
                                  snapshot_dir)
        # Border-match filters (`RemoveMatchesNearBorder`/`...NearBottom`,
        # `src/BundlerGeometry.cpp:119-139, 752-845`).
        if cfg.keypoint_border_width > 0 or cfg.keypoint_border_bottom > 0:
            remove_border_matches(scene)
        if not cfg.skip_fmatrix:
            with stage("verify_fmatrix"):
                compute_epipolar_geometry(scene, seed=seed, sampler=sampler)
        if not cfg.skip_homographies:
            with stage("verify_homography"):
                compute_transforms(scene, seed=seed, sampler=sampler)
        if scores_path is not None:
            # The reference emits pairwise_scores.txt at the end of every
            # ComputeTransforms run (`src/BundlerGeometry.cpp:309-326`).
            write_pairwise_scores(scores_path, scene)
        if snapshot_dir is not None:
            with stage("match_snapshots"):
                write_match_table(scene.num_images, scene.matches, ".ransac",
                                  snapshot_dir)
        with stage("verify_tracks"):
            scene.matches = symmetrize(scene.matches)
            if native.available():
                scene.tracks = native.build_tracks_native(scene.matches,
                                                          scene.num_images)
            else:
                scene.tracks = build_tracks(scene.matches, scene.num_images)
            # Filter track length like the reference's min/max_track_views
            # gates.
            scene.tracks = [
                t for t in scene.tracks
                if cfg.min_track_views <= len(t) <= cfg.max_track_views]
            vp, vk, kt = tracks_to_image_tables(scene.tracks,
                                                scene.num_images)
        scene.visible_points = vp
        scene.visible_keys = vk
        scene.key_track = kt
        # Reference clears raw match lists after track building
        # (`RemoveAllMatches`, BundlerGeometry.cpp:158) — tracks are the
        # truth now.
        scene.matches = {}
    if cache_path:
        with stage("write_constraints"):
            write_geometric_constraints(cache_path, scene)
    if snapshot_dir is not None:
        # .corresp: the covisibility pair set derived from tracks, with the
        # match lists cleared (BundlerGeometry.cpp:160-188); the counter
        # counts the view pairs the walk visits, repeats included.
        with stage("match_snapshots"):
            covis = {}
            empty = np.zeros((0, 2), np.int32)
            for t in scene.tracks:
                views = sorted(img for img, _ in t)
                for a in range(len(views)):
                    for b in range(a + 1, len(views)):
                        covis[(views[a], views[b])] = empty
            write_match_table(scene.num_images, covis, ".corresp",
                              snapshot_dir)
        counter("corresp_pairs", sum(len(t) * (len(t) - 1) // 2
                                     for t in scene.tracks))

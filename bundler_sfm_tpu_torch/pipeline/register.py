"""Localize a new image against an existing model — port of
`bundler_sfm_tpu/pipeline/register.py`.

The role of `BundleRegisterImage` (`src/Bundle.cpp:3692-4188`): coalesce one
descriptor per 3D point from its member keys (the averaging of
`BundlerGeometry.cpp:443-622`), match the new image's descriptors against
them by exact 2-NN (`MatchKeysToPoints`, `BundlerGeometry.cpp:624-750`; on
CUDA the hand-written 2-NN kernel), then DLT-RANSAC resection and iterative
refinement — the estimators of in-loop registration, on `device`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from bundler_sfm_tpu_torch.config import BundlerConfig
from bundler_sfm_tpu_torch.io.bundlefile import BundleFile
from bundler_sfm_tpu_torch.ops.matching import match_pair, prune_double_matches
from bundler_sfm_tpu_torch.ops.resection import find_and_verify_camera
from bundler_sfm_tpu_torch.ops.triangulate import triangulate_tracks
from bundler_sfm_tpu_torch.pipeline.incremental import (
    StageSampler, refine_camera_iterative,
)
from bundler_sfm_tpu_torch.utils import resolve_device


def coalesce_point_descriptors(bundle: BundleFile, key_descs) -> np.ndarray:
    """Mean descriptor per 3D point over its views' keys (uint8 [P, 128])."""
    out = np.zeros((len(bundle.points), 128), dtype=np.float64)
    for pi, p in enumerate(bundle.points):
        count = 0
        for v in p.views:
            img, key = int(v[0]), int(v[1])
            if img < len(key_descs) and key_descs[img] is not None \
                    and key < len(key_descs[img]):
                out[pi] += key_descs[img][key]
                count += 1
        if count:
            out[pi] /= count
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def points_near_cameras(bundle: BundleFile, drop_pt: np.ndarray,
                        num_nns: int = 20) -> np.ndarray:
    """Indices of 3D points seen by the `num_nns` registered cameras nearest
    to a position guess — the camera-neighborhood prefilter of
    `BundleRegisterImage` (`src/Bundle.cpp:3722-3790`: CreateCameraSearchTree
    + NUM_NNS=20), as one distance computation on the host."""
    regs = np.array([i for i, c in enumerate(bundle.cameras) if c.f > 0])
    if len(regs) == 0:
        return np.arange(len(bundle.points))
    centers = np.stack([-bundle.cameras[i].R.T @ bundle.cameras[i].t
                        for i in regs])
    d2 = ((centers - np.asarray(drop_pt)[None]) ** 2).sum(axis=1)
    near = set(int(i) for i in regs[np.argsort(d2)[:num_nns]])
    keep = [pi for pi, p in enumerate(bundle.points)
            if any(int(v[0]) in near for v in p.views)]
    return np.array(keep, dtype=np.int64)


class _RefineScene:
    """What `refine_camera_iterative` reads of a scene: the config, and no
    initial focal for the new image."""

    def __init__(self, config):
        self.config = config

    @staticmethod
    def has_init_focal(_):
        return False

    @staticmethod
    def init_focal(_):
        return 0.0


def register_image(bundle: BundleFile, point_descs: np.ndarray,
                   new_desc: np.ndarray, new_xy: np.ndarray,
                   config: Optional[BundlerConfig] = None,
                   ratio: float = 0.6, seed: int = 0,
                   drop_pt: Optional[np.ndarray] = None, num_nns: int = 20,
                   device="cuda", sampler: Callable = None
                   ) -> Optional[Dict]:
    """Estimate the new image's camera on `device`.  Returns None on
    failure, else a dict with R, center, f, k, num_inliers, matches and
    inlier_idx.

    point_descs [P, 128] are the coalesced point descriptors, new_desc
    [K, 128] / new_xy [K, 2] the new image's descriptors and centered key
    coordinates.  With `drop_pt` (a position guess, the reference's
    m_drop_pt, `src/Bundle.cpp:3730`) only points seen by the `num_nns`
    nearest registered cameras are matched.  The resection draw is
    `sampler("resection_one", seed, ...)` (default `StageSampler`)."""
    cfg = config or BundlerConfig()
    dev = resolve_device(device)
    sampler = sampler or StageSampler(dev)
    if drop_pt is not None:
        subset = points_near_cameras(bundle, drop_pt, num_nns)
        if len(subset) == 0:
            return None
        matches = match_keys_to_points(new_desc, point_descs[subset], ratio,
                                       device=dev)
        if len(matches):
            matches = np.stack(
                [matches[:, 0], subset[matches[:, 1]]], axis=1
            ).astype(np.int32)
    else:
        matches = match_keys_to_points(new_desc, point_descs, ratio,
                                       device=dev)
    if len(matches) < cfg.min_max_matches:
        return None
    X = np.stack([bundle.points[int(m[1])].pos for m in matches])
    x = new_xy[matches[:, 0]]
    n = len(X)
    samples = sampler("resection_one", seed, torch.tensor([n]),
                      cfg.projection_rounds, 6).to(dev)
    ver = find_and_verify_camera(
        samples, torch.as_tensor(X[None], dtype=torch.float64, device=dev),
        torch.as_tensor(x[None], dtype=torch.float64, device=dev),
        torch.tensor([n], device=dev), cfg.projection_estimation_threshold,
        16.0 * cfg.projection_estimation_threshold)
    if not bool(ver.ok[0]):
        return None
    K, R, t = (v[0].cpu().numpy() for v in (ver.K, ver.R, ver.t))
    center = -R.T @ t
    f0 = 0.5 * (K[0, 0] + K[1, 1])
    weak = np.nonzero(ver.inliers_weak[0].cpu().numpy())[0]
    if len(weak) < 8:
        return None
    cam0 = np.concatenate([center, np.zeros(3), [f0], np.zeros(2)])
    cam, Rn, inl = refine_camera_iterative(
        _RefineScene(cfg), 0, cam0, R, X[weak], x[weak], adjust_focal=True,
        device=dev)
    if len(inl) < 8:
        return None
    return dict(R=Rn, center=cam[0:3], f=float(cam[6]),
                k=(float(cam[7]), float(cam[8])), num_inliers=len(inl),
                matches=matches, inlier_idx=weak[inl])


def match_keys_to_points(new_desc: np.ndarray, point_descs: np.ndarray,
                         ratio: float = 0.6, device="cuda") -> np.ndarray:
    """2-NN + ratio match of a new image's descriptors (queries) against
    coalesced point descriptors (`MatchKeysToPoints`,
    `BundlerGeometry.cpp:624-685`), deduped keep-first.  Rows are (key,
    point)."""
    return prune_double_matches(match_pair(new_desc, point_descs,
                                           ratio=ratio, device=device))


def match_points_to_keys(point_descs: np.ndarray, new_desc: np.ndarray,
                         ratio: float = 0.6, device="cuda") -> np.ndarray:
    """The reverse direction (`MatchPointsToKeys`,
    `BundlerGeometry.cpp:687-750`): the point descriptors query the new
    image's keys.  Rows are (point, key)."""
    return prune_double_matches(match_pair(point_descs, new_desc,
                                           ratio=ratio, device=device))


def refine_points(points: np.ndarray, projs: np.ndarray, views_pv: list,
                  views_R: list, views_c: list, cam: np.ndarray,
                  R_cam: np.ndarray, device="cuda") -> tuple:
    """Re-triangulate each point from its existing views plus the new
    camera's observation on `device`, then report the RMS reprojection
    error in the new camera (`RefinePoints`, `src/Bundle.cpp:2697-2775`).

    views_pv[i]: [v, 2] NEGATED normalized coords of point i's existing
    views (the reference's ray convention); views_R / views_c: per-view
    [v, 3, 3] / [v, 3].  projs: [N, 2] pixel observations in the new
    camera."""
    n = len(points)
    if n == 0:
        return np.array(points, copy=True), 0.0
    f = cam[6]
    counts = np.array([len(v) + 1 for v in views_pv])
    M = int(counts.max())
    pv = np.zeros((n, M, 2))
    Rs = np.broadcast_to(np.eye(3), (n, M, 3, 3)).copy()
    cs = np.zeros((n, M, 3))
    mask = np.zeros((n, M), bool)
    for i in range(n):
        v = len(views_pv[i])
        pv[i, :v] = views_pv[i]
        pv[i, v] = -projs[i] / f
        Rs[i, :v] = views_R[i]
        Rs[i, v] = R_cam
        cs[i, :v] = views_c[i]
        cs[i, v] = cam[0:3]
        mask[i, :v + 1] = True
    ts = np.einsum("pvij,pvj->pvi", Rs, -cs)
    dev = resolve_device(device)
    X, _ = triangulate_tracks(*(torch.as_tensor(a, device=dev)
                                for a in (pv, Rs, ts, mask)), 5)
    out = X.cpu().numpy()
    # RMS reprojection error in the NEW camera (the value RefinePoints
    # reports, src/Bundle.cpp:2750-2771).
    q = np.einsum("ij,pj->pi", R_cam, out - cam[0:3])
    u = -f * q[:, 0:2] / q[:, 2:3]
    rsq = np.sum(u * u, axis=1) / (f * f)
    u = u * (1.0 + cam[7] * rsq + cam[8] * rsq * rsq)[:, None]
    errs = ((u - projs) ** 2).sum(axis=1)
    return out, float(np.sqrt(errs.mean()))


def refine_camera_and_points(scene, cam0: np.ndarray, R0: np.ndarray,
                             points: np.ndarray, projs: np.ndarray,
                             views_pv: list, views_R: list, views_c: list,
                             adjust_focal: bool = True, max_rounds: int = 4,
                             error_tol: float = 1e-3, device="cuda") -> tuple:
    """Alternate single-camera refinement and point re-triangulation until
    the error stops improving (`RefineCameraAndPoints`,
    `src/Bundle.cpp:2777-2884`).  Returns (cam, R, points, inlier_idx)."""
    cam, R = np.array(cam0, copy=True), np.array(R0, copy=True)
    pts = np.array(points, copy=True)
    error_old = np.inf
    inl = np.arange(len(pts))
    for _ in range(max_rounds):
        cam, R, inl_local = refine_camera_iterative(
            scene, 0, cam, R, pts[inl], projs[inl], adjust_focal,
            device=device)
        inl = inl[inl_local]
        if len(inl) < 6:
            break
        new_pts, error = refine_points(
            pts[inl], projs[inl], [views_pv[i] for i in inl],
            [views_R[i] for i in inl], [views_c[i] for i in inl], cam, R,
            device=device)
        pts[inl] = new_pts
        if error_old - error < error_tol:
            break
        error_old = error
    return cam, R, pts, inl

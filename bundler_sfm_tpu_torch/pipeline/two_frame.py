"""Two-frame models and camera covariance; port of
`bundler_sfm_tpu/pipeline/two_frame.py`.

Reference `src/TwoFrameModel.h:36-110` / `src/BundleTwo.cpp`
(`BundleTwoFrame` `:491` — a two-camera reconstruction per image pair used
for pair scoring and relative-pose export — and `ComputeCameraCovariance`
`:1748-1990`, which re-bundles with point constraints and reads the camera
covariance off the Schur complement).

A TwoFrameModel comes from the same stack as the main loop: 5-point init →
two-view triangulation → 2-camera Schur-LM, on `scene.device`.  Covariance
is the inverse of the converged (undamped) reduced camera system S — the
block SBA exports as Sout — through one f64 Cholesky factorisation on the
problem's device.

The RANSAC draws come from `sampler(stage, seed, n_valid, num_rounds,
sample_size)` -> int64 [1, num_rounds, sample_size], the protocol of
`pipeline/incremental.py`: "fivepoint" (`bundle_two_frame`, its seed),
"ematrix" (`estimate_relative_pose`, its seed) and "homography" (seed + 1).
The default draws from a `torch.Generator` seeded with the stage's seed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from bundler_sfm_tpu_torch.ops.ba import (
    CNP, BAProblem, assemble_schur, build_normal_blocks, build_problem,
    run_ba,
)
from bundler_sfm_tpu_torch.ops.essential import (
    decompose_essential_multipt, pose_to_center,
)
from bundler_sfm_tpu_torch.ops.fivepoint import estimate_pose_5point
from bundler_sfm_tpu_torch.ops.fmatrix import estimate_ematrix, fmatrix_residual
from bundler_sfm_tpu_torch.ops.homography import estimate_homography_ransac
from bundler_sfm_tpu_torch.ops.homography_decompose import (
    decompose_homography, fundamental_from_pose, homography_pixel_to_ray,
)
from bundler_sfm_tpu_torch.ops.linalg_small import inv3
from bundler_sfm_tpu_torch.ops.triangulate import triangulate_two_view
from bundler_sfm_tpu_torch.pipeline.incremental import StageSampler
from bundler_sfm_tpu_torch.pipeline.scene import Scene
from bundler_sfm_tpu_torch.pipeline.tracks import matches_from_tracks
from bundler_sfm_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TwoFrameModel:
    """Pairwise reconstruction (fields of `src/TwoFrameModel.h:81-91`)."""
    num_points: int
    points: np.ndarray          # [n,3]
    keys1: np.ndarray           # [n]
    keys2: np.ndarray           # [n]
    R0: np.ndarray              # camera 0 (identity frame)
    c0: np.ndarray
    f0: float
    R1: np.ndarray
    c1: np.ndarray
    f1: float
    C0: np.ndarray              # [3,3] camera-0 position covariance
    C1: np.ndarray              # [3,3] camera-1 position covariance
    angle: float                # median triangulation angle (degrees)
    error: float                # mean reprojection error

    def write(self, f) -> None:
        """Text serialization compatible in spirit with
        `TwoFrameModel::Write` (`src/TwoFrameModel.cpp:137-168`)."""
        f.write(f"{self.num_points}\n{self.angle:0.9f}\n{self.error:0.9f}\n")
        for i in range(self.num_points):
            p = self.points[i]
            f.write(f"-1 {self.keys1[i]} {self.keys2[i]} "
                    f"{p[0]:0.16e} {p[1]:0.16e} {p[2]:0.16e}\n")
        for R, c, fo in ((self.R0, self.c0, self.f0),
                         (self.R1, self.c1, self.f1)):
            t = -R @ c
            f.write(f"{fo:0.9f}\n")
            f.write(" ".join(f"{v:0.16e}" for v in R.reshape(-1)) + "\n")
            f.write(" ".join(f"{v:0.16e}" for v in t) + "\n")
        for C in (self.C0, self.C1):
            f.write(" ".join(f"{v:0.16e}" for v in C.reshape(-1)) + "\n")


ModelTable = Dict[Tuple[int, int], TwoFrameModel]


def camera_covariance(prob: BAProblem, cam: torch.Tensor, pts: torch.Tensor,
                      pt_constraint_weight: float = 1.0) -> np.ndarray:
    """Covariance of camera parameters at a solution: inv(S) of the
    UNDAMPED reduced camera system (role of `ComputeCameraCovariance`,
    `src/BundleTwo.cpp:1748-1990`), on the problem's device.

    The reference fixes the gauge by re-bundling with POINT CONSTRAINTS at
    the converged structure before reading off S — same here: a quadratic
    prior anchoring every point makes S positive definite without biasing
    the camera blocks; frozen parameters get 1 on U's diagonal.  Returns
    [C*9, C*9] (host f64)."""
    anchored = prob._replace(
        pt_constrained=torch.ones_like(pts[:, 0]),
        pt_constraints=pts,
        pt_weight=float(pt_constraint_weight),
        # Covariance must come out in RAW parameter units, not the LM's
        # scaled q-space — disable f/k column scaling for this solve.
        cam_scale=torch.ones_like(prob.cam_scale))
    U, V, W, g_c, g_p, _ = build_normal_blocks(cam, pts, anchored, False)
    U_aug = U + torch.diag_embed(1.0 - prob.cam_mask)
    eye = torch.eye(3, dtype=V.dtype, device=V.device)
    Vinv = inv3(V + 1e-12 * eye)
    Y = (W[:, :, :, None] * Vinv[anchored.obs_pt][:, None, :, :]).sum(2)
    S, _ = assemble_schur(U_aug, Y, W, g_c, g_p, anchored)
    # inv(S) with S SPD: one Cholesky factorisation in f64.
    cov = torch.cholesky_inverse(torch.linalg.cholesky(S))
    return (0.5 * (cov + cov.T)).cpu().numpy()


def _draw(sampler, stage, seed, n, rounds, k, dev) -> torch.Tensor:
    """One problem's [rounds, k] draw from the sampler, on `dev`."""
    return sampler(stage, seed, torch.tensor([n]), rounds, k)[0].to(dev)


def bundle_two_frame(scene: Scene, i1: int, i2: int, seed: int = 0,
                     sampler: Callable = None) -> Optional[TwoFrameModel]:
    """`BundleTwoFrame` (`src/BundleTwo.cpp:491`): full two-camera
    reconstruction of a pair from its shared tracks, on `scene.device`."""
    cfg = scene.config
    dev = resolve_device(scene.device)
    sampler = sampler or StageSampler(dev)
    pair_matches = matches_from_tracks(scene.tracks, i1, i2)
    if len(pair_matches) < cfg.min_max_matches:
        return None
    f1 = scene.init_focal(i1) or cfg.init_focal_length
    f2 = scene.init_focal(i2) or cfg.init_focal_length
    x1 = scene.key_xy[i1][pair_matches[:, 0]]
    x2 = scene.key_xy[i2][pair_matches[:, 1]]
    n = len(pair_matches)
    t1 = torch.as_tensor(x1, dtype=torch.float64, device=dev)
    t2 = torch.as_tensor(x2, dtype=torch.float64, device=dev)
    samples = _draw(sampler, "fivepoint", seed, n, cfg.fivepoint_rounds, 5,
                    dev)
    R, t, _, ok = estimate_pose_5point(samples, t1, t2, n, f1, f2,
                                       0.25 * cfg.fmatrix_threshold)
    if not bool(ok):
        return None
    R1 = R.cpu().numpy()
    c1 = pose_to_center(R, t).cpu().numpy()
    R0 = np.eye(3)
    c0 = np.zeros(3)

    # Triangulate all matches; keep those under the projection threshold.
    def T(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)
    X, err = triangulate_two_view(T(-x1 / f1), T(-x2 / f2), T(R0),
                                  T(-R0 @ c0), T(R1), T(-R1 @ c1))
    X, err = X.cpu().numpy(), err.cpu().numpy()
    keep = ~(err * 0.5 * (f1 + f2) > cfg.projection_estimation_threshold)
    if keep.sum() < cfg.min_max_matches:
        return None
    pts = X[keep]
    k1s = pair_matches[keep, 0].astype(int)
    k2s = pair_matches[keep, 1].astype(int)
    r1 = pts - c0
    r2 = pts - c1
    d = (r1 * r2).sum(1) / np.maximum(
        np.linalg.norm(r1, axis=1) * np.linalg.norm(r2, axis=1), 1e-12)
    angles = np.degrees(np.arccos(np.clip(d, -1, 1)))

    # Two-camera bundle.
    obs_cam = np.concatenate([np.zeros(len(pts), np.int32),
                              np.ones(len(pts), np.int32)])
    obs_pt = np.concatenate([np.arange(len(pts), dtype=np.int32)] * 2)
    obs_xy = np.concatenate([scene.key_xy[i1][k1s], scene.key_xy[i2][k2s]])
    cam0 = np.zeros((2, CNP))
    cam0[0, 0:3] = c0
    cam0[0, 6] = f1
    cam0[1, 0:3] = c1
    cam0[1, 6] = f2
    prob = build_problem(np.stack([R0, R1]), cam0, pts, obs_cam, obs_pt,
                         obs_xy, est_focal=not cfg.fixed_focal_length,
                         est_distortion=cfg.estimate_distortion, device=dev)
    res = run_ba(prob, max_iters=cfg.sfm_max_iters)
    cam = res.cam.cpu().numpy()
    Rf = res.R.cpu().numpy()
    ptsf = res.pts.cpu().numpy()
    err = float(np.sqrt(2 * float(res.cost) / max(len(obs_cam), 1)))

    # run_ba folds w into R and zeroes it — evaluate the covariance with the
    # UPDATED base rotations or the Jacobians are taken at the wrong point.
    cov = camera_covariance(prob._replace(R0=res.R), res.cam, res.pts)
    # Position covariance blocks: params 0:3 of each camera.
    return TwoFrameModel(
        num_points=len(ptsf), points=ptsf, keys1=k1s, keys2=k2s,
        R0=Rf[0], c0=cam[0, 0:3], f0=float(cam[0, 6]),
        R1=Rf[1], c1=cam[1, 0:3], f1=float(cam[1, 6]),
        C0=cov[0:3, 0:3], C1=cov[CNP:CNP + 3, CNP:CNP + 3],
        angle=float(np.median(angles)), error=err)


def estimate_relative_pose(scene: Scene, i1: int, i2: int, seed: int = 0,
                           sampler: Callable = None
                           ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """`EstimateRelativePose` (src/RelativePose.cpp:36-192): E-matrix RANSAC
    (4x fmatrix rounds at threshold²), homography fallback when >= 75% of the
    epipolar inliers fit an H (planar/rotational scenes), E decomposition
    otherwise.  Returns (R, center) of camera i2 in camera i1's frame."""
    cfg = scene.config
    dev = resolve_device(scene.device)
    sampler = sampler or StageSampler(dev)
    pair_matches = matches_from_tracks(scene.tracks, i1, i2)
    if len(pair_matches) < 8:
        return None
    f1 = scene.init_focal(i1) or cfg.init_focal_length
    f2 = scene.init_focal(i2) or cfg.init_focal_length
    x1 = scene.key_xy[i1][pair_matches[:, 0]]
    x2 = scene.key_xy[i2][pair_matches[:, 1]]
    n = len(pair_matches)
    t1 = torch.as_tensor(x1, dtype=torch.float64, device=dev)
    t2 = torch.as_tensor(x2, dtype=torch.float64, device=dev)
    E, _, inl, cnt = estimate_ematrix(
        _draw(sampler, "ematrix", seed, n, 4 * cfg.fmatrix_rounds, 8, dev),
        t1, t2, n, f1, f2, cfg.fmatrix_threshold ** 2)
    if int(cnt) == 0:
        return None
    idx = torch.nonzero(inl)[:, 0]

    # Homography on the epipolar inliers (128 rounds @ 6.0,
    # src/RelativePose.cpp:90-94).
    if len(idx) >= 4:
        m = len(idx)
        H, _, hcnt = estimate_homography_ransac(
            _draw(sampler, "homography", seed + 1, m, 128, 4, dev)[None],
            t1[idx][None], t2[idx][None], torch.tensor([m], device=dev), 6.0)
        if int(hcnt[0]) / max(m, 1) >= 0.75:
            H_ray = homography_pixel_to_ray(H[0].cpu().numpy(), f1, f2)
            # Pick the solution whose F explains more matches
            # (src/RelativePose.cpp:129-162).
            best, best_inl = None, -1
            for R, t, _ in decompose_homography(H_ray):
                Fh = torch.as_tensor(fundamental_from_pose(R, t, f1, f2),
                                     device=dev)
                ninl = int((fmatrix_residual(Fh, t2, t1)
                            < cfg.fmatrix_threshold).sum())
                if ninl > best_inl:
                    best, best_inl = (R, t), ninl
            if best is not None and best_inl > 0:
                R, t = best
                return np.asarray(R), np.asarray(-R.T @ t)

    # Default: decompose E (multi-point cheirality vote).
    R, t, ok = decompose_essential_multipt(E, -t1 / f1, -t2 / f2, inl)
    if not bool(ok):
        return None
    return R.cpu().numpy(), pose_to_center(R, t).cpu().numpy()


def compute_model_table(scene: Scene, seed: int = 0,
                        sampler: Callable = None) -> ModelTable:
    """Two-frame models for every pair sharing enough tracks
    (the models the reference builds for pair scoring / relpose output)."""
    out: ModelTable = {}
    n = scene.num_images
    track_sets = [set(vp) for vp in scene.visible_points]
    for i in range(n):
        for j in range(i + 1, n):
            if len(track_sets[i] & track_sets[j]) < \
                    scene.config.min_max_matches:
                continue
            m = bundle_two_frame(scene, i, j, seed=seed + i * n + j,
                                 sampler=sampler)
            if m is not None:
                out[(i, j)] = m
    return out


def write_relative_poses(path: str, models: ModelTable) -> None:
    """Pairwise relative-pose dump (role of `OutputRelativePoses3D`,
    `src/ProcessBundle.cpp:676`)."""
    with open(path, "w") as f:
        f.write(f"{len(models)}\n")
        for (i, j), m in sorted(models.items()):
            R_rel = m.R1 @ m.R0.T
            t_rel = m.R0 @ (m.c1 - m.c0)
            f.write(f"{i} {j} {m.num_points} {m.angle:0.6f} {m.error:0.6f}\n")
            f.write(" ".join(f"{v:0.9e}" for v in R_rel.reshape(-1)) + "\n")
            f.write(" ".join(f"{v:0.9e}" for v in t_rel) + "\n")


def scene_covariance(bundle, estimate_distortion: bool = True,
                     point_weight: float = 1000.0, device="cuda"):
    """App-level `--compute_covariance` (`BundlerApp::ComputeCameraCovariance`,
    `src/BundleTwo.cpp:1748-2024`): anchor every point at its converged
    position (weight 1000, `:1758`), form the reduced camera Schur system on
    `device`, and return (registered_image_ids, full inv(S), per-camera 3x3
    translation-covariance blocks) — the blocks + their traces are what the
    reference writes to covariance.txt (`:1996-2016`)."""
    dev = resolve_device(device)
    regs = [i for i, c in enumerate(bundle.cameras) if c.registered]
    slot = {img: s for s, img in enumerate(regs)}
    R0 = np.stack([bundle.cameras[i].R for i in regs])
    cam0 = np.zeros((len(regs), 9))
    for s, i in enumerate(regs):
        c = bundle.cameras[i]
        cam0[s, 0:3] = c.center
        cam0[s, 6] = c.f
        cam0[s, 7] = c.k1
        cam0[s, 8] = c.k2
    obs_cam, obs_pt, obs_xy = [], [], []
    pts = np.stack([p.pos for p in bundle.points])
    for pi, p in enumerate(bundle.points):
        for (ci, _ki, x, y) in np.atleast_2d(p.views):
            if int(ci) in slot:
                obs_cam.append(slot[int(ci)])
                obs_pt.append(pi)
                obs_xy.append((x, y))
    prob = build_problem(R0, cam0, pts,
                         np.array(obs_cam, np.int32),
                         np.array(obs_pt, np.int32),
                         np.array(obs_xy, np.float64),
                         est_focal=True, est_distortion=estimate_distortion,
                         device=dev)
    cov = camera_covariance(prob, prob.cam0, prob.pts0,
                            pt_constraint_weight=point_weight)
    blocks = [cov[s * CNP:s * CNP + 3, s * CNP:s * CNP + 3] for s in
              range(len(regs))]
    return regs, cov, blocks


def write_covariance_file(path: str, regs, blocks) -> None:
    """covariance.txt: per registered image `i`, its 3x3 translation
    covariance (row-major) and trace (`src/BundleTwo.cpp:1996-2016`)."""
    with open(path, "w") as f:
        for i, C in zip(regs, blocks):
            f.write(f"{i}\n")
            f.write(" ".join(f"{v:0.6f}" for v in np.asarray(C).ravel()))
            f.write(f"\n{float(np.trace(C)):0.6f}\n")

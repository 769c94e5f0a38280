"""Incremental reconstruction driver — port of
`bundler_sfm_tpu/pipeline/incremental.py`: the `BundleAdjustFast` state
machine (`src/BundleFast.cpp:37-526`) and the one-image-at-a-time
`BundleAdjust` (`bundle_adjust_slow`, --slow_bundle), with the Necker fix,
ignored-camera recovery and panorama points.

  pick initial pair  (`BundlePickInitialPair`, src/Bundle.cpp:1578-1701)
  setup initial pair (`SetupInitialCameraPair`, src/Bundle.cpp:1704-1884)
  run_sfm            (`RunSFM_SBA` + outlier loop, src/Bundle.cpp:568-919)
  while images remain:
    find candidates  (`FindCamerasWithNMatches`)
    register batch   (`BundleInitializeImage`, src/Bundle.cpp:2994-3270)
    triangulate      (`BundleAdjustAddAllNewPoints`, src/BundleAdd.cpp:193-427)
    run_sfm + prune  (`RemoveBadPointsAndCameras`, src/Bundle.cpp:4190-4261)
    dump round outputs

The 5-point RANSAC, two-view and N-view triangulation, resection RANSAC,
camera refinement and bundle adjustment run as tensor programs on
`scene.device` in f64; the host keeps the bookkeeping (which image joins
when, which keys belong to which point) in numpy, as the JAX package does.

The 5-point and resection draws come from `sampler(stage, seed, n_valid,
num_rounds, sample_size)` -> int64 [B, num_rounds, sample_size] for the B
problems with n_valid [B] correspondences; `stage` is "fivepoint" (seed + 101),
"resection" (a batched round, seed + 131·round) or "resection_one" (one image
registered on its own: seed + 31·image in the slow bundle and on resume,
seed + 71·image when ignored cameras are retried, the caller's seed in
`register_image`).  The default, `StageSampler`, draws from a
`torch.Generator` seeded with the stage's seed.

With config.num_devices > 1 (0: every rank of the process group), every
rank of the default process group runs this same driver on the same scene,
and each bundle adjustment is point-sharded over the ranks
(`parallel/ba_sharded.py`).  Every host decision comes from replicated
values (all-reduced BA results, seeded draws), so the ranks take the same
branches; before and after each sharded BA, `Mesh.check_replicated`
compares the ranks' inputs and cameras and raises if they drifted apart.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bundler_sfm_tpu_torch.io.bundlefile import (
    BundleCamera, BundleFile, BundlePoint, write_bundle_file,
)
from bundler_sfm_tpu_torch.io.plyfile import write_points_ply
from bundler_sfm_tpu_torch.ops import ba as ba_ops
from bundler_sfm_tpu_torch.ops.ba import (
    CNP, _slot_within, build_problem, run_ba_outlier_loop,
)
from bundler_sfm_tpu_torch.ops.essential import pose_to_center
from bundler_sfm_tpu_torch.ops.fivepoint import estimate_pose_5point
from bundler_sfm_tpu_torch.ops.lm import camera_refine_trim_batch
from bundler_sfm_tpu_torch.ops.ransac import sample_indices
from bundler_sfm_tpu_torch.ops.resection import find_and_verify_camera
from bundler_sfm_tpu_torch.ops.triangulate import (
    triangulate_tracks_pixels, triangulate_two_view,
)
from bundler_sfm_tpu_torch.parallel import ba_sharded
from bundler_sfm_tpu_torch.parallel.mesh import make_mesh
from bundler_sfm_tpu_torch.pipeline.scene import Scene
from bundler_sfm_tpu_torch.pipeline.tracks import matches_from_tracks
from bundler_sfm_tpu_torch.utils import (
    counter, get_telemetry, resolve_device, stage,
)

INIT_REPROJECTION_ERROR = 16.0   # src/BundleAdd.cpp:43
ADD_REPROJECTION_ERROR = 16.0    # src/BundleAdd.cpp:44
INITIAL_DEPTH = 3.0              # src/Bundle.cpp:1776
# Seed offsets of the 5-point draw and of each registration round's
# resection draw (the JAX package's PRNGKey(seed + 101), seed + 131·round).
FIVEPOINT_SEED_OFFSET = 101
RESECTION_SEED_STRIDE = 131
# Seed strides of the one-image resection draw (the JAX package's
# PRNGKey(seed + 31·img) in the slow bundle / on resume, seed + 71·img in
# estimate_ignored_cameras).
SLOW_SEED_STRIDE = 31
IGNORED_SEED_STRIDE = 71
# Bound on [lanes, rounds, correspondences] entries per resection batch.
_RESECT_ELEMS = 1 << 26


class StageSampler:
    """Default RANSAC draw of the 5-point and resection stages: distinct
    valid indices from a `torch.Generator` on `device`, seeded with the
    stage's seed at each call (so a run is reproducible per device)."""

    def __init__(self, device):
        self.device = torch.device(device)

    def __call__(self, stage_name, seed, n_valid, num_rounds, sample_size):
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        return sample_indices(g, num_rounds, sample_size,
                              n_valid.to(self.device), int(n_valid.max()))


@dataclasses.dataclass
class Reconstruction:
    """Mutable reconstruction state (the arrays BundleAdjustFast carries)."""
    added_order: List[int]                    # cam slot -> image idx
    cam_R: List[np.ndarray]                   # per slot [3,3]
    cam_params: List[np.ndarray]              # per slot [9] (c,0,f,k1,k2)
    points: List[np.ndarray]                  # [3] each
    colors: List[np.ndarray]
    pt_views: List[List[Tuple[int, int]]]     # (cam_slot, key_idx)
    track_extra: np.ndarray                   # [T] -> point idx / -1
    key_extra: List[Dict[int, int]]           # img -> {key: pt | -1 | -2}

    @property
    def num_cameras(self):
        return len(self.added_order)

    @property
    def num_points(self):
        return len(self.points)

    def slot_of_image(self, img: int) -> Optional[int]:
        return self.added_order.index(img) if img in self.added_order \
            else None


def log(msg: str):
    print(msg, flush=True)


def resolve_num_devices(cfg) -> int:
    """config.num_devices with 0 = every rank of the default process group
    (one without a group)."""
    if cfg.num_devices == 0:
        return dist.get_world_size() if dist.is_initialized() else 1
    return max(1, cfg.num_devices)


def _device(scene: Scene) -> torch.device:
    return resolve_device(scene.device)


def _T(x, dev, dtype=torch.float64):
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)


def _np(x) -> np.ndarray:
    return x.cpu().numpy()


# --------------------------------------------------------------------------
# Initial pair
# --------------------------------------------------------------------------

def pick_initial_pair(scene: Scene, use_init_focal_only: bool
                      ) -> Tuple[int, int]:
    """`BundlePickInitialPair` (src/Bundle.cpp:1578-1701): most track-matches
    among pairs whose homography fits badly (score = 1/inlier_ratio > 2);
    shared-track counts from one sparse incidence self-product, pairs in
    row-major order."""
    cfg = scene.config
    if cfg.initial_pair[0] >= 0 and cfg.initial_pair[1] >= 0:
        return cfg.initial_pair
    n = scene.num_images
    SCORE_THRESHOLD = 2.0
    MATCH_THRESHOLD, MIN_SCORE, MIN_MATCHES = 32, 1.0e-1, 80
    best = (-1, -1, 0, 0.0)      # i, j, matches, score
    best2 = (-1, -1, 0, 0.0)
    from scipy import sparse
    eligible = np.ones(n, bool)
    for i in range(n):
        if scene.ignore_in_bundle[i]:
            eligible[i] = False
        elif use_init_focal_only and cfg.use_focal_estimate \
                and not scene.has_init_focal(i):
            eligible[i] = False
    rows = np.concatenate([
        np.full(len(scene.visible_points[i]), i, np.int64)
        for i in range(n)]) if n else np.zeros(0, np.int64)
    cols = np.concatenate([
        np.asarray(scene.visible_points[i], np.int64)
        for i in range(n)]) if n else np.zeros(0, np.int64)
    T = int(cols.max()) + 1 if len(cols) else 1
    V = sparse.csr_matrix(
        (np.ones(len(rows), np.int32), (rows, cols)), shape=(n, T))
    counts = (V @ V.T).toarray()
    counts[~eligible] = 0
    counts[:, ~eligible] = 0
    ii, jj = np.nonzero(np.triu(counts, 1) > MATCH_THRESHOLD)
    for i, j in zip(ii.tolist(), jj.tolist()):
        num_matches = int(counts[i, j])
        ti = scene.transforms.get((i, j))
        ratio = ti.inlier_ratio if ti else 0.0
        score = MIN_SCORE if ratio == 0.0 else 1.0 / ratio
        if num_matches > best[2] and score > SCORE_THRESHOLD:
            best = (i, j, num_matches, score)
        if num_matches > MIN_MATCHES and score > best2[3]:
            best2 = (i, j, num_matches, score)
    if best[0] != -1:
        return best[0], best[1]
    if best2[0] != -1:
        return best2[0], best2[1]
    if use_init_focal_only:
        return pick_initial_pair(scene, False)
    return 0, 1


def _pair_focal(scene: Scene, img: int) -> float:
    cfg = scene.config
    if not cfg.fixed_focal_length and scene.has_init_focal(img):
        return scene.init_focal(img)
    return cfg.init_focal_length


def setup_initial_pair(scene: Scene, i_best: int, j_best: int,
                       seed: int = 0, sampler: Callable = None
                       ) -> Reconstruction:
    """`SetupInitialCameraPair` (src/Bundle.cpp:1704-1884): 5-point RANSAC
    (512 rounds at 0.25·fmatrix_threshold, `EstimateRelativePose2`,
    src/RelativePose.cpp:216-223), then the pair's matches triangulated and
    gated at projection_estimation_threshold px."""
    cfg = scene.config
    dev = _device(scene)
    sampler = sampler or StageSampler(dev)
    f0, f1 = _pair_focal(scene, i_best), _pair_focal(scene, j_best)
    R0, c0 = np.eye(3), np.zeros(3)
    R1, c1 = np.eye(3), np.zeros(3)
    pair_matches = matches_from_tracks(scene.tracks, i_best, j_best)
    n_m = len(pair_matches)
    x1 = _T(scene.key_xy[i_best][pair_matches[:, 0]], dev)
    x2 = _T(scene.key_xy[j_best][pair_matches[:, 1]], dev)

    solved = False
    # A 5-point sample needs five matches; with fewer the pair falls back
    # to the reference's fixed-depth initialization.
    if cfg.factor_essential and scene.has_init_focal(i_best) and \
            scene.has_init_focal(j_best) and not cfg.use_constraints \
            and n_m >= 5:
        with stage("init_5pt"):
            samples = sampler("fivepoint", seed + FIVEPOINT_SEED_OFFSET,
                              torch.tensor([n_m]), cfg.fivepoint_rounds, 5)
            R, t, cnt, ok = estimate_pose_5point(
                samples[0].to(dev), x1, x2, n_m, f0, f1,
                0.25 * cfg.fmatrix_threshold)
            ok = bool(ok)
        if ok:
            R1 = _np(R)
            c1 = _np(pose_to_center(R, t))
            solved = True
            log(f"[SetupInitialCameraPair] 5pt-init: {int(cnt)}/{n_m} inliers")

    recon = Reconstruction(
        added_order=[i_best, j_best], cam_R=[R0, R1],
        cam_params=[np.concatenate([c0, np.zeros(3), [f0], np.zeros(2)]),
                    np.concatenate([c1, np.zeros(3), [f1], np.zeros(2)])],
        points=[], colors=[], pt_views=[],
        track_extra=np.full(len(scene.tracks), -1, dtype=np.int64),
        key_extra=[dict() for _ in range(scene.num_images)])

    if solved and n_m:
        with stage("init_triangulate"):
            Xs, errs = triangulate_two_view(
                -x1 / f0, -x2 / f1, _T(R0, dev), _T(-R0 @ c0, dev),
                _T(R1, dev), _T(-R1 @ c1, dev))
            Xs = _np(Xs)
            # The gate is on the PIXEL error: scale the normalized rms by
            # the mean focal.
            errs = _np(errs) * 0.5 * (f0 + f1)
    for mi, (k1, k2) in enumerate(pair_matches):
        if not solved:
            p = scene.key_xy[i_best][k1]
            X = np.array([(p[0] / cfg.init_focal_length) * INITIAL_DEPTH,
                          (p[1] / cfg.init_focal_length) * INITIAL_DEPTH,
                          INITIAL_DEPTH + c0[2]])
        else:
            if errs[mi] > cfg.projection_estimation_threshold:
                continue
            X = Xs[mi]
        pt_idx = len(recon.points)
        recon.points.append(X)
        recon.colors.append(scene.color_of_key(i_best, int(k1)))
        recon.key_extra[i_best][int(k1)] = pt_idx
        recon.key_extra[j_best][int(k2)] = pt_idx
        tr = scene.key_track[i_best].get(int(k1))
        if tr is not None:
            recon.track_extra[tr] = pt_idx
        recon.pt_views.append([(0, int(k1)), (1, int(k2))])
    log(f"[SetupInitialCameraPair] {len(recon.points)} initial points")
    return recon


# --------------------------------------------------------------------------
# Bundle adjustment with the outlier loop
# --------------------------------------------------------------------------

def _gather_problem(recon: Reconstruction, scene: Scene):
    """vmask/projections marshaling (src/Bundle.cpp:597-637): only points
    with live views enter BA.  Returns (live point ids, (obs_cam, obs_pt,
    obs_xy))."""
    counts = np.fromiter(map(len, recon.pt_views), dtype=np.int64,
                         count=len(recon.pt_views))
    live = np.nonzero(counts > 0)[0]
    total = int(counts[live].sum())
    flat = np.fromiter(
        itertools.chain.from_iterable(
            itertools.chain.from_iterable(recon.pt_views[p] for p in live)),
        dtype=np.int64, count=2 * total).reshape(-1, 2)
    obs_cam = flat[:, 0]
    keys = flat[:, 1]
    obs_pt = np.repeat(np.arange(len(live), dtype=np.int64), counts[live])
    img_of_obs = np.asarray(recon.added_order, dtype=np.int64)[obs_cam]
    obs_xy = np.empty((total, 2), dtype=np.float64)
    for img in np.unique(img_of_obs):
        sel = img_of_obs == img
        obs_xy[sel] = scene.key_xy[img][keys[sel]]
    return [int(p) for p in live], (obs_cam, obs_pt, obs_xy)


def _cap_slot_views(obs_cam, obs_pt, obs_xy, num_points,
                    waste_factor: float = 4.0, min_cap: int = 32):
    """The JAX package's per-round decimation of very long tracks: when
    num_points·(longest track) exceeds waste_factor·O, points with more
    views than cap = max(min_cap, ceil(waste_factor·O / num_points))
    (rounded up to 4) keep exactly `cap` evenly spaced views for this BA
    round.  It changes which observations enter BA, so the port keeps it
    for parity; it never fires below 33 views per track."""
    counts = np.bincount(obs_pt, minlength=num_points)
    M = int(counts.max()) if len(obs_pt) else 1
    O = len(obs_pt)
    if M <= min_cap or num_points * M <= waste_factor * O:
        return obs_cam, obs_pt, obs_xy
    cap = max(min_cap, int(np.ceil(waste_factor * O / num_points)))
    cap = -(-min(cap, M) // 4) * 4
    if cap >= M:
        return obs_cam, obs_pt, obs_xy
    within = _slot_within(obs_pt)
    cnt = counts[obs_pt]
    keep = (cnt <= cap) | (((within + 1) * cap) // cnt
                           > (within * cap) // cnt)
    get_telemetry().add("ba_views_capped", float(np.sum(~keep)))
    return obs_cam[keep], obs_pt[keep], obs_xy[keep]


def _bucket(n: int, lo: int) -> int:
    """The JAX package's power-of-two shape bucket (`_bucket`): its
    run_sfm hands the window planner the camera and view counts bucketed
    this way, and the port plans on the same counts so that both packages
    plan alike (windows from C >= 129, where _bucket(C, 8) reaches 192)."""
    b = lo
    while b < n:
        b *= 2
    return b


def run_sfm(recon: Reconstruction, scene: Scene,
            remove_outliers: bool = True, fix_points: bool = False,
            verbose: bool = True,
            pt_constraints: Optional[Dict[int, np.ndarray]] = None,
            pt_weight: float = 0.0) -> float:
    """`RunSFM_SBA` with the >40-outlier re-bundle loop
    (src/Bundle.cpp:568-919) on `scene.device`.  `pt_constraints` maps a
    point index to its anchor position, weighted by `pt_weight`
    (--point_constraint_file, src/BundleIO.cpp:1241-1290); anchored points
    are never removed as outliers.  The problem is marshaled
    once per call of the outlier loop, and the removal bookkeeping applied
    once; the host re-enters only if the loop hit its pass cap with
    outliers still above the floor.  The covisibility-window plan of the
    Schur assembly is made where and as the JAX package makes it
    (`ops.ba.plan_schur_windows` on the bucketed camera and view counts,
    counter `ba_schur_windowed`), on both branches; the one-device problem
    keeps the live points' order, the sharded one lays whole groups out
    with `plan_shard_windows`.  Returns the final mean reprojection error
    (inf when too few points remain)."""
    cfg = scene.config
    dev = _device(scene)
    MIN_POINTS, MIN_OUTLIERS = cfg.sfm_min_points, cfg.sfm_min_outliers
    MAX_PASSES = 8
    while True:
        live, (obs_cam, obs_pt, obs_xy) = _gather_problem(recon, scene)
        if len(live) < MIN_POINTS:
            log("[RunSFM] Too few points remaining, exiting!")
            return float("inf")
        obs_cam, obs_pt, obs_xy = _cap_slot_views(obs_cam, obs_pt, obs_xy,
                                                  len(live))
        C = recon.num_cameras
        # Focal / distortion priors (SetCameraConstraints, src/Bundle.cpp:
        # 921-988); the Ceres backend scales them by each camera's
        # visibility count (src/BundleCeres.cpp:300-323).
        num_vis = np.bincount(obs_cam, minlength=C)
        cc = np.zeros((C, CNP)); ct = np.zeros((C, CNP)); cw = np.zeros((C, CNP))
        for s in range(C):
            img = recon.added_order[s]
            if cfg.constrain_focal and scene.has_init_focal(img):
                cc[s, 6] = 1.0
                ct[s, 6] = scene.init_focal(img)
                cw[s, 6] = (cfg.constrain_focal_weight * num_vis[s]
                            if cfg.use_ceres else cfg.constrain_focal_weight)
            if cfg.estimate_distortion:
                cc[s, 7:9] = 1.0
                cw[s, 7:9] = (1e-4 * cfg.distortion_weight * num_vis[s]
                              if cfg.use_ceres else cfg.distortion_weight)
        pc_arr = pc_con = None
        if pt_constraints:
            pc_arr = np.zeros(len(live))
            pc_con = np.zeros((len(live), 3))
            for k, p in enumerate(live):
                anchor = pt_constraints.get(p)
                if anchor is not None:
                    pc_arr[k] = 1.0
                    pc_con[k] = anchor
        solver, loss = "cholesky", "l2"
        if cfg.use_ceres:
            solver = "cholesky" if C <= cfg.ceres_dense_max_cameras else "cg"
            loss = "huber"
        R0, cam0 = np.stack(recon.cam_R), np.stack(recon.cam_params)
        pts0 = np.stack([recon.points[p] for p in live])
        ba_kw = dict(
            max_iters=cfg.sfm_max_iters, fix_points=fix_points,
            tau=cfg.sfm_mu0_tau, eps1=cfg.sfm_eps1, eps2=cfg.sfm_eps2,
            loss=loss, huber_param=cfg.ceres_huber_param, solver=solver,
            outlier_factor=1.2 * cfg.outlier_num_stddev,
            min_thresh=cfg.min_proj_error_threshold,
            max_thresh=cfg.max_proj_error_threshold,
            min_outliers=MIN_OUTLIERS, min_points=MIN_POINTS,
            max_passes=MAX_PASSES, remove_outliers=remove_outliers)
        prob_kw = dict(
            est_focal=not cfg.fixed_focal_length,
            est_distortion=cfg.estimate_distortion,
            cam_constrained=cc, cam_constraints=ct, cam_weights=cw,
            pt_constrained=pc_arr, pt_constraints=pc_con,
            pt_weight=pt_weight if pt_constraints else 0.0)
        # Covisibility-windowed Schur assembly at high camera counts (the
        # full-C product is (C·9)²·3 multiply-adds a point an iteration).
        plan = ba_ops.plan_schur_windows(
            obs_cam, obs_pt, len(live), _bucket(C, 8),
            _bucket(int(np.bincount(obs_pt).max()), 8))
        win = {} if plan is None else dict(window=plan[2],
                                           group_pts=plan[3])
        if plan is not None:
            counter("ba_schur_windowed")
        D = resolve_num_devices(cfg)
        if D > 1:
            # Points and their observations sharded over the ranks, cameras
            # replicated (the JAX package's run_sfm D > 1 branch); with a
            # plan, whole point groups go to each rank.
            mesh = make_mesh(D, device=dev)
            mesh.check_replicated("BA inputs", R0, cam0, pts0, obs_cam,
                                  obs_pt, obs_xy, cw)
            layout = {}
            if plan is not None:
                shard_of, local_of, sw_local, _ = \
                    ba_sharded.plan_shard_windows(*plan, D)
                layout = dict(shard_of_pt=shard_of, local_idx=local_of,
                              schur_win_local=sw_local, **win)
            prob = ba_sharded.shard_problem(
                R0, cam0, pts0, obs_cam, obs_pt, obs_xy, mesh, **layout,
                **prob_kw)
            cam_obs = ba_sharded.build_cam_obs_table_sharded(
                obs_cam, obs_pt, mesh, C,
                shard_of_pt=layout.get("shard_of_pt"))
            with stage("ba"):
                res = ba_sharded.run_ba_outlier_loop_sharded(
                    prob, cam_obs, mesh, **win, **ba_kw)
                cam, Rf = _np(res.cam), _np(res.R)
                if plan is None:
                    pts = ba_sharded.unshard_points(res.pts, mesh, len(live))
                    removed = ba_sharded.unshard_flat(res.pt_removed, mesh,
                                                      len(live))
                else:
                    pts, removed = (ba_sharded.unshard_with_map(
                        x, mesh, shard_of, local_of)
                        for x in (res.pts, res.pt_removed))
            mesh.check_replicated("cameras after BA", cam, Rf)
        else:
            prob = build_problem(R0, cam0, pts0, obs_cam, obs_pt, obs_xy,
                                 schur_plan=plan, device=dev, **prob_kw)
            with stage("ba"):
                res = run_ba_outlier_loop(prob, **win, **ba_kw)
                cam, Rf, pts = _np(res.cam), _np(res.R), _np(res.pts)
                removed = _np(res.pt_removed)
        counter("ba_observations", float(len(obs_cam)) * float(res.iters))
        for s in range(C):
            recon.cam_params[s] = cam[s]
            recon.cam_R[s] = Rf[s]
        for k, p in enumerate(live):
            recon.points[p] = pts[k]

        if verbose:
            stats, hist = _np(res.stats), _np(res.hist)
            edges2 = _np(res.hist_edges)
            for pi in range(res.passes):
                for s in range(C):
                    n, mean, p80, thresh = stats[pi, s]
                    if n <= 0:
                        continue
                    log(f"[RunSFM] cam {s}: {int(n)} obs, mean "
                        f"{mean:.3f}, p80 {p80:.3f}, thresh {thresh:.3f}")
                    # 10-bin error histogram (src/Bundle.cpp:823-846).
                    pr_min, pr_max = edges2[pi, s]
                    step = (pr_max - pr_min) / 10.0
                    for b in range(10):
                        hi = pr_min + step * (b + 1)
                        log(f"   E[{hi - step:0.3e}--{hi:0.3e}]: "
                            f"{int(hist[pi, s, b])} "
                            f"[{hist[pi, s, b] / n:0.3f}]")
                if remove_outliers:
                    log(f"[RunSFM] Removing {int(res.n_outliers[pi])} "
                        f"outliers (pass {pi + 1})")
            log(f"[RunSFM] {res.passes} passes, {res.iters} LM iters, "
                f"cost {float(res.initial_cost):.1f} -> "
                f"{float(res.cost):.1f}")
        avg_dist = float(res.avg_dist)
        if not remove_outliers:
            return avg_dist
        for k in np.nonzero(removed)[0]:
            p = live[k]
            for (slot, key) in recon.pt_views[p]:
                recon.key_extra[recon.added_order[slot]][key] = -2
            recon.pt_views[p] = []
            recon.colors[p] = np.array([0.0, 0.0, 255.0])
        if res.too_few:
            log("[RunSFM] Too few points remaining, exiting!")
            return float("inf")
        if res.passes < MAX_PASSES or \
                int(res.n_outliers[res.passes - 1]) <= MIN_OUTLIERS:
            return avg_dist


# --------------------------------------------------------------------------
# Camera registration
# --------------------------------------------------------------------------

def fix_necker_reversal(recon: Reconstruction, scene: Scene) -> None:
    """Necker-reversal handling after the initial two-camera bundle
    (--fix_necker; src/BundleFast.cpp:126-214, src/Bundle.cpp:2160-2240):
    swap the two cameras' poses, reset their focals to the initial guesses
    and distortion to zero, re-triangulate every point from the swapped pair
    on `scene.device`, and re-bundle.  The reference commits to the flipped
    configuration unconditionally (the error0/error1 restore is compiled
    out, BundleFast.cpp:202-213)."""
    assert recon.num_cameras == 2
    dev = _device(scene)
    i_best, j_best = recon.added_order
    f0, f1 = _pair_focal(scene, i_best), _pair_focal(scene, j_best)
    # Swap poses; reset intrinsics (BundleFast.cpp:137-147).
    R0, R1 = recon.cam_R[1].copy(), recon.cam_R[0].copy()
    c0, c1 = recon.cam_params[1][0:3].copy(), recon.cam_params[0][0:3].copy()
    recon.cam_R[0], recon.cam_R[1] = R0, R1
    recon.cam_params[0] = np.concatenate([c0, np.zeros(3), [f0], np.zeros(2)])
    recon.cam_params[1] = np.concatenate([c1, np.zeros(3), [f1], np.zeros(2)])

    # Re-triangulate each live point from its two views (:158-196) as one
    # batched call: both views are the two swapped cameras.
    todo = [p for p in range(len(recon.points))
            if len(recon.pt_views[p]) >= 2]
    if todo:
        p_all = np.zeros((len(todo), 2))
        q_all = np.zeros((len(todo), 2))
        for mi, p in enumerate(todo):
            (s1, k1), (s2, k2) = recon.pt_views[p][0], recon.pt_views[p][1]
            assert (s1, s2) == (0, 1)
            p_all[mi] = scene.key_xy[recon.added_order[s1]][k1]
            q_all[mi] = scene.key_xy[recon.added_order[s2]][k2]
        Xs, _ = triangulate_two_view(
            -_T(p_all, dev) / f0, -_T(q_all, dev) / f1, _T(R0, dev),
            _T(-R0 @ c0, dev), _T(R1, dev), _T(-R1 @ c1, dev))
        Xs = _np(Xs)
        for mi, p in enumerate(todo):
            recon.points[p] = Xs[mi]

    log("[FixNecker] Re-bundling the reversed configuration")
    run_sfm(recon, scene)


def find_candidate_images(recon: Reconstruction, scene: Scene
                          ) -> Dict[int, int]:
    """#existing 3D points seen by each unregistered image
    (`FindCamerasWithNMatches`, src/Bundle.cpp:1437-1570)."""
    counts: Dict[int, int] = {}
    registered = set(recon.added_order)
    for i in range(scene.num_images):
        if i in registered or scene.ignore_in_bundle[i]:
            continue
        if scene.config.only_bundle_init_focal and not scene.has_init_focal(i):
            continue
        cnt = 0
        for tr in scene.visible_points[i]:
            pt = recon.track_extra[tr]
            if pt >= 0 and len(recon.pt_views[pt]) > 0:
                cnt += 1
        counts[i] = cnt
    return counts


def find_camera_with_most_connectivity(recon: Reconstruction, scene: Scene,
                                       frontier_min_matches: int = 32
                                       ) -> Tuple[int, int]:
    """Next-image selection that maximizes frontier growth
    (`FindCameraWithMostConnectivity`, src/Bundle.cpp:1209-1434, selected by
    --construct_max_connectivity): among unregistered images seeing enough
    existing points (>= max(32, 0.2·max_seen)), the one whose addition would
    put the most new images onto the frontier (> 32 shared tracks); ties go
    to more points seen, then to the lower image index.  Returns (image,
    num_existing_matches) or (-1, 0)."""
    registered = set(recon.added_order)
    n = scene.num_images
    visible = [set(v) for v in scene.visible_points]

    def shared_tracks(i, j):
        return sum(1 for t in scene.visible_points[j] if t in visible[i])

    frontier = [False] * n
    for i in recon.added_order:
        frontier[i] = True
        for j in range(n):
            if j != i and not frontier[j] and \
                    shared_tracks(i, j) > frontier_min_matches:
                frontier[j] = True

    seen_scores, frontier_scores = {}, {}
    for i in range(n):
        if i in registered or scene.ignore_in_bundle[i]:
            continue
        if scene.config.only_bundle_init_focal and not scene.has_init_focal(i):
            continue
        seen = set()
        for tr in scene.visible_points[i]:
            pt = recon.track_extra[tr]
            if pt >= 0 and len(recon.pt_views[pt]) > 0:
                seen.add(int(pt))
        seen_scores[i] = len(seen)
        frontier_scores[i] = sum(
            1 for j in range(n) if not frontier[j] and j != i
            and shared_tracks(i, j) > frontier_min_matches)
    if not seen_scores:
        return -1, 0
    max_seen = max(seen_scores.values())
    if max_seen == 0:
        return -1, 0
    i_best, top = -1, (-1, -1)
    for i, seen in seen_scores.items():
        if seen < 0.20 * max_seen or seen < 32:
            continue
        score = (frontier_scores[i], seen)
        if score > top:
            i_best, top = i, score
    if i_best == -1:
        return -1, 0
    return i_best, seen_scores[i_best]


def refine_camera_iterative(scene, img: int, cam0: np.ndarray,
                            R0: np.ndarray, pts: np.ndarray,
                            projs: np.ndarray, adjust_focal: bool,
                            device="cuda"
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """`RefineCameraParameters` (src/Bundle.cpp:2535-2694) for one camera:
    repeat {camera refine, drop observations with error above
    clamp(2.4·p95, 8, 16)} until the inlier set is stable, as a batch of one
    of `camera_refine_trim_batch` on `device`.  `scene` needs only `config`,
    `has_init_focal` and `init_focal`.  Returns (cam, R, inlier indices)."""
    cfg = scene.config
    dev = resolve_device(device)
    n = len(pts)
    fw = cfg.constrain_focal_weight if (cfg.constrain_focal and
                                        scene.has_init_focal(img)) else 0.0
    fc = scene.init_focal(img) if fw > 0 else 0.0
    cam, R, mask = camera_refine_trim_batch(
        _T(cam0[None], dev), _T(R0[None], dev), _T(pts[None], dev),
        _T(projs[None], dev), torch.ones((1, n), dtype=torch.bool, device=dev),
        adjust_focal, cfg.estimate_distortion, _T([fc], dev), _T([fw], dev),
        cfg.distortion_weight, 50, 1e-3, cfg.outlier_num_stddev,
        cfg.min_proj_error_threshold, cfg.max_proj_error_threshold)
    return _np(cam[0]), _np(R[0]), np.nonzero(_np(mask[0]))[0]


def _existing_points(recon: Reconstruction, scene: Scene, img: int):
    """The existing 3D points image `img` sees through its tracks, with
    their keys: dict(img, pts3 [n,3], projs [n,2], pt_idx, keys), or None
    (logged) when fewer than min_max_matches."""
    pts3, projs, pt_idx, keys = [], [], [], []
    for tr, key in zip(scene.visible_points[img], scene.visible_keys[img]):
        pt = recon.track_extra[tr]
        if pt < 0 or len(recon.pt_views[pt]) == 0:
            continue
        pts3.append(recon.points[pt])
        projs.append(scene.key_xy[img][key])
        pt_idx.append(pt)
        keys.append(key)
    if len(pts3) < scene.config.min_max_matches:
        log(f"[BundleInitializeImage] {img}: too few matches")
        return None
    return dict(img=img, pts3=np.stack(pts3), projs=np.stack(projs),
                pt_idx=pt_idx, keys=keys)


def _resect(samples, X, x, nv, thr, weak_thr):
    """find_and_verify_camera over candidate lanes, in chunks that bound
    the [lanes, rounds, correspondences] scoring tensors."""
    B, pad = X.shape[0], X.shape[1]
    ch = max(1, _RESECT_ELEMS // max(samples.shape[1] * pad, 1))
    parts = [find_and_verify_camera(samples[s:s + ch], X[s:s + ch],
                                    x[s:s + ch], nv[s:s + ch], thr, weak_thr)
             for s in range(0, B, ch)]
    return type(parts[0])(*(torch.cat(f) for f in zip(*parts)))


def bundle_initialize_images(recon: Reconstruction, scene: Scene,
                             imgs: Sequence[int], seed: int,
                             sampler: Callable = None) -> List[int]:
    """`BundleInitializeImage` for one registration round's candidates as
    one batched resection RANSAC and one lockstep refine-and-trim program
    (the reference registers them one at a time, src/BundleFast.cpp:
    300-336).  Returns the images that registered (cameras appended in that
    order); failures are the caller's to mark ignored."""
    cfg = scene.config
    dev = _device(scene)
    sampler = sampler or StageSampler(dev)
    cands = []
    for img in imgs:
        cand = _existing_points(recon, scene, img)
        if cand is not None:
            cands.append(cand)
    if not cands:
        return []

    B = len(cands)
    pad = max(len(c["pts3"]) for c in cands)
    Xp = np.zeros((B, pad, 3))
    xp = np.zeros((B, pad, 2))
    nv = np.zeros(B, np.int64)
    for b, c in enumerate(cands):
        n = len(c["pts3"])
        Xp[b, :n] = c["pts3"]
        xp[b, :n] = c["projs"]
        nv[b] = n
    X_d, x_d, nv_d = _T(Xp, dev), _T(xp, dev), _T(nv, dev, torch.int64)
    with stage("resection"):
        samples = sampler("resection", seed, torch.from_numpy(nv),
                          cfg.projection_rounds, 6).to(dev)
        ver = _resect(samples, X_d, x_d, nv_d,
                      cfg.projection_estimation_threshold,
                      16.0 * cfg.projection_estimation_threshold)
        ok, Ks, Rs, ts, weak = (_np(v) for v in (
            ver.ok, ver.K, ver.R, ver.t, ver.inliers_weak))

    live = []
    cam0 = np.zeros((B, CNP))
    R0 = np.tile(np.eye(3), (B, 1, 1))
    fcs = np.zeros(B)
    fws = np.zeros(B)
    for b, c in enumerate(cands):
        img = c["img"]
        if not ok[b]:
            log(f"[BundleInitializeImage] {img}: pose estimation failed")
            continue
        if not weak[b, :nv[b]].any():
            continue
        K, R, t = Ks[b], Rs[b], ts[b]
        cam0[b, 0:3] = -R.T @ t
        cam0[b, 6] = _init_focal(scene, img, K)
        R0[b] = R
        if cfg.constrain_focal and scene.has_init_focal(img):
            fcs[b] = scene.init_focal(img)
            fws[b] = cfg.constrain_focal_weight
        live.append(b)
    if not live:
        return []

    # Refine and trim (first pass focal-fixed, then refine + p95 trim until
    # stable) over the live lanes at once.
    L = np.asarray(live)
    with stage("refine_camera"):
        cam, R, masks = camera_refine_trim_batch(
            _T(cam0[L], dev), _T(R0[L], dev), X_d[L], x_d[L],
            _T(weak[L], dev, torch.bool), not cfg.fixed_focal_length,
            cfg.estimate_distortion, _T(fcs[L], dev), _T(fws[L], dev),
            cfg.distortion_weight, 50, 1e-3, cfg.outlier_num_stddev,
            cfg.min_proj_error_threshold, cfg.max_proj_error_threshold)
        cam, R, masks = _np(cam), _np(R), _np(masks)

    registered = []
    for li, b in enumerate(live):
        c = cands[b]
        img = c["img"]
        inl = np.nonzero(masks[li, :nv[b]])[0]
        width = scene.dims[img][0]
        if len(inl) < 8 or cam[li, 6] < 0.1 * width:
            log(f"[BundleInitializeImage] {img}: bad camera "
                f"({len(inl)} inliers, f={cam[li, 6]:.1f})")
            continue
        cam_slot = recon.num_cameras
        for i in inl:
            recon.key_extra[img][c["keys"][i]] = c["pt_idx"][i]
            recon.pt_views[c["pt_idx"][i]].append((cam_slot, c["keys"][i]))
        recon.added_order.append(img)
        recon.cam_R.append(R[li])
        recon.cam_params.append(cam[li])
        counter("images_registered")
        log(f"[BundleInitializeImage] {img}: registered with {len(inl)} "
            f"points, f={cam[li, 6]:.2f}")
        registered.append(img)
    return registered


def _init_focal(scene: Scene, img: int, K: np.ndarray) -> float:
    """Focal initialization of a resected camera (src/Bundle.cpp:
    3131-3172)."""
    cfg = scene.config
    if cfg.fixed_focal_length:
        return cfg.init_focal_length
    if cfg.use_focal_estimate and scene.has_init_focal(img):
        f_init = scene.init_focal(img)
        f_obs = 0.5 * (K[0, 0] + K[1, 1])
        ratio = f_init / f_obs if f_init > f_obs else f_obs / f_init
        return f_init if (ratio < 1.4 or cfg.trust_focal_estimate) else f_obs
    return 0.5 * (K[0, 0] + K[1, 1])


def bundle_initialize_image(recon: Reconstruction, scene: Scene, img: int,
                            cam_slot: int, seed: int,
                            sampler: Callable = None) -> bool:
    """`BundleInitializeImage` (src/Bundle.cpp:2994-3270) for one image:
    resection RANSAC on its existing 3D points (the "resection_one" draw
    from `seed`), focal initialization, then `refine_camera_iterative` on
    the weak inliers; on success the camera joins `recon` in `cam_slot`."""
    cfg = scene.config
    dev = _device(scene)
    sampler = sampler or StageSampler(dev)
    cand = _existing_points(recon, scene, img)
    if cand is None:
        return False
    pts3, projs, pt_idx, keys = (cand[k] for k in ("pts3", "projs", "pt_idx",
                                                   "keys"))
    n = len(pts3)
    with stage("resection"):
        samples = sampler("resection_one", seed, torch.tensor([n]),
                          cfg.projection_rounds, 6).to(dev)
        ver = find_and_verify_camera(
            samples, _T(pts3[None], dev), _T(projs[None], dev),
            torch.tensor([n], device=dev), cfg.projection_estimation_threshold,
            16.0 * cfg.projection_estimation_threshold)
        ok, K, R, t, weak = (_np(v[0]) for v in (
            ver.ok, ver.K, ver.R, ver.t, ver.inliers_weak))
    if not ok:
        log(f"[BundleInitializeImage] {img}: pose estimation failed")
        return False
    weak = np.nonzero(weak)[0]
    if len(weak) == 0:
        return False
    cam0 = np.concatenate([-R.T @ t, np.zeros(3), [_init_focal(scene, img, K)],
                           np.zeros(2)])
    with stage("refine_camera"):
        cam, Rn, inl = refine_camera_iterative(
            scene, img, cam0, R, pts3[weak], projs[weak],
            adjust_focal=not cfg.fixed_focal_length, device=dev)
    width = scene.dims[img][0]
    if len(inl) < 8 or cam[6] < 0.1 * width:
        log(f"[BundleInitializeImage] {img}: bad camera "
            f"({len(inl)} inliers, f={cam[6]:.1f})")
        return False
    # Connect the inlier keys to their points (src/Bundle.cpp:3238-3247).
    for i in inl:
        gi = weak[i]
        recon.key_extra[img][keys[gi]] = pt_idx[gi]
        recon.pt_views[pt_idx[gi]].append((cam_slot, keys[gi]))
    recon.added_order.append(img)
    recon.cam_R.append(Rn)
    recon.cam_params.append(cam)
    counter("images_registered")
    log(f"[BundleInitializeImage] {img}: registered with {len(inl)} points, "
        f"f={cam[6]:.2f}")
    return True


# --------------------------------------------------------------------------
# Point addition and pruning
# --------------------------------------------------------------------------

def add_all_new_points(recon: Reconstruction, scene: Scene) -> int:
    """`BundleAdjustAddAllNewPoints` (src/BundleAdd.cpp:193-427): sub-tracks
    visible in >= 2 registered cameras, gated by ray angle >= 2° (host, f32
    dots as in the JAX package), triangulated on the device (or, in
    panorama mode, placed on the first view's ray on the host), gated by
    reprojection <= 16 px and cheirality."""
    cfg = scene.config
    dev = _device(scene)
    cand: Dict[int, List[Tuple[int, int]]] = {}
    for slot, img in enumerate(recon.added_order):
        for tr, key in zip(scene.visible_points[img],
                           scene.visible_keys[img]):
            if recon.track_extra[tr] != -1:
                continue          # already a point
            if recon.key_extra[img].get(key, -1) != -1:
                continue          # outlier (-2) or already connected
            cand.setdefault(tr, []).append((slot, key))
    tracks = [(tr, views) for tr, views in cand.items()
              if len(views) >= max(2, cfg.min_track_views)]
    if not tracks:
        return 0

    T = len(tracks)
    M = max(len(v) for _, v in tracks)
    counts = np.fromiter((len(v) for _, v in tracks), dtype=np.int64,
                         count=T)
    total = int(counts.sum())
    flat = np.fromiter(
        itertools.chain.from_iterable(
            itertools.chain.from_iterable(v for _, v in tracks)),
        dtype=np.int64, count=2 * total).reshape(-1, 2)
    slots, keys = flat[:, 0], flat[:, 1]
    ti_f = np.repeat(np.arange(T), counts)
    vi_f = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    cam_arr = np.stack(recon.cam_params)
    R_arr = np.stack(recon.cam_R)
    added = np.asarray(recon.added_order, dtype=np.int64)
    xy = np.zeros((T, M, 2))
    fs = np.ones((T, M))
    ks = np.zeros((T, M, 2))
    Rs = np.broadcast_to(np.eye(3), (T, M, 3, 3)).copy()
    cs = np.zeros((T, M, 3))
    mask = np.zeros((T, M), dtype=bool)
    img_f = added[slots]
    xy_f = np.empty((total, 2))
    for img in np.unique(img_f):
        sel = img_f == img
        xy_f[sel] = scene.key_xy[img][keys[sel]]
    xy[ti_f, vi_f] = xy_f
    fs[ti_f, vi_f] = cam_arr[slots, 6]
    ks[ti_f, vi_f] = cam_arr[slots, 7:9]
    Rs[ti_f, vi_f] = R_arr[slots]
    cs[ti_f, vi_f] = cam_arr[slots, 0:3]
    mask[ti_f, vi_f] = True

    # Ray-angle conditioning (src/BundleAdd.cpp:272-337): max pairwise
    # angle >= ray_angle_threshold ⟺ min pairwise dot of unit rays <= cos.
    v = np.concatenate([xy / fs[..., None], -np.ones((T, M, 1))], axis=2)
    rays = np.einsum("tmi,tmij->tmj", v, Rs)
    rays = np.where(mask[..., None], rays, 0.0)
    norms = np.linalg.norm(rays, axis=2, keepdims=True)
    norms[norms == 0] = 1.0
    rn = rays / norms
    dots = np.einsum("tmi,tni->tmn", rn.astype(np.float32),
                     rn.astype(np.float32))
    pair_mask = mask[:, :, None] & mask[:, None, :]
    min_dot = np.where(pair_mask, dots, 2.0).min(axis=(1, 2))
    cos_thr = max(np.cos(np.radians(cfg.ray_angle_threshold)), -1 + 1e-8)
    conditioned = min_dot <= cos_thr

    if not cfg.panorama_mode:
        with stage("triangulate"):
            X, err = triangulate_tracks_pixels(
                _T(xy, dev), _T(fs, dev), _T(ks, dev), _T(Rs, dev),
                _T(cs, dev), _T(mask, dev, torch.bool))
            X, err = _np(X), _np(err)
    else:
        # Panorama mode: each track on its first view's ray at unit distance
        # (`GeneratePointAtInfinity`, src/BundleAdd.cpp:129-176, selected at
        # :342-348), gated on its mean pixel residual over all views (the
        # reference leaves `error` unset here).
        X = cs[:, 0] + rn[:, 0]
        q = np.einsum("tmij,tmj->tmi", Rs, X[:, None, :] - cs)
        qz = np.where(np.abs(q[:, :, 2]) < 1e-12, -1e-12, q[:, :, 2])
        u = -q[:, :, :2] / qz[:, :, None]
        r2 = (u ** 2).sum(axis=2)
        distort = 1.0 + ks[:, :, 0] * r2 + ks[:, :, 1] * r2 * r2
        pred = fs[..., None] * distort[..., None] * u
        d = np.linalg.norm(pred - xy, axis=2)
        err = np.where(mask, d, 0.0).sum(axis=1) / \
            np.maximum(mask.sum(axis=1), 1)

    # Cheirality for every view (src/BundleAdd.cpp:359-378).
    q = np.einsum("tmij,tmj->tmi", Rs, X[:, None, :] - cs)
    in_front = np.where(mask, q[:, :, 2] < 0.0, True).all(axis=1)
    good = conditioned & np.isfinite(err) & \
        (err <= ADD_REPROJECTION_ERROR) & in_front
    n_added = 0
    for ti, (tr, views) in enumerate(tracks):
        if not good[ti]:
            continue
        pt_idx = len(recon.points)
        recon.points.append(X[ti])
        img0 = recon.added_order[views[0][0]]
        recon.colors.append(scene.color_of_key(img0, views[0][1]))
        recon.pt_views.append(list(views))
        recon.track_extra[tr] = pt_idx
        for (slot, key) in views:
            recon.key_extra[recon.added_order[slot]][key] = pt_idx
        n_added += 1
    log(f"[AddAllNewPoints] Added {n_added} / {T} candidate tracks "
        f"(ill-conditioned {int((~conditioned).sum())}, "
        f"high-reproj {int((err > ADD_REPROJECTION_ERROR).sum())}, "
        f"behind {int((~in_front).sum())})")
    return n_added


def remove_bad_points(recon: Reconstruction, scene: Scene) -> int:
    """`RemoveBadPointsAndCameras` (src/Bundle.cpp:4190-4261): drop points
    whose max pairwise ray angle (point->camera-center rays) is below
    0.5·ray_angle_threshold (host, f32 dots as in the JAX package)."""
    cfg = scene.config
    P = len(recon.points)
    counts = np.fromiter(map(len, recon.pt_views), dtype=np.int64, count=P)
    live = np.nonzero(counts > 0)[0]
    if len(live) == 0:
        log("[RemoveBadPointsAndCameras] Pruned 0 points")
        return 0
    M = int(counts[live].max())
    total = int(counts[live].sum())
    flat_slots = np.fromiter(
        itertools.chain.from_iterable(
            (v[0] for v in recon.pt_views[p]) for p in live),
        dtype=np.int64, count=total)
    li = np.repeat(np.arange(len(live)), counts[live])
    vi = np.arange(total) - np.repeat(
        np.cumsum(counts[live]) - counts[live], counts[live])
    cam_c = np.stack(recon.cam_params)[:, 0:3]
    pos = np.stack([recon.points[p] for p in live])
    rays_f = pos[li] - cam_c[flat_slots]
    n = np.linalg.norm(rays_f, axis=1, keepdims=True)
    valid_f = n[:, 0] > 0
    rays_f = np.divide(rays_f, n, out=np.zeros_like(rays_f), where=n > 0)
    rays = np.zeros((len(live), M, 3))
    vmask = np.zeros((len(live), M), bool)
    rays[li, vi] = rays_f
    vmask[li, vi] = valid_f
    min_dot = np.full(len(live), 2.0, np.float32)
    rays = rays.astype(np.float32)
    iu = np.triu_indices(M, 1)
    step = max(1, int(4e7 // max(M * M, 1)))
    for s in range(0, len(live), step):
        r = rays[s:s + step]
        vm = vmask[s:s + step]
        dots = np.einsum("lmi,lni->lmn", r, r)
        pair_ok = vm[:, :, None] & vm[:, None, :]
        if M > 1:
            d = np.where(pair_ok, dots, 2.0)[:, iu[0], iu[1]]
            min_dot[s:s + step] = d.min(axis=1)
    cos_thr = min(np.cos(np.radians(0.5 * cfg.ray_angle_threshold)),
                  1.0 - 1e-8)
    bad = live[min_dot > cos_thr]
    for p in bad:
        for (slot, key) in recon.pt_views[p]:
            recon.key_extra[recon.added_order[slot]][key] = -1
        recon.pt_views[p] = []
        recon.colors[p] = np.array([0.0, 0.0, 255.0])
    log(f"[RemoveBadPointsAndCameras] Pruned {len(bad)} points")
    return len(bad)


def estimate_ignored_cameras(recon: Reconstruction, scene: Scene,
                             seed: int = 0, sampler: Callable = None) -> int:
    """`EstimateIgnoredCameras` (src/Bundle.cpp:1887-1990): after the main
    loop, try to register every ignored image one at a time (the
    "resection_one" draw from seed + 71·image), bundle the cameras with the
    points fixed, add points, then sweep once more."""
    def sweep():
        n_added = 0
        for img in range(scene.num_images):
            if not scene.ignore_in_bundle[img]:
                continue
            if recon.slot_of_image(img) is not None:
                continue
            if bundle_initialize_image(recon, scene, img, recon.num_cameras,
                                       seed=seed + IGNORED_SEED_STRIDE * img,
                                       sampler=sampler):
                n_added += 1
        return n_added

    added = sweep()
    if added:
        run_sfm(recon, scene, fix_points=True, verbose=False)
        add_all_new_points(recon, scene)
        added += sweep()
    log(f"[EstimateIgnoredCameras] Recovered {added} cameras")
    return added


def bundle_adjust_slow(scene: Scene, out_dir: Optional[str] = None,
                       seed: int = 0, sampler: Callable = None
                       ) -> Reconstruction:
    """The one-camera-at-a-time loop (`BundleAdjust`, src/Bundle.cpp:2069;
    --slow_bundle): the same machinery as `bundle_adjust_fast`, but each
    round registers only the best-connected image (most existing points
    seen, or with --construct_max_connectivity the largest frontier gain)
    before re-bundling."""
    cfg = scene.config
    sampler = sampler or StageSampler(_device(scene))
    with stage("init_pair"):
        i_best, j_best = pick_initial_pair(scene, True)
        log(f"[BundleAdjustSlow] Initial pair: {i_best}, {j_best}")
        recon = setup_initial_pair(scene, i_best, j_best, seed=seed,
                                   sampler=sampler)
    run_sfm(recon, scene, remove_outliers=not cfg.fix_necker)
    if cfg.fix_necker:
        fix_necker_reversal(recon, scene)
    while recon.num_cameras < scene.num_images:
        if cfg.construct_max_connectivity:
            img, max_matches = find_camera_with_most_connectivity(recon,
                                                                  scene)
            if img < 0:
                break
        else:
            counts = find_candidate_images(recon, scene)
            if not counts:
                break
            img, max_matches = max(counts.items(), key=lambda kv: kv[1])
        if max_matches < cfg.min_max_matches:
            break
        with stage("register"):
            ok = bundle_initialize_image(
                recon, scene, img, recon.num_cameras,
                seed=seed + SLOW_SEED_STRIDE * img, sampler=sampler)
        if not ok:
            scene.ignore_in_bundle[img] = True
            continue
        if not cfg.skip_add_points:
            with stage("add_points"):
                add_all_new_points(recon, scene)
        if not cfg.skip_full_bundle:
            run_sfm(recon, scene)
            with stage("prune"):
                remove_bad_points(recon, scene)
        if out_dir:
            dump_round(recon, scene, out_dir, recon.num_cameras)
    if out_dir and cfg.bundle_output_file:
        write_bundle_file(os.path.join(out_dir, cfg.bundle_output_file),
                          to_bundle_file(recon, scene))
    log(f"[BundleAdjust] Done: {recon.num_cameras} cameras, "
        f"{sum(1 for v in recon.pt_views if v)} points")
    return recon


def write_match_table(scene: Scene, append: str = "",
                      directory: str = ".") -> None:
    """Match-table snapshot nmatches<ext>.txt / matches<ext>.txt of the
    scene's non-empty match lists (`WriteMatchTable`,
    src/BundleIO.cpp:1044-1111)."""
    from bundler_sfm_tpu_torch.io.matchfile import (
        write_match_table as _write_table,
    )
    nonempty = {p: m for p, m in scene.matches.items()
                if m is not None and len(m)}
    _write_table(scene.num_images, nonempty, append, directory)


# --------------------------------------------------------------------------
# Output
# --------------------------------------------------------------------------

def to_bundle_file(recon: Reconstruction, scene: Scene) -> BundleFile:
    """Final scene -> BundleFile (DumpOutputFile, src/BundleIO.cpp:730-875)."""
    cams = []
    slot_of = {img: s for s, img in enumerate(recon.added_order)}
    for i in range(scene.num_images):
        s = slot_of.get(i)
        if s is None:
            cams.append(BundleCamera(f=0.0, k1=0.0, k2=0.0,
                                     R=np.zeros((3, 3)), t=np.zeros(3)))
        else:
            cp = recon.cam_params[s]
            R = recon.cam_R[s]
            cams.append(BundleCamera(f=float(cp[6]), k1=float(cp[7]),
                                     k2=float(cp[8]), R=R.copy(),
                                     t=-R @ cp[0:3]))
    pts = []
    for p in range(len(recon.points)):
        views = recon.pt_views[p]
        if len(views) == 0:
            continue
        v = np.zeros((len(views), 4))
        for k, (slot, key) in enumerate(views):
            img = recon.added_order[slot]
            v[k] = [img, key, scene.key_xy[img][key][0],
                    scene.key_xy[img][key][1]]
        pts.append(BundlePoint(pos=recon.points[p].copy(),
                               color=recon.colors[p].copy(), views=v))
    return BundleFile(cameras=cams, points=pts)


def dump_round(recon: Reconstruction, scene: Scene, out_dir: str,
               round_id: int) -> None:
    """bundle_NNN.out (with output_all) and pointsNNN.ply of one round."""
    cfg = scene.config
    os.makedirs(out_dir, exist_ok=True)
    if cfg.output_all and cfg.bundle_output_base:
        path = os.path.join(out_dir,
                            f"{cfg.bundle_output_base}{round_id:03d}.out")
        write_bundle_file(path, to_bundle_file(recon, scene))
    live = [p for p in range(len(recon.points)) if recon.pt_views[p]]
    if live:
        write_points_ply(
            os.path.join(out_dir, f"points{round_id:03d}.ply"),
            np.stack([recon.points[p] for p in live]),
            np.stack([recon.colors[p] for p in live]),
            np.stack(recon.cam_R),
            np.stack([c[0:3] for c in recon.cam_params]))


# --------------------------------------------------------------------------
# Main driver
# --------------------------------------------------------------------------

def bundle_adjust_fast(scene: Scene, out_dir: Optional[str] = None,
                       seed: int = 0, sampler: Callable = None
                       ) -> Reconstruction:
    """The full incremental loop (`BundleAdjustFast`,
    src/BundleFast.cpp:37-526) on `scene.device`; writes the round outputs
    and `bundle.out` into `out_dir` when given."""
    with stage("total", verbose=True):
        recon = _bundle_adjust_fast(scene, out_dir, seed, sampler)
    rep = get_telemetry().report()
    log("[Telemetry] stage seconds: " + ", ".join(
        f"{k}={v:.1f}" for k, v in sorted(
            rep["stages_s"].items(), key=lambda kv: -kv[1])))
    return recon


def _bundle_adjust_fast(scene: Scene, out_dir, seed, sampler):
    cfg = scene.config
    sampler = sampler or StageSampler(_device(scene))
    with stage("init_pair"):
        i_best, j_best = pick_initial_pair(scene, True)
        log(f"[BundleAdjust] Initial pair: {i_best}, {j_best}")
        recon = setup_initial_pair(scene, i_best, j_best, seed=seed,
                                   sampler=sampler)
    run_sfm(recon, scene, remove_outliers=not cfg.fix_necker)
    if cfg.fix_necker:
        fix_necker_reversal(recon, scene)
    if out_dir:
        dump_round(recon, scene, out_dir, recon.num_cameras)

    round_id = 0
    while recon.num_cameras < scene.num_images:
        counts = find_candidate_images(recon, scene)
        if not counts:
            break
        max_matches = max(counts.values())
        if max_matches < cfg.min_max_matches:
            log(f"[BundleAdjust] No more connections (max {max_matches})")
            break
        n_needed = int(round(0.75 * max_matches))
        if cfg.num_matches_add_camera > 0:
            n_needed = min(n_needed, cfg.num_matches_add_camera)
        batch_imgs = [i for i, c in counts.items() if c >= n_needed]
        log(f"[BundleAdjustFast] Registering {len(batch_imgs)} images "
            f"(>= {n_needed} matches)")
        with stage("register"):
            registered = bundle_initialize_images(
                recon, scene, batch_imgs,
                seed=seed + RESECTION_SEED_STRIDE * round_id,
                sampler=sampler)
        for img in batch_imgs:
            if img not in registered:
                scene.ignore_in_bundle[img] = True
        if not registered:
            round_id += 1
            continue
        if not cfg.skip_add_points:
            with stage("add_points"):
                add_all_new_points(recon, scene)
        if not cfg.skip_full_bundle:
            run_sfm(recon, scene)
            with stage("prune"):
                remove_bad_points(recon, scene)
        if out_dir:
            dump_round(recon, scene, out_dir, recon.num_cameras)
        round_id += 1

    if cfg.estimate_ignored:
        estimate_ignored_cameras(recon, scene, seed=seed, sampler=sampler)

    if out_dir and cfg.bundle_output_file:
        write_bundle_file(os.path.join(out_dir, cfg.bundle_output_file),
                          to_bundle_file(recon, scene))
    log(f"[BundleAdjust] Done: {recon.num_cameras} cameras, "
        f"{sum(1 for v in recon.pt_views if v)} points")
    return recon

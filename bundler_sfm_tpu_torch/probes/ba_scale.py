"""Bundle adjustment at the scale the JAX package raced against SBA.

The scene is `benchmarks/ba_vs_sba.py::synthesize` (copied here, same seed
behaviour, so both packages build the same problem): cameras on an arc
looking at the origin, each point seen by a contiguous run of cameras,
0.5 px of noise a coordinate, points and camera centres perturbed.  The
problem is built as that script's `run_ours` builds it (focal and
distortion free, no priors, true rotations as R0), windows planned by
`plan_schur_windows` on the true camera count, and run through `run_ba`.

    python -m bundler_sfm_tpu_torch.probes.ba_scale \
        [num_cams num_pts views_per_pt] [--max_iters N] [--device cuda|cpu]

prints one JSON line: the plan (window, groups, wide points), LM
iterations, the final cost beside the cost at the generator's ground
truth on the same observations, the mean reprojection error, BA seconds,
ms per LM iteration and peak device memory (cuda only; a CPU run times
nothing).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from bundler_sfm_tpu_torch.ops.ba import (
    BAProblem, BAResult, build_problem, compute_cost, plan_schur_windows,
    run_ba,
)
from bundler_sfm_tpu_torch.utils.device import resolve_device

W_IMG, H_IMG = 640, 480
FOCAL = 700.0
PIX_NOISE = 0.5   # px, observation noise
PT_NOISE = 0.05   # world units, initial point perturbation
CAM_NOISE = 0.02  # world units, initial center perturbation


def synthesize(num_cams, num_pts, views_per_pt, seed=0):
    """Cameras on an arc looking at the origin; each point seen by a
    contiguous window of cameras; observations inside the image.  The same
    draws in the same order as the JAX package's benchmark, with the
    per-observation loop vectorized: returns (R, centers, centers_init,
    pts, pts_init, obs_cam, obs_pt, obs_xy)."""
    rng = np.random.default_rng(seed)
    centers = np.array([[np.sin(a) * 8, 0.5 * np.sin(3 * a), np.cos(a) * 8]
                        for a in np.linspace(0, 1.2, num_cams)])
    pts = rng.uniform(-2, 2, (num_pts, 3))

    def look_at(c):
        z = c / np.linalg.norm(c)
        x = np.cross([0, 1, 0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        return np.stack([x, y, z])

    R = np.stack([look_at(c) for c in centers])
    start = rng.integers(0, max(1, num_cams - views_per_pt + 1), num_pts)
    obs_cam = (start[:, None] + np.arange(views_per_pt)).reshape(-1) \
        .astype(np.int32)
    obs_pt = np.repeat(np.arange(num_pts), views_per_pt).astype(np.int32)
    p_cam = np.einsum("oij,oj->oi", R[obs_cam], pts[obs_pt] - centers[obs_cam])
    obs_xy = -FOCAL * p_cam[:, :2] / p_cam[:, 2:3]
    obs_xy += rng.normal(size=obs_xy.shape) * PIX_NOISE

    # Keep only observations inside the image.
    keep = ((np.abs(obs_xy[:, 0]) < (W_IMG - 2) / 2) &
            (np.abs(obs_xy[:, 1]) < (H_IMG - 2) / 2) & (p_cam[:, 2] < 0))
    obs_cam, obs_pt, obs_xy = obs_cam[keep], obs_pt[keep], obs_xy[keep]
    # Drop points with <2 surviving views and reindex.
    counts = np.bincount(obs_pt, minlength=num_pts)
    keep_pt = counts >= 2
    remap = -np.ones(num_pts, np.int64)
    remap[keep_pt] = np.arange(keep_pt.sum())
    sel = keep_pt[obs_pt]
    obs_cam, obs_pt, obs_xy = obs_cam[sel], remap[obs_pt[sel]], obs_xy[sel]
    pts = pts[keep_pt]

    pts_init = pts + rng.normal(size=pts.shape) * PT_NOISE
    centers_init = centers + rng.normal(size=centers.shape) * CAM_NOISE
    return (R, centers, centers_init, pts, pts_init,
            obs_cam, obs_pt.astype(np.int32), obs_xy)


def mean_reproj(cam9, R, pts, obs_cam, obs_pt, obs_xy) -> float:
    """Mean reprojection error (px) of a [C,9] cam / R / pts state."""
    c = cam9[obs_cam, 0:3]
    f = cam9[obs_cam, 6]
    k1 = cam9[obs_cam, 7]
    k2 = cam9[obs_cam, 8]
    p = np.einsum("oij,oj->oi", R[obs_cam], pts[obs_pt] - c)
    uv = -p[:, :2] / p[:, 2:3]
    r2 = (uv[:, 0] ** 2 + uv[:, 1] ** 2)
    d = 1.0 + k1 * r2 + k2 * r2 * r2
    pred = f[:, None] * d[:, None] * uv
    return float(np.mean(np.linalg.norm(pred - obs_xy, axis=1)))


class ScaleProblem(NamedTuple):
    prob: BAProblem
    plan: Optional[tuple]     # plan_schur_windows' result, or None
    gt_cam: torch.Tensor      # [C,9] the generator's cameras
    gt_pts: torch.Tensor      # [P,3] the generator's points
    host: Dict                # R, obs_cam, obs_pt, obs_xy (numpy)


def build(num_cams: int, num_pts: int, views_per_pt: int,
          device="cuda") -> ScaleProblem:
    """The synthesized scene (seed 0) as a BAProblem on `device`, built as
    `ba_vs_sba.run_ours` builds it (f64 here), with its window plan."""
    dev = resolve_device(device)
    (R, centers, centers_init, pts, pts_init,
     obs_cam, obs_pt, obs_xy) = synthesize(num_cams, num_pts, views_per_pt)
    C = len(centers_init)
    cam0 = np.zeros((C, 9))
    cam0[:, 0:3] = centers_init
    cam0[:, 6] = FOCAL
    plan = plan_schur_windows(obs_cam, obs_pt, len(pts_init), C,
                              int(np.bincount(obs_pt).max()))
    prob = build_problem(R, cam0, pts_init, obs_cam, obs_pt, obs_xy,
                         est_focal=True, est_distortion=True,
                         schur_plan=plan, device=dev)
    gt_cam = np.zeros((C, 9))
    gt_cam[:, 0:3] = centers
    gt_cam[:, 6] = FOCAL
    return ScaleProblem(
        prob=prob, plan=plan,
        gt_cam=torch.as_tensor(gt_cam, device=dev),
        gt_pts=torch.as_tensor(pts, device=dev),
        host=dict(R=R, obs_cam=obs_cam, obs_pt=obs_pt, obs_xy=obs_xy))


def plan_summary(plan) -> Dict:
    """Window width, groups and wide points of a plan (zeros for None)."""
    if plan is None:
        return dict(window=0, group_pts=0, groups=0, wide_points=0)
    row_of, starts, Wd, G, _ = plan
    return dict(window=Wd, group_pts=G, groups=len(starts),
                wide_points=int((row_of >= len(starts) * G).sum()))


def solve(sp: ScaleProblem,
          max_iters: int = 150) -> Tuple[Dict, BAResult]:
    """run_ba on the problem (windowed when it carries a plan); the
    result's record and the BAResult.  Times and peak memory on cuda
    only (a synchronize ends the timed region)."""
    prob = sp.prob
    cuda = prob.cam0.device.type == "cuda"
    win = plan_summary(sp.plan)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_ba(prob, max_iters=max_iters, window=win["window"],
                 group_pts=win["group_pts"])
    cost = float(res.cost)
    secs = time.perf_counter() - t0
    h = sp.host
    gt_cost = float(compute_cost(sp.gt_cam, sp.gt_pts, prob))
    rec = dict(
        num_cams=int(prob.cam0.shape[0]), num_pts=int(prob.pts0.shape[0]),
        num_obs=int(prob.obs_cam.shape[0]), **win, iters=res.iters,
        initial_cost=float(res.initial_cost), cost=cost, gt_cost=gt_cost,
        mean_reproj_px=mean_reproj(res.cam.cpu().numpy(),
                                   res.R.cpu().numpy(),
                                   res.pts.cpu().numpy(), h["obs_cam"],
                                   h["obs_pt"], h["obs_xy"]),
        gt_reproj_px=mean_reproj(sp.gt_cam.cpu().numpy(), h["R"],
                                 sp.gt_pts.cpu().numpy(), h["obs_cam"],
                                 h["obs_pt"], h["obs_xy"]),
        device=(torch.cuda.get_device_name(prob.cam0.device) if cuda
                else "cpu"))
    if cuda:
        rec.update(ba_s=secs, ms_per_iter=1e3 * secs / max(res.iters, 1),
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return rec, res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="ba_scale", description="Bundle adjustment on the JAX "
        "package's synthetic SBA race scene.")
    p.add_argument("sizes", nargs="*", type=int, default=[256, 262144, 8],
                   help="num_cams num_pts views_per_pt (default 256 "
                        "262144 8)")
    p.add_argument("--max_iters", type=int, default=150)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu times nothing)")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    if len(args.sizes) != 3:
        p.error("give num_cams num_pts views_per_pt")
    sp = build(*args.sizes, device=args.device)
    rec, _ = solve(sp, args.max_iters)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

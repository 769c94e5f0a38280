"""Bundle adjustment — Schur-complement Levenberg-Marquardt; port of the
single-device path of `bundler_sfm_tpu/ops/ba.py`.

The replacement for the reference's SBA stack (`lib/sba-1.5/sba_levmar.c`
`sba_motstr_levmar_x`, driven by `run_sfm`, `lib/sfm-driver/sfm.c:592-1004`):

- residuals: the Snavely model over a FLAT observation layout (obs_cam,
  obs_pt, obs_xy), with closed-form Jacobian blocks A [O,2,9] (camera) and
  B [O,2,3] (point);
- normal equations: U_j = Σ AᵀA, V_i = Σ BᵀB, W_o = AᵀB, the blocks SBA
  builds (`sba_levmar.c:1191-1324`);
- Schur: Y_o = W_o V⁻¹; the reduced camera system
  S = U − Σ_i Σ_{a,b ∈ views(i)} Y_a W_bᵀ.  A track never revisits an image
  (`src/ComputeTracks.cpp:171`), so each (point, camera) pair holds at
  most one observation and the double sum factorises: scattered into dense
  [C·9, P·3] camera tables, S_off = −Ỹ·W̃ᵀ is a dense f64 matrix product,
  run over chunks of points (rows of `pt_views`) under
  `SCHUR_TABLE_BYTES`.  With a
  covisibility-window plan (`plan_schur_windows`, carried by the problem),
  each group of points whose cameras fit one window contracts only inside
  that window, (W·9)² instead of (C·9)² a point, and the wide points run
  the full-C product.  S is factored by a dense Cholesky (`sba_Axb_Chol`)
  or solved by block-Jacobi preconditioned CG (the Ceres ITERATIVE_SCHUR
  configuration);
- LM: additive damping, mu0 = tau·max(diag), Nielsen's mu update; camera
  parameters are damped in the scaled space q = s∘x (run_sfm packs f·0.001
  and k·5.0, `sfm.c:634-635`).

Camera = [c(3), w(3), f, k1, k2] with R = exp([w]x)·R0; w starts at 0 and
is folded back into R after each run (`sfm.c:876-929`).

Reductions are deterministic: per-point and per-camera sums are gathers
through fixed [P, M] / [C, S] observation tables summed in a fixed order
(no atomics), so two runs on the card give bit-identical results.  The LM
loop runs on the host and reads one pair of flags (accept, done) per
iteration.  On CUDA, on one rank with the Cholesky solve, the iteration's
kernels are captured once as CUDA graphs and replayed (`_LMGraphs`), with
the eager loop's results to the bit.

With a `mesh` (`parallel/mesh.py`), `prob` is one rank's shard of a
point-sharded problem (`parallel/ba_sharded.py`: its points with all their
observations, cameras replicated): wherever the JAX package `psum`s or
`pmax`es over its mesh axis, the LM loop, the outlier loop and the stats
pass reduce over the ranks, so every rank takes the same camera step and
the same host branches.  With mesh=None nothing changes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from bundler_sfm_tpu_torch.ops.linalg_small import inv3
from bundler_sfm_tpu_torch.ops.rotations import rot_update
from bundler_sfm_tpu_torch.utils import counter, stage
from bundler_sfm_tpu_torch.utils.device import resolve_device

CNP = 9  # camera params: c(3) w(3) f k1 k2
PNP = 3

# Parameter scaling (run_sfm packs f·0.001 and k·5.0, sfm.c:634-635): LM
# damps mu·I in the scaled space q = s∘x, which balances the focal and
# distortion columns of JᵀJ against the pose columns.
F_SCALE = 0.001
K_SCALE = 5.0

# Bytes of one dense camera table in the Schur assembly: the full-C form
# runs over chunks of points whose [C·9, n·3] table fits, the windowed form
# over batches of groups whose [b, W·9, G·3] table fits.  Two tables live
# at once beside S, so the assembly's peak stays near 2 GiB + S whatever
# P·C is (one table of the 512-camera, 524288-point problem is 58 GB).
SCHUR_TABLE_BYTES = 1 << 30


def _robust_weight(s, loss: str, b):
    """IRLS weight rho'(s) for a squared residual norm s: 1 for "l2"; for
    "huber" Ceres' HuberLoss(a) with b = a² (src/BundleCeres.cpp:124-125,
    285): rho'(s) = min(1, sqrt(b/s))."""
    if loss == "l2":
        return torch.ones_like(s)
    return torch.clamp(torch.sqrt(b / torch.clamp(s, min=1e-30)), max=1.0)


def _robust_rho(s, loss: str, b):
    if loss == "l2":
        return s
    return torch.where(s <= b, s,
                       2.0 * torch.sqrt(b * torch.clamp(s, min=1e-30)) - b)


def _robust_curvature(s, loss: str, b):
    """rho''(s): Huber is 0 inside, −½·√b·s^(−3/2) beyond (never > 0, so
    the Triggs correction's alpha term vanishes)."""
    if loss == "l2":
        return torch.zeros_like(s)
    return torch.where(s <= b, 0.0,
                       -0.5 * math.sqrt(b) * torch.clamp(s, min=1e-30) ** -1.5)


@dataclasses.dataclass(frozen=True)
class RowObs:
    """Observations grouped by table row for the dense-table Schur
    assembly: `obs` [n] observation ids ordered by row (input order within
    a row), `row` [n] the row of each, `off` [R + 1] (host) the offset of
    each row's first observation in `obs`."""
    obs: torch.Tensor
    row: torch.Tensor
    off: np.ndarray


@dataclasses.dataclass(frozen=True)
class SchurWindows:
    """A `plan_schur_windows` plan laid onto a problem's observations
    (`build_problem(schur_plan=...)`).  Group g holds the points of plan
    rows [g·G, (g+1)·G); every camera that observes them lies in
    [starts[g], starts[g] + window).  `grouped` lists the grouped points'
    observations by plan row, `cam` each one's camera less its window's
    start; `wide` [n, M] holds the `pt_views` rows of the other points in
    plan-row order, for the full-C form."""
    window: int
    group_pts: int
    starts: Tuple[int, ...]
    grouped: RowObs
    cam: torch.Tensor
    wide: torch.Tensor


@dataclasses.dataclass(frozen=True)
class BAProblem:
    """A bundle-adjustment problem on one device, observations flat.

    `pt_views` [P, M] and `cam_views` [C, S] list each point's / camera's
    observation indices in input order, padded with O (a zero row appended
    before every gather), so per-point and per-camera sums are fixed-order
    reductions; the full-C Schur assembly reads its chunks of points
    through `pt_views` too.  `schur` is the covisibility-window plan, if
    any."""
    R0: torch.Tensor               # [C,3,3] base rotations
    cam0: torch.Tensor             # [C,9] initial params (c, w=0, f, k1, k2)
    cam_mask: torch.Tensor         # [C,9] 1.0 = free, 0.0 = frozen
    cam_constrained: torch.Tensor  # [C,9] 1.0 where a constraint is active
    cam_constraints: torch.Tensor  # [C,9] target values
    cam_weights: torch.Tensor      # [C,9] constraint weights
    pts0: torch.Tensor             # [P,3]
    obs_cam: torch.Tensor          # [O] int64
    obs_pt: torch.Tensor           # [O] int64
    obs_xy: torch.Tensor           # [O,2]
    obs_valid: torch.Tensor        # [O] bool (False once removed)
    cam_scale: torch.Tensor        # [9] per-parameter scale s
    pt_views: torch.Tensor         # [P,M] int64 observation ids, pad O
    cam_views: torch.Tensor        # [C,S] int64 observation ids, pad O
    pt_constrained: torch.Tensor   # [P] 1.0 where a point is anchored
    pt_constraints: torch.Tensor   # [P,3] anchor positions
    pt_weight: float = 0.0         # weight of every anchor
    schur: Optional[SchurWindows] = None

    def _replace(self, **kw) -> "BAProblem":
        return dataclasses.replace(self, **kw)


class BAResult(NamedTuple):
    cam: torch.Tensor              # [C,9] final params (w folded to 0)
    R: torch.Tensor                # [C,3,3] final rotations
    pts: torch.Tensor              # [P,3]
    cost: torch.Tensor             # final 0.5·Σρ(r²)
    initial_cost: torch.Tensor
    iters: int
    mu: torch.Tensor


# --------------------------------------------------------------------------
# Problem construction (host side)
# --------------------------------------------------------------------------

def _slot_within(obs_pt: np.ndarray) -> np.ndarray:
    """k-th observation of its point, in input order."""
    obs_pt = np.asarray(obs_pt, dtype=np.int64)
    order = np.argsort(obs_pt, kind="stable")
    counts = np.bincount(obs_pt[order]) if len(obs_pt) else np.zeros(0, int)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    out = np.empty(len(obs_pt), dtype=np.int64)
    out[order] = np.arange(len(obs_pt)) - start[obs_pt[order]]
    return out


def _view_table(seg: np.ndarray, num_segments: int) -> np.ndarray:
    """[num_segments, width] observation ids of each segment in input
    order, padded with O = len(seg)."""
    O = len(seg)
    counts = np.bincount(seg, minlength=num_segments) if O else \
        np.zeros(num_segments, np.int64)
    width = max(1, int(counts.max()) if num_segments else 1)
    table = np.full((num_segments, width), O, dtype=np.int64)
    within = _slot_within(seg)
    table[seg, within] = np.arange(O)
    return table


def build_cam_obs_table(obs_cam: np.ndarray, num_cams: int) -> np.ndarray:
    """[C, S] observation ids per camera (input order), padded with O; the
    per-camera reprojection statistics (`src/Bundle.cpp:659-850`) and
    camera sums read observations through it."""
    return _view_table(np.asarray(obs_cam, np.int64), num_cams)


def plan_schur_windows(obs_cam, obs_pt, num_points: int, num_cams: int,
                       max_views: int,
                       min_cameras: int = 192,
                       windows=(32, 64, 128),
                       group_budget: int = 1 << 23):
    """Host-side plan for the covisibility-windowed Schur assembly; a copy
    of the JAX package's `plan_schur_windows` (same arguments, defaults,
    result and None cases, so both packages plan alike).

    Incremental SfM's covisibility is local: with cameras in added order,
    almost every point's observing-camera ids span a narrow range (the
    sparse structure sba's CRS vmask encodes, `lib/sba-1.5/sba.h:70-78`).
    Pick a window width W, assign each point whose [lo, hi] camera span
    fits a half-overlapping window [k·W/2, k·W/2+W) to that window, split
    windows into groups of `group_pts` points, and return the point-row
    permutation that lays groups out contiguously:

      (row_of [num_points] int32, schur_win [nwin] int32, window,
       group_pts, total_rows)

    row_of[p] is the plan row of input point p; rows not hit are group
    padding.  Wide-span points (e.g. loop closures) go to rows
    [nwin·group_pts, total_rows) and run the full-C assembly.  Returns None
    when windowing isn't worth it (few cameras, wide spans, or excessive
    padding) — callers then use window=0."""
    C = num_cams
    if C < min_cameras or num_points == 0:
        return None
    obs_cam = np.asarray(obs_cam)
    obs_pt = np.asarray(obs_pt)
    lo = np.full(num_points, np.iinfo(np.int64).max, np.int64)
    hi = np.full(num_points, -1, np.int64)
    np.minimum.at(lo, obs_pt, obs_cam)
    np.maximum.at(hi, obs_pt, obs_cam)
    empty = hi < 0
    lo[empty] = 0
    hi[empty] = 0

    best = None
    for Wd in windows:
        if 2 * Wd > C:
            break
        half = Wd // 2
        w_idx = np.minimum(lo // half, (C - Wd) // half)
        narrow = hi < w_idx * half + Wd
        n_narrow = int(narrow.sum())
        cost = (Wd * 9) ** 2 * n_narrow \
            + (C * 9) ** 2 * (num_points - n_narrow)
        if best is None or cost < best[0]:
            best = (cost, Wd, w_idx, narrow)
    if best is None or best[0] > 0.5 * (C * 9) ** 2 * num_points:
        return None
    _, Wd, w_idx, narrow = best
    half = Wd // 2

    gmax = max(256, group_budget // (Wd * max(max_views, 1)))
    counts = np.bincount(w_idx[narrow])
    live_w = np.nonzero(counts)[0]
    if len(live_w) == 0:
        return None
    G = int(min(gmax, max(256, int(np.percentile(counts[live_w], 90)))))
    G = ((G + 63) // 64) * 64
    nwin = int(sum(-(-int(c) // G) for c in counts[live_w]))
    n_narrow = int(narrow.sum())
    if nwin * G > 2 * n_narrow + 8 * G:
        return None   # padding waste would exceed the contraction win

    row_of = np.full(num_points, -1, np.int64)
    schur_win = np.zeros(nwin, np.int32)
    row = 0
    g = 0
    for w in live_w:
        pts_w = np.nonzero(narrow & (w_idx == w))[0]
        start = int(min(w * half, C - Wd))
        for s in range(0, len(pts_w), G):
            chunk = pts_w[s:s + G]
            row_of[chunk] = row + np.arange(len(chunk))
            schur_win[g] = start
            row += G
            g += 1
    assert g == nwin and row == nwin * G
    wide = np.nonzero(~narrow)[0]
    row_of[wide] = row + np.arange(len(wide))
    total = row + len(wide)
    return row_of.astype(np.int32), schur_win, int(Wd), int(G), int(total)


def _row_obs(ids: np.ndarray, rows: np.ndarray, num_rows: int,
             dev) -> RowObs:
    """RowObs of the observations `ids` [n], whose rows are `rows` [n]
    (each in [0, num_rows))."""
    order = np.argsort(rows, kind="stable")
    off = np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=num_rows))]).astype(np.int64)
    return RowObs(obs=torch.as_tensor(ids[order], device=dev),
                  row=torch.as_tensor(rows[order], device=dev), off=off)


def _lay_out_windows(plan, obs_cam: np.ndarray, obs_pt: np.ndarray,
                     pt_views: np.ndarray, dev) -> SchurWindows:
    """SchurWindows of `plan` (plan_schur_windows' tuple; row_of maps the
    problem's points to plan rows, which may leave holes: rows without
    observations).  Raises if a grouped point has a camera outside its
    group's window."""
    num_points = len(pt_views)
    row_of, starts, window, G = plan[:4]
    row_of = np.asarray(row_of, np.int64)
    starts = np.asarray(starts, np.int64).reshape(-1)
    if row_of.shape != (num_points,):
        raise ValueError(f"the plan maps {row_of.shape} points, the problem "
                         f"has {num_points}")
    n = len(starts) * G
    prow = row_of[obs_pt]
    sel = np.nonzero(prow < n)[0]
    lcam = obs_cam[sel] - starts[prow[sel] // G]
    if np.any((lcam < 0) | (lcam >= window)):
        raise ValueError("a grouped point is observed outside its window")
    grouped = _row_obs(sel, prow[sel], n, dev)
    wide = np.nonzero(row_of >= n)[0]
    wide = wide[np.argsort(row_of[wide], kind="stable")]
    lcam = torch.as_tensor(obs_cam, device=dev)[grouped.obs] - \
        torch.as_tensor(starts, device=dev)[grouped.row // G]
    return SchurWindows(
        window=int(window), group_pts=int(G),
        starts=tuple(int(v) for v in starts), grouped=grouped, cam=lcam,
        wide=torch.as_tensor(pt_views[wide], device=dev))


def build_problem(
    R0: np.ndarray, cam0: np.ndarray, pts0: np.ndarray,
    obs_cam: np.ndarray, obs_pt: np.ndarray, obs_xy: np.ndarray,
    *,
    est_focal: bool = True,
    est_distortion: bool = True,
    cam_constrained: Optional[np.ndarray] = None,
    cam_constraints: Optional[np.ndarray] = None,
    cam_weights: Optional[np.ndarray] = None,
    pt_constrained: Optional[np.ndarray] = None,
    pt_constraints: Optional[np.ndarray] = None,
    pt_weight: float = 0.0,
    schur_plan=None,
    device="cuda",
) -> BAProblem:
    """A BAProblem on `device` from host arrays (f64), with the focal /
    distortion priors of `SetCameraConstraints` (`src/Bundle.cpp:921-988`)
    and the point anchors of --point_constraint_file (`sfm.c:757-781`):
    pt_constrained [P] flags, pt_constraints [P,3] targets, one weight.
    `schur_plan` is a `plan_schur_windows` result for these points (its
    row_of indexed by the problem's point ids): the problem carries it and
    `run_ba(window=, group_pts=)` uses it; the points keep their order.
    Raises if a (point, camera) pair is observed twice: the dense Schur
    tables hold one observation per pair."""
    dev = resolve_device(device)
    C, P = len(cam0), len(pts0)
    obs_cam = np.asarray(obs_cam, dtype=np.int64)
    obs_pt = np.asarray(obs_pt, dtype=np.int64)
    if len(np.unique(obs_pt * max(C, 1) + obs_cam)) != len(obs_pt):
        raise ValueError("a (point, camera) pair is observed more than once")
    mask = np.ones((C, CNP))
    if not est_focal:
        mask[:, 6] = 0.0
    if not est_distortion:
        mask[:, 7:9] = 0.0

    def arr(x, shape):
        return np.zeros(shape) if x is None else np.asarray(x, np.float64)
    pt_views = _view_table(obs_pt, P)
    cam_views = build_cam_obs_table(obs_cam, C)
    schur = None if schur_plan is None else \
        _lay_out_windows(schur_plan, obs_cam, obs_pt, pt_views, dev)

    def T(x, dtype=torch.float64):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)
    return BAProblem(
        R0=T(R0), cam0=T(cam0), cam_mask=T(mask),
        cam_constrained=T(arr(cam_constrained, (C, CNP))),
        cam_constraints=T(arr(cam_constraints, (C, CNP))),
        cam_weights=T(arr(cam_weights, (C, CNP))),
        pts0=T(pts0), obs_cam=T(obs_cam, torch.int64),
        obs_pt=T(obs_pt, torch.int64), obs_xy=T(obs_xy),
        obs_valid=torch.ones(len(obs_cam), dtype=torch.bool, device=dev),
        cam_scale=T(np.array([1, 1, 1, 1, 1, 1, F_SCALE, K_SCALE, K_SCALE])),
        pt_views=T(pt_views, torch.int64), cam_views=T(cam_views, torch.int64),
        pt_constrained=T(arr(pt_constrained, (P,))),
        pt_constraints=T(arr(pt_constraints, (P, PNP))),
        pt_weight=float(pt_weight),
        schur=schur)


# --------------------------------------------------------------------------
# Normal equations
# --------------------------------------------------------------------------

def _pad_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1,) + x.shape[1:])])


def _point_sum(data, prob: BAProblem):
    """Per-point sum of per-observation data [O, ...] -> [P, ...]."""
    return _pad_row(data)[prob.pt_views].sum(1)


def _cam_sum(data, prob: BAProblem):
    """Per-camera sum of per-observation data [O, ...] -> [C, ...]."""
    return _pad_row(data)[prob.cam_views].sum(1)


def _point_any(flags, prob: BAProblem):
    return _pad_row(flags)[prob.pt_views].any(1)


_drot_dw = vmap(jacfwd(rot_update, argnums=1))


def _predict_obs(cam, pts, R, prob: BAProblem):
    """Snavely projection of every observation given per-camera rotations
    R [C,3,3].  Returns pred [O,2] and p [O,3]."""
    co = cam[prob.obs_cam]
    Ro = R[prob.obs_cam]
    v = pts[prob.obs_pt] - co[:, 0:3]
    p = (Ro * v[:, None, :]).sum(2)
    f = co[:, 6:7]
    n = p[:, 0:2] / p[:, 2:3]
    rsq = (n * n).sum(1, keepdim=True)
    D = 1.0 + co[:, 7:8] * rsq + co[:, 8:9] * rsq * rsq
    return -f * D * n, p


def _residuals(cam, pts, prob: BAProblem):
    R = rot_update(prob.R0, cam[:, 3:6])
    pred, _ = _predict_obs(cam, pts, R, prob)
    return torch.where(prob.obs_valid[:, None], pred - prob.obs_xy, 0.0)


def _linearize_obs(cam, pts, prob: BAProblem):
    """Residual r [O,2] and closed-form Jacobian blocks A [O,2,9] (camera)
    and B [O,2,3] (point), exact at the current w (dR/dw by forward-mode
    AD per camera), plus the scaled camera mask per observation."""
    R = rot_update(prob.R0, cam[:, 3:6])
    dRdw = _drot_dw(prob.R0, cam[:, 3:6])                 # [C,3,3,3]
    oc = prob.obs_cam
    co, Ro, dRo = cam[oc], R[oc], dRdw[oc]
    ms = (prob.cam_mask / prob.cam_scale[None])[oc]
    v = pts[prob.obs_pt] - co[:, 0:3]
    p = (Ro * v[:, None, :]).sum(2)
    f, k1, k2 = co[:, 6], co[:, 7], co[:, 8]
    inv_z = 1.0 / p[:, 2]
    n = p[:, 0:2] * inv_z[:, None]
    rsq = (n * n).sum(1)
    D = 1.0 + k1 * rsq + k2 * rsq * rsq
    pred = -(f * D)[:, None] * n
    zero = torch.zeros_like(inv_z)
    dn_dp = torch.stack([
        torch.stack([inv_z, zero, -n[:, 0] * inv_z], 1),
        torch.stack([zero, inv_z, -n[:, 1] * inv_z], 1)], 1)  # [O,2,3]
    drsq_dp = 2.0 * (n[:, :, None] * dn_dp).sum(1)
    dD_dp = (k1 + 2.0 * k2 * rsq)[:, None] * drsq_dp
    dpred_dp = -f[:, None, None] * (D[:, None, None] * dn_dp
                                    + n[:, :, None] * dD_dp[:, None, :])
    dp_dw = (dRo * v[:, None, :, None]).sum(2)                # [O,3,3]
    B = (dpred_dp[:, :, :, None] * Ro[:, None, :, :]).sum(2)
    A_w = (dpred_dp[:, :, :, None] * dp_dw[:, None, :, :]).sum(2)
    A_f = -(D[:, None]) * n
    A_k1 = -(f * rsq)[:, None] * n
    A_k2 = -(f * rsq * rsq)[:, None] * n
    A = torch.cat([-B, A_w, A_f[:, :, None], A_k1[:, :, None],
                   A_k2[:, :, None]], 2)
    m = prob.obs_valid[:, None]
    return (torch.where(m, pred - prob.obs_xy, 0.0),
            torch.where(m[:, :, None], A, 0.0),
            torch.where(m[:, :, None], B, 0.0), ms)


def _constraint_cost(cam, pts, prob: BAProblem):
    """0.5·Σ cw (x − t)² over the camera priors + 0.5·Σ w ‖X − X̄‖² over
    the anchored points."""
    cw = prob.cam_weights * prob.cam_constrained * prob.cam_mask
    pw = prob.pt_weight * prob.pt_constrained
    return 0.5 * (cw * (cam - prob.cam_constraints) ** 2).sum() + \
        0.5 * (pw[:, None] * (pts - prob.pt_constraints) ** 2).sum()


def compute_cost(cam, pts, prob: BAProblem, loss: str = "l2",
                 huber_b: float = 625.0):
    r = _residuals(cam, pts, prob)
    cost = 0.5 * _robust_rho((r * r).sum(1), loss, huber_b).sum()
    return cost + _constraint_cost(cam, pts, prob)


def build_normal_blocks(cam, pts, prob: BAProblem, fix_points: bool,
                        loss: str = "l2", huber_b: float = 625.0):
    """U [C,9,9], V [P,3,3], W [O,9,3], g_c [C,9], g_p [P,3], cost.

    Camera quantities are in the scaled space q = cam_scale∘x; the camera
    step the solve produces is δq (δx = δq / cam_scale).  Robust losses use
    Ceres' Corrector (the full Triggs correction; for Huber, whose ρ'' ≤ 0,
    it reduces to the √ρ' scaling)."""
    inv_s = 1.0 / prob.cam_scale
    r, A, B, ms = _linearize_obs(cam, pts, prob)
    s = (r * r).sum(1)
    cost = 0.5 * _robust_rho(s, loss, huber_b).sum()
    if loss != "l2":
        rho1 = _robust_weight(s, loss, huber_b)
        rho2 = _robust_curvature(s, loss, huber_b)
        sq1 = torch.sqrt(rho1)
        pos = rho2 > 0.0
        Dd = torch.clamp(
            1.0 + 2.0 * s * rho2 / torch.clamp(rho1, min=1e-30), min=0.0)
        alpha = torch.where(pos, 1.0 - torch.sqrt(Dd), 0.0)
        r_scale = torch.where(
            pos, sq1 / torch.clamp(1.0 - alpha, min=1e-30), sq1)
        asn = (alpha / torch.clamp(s, min=1e-30))[:, None, None]
        rtA = (r[:, :, None] * A).sum(1)
        A = sq1[:, None, None] * (A - asn * r[:, :, None] * rtA[:, None, :])
        rtB = (r[:, :, None] * B).sum(1)
        B = sq1[:, None, None] * (B - asn * r[:, :, None] * rtB[:, None, :])
        r = r * r_scale[:, None]
    A = A * ms[:, None, :]
    if fix_points:
        B = B * 0.0
    U = _cam_sum((A[:, :, :, None] * A[:, :, None, :]).sum(1), prob)
    V = _point_sum((B[:, :, :, None] * B[:, :, None, :]).sum(1), prob)
    W = (A[:, :, :, None] * B[:, :, None, :]).sum(1)
    g_c = -_cam_sum((A * r[:, :, None]).sum(1), prob)
    g_p = -_point_sum((B * r[:, :, None]).sum(1), prob)

    # Camera constraints (sba.h:82-90) in q-space: 0.5·cw·(x−t)² =
    # 0.5·(cw/s²)·(q−s·t)², so diag += cw/s², the gradient gains one 1/s.
    cw = prob.cam_weights * prob.cam_constrained * prob.cam_mask
    U = U + torch.diag_embed(cw * (inv_s * inv_s)[None])
    g_c = g_c + cw * (prob.cam_constraints - cam) * inv_s[None]
    # Point anchors (sfm.c:757-781): V_i += w·I, g_p += w·(X̄ − X).
    pw = prob.pt_weight * prob.pt_constrained
    V = V + pw[:, None, None] * torch.eye(PNP, dtype=V.dtype, device=V.device)
    g_p = g_p + pw[:, None] * (prob.pt_constraints - pts)
    return U, V, W, g_c, g_p, cost + _constraint_cost(cam, pts, prob)


# --------------------------------------------------------------------------
# Reduced camera system
# --------------------------------------------------------------------------

def _schur_full(Y, W, obs_cam, views, C: int, S):
    """S −= Σ_chunks T_Y·T_Wᵀ, in place: T [C·9, n·3] the dense camera
    table of a chunk of n rows of `views` ([R, M] observation ids padded
    with O, as `pt_views`), zero where a row's point is not observed; n as
    large as SCHUR_TABLE_BYTES allows.  The chunks are added in row order.
    Padding entries are written to a spare camera C that is cut off."""
    O = Y.shape[0]
    if O == 0:
        return
    per = max(1, SCHUR_TABLE_BYTES // ((C + 1) * CNP * PNP
                                       * Y.element_size()))
    R = views.shape[0]
    for r0 in range(0, R, per):
        r1 = min(r0 + per, R)
        pad = views[r0:r1] >= O
        ids = views[r0:r1].clamp(max=O - 1)
        cam = torch.where(pad, C, obs_cam[ids])
        row = torch.arange(r1 - r0, device=ids.device)[:, None] \
            .expand_as(ids)

        def table(X):
            t = X.new_zeros(C + 1, CNP, r1 - r0, PNP)
            t[cam, :, row, :] = X[ids]
            return t[:C].reshape(C * CNP, (r1 - r0) * PNP)
        S.sub_(table(Y) @ table(W).T)


def _schur_windowed(Y, W, plan: SchurWindows, C: int, S):
    """S −= Σ_g (the block of group g, added at its window), in place: the
    dense tables [b, W·9, G·3] of a batch of b groups (as many as
    SCHUR_TABLE_BYTES allows) contract in one batched product.  Windows
    overlap by half and several groups share a window, so the blocks are
    added one group at a time in group order (a scatter-add of all blocks
    at once would sum the overlaps in no fixed order).  A window that
    reaches past camera C−1 (the plan counts padded cameras) is clipped:
    no observation lies there, so the clipped rows and columns are
    zero."""
    Wd, G = plan.window, plan.group_pts
    off = plan.grouped.off[::G]
    per = max(1, SCHUR_TABLE_BYTES // (Wd * CNP * G * PNP * Y.element_size()))
    n = len(plan.starts)
    for g0 in range(0, n, per):
        g1 = min(g0 + per, n)
        o0, o1 = int(off[g0]), int(off[g1])
        if o0 == o1:
            continue
        ids = plan.grouped.obs[o0:o1]
        r = plan.grouped.row[o0:o1] - g0 * G
        grp, slot, cam = r // G, r % G, plan.cam[o0:o1]

        def table(X):
            t = X.new_zeros(g1 - g0, Wd, CNP, G, PNP)
            t[grp, cam, :, slot, :] = X[ids]
            return t.reshape(g1 - g0, Wd * CNP, G * PNP)
        blocks = torch.bmm(table(Y), table(W).transpose(1, 2))
        for g in range(g0, g1):
            if off[g] == off[g + 1]:
                continue
            a, b = plan.starts[g] * CNP, min(plan.starts[g] + Wd, C) * CNP
            S[a:b, a:b] -= blocks[g - g0, :b - a, :b - a]


def _window_plan(prob: BAProblem, num_cams: int, window: int,
                 group_pts: int) -> Optional[SchurWindows]:
    """The plan the assembly runs, as the JAX package gates it: window > 0
    and group_pts > 0 name the problem's plan (anything else raises), and
    a window of num_cams or more runs the full-C form.  The problem
    carries the plan; window / group_pts are kept beside it so that the
    entry points take the JAX package's arguments, and this check keeps
    the two from disagreeing."""
    if window <= 0 or group_pts <= 0:
        return None
    plan = prob.schur
    if plan is None or (plan.window, plan.group_pts) != (window, group_pts):
        raise ValueError(f"window={window}, group_pts={group_pts} do not "
                         "name the problem's window plan")
    return plan if window < num_cams else None


def assemble_schur_off(Y, W, g_p, prob: BAProblem, num_cams: int,
                       window: int = 0, group_pts: int = 0):
    """The point-coupled part of the reduced camera system: S_off
    [C·9, C·9] = −Σ_i Ỹ_i·W̃_iᵀ with Ỹ_i, W̃_i point i's dense camera
    tables [C·9, 3] (zero where the point is not observed), and rhs_off =
    −Σ_obs Y_o g_p[pt(o)] per camera [C, 9].  Sums over points, so a
    point-sharded problem's shards add up to the whole.

    The full-C form contracts [C·9, n·3] tables over chunks of n points
    under SCHUR_TABLE_BYTES: (C·9)²·3 multiply-adds a point.  With
    window / group_pts naming the problem's plan (`plan_schur_windows`),
    each group contracts inside its window only, (W·9)²·3 a point, and the
    wide points run the full-C form; the result is the same up to
    summation order, since every camera pair a grouped point couples lies
    inside its window."""
    C = num_cams
    rhs_off = -_cam_sum((Y * g_p[prob.obs_pt][:, None, :]).sum(2), prob)
    S = Y.new_zeros(C * CNP, C * CNP)
    plan = _window_plan(prob, C, window, group_pts)
    if plan is not None:
        _schur_windowed(Y, W, plan, C, S)
    _schur_full(Y, W, prob.obs_cam, prob.pt_views if plan is None
                else plan.wide, C, S)
    return S, rhs_off


def _add_block_diag(S_off, U_aug):
    C = U_aug.shape[0]
    idx = torch.arange(C, device=S_off.device)
    diag = torch.zeros(C, CNP, C, CNP, dtype=S_off.dtype, device=S_off.device)
    diag[idx, :, idx, :] = U_aug
    return S_off + diag.reshape(C * CNP, C * CNP)


def assemble_schur(U_aug, Y, W, g_c, g_p, prob: BAProblem):
    """The dense reduced camera system S [C·9, C·9] and its rhs [C·9]:
    S = blockdiag(U_aug) − Ỹᵀ·W̃, rhs = g_c − Σ_obs Y_o g_p[pt(o)] per
    camera (`assemble_schur_off`)."""
    S_off, rhs_off = assemble_schur_off(Y, W, g_p, prob, U_aug.shape[0])
    return _add_block_diag(S_off, U_aug), (g_c + rhs_off).reshape(-1)


def solve_schur(S, rhs):
    """Dense Cholesky solve (`sba_Axb_Chol`, sba_levmar.c:1368).  A system
    that is not positive definite gives NaN (as a failed factorization does
    in the JAX package), so the LM step is rejected; no host sync."""
    L, info = torch.linalg.cholesky_ex(S)
    x = torch.cholesky_solve(rhs[:, None], L)[:, 0]
    return torch.where(info == 0, x, torch.nan)


def _pcg(matvec, precond, rhs, max_iters: int, tol: float,
         check_every: int):
    """Preconditioned CG from 0 on vectors of any shape.  Iterations after
    convergence leave the state unchanged; the host checks for convergence
    every `check_every` iterations."""
    b2 = (rhs * rhs).sum()
    x = torch.zeros_like(rhs)
    r = rhs
    z = precond(r)
    p = z
    rz = (r * z).sum()
    for it in range(max_iters):
        go = (r * r).sum() > tol * tol * b2
        if it % check_every == 0:
            counter("ba_host_syncs")
            if not bool(go):
                break
        Ap = matvec(p)
        alpha = rz / torch.clamp((p * Ap).sum(), min=1e-300)
        x1 = x + alpha * p
        r1 = r - alpha * Ap
        z1 = precond(r1)
        rz1 = (r1 * z1).sum()
        p1 = z1 + (rz1 / torch.clamp(rz, min=1e-300)) * p
        x, r, z, p, rz = (torch.where(go, a, b) for a, b in
                          ((x1, x), (r1, r), (z1, z), (p1, p), (rz1, rz)))
    return x


def solve_schur_cg(S, rhs, max_iters: int = 100, tol: float = 1e-8,
                   check_every: int = 10):
    """Preconditioned CG on S with the block-Jacobi (SCHUR_JACOBI)
    preconditioner — Ceres' ITERATIVE_SCHUR path for > 200 cameras
    (src/BundleCeres.cpp:132-134,369-379); see `_pcg`."""
    C = S.shape[0] // CNP
    idx = torch.arange(C, device=S.device)
    blocks = S.reshape(C, CNP, C, CNP)[idx, :, idx, :]
    Minv = torch.linalg.inv(
        blocks + 1e-12 * torch.eye(CNP, dtype=S.dtype, device=S.device))

    def precond(r):
        return (Minv @ r.reshape(C, CNP, 1)).reshape(-1)
    return _pcg(lambda p: S @ p, precond, rhs, max_iters, tol, check_every)


def _solve_schur_cg_sharded(U_aug, Y, W, g_c, g_p, prob: BAProblem, mesh,
                            max_iters: int = 100, tol: float = 1e-8,
                            check_every: int = 10):
    """`solve_schur_cg` on a point-sharded problem without materializing
    S_off (the JAX package's matrix-free distributed PCG): the
    SCHUR_JACOBI preconditioner takes the true diagonal blocks
    U_aug_j − Σ_o Y_o W_oᵀ (one psum), and each product
    S·x = U_aug·x − Σ_o Y_o Σ_{o' ∈ views(pt(o))} W_o'ᵀ x[cam(o')] costs one
    [C, 9] psum.  Every rank runs the same iterations on replicated
    vectors.  Returns δq [C, 9]."""
    C = U_aug.shape[0]
    eye = torch.eye(CNP, dtype=U_aug.dtype, device=U_aug.device)
    ywt = (Y[:, :, None, :] * W[:, None, :, :]).sum(3)       # [O,9,9]
    rhs_off = _cam_sum((Y * g_p[prob.obs_pt][:, None, :]).sum(2), prob)
    D_off, rhs_off = mesh.psum_all(_cam_sum(ywt, prob), rhs_off)
    Minv = torch.linalg.inv(U_aug - D_off + 1e-12 * eye)
    rhs = g_c - rhs_off

    def matvec(x):
        t = (W * x[prob.obs_cam][:, :, None]).sum(1)          # [O,3]
        u = (Y * _point_sum(t, prob)[prob.obs_pt][:, None, :]).sum(2)
        return (U_aug @ x[:, :, None])[:, :, 0] - mesh.psum(_cam_sum(u, prob))

    def precond(r):
        return (Minv @ r[:, :, None])[:, :, 0]
    return _pcg(matvec, precond, rhs, max_iters, tol, check_every)


def back_substitute(Vinv, W, g_p, dcam, prob: BAProblem):
    """dp_i = V_i⁻¹ (g_p_i − Σ_{o∈views(i)} W_oᵀ dcam[cam(o)])."""
    wc = (W * dcam[prob.obs_cam][:, :, None]).sum(1)
    x = g_p - _point_sum(wc, prob)
    return (Vinv * x[:, None, :]).sum(2)


# --------------------------------------------------------------------------
# LM driver
# --------------------------------------------------------------------------

def _psum(x, mesh):
    return x if mesh is None else mesh.psum(x)


def _pmax(x, mesh):
    return x if mesh is None else mesh.pmax(x)


def _local_max(x):
    """x.max(), or −inf for an empty x (a rank may hold no points)."""
    return x.max() if x.numel() else x.new_full((), -math.inf)


def initial_mu(U, V, tau, mesh=None):
    """LM's first damping: tau·max(1, the largest diagonal entry of U and
    of V, over the ranks with `mesh`)."""
    maxdiag = torch.maximum(
        torch.diagonal(U, dim1=-2, dim2=-1).max(),
        _pmax(_local_max(torch.diagonal(V, dim1=-2, dim2=-1)), mesh))
    return tau * torch.clamp(maxdiag, min=1.0)


def eliminate_points(V, W, mu, prob: BAProblem):
    """The point side of one damped LM step: Vinv_i = (V_i + mu·I)⁻¹ per
    point and Y_o = W_o·Vinv_pt(o) per observation, which the reduced
    camera system takes (`assemble_schur_off`)."""
    eyep = torch.eye(PNP, dtype=V.dtype, device=V.device)
    Vinv = inv3(V + (mu + 1e-12) * eyep)
    return Vinv, (W[:, :, :, None] * Vinv[prob.obs_pt][:, None, :, :]).sum(2)


class _LMBody:
    """The arithmetic of one LM iteration on `prob`, which the eager loop and
    the CUDA graphs of `_LMGraphs` both run: `blocks` linearizes at (cam,
    pts), `step` takes one damped step from the loop state (the normal
    blocks, cam, pts, cost, mu, nu) and returns the next (cam, pts, cost,
    mu, nu) with the flags [accept, done].  The step reads its inputs
    before it returns, so a caller may write its outputs over them.

    With `mesh`, `prob` is this rank's point shard: U, g_c, S_off, the rhs
    and every cost, predicted decrease and norm are summed over the ranks,
    the largest V diagonal and point gradient taken over them; the camera
    solve runs replicated, the point back-substitution locally.  Camera
    constraint weights must come pre-scaled by 1/size (`shard_problem`)."""

    def __init__(self, prob: BAProblem, fix_points: bool, eps1, eps2,
                 loss: str, huber_param, solver: str, mesh=None,
                 window: int = 0, group_pts: int = 0):
        dtype, dev = prob.cam0.dtype, prob.cam0.device
        self.prob, self.fix_points, self.loss = prob, fix_points, loss
        self.eps1, self.eps2, self.solver, self.mesh = eps1, eps2, solver, mesh
        self.window, self.group_pts = window, group_pts
        self.huber_b = huber_param * huber_param
        self.eyec = torch.eye(CNP, dtype=dtype, device=dev)
        self.inv_s = 1.0 / prob.cam_scale
        self.frozen = torch.diag_embed(1.0 - prob.cam_mask)

    def blocks(self, cam, pts):
        U, V, W, g_c, g_p, cost = build_normal_blocks(
            cam, pts, self.prob, self.fix_points, loss=self.loss,
            huber_b=self.huber_b)
        if self.mesh is not None:
            U, g_c, cost = self.mesh.psum_all(U, g_c, cost)
        return U, V, W, g_c, g_p, cost

    def step(self, U, V, W, g_c, g_p, cam, pts, cost, mu, nu):
        prob, mesh, solver = self.prob, self.mesh, self.solver
        Vinv, Y = eliminate_points(V, W, mu, prob)
        U_aug = U + self.frozen + mu * self.eyec
        if solver == "cg" and mesh is not None:
            dcam = _solve_schur_cg_sharded(U_aug, Y, W, g_c, g_p, prob, mesh)
        else:
            S_off, rhs_off = assemble_schur_off(
                Y, W, g_p, prob, prob.cam0.shape[0], self.window,
                self.group_pts)
            if mesh is not None:
                S_off, rhs_off = mesh.psum_all(S_off, rhs_off)
            S = _add_block_diag(S_off, U_aug)
            rhs = (g_c + rhs_off).reshape(-1)
            dcam = solve_schur_cg(S, rhs) if solver == "cg" else \
                solve_schur(S, rhs)
        dcam = dcam.reshape(-1, CNP) * prob.cam_mask
        dpts = torch.zeros_like(pts) if self.fix_points else \
            back_substitute(Vinv, W, g_p, dcam, prob)
        cam_new = cam + dcam * self.inv_s[None]
        pts_new = pts + dpts
        # The point-side sums of this step: new cost, predicted decrease,
        # |pts|² before and after, |dpts|² (one all_reduce with a mesh).
        new_cost = compute_cost(cam_new, pts_new, prob, self.loss,
                                self.huber_b)
        pred_p = 0.5 * (dpts * (mu * dpts + g_p)).sum()
        sq_old, sq_new = (pts * pts).sum(), (pts_new * pts_new).sum()
        dpts_sq = (dpts * dpts).sum()
        if mesh is not None:
            new_cost, pred_p, sq_old, sq_new, dpts_sq = mesh.psum_all(
                new_cost, pred_p, sq_old, sq_new, dpts_sq)
        pred = 0.5 * (dcam * (mu * dcam + g_c)).sum() + pred_p
        rho = (cost - new_cost) / torch.clamp(pred, min=1e-300)
        accept = new_cost < cost
        gnorm = torch.maximum(g_c.abs().max(),
                              _pmax(_local_max(g_p.abs()), mesh))
        cam = torch.where(accept, cam_new, cam)
        pts = torch.where(accept, pts_new, pts)
        cost = torch.where(accept, new_cost, cost)
        mu = torch.where(accept, mu * torch.clamp(
            1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0), mu * nu)
        nu = torch.where(accept, 2.0, nu * 2.0)
        q = cam * prob.cam_scale[None]
        pnorm = torch.sqrt((q * q).sum() + torch.where(accept, sq_new, sq_old))
        dnorm = torch.sqrt((dcam * dcam).sum() + dpts_sq)
        done = (gnorm < self.eps1) | \
            (dnorm < self.eps2 * (pnorm + self.eps2)) | (mu > 1e30)
        return cam, pts, cost, mu, nu, torch.stack([accept, done])


def _lm_iterate(step, rebuild, max_iters: int) -> int:
    """The LM loop's control, whichever way its iterations run: `step()`
    takes one damped step and returns its flags [accept, done] on the
    device, which the host reads once an iteration; the loop stops when
    done or after max_iters steps and calls `rebuild()` (the normal blocks
    at the new state) after an accepted step that was not the last (a
    rejected step leaves cam and pts, and so the blocks, as they were).
    Returns the iterations run."""
    it = 0
    while it < max_iters:
        flags = step()
        it += 1
        counter("ba_host_syncs")
        accepted, finished = flags.tolist()
        if finished:
            break
        if accepted:
            rebuild()
    return it


def _lm_loop(prob: BAProblem, max_iters: int, fix_points: bool, tau, eps1,
             eps2, loss: str, huber_param, solver: str, mesh=None,
             window: int = 0, group_pts: int = 0, graphs=None):
    """The LM loop from prob.cam0 / pts0; returns (cam, pts, cost, cost0,
    iters, mu) with w NOT yet folded into R.  window / group_pts > 0 run
    the windowed Schur assembly on the problem's plan
    (`assemble_schur_off`); with `mesh`, `prob` is this rank's point shard
    (`_LMBody`).  `graphs` (`_lm_graphs`, made with the same arguments)
    replays the iterations as CUDA graphs; None runs them eagerly."""
    body = _LMBody(prob, fix_points, eps1, eps2, loss, huber_param, solver,
                   mesh, window, group_pts)
    if graphs is not None:
        return graphs.run(body, max_iters, tau)
    U, V, W, g_c, g_p, cost0 = body.blocks(prob.cam0, prob.pts0)
    # The loop state: U, V, W, g_c, g_p, cam, pts, cost, mu, nu.
    st = [U, V, W, g_c, g_p, prob.cam0, prob.pts0, cost0,
          initial_mu(U, V, tau, mesh),
          torch.tensor(2.0, dtype=prob.cam0.dtype, device=prob.cam0.device)]

    def step():
        out = body.step(*st)
        st[5:] = out[:5]
        return out[5]

    def rebuild():
        st[:5] = body.blocks(st[5], st[6])[:5]
    it = _lm_iterate(step, rebuild, max_iters)
    return st[5], st[6], st[7], cost0, it, st[8]


@functools.cache
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream every `_LMGraphs` of `device` captures on (a capture
    cannot use the default stream; one stream keeps one cuBLAS workspace)."""
    return torch.cuda.Stream(device=device)


@functools.cache
def _pool_anchor(device: torch.device) -> torch.cuda.CUDAGraph:
    """A one-fill graph kept for the process, whose memory pool every
    `_LMGraphs` of `device` captures into.  A pool that its graphs alone
    hold goes back to the device only at `empty_cache` or after a failed
    allocation, which the allocator does not retry inside a capture, so
    per-run pools pile up until a capture fails; one pool reuses its free
    blocks and stays at the largest run's size."""
    anchor = torch.cuda.CUDAGraph()
    with torch.cuda.stream(_capture_stream(device)):
        anchor.capture_begin(capture_error_mode="thread_local")
        torch.zeros(1, device=device)
        anchor.capture_end()
    return anchor


class _LMGraphs:
    """One LM iteration of one problem as two CUDA graphs, captured at the
    first `run` and replayed for every iteration of every run until
    `close`: `blocks` writes the normal blocks at the state's (cam, pts),
    `step` reads them and the state (cam, pts, cost, mu, nu) and writes the
    next state and the flags [accept, done], each into a tensor allocated
    before the capture.  The graphs launch the eager loop's kernels in its
    order on the same data, so a run returns the eager loop's results to
    the bit; the host still reads the flags once an iteration
    (`_lm_iterate`).

    Later runs must be of the first one's problem with other R0, cam0,
    pts0 and obs_valid, which a run copies in (run_ba_outlier_loop's
    passes).  `close` frees the graphs, whose memory goes back to the
    capture pool (`_pool_anchor`), and the capture stream's cuBLAS
    workspace."""

    def __init__(self):
        self.body = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self):
        if self.body is not None:
            self.g_step.reset()
            self.g_blocks.reset()
            # The capture stream's cuBLAS workspace, which the graphs ran
            # with, goes too (32 MiB on the H100; the next capture makes it
            # again), so no memory stays allocated past the run.
            torch._C._cuda_clearCublasWorkspaces()
        self.body = self.g_step = self.g_blocks = None
        self.blk = self.state = self.flags = None

    def _capture(self, body: _LMBody):
        """Static copies of what a pass changes, the state, and both
        graphs, on the capture stream (which first creates the cuBLAS and
        cuSOLVER handles and workspaces the capture must find made)."""
        p = body.prob
        dtype, dev = p.cam0.dtype, p.cam0.device
        C, P, O = p.cam0.shape[0], p.pts0.shape[0], p.obs_cam.shape[0]
        body.prob = p._replace(R0=torch.empty_like(p.R0),
                               obs_valid=torch.empty_like(p.obs_valid))

        def new(*shape):
            return torch.empty(shape, dtype=dtype, device=dev)
        self.blk = (new(C, CNP, CNP), new(P, PNP, PNP), new(O, CNP, PNP),
                    new(C, CNP), new(P, PNP), new())
        self.state = (new(C, CNP), new(P, PNP), new(), new(), new())
        self.flags = torch.empty(2, dtype=torch.bool, device=dev)
        stream = _capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with stage("ba_graph_capture"), torch.cuda.stream(stream):
            eye = torch.eye(CNP, dtype=dtype, device=dev)
            torch.cholesky_solve(eye, torch.linalg.cholesky_ex(eye)[0])
            torch.bmm(eye[None], eye[None])
            torch.mm(eye, eye)
            self.g_blocks = torch.cuda.CUDAGraph()
            self.g_blocks.capture_begin(pool=_pool_anchor(dev).pool(),
                                        capture_error_mode="thread_local")
            for dst, src in zip(self.blk, body.blocks(*self.state[:2])):
                dst.copy_(src)
            self.g_blocks.capture_end()
            self.g_step = torch.cuda.CUDAGraph()
            self.g_step.capture_begin(pool=_pool_anchor(dev).pool(),
                                      capture_error_mode="thread_local")
            out = body.step(*self.blk[:5], *self.state)
            for dst, src in zip(self.state + (self.flags,), out):
                dst.copy_(src)
            del out
            self.g_step.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        counter("ba_graph_captures", 2)
        self.body = body

    def run(self, body: _LMBody, max_iters: int, tau):
        """`_lm_loop` on body.prob by replay (captured from `body` at the
        first run)."""
        prob = body.prob
        if self.body is None:
            self._capture(body)
        self.body.prob.R0.copy_(prob.R0)
        self.body.prob.obs_valid.copy_(prob.obs_valid)
        cam, pts, cost, mu, nu = self.state
        cam.copy_(prob.cam0)
        pts.copy_(prob.pts0)
        self.g_blocks.replay()
        U, V, *_, cost0 = self.blk
        mu.copy_(initial_mu(U, V, tau))
        nu.fill_(2.0)
        cost.copy_(cost0)
        cost0 = cost0.clone()

        def step():
            self.g_step.replay()
            return self.flags
        it = _lm_iterate(step, self.g_blocks.replay, max_iters)
        counter("ba_graph_iters", it)
        return cam.clone(), pts.clone(), cost.clone(), cost0, it, mu.clone()


def _lm_graphs(prob: BAProblem, solver: str, mesh):
    """A context holding the `_LMGraphs` of `prob`'s LM runs where they
    engage: a CUDA device, one rank (the sharded loop runs collectives
    between its kernels) and the Cholesky solve (CG reads its convergence
    on the host every few steps).  Elsewhere it holds None, and the loop
    runs eagerly."""
    if prob.cam0.device.type != "cuda" or mesh is not None or \
            solver != "cholesky":
        return contextlib.nullcontext()
    return _LMGraphs()


def _fold(R0, cam):
    """Fold w into R (run_sfm's epilogue, sfm.c:876-929)."""
    return rot_update(R0, cam[:, 3:6]), torch.cat(
        [cam[:, :3], torch.zeros_like(cam[:, 3:6]), cam[:, 6:]], 1)


def run_ba(prob: BAProblem, max_iters: int = 150, fix_points: bool = False,
           tau: float = 1e-3, eps1: float = 1e-10, eps2: float = 1e-12,
           loss: str = "l2", huber_param: float = 25.0,
           solver: str = "cholesky", mesh=None, window: int = 0,
           group_pts: int = 0) -> BAResult:
    """Levenberg-Marquardt with Schur complement; mirrors run_sfm's SBA call
    (MAX_ITERS=150 `sfm.c:814`, opts `sfm.c:705-714`).  loss="huber" with
    solver="cg" is the Ceres backend's configuration.  With `mesh`, `prob`
    is this rank's point shard (see `_lm_loop`); `pts` is the shard's.
    window / group_pts (the plan's, from `plan_schur_windows`) run the
    covisibility-windowed Schur assembly on the plan `prob` carries; 0
    runs the full-C form.  They repeat the problem's plan only so that the
    arguments are the JAX package's (`_window_plan` checks they agree)."""
    counter(f"ba_runs_{prob.cam0.device.type}")
    with _lm_graphs(prob, solver, mesh) as graphs:
        cam, pts, cost, cost0, iters, mu = _lm_loop(
            prob, max_iters, fix_points, tau, eps1, eps2, loss, huber_param,
            solver, mesh, window, group_pts, graphs)
    counter("lm_iters", iters)
    R, cam = _fold(prob.R0, cam)
    return BAResult(cam=cam, R=R, pts=pts, cost=cost, initial_cost=cost0,
                    iters=iters, mu=mu)


# --------------------------------------------------------------------------
# BA + outlier-removal loop (RunSFM's re-bundle loop)
# --------------------------------------------------------------------------

class BAOutlierResult(NamedTuple):
    cam: torch.Tensor          # [C,9] final params (w folded)
    R: torch.Tensor            # [C,3,3]
    pts: torch.Tensor          # [P,3]
    obs_valid: torch.Tensor    # [O] final observation liveness
    pt_removed: torch.Tensor   # [P] True where the point was removed
    passes: int                # number of BA passes run
    iters: int                 # total LM iterations across passes
    n_outliers: np.ndarray     # [max_passes] outlier points found per pass
    stats: torch.Tensor        # [max_passes, C, 4]: nobs, mean, p80, thresh
    hist: torch.Tensor         # [max_passes, C, 10] error-bin counts
    hist_edges: torch.Tensor   # [max_passes, C, 2]: per-camera min/max
    avg_dist: torch.Tensor     # mean reprojection error, final pass
    too_few: bool              # live points dropped below min_points
    cost: torch.Tensor         # final pass cost
    initial_cost: torch.Tensor  # first pass initial cost


def _pass_stats(prob: BAProblem, cam, pts, R, ov, outlier_factor,
                min_thresh, max_thresh, cam_obs=None, mesh=None):
    """Per-camera reprojection statistics on the live observations
    (`src/Bundle.cpp:659-850`): distances, the p80 threshold clamped to
    [min, max], mean, and the 10-bin histogram.  `cam_obs` [C, S] lists
    each camera's observations (default prob.cam_views); with `mesh`, each
    rank's rows (one width on every rank, `build_cam_obs_table_sharded`)
    are all-gathered along the slot axis, so every rank computes the stats
    of all observations."""
    dtype = cam.dtype
    views = prob.cam_views if cam_obs is None else cam_obs
    pred, _ = _predict_obs(cam, pts, R, prob)
    d = torch.sqrt(((pred - prob.obs_xy) ** 2).sum(1))
    vm = _pad_row(ov)[views]                                 # [C,S]
    dc = _pad_row(d)[views]
    if mesh is not None:
        vm, dc = mesh.all_gather(vm, 1), mesh.all_gather(dc, 1)
    dmask = torch.where(vm, dc, torch.finfo(dtype).max)
    dsort = torch.sort(dmask, 1).values
    n = vm.sum(1)
    top = torch.clamp(n - 1, min=0)
    k = torch.minimum(torch.clamp(torch.round(0.8 * n.to(dtype)).long(),
                                  min=0), top)
    has = n > 0
    p80 = torch.where(has, dsort.gather(1, k[:, None])[:, 0], 0.0)
    thresh = torch.clamp(outlier_factor * p80, min_thresh, max_thresh)
    mean = torch.where(has, torch.where(vm, dc, 0.0).sum(1)
                       / torch.clamp(n, min=1), 0.0)
    pr_min = torch.where(has, dsort[:, 0], 0.0)
    pr_max = torch.where(has, dsort.gather(1, top[:, None])[:, 0], 0.0)
    step = (pr_max - pr_min) / 10.0
    edges = pr_min[:, None] + step[:, None] * torch.arange(
        1, 11, dtype=dtype, device=cam.device)[None, :]
    le = (dmask[:, :, None] <= edges[:, None, :]) & vm[:, :, None]
    cum = le.sum(1)
    cum[:, 9] = n
    bins = torch.diff(cum, dim=1, prepend=torch.zeros_like(cum[:, :1]))
    stats = torch.stack([n.to(dtype), mean, p80, thresh], 1)
    return d, thresh, stats, bins, torch.stack([pr_min, pr_max], 1)


def run_ba_outlier_loop(
    prob: BAProblem, max_iters: int = 150, fix_points: bool = False,
    tau: float = 1e-3, eps1: float = 1e-10, eps2: float = 1e-12,
    loss: str = "l2", huber_param: float = 25.0, solver: str = "cholesky",
    outlier_factor: float = 2.4, min_thresh: float = 8.0,
    max_thresh: float = 16.0, min_outliers: int = 40, min_points: int = 8,
    max_passes: int = 8, remove_outliers: bool = True,
    cam_obs: Optional[torch.Tensor] = None, mesh=None, window: int = 0,
    group_pts: int = 0,
) -> BAOutlierResult:
    """`RunSFM_SBA`'s outer loop (`src/Bundle.cpp:568-919`): BA, per-camera
    reprojection stats, adaptive threshold 1.2·outlier_num_stddev·p80
    clamped to [min_thresh, max_thresh], removal of every point with an
    observation above it, and a re-bundle while more than `min_outliers`
    points went; points anchored with a positive weight are never removed.
    The host reads the live-point and outlier counts once per pass.

    With `mesh`, `prob` is this rank's point shard and `cam_obs` its
    per-camera table (`parallel/ba_sharded.py`): the live-point and
    outlier counts and the mean error are summed over the ranks and the
    stats pass sees every rank's observations, so cam, R, the stats and
    the counts are replicated while pts, obs_valid and pt_removed are the
    shard's.  window / group_pts run the windowed Schur assembly, as in
    `run_ba`."""
    dtype, dev = prob.cam0.dtype, prob.cam0.device
    C, P = prob.cam0.shape[0], prob.pts0.shape[0]
    cam, pts, R0c, ov = prob.cam0, prob.pts0, prob.R0, prob.obs_valid
    removed = torch.zeros(P, dtype=torch.bool, device=dev)
    stats_b = torch.zeros((max_passes, C, 4), dtype=dtype, device=dev)
    hist_b = torch.zeros((max_passes, C, 10), dtype=torch.int64, device=dev)
    edge_b = torch.zeros((max_passes, C, 2), dtype=dtype, device=dev)
    nout_b = np.zeros(max_passes, np.int64)
    zero = torch.zeros((), dtype=dtype, device=dev)
    iters_tot, passes, n_out, too_few = 0, 0, 0, False
    avg, cost_f, cost_i = zero, zero, zero
    counter(f"ba_runs_{dev.type}")
    # The passes keep the problem's shapes, so they share one capture.
    with _lm_graphs(prob, solver, mesh) as graphs:
        while passes == 0 or (remove_outliers and passes < max_passes
                              and n_out > min_outliers):
            counter("ba_host_syncs")
            if int(_psum(_point_any(ov, prob).sum(), mesh)) < min_points:
                too_few = True
                break
            p = prob._replace(R0=R0c, cam0=cam, pts0=pts, obs_valid=ov)
            cam1, pts1, cost, cost0, iters, _ = _lm_loop(
                p, max_iters, fix_points, tau, eps1, eps2, loss, huber_param,
                solver, mesh, window, group_pts, graphs)
            R1, cam1 = _fold(R0c, cam1)
            d, thresh, stats, bins, edges = _pass_stats(
                prob, cam1, pts1, R1, ov, outlier_factor, min_thresh,
                max_thresh, cam_obs, mesh)
            bad_pt = _point_any(ov & (d > thresh[prob.obs_cam]), prob)
            if prob.pt_weight > 0:
                # Anchored points are kept (src/Bundle.cpp:798-803).
                bad_pt = bad_pt & ~(prob.pt_constrained > 0)
            avg = _psum(torch.where(ov, d, 0.0).sum(), mesh) / torch.clamp(
                _psum(ov.sum(), mesh), min=1)
            if remove_outliers:
                ov = ov & ~bad_pt[prob.obs_pt]
                removed = removed | bad_pt
            cam, pts, R0c = cam1, pts1, R1
            stats_b[passes], hist_b[passes], edge_b[passes] = \
                stats, bins, edges
            counter("ba_host_syncs")
            n_out = int(_psum(bad_pt.sum(), mesh))
            nout_b[passes] = n_out
            iters_tot += iters
            cost_f = cost
            if passes == 0:
                cost_i = cost0
            passes += 1
    counter("lm_iters", iters_tot)
    return BAOutlierResult(
        cam=cam, R=R0c, pts=pts, obs_valid=ov, pt_removed=removed,
        passes=passes, iters=iters_tot, n_outliers=nout_b, stats=stats_b,
        hist=hist_b, hist_edges=edge_b, avg_dist=avg, too_few=too_few,
        cost=cost_f, initial_cost=cost_i)

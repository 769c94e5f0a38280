"""Distributed bundle adjustment — port of
`bundler_sfm_tpu/parallel/ba_sharded.py`.

Each rank owns a shard of the points and ALL of their observations
(view-table locality); cameras are replicated.  Per LM iteration every rank
builds its local U/V/W blocks and partial Schur system; U, g_c, S_off, the
rhs and the cost are summed over the ranks (`ops/ba.py` with a `mesh`);
the dense camera solve runs replicated, identical on every rank; point
back-substitution is local.  This is SBA's U/V/W/S algebra
(`lib/sba-1.5/sba_levmar.c:1191-1373`) with the point sums turned into
collectives, and the same code as the single-device solver.

Camera constraints, which every shard's normal blocks add, are scaled by
1/size on the host so the sum counts them once.

The JAX package stacks every shard into [D, …] arrays in one process; here
every rank builds the same host arrays and keeps its own shard on its
device, so `shard_problem` and `build_cam_obs_table_sharded` return the
rank's shard and `unshard_*` all-gather the shards to every rank.  The
observations keep the port's flat layout (input order within the shard),
not the JAX package's [P, M] slot layout.

Points are laid out round-robin, or by an explicit (shard, local row) map.
`plan_shard_windows` (a copy of the JAX package's) makes one from a
`plan_schur_windows` plan: whole point groups go to shards, so each rank
runs the covisibility-windowed Schur assembly over its own groups
(`shard_problem(..., schur_win_local=, window=, group_pts=)`) and the
all_reduce of S_off adds the window blocks, as the JAX package's psum
does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bundler_sfm_tpu_torch.ops.ba import (
    BAOutlierResult, BAProblem, BAResult, build_problem, run_ba,
    run_ba_outlier_loop, _view_table,
)


def plan_shard_windows(row_of, schur_win, window: int, group_pts: int,
                       n_rows: int, num_shards: int):
    """Partition a `plan_schur_windows` plan across shards (a copy of the
    JAX package's): point-groups go round-robin over shards (group g ->
    shard g mod D at local group g div D), the wide-span tail round-robin
    after the groups.  Returns (shard_of_pt [P], local_idx [P],
    schur_win_local [D, nwin_s], rows_per_shard); pass the first three to
    shard_problem (with the plan's window and group_pts), shard_of_pt to
    build_cam_obs_table_sharded and the map to unshard_with_map.  Each
    shard owns whole groups, so its local windowed assembly is the
    one-device one over its groups and the all_reduce adds the window
    blocks."""
    D = num_shards
    nwin = len(schur_win)
    nwin_s = -(-nwin // D)
    G = group_pts
    wide = n_rows - nwin * G
    wide_s = -(-wide // D) if wide else 0
    rows_per_shard = nwin_s * G + wide_s

    r = np.asarray(row_of, np.int64)
    grouped = r < nwin * G
    g = r // G
    shard_of_pt = np.where(grouped, g % D, (r - nwin * G) % D).astype(
        np.int32)
    local_idx = np.where(
        grouped, (g // D) * G + r % G,
        nwin_s * G + (r - nwin * G) // D).astype(np.int64)
    sw = np.zeros((D, nwin_s), np.int32)
    for s in range(D):
        starts = schur_win[s::D]
        sw[s, :len(starts)] = starts
    return shard_of_pt, local_idx, sw, rows_per_shard


def _layout(num_points: int, num_shards: int, shard_of_pt, local_idx):
    """(shard_of_pt, local_idx, rows per shard): round-robin by default
    (point p -> shard p % D, row p // D)."""
    if shard_of_pt is None:
        shard_of_pt = np.arange(num_points) % num_shards
        local_idx = np.arange(num_points) // num_shards
    shard_of_pt = np.asarray(shard_of_pt, np.int64)
    local_idx = np.asarray(local_idx, np.int64)
    rows = int(local_idx.max()) + 1 if num_points else 1
    return shard_of_pt, local_idx, rows


def shard_problem(
    R0, cam0, pts0, obs_cam, obs_pt, obs_xy, mesh, *, est_focal=True,
    est_distortion=True, cam_constrained=None, cam_constraints=None,
    cam_weights=None, pt_constrained=None, pt_constraints=None,
    pt_weight: float = 0.0, shard_of_pt: Optional[np.ndarray] = None,
    local_idx: Optional[np.ndarray] = None,
    schur_win_local: Optional[np.ndarray] = None, window: int = 0,
    group_pts: int = 0,
) -> BAProblem:
    """This rank's shard of the problem, on mesh.device: the points of
    shard mesh.rank at their local rows (every shard padded to one row
    count, as the JAX package pads to pad_pts_per_shard) and their
    observations in input order, cameras whole, camera weights / size.
    Round-robin unless shard_of_pt / local_idx give the layout;
    schur_win_local [D, nwin_s] (from plan_shard_windows, with the plan's
    window and group_pts) gives each rank the window plan of its groups:
    local group l holds local rows [l·G, (l+1)·G)."""
    D, s = mesh.size, mesh.rank
    obs_cam = np.asarray(obs_cam, np.int64)
    obs_pt = np.asarray(obs_pt, np.int64)
    obs_xy = np.asarray(obs_xy)
    pts0 = np.asarray(pts0)
    shard_of_pt, local_idx, rows = _layout(len(pts0), D, shard_of_pt,
                                           local_idx)
    sel = shard_of_pt[obs_pt] == s
    p_sel = shard_of_pt == s
    rows_s = local_idx[p_sel]

    def scatter(x, tail=()):
        out = np.zeros((rows,) + tail)
        out[rows_s] = np.asarray(x)[p_sel]
        return out
    pc_l = pt_con_l = None
    if pt_constrained is not None:
        pc_l = scatter(pt_constrained)
        pt_con_l = scatter(pt_constraints, (3,))
    plan = None
    if schur_win_local is not None:
        plan = (np.arange(rows), np.asarray(schur_win_local)[s], window,
                group_pts, rows)
    cw = None if cam_weights is None else np.asarray(cam_weights) / D
    return build_problem(
        R0, cam0, scatter(pts0, (3,)), obs_cam[sel],
        local_idx[obs_pt[sel]], obs_xy[sel], est_focal=est_focal,
        est_distortion=est_distortion, cam_constrained=cam_constrained,
        cam_constraints=cam_constraints, cam_weights=cw,
        pt_constrained=pc_l, pt_constraints=pt_con_l, pt_weight=pt_weight,
        schur_plan=plan, device=mesh.device)


def build_cam_obs_table_sharded(
    obs_cam, obs_pt, mesh, num_cams: int,
    shard_of_pt: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """This rank's per-camera observation table [C, S] on mesh.device:
    the ids of its shard's observations (in the order `shard_problem`
    keeps them) of each camera, padded with the shard's observation count.
    S is the largest per-camera count over every shard, so the stats pass
    all-gathers rows of one width.  Round-robin unless shard_of_pt gives
    the layout (the rows within a shard do not enter: the table holds
    observation ids, not the JAX package's slot rows)."""
    D = mesh.size
    obs_cam = np.asarray(obs_cam, np.int64)
    obs_pt = np.asarray(obs_pt, np.int64)
    shard_of = obs_pt % D if shard_of_pt is None else \
        np.asarray(shard_of_pt, np.int64)[obs_pt]
    counts = np.zeros((D, num_cams), np.int64)
    np.add.at(counts, (shard_of, obs_cam), 1)
    S = max(1, int(counts.max(initial=0)))
    mine = obs_cam[shard_of == mesh.rank]
    table = _view_table(mine, num_cams)
    table = np.pad(table, ((0, 0), (0, S - table.shape[1])),
                   constant_values=len(mine))
    return torch.as_tensor(table, dtype=torch.int64, device=mesh.device)


def run_ba_sharded(prob: BAProblem, mesh, max_iters: int = 100,
                   fix_points: bool = False, tau: float = 1e-3,
                   eps1: float = 1e-10, eps2: float = 1e-12,
                   solver: str = "cholesky", window: int = 0,
                   group_pts: int = 0) -> BAResult:
    """LM with point-sharded Schur assembly on `prob` from shard_problem.
    solver="cholesky" sums the dense S_off over the ranks and factors it
    replicated (right for up to a few hundred cameras); solver="cg" never
    materializes S_off: matrix-free PCG whose products cost one [C, 9]
    all_reduce each.  window / group_pts (with a plan_shard_windows
    layout) run each rank's windowed assembly.  Returns replicated cameras
    and this rank's points."""
    return run_ba(prob, max_iters, fix_points, tau, eps1, eps2, "l2", 25.0,
                  solver, mesh=mesh, window=window, group_pts=group_pts)


def run_ba_outlier_loop_sharded(
    prob: BAProblem, cam_obs: torch.Tensor, mesh, max_iters: int = 150,
    fix_points: bool = False, tau: float = 1e-3, eps1: float = 1e-10,
    eps2: float = 1e-12, loss: str = "l2", huber_param: float = 25.0,
    solver: str = "cholesky", outlier_factor: float = 2.4,
    min_thresh: float = 8.0, max_thresh: float = 16.0,
    min_outliers: int = 40, min_points: int = 8, max_passes: int = 8,
    remove_outliers: bool = True, window: int = 0, group_pts: int = 0,
) -> BAOutlierResult:
    """The RunSFM outlier loop over point-sharded ranks: `prob` from
    shard_problem, `cam_obs` from build_cam_obs_table_sharded.  Each rank
    gathers its own per-camera distance rows and one all_gather per stats
    pass assembles them.  cam, R, the stats and the counts come back
    replicated; pts, obs_valid and pt_removed are this rank's.
    window / group_pts run each rank's windowed assembly."""
    return run_ba_outlier_loop(
        prob, max_iters, fix_points, tau, eps1, eps2, loss, huber_param,
        solver, outlier_factor, min_thresh, max_thresh, min_outliers,
        min_points, max_passes, remove_outliers, cam_obs=cam_obs, mesh=mesh,
        window=window, group_pts=group_pts)


def _gather_shards(x_local: torch.Tensor, mesh) -> np.ndarray:
    """[D, rows, ...] of every rank's x_local (one shape on every rank)."""
    return mesh.all_gather(x_local[None], 0).cpu().numpy()


def unshard_flat(x_local: torch.Tensor, mesh, n: int) -> np.ndarray:
    """Round-robin point shards -> [n, ...] in input point order, on every
    rank."""
    arr = _gather_shards(x_local, mesh)
    D = arr.shape[0]
    out = np.zeros((n,) + arr.shape[2:], dtype=arr.dtype)
    for s in range(D):
        idx = np.arange(s, n, D)
        out[idx] = arr[s, :len(idx)]
    return out


def unshard_points(pts_local: torch.Tensor, mesh,
                   num_points: int) -> np.ndarray:
    """Round-robin [rows, 3] point shards -> [num_points, 3]."""
    return unshard_flat(pts_local, mesh, num_points)


def unshard_with_map(x_local: torch.Tensor, mesh, shard_of_pt,
                     local_idx) -> np.ndarray:
    """Shards under an explicit (shard, local row) point map -> [P, ...] in
    input point order, on every rank."""
    arr = _gather_shards(x_local, mesh)
    return arr[np.asarray(shard_of_pt), np.asarray(local_idx)]

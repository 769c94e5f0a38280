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
not the JAX package's [P, M] slot layout.  The covisibility-window plan
(`plan_shard_windows`) is not ported: points are laid out round-robin and
the sharded path runs the plain assembly, as the JAX package does whenever
`plan_schur_windows` returns None.
"""

from __future__ import annotations

import numpy as np
import torch

from bundler_sfm_tpu_torch.ops.ba import (
    BAOutlierResult, BAProblem, BAResult, build_problem, run_ba,
    run_ba_outlier_loop, _view_table,
)


def shard_problem(
    R0, cam0, pts0, obs_cam, obs_pt, obs_xy, mesh, *, est_focal=True,
    est_distortion=True, cam_constrained=None, cam_constraints=None,
    cam_weights=None, pt_constrained=None, pt_constraints=None,
    pt_weight: float = 0.0,
) -> BAProblem:
    """This rank's shard of the problem, on mesh.device: point p goes to
    shard p % size at row p // size (every shard padded to one row count,
    as the JAX package pads to pad_pts_per_shard), with its observations in
    input order; cameras whole, camera weights / size."""
    D, s = mesh.size, mesh.rank
    obs_pt = np.asarray(obs_pt, np.int64)
    pts0 = np.asarray(pts0)
    rows = max(1, -(-len(pts0) // D))
    sel = obs_pt % D == s

    def shard(x, tail=()):
        out = np.zeros((rows,) + tail)
        mine = np.asarray(x)[s::D]
        out[:len(mine)] = mine
        return out
    pc_l = pt_con_l = None
    if pt_constrained is not None:
        pc_l = shard(pt_constrained)
        pt_con_l = shard(pt_constraints, (3,))
    cw = None if cam_weights is None else np.asarray(cam_weights) / D
    return build_problem(
        R0, cam0, shard(pts0, (3,)), np.asarray(obs_cam, np.int64)[sel],
        obs_pt[sel] // D, np.asarray(obs_xy)[sel], est_focal=est_focal,
        est_distortion=est_distortion, cam_constrained=cam_constrained,
        cam_constraints=cam_constraints, cam_weights=cw,
        pt_constrained=pc_l, pt_constraints=pt_con_l, pt_weight=pt_weight,
        device=mesh.device)


def build_cam_obs_table_sharded(obs_cam, obs_pt, mesh,
                                num_cams: int) -> torch.Tensor:
    """This rank's per-camera observation table [C, S] on mesh.device:
    the ids of its shard's observations (in the order `shard_problem`
    keeps them) of each camera, padded with the shard's observation count.
    S is the largest per-camera count over every shard, so the stats pass
    all-gathers rows of one width."""
    D = mesh.size
    obs_cam = np.asarray(obs_cam, np.int64)
    shard_of = np.asarray(obs_pt, np.int64) % D
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
                   solver: str = "cholesky") -> BAResult:
    """LM with point-sharded Schur assembly on `prob` from shard_problem.
    solver="cholesky" sums the dense S_off over the ranks and factors it
    replicated (right for up to a few hundred cameras); solver="cg" never
    materializes S_off: matrix-free PCG whose products cost one [C, 9]
    all_reduce each.  Returns replicated cameras and this rank's points."""
    return run_ba(prob, max_iters, fix_points, tau, eps1, eps2, "l2", 25.0,
                  solver, mesh=mesh)


def run_ba_outlier_loop_sharded(
    prob: BAProblem, cam_obs: torch.Tensor, mesh, max_iters: int = 150,
    fix_points: bool = False, tau: float = 1e-3, eps1: float = 1e-10,
    eps2: float = 1e-12, loss: str = "l2", huber_param: float = 25.0,
    solver: str = "cholesky", outlier_factor: float = 2.4,
    min_thresh: float = 8.0, max_thresh: float = 16.0,
    min_outliers: int = 40, min_points: int = 8, max_passes: int = 8,
    remove_outliers: bool = True,
) -> BAOutlierResult:
    """The RunSFM outlier loop over point-sharded ranks: `prob` from
    shard_problem, `cam_obs` from build_cam_obs_table_sharded.  Each rank
    gathers its own per-camera distance rows and one all_gather per stats
    pass assembles them.  cam, R, the stats and the counts come back
    replicated; pts, obs_valid and pt_removed are this rank's."""
    return run_ba_outlier_loop(
        prob, max_iters, fix_points, tau, eps1, eps2, loss, huber_param,
        solver, outlier_factor, min_thresh, max_thresh, min_outliers,
        min_points, max_passes, remove_outliers, cam_obs=cam_obs, mesh=mesh)


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

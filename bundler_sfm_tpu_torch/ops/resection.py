"""Camera resection — batched 6-point DLT RANSAC + RQ verification; port of
`bundler_sfm_tpu/ops/resection.py`.

Reference: `find_projection_3x4_ransac` (`lib/imagelib/triangulate.c`) and
`FindAndVerifyCamera` (`src/Bundle.cpp:2887-2990`): DLT for P, RQ split
into K·R, sign fixing, cheirality-gated inlier counting with a strong and a
weak threshold.  Image = (-q0/q2, -q1/q2) for q = P·[X;1].

Every function is batched over a leading candidate dimension B (one
registration round's images); the RANSAC draw is an input (`samples`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bundler_sfm_tpu_torch.ops.linalg_small import cholesky_solve, solve3
from bundler_sfm_tpu_torch.ops.ransac import gather_rows
from bundler_sfm_tpu_torch.ops.rotations import fix_intrinsics_sign, rq3


def _normalization(X, x, w):
    """Hartley normalization of both sides over the weighted rows: returns
    (Xn, xn, T2inv, T3) with P = T2⁻¹·P̃·T3 undoing it (the translation of
    T2⁻¹ negated by the -z image convention)."""
    count = torch.clamp(w.sum(-1), min=1.0)[..., None]
    cX = (X * w[..., None]).sum(-2) / count
    dX = torch.sqrt(((X - cX[..., None, :]) ** 2).sum(-1) + 1e-300)
    sX = math.sqrt(3.0) / torch.clamp((dX * w).sum(-1) / count[..., 0],
                                      min=1e-12)
    Xn = (X - cX[..., None, :]) * sX[..., None, None]
    cx = (x * w[..., None]).sum(-2) / count
    dx = torch.sqrt(((x - cx[..., None, :]) ** 2).sum(-1) + 1e-300)
    sx = math.sqrt(2.0) / torch.clamp((dx * w).sum(-1) / count[..., 0],
                                      min=1e-12)
    xn = (x - cx[..., None, :]) * sx[..., None, None]
    zero = torch.zeros_like(sx)
    one = torch.ones_like(sx)
    T2inv = torch.stack([
        torch.stack([1.0 / sx, zero, -cx[..., 0]], -1),
        torch.stack([zero, 1.0 / sx, -cx[..., 1]], -1),
        torch.stack([zero, zero, one], -1)], -2)
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(
        sX.shape + (3, 3))
    top = sX[..., None, None] * torch.cat([eye, -cX[..., :, None]], -1)
    bottom = torch.stack([zero, zero, zero, one], -1)[..., None, :]
    T3 = torch.cat([top, bottom], -2)
    return Xn, xn, T2inv, T3


def _dlt_rows(Xn, xn):
    """The two DLT rows of each correspondence, [..., N, 12] each."""
    Xh = torch.cat([Xn, torch.ones_like(Xn[..., :1])], -1)
    zero = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zero, xn[..., 0:1] * Xh], -1)
    r2 = torch.cat([zero, Xh, xn[..., 1:2] * Xh], -1)
    return r1, r2


def fit_projection_dlt(X: torch.Tensor, x: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Weighted homogeneous DLT for P [..., 3, 4] from X [..., N, 3] and
    x [..., N, 2] (rows weighted by mask): the smallest eigenvector of the
    Hartley-normalized AᵀA (its sign is arbitrary)."""
    w = mask.to(X.dtype)
    Xn, xn, T2inv, T3 = _normalization(X, x, w)
    r1, r2 = _dlt_rows(Xn, xn)
    A = torch.cat([r1, r2], -2)
    ww = torch.cat([w, w], -1)
    AtA = (A * ww[..., None]).transpose(-1, -2) @ A
    _, vecs = torch.linalg.eigh(AtA)
    Pn = vecs[..., :, 0].unflatten(-1, (3, 4))
    return T2inv @ Pn @ T3


def projection_residual_cheirality(P: torch.Tensor, X: torch.Tensor,
                                   x: torch.Tensor) -> torch.Tensor:
    """Reprojection distance of X [..., N, 3] / x [..., N, 2] under P
    [..., 3, 4] (broadcasting), +inf where the point is behind the camera
    once P's global sign is fixed by sign(det P[:, :3])."""
    sign = torch.sign(torch.linalg.det(P[..., 0:3]))
    sign = torch.where(sign == 0, 1.0, sign)
    p = P[..., None, :, :]                                       # [..., 1,3,4]
    X0, X1, X2 = X[..., 0], X[..., 1], X[..., 2]
    q = [p[..., i, 0] * X0 + p[..., i, 1] * X1 + p[..., i, 2] * X2
         + p[..., i, 3] for i in range(3)]
    behind = sign[..., None] * q[2] > 0.0
    d0 = -q[0] / q[2] - x[..., 0]
    d1 = -q[1] / q[2] - x[..., 1]
    dist = torch.sqrt(d0 * d0 + d1 * d1)
    return torch.where(behind, torch.inf, dist)


def find_projection_ransac(samples, X, x, n_valid, threshold):
    """RANSAC P from padded 2D-3D correspondences.

    samples [B, R, 6]; X [B, N, 3]; x [B, N, 2]; n_valid [B]; threshold in
    px.  Each round's 12×12 normal matrix is the sum of its six samples'
    outer products under one global Hartley normalization and is solved
    inhomogeneously with P̃[2,3] = 1 (an 11×11 Cholesky with trace-scaled
    damping); the winner is polished by the homogeneous DLT on its inliers,
    kept if it explains at least as many.  Returns (P [B,3,4], inlier_mask
    [B,N], num_inliers [B])."""
    B, N, _ = X.shape
    R = samples.shape[1]
    dtype = X.dtype
    valid = torch.arange(N, device=X.device) < n_valid[:, None]
    Xn, xn, T2inv, T3 = _normalization(X, x, valid.to(dtype))
    r1, r2 = _dlt_rows(Xn, xn)
    outer = (r1[..., :, None] * r1[..., None, :]
             + r2[..., :, None] * r2[..., None, :]).flatten(-2)  # [B, N, 144]
    M = gather_rows(outer, samples).sum(-2).unflatten(-1, (12, 12))
    eye11 = torch.eye(11, dtype=dtype, device=X.device)
    tr = torch.diagonal(M[..., :11, :11], dim1=-2, dim2=-1).sum(-1)
    A11 = M[..., :11, :11] + (1e-9 / 11.0) * tr[..., None, None] * eye11
    p11 = cholesky_solve(A11, -M[..., :11, 11])
    Pn = torch.cat([p11, torch.ones_like(p11[..., :1])], -1).unflatten(
        -1, (3, 4))                                              # [B, R, 3, 4]
    Ph = T2inv[:, None] @ Pn @ T3[:, None]
    resid = projection_residual_cheirality(Ph, X[:, None], x[:, None])
    ok = torch.isfinite(resid) & (resid < threshold) & valid[:, None, :]
    del resid
    counts = ok.sum(-1)
    best = torch.argmax(counts, dim=-1)
    rows = torch.arange(B, device=X.device)
    P, inl, cnt = Ph[rows, best], ok[rows, best], counts[rows, best]
    P2 = fit_projection_dlt(X, x, inl)
    r2d = projection_residual_cheirality(P2, X, x)
    inl2 = valid & (r2d < threshold)
    n2 = inl2.sum(-1)
    better = n2 >= cnt
    return (torch.where(better[:, None, None], P2, P),
            torch.where(better[:, None], inl2, inl), torch.maximum(n2, cnt))


class VerifiedCamera(NamedTuple):
    ok: torch.Tensor            # [B] bool
    K: torch.Tensor             # [B,3,3] intrinsics (K22 = 1)
    R: torch.Tensor             # [B,3,3]
    t: torch.Tensor             # [B,3] world->cam translation
    inliers: torch.Tensor       # [B,N] strong inliers (< threshold)
    inliers_weak: torch.Tensor  # [B,N] weak inliers (< weak threshold)


def find_and_verify_camera(samples, X, x, n_valid, threshold,
                           weak_threshold, min_inliers: int = 6
                           ) -> VerifiedCamera:
    """`FindAndVerifyCamera` (`src/Bundle.cpp:2887-2990`) for a batch of
    candidates: threshold = projection_estimation_threshold (4.0), weak =
    16× that, min_inliers = MIN_INLIERS_EST_PROJECTION (6)."""
    P, _, cnt = find_projection_ransac(samples, X, x, n_valid, threshold)
    sgn = torch.sign(torch.linalg.det(P[..., 0:3]))
    P = P * torch.where(sgn == 0, 1.0, sgn)[:, None, None]
    K, Q = rq3(P[..., 0:3])
    K, R = fix_intrinsics_sign(K, Q)
    t = solve3(K, P[..., 3])
    K = K / K[..., 2:3, 2:3]
    q = X @ R.transpose(-1, -2) + t[:, None, :]
    q2 = q @ K.transpose(-1, -2)
    pred = -q2[..., 0:2] / q2[..., 2:3]
    diff = torch.sqrt(((pred - x) ** 2).sum(-1))
    valid = torch.arange(X.shape[1], device=X.device) < n_valid[:, None]
    num_behind = (valid & (q[..., 2] > 0.0)).sum(-1)
    ok = (cnt > min_inliers) & (num_behind < 0.9 * n_valid)
    return VerifiedCamera(ok=ok, K=K, R=R, t=t,
                          inliers=valid & (diff < threshold),
                          inliers_weak=valid & (diff < weak_threshold))

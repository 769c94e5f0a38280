"""Triangulation — two-view and padded N-view DLT with Gauss-Newton polish;
port of `bundler_sfm_tpu/ops/triangulate.py`.

Reference: `triangulate` / `triangulate_n` (`lib/imagelib/triangulate.c`),
drivers `Triangulate` / `TriangulateNViews` (`src/BundleAdd.cpp:47-127`).

Ray convention: a camera with world→cam rotation R and translation t = -R·c
sees X at direction (R X + t) ∝ (px, py, 1) with (px, py) = (-u/f, -v/f), the
NEGATED normalized image coordinates.

Every function is batched over leading dimensions: a track is a padded
[..., M] set of views with a mask, so a whole registration round's tracks
triangulate in one set of tensor ops.
"""

from __future__ import annotations

import torch

from bundler_sfm_tpu_torch.ops.linalg_small import solve3


def _eye3(x: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device)


def _linear_triangulate(pv, Rs, ts, mask):
    """Masked linear triangulation.  pv [..., M, 2], Rs [..., M, 3, 3], ts
    [..., M, 3], mask [..., M] -> X [..., 3].  Rows (triangulate_n):
        (R0 - px·R2)·X = t2·px - t0,   (R1 - py·R2)·X = t2·py - t1."""
    w = mask.to(pv.dtype)
    r0, r1, r2 = Rs[..., 0, :], Rs[..., 1, :], Rs[..., 2, :]
    px, py = pv[..., 0:1], pv[..., 1:2]
    A = torch.cat([r0 - px * r2, r1 - py * r2], -2)              # [..., 2M, 3]
    b = torch.cat([ts[..., 2] * pv[..., 0] - ts[..., 0],
                   ts[..., 2] * pv[..., 1] - ts[..., 1]], -1)    # [..., 2M]
    ww = torch.cat([w, w], -1)
    Aw = A * ww[..., None]
    AtA = Aw.transpose(-1, -2) @ A + 1e-12 * _eye3(pv)
    return solve3(AtA, (Aw.transpose(-1, -2) @ b[..., None])[..., 0])


def _polish_residuals(X, pv, Rs, ts, w):
    q = (Rs @ X[..., None, :, None])[..., 0] + ts                # [..., M, 3]
    return (q[..., 0:2] / q[..., 2:3] - pv) * w[..., None], q


def _gn_polish(X, pv, Rs, ts, mask, num_iters: int):
    """Masked Gauss-Newton on the normalized reprojection residual (replaces
    the lmdif polish of `triangulate_n`); a step is kept only if it lowers
    the squared residual.  The Jacobian is the forward-mode one the JAX
    package takes: d(q/q_z)/dX = R/q_z - q·R_z/q_z²."""
    w = mask.to(X.dtype)
    eye = _eye3(X)
    for _ in range(num_iters):
        r, q = _polish_residuals(X, pv, Rs, ts, w)
        qz = q[..., 2]
        J = (Rs[..., 0:2, :] / qz[..., None, None]
             + (-Rs[..., 2:3, :] * q[..., 0:2, None])
             * (1.0 / (qz * qz))[..., None, None]) * w[..., None, None]
        J = J.flatten(-3, -2)                                     # [..., 2M, 3]
        r = r.flatten(-2)
        JtJ = J.transpose(-1, -2) @ J + 1e-12 * eye
        Xn = X - solve3(JtJ, (J.transpose(-1, -2) @ r[..., None])[..., 0])
        rn, _ = _polish_residuals(Xn, pv, Rs, ts, w)
        better = (rn * rn).sum((-2, -1)) < (r * r).sum(-1)
        X = torch.where(better[..., None], Xn, X)
    return X


def triangulate_track(pv, Rs, ts, mask, num_polish: int = 5):
    """Triangulate padded tracks; returns (X [..., 3], rms normalized
    error [...])."""
    X = _linear_triangulate(pv, Rs, ts, mask)
    X = _gn_polish(X, pv, Rs, ts, mask, num_polish)
    w = mask.to(X.dtype)
    r, _ = _polish_residuals(X, pv, Rs, ts, torch.ones_like(w))
    err = ((r * r).sum(-1) * w).sum(-1) / torch.clamp(w.sum(-1), min=1.0)
    return X, torch.sqrt(err)


def triangulate_tracks(pv, Rs, ts, mask, num_polish: int = 5):
    """Tracks [T, M] of negated normalized views with w2c cameras (the JAX
    package's vmapped `triangulate_track`, used by `RefinePoints`); returns
    (X [T, 3], rms normalized error [T])."""
    return triangulate_track(pv, Rs, ts, mask, num_polish)


def triangulate_tracks_pixels(xy, fs, ks, Rs, centers, mask,
                              num_polish: int = 5):
    """N-view triangulation from PIXEL observations and full cameras.

    xy [T,M,2] centered pixel coords; fs [T,M]; ks [T,M,2] (k1, k2, undone
    by two fixed-point steps); Rs [T,M,3,3]; centers [T,M,3]; mask [T,M].
    Returns (X [T,3], rms PIXEL reprojection error [T] with distortion
    applied — what `TriangulateNViews` returns, `src/BundleAdd.cpp:98-120`).
    """
    un = xy / fs[..., None]
    r2 = (un * un).sum(-1, keepdim=True)
    for _ in range(2):
        factor = 1.0 + ks[..., 0:1] * r2 + ks[..., 1:2] * r2 * r2
        r2 = ((un / factor) ** 2).sum(-1, keepdim=True)
    factor = 1.0 + ks[..., 0:1] * r2 + ks[..., 1:2] * r2 * r2
    pv = -(un / factor)
    ts = -(Rs @ centers[..., None])[..., 0]
    X, _ = triangulate_track(pv, Rs, ts, mask, num_polish)
    q = (Rs @ (X[:, None, :] - centers)[..., None])[..., 0]
    pred = -fs[..., None] * q[..., 0:2] / q[..., 2:3]
    rr = (pred * pred).sum(-1, keepdim=True) / (fs[..., None] ** 2)
    pred = pred * (1.0 + ks[..., 0:1] * rr + ks[..., 1:2] * rr * rr)
    w = mask.to(xy.dtype)
    err = (((pred - xy) ** 2).sum(-1) * w).sum(1) / torch.clamp(w.sum(1),
                                                                min=1.0)
    return X, torch.sqrt(err)


def triangulate_two_view(p_n, q_n, R1, t1, R2, t2, num_polish: int = 5):
    """Two-view triangulation of correspondences p_n, q_n [..., 2] (negated
    normalized coords) between cameras (R1, t1) and (R2, t2) (w2c; the
    cameras broadcast against the correspondences).  Returns (X [..., 3],
    rms normalized error [...])."""
    lead = p_n.shape[:-1]
    pv = torch.stack([p_n, q_n], -2)
    Rs = torch.stack([R1.expand(lead + (3, 3)), R2.expand(lead + (3, 3))], -3)
    ts = torch.stack([t1.expand(lead + (3,)), t2.expand(lead + (3,))], -2)
    mask = torch.ones(lead + (2,), dtype=torch.bool, device=p_n.device)
    return triangulate_track(pv, Rs, ts, mask, num_polish)

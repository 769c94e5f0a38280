"""Homography estimation — batched 4-point DLT RANSAC; port of
`bundler_sfm_tpu/ops/homography.py`.

Reference: `EstimateTransform` (`src/Register.cpp:49-159`, MotionHomography,
256 rounds @ 6.0 px by default), inlier test = one-directional transfer
distance (`CountInliers`, `src/Register.cpp:161-199`), final least-squares
refit on the inliers (`LeastSquaresFit`, `src/Register.cpp:201`).
Batched over a leading problem dimension; the RANSAC draw is an input.
"""

from __future__ import annotations

import torch

from bundler_sfm_tpu_torch.ops.linalg_small import cholesky_solve, inv3
from bundler_sfm_tpu_torch.ops.ransac import gather_rows, hartley_normalize


def homography_transfer_dist(H: torch.Tensor, p1: torch.Tensor,
                             p2: torch.Tensor) -> torch.Tensor:
    """|project(H, p1) - p2| per point.  H [..., 3, 3]; p1/p2 [..., N, 2]
    broadcasting against H's leading dims.  Returns [..., N]."""
    h = [[H[..., i, j, None] for j in range(3)] for i in range(3)]
    x, y = p1[..., 0], p1[..., 1]
    q0 = h[0][0] * x + h[0][1] * y + h[0][2]
    q1 = h[1][0] * x + h[1][1] * y + h[1][2]
    q2 = h[2][0] * x + h[2][1] * y + h[2][2]
    den = torch.where(q2.abs() < 1e-300, torch.sign(q2) + 1e-300, q2)
    return torch.sqrt((q0 / den - p2[..., 0]) ** 2
                      + (q1 / den - p2[..., 1]) ** 2)


def _dlt_rows(p1n: torch.Tensor, p2n: torch.Tensor):
    """The two inhomogeneous DLT rows per correspondence, [..., N, 8]."""
    x, y = p1n[..., 0], p1n[..., 1]
    xp, yp = p2n[..., 0], p2n[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -x * xp, -y * xp], -1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -x * yp, -y * yp], -1)
    return r1, r2, xp, yp


def _unnormalize(h: torch.Tensor, T1: torch.Tensor, T2: torch.Tensor
                 ) -> torch.Tensor:
    """[..., 8] normalized solution -> H = T2⁻¹ Hn T1 with H33 = 1."""
    Hn = torch.cat([h, torch.ones_like(h[..., :1])], -1).reshape(
        h.shape[:-1] + (3, 3))
    H = inv3(T2) @ Hn @ T1
    return H / H[..., 2:3, 2:3]


def fit_homography_dlt(p1: torch.Tensor, p2: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """(Weighted) normalized DLT: H with p2 ~ H p1, H33 = 1.  p1/p2
    [..., N, 2], mask [..., N]."""
    w = mask.to(p1.dtype)
    p1n, T1 = hartley_normalize(p1, mask)
    p2n, T2 = hartley_normalize(p2, mask)
    r1, r2, xp, yp = _dlt_rows(p1n, p2n)
    A = torch.cat([r1, r2], -2)                            # [..., 2N, 8]
    b = torch.cat([xp, yp], -1)
    ww = torch.cat([w, w], -1)
    Aw = A * ww[..., None]
    eye = torch.eye(8, dtype=p1.dtype, device=p1.device)
    AtA = Aw.transpose(-1, -2) @ A + 1e-12 * eye
    Atb = (Aw.transpose(-1, -2) @ b[..., None])[..., 0]
    return _unnormalize(cholesky_solve(AtA, Atb), T1, T2)


def estimate_homography_ransac(samples: torch.Tensor, p1: torch.Tensor,
                               p2: torch.Tensor, n_valid: torch.Tensor,
                               threshold: float):
    """Batched-hypothesis homography RANSAC + inlier refit.

    samples [B, R, 4]; p1/p2 [B, N, 2] padded correspondences; n_valid
    [B]; threshold in pixels (default 6.0, `src/BundlerApp.h:61`).
    Returns (H [B,3,3] refit on the inliers, inlier_mask [B,N] of the best
    hypothesis, num_inliers [B]) — the reference returns the pre-refit
    inlier set (`src/Register.cpp:147-149`)."""
    B, N, _ = p1.shape
    dtype = p1.dtype
    valid = torch.arange(N, device=p1.device) < n_valid[:, None]
    p1n, T1 = hartley_normalize(p1, valid)
    p2n, T2 = hartley_normalize(p2, valid)
    r1, r2, xp, yp = _dlt_rows(p1n, p2n)
    # Per-point contribution to [AtA | Atb]: 64 + 8 entries.
    outer = torch.cat(
        [(r1[..., :, None] * r1[..., None, :]
          + r2[..., :, None] * r2[..., None, :]).reshape(B, N, 64),
         r1 * xp[..., None] + r2 * yp[..., None]], -1)        # [B,N,72]
    M = gather_rows(outer, samples).sum(-2)                   # [B,R,72]
    R = samples.shape[1]
    AtA = M[..., :64].reshape(B, R, 8, 8) \
        + 1e-12 * torch.eye(8, dtype=dtype, device=p1.device)
    Atb = M[..., 64:]
    Hh = _unnormalize(cholesky_solve(AtA, Atb), T1[:, None], T2[:, None])
    resid = homography_transfer_dist(Hh, p1[:, None], p2[:, None])
    ok = torch.isfinite(resid) & (resid < threshold) & valid[:, None, :]
    counts = ok.sum(-1)
    best = torch.argmax(counts, dim=-1)
    rows = torch.arange(B, device=p1.device)
    inl = ok[rows, best]
    cnt = counts[rows, best]
    return fit_homography_dlt(p1, p2, inl), inl, cnt

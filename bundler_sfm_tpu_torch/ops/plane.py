"""Batched plane / line fitting — port of `bundler_sfm_tpu/ops/plane.py`,
the reference's orthogonal-regression RANSAC (`lib/imagelib/fit.c`):

- `fit_3D_plane_orthogonal_regression` (`fit.c:301-353`): mean-center, take
  the covariance's smallest eigenvector as the normal, d = -mean.n, and
  normalize the sign so d <= 0.
- `fit_3D_plane_ortreg_ransac` (`fit.c:379-491`): 3-point hypotheses scored
  by |point-plane distance| < threshold, then a final orthogonal regression
  over the best hypothesis's inliers.
- `fit_2D_line_ortreg_ransac` (used by `FitPlaneToPoints` when the plane
  must stay parallel to the up vector, `src/Geometry.cpp:966-990`).

Every hypothesis is a closed-form 3x3 (2x2) eigen problem, so all RANSAC
rounds run as one batch and scoring is a [N, rounds] broadcast, on the
tensors' device.  The sample draw is an input (`samples`, as in
`ops/ransac.py`); `draw_samples` makes one from a `torch.Generator`.
"""

from __future__ import annotations

import torch

from bundler_sfm_tpu_torch.ops.ransac import sample_indices
from bundler_sfm_tpu_torch.utils.device import resolve_device

# Rows of the [rows, N] squared-distance block `knn_plane_normals` holds at
# once: 2^25 f64 values (256 MiB), whatever the point count.
_KNN_BLOCK_ELEMS = 1 << 25


def draw_samples(generator: torch.Generator, rounds: int, k: int,
                 mask: torch.Tensor) -> torch.Tensor:
    """[rounds, k] distinct indices of the valid (mask > 0) entries, each
    round uniform over them (all entries when fewer than k are valid; the
    JAX package's Gumbel top-k draws masked entries only then too).  On the
    generator's device."""
    valid = torch.nonzero(mask > 0)[:, 0]
    if len(valid) < k:
        valid = torch.arange(len(mask), device=mask.device)
    if len(valid) < k:
        raise ValueError(f"need at least {k} points, got {len(valid)}")
    n = torch.tensor([len(valid)], device=generator.device)
    idx = sample_indices(generator, rounds, k, n, len(valid))[0]
    return valid.to(idx.device)[idx]


def _plane_from_cov(mean, cov):
    """Normal = eigenvector of the smallest eigenvalue; d = -mean.n with the
    sign convention d <= 0 (fit.c:328-338).  Batched over leading dims."""
    _, V = torch.linalg.eigh(cov)
    n = V[..., :, 0]
    d = -(mean * n).sum(-1)
    flip = torch.where(d > 0.0, -1.0, 1.0).to(n.dtype)
    return torch.cat([n * flip[..., None], (d * flip)[..., None]], -1)


def _masked_moments(pts, mask):
    """Masked mean and scatter matrix of pts [N, d] -> ([d], [d, d])."""
    if mask is None:
        mask = torch.ones(pts.shape[0], dtype=pts.dtype, device=pts.device)
    m = mask.to(pts.dtype)
    cnt = torch.clamp(m.sum(), min=1.0)
    mean = (pts * m[:, None]).sum(0) / cnt
    dev = (pts - mean) * m[:, None]
    return mean, dev.T @ dev


def fit_plane_ortho(pts, mask=None):
    """Masked orthogonal-regression plane fit.  pts [N,3], mask [N] ->
    plane [4] (unit normal, offset), as `fit_3D_plane_orthogonal_regression`
    (`fit.c:301-353`)."""
    return _plane_from_cov(*_masked_moments(pts, mask))


def plane_point_distance(plane, pts):
    """|n.p + d| for unit-normal planes (fit.c plane_point_distance)."""
    return torch.abs(pts @ plane[:3] + plane[3])


def fit_plane_ransac(samples, pts, mask, threshold):
    """RANSAC plane fit (`fit_3D_plane_ortreg_ransac`, `fit.c:379-491`).

    samples [rounds, 3] point indices per round; pts [N,3], mask [N]
    validity.  All hypotheses are solved and scored in one batch (ties in
    the inlier count go to the first round); the best hypothesis's inliers
    get a final orthogonal-regression refit (the reference's epilogue,
    `fit.c:463-470`).  Returns (plane [4], num_inliers, inlier_mask [N])
    with num_inliers the best hypothesis's count and the mask recounted
    against the refit plane (fit.c:472-479).
    """
    m = mask.to(pts.dtype)
    p3 = pts[samples]                                        # [R,3,3]
    mean = p3.mean(1)
    dev = p3 - mean[:, None, :]
    planes = _plane_from_cov(mean, dev.transpose(1, 2) @ dev)   # [R,4]
    dist = torch.abs(pts @ planes[:, :3].T + planes[None, :, 3])  # [N,R]
    inl = (dist < threshold) & (m[:, None] > 0)
    best = torch.argmax(inl.sum(0))
    best_mask = inl[:, best]

    plane = fit_plane_ortho(pts, best_mask)
    final_inl = (plane_point_distance(plane, pts) < threshold) & (m > 0)
    return plane, best_mask.sum(), final_inl


def fit_line_2d_ortho(pts2, mask=None):
    """Masked orthogonal-regression 2D line fit -> [a, b, c] with unit
    (a,b), a*x + b*y + c = 0 (`fit_2D_line_orthogonal_regression`).  The
    sign of (a, b, c) is the eigensolver's, as in the JAX package."""
    mean, cov = _masked_moments(pts2, mask)
    _, V = torch.linalg.eigh(cov)
    n = V[:, 0]
    return torch.cat([n, -(mean @ n)[None]])


def fit_line_2d_ransac(samples, pts2, mask, threshold):
    """RANSAC 2D line fit (`fit_2D_line_ortreg_ransac`), batched like
    fit_plane_ransac but with 2-point hypotheses (samples [rounds, 2])."""
    m = mask.to(pts2.dtype)
    p2 = pts2[samples]                                       # [R,2,2]
    d = p2[:, 1] - p2[:, 0]
    n = torch.stack([-d[:, 1], d[:, 0]], -1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                        min=1e-12)
    lines = torch.cat([n, -(n * p2[:, 0]).sum(-1, keepdim=True)], -1)
    dist = torch.abs(pts2 @ lines[:, :2].T + lines[None, :, 2])
    inl = (dist < threshold) & (m[:, None] > 0)
    best = torch.argmax(inl.sum(0))
    best_mask = inl[:, best]

    line = fit_line_2d_ortho(pts2, best_mask)
    final_inl = (torch.abs(pts2 @ line[:2] + line[2]) < threshold) & (m > 0)
    return line, best_mask.sum(), final_inl


def knn_plane_normals(pts, mask, k: int = 32, device="cuda"):
    """Per-point normals from a plane fit to the k nearest neighbors
    (`EstimatePointNormals`, `src/BaseGeometry.cpp:1444-1594`, NUM_NNS=32),
    on `device` in f64.

    The reference queries an ANN kd-tree point-by-point; here, as in the JAX
    package, each row of the [N,N] squared-distance matrix
    (|a|^2+|b|^2-2ab^T) comes from one matrix product, then top-k per row
    (self included) and batched 3x3 covariance eigen problems.  Rows run in
    blocks that bound the distance tile; every row's top-k is independent of
    the others, so blocking does not change the result.  pts [N,3], mask
    [N] -> normals [N,3] (unit, smallest covariance eigenvector, unoriented:
    the sign is the eigensolver's).
    """
    dev = resolve_device(device)
    pts = torch.as_tensor(pts, dtype=torch.float64).to(dev)
    m = torch.as_tensor(mask).to(dev, torch.float64)
    N = pts.shape[0]
    sq = (pts * pts).sum(1)
    rows = max(1, _KNN_BLOCK_ELEMS // max(N, 1))
    normals = []
    for s in range(0, N, rows):
        D = sq[s:s + rows, None] + sq[None, :] - 2.0 * (pts[s:s + rows]
                                                       @ pts.T)
        D = torch.where(m[None, :] > 0, D, torch.inf)       # mask padding
        dist, idx = torch.topk(D, k, dim=1, largest=False)  # incl. self
        nbrs = pts[idx]                                     # [rows,k,3]
        w = torch.isfinite(dist).to(pts.dtype)
        cnt = torch.clamp(w.sum(1, keepdim=True), min=1.0)
        mean = (nbrs * w[..., None]).sum(1) / cnt
        dv = (nbrs - mean[:, None, :]) * w[..., None]
        _, V = torch.linalg.eigh(dv.transpose(1, 2) @ dv)
        normals.append(V[:, :, 0])
    return torch.cat(normals)

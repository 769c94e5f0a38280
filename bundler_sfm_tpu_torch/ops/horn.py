"""2D rigid/similarity alignment (Horn's method) + RANSAC — port of
`bundler_sfm_tpu/ops/horn.py`.

Role of `align_horn` (`lib/imagelib/horn.h`, used by `EstimateTransform`'s
MotionRigid model, `src/Register.cpp:122-126`, and scene alignment): the
closed-form least-squares similarity transform between 2D point sets.
"""

from __future__ import annotations

import torch

from bundler_sfm_tpu_torch.ops.ransac import run_ransac, sample_indices
from bundler_sfm_tpu_torch.utils.device import resolve_device


def fit_similarity_2d(p1: torch.Tensor, p2: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Weighted 2D similarity p2 ≈ s·R·p1 + t as a 3x3 matrix (Horn).
    p1, p2 [..., N, 2], mask [..., N] -> [..., 3, 3]."""
    w = mask.to(p1.dtype)
    count = torch.clamp(w.sum(-1), min=1.0)[..., None]
    mu1 = (p1 * w[..., None]).sum(-2) / count
    mu2 = (p2 * w[..., None]).sum(-2) / count
    q1 = (p1 - mu1[..., None, :]) * w[..., None]
    q2 = (p2 - mu2[..., None, :]) * w[..., None]
    # Complex-number form of 2D Horn: s·e^{iθ} = Σ q2·conj(q1) / Σ |q1|².
    num_re = (q2[..., 0] * q1[..., 0] + q2[..., 1] * q1[..., 1]).sum(-1)
    num_im = (q2[..., 1] * q1[..., 0] - q2[..., 0] * q1[..., 1]).sum(-1)
    den = torch.clamp((q1[..., 0] ** 2 + q1[..., 1] ** 2).sum(-1),
                      min=1e-300)
    a = num_re / den
    b = num_im / den
    tx = mu2[..., 0] - (a * mu1[..., 0] - b * mu1[..., 1])
    ty = mu2[..., 1] - (b * mu1[..., 0] + a * mu1[..., 1])
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([a, -b, tx], -1),
                        torch.stack([b, a, ty], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def similarity_transfer_dist(M: torch.Tensor, p1: torch.Tensor,
                             p2: torch.Tensor) -> torch.Tensor:
    """|M·[p1, 1] − p2| for M [..., 3, 3] and p1, p2 [..., 2]."""
    ph = torch.cat([p1, torch.ones_like(p1[..., :1])], -1)
    q = ph @ M.transpose(-1, -2)
    return torch.sqrt(((q[..., :2] - p2) ** 2).sum(-1))


def estimate_similarity_ransac(p1, p2, n_valid: int, threshold: float,
                               num_rounds: int = 256, samples=None,
                               seed: int = 0, device="cuda"):
    """MotionRigid RANSAC (3-point samples, `src/Register.cpp:58-60`) on
    `device` in f64.

    p1, p2 [N, 2] (the first n_valid rows live); samples [num_rounds, 3]
    indices below n_valid, or None to draw them from a `torch.Generator`
    on `device` seeded with `seed`.  Returns (M [3, 3] refit on the best
    round's inliers, inlier mask [N], number of inliers)."""
    dev = resolve_device(device)
    p1 = torch.as_tensor(p1, dtype=torch.float64).to(dev)
    p2 = torch.as_tensor(p2, dtype=torch.float64).to(dev)
    n = torch.tensor([int(n_valid)], device=dev)
    if samples is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        samples = sample_indices(gen, num_rounds, 3, n, p1.shape[0])[0]
    samples = torch.as_tensor(samples).to(dev, torch.int64)

    def fit(s1, s2):
        return fit_similarity_2d(s1, s2, torch.ones(
            s1.shape[:-1], dtype=torch.bool, device=dev))

    def resid(M, a1, a2):                  # [1,R,3,3], [1,N,2] -> [1,R,N]
        return similarity_transfer_dist(M, a1[:, None], a2[:, None])

    _, inl, cnt = run_ransac(samples[None], fit, resid, p1[None], p2[None],
                             n, threshold)
    return fit_similarity_2d(p1, p2, inl[0]), inl[0], cnt[0]

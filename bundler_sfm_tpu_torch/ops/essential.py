"""Essential-matrix decomposition into relative pose — port of
`bundler_sfm_tpu/ops/essential.py`.

Reference `find_extrinsics_essential(_multipt)` (`lib/imagelib/triangulate.c`):
E = U diag(1,1,0) Vᵀ gives rotations Ra = U D Vᵀ, Rb = U Dᵀ Vᵀ (det fixed to
+1) and translations ±u3; the candidate is picked by triangulating and
requiring NEGATIVE depth in both views (the -z convention).  Points are
NEGATED normalized coords (-u/f, -v/f).
"""

from __future__ import annotations

import torch

from bundler_sfm_tpu_torch.ops.svd_utils import svd_small
from bundler_sfm_tpu_torch.ops.triangulate import (
    triangulate_track, triangulate_two_view,
)

_D = ((0.0, 1.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 0.0, 1.0))
# M = diag(-1,-1,1): conjugation from a ray-coordinate E to the pixel-
# normalized frame (`lib/5point/5point.c` E2 negation).
_M = (-1.0, -1.0, 1.0)


def _candidates(E: torch.Tensor):
    """The four (R, t) candidates of E [3, 3] -> Rs [4,3,3], ts [4,3]."""
    U, _, Vt = svd_small(E)
    # E is rank 2: rebuild U's third column as u0 x u1.
    u2 = torch.linalg.cross(U[:, 0], U[:, 1], dim=-1)
    u2 = u2 / torch.clamp(torch.linalg.norm(u2), min=1e-30)
    U = torch.cat([U[:, :2], u2[:, None]], 1)
    tu = U[:, 2]
    D = torch.tensor(_D, dtype=E.dtype, device=E.device)
    Ra = U @ D @ Vt
    Rb = U @ D.T @ Vt
    Ra = Ra * torch.sign(torch.linalg.det(Ra))
    Rb = Rb * torch.sign(torch.linalg.det(Rb))
    return torch.stack([Ra, Ra, Rb, Rb]), torch.stack([tu, -tu, tu, -tu])


def decompose_essential(E: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor):
    """(R, t, ok) from E and ONE correspondence in ray coords [2]."""
    Rs, ts = _candidates(E)
    I = torch.eye(3, dtype=E.dtype, device=E.device)
    t0 = torch.zeros(3, dtype=E.dtype, device=E.device)
    X, _ = triangulate_two_view(p1.expand(4, 2), p2.expand(4, 2), I, t0, Rs, ts)
    c2 = ((Rs @ X[..., None])[..., 0] + ts)[:, 2]
    good = (X[:, 2] < 0) & (c2 < 0)
    idx = torch.argmax(good.to(torch.int32))
    return Rs[idx], ts[idx], good.any()


def decompose_essential_multipt(E: torch.Tensor, p1: torch.Tensor,
                                p2: torch.Tensor, mask: torch.Tensor):
    """Pick the (R, t) candidate with the most both-depths-negative votes
    over the correspondences p1/p2 [N, 2] (ray coords) where mask [N]."""
    Rs, ts = _candidates(E)
    N = p1.shape[0]
    I = torch.eye(3, dtype=E.dtype, device=E.device)
    pv = torch.stack([p1, p2], -2).expand(4, N, 2, 2)
    RR = torch.stack([I.expand(4, 3, 3), Rs], 1)[:, None].expand(4, N, 2, 3, 3)
    tt = torch.stack([torch.zeros_like(ts), ts], 1)[:, None].expand(4, N, 2, 3)
    ones = torch.ones((4, N, 2), dtype=torch.bool, device=E.device)
    X, _ = triangulate_track(pv, RR, tt, ones, 3)               # [4, N, 3]
    z2 = ((Rs[:, None] @ X[..., None])[..., 0] + ts[:, None])[..., 2]
    counts = ((X[..., 2] < 0) & (z2 < 0) & mask).sum(-1)
    idx = torch.argmax(counts)
    return Rs[idx], ts[idx], counts[idx] > 0


def pose_to_center(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """w2c translation t -> camera center c = -Rᵀ t."""
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]


def ematrix_to_fmatrix(E_ray: torch.Tensor, f1, f2) -> torch.Tensor:
    """Ray-coordinate E [..., 3, 3] -> pixel F = K2⁻ᵀ (M E M) K1⁻¹."""
    one = torch.ones_like(torch.as_tensor(f1, dtype=E_ray.dtype,
                                          device=E_ray.device))
    k1 = torch.stack([one / f1, one / f1, one])
    k2 = torch.stack([one / f2, one / f2, one])
    m = torch.tensor(_M, dtype=E_ray.dtype, device=E_ray.device)
    return k2[:, None] * (m[:, None] * E_ray * m) * k1

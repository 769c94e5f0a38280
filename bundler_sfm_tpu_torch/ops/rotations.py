"""Rotation utilities — port of `bundler_sfm_tpu/ops/rotations.py`.

`rodrigues` mirrors the reference's `rot_update` (`lib/sfm-driver/sfm.c:77-116`):
R_new = exp([w]x) · R0, the incremental-rotation parameterization used by every
LM run.  Every function is batched over leading dimensions and has no
data-dependent branch, so `torch.func.jacfwd` differentiates it.
"""

from __future__ import annotations

import torch

from bundler_sfm_tpu_torch.ops.linalg_small import qr3


def skew(w: torch.Tensor) -> torch.Tensor:
    """[w]x cross-product matrix; w: [..., 3] -> [..., 3, 3]."""
    zero = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zero, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], zero, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], zero], -1)], -2)


def rodrigues(w: torch.Tensor) -> torch.Tensor:
    """exp([w]x): axis-angle [..., 3] -> rotation matrix [..., 3, 3], with
    the sinc-form series below theta² = 1e-16 (smooth and differentiable
    at w = 0, where every LM run starts, `lib/sfm-driver/sfm.c:669-671`)."""
    theta_sq = (w * w).sum(-1)
    theta = torch.sqrt(theta_sq + 1e-300)
    small = theta_sq < 1e-16
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / theta_sq)
    wx = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(wx.shape)
    return eye + a[..., None, None] * wx + b[..., None, None] * (wx @ wx)


def rot_update(R0: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """R = exp([w]x) @ R0 (lib/sfm-driver/sfm.c:115)."""
    return rodrigues(w) @ R0


def log_rotation(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues: rotation matrix [..., 3, 3] -> axis-angle [..., 3]
    (accurate away from theta = pi; the pipeline logs small rotations)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0)
    theta = torch.arccos(cos_t)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    scale = torch.where(theta < 1e-7, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * torch.clamp(torch.sin(theta), min=1e-12)))
    return v * scale[..., None]


def rq3(M: torch.Tensor):
    """RQ decomposition of 3×3 matrices: M = R_upper @ Q with Q orthonormal
    (replaces LAPACK `dgerqf_driver`, `src/Bundle.cpp:2924`), from QR of the
    row-reversed transpose."""
    A = torch.flip(M, (-2,)).transpose(-1, -2)
    q, r = qr3(A)
    R_upper = torch.flip(r.transpose(-1, -2), (-2, -1))
    Q = torch.flip(q.transpose(-1, -2), (-2,))
    return R_upper, Q


def fix_intrinsics_sign(K: torch.Tensor, Q: torch.Tensor):
    """Make diag(K) positive by flipping matching columns of K / rows of Q
    (preserves K@Q; `src/Bundle.cpp:2926-2928`).  Requires det(K@Q) > 0."""
    sign = torch.sign(torch.diagonal(K, dim1=-2, dim2=-1))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return K * sign[..., None, :], Q * sign[..., :, None]

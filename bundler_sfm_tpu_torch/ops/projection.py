"""The Snavely camera model, batched — port of
`bundler_sfm_tpu/ops/projection.py`.

Semantics from `include/snavely_reprojection_error.h:53-96` and
`lib/sfm-driver/sfm.c:302-380` (explicit camera centers):

    p   = R (X - c)                  # c = camera center
    u   = -f * p.xy / p.z            # the -z viewing axis
    r²  = |u|² / f²
    u  *= 1 + k1 r² + k2 r⁴

A camera is a 9-vector [c(3), w(3), f, k1, k2] with R = exp([w]x) R0 and the
base rotation R0 [3, 3] passed separately.
"""

from __future__ import annotations

import math

import torch

from bundler_sfm_tpu_torch.ops.rotations import rot_update
from bundler_sfm_tpu_torch.utils.device import resolve_device

NUM_CAMERA_PARAMS = 9


def pack_camera(center, w, f, k) -> torch.Tensor:
    parts = [torch.as_tensor(x, dtype=torch.float64).reshape(-1)
             for x in (center, w, f, k)]
    return torch.cat(parts)


def project_one(cam: torch.Tensor, R0: torch.Tensor, X: torch.Tensor,
                apply_distortion: bool = True) -> torch.Tensor:
    """Project points X [..., 3] through cameras cam [..., 9] / R0
    [..., 3, 3] (broadcasting over leading dims) -> [..., 2]."""
    c, w, f, k = cam[..., 0:3], cam[..., 3:6], cam[..., 6], cam[..., 7:9]
    R = rot_update(R0, w)
    p = (R @ (X - c)[..., None])[..., 0]
    u = -f[..., None] * p[..., 0:2] / p[..., 2:3]
    if apply_distortion:
        rsq = (u[..., 0] * u[..., 0] + u[..., 1] * u[..., 1]) / (f * f)
        factor = 1.0 + k[..., 0] * rsq + k[..., 1] * rsq * rsq
        u = u * factor[..., None]
    return u


def project_obs(cams, R0s, pts, obs_cam, obs_pt, apply_distortion=True):
    """Every observation: cams [C,9], R0s [C,3,3], pts [P,3], obs_cam /
    obs_pt [O] -> [O,2]."""
    return project_one(cams[obs_cam], R0s[obs_cam], pts[obs_pt],
                       apply_distortion)


def camera_depths(cams, R0s, pts, obs_cam, obs_pt) -> torch.Tensor:
    """Camera-frame z per observation (negative = in front,
    `src/Bundle.cpp:177-191`)."""
    cam = cams[obs_cam]
    R = rot_update(R0s[obs_cam], cam[:, 3:6])
    return (R @ (pts[obs_pt] - cam[:, 0:3])[..., None])[..., 2, 0]


def check_cheirality(point, R, center) -> torch.Tensor:
    """True where the point is in front of the camera (z < 0)."""
    return (R @ (point - center)[..., None])[..., 2, 0] < 0.0


def ray_directions(xy: torch.Tensor, f, R: torch.Tensor) -> torch.Tensor:
    """World-space viewing rays Rᵀ·(x/f, y/f, -1) for centered pixel coords
    xy [..., 2] (`ComputeRayAngle`, `src/Bundle.cpp:102-152`)."""
    v = torch.stack([xy[..., 0] / f, xy[..., 1] / f,
                     -torch.ones_like(xy[..., 0])], -1)
    return (v[..., :, None] * R).sum(-2)


def ray_angle(xy1, f1, R1, xy2, f2, R2) -> torch.Tensor:
    """Angle (radians) between the viewing rays of correspondences."""
    r1 = ray_directions(xy1, f1, R1)
    r2 = ray_directions(xy2, f2, R2)
    dot = (r1 * r2).sum(-1)
    mag = torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1)
    return torch.arccos(torch.clamp(dot / mag, -1.0 + 1e-8, 1.0 - 1e-8))


def undistort_normalized(u: torch.Tensor, k_inv: torch.Tensor) -> torch.Tensor:
    """Apply the 6-term inverse-distortion polynomial to normalized points
    u [..., 2] (`UndistortNormalizedPoint`, `src/Distortion.cpp:90-…`,
    POLY_INVERSE_DEGREE=6 per `lib/sfm-driver/sfm.h:30`):
      r = |u|;  r_new = Σ_i k_inv[i]·r^i;  u *= r_new / r."""
    r = torch.sqrt((u * u).sum(-1) + 1e-300)
    powers = torch.stack([r ** i for i in range(6)], -1)
    r_new = (powers * k_inv).sum(-1)
    return u * (r_new / r)[..., None]


def invert_distortion(k1, k2, f, width, height, degree: int = 6,
                      num_samples: int = 20, device="cuda") -> torch.Tensor:
    """Fit the inverse radial-distortion polynomial on `device` (f64),
    as `InvertDistortion` does (`src/Distortion.cpp:29-87`): sample the
    forward polynomial r_d = r (1 + k1 r² + k2 r⁴) at `num_samples` radii
    in [0, max_radius], max_radius = sqrt((W/2)² + (H/2)²) / f
    (`src/Bundle.cpp:684-688`), and least-squares fit r = Σ a_i r_d^i.
    Returns the `degree` coefficients a."""
    dev = resolve_device(device)
    max_radius = math.sqrt((0.5 * width) ** 2 + (0.5 * height) ** 2) / f
    r = torch.linspace(0.0, max_radius, num_samples, dtype=torch.float64,
                       device=dev)
    rd = r * (1.0 + k1 * r ** 2 + k2 * r ** 4)
    A = torch.stack([rd ** i for i in range(degree)], -1)
    return torch.linalg.lstsq(A, r[:, None]).solution[:, 0]

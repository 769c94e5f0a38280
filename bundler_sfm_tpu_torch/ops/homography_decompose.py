"""Homography → relative pose decomposition; a copy of
`bundler_sfm_tpu/ops/homography_decompose.py` (host numpy, as there).

Role of `DecomposeHomography` / `ComputeFundamentalMatrix`
(`src/Decompose.h:26-30`, used by the planar-scene fallback in
`EstimateRelativePose`, `src/RelativePose.cpp:100-167`): when most epipolar
inliers also fit a homography, extract (R, t) from H instead of E.

Faugeras-Lustman SVD decomposition on RAY coordinates (negated normalized,
the same contract as ops.essential) so results land directly in the bundler
-z convention.  Returns the two physical (R, t) candidates; the caller picks
by epipolar-inlier count like the reference (`RelativePose.cpp:129-162`).
"""

from __future__ import annotations

import numpy as np

# M = diag(-1,-1,1): conjugation between ray and pixel-normalized
# coordinates (`ops/essential.py`'s _M, as a matrix).
_M = np.diag([-1.0, -1.0, 1.0])


def homography_pixel_to_ray(H_pix: np.ndarray, f1: float, f2: float
                            ) -> np.ndarray:
    """Pixel-space H (p2 ~ H p1, centered coords) -> ray-space H."""
    K1i = np.diag([1.0 / f1, 1.0 / f1, 1.0])
    K2i = np.diag([1.0 / f2, 1.0 / f2, 1.0])
    return _M @ K2i @ H_pix @ np.linalg.inv(K1i) @ _M


def decompose_homography(H_ray: np.ndarray):
    """Faugeras SVD decomposition of a ray-space homography.

    Returns ((R1, t1, n1), (R2, t2, n2)) — the two non-degenerate physical
    solutions (each also valid with (t, n) negated; cheirality downstream
    disambiguates, as in the reference)."""
    U, d, Vt = np.linalg.svd(H_ray)
    s = np.linalg.det(U) * np.linalg.det(Vt)
    d1, d2, d3 = d
    H_ray = H_ray / d2
    d1, d3 = d1 / d2, d3 / d2

    if abs(d1 - d3) < 1e-9:
        # Pure rotation.
        R = H_ray * np.cbrt(1.0 / np.linalg.det(H_ray))
        return ((R, np.zeros(3), np.array([0.0, 0.0, 1.0])),
                (R, np.zeros(3), np.array([0.0, 0.0, 1.0])))

    x1 = np.sqrt(max((d1 * d1 - 1.0) / (d1 * d1 - d3 * d3), 0.0))
    x3 = np.sqrt(max((1.0 - d3 * d3) / (d1 * d1 - d3 * d3), 0.0))
    sin_t = (d1 - d3) * x1 * x3
    cos_t = d1 * x3 * x3 + d3 * x1 * x1

    out = []
    for sign in (1.0, -1.0):
        st = sign * sin_t
        Rp = np.array([[cos_t, 0.0, -st],
                       [0.0, 1.0, 0.0],
                       [st, 0.0, cos_t]])
        tp = (d1 - d3) * np.array([x1, 0.0, -sign * x3])
        npl = np.array([x1, 0.0, sign * x3])
        R = s * U @ Rp @ Vt
        t = U @ tp
        n = Vt.T @ npl
        out.append((R, t, n))
    return tuple(out)


def fundamental_from_pose(R: np.ndarray, t: np.ndarray,
                          f1: float, f2: float) -> np.ndarray:
    """F in pixel space from a bundler-convention (R, t)
    (`ComputeFundamentalMatrix`, `src/Decompose.h:30`):
    F = K2⁻ᵀ · M[t]ₓR M · K1⁻¹ (the same M-conjugation as the E path)."""
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E_ray = tx @ R
    K1i = np.diag([1.0 / f1, 1.0 / f1, 1.0])
    K2i = np.diag([1.0 / f2, 1.0 / f2, 1.0])
    return K2i @ (_M @ E_ray @ _M) @ K1i

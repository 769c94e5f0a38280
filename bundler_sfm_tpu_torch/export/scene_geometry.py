"""Scene-level geometry on BundleFile objects — the part of the JAX
package's `export/scene_geometry.py` that `bundler --bundle
--estimate_up_vector_szeliski` calls: `estimate_axes` (Szeliski-style axes
estimation, `EstimateAxes`, `src/BaseGeometry.cpp:553-713`).  A copy of
that host-only numpy code; the plane fits and the rest of the module are
not ported yet."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from bundler_sfm_tpu_torch.io.bundlefile import BundleFile


def _registered(bundle: BundleFile) -> List[int]:
    return [i for i, c in enumerate(bundle.cameras) if c.registered]


def estimate_axes(bundle: BundleFile, up_image: int = -1,
                  min_deg: float = 80.0,
                  rotations: Optional[Sequence[int]] = None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Szeliski-style axes estimation (`EstimateAxes`,
    `src/BaseGeometry.cpp:553-713`): the y (up) axis is the direction most
    orthogonal to all agreeing cameras' x-axes (smallest eigenvector of
    sum x_i x_i^T), sign-voted by camera y-rows; z is the mean camera z-row
    orthogonalized; x = y cross z.  Returns (x_axis, y_axis, z_axis).

    `rotations` are per-image quarter-turn counts (EXIF upright rotation,
    `CameraInfo::GetUprightRotation`, `src/Camera.cpp:104-114`).
    """
    regs = _registered(bundle)
    R90 = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])

    def upright(i):
        R = bundle.cameras[i].R
        r = 0 if rotations is None else int(rotations[i]) % 4
        return np.linalg.matrix_power(R90, r) @ R

    dot_thr = np.cos(np.deg2rad(min_deg))
    if up_image >= 0:
        ref_axis = bundle.cameras[up_image].R[1].copy()
    else:
        best, best_inl = regs[0], -1
        for i in regs:
            yi = upright(i)[1]
            inl = sum(1 for j in regs if j != i
                      and abs(yi @ upright(j)[0]) <= dot_thr)
            if inl > best_inl:
                best, best_inl = i, inl
        ref_axis = upright(best)[1]

    # Moment matrix of agreeing cameras' x-axes (:625-645).
    RTR = np.zeros((3, 3))
    agree = []
    for i in regs:
        R = upright(i)
        if abs(R[0] @ ref_axis) > dot_thr:
            continue
        agree.append(i)
        RTR += np.outer(R[0], R[0])
    w, V = np.linalg.eigh(RTR)
    yaxis = V[:, 0]

    # Sign vote by raw camera y-rows (:652-668).
    num_pos = num_neg = 0
    for i in agree:
        d = bundle.cameras[i].R[1] @ yaxis
        if d < -0.707106781186548:
            num_neg += 1
        elif d > 0.707106781186548:
            num_pos += 1
    if num_neg > num_pos:
        yaxis = -yaxis

    # Average viewing direction -> z; orthogonalize (:688-712).
    zaxis = np.zeros(3)
    for i in regs:
        zaxis += bundle.cameras[i].R[2]
    xaxis = np.cross(yaxis, zaxis)
    xaxis /= max(np.linalg.norm(xaxis), 1e-12)
    zaxis = np.cross(xaxis, yaxis)
    return xaxis, yaxis, zaxis

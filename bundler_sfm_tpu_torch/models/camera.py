"""Finalized-camera utilities — a copy of `bundler_sfm_tpu/models/camera.py`
(host numpy, as there): the `CameraInfo` API of the reference
(`src/Camera.h:31-182`, `src/Camera.cpp`) as plain-numpy functions over the
framework's camera records (R world→cam, t = −R·c file convention, f, k1, k2).

These are host-side scene/viewer helpers (FOV, horizon lines, inter-camera
epipolar geometry, rays); none of them are on the device hot path, so they
stay numpy and vectorize over leading batch dims where noted.

Conventions (see DESIGN.md): projection divides by −z — the homogeneous
image point of a camera-space point p is (f·p.x, f·p.y, −p.z) — and image
coordinates are centered with y up.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Intrinsics / FOV (src/Camera.cpp:117-143)
# ---------------------------------------------------------------------------

def intrinsics(f: float) -> np.ndarray:
    """K = diag(f, f, 1) (`src/Camera.cpp:117-121`)."""
    return np.diag([f, f, 1.0])


def fov(f: float, width: float) -> float:
    """Horizontal field of view in radians (`src/Camera.cpp:124-126`)."""
    return 2.0 * np.arctan(width / (2.0 * f))


def fov_max(f: float, width: float, height: float, rotate: int = 0) -> float:
    """FOV along the longer image axis after `rotate` quarter-turns
    (`src/Camera.cpp:128-138`)."""
    if ((rotate % 2) == 0 and width >= height) or \
       ((rotate % 2) == 1 and width < height):
        return 2.0 * np.arctan(width / (2.0 * f))
    vfov = 2.0 * np.arctan(height / (2.0 * f))
    return 2.0 * np.arctan(np.tan(0.5 * vfov) * width / height)


def focal_from_fov(fov_deg: float, width: float) -> float:
    """Inverse of `fov` (`CameraInfo::SetFOV`, `src/Camera.cpp:141-143`)."""
    return 0.5 * width / np.tan(0.5 * np.deg2rad(fov_deg))


# ---------------------------------------------------------------------------
# Projection (src/Camera.cpp:146-173)
# ---------------------------------------------------------------------------

def project(R: np.ndarray, t: np.ndarray, f: float, k1: float, k2: float,
            X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Project world points [..., 3] → centered image coords [..., 2] and an
    in-front mask.  Matches `CameraInfo::Project` (`src/Camera.cpp:146-173`)
    including its bad-extrapolation guard: the distortion factor is skipped
    when r² > 8 or the polynomial goes negative."""
    X = np.asarray(X, dtype=float)
    p = X @ R.T + t
    z = p[..., 2]
    in_front = z < 0.0
    safe_z = np.where(z == 0.0, 1.0, z)
    u = -f * p[..., :2] / safe_z[..., None]
    rsq = (u[..., 0] ** 2 + u[..., 1] ** 2) / (f * f)
    factor = 1.0 + k1 * rsq + k2 * rsq * rsq
    ok = (rsq <= 8.0) & (factor >= 0.0)
    u = np.where(ok[..., None], u * factor[..., None], u)
    return u, in_front & (z != 0.0)


def point_in_front(R: np.ndarray, t: np.ndarray, X: np.ndarray) -> np.ndarray:
    """z < 0 in camera coordinates (`src/Camera.cpp:456-465`)."""
    X = np.asarray(X, dtype=float)
    return (X @ R.T + t)[..., 2] < 0.0


def point_inside_image(R, t, f, k1, k2, X, width, height) -> np.ndarray:
    """In front AND inside the centered image rectangle
    (`src/Camera.cpp:853-859`)."""
    u, in_front = project(R, t, f, k1, k2, X)
    inside = (np.abs(u[..., 0]) < 0.5 * width) & \
             (np.abs(u[..., 1]) < 0.5 * height)
    return in_front & inside


# ---------------------------------------------------------------------------
# Inter-camera epipolar geometry (src/Camera.cpp:175-225)
# ---------------------------------------------------------------------------

def essential_between(R1, t1, R2, t2) -> np.ndarray:
    """Essential matrix between two finalized cameras, in this framework's
    negated-z image convention (`CameraInfo::ComputeEssentialMatrix`,
    `src/Camera.cpp:175-214`).

    Relative motion from camera-1 frame to camera-2 frame is
    R = R2·R1ᵀ, t = t2 − R·t1; the standard E = [t]ₓR is then conjugated by
    diag(1,1,−1) (the reference's "black magic because we flipped the
    Z-axis" sign pattern, `src/Camera.cpp:203-208`) so that homogeneous
    image points h = (f·px, f·py, −pz) satisfy h2ᵀ·F·h1 = 0."""
    R1, R2 = np.asarray(R1, float), np.asarray(R2, float)
    t1, t2 = np.asarray(t1, float), np.asarray(t2, float)
    R = R2 @ R1.T
    t = t2 - R @ t1
    tx = np.array([[0.0, -t[2], t[1]],
                   [t[2], 0.0, -t[0]],
                   [-t[1], t[0], 0.0]])
    E = tx @ R
    D = np.diag([1.0, 1.0, -1.0])
    return -(D @ E @ D)


def fundamental_between(R1, t1, f1, R2, t2, f2) -> np.ndarray:
    """F = K2⁻ᵀ·E·K1⁻¹ (`src/Camera.cpp:215-225`)."""
    E = essential_between(R1, t1, R2, t2)
    K1inv = np.diag([1.0 / f1, 1.0 / f1, 1.0])
    K2inv = np.diag([1.0 / f2, 1.0 / f2, 1.0])
    return K2inv.T @ E @ K1inv


# ---------------------------------------------------------------------------
# Pose helpers (src/Camera.cpp:227-252, 697-850)
# ---------------------------------------------------------------------------

def reflect(R: np.ndarray, t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Flip the camera over the z-axis (`CameraInfo::Reflect`,
    `src/Camera.cpp:227-238`): negate R[0,2], R[1,2], R[2,0], R[2,1], t[2]."""
    R2 = np.array(R, dtype=float, copy=True)
    t2 = np.array(t, dtype=float, copy=True)
    R2[0, 2] = -R2[0, 2]
    R2[1, 2] = -R2[1, 2]
    R2[2, 0] = -R2[2, 0]
    R2[2, 1] = -R2[2, 1]
    t2[2] = -t2[2]
    return R2, t2


def camera_center(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """c = −Rᵀ·t (`src/Camera.h:66-75`)."""
    return -np.asarray(R, float).T @ np.asarray(t, float)


def camera_distance(R1, t1, R2, t2) -> float:
    """Distance between camera centers (`src/Camera.cpp:240-252`)."""
    return float(np.linalg.norm(camera_center(R1, t1) -
                                camera_center(R2, t2)))


def view_direction(R: np.ndarray) -> np.ndarray:
    """World-space viewing direction = −(third row of R)
    (`src/Camera.cpp:799-809`)."""
    return -np.asarray(R, float)[2]


def twist_angle(R: np.ndarray) -> float:
    """In-plane twist of the camera in radians
    (`CameraInfo::GetTwistAngleRadians`, `src/Camera.cpp:812-829`): computed
    from the camera→world rotation P = Rᵀ as
    acos((P00·P22 − P20·P02)/√(1−P12²)), signed by P10."""
    P = np.asarray(R, float).T
    denom = np.sqrt(max(1.0 - P[1, 2] ** 2, 1e-16))
    c = (P[0, 0] * P[2, 2] - P[2, 0] * P[0, 2]) / denom
    angle = np.arccos(np.clip(c, -1.0 + 1e-8, 1.0 - 1e-8))
    return float(-angle if P[1, 0] < 0.0 else angle)


def front_halfspace(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Plane (n, d) bounding the halfspace in front of the camera
    (`src/Camera.cpp:831-850`)."""
    v = view_direction(R)
    pos = camera_center(R, t) + 1e-6 * v
    return np.array([v[0], v[1], v[2], -float(v @ pos)])


def pixel_to_camera_ray(x: float, y: float, f: float) -> np.ndarray:
    """Centered pixel → unit ray in CAMERA coordinates (z = −f plane,
    `src/Camera.cpp:697-707`)."""
    ray = np.array([x, y, -f], dtype=float)
    return ray / np.linalg.norm(ray)


def pixel_to_camera_ray_absolute(x: float, y: float, f: float,
                                 R: np.ndarray) -> np.ndarray:
    """Centered pixel → unit ray in WORLD coordinates
    (`src/Camera.cpp:710-718`)."""
    ray = np.asarray(R, float).T @ np.array([x, y, -f], dtype=float)
    return ray / np.linalg.norm(ray)


# ---------------------------------------------------------------------------
# Horizon / vanishing lines (src/Camera.cpp:255-453)
# ---------------------------------------------------------------------------

def vanishing_line(R: np.ndarray, f: float, normal: np.ndarray) -> np.ndarray:
    """Image of a plane's line at infinity (`CameraInfo::ComputeVanishingLine`,
    `src/Camera.cpp:255-284`).

    The reference intersects the plane with the plane at infinity and
    projects two sampled points; the closed form is the classic cofactor
    identity — for directions v1, v2 spanning the plane, the homogeneous
    image of a direction v is D·K·R·v with D = diag(1, 1, −1) (the −z
    division), and the line through two such vanishing points is
    (M·v1)×(M·v2) ∝ M⁻ᵀ·(v1×v2) with M = D·K·R — so
    l ∝ D·K⁻ᵀ·R·n."""
    n = np.asarray(normal, dtype=float)
    n = n / np.linalg.norm(n)
    Rn = np.asarray(R, float) @ n
    line = np.array([Rn[0] / f, Rn[1] / f, -Rn[2]])
    return line / np.linalg.norm(line[:2])


def horizon_line(R: np.ndarray, f: float, ground_normal: np.ndarray,
                 up: np.ndarray) -> np.ndarray:
    """Horizon line l (homogeneous, for centered image coords) such that
    points above the horizon have l·(x, y, 1) > 0
    (`CameraInfo::ComputeHorizonLine`, `src/Camera.cpp:287-443`).

    The horizon is the ground plane's vanishing line.  Orientation: the
    reference orients via a cross-product rule against an up vector mapped
    through the transposed pose (`src/Camera.cpp:425-442`); we orient
    directly by the defining property — the positive side of the line is
    the image-space up side, so `point_above_horizon` is true exactly for
    points above it."""
    line = vanishing_line(R, f, ground_normal)
    up_img = np.asarray(R, float) @ np.asarray(up, dtype=float)
    up2 = up_img[:2]
    if np.linalg.norm(up2) > 1e-12:
        # l·(p + up) > l·p for p on the line ⇔ (l.x, l.y)·up > 0.
        if line[0] * up2[0] + line[1] * up2[1] < 0.0:
            line = -line
    return line


def point_above_horizon(horizon: np.ndarray, p: np.ndarray) -> np.ndarray:
    """l·(x, y, 1) > 0 (`src/Camera.cpp:446-453`); p is [..., 2]."""
    p = np.asarray(p, dtype=float)
    return (horizon[0] * p[..., 0] + horizon[1] * p[..., 1] +
            horizon[2]) > 0.0


# ---------------------------------------------------------------------------
# Viewer helpers (src/Camera.cpp:470-600, 862-917)
# ---------------------------------------------------------------------------

def _quat_from_matrix(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → unit quaternion (w, x, y, z), Shepperd's method."""
    R = np.asarray(R, float)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-16)) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def interpolate_cameras(R1, t1, R2, t2, alpha: float
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Pose between two cameras: lerp of centers + normalized-lerp of pose
    quaternions with hemisphere alignment (`InterpolateCameras`,
    `src/Camera.cpp:470-530`).  Returns (R, t) at parameter alpha∈[0,1]."""
    c = (1.0 - alpha) * camera_center(R1, t1) + \
        alpha * camera_center(R2, t2)
    q1 = _quat_from_matrix(np.asarray(R1, float).T)   # pose = cam→world
    q2 = _quat_from_matrix(np.asarray(R2, float).T)
    if q1 @ q2 < 0.0:
        q2 = -q2
    q = (1.0 - alpha) * q1 + alpha * q2
    R = _quat_to_matrix(q).T                           # back to world→cam
    return R, -R @ c


def up_camera(R: np.ndarray, t: np.ndarray, up: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray]:
    """Roll the camera about its optical axis so the given world up vector
    has no image-x component (`CameraInfo::GetUpCamera`,
    `src/Camera.cpp:862-917`): rotate the camera frame by the angle between
    the image-projected up vector and the image y-axis, keeping the
    position fixed."""
    R = np.asarray(R, float)
    c = camera_center(R, t)
    up_img = R @ np.asarray(up, dtype=float)
    proj = np.array([up_img[0], up_img[1], 0.0])
    proj = proj / np.linalg.norm(proj)
    angle = np.arccos(np.clip(proj[1], -1.0, 1.0))
    axis = np.cross(proj, [0.0, 1.0, 0.0])
    nrm = np.linalg.norm(axis)
    if nrm < 1e-12:
        return R.copy(), -R @ c
    axis = axis / nrm
    # Rodrigues for rotation of -angle about axis, transposed application
    # (reference composes Rrollᵀ·R, src/Camera.cpp:903).
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    Rroll = np.eye(3) + np.sin(-angle) * K + (1 - np.cos(-angle)) * (K @ K)
    Rnew = Rroll.T @ R
    return Rnew, -Rnew @ c

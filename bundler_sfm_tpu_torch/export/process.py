"""Bundle-file surgery ops — the `ProcessBundle.cpp` tool set operating on
BundleFile objects (`src/ProcessBundle.cpp`): scale focal lengths, rotate
cameras, zero distortion, prune bad points, compressed output.  A copy of
the JAX package's host-only module; `bundler --bundle` surgery mode calls
it."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from bundler_sfm_tpu_torch.io.bundlefile import BundleCamera, BundleFile, BundlePoint


def scale_focal_lengths(bundle: BundleFile, scale) -> BundleFile:
    """Multiply registered focals by `scale` (scalar or per-image array)
    (`ScaleFocalLengths`, `src/ProcessBundle.cpp:144,244`)."""
    scales = np.broadcast_to(np.asarray(scale, dtype=np.float64),
                             (len(bundle.cameras),))
    cams = []
    for cam, s in zip(bundle.cameras, scales):
        if cam.registered:
            cams.append(BundleCamera(f=cam.f * s, k1=cam.k1, k2=cam.k2,
                                     R=cam.R, t=cam.t))
        else:
            cams.append(cam)
    return BundleFile(cameras=cams, points=bundle.points)


def rotate_cameras(bundle: BundleFile, R_global: np.ndarray) -> BundleFile:
    """Apply a global rotation to the scene (`RotateCameras`,
    `src/ProcessBundle.cpp:30`): R' = R·R_gᵀ, points rotated by R_g."""
    R_global = np.asarray(R_global)
    cams = []
    for cam in bundle.cameras:
        if cam.registered:
            cams.append(BundleCamera(f=cam.f, k1=cam.k1, k2=cam.k2,
                                     R=cam.R @ R_global.T, t=cam.t))
        else:
            cams.append(cam)
    pts = [BundlePoint(pos=R_global @ p.pos, color=p.color, views=p.views)
           for p in bundle.points]
    return BundleFile(cameras=cams, points=pts)


def rotate_cameras_roll(bundle: BundleFile,
                        degrees: Sequence[float]) -> BundleFile:
    """Per-camera in-plane roll (`RotateCameras(char*)`,
    `src/ProcessBundle.cpp:30-62`): R' = Rz(θᵢ)·Rᵢ, t' = Rz(θᵢ)·tᵢ —
    camera centers are invariant, only the image orientation turns."""
    cams = []
    for cam, deg in zip(bundle.cameras, degrees):
        if cam.registered and deg != 0.0:
            rad = np.deg2rad(deg)
            Rz = np.array([[np.cos(rad), -np.sin(rad), 0.0],
                           [np.sin(rad), np.cos(rad), 0.0],
                           [0.0, 0.0, 1.0]])
            cams.append(BundleCamera(f=cam.f, k1=cam.k1, k2=cam.k2,
                                     R=Rz @ cam.R, t=Rz @ cam.t))
        else:
            cams.append(cam)
    return BundleFile(cameras=cams, points=bundle.points)


def read_per_image_values(path: str, num_images: int) -> np.ndarray:
    """Read a `name value` per-line file (the format of --rotate_cameras
    and --scale_focal_file inputs, `src/ProcessBundle.cpp:40-43,154-157`)."""
    vals = np.zeros(num_images)
    with open(path) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    for i, toks in enumerate(lines[:num_images]):
        vals[i] = float(toks[1]) if len(toks) > 1 else float(toks[0])
    return vals


def zero_distortion_params(bundle: BundleFile) -> BundleFile:
    """`ZeroDistortionParams` (`src/ProcessBundle.cpp:551`)."""
    cams = [BundleCamera(f=c.f, k1=0.0, k2=0.0, R=c.R, t=c.t)
            if c.registered else c for c in bundle.cameras]
    return BundleFile(cameras=cams, points=bundle.points)


def prune_bad_points(bundle: BundleFile,
                     min_angle_deg: float = 1.5,
                     min_views: int = 3) -> BundleFile:
    """Drop points with < min_views views or max triangulation angle below
    the threshold (`PruneBadPoints`, `src/ProcessBundle.cpp:494-549`;
    MIN_ANGLE_THRESHOLD = 1.5°). Pruned points keep their slot with views
    cleared and the outlier color (0,0,255), as the reference does."""
    centers = [c.center if c.registered else None for c in bundle.cameras]
    out_pts = []
    num_pruned = 0
    for p in bundle.points:
        views = p.views[:, 0].astype(int)
        max_angle = 0.0
        rays = []
        for v in views:
            if centers[v] is None:
                continue
            r = p.pos - centers[v]
            n = np.linalg.norm(r)
            if n > 0:
                rays.append(r / n)
        for a in range(len(rays)):
            for b in range(a + 1, len(rays)):
                dot = np.clip(rays[a] @ rays[b], -1 + 1e-8, 1 - 1e-8)
                max_angle = max(max_angle, np.degrees(np.arccos(dot)))
        if len(views) < min_views or max_angle < min_angle_deg:
            out_pts.append(BundlePoint(
                pos=p.pos, color=np.array([0.0, 0.0, 255.0]),
                views=np.zeros((0, 4))))
            num_pruned += 1
        else:
            out_pts.append(p)
    return BundleFile(cameras=bundle.cameras, points=out_pts)


def compress(bundle: BundleFile, image_names: Sequence[str]
             ) -> "tuple[BundleFile, List[str]]":
    """Drop unregistered cameras, remapping point view indices
    (`OutputCompressed`, `src/ProcessBundle.cpp:335`).  Returns the
    compressed bundle and the compressed image-name list."""
    remap: Dict[int, int] = {}
    cams, names = [], []
    for i, cam in enumerate(bundle.cameras):
        if cam.registered:
            remap[i] = len(cams)
            cams.append(cam)
            names.append(image_names[i] if i < len(image_names) else f"{i}")
    pts = []
    for p in bundle.points:
        if len(p.views) == 0:
            continue
        keep = [v for v in p.views if int(v[0]) in remap]
        if not keep:
            continue
        v = np.array([[remap[int(x[0])], x[1], x[2], x[3]] for x in keep])
        pts.append(BundlePoint(pos=p.pos, color=p.color, views=v))
    return BundleFile(cameras=cams, points=pts), names


def estimate_up_vector(bundle: BundleFile,
                       up_image: int = -1,
                       min_deg: float = 80.0) -> np.ndarray:
    """Scene up vector from camera y-axes.

    Role of `EstimateAxes` (`src/BaseGeometry.cpp:553-713`): pick the camera
    whose y-axis is most consistently orthogonal to the other cameras'
    x-axes (within 90°±10°), use its y-axis as the up reference."""
    regs = [i for i, c in enumerate(bundle.cameras) if c.registered]
    if up_image >= 0:
        return bundle.cameras[up_image].R[1].copy()
    dot_thr = np.cos(np.deg2rad(min_deg))
    best, best_inl = regs[0], -1
    for i in regs:
        y_i = bundle.cameras[i].R[1]
        inl = sum(1 for j in regs if j != i and
                  abs(y_i @ bundle.cameras[j].R[0]) <= dot_thr)
        if inl > best_inl:
            best, best_inl = i, inl
    return bundle.cameras[best].R[1].copy()


def transform_scene_canonical(bundle: BundleFile,
                              up_image: int = -1) -> BundleFile:
    """Rotate the scene so the estimated up vector becomes +y, then
    center/scale (role of `TransformSceneCanonical`,
    `src/BaseGeometry.cpp:1162`)."""
    up = estimate_up_vector(bundle, up_image)
    up = up / np.linalg.norm(up)
    # Rotation taking `up` to (0, 1, 0).
    y = np.array([0.0, 1.0, 0.0])
    v = np.cross(up, y)
    s = np.linalg.norm(v)
    c = up @ y
    if s < 1e-12:
        Rg = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        Rg = np.eye(3) + vx + vx @ vx * ((1 - c) / (s * s))
    return reposition_scene(rotate_cameras(bundle, Rg))


def reposition_scene(bundle: BundleFile) -> BundleFile:
    """Translate/scale the scene to a canonical frame: centroid of camera
    centers at the origin, median camera distance 1 (role of
    `RepositionScene`, `src/BaseGeometry.cpp:1023`)."""
    centers = np.stack([c.center for c in bundle.cameras if c.registered])
    mu = centers.mean(axis=0)
    d = np.linalg.norm(centers - mu, axis=1)
    scale = 1.0 / max(np.median(d), 1e-12)
    cams = []
    for cam in bundle.cameras:
        if not cam.registered:
            cams.append(cam)
            continue
        c_new = (cam.center - mu) * scale
        cams.append(BundleCamera(f=cam.f, k1=cam.k1, k2=cam.k2,
                                 R=cam.R, t=-cam.R @ c_new))
    pts = [BundlePoint(pos=(p.pos - mu) * scale, color=p.color,
                       views=p.views) for p in bundle.points]
    return BundleFile(cameras=cams, points=pts)

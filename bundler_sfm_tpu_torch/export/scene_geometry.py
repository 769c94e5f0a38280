"""Scene-level geometry on BundleFile objects — port of
`bundler_sfm_tpu/export/scene_geometry.py`: the `BaseGeometry.cpp` /
`Geometry.cpp` post-processing set — plane fits over the reconstruction,
up-vector / axes estimation, ground-plane scene setup, point normals +
confidence, bad-image removal, and panorama detection.

The orchestration stays host numpy on BundleFile, as in the JAX package
(per-scene, not per-observation, cost); the plane / line RANSAC fits and
the kNN normals run on `device` through `ops/plane.py`.  Each function
that draws RANSAC samples takes them as `samples` (or draws them from a
`torch.Generator` on `device` seeded with `seed`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from bundler_sfm_tpu_torch.io.bundlefile import (
    BundleCamera, BundleFile, BundlePoint,
)
from bundler_sfm_tpu_torch.ops.plane import (
    draw_samples, fit_line_2d_ransac, fit_plane_ransac, knn_plane_normals,
)
from bundler_sfm_tpu_torch.utils.device import resolve_device


def _registered(bundle: BundleFile) -> List[int]:
    return [i for i, c in enumerate(bundle.cameras) if c.registered]


def _ransac_samples(samples, seed, rounds, k, n, dev):
    """The given draw on `dev`, or `rounds` k-subsets of range(n) from a
    generator on `dev` seeded with `seed`."""
    if samples is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return draw_samples(gen, rounds, k, torch.ones(n, device=dev))
    return torch.as_tensor(samples).to(dev, torch.int64)


def fit_plane_to_points(positions: np.ndarray,
                        indices: Optional[Sequence[int]] = None,
                        ransac_rounds: int = 1024,
                        ransac_threshold: float = 0.1,
                        par_to_up: bool = False,
                        perp_to_up: bool = False,
                        up: Optional[np.ndarray] = None,
                        seed: int = 0, samples=None, device="cuda"
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Fit a plane to a subset of 3D points (`FitPlaneToPoints`,
    `src/Geometry.cpp:897-1005`); the RANSAC fit on `device` in f64.

    par_to_up: constrain the plane to contain the up direction (y), fitting
    a 2D line in the xz slice (`:966-990`).  perp_to_up: refit the normal to
    `up` through the inlier centroid (`:938-961`).  samples: [ransac_rounds,
    3] (par_to_up: [ransac_rounds, 2]) indices into the selected points.
    Returns (plane [4], inlier indices into `positions`).
    """
    dev = resolve_device(device)
    positions = np.asarray(positions, np.float64)
    idx = (np.arange(len(positions)) if indices is None
           else np.asarray(list(indices), np.int64))
    pts = positions[idx]
    mask = torch.ones(len(pts), dtype=torch.float64, device=dev)

    if par_to_up and perp_to_up:
        perp_to_up = False  # reference warns and drops perp (:905-908)

    if par_to_up:
        assert up is not None and abs(up[1] - 1.0) < 1e-5, \
            "par_to_up requires the scene already aligned to +y (:969)"
        s = _ransac_samples(samples, seed, ransac_rounds, 2, len(pts), dev)
        line, _, _ = fit_line_2d_ransac(
            s, torch.from_numpy(pts[:, [0, 2]]).to(dev), mask,
            ransac_threshold)
        line = line.cpu().numpy()
        plane = np.array([line[0], 0.0, line[1], line[2]])
    else:
        s = _ransac_samples(samples, seed, ransac_rounds, 3, len(pts), dev)
        pl, _, _ = fit_plane_ransac(s, torch.from_numpy(pts).to(dev), mask,
                                    ransac_threshold)
        plane = pl.cpu().numpy()

    dist = np.abs(pts @ plane[:3] + plane[3])
    inliers = idx[dist < ransac_threshold]

    if perp_to_up:
        assert up is not None
        mean = positions[inliers].mean(axis=0)
        plane = np.array([up[0], up[1], up[2], -float(up @ mean)])
        # Inlier set is NOT regathered (reference keeps the pre-projection
        # inliers, :943-961).
    return plane, inliers


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


def setup_scene_ground_plane(bundle: BundleFile, up_image: int = -1,
                             scale_factor: float = 0.05,
                             metric: bool = False, scale_param: float = 1.0,
                             seed: int = 0, samples=None, device="cuda"):
    """Ground-plane scene frame (`SetupSceneGroundPlane`,
    `src/BaseGeometry.cpp:715-951`): RANSAC-fit a plane through the camera
    centers (1024 rounds at scale_factor*rms threshold, on `device`; samples
    [1024, 3] index the registered cameras), orient it by the cameras'
    up-vector vote, and take the middle principal direction of the
    centered centers as the x-axis.  Returns (center, up, x_axis, z_axis,
    scale)."""
    dev = resolve_device(device)
    regs = _registered(bundle)
    cc = np.stack([bundle.cameras[i].center for i in regs])
    mean = cc.mean(axis=0)
    cc0 = cc - mean
    rms = float(np.sqrt((cc0 ** 2).sum(axis=1).mean()))

    if up_image == -1:
        s = _ransac_samples(samples, seed, 1024, 3, len(cc0), dev)
        pl, n_inl, _ = fit_plane_ransac(
            s, torch.from_numpy(cc0).to(dev),
            torch.ones(len(cc0), dtype=torch.float64, device=dev),
            scale_factor * rms)
        plane = pl.cpu().numpy()[:3]
        plane /= max(np.linalg.norm(plane), 1e-12)
        cc_svd = cc0
    else:
        plane = bundle.cameras[up_image].R.T @ np.array([0.0, 1.0, 0.0])
        plane /= max(np.linalg.norm(plane), 1e-12)
        # Project centers onto the plane before the SVD (:836-848).
        cc_svd = cc0 - np.outer(cc0 @ plane, plane)

    _, S, VT = np.linalg.svd(cc_svd, full_matrices=False)

    # Orient the plane normal by the camera up-vote (:857-893): camera up
    # in world coords is R^T [0,1,0] = R[1] row transposed... GetPose gives
    # R^T, so up_cam = R^T y = row 1 of R read as a column = R.T @ y.
    num_pos = num_neg = 0
    for i in regs:
        up_cam = bundle.cameras[i].R.T @ np.array([0.0, 1.0, 0.0])
        d = up_cam @ plane
        if abs(d) < 0.8:
            continue
        if d < 0.0:
            num_neg += 1
        else:
            num_pos += 1
    up = plane if num_pos >= num_neg else -plane

    # x-axis: middle principal direction, negated (:899-911).
    order = np.argsort(S)            # ascending; middle = order[1]
    x_axis = -VT[order[1]]
    x_axis /= max(np.linalg.norm(x_axis), 1e-12)
    # Orthogonalize against up (:916-925).
    x_axis = x_axis - (up @ x_axis) * up
    x_axis /= max(np.linalg.norm(x_axis), 1e-12)
    z_axis = np.cross(x_axis, up)

    scale = 1000.0 if metric else scale_param * rms
    return mean, up, x_axis, z_axis, scale


def setup_scene(bundle: BundleFile, up_image: int = -1,
                estimate_up_vector_szeliski: bool = False, **kw):
    """`SetupScene` (`src/BaseGeometry.cpp:936-951`): ground-plane frame,
    optionally recomputing the axes with EstimateAxes.  `kw` goes to
    setup_scene_ground_plane (samples, seed and device among them)."""
    center, up, x_axis, z_axis, scale = setup_scene_ground_plane(
        bundle, up_image=up_image, **kw)
    if estimate_up_vector_szeliski:
        x_axis, up, z_axis = estimate_axes(bundle, up_image=up_image)
    return center, up, x_axis, z_axis, scale


def estimate_point_normals_confidence(bundle: BundleFile
                                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-point normals + confidence (`EstimatePointNormalsConfidence`,
    `src/BaseGeometry.cpp:1405-1442`): normal = -mean unit ray from viewing
    cameras; confidence from the max pairwise angle between the three most
    spread-out rays, clamped to [0,1] over 20 degrees (`ComputeConfidence`,
    `:1375-1403`)."""
    centers = np.stack([c.center if c.registered else np.zeros(3)
                        for c in bundle.cameras])
    P = len(bundle.points)
    normals = np.zeros((P, 3))
    conf = np.zeros(P)
    for pi, p in enumerate(bundle.points):
        cams = p.views[:, 0].astype(int) if len(p.views) else np.array([], int)
        if len(cams) == 0:
            continue
        rays = p.pos[None, :] - centers[cams]
        rays /= np.maximum(np.linalg.norm(rays, axis=1, keepdims=True), 1e-12)
        n = rays.sum(axis=0)
        normals[pi] = -n / max(np.linalg.norm(n), 1e-12)
        conf[pi] = _ray_confidence(rays)
    return normals, conf


def _ray_confidence(rays: np.ndarray, max_angle_deg: float = 20.0) -> float:
    """`ComputeConfidence` (`src/BaseGeometry.cpp:1375-1403`)."""
    if len(rays) <= 2:
        return 0.0
    avg = rays.mean(axis=0)
    avg /= max(np.linalg.norm(avg), 1e-12)

    def extremum(v):                         # ray furthest from direction v
        return rays[np.argmin(rays @ v)]

    ex1 = extremum(avg)
    ex2 = extremum(ex1)
    ex3 = rays[np.argmin(np.maximum(rays @ ex1, rays @ ex2))]
    max_dot = max(ex1 @ ex2, ex2 @ ex3, ex1 @ ex3)
    angle = np.degrees(np.arccos(np.clip(max_dot, -1.0, 1.0)))
    return float(np.clip(angle / max_angle_deg, 0.0, 1.0))


def remove_bad_images(bundle: BundleFile, min_num_points: int = 24
                      ) -> BundleFile:
    """Unregister cameras seeing fewer than `min_num_points` points and
    erase their views (`RemoveBadImages`, `src/BaseGeometry.cpp:1596-1627`;
    called with 24 / 6 at `src/BundlerApp.cpp:904,970`)."""
    counts = np.zeros(len(bundle.cameras), int)
    for p in bundle.points:
        for v in p.views:
            counts[int(v[0])] += 1
    bad = {i for i, c in enumerate(bundle.cameras)
           if c.registered and counts[i] < min_num_points}
    if not bad:
        return bundle
    cams = [BundleCamera(f=0.0, k1=0.0, k2=0.0, R=np.zeros((3, 3)),
                         t=np.zeros(3)) if i in bad else c
            for i, c in enumerate(bundle.cameras)]
    pts = []
    for p in bundle.points:
        keep = np.array([v for v in p.views if int(v[0]) not in bad]
                        ).reshape(-1, p.views.shape[1] if len(p.views) else 4)
        pts.append(BundlePoint(pos=p.pos, color=p.color, views=keep))
    return BundleFile(cameras=cams, points=pts)


def images_part_of_panorama(bundle: BundleFile, i1: int, i2: int,
                            max_angle_deg: float = 3.0,
                            max_offset_ratio: float = 0.1) -> bool:
    """Do two cameras form (part of) a panorama? (`ImagesPartOfPanorama`,
    `src/BaseGeometry.cpp:1629-1720`): small mean ray angle across both
    cameras' points and camera separation under 10% of the mean ray
    length."""
    c1, c2 = bundle.cameras[i1], bundle.cameras[i2]
    if not (c1.registered and c2.registered):
        return False
    vis1 = [pi for pi, p in enumerate(bundle.points)
            if len(p.views) and i1 in p.views[:, 0].astype(int)]
    vis2 = [pi for pi, p in enumerate(bundle.points)
            if len(p.views) and i2 in p.views[:, 0].astype(int)]
    if not set(vis1) & set(vis2):
        return False
    pos1, pos2 = c1.center, c2.center
    pts = np.stack([bundle.points[pi].pos for pi in vis1 + vis2])
    r1 = pts - pos1
    r2 = pts - pos2
    d1 = np.linalg.norm(r1, axis=1)
    d2 = np.linalg.norm(r2, axis=1)
    cosang = np.clip(np.sum(r1 * r2, axis=1) / np.maximum(d1 * d2, 1e-12),
                     -1 + 1e-8, 1 - 1e-8)
    angle_avg = np.degrees(np.arccos(cosang)).mean()
    dist_cams = np.linalg.norm(pos1 - pos2)
    return (angle_avg <= max_angle_deg
            and dist_cams <= max_offset_ratio * d1.mean()
            and dist_cams <= max_offset_ratio * d2.mean())


def compute_image_rotations(bundle: BundleFile, seed: int = 0,
                            samples=None, device="cuda") -> List[int]:
    """Per-image quarter-turn uprighting (`ComputeImageRotations`,
    `src/BaseGeometry.cpp:502-549`): project the scene up vector (the
    ground plane's, fitted on `device`) into each image and pick the
    90-degree rotation (0..3) aligning it with +y."""
    _, up, _, _, _ = setup_scene_ground_plane(bundle, seed=seed,
                                              samples=samples, device=device)
    rots = [0] * len(bundle.cameras)
    for i, cam in enumerate(bundle.cameras):
        if not cam.registered:
            continue
        up_cam = cam.R @ up            # pose^T·up with pose = R^T
        x_dot, y_dot = up_cam[0], up_cam[1]
        if abs(x_dot) > abs(y_dot):
            rots[i] = 3 if x_dot > 0.0 else 1
        else:
            rots[i] = 0 if y_dot > 0.0 else 2
    return rots


def get_point_projections(bundle: BundleFile, cam_idx: int,
                          indices: Optional[Sequence[int]] = None,
                          width: int = 0, height: int = 0,
                          cheirality: bool = True):
    """Project points into one camera, keeping in-front (and, when an image
    size is given, in-bounds) ones (`GetPointProjections`,
    `src/Geometry.cpp:1010-1048`).  Returns (projs [M,2], kept indices)."""
    cam = bundle.cameras[cam_idx]
    idx = (np.arange(len(bundle.points)) if indices is None
           else np.asarray(list(indices), np.int64))
    pos = np.stack([bundle.points[i].pos for i in idx])
    q = (pos - cam.center) @ cam.R.T
    in_front = q[:, 2] < 0.0 if cheirality else np.ones(len(q), bool)
    qz = np.where(np.abs(q[:, 2]) < 1e-12, -1e-12, q[:, 2])
    u = -cam.f * q[:, :2] / qz[:, None]
    r2 = (u ** 2).sum(axis=1) / (cam.f * cam.f)
    u = u * (1.0 + cam.k1 * r2 + cam.k2 * r2 * r2)[:, None]
    keep = in_front
    if width and height:
        keep = keep & (np.abs(u[:, 0]) <= 0.5 * width) \
                    & (np.abs(u[:, 1]) <= 0.5 * height)
    return u[keep], idx[keep]


def estimate_point_normals(bundle: BundleFile, k: int = 32,
                           device="cuda") -> np.ndarray:
    """kNN plane-fit normals, oriented toward the viewing cameras
    (`EstimatePointNormals`, `src/BaseGeometry.cpp:1444-1594`, NUM_NNS=32);
    the kNN + covariance work runs batched on `device`
    (ops/plane.knn_plane_normals)."""
    dev = resolve_device(device)
    P = len(bundle.points)
    if P == 0:
        return np.zeros((0, 3))
    pos = np.stack([p.pos for p in bundle.points])
    normals = knn_plane_normals(pos, np.ones(P), k=min(k, P),
                                device=dev).cpu().numpy()
    # Orient each normal against the mean viewing ray (toward the cameras).
    centers = np.stack([c.center if c.registered else np.zeros(3)
                        for c in bundle.cameras])
    for pi, p in enumerate(bundle.points):
        cams = p.views[:, 0].astype(int) if len(p.views) else []
        if len(cams) == 0:
            continue
        rays = pos[pi][None, :] - centers[cams]
        if normals[pi] @ rays.mean(axis=0) > 0:
            normals[pi] = -normals[pi]
    return normals

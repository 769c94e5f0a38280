"""constraints.txt — the geometric-verification checkpoint.

The reference caches pairwise geometry + tracks and skips recomputation when
the file exists (`ComputeGeometricConstraints`,
`src/BundlerGeometry.cpp:105-108`; writer `WriteGeometricConstraints`,
`src/BaseGeometry.cpp:273-364`).  Format:

    <num_images>
    <num_transforms>
    --- per transform:
    i j
    H (9 floats on one line)
    F (9 floats on one line)
    inlier_ratio
    num_inliers
    0                      # match list (reference writes 0 matches)
    --- tracks:
    <num_tracks>
    <size img key img key ...>   per track

Also provides pairwise_scores.txt (`src/BundlerGeometry.cpp:309-326`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from bundler_sfm_tpu_torch.pipeline.scene import Scene, TransformInfo


def write_geometric_constraints(path: str, scene: Scene) -> None:
    # Transforms are stored for both (i,j) and (j,i) like the reference's
    # symmetric adjacency.
    keys = sorted(scene.transforms.keys())
    with open(path, "w") as f:
        f.write(f"{scene.num_images}\n")
        f.write(f"{len(keys)}\n")
        for (i, j) in keys:
            t = scene.transforms[(i, j)]
            f.write(f"{i} {j}\n")
            H = t.hmatrix if t.hmatrix is not None else np.zeros((3, 3))
            F = t.fmatrix if t.fmatrix is not None else np.zeros((3, 3))
            f.write(" ".join(f"{v:0.6e}" for v in H.reshape(-1)) + "\n")
            f.write(" ".join(f"{v:0.6e}" for v in F.reshape(-1)) + "\n")
            f.write(f"{t.inlier_ratio:0.16e}\n")
            f.write(f"{t.num_inliers}\n")
            f.write("0\n")
        f.write(f"{len(scene.tracks)}\n")
        for track in scene.tracks:
            f.write(str(len(track)))
            for img, key in track:
                f.write(f" {img} {key}")
            f.write("\n")


def read_geometric_constraints(path: str, scene: Scene) -> None:
    """Restore transforms + tracks into `scene` (the resume path the
    reference takes when constraints.txt exists)."""
    from bundler_sfm_tpu_torch.pipeline.tracks import tracks_to_image_tables

    with open(path) as f:
        tokens = f.read().split()
    pos = 0

    def take(n):
        nonlocal pos
        out = tokens[pos:pos + n]
        pos += n
        return out

    num_images = int(take(1)[0])
    if num_images != scene.num_images:
        raise ValueError(
            f"constraints file has {num_images} images, scene has "
            f"{scene.num_images}")
    num_transforms = int(take(1)[0])
    scene.transforms = {}
    for _ in range(num_transforms):
        i, j = int(take(1)[0]), int(take(1)[0])
        H = np.array(take(9), dtype=np.float64).reshape(3, 3)
        F = np.array(take(9), dtype=np.float64).reshape(3, 3)
        ratio = float(take(1)[0])
        num_inl = int(take(1)[0])
        num_matches = int(take(1)[0])
        take(2 * num_matches)
        scene.transforms[(i, j)] = TransformInfo(
            fmatrix=F if np.any(F) else None,
            hmatrix=H if np.any(H) else None,
            num_inliers=num_inl, inlier_ratio=ratio)
    num_tracks = int(take(1)[0])
    tracks = []
    for _ in range(num_tracks):
        sz = int(take(1)[0])
        vals = np.array(take(2 * sz), dtype=np.int64).reshape(sz, 2)
        tracks.append([(int(a), int(b)) for a, b in vals])
    scene.tracks = tracks
    vp, vk, kt = tracks_to_image_tables(tracks, scene.num_images)
    scene.visible_points = vp
    scene.visible_keys = vk
    scene.key_track = kt
    scene.matches = {}


def write_pairwise_scores(path: str, scene: Scene) -> None:
    """pairwise_scores.txt: `i j ratio` per matched pair, ratio %0.5f —
    the exact lines `src/BundlerGeometry.cpp:309-326` prints at the end of
    ComputeTransforms (pairs whose homography failed keep the default
    ratio 0, as the reference's default-constructed TransformInfo does)."""
    with open(path, "w") as f:
        for (i, j) in sorted(scene.transforms.keys()):
            if i >= j:
                continue
            t = scene.transforms[(i, j)]
            f.write(f"{i} {j} {t.inlier_ratio:0.5f}\n")

"""`bundler_sfm_tpu/io/plyfile.py` in the port: PLY
point-cloud writer matching the reference's `DumpPointsToPly`
(`src/BundleIO.cpp:1112-1183`): outlier points (painted pure blue 0,0,255) are
skipped; each camera contributes two vertices — its center (alternating
green/red) and a yellow vertex 0.05 units along the viewing direction.
The vertices are formatted from flat arrays in one native call
(`io/bundle_text.py`)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from bundler_sfm_tpu_torch.io import bundle_text


def write_points_ply(
    path: str,
    points: np.ndarray,            # [P,3]
    colors: np.ndarray,            # [P,3]
    camera_R: Optional[np.ndarray] = None,        # [C,3,3]
    camera_centers: Optional[np.ndarray] = None,  # [C,3]
) -> None:
    """The points, then each camera's two vertices, formatted in one native
    call (`io/bundle_text.py`)."""
    verts = [np.asarray(points, dtype=np.float64).reshape(-1, 3)]
    cols = [np.asarray(colors, dtype=np.float64).reshape(-1, 3)]
    num_cams = 0 if camera_centers is None else len(camera_centers)
    for i in range(num_cams):
        c = np.asarray(camera_centers[i], dtype=np.float64)
        # Viewing direction: camera looks down -z in camera coords.
        p = camera_R[i].T @ np.array([0.0, 0.0, -0.05]) + c
        verts.append(np.stack([c, p]))
        cols.append(np.array([[0.0, 255.0, 0.0] if i % 2 == 0
                              else [255.0, 0.0, 0.0], [255.0, 255.0, 0.0]]))
    with open(path, "w") as f:
        bundle_text.write_ply(f, np.concatenate(verts), np.concatenate(cols))

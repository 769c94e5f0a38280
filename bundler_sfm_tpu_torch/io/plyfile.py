"""A copy of `bundler_sfm_tpu/io/plyfile.py` (host numpy only): PLY
point-cloud writer matching the reference's `DumpPointsToPly`
(`src/BundleIO.cpp:1112-1183`): outlier points (painted pure blue 0,0,255) are
skipped; each camera contributes two vertices — its center (alternating
green/red) and a yellow vertex 0.05 units along the viewing direction."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

_PLY_HEADER = """ply
format ascii 1.0
element vertex {n}
property float x
property float y
property float z
property uchar diffuse_red
property uchar diffuse_green
property uchar diffuse_blue
end_header
"""


def write_points_ply(
    path: str,
    points: np.ndarray,            # [P,3]
    colors: np.ndarray,            # [P,3]
    camera_R: Optional[np.ndarray] = None,        # [C,3,3]
    camera_centers: Optional[np.ndarray] = None,  # [C,3]
) -> None:
    points = np.asarray(points, dtype=np.float64)
    colors = np.asarray(colors)
    good = ~((colors[:, 0] == 0) & (colors[:, 1] == 0) & (colors[:, 2] == 255))
    num_cams = 0 if camera_centers is None else len(camera_centers)
    with open(path, "w") as f:
        f.write(_PLY_HEADER.format(n=int(good.sum()) + 2 * num_cams))
        for p, c in zip(points[good], colors[good]):
            f.write(f"{p[0]:0.6e} {p[1]:0.6e} {p[2]:0.6e} "
                    f"{int(round(c[0]))} {int(round(c[1]))} {int(round(c[2]))}\n")
        for i in range(num_cams):
            c = camera_centers[i]
            col = "0 255 0" if i % 2 == 0 else "255 0 0"
            f.write(f"{c[0]:0.6e} {c[1]:0.6e} {c[2]:0.6e} {col}\n")
            # Viewing direction: camera looks down -z in camera coords.
            p = camera_R[i].T @ np.array([0.0, 0.0, -0.05]) + c
            f.write(f"{p[0]:0.6e} {p[1]:0.6e} {p[2]:0.6e} 255 255 0\n")

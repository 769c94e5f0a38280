"""Bundle2Vis — PMVS covisibility file; a copy of
`bundler_sfm_tpu/export/vis.py` (host).

Reference `src/Bundle2Vis.cpp:60-217`: count shared points per camera pair;
a pair is "visible" at >= 32 shared points; format:

    VISDATA
    <num cameras>
    <cam_idx> <num_vis> <vis...>     (one row per camera)
"""

from __future__ import annotations

import numpy as np

from bundler_sfm_tpu_torch.io.bundlefile import read_bundle_file

MATCH_THRESHOLD = 32


def covisibility_counts(bundle) -> np.ndarray:
    n = len(bundle.cameras)
    matches = np.zeros((n, n), dtype=np.int64)
    for p in bundle.points:
        views = p.views[:, 0].astype(int)
        for a in range(len(views)):
            for b in range(a + 1, len(views)):
                matches[views[a], views[b]] += 1
                matches[views[b], views[a]] += 1
    return matches


def write_vis_file(bundle_file: str, vis_file: str,
                   threshold: int = MATCH_THRESHOLD) -> None:
    bundle = read_bundle_file(bundle_file)
    matches = covisibility_counts(bundle)
    n = len(bundle.cameras)
    with open(vis_file, "w") as f:
        f.write("VISDATA\n")
        f.write(f"{n}\n")
        for i in range(n):
            vis = np.nonzero(matches[i] >= threshold)[0]
            f.write(f"{i} {len(vis)}")
            for j in vis:
                f.write(f" {j}")
            f.write("\n")

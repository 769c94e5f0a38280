"""Bundle2PMVS — export a reconstruction to PMVS inputs; a copy of
`bundler_sfm_tpu/export/pmvs.py` (host text).

Reference `src/Bundle2PMVS.cpp:144-255` (`WritePMVS`): per registered camera
a `txt/%08d.txt` projection matrix

    P = -K [R | t],  K = [[-f, 0, (w-1)/2], [0, f, (h-1)/2], [0, 0, 1]]

plus `pmvs_options.txt` and a `prep_pmvs.sh` helper script, which runs this
package's `radialundistort` and `bundle2vis`.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from bundler_sfm_tpu_torch.io.bundlefile import BundleFile, read_bundle_file
from bundler_sfm_tpu_torch.io.listfile import read_list_file

PMVS_OPTIONS = """level 1
csize 2
threshold 0.7
wsize 7
minImageNum 3
CPU 8
setEdge 0
useBound 0
useVisData 1
sequence -1
timages -1 0 {count}
oimages -3
"""


def pmvs_projection(f: float, R: np.ndarray, t: np.ndarray,
                    width: int, height: int) -> np.ndarray:
    """P = -K[R|t] with the reference's negated-fx K
    (`src/Bundle2PMVS.cpp:193-207`)."""
    K = np.array([[-f, 0.0, 0.5 * width - 0.5],
                  [0.0, f, 0.5 * height - 0.5],
                  [0.0, 0.0, 1.0]])
    Rt = np.concatenate([R, t[:, None]], axis=1)
    return -(K @ Rt)


def write_pmvs(output_path: str, list_file: str, bundle_file: str,
               image_dims: Optional[Sequence[Tuple[int, int]]] = None) -> int:
    """Write the PMVS directory; returns the number of exported cameras."""
    bundle = read_bundle_file(bundle_file)
    entries = read_list_file(list_file)
    os.makedirs(output_path, exist_ok=True)
    os.makedirs(os.path.join(output_path, "txt"), exist_ok=True)
    os.makedirs(os.path.join(output_path, "visualize"), exist_ok=True)
    os.makedirs(os.path.join(output_path, "models"), exist_ok=True)

    script_lines = [
        "# Script for preparing images and calibration data",
        "#   for Yasutaka Furukawa's PMVS system",
        "",
        "# Apply radial undistortion to the images",
        f"python -m bundler_sfm_tpu_torch.radialundistort {list_file} "
        f"{bundle_file} {output_path}",
        "",
        "# Copy and rename files",
    ]

    count = 0
    for i, cam in enumerate(bundle.cameras):
        if not cam.registered:
            continue
        if image_dims is not None:
            w, h = image_dims[i]
        else:
            w, h = _dims(entries[i].name)
        P = pmvs_projection(cam.f, cam.R, cam.t, w, h)
        txt = os.path.join(output_path, "txt", f"{count:08d}.txt")
        with open(txt, "w") as fo:
            fo.write("CONTOUR\n")
            for r in range(3):
                fo.write(f"{P[r,0]:0.6f} {P[r,1]:0.6f} "
                         f"{P[r,2]:0.6f} {P[r,3]:0.6f}\n")
        base = os.path.splitext(os.path.basename(entries[i].name))[0]
        script_lines.append(
            f"mv pmvs/{base}.rd.jpg {output_path}/visualize/{count:08d}.jpg")
        count += 1

    with open(os.path.join(output_path, "pmvs_options.txt"), "w") as fo:
        fo.write(PMVS_OPTIONS.format(count=count))
    script_lines += [
        "",
        'echo "Running Bundle2Vis to generate vis.dat"',
        f"python -m bundler_sfm_tpu_torch.bundle2vis "
        f"{output_path}/bundle.rd.out {output_path}/vis.dat",
        "",
        "echo @@ Sample command for running pmvs:",
        f'echo "   pmvs2 {output_path}/ pmvs_options.txt"',
    ]
    with open(os.path.join(output_path, "prep_pmvs.sh"), "w") as fo:
        fo.write("\n".join(script_lines) + "\n")
    return count


def _dims(path):
    try:
        from PIL import Image
        with Image.open(path) as img:
            return img.size
    except Exception:
        return (1024, 768)

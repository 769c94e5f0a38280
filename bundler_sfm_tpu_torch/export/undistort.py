"""RadialUndistort — resample images to remove estimated radial distortion;
port of `bundler_sfm_tpu/export/undistort.py`.

Reference `src/RadialUndistort.cpp:36-120` + resampling main: per output
pixel (x, y), sample the input at the forward-distorted location

    r² = ((x-w/2)² + (y-h/2)²) / f²
    (x', y') = center + (1 + k1 r² + k2 r⁴)·(x-w/2, y-h/2)

with bilinear interpolation, black outside; writes `<base>.rd.jpg` per
registered camera plus `list.rd.txt` and `bundle.rd.out` (distortion zeroed).
The resampling runs on `device` in f64 (`ops/resample.py`); file I/O stays
on the host.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from bundler_sfm_tpu_torch.io.bundlefile import (
    BundleCamera, BundleFile, read_bundle_file, write_bundle_file,
)
from bundler_sfm_tpu_torch.io.listfile import read_list_file
from bundler_sfm_tpu_torch.ops.resample import pixel_grid, resample_bilinear
from bundler_sfm_tpu_torch.utils.device import resolve_device


def undistort_image(img: np.ndarray, f: float, k1: float, k2: float,
                    device="cuda") -> np.ndarray:
    """img [H, W, C] -> undistorted [H, W, C] (bilinear, black border),
    resampled on `device`."""
    dev = resolve_device(device)
    h, w = img.shape[:2]
    grid = pixel_grid(h, w, dev)
    xc, yc = grid[..., 0], grid[..., 1]
    f, k1, k2 = float(f), float(k1), float(k2)
    r2 = (xc * xc + yc * yc) / (f * f)
    factor = 1.0 + k1 * r2 + k2 * r2 * r2
    return resample_bilinear(img, xc * factor + 0.5 * w,
                             yc * factor + 0.5 * h)


def radial_undistort(list_file: str, bundle_file: str, output_path: str,
                     device="cuda") -> Tuple[List[str], BundleFile]:
    """The RadialUndistort tool: undistort every registered image on
    `device`, write list.rd.txt and bundle.rd.out (`WriteNewFiles`,
    `src/RadialUndistort.cpp`)."""
    from PIL import Image

    resolve_device(device)
    entries = read_list_file(list_file)
    bundle = read_bundle_file(bundle_file)
    os.makedirs(output_path, exist_ok=True)
    kept = []
    new_cams = []
    for i, cam in enumerate(bundle.cameras):
        if not cam.registered:
            new_cams.append(cam)
            continue
        name = entries[i].name
        base = os.path.splitext(os.path.basename(name))[0]
        out_name = os.path.join(output_path, base + ".rd.jpg")
        try:
            with Image.open(name) as im:
                arr = np.asarray(im.convert("RGB"))
        except FileNotFoundError:
            arr = None      # listed but absent: still listed, as in the JAX
        if arr is not None:  # package, which skips only the image
            und = undistort_image(arr, cam.f, cam.k1, cam.k2, device=device)
            Image.fromarray(und).save(out_name, quality=95)
        kept.append(out_name)
        new_cams.append(BundleCamera(f=cam.f, k1=0.0, k2=0.0,
                                     R=cam.R, t=cam.t))
    with open(os.path.join(output_path, "list.rd.txt"), "w") as f:
        for n in kept:
            f.write(n + "\n")
    rd_bundle = BundleFile(cameras=new_cams, points=bundle.points)
    write_bundle_file(os.path.join(output_path, "bundle.rd.out"), rd_bundle)
    return kept, rd_bundle

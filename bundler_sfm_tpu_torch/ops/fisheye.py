"""Fisheye (equiangular) camera model; port of `bundler_sfm_tpu/ops/fisheye.py`.

Reference `ImageData::DistortPoint` / `UndistortPoint`
(`src/ImageData.cpp:1129-1192`) with parameters (fCx, fCy, fRad, fAngle,
fFocal) from a `fisheye.txt` (`src/FisheyeUndistort.cpp:20-90`):

    undistort: r = |p - c|;  angle = 0.5·fAngle·(r/fRad);
               r' = fFocal·tan(angle);   p' = (p-c)·r'/r        (centered)
    distort:   r = |p|; angle = atan(r/fFocal) [deg];
               r' = fRad·angle/(0.5·fAngle);  p' = p·r'/r + c

COORDINATE CONVENTION: (fCx, fCy) is the fisheye-circle center as an
offset in CENTERED image coordinates (usually ~0), NOT absolute pixels —
the reference applies UndistortPoint to centered keypoints
(`src/ImageData.cpp:1183` on keys centered by ExtractFeatures) and its
undistort tool re-adds 0.5·w/h after DistortPoint
(`src/FisheyeUndistort.cpp:131-139`).

The point maps are torch ops on the tensor's device, vectorized over
[..., 2]; `undistort_image` resamples on `device` (f64, the JAX package's
expression order, round-half-even, uint8 clip).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bundler_sfm_tpu_torch.ops.resample import pixel_grid, resample_bilinear
from bundler_sfm_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class FisheyeParams:
    fCx: float = 0.0
    fCy: float = 0.0
    fRad: float = 0.0
    fAngle: float = 0.0
    fFocal: float = 0.0


def read_fisheye_file(path: str) -> FisheyeParams:
    """Parse the reference's fisheye.txt (`ReadFisheyeParameters`)."""
    p = FisheyeParams()
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            if toks[0] == "FisheyeCenter:":
                p.fCx, p.fCy = float(toks[1]), float(toks[2])
            elif toks[0] == "FisheyeRadius:":
                p.fRad = float(toks[1])
            elif toks[0] == "FisheyeAngle:":
                p.fAngle = float(toks[1])
            elif toks[0] == "FisheyeFocal:":
                p.fFocal = float(toks[1])
    return p


def undistort_points(xy: torch.Tensor, p: FisheyeParams) -> torch.Tensor:
    """Fisheye pixel coords -> rectilinear centered coords
    (`UndistortPoint`, src/ImageData.cpp:1171-1192)."""
    xn = xy[..., 0] - p.fCx
    yn = xy[..., 1] - p.fCy
    r = torch.sqrt(xn * xn + yn * yn)
    r_safe = torch.clamp(r, min=1e-12)
    angle = 0.5 * p.fAngle * (r / p.fRad)
    rnew = p.fFocal * torch.tan(torch.deg2rad(angle))
    scale = rnew / r_safe
    return torch.stack([xn * scale, yn * scale], -1)


def distort_points(xy: torch.Tensor, p: FisheyeParams) -> torch.Tensor:
    """Rectilinear centered coords -> fisheye pixel coords
    (`DistortPoint` with R = I, src/ImageData.cpp:1129-1170)."""
    xn = xy[..., 0]
    yn = xy[..., 1]
    r = torch.sqrt(xn * xn + yn * yn)
    r_safe = torch.clamp(r, min=1e-12)
    angle = torch.rad2deg(torch.arctan(r / p.fFocal))
    rnew = p.fRad * angle / (0.5 * p.fAngle)
    scale = rnew / r_safe
    return torch.stack([xn * scale + p.fCx, yn * scale + p.fCy], -1)


def undistort_image(img: np.ndarray, p: FisheyeParams, device="cuda"
                    ) -> np.ndarray:
    """Fisheye image -> rectilinear image (FisheyeUndistort tool,
    `src/FisheyeUndistort.cpp`): for each rectilinear output pixel sample
    the fisheye input at its distorted location (bilinear), on `device`."""
    dev = resolve_device(device)
    h, w = img.shape[:2]
    # Output grid in centered rectilinear coords; distort (which lands in
    # centered fisheye coords offset by fCx/fCy), then back to pixels —
    # the 0.5·w/h re-add of `src/FisheyeUndistort.cpp:131-139`.
    src = distort_points(pixel_grid(h, w, dev), p)
    return resample_bilinear(img, src[..., 0] + 0.5 * w, src[..., 1] + 0.5 * h)

"""Bilinear image resampling on a device — the sampling step shared by the
JAX package's two undistortion tools (`export/undistort.py::undistort_image`,
`ops/fisheye.py::undistort_image`), written once here: the same f64
expression order, the same `inside` mask, round-half-even and the uint8
clip, so the output equals theirs pixel for pixel where the source
positions do.
"""

from __future__ import annotations

import numpy as np
import torch


def pixel_grid(h: int, w: int, device) -> torch.Tensor:
    """[h, w, 2] centered (x, y) coordinates of every output pixel: column
    − 0.5·w, row − 0.5·h (f64)."""
    ys = torch.arange(h, dtype=torch.float64, device=device)
    xs = torch.arange(w, dtype=torch.float64, device=device)
    return torch.stack([(xs - 0.5 * w)[None, :].expand(h, w),
                        (ys - 0.5 * h)[:, None].expand(h, w)], -1)


def resample_bilinear(img: np.ndarray, xsrc: torch.Tensor, ysrc: torch.Tensor
                      ) -> np.ndarray:
    """Bilinear sample of img [H, W] or [H, W, C] (uint8) at the source
    positions [H, W] (on their device), black where a position is not
    inside [0, W-1) × [0, H-1); rounded half-to-even and clipped to uint8,
    as the JAX package's resamplers do."""
    h, w = img.shape[:2]
    inside = (xsrc >= 0) & (xsrc < w - 1) & (ysrc >= 0) & (ysrc < h - 1)
    x0 = torch.clamp(torch.floor(xsrc).long(), 0, w - 2)
    y0 = torch.clamp(torch.floor(ysrc).long(), 0, h - 2)
    fx = (xsrc - x0)[..., None]
    fy = (ysrc - y0)[..., None]
    im = torch.as_tensor(np.array(img), device=xsrc.device).to(torch.float64)
    squeeze = im.ndim == 2
    if squeeze:
        im = im[..., None]
    out = ((1 - fy) * ((1 - fx) * im[y0, x0] + fx * im[y0, x0 + 1]) +
           fy * ((1 - fx) * im[y0 + 1, x0] + fx * im[y0 + 1, x0 + 1]))
    out = torch.where(inside[..., None], out, 0.0)
    out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8).cpu().numpy()
    return out[..., 0] if squeeze else out

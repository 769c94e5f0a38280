"""Frozen copy of the procedural box-room renderer: the functions of
`bundler_sfm_tpu_torch/utils/render_scene.py` at commit 04a3558, draw for
draw (the benchmark's tests hold the two to identical JPEG bytes).

A textured "box room" (floor, four walls, ceiling) viewed by N cameras on
an interior orbit, each view rendered by per-plane homography warps,
composited nearest-plane-first; the textures come from a seed.  Kept here
so that the benchmark's inputs do not move when the program's copy does.
"""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image, ImageDraw


def texture_sheet(size: int, rng: np.random.Generator,
                  n_ellipses: int = 900) -> Image.Image:
    """Seeded texture: smooth colored noise plus random filled ellipses of
    many sizes (blob-like structure at every SIFT scale)."""
    coarse = rng.uniform(40, 215, (size // 64, size // 64, 3))
    base = Image.fromarray(coarse.astype(np.uint8)).resize(
        (size, size), Image.BICUBIC)
    draw = ImageDraw.Draw(base)
    for _ in range(n_ellipses):
        r = size * rng.uniform(0.004, 0.03)
        cx, cy = rng.uniform(0, size, 2)
        ax = r * rng.uniform(0.5, 1.5)
        ay = r * rng.uniform(0.5, 1.5)
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        draw.ellipse([cx - ax, cy - ay, cx + ax, cy + ay], fill=color)
    arr = np.asarray(base).astype(np.int16)
    arr += rng.integers(-12, 13, arr.shape).astype(np.int16)
    return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))


def plane_corners():
    """Six planes of a 10x6x10 box room (y up), corners CCW; texture (u,v)
    in [0,1]^2 maps corner order (0,0),(1,0),(1,1),(0,1)."""
    X, Y, Z = 5.0, 3.0, 5.0
    return [
        np.array([[-X, -Y, -Z], [X, -Y, -Z], [X, -Y, Z], [-X, -Y, Z]]),  # floor
        np.array([[-X, -Y, -Z], [X, -Y, -Z], [X, Y, -Z], [-X, Y, -Z]]),  # wall -z
        np.array([[X, -Y, -Z], [X, -Y, Z], [X, Y, Z], [X, Y, -Z]]),      # wall +x
        np.array([[X, -Y, Z], [-X, -Y, Z], [-X, Y, Z], [X, Y, Z]]),      # wall +z
        np.array([[-X, -Y, Z], [-X, -Y, -Z], [-X, Y, -Z], [-X, Y, Z]]),  # wall -x
        np.array([[-X, Y, -Z], [X, Y, -Z], [X, Y, Z], [-X, Y, Z]]),      # ceiling
    ]


def camera(i: int, n: int):
    """Orbit inside the room: position on a small circle, yaw sweeping 360
    degrees plus a slight pitch wobble; consecutive views overlap and the
    orbit closes the loop.  Returns (R world->cam, center)."""
    a = 2.0 * np.pi * i / n
    c = np.array([1.8 * np.sin(a), 0.6 + 0.3 * np.sin(2 * a),
                  1.8 * np.cos(a)])
    yaw = a + 0.35 * np.sin(3 * a)
    pitch = -0.35 + 0.15 * np.sin(2 * a + 1.0)
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    R_yaw = np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]])
    R_pitch = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    return R_pitch @ R_yaw, c


def render_view(R, c, f, W, H, planes, sheets) -> Image.Image:
    """Composite the planes for one camera by inverse homography warps
    (bundler convention: image = -f*xy/z, y up, origin at the center)."""
    half_w, half_h = (W - 1) / 2.0, (H - 1) / 2.0
    canvas = Image.new("RGB", (W, H))
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    ones = np.ones_like(xs, float)
    order = np.argsort([-np.linalg.norm(p.mean(0) - c) for p in planes])
    for k in order:
        corners = planes[k]
        pc = (corners - c) @ R.T
        if np.all(pc[:, 2] > -0.05):
            continue                              # fully behind
        with np.errstate(divide="ignore", invalid="ignore"):
            uv = -f * pc[:, :2] / pc[:, 2:3]
        col = uv[:, 0] + half_w
        row = (H - 1) - (uv[:, 1] + half_h)
        if not np.isfinite(col).all():
            continue
        ts = sheets[k].size[0]
        src = np.array([[0, 0], [ts - 1, 0], [ts - 1, ts - 1], [0, ts - 1]],
                       float)
        A, b = [], []
        for (sx, sy), (dx, dy) in zip(src, np.stack([col, row], 1)):
            A.append([sx, sy, 1, 0, 0, 0, -dx * sx, -dx * sy])
            b.append(dx)
            A.append([0, 0, 0, sx, sy, 1, -dy * sx, -dy * sy])
            b.append(dy)
        try:
            Hm = np.append(np.linalg.solve(np.array(A), np.array(b)), 1.0
                           ).reshape(3, 3)
            Hinv = np.linalg.inv(Hm)
        except np.linalg.LinAlgError:             # plane seen edge-on
            continue
        Hinv = Hinv / Hinv[2, 2]
        warped = sheets[k].transform(
            (W, H), Image.PERSPECTIVE, tuple(Hinv.flatten()[:8]),
            resample=Image.BILINEAR)
        # Pixels whose inverse-mapped source lies inside the sheet AND whose
        # ray hits the plane in front of the camera.
        pts = np.stack([xs, ys, ones], -1) @ Hinv.T
        with np.errstate(divide="ignore", invalid="ignore"):
            sxm = pts[..., 0] / pts[..., 2]
            sym = pts[..., 1] / pts[..., 2]
        inside = ((sxm >= 0) & (sxm <= ts - 1) & (sym >= 0)
                  & (sym <= ts - 1) & np.isfinite(sxm) & np.isfinite(sym))
        p0 = corners[0]
        nvec = np.cross(corners[1] - corners[0], corners[3] - corners[0])
        ray_img = np.stack([xs - half_w, (H - 1 - ys) - half_h, -f * ones], -1)
        denom = (ray_img @ R) @ nvec
        with np.errstate(divide="ignore", invalid="ignore"):
            tt = ((p0 - c) @ nvec) / denom
        front = (tt * f > 0.05) & np.isfinite(tt)
        mask = Image.fromarray(((inside & front) * 255).astype(np.uint8))
        canvas.paste(warped, (0, 0), mask)
    return canvas


def render_box_room(outdir: str, n: int = 24, W: int = 1024, H: int = 768,
                    seed: int = 0, f: float = 700.0, sheet_size: int = 1024):
    """Render n views into outdir; returns the ground truth dict."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    planes = plane_corners()
    sheets = [texture_sheet(sheet_size, rng) for _ in planes]
    centers, Rs = [], []
    for i in range(n):
        R, c = camera(i, n)
        render_view(R, c, f, W, H, planes, sheets).save(
            os.path.join(outdir, f"img{i:04d}.jpg"), quality=92)
        centers.append(c.tolist())
        Rs.append(R.tolist())
    gt = {"centers": centers, "Rs": Rs, "focal": f, "W": W, "H": H}
    with open(os.path.join(outdir, "gt.json"), "w") as fo:
        json.dump(gt, fo)
    return gt

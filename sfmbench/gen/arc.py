"""Frozen copy of the synthetic arc collection: `synthesize` is
`bundler_sfm_tpu_torch/probes/e2e_synthetic.py::synthesize` at commit
b49f016, draw for draw (the benchmark's tests hold the two to equal
arrays), with its module constants as arguments.

Cameras on an arc of 1.6 rad at radius 10 look at the origin; every view
draws `keys_per_image * track_ratio` track keys from one pool of world
points in [-3, 3]^3 (each descriptor its point's, jittered by up to 6 a
view, the position by `pix_noise` px) and fills the rest with clutter keys
of random position and descriptor.  `views` writes JPEGs for the views,
textured from the scene seed, so that the images a Bundler run opens for
their size and key colours are real files of a photograph's size.
"""

from __future__ import annotations

import os

import numpy as np

from sfmbench.gen import room

W_IMG, H_IMG = 1024, 768
FOCAL = 900.0
PIX_NOISE = 0.4


def look_at(c, target):
    z = c - target
    z = z / np.linalg.norm(z)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z])


def synthesize(num_images, keys_per_image, track_ratio, seed=0,
               width=W_IMG, height=H_IMG, focal=FOCAL, pix_noise=PIX_NOISE):
    """(infos, descs, gt): per view float32 [keys, 4] (x=col, y=row in raw
    image coordinates, scale 2, orientation 0) and uint8 [keys, 128];
    gt holds the centres [n, 3] and rotations [n, 3, 3]."""
    rng = np.random.default_rng(seed)
    centers = np.array([[np.sin(a) * 10, 1.5 * np.sin(2 * a),
                         np.cos(a) * 10]
                        for a in np.linspace(0, 1.6, num_images)])
    Rs = np.stack([look_at(c, np.zeros(3)) for c in centers])

    # A fixed pool relative to the per-view key budget, not scaled with
    # num_images, so that overlapping views share points.
    num_pts = int(keys_per_image * track_ratio * 5)
    pts = rng.uniform(-3, 3, (num_pts, 3))
    base_desc = rng.integers(0, 256, (num_pts, 128)).astype(np.int32)

    infos, descs = [], []
    half_w, half_h = (width - 1) / 2, (height - 1) / 2
    for i in range(num_images):
        p = np.einsum("ij,nj->ni", Rs[i], pts - centers[i])
        uv = -focal * p[:, :2] / p[:, 2:3]
        vis = ((p[:, 2] < -1.0) & (np.abs(uv[:, 0]) < half_w - 8)
               & (np.abs(uv[:, 1]) < half_h - 8))
        idx = np.nonzero(vis)[0]
        n_track = min(len(idx), int(keys_per_image * track_ratio))
        idx = rng.choice(idx, n_track, replace=False)
        xy = uv[idx] + rng.normal(0, pix_noise, (n_track, 2))
        # Centred, y up -> raw image row / col.
        col = xy[:, 0] + half_w
        row = (height - 1) - (xy[:, 1] + half_h)
        d = np.clip(base_desc[idx] + rng.integers(-6, 7, (n_track, 128)),
                    0, 255).astype(np.uint8)
        n_clutter = keys_per_image - n_track
        ccol = rng.uniform(0, width - 1, n_clutter)
        crow = rng.uniform(0, height - 1, n_clutter)
        cd = rng.integers(0, 256, (n_clutter, 128)).astype(np.uint8)
        info = np.zeros((keys_per_image, 4), np.float32)
        info[:n_track, 0] = col
        info[:n_track, 1] = row
        info[n_track:, 0] = ccol
        info[n_track:, 1] = crow
        info[:, 2] = 2.0
        perm = rng.permutation(keys_per_image)
        infos.append(info[perm])
        descs.append(np.concatenate([d, cd])[perm])
    return infos, descs, {"centers": centers, "Rs": Rs}


def write_views(out_dir: str, n: int, width: int, height: int,
                seed: int) -> None:
    """`img0000.jpg` ... `img{n-1}.jpg` at width x height, quality 92, each
    cut from a texture sheet of the room's (`room.texture_sheet`) drawn in
    turn from `seed`."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    size = max(width, height)
    for i in range(n):
        sheet = room.texture_sheet(size, rng)
        sheet.crop((0, 0, width, height)).save(
            os.path.join(out_dir, f"img{i:04d}.jpg"), quality=92)

"""`bundle.out` v0.3 reader/writer, bit-compatible with the reference —
a copy of `bundler_sfm_tpu/io/bundlefile.py` (host numpy only).

Writer semantics from `src/BundleIO.cpp:730-875`; reader from
`src/BundleIO.cpp:417-607`; format documented in the reference README
("Output format").  Layout:

    # Bundle file v0.3
    <num_images> <num_points>
    --- per image (all images, registered or not):
    f k1 k2
    R (3 rows of 3)
    t (1 row of 3)            # t = -R·c  (src/BundleIO.cpp:799-802)
    --- per point:
    x y z
    r g b                     # ints
    num_views  [img key x y]*  # x,y in centered coords (%0.4f)

Unregistered cameras are written as zeros (`src/BundleIO.cpp:779-781`).
Internally our cameras store the camera CENTER c (explicit-camera-centers
convention, `lib/sfm-driver/sfm.c:325-331`); conversion happens here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class BundleCamera:
    f: float
    k1: float
    k2: float
    R: np.ndarray  # [3,3] world->camera rotation
    t: np.ndarray  # [3]   file-convention translation (= -R·c)

    @property
    def registered(self) -> bool:
        return self.f != 0.0

    @property
    def center(self) -> np.ndarray:
        """Camera center c = -Rᵀ·t (src/Camera.h:66-75)."""
        return -self.R.T @ self.t


@dataclasses.dataclass
class BundlePoint:
    pos: np.ndarray    # [3]
    color: np.ndarray  # [3] uint8-ish ints
    views: np.ndarray  # int/float [v, 4]: (img, key, x, y)


@dataclasses.dataclass
class BundleFile:
    cameras: List[BundleCamera]
    points: List[BundlePoint]

    @property
    def num_registered(self) -> int:
        return sum(1 for c in self.cameras if c.registered)


def fix_reflection_bug(bundle: BundleFile) -> BundleFile:
    """Reflect a pre-v0.3 scene into the v0.3 frame (`FixReflectionBug`,
    `src/BaseGeometry.cpp:484-500`; `CameraInfo::Reflect`,
    `src/Camera.cpp:227-237`): R' = D·R·D with D = diag(1,1,-1) written
    element-wise (negate R02,R12,R20,R21 and t2), point z negated."""
    D = np.diag([1.0, 1.0, -1.0])
    cams = []
    for c in bundle.cameras:
        if not c.registered:
            cams.append(c)
            continue
        cams.append(BundleCamera(f=c.f, k1=c.k1, k2=c.k2,
                                 R=D @ c.R @ D, t=D @ c.t))
    pts = [BundlePoint(pos=p.pos * np.array([1.0, 1.0, -1.0]),
                       color=p.color, views=p.views)
           for p in bundle.points]
    return BundleFile(cameras=cams, points=pts)


def read_bundle_file(path: str) -> BundleFile:
    """Read any bundle version the reference reads
    (`ReadBundleFile`, `src/BundleIO.cpp:417-607`): v0.1 (no header, focal
    only, views without coords), v0.2 (focal+k, views without coords),
    v0.3 (the standard format above), v0.4 (extra per-camera name/size
    line).  Pre-v0.3 scenes are reflected into the v0.3 frame
    (`FixReflectionBug` applied at `src/BundleIO.cpp:630-631`,
    `src/BundlerApp.cpp:846-848`)."""
    with open(path) as f:
        header = f.readline()
        if header.startswith("#") or header.startswith("v"):
            version = float(header.strip().split("v")[-1])
            tokens = f.read().split()
        else:
            version = 0.1  # headerless (src/BundleIO.cpp:446-448)
            tokens = (header + f.read()).split()
    pos = 0

    def take(n):
        nonlocal pos
        out = tokens[pos:pos + n]
        pos += n
        return out

    num_images, num_points = int(take(1)[0]), int(take(1)[0])
    cameras = []
    for _ in range(num_images):
        if version >= 0.4:
            take(3)  # name, width, height (src/BundleIO.cpp:466-470)
        if version > 0.1:
            f_k = np.array(take(3), dtype=np.float64)
        else:
            f_k = np.array([float(take(1)[0]), 0.0, 0.0])
        vals = np.array(take(12), dtype=np.float64)
        cameras.append(
            BundleCamera(
                f=float(f_k[0]), k1=float(f_k[1]), k2=float(f_k[2]),
                R=vals[0:9].reshape(3, 3), t=vals[9:12],
            )
        )
    view_w = 4 if version >= 0.3 else 2
    points = []
    for _ in range(num_points):
        xyz = np.array(take(3), dtype=np.float64)
        rgb = np.array(take(3), dtype=np.float64)
        nviews = int(take(1)[0])
        raw = np.array(take(view_w * nviews),
                       dtype=np.float64).reshape(nviews, view_w)
        views = raw if view_w == 4 else np.concatenate(
            [raw, np.zeros((nviews, 2))], axis=1)
        points.append(BundlePoint(pos=xyz, color=rgb, views=views))
    out = BundleFile(cameras=cameras, points=points)
    if version < 0.3:
        out = fix_reflection_bug(out)
    return out


def write_bundle_file(path: str, bundle: BundleFile) -> None:
    with open(path, "w") as f:
        num_visible = sum(1 for p in bundle.points if len(p.views) > 0)
        f.write("# Bundle file v0.3\n")
        f.write(f"{len(bundle.cameras)} {num_visible}\n")
        for cam in bundle.cameras:
            if not cam.registered:
                f.write("0 0 0\n0 0 0\n0 0 0\n0 0 0\n0 0 0\n")
                continue
            f.write(f"{cam.f:0.10e} {cam.k1:0.10e} {cam.k2:0.10e}\n")
            for r in range(3):
                f.write(
                    f"{cam.R[r, 0]:0.10e} {cam.R[r, 1]:0.10e} {cam.R[r, 2]:0.10e}\n"
                )
            f.write(f"{cam.t[0]:0.10e} {cam.t[1]:0.10e} {cam.t[2]:0.10e}\n")
        for p in bundle.points:
            if len(p.views) == 0:
                continue
            f.write(f"{p.pos[0]:0.10e} {p.pos[1]:0.10e} {p.pos[2]:0.10e}\n")
            f.write(f"{int(round(p.color[0]))} {int(round(p.color[1]))} "
                    f"{int(round(p.color[2]))}\n")
            f.write(str(len(p.views)))
            for v in p.views:
                f.write(f" {int(v[0])} {int(v[1])} {v[2]:0.4f} {v[3]:0.4f}")
            f.write("\n")


def camera_from_center(f: float, k1: float, k2: float,
                       R: np.ndarray, center: np.ndarray) -> BundleCamera:
    """Build a file-convention camera from internal (R, camera-center) state."""
    return BundleCamera(f=f, k1=k1, k2=k2, R=np.asarray(R),
                        t=-np.asarray(R) @ np.asarray(center))

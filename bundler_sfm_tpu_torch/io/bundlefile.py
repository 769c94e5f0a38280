"""`bundle.out` v0.3 reader/writer, bit-compatible with the reference —
a copy of `bundler_sfm_tpu/io/bundlefile.py`, whose writer formats flat
arrays (`BundleArrays`) in one native call (`io/bundle_text.py`).

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

from bundler_sfm_tpu_torch.io import bundle_text


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


@dataclasses.dataclass
class BundleArrays:
    """A bundle with its points as flat arrays, the form its text is
    formatted from.  Point p's views are views[o : o + counts[p]] (and the
    same rows of xy), o the sum of the counts before p; a point without
    views is not written."""
    cameras: List[BundleCamera]
    pos: np.ndarray     # [P,3]
    color: np.ndarray   # [P,3]
    counts: np.ndarray  # [P] int, views per point
    views: np.ndarray   # [V,2] int (img, key)
    xy: np.ndarray      # [V,2] centered key coordinates


def bundle_arrays(bundle: BundleFile) -> BundleArrays:
    """The points of a `BundleFile` as flat arrays (image and key truncated
    to integers, as the writer always wrote them)."""
    views = [np.asarray(p.views, dtype=np.float64).reshape(-1, 4)
             for p in bundle.points]
    flat = np.concatenate(views) if views else np.zeros((0, 4))
    return BundleArrays(
        cameras=bundle.cameras,
        pos=np.array([p.pos for p in bundle.points],
                     dtype=np.float64).reshape(-1, 3),
        color=np.array([p.color for p in bundle.points],
                       dtype=np.float64).reshape(-1, 3),
        counts=np.array([len(v) for v in views], dtype=np.int64),
        views=flat[:, :2].astype(np.int64), xy=flat[:, 2:])


def _camera_rows(cameras: List[BundleCamera]) -> np.ndarray:
    """[C, 15]: f, k1, k2, R row-major, t; zeros for unregistered cameras."""
    rows = np.zeros((len(cameras), 15))
    for row, c in zip(rows, cameras):
        if c.registered:
            row[0:3] = c.f, c.k1, c.k2
            row[3:12] = np.ravel(c.R)
            row[12:15] = np.ravel(c.t)
    return rows


def write_bundle_file(path: str, bundle) -> None:
    """`bundle` (a `BundleFile` or `BundleArrays`) as `bundle.out` v0.3,
    formatted in one native call (`io/bundle_text.py`)."""
    b = bundle if isinstance(bundle, BundleArrays) else bundle_arrays(bundle)
    with open(path, "w") as f:
        bundle_text.write_bundle(f, _camera_rows(b.cameras), b.pos, b.color,
                                 b.counts, b.views, b.xy)


def camera_from_center(f: float, k1: float, k2: float,
                       R: np.ndarray, center: np.ndarray) -> BundleCamera:
    """Build a file-convention camera from internal (R, camera-center) state."""
    return BundleCamera(f=f, k1=k1, k2=k2, R=np.asarray(R),
                        t=-np.asarray(R) @ np.asarray(center))

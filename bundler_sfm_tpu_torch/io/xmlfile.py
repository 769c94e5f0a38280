"""XML scene exporters — a copy of `bundler_sfm_tpu/io/xmlfile.py` (host
text): `WriteCamerasXML` / `WritePointsXML`
(`src/BundleIO.cpp:882-975`), with the per-record bodies of
`ImageData::WriteCameraXML` (`src/ImageData.cpp:2028-2103`),
`CameraInfo::WriteXML` (`src/Camera.cpp:959-976`) and
`PointData::WriteXML` (`src/Geometry.cpp:57-87`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from bundler_sfm_tpu_torch.io.bundlefile import BundleFile

URL_BASE = "http://grail.cs.cornell.edu/projects/phototour/trevi/images"


def _plane_ray_isect(plane: np.ndarray, eye: np.ndarray, ray: np.ndarray
                     ) -> Tuple[float, np.ndarray]:
    """t >= 0 intersection of eye + t*ray with plane (n, d)."""
    denom = plane[:3] @ ray
    if abs(denom) < 1e-12:
        return -1.0, np.zeros(3)
    t = -(plane[:3] @ eye + plane[3]) / denom
    return t, eye + t * ray


def write_cameras_xml(path: str, bundle: BundleFile,
                      image_names: Sequence[str],
                      dims: Sequence[Tuple[int, int]],
                      fit_plane: Optional[np.ndarray] = None) -> None:
    """`WriteCamerasXML` (`src/BundleIO.cpp:882-908`): registered cameras
    only; each with size, name (extension rewritten to .jpg), intrinsics,
    R/t, and — when a scene plane is given — the projection-plane corner
    intersections (`ImageData::WriteCameraXML`, `src/ImageData.cpp:2060-2099`
    projecting the four image-corner rays)."""
    with open(path, "w") as f:
        f.write('<?xml version="1.0" encoding="iso-8859-1"?>\n\n')
        f.write(f"<url_base> {URL_BASE} </url_base>\n")
        f.write("<cameras>\n")
        for i, cam in enumerate(bundle.cameras):
            if not cam.registered:
                continue
            w, h = dims[i] if i < len(dims) else (0, 0)
            name = image_names[i] if i < len(image_names) else f"{i:08d}.jpg"
            if len(name) >= 3:
                name = name[:-3] + "jpg"
            f.write("  <camera>\n")
            f.write(f"    <w> {w} </w>\n    <h> {h} </h>\n")
            f.write("    <adj> 1 </adj>\n")
            f.write(f"    <name> {name} </name>\n")
            f.write(f"    <focal> {cam.f:0.8e} </focal>\n")
            R = cam.R.reshape(-1)
            f.write("    <rot> " + " ".join(f"{v:0.8e}" for v in R)
                    + " </rot>\n")
            f.write("    <t> " + " ".join(f"{v:0.8e}" for v in cam.t)
                    + " </t>\n")
            if fit_plane is not None and w and h:
                eye = cam.center
                corners = [(-0.5 * w, -0.5 * h), (0.5 * w, -0.5 * h),
                           (-0.5 * w, 0.5 * h), (0.5 * w, 0.5 * h)]
                isects, ok = [], True
                for (cx, cy) in corners:
                    ray = cam.R.T @ np.array([cx, cy, -cam.f])
                    t, p = _plane_ray_isect(np.asarray(fit_plane), eye, ray)
                    ok &= t >= 0.0
                    isects.append(p)
                for k, p in enumerate(isects, 1):
                    if ok:
                        f.write(f"    <p{k}> " +
                                " ".join(f"{v:0.6e}" for v in p) +
                                f" </p{k}>\n")
                    else:
                        f.write(f"    <p{k}> 0.0 0.0 0.0 </p{k}>\n")
            f.write("  </camera>\n")
        f.write("</cameras>\n")


def write_points_xml(path: str, bundle: BundleFile,
                     min_views: int = 3) -> None:
    """`WritePointsXML` (`src/BundleIO.cpp:911-945`): points seen by >=
    min_views cameras; pos/color/per-view camera indices
    (`PointData::WriteXML`, `src/Geometry.cpp:57-87`)."""
    with open(path, "w") as f:
        f.write('<?xml version="1.0" encoding="iso-8859-1"?>\n\n')
        f.write("<points>\n")
        n = 0
        for p in bundle.points:
            if len(p.views) < min_views:
                continue
            n += 1
            f.write("    <point>\n      <pos>\n")
            for ax, v in zip("xyz", p.pos):
                f.write(f"        <{ax}> {v:0.8e} </{ax}>\n")
            f.write("      </pos>\n      <col>\n")
            for ch, v in zip("rgb", p.color):
                f.write(f"        <{ch}> {int(round(v))} </{ch}>\n")
            f.write("      </col>\n      <views>\n")
            for v in p.views:
                f.write("        <view>\n"
                        f"          <cam> {int(v[0])} </cam>\n"
                        "        </view>\n")
            f.write("      </views>\n    </point>\n")
        f.write("</points>\n")
    print(f"[WritePointsXML] {n} / {len(bundle.points)} points seen by "
          f">= {min_views} views")

"""Fisheye camera model — port of `bundler_sfm_tpu/models/fisheye.py`:
equidistant-style radial mapping with the reference's parameterization
(`src/ImageData.h` fisheye members; distortion math
`ImageData::UndistortPoint`/`DistortPoint`; optimized when
`m_optimize_for_fisheye`, `lib/sfm-driver/sfm.h:44` `fisheye` flag).

Projection: the Snavely pinhole ray is bent by the fisheye angle map before
scaling by the focal length — `ops/fisheye.py` holds the point-level
distort/undistort maps; this class packages them as a camera model.
"""

from __future__ import annotations

from bundler_sfm_tpu_torch.ops.fisheye import distort_points
from bundler_sfm_tpu_torch.ops.projection import project_one
from bundler_sfm_tpu_torch.ops.rotations import rot_update


class FisheyeModel:
    """params [..., 9] like SnavelyModel; aux = (R0, FisheyeParams).

    project() produces the DISTORTED (as-captured) pixel position: the
    pinhole prediction mapped through the fisheye forward model — the
    direction the reference uses when scoring fisheye observations
    (`sfm_project_rd` with fisheye, `lib/sfm-driver/sfm.c:183-280`).
    """
    name = "fisheye"
    num_params = 9

    @staticmethod
    def project(params, aux, X):
        R0, fp = aux
        u = project_one(params, R0, X, apply_distortion=False)
        return distort_points(u, fp)

    @staticmethod
    def rotation(params, aux):
        return rot_update(aux[0], params[..., 3:6])

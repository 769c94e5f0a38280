"""Camera-model families — port of `bundler_sfm_tpu/models/`.

The reference carries one projection model in several parameterizations
(`include/snavely_reprojection_error.h`: angle-axis `:53-96`, quaternion
`:103-151`; `lib/sfm-driver/sfm.h:32-51` camera_params_t with known-K and
fisheye flags; `src/ImageData.h` fisheye distortion).  This package is the
typed registry of those families: every model exposes `num_params`, a
differentiable `project(params, aux, X) -> [..., 2]` (centered pixels) on
the tensors' device, and pack/unpack helpers; `camera.py` holds the
host-side finalized-camera utilities.
"""

from bundler_sfm_tpu_torch.models.snavely import (  # noqa: F401
    SnavelyModel, SnavelyQuaternionModel, KnownIntrinsicsModel,
)
from bundler_sfm_tpu_torch.models.fisheye import FisheyeModel  # noqa: F401

CAMERA_MODELS = {
    "snavely": SnavelyModel,
    "snavely_quaternion": SnavelyQuaternionModel,
    "known_intrinsics": KnownIntrinsicsModel,
    "fisheye": FisheyeModel,
}


def get_camera_model(name: str):
    try:
        return CAMERA_MODELS[name]
    except KeyError:
        raise ValueError(f"unknown camera model {name!r}; "
                         f"choices: {sorted(CAMERA_MODELS)}")

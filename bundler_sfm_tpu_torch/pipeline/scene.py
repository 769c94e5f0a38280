"""Scene state — the role of `BaseApp`'s god object (`src/BaseApp.h:338-618`),
flattened into arrays + dicts the pipeline stages share."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from bundler_sfm_tpu_torch.config import BundlerConfig
from bundler_sfm_tpu_torch.io.listfile import ImageEntry


@dataclasses.dataclass
class TransformInfo:
    """Pairwise geometry record (`TransformInfo`, `src/BaseApp.h:65-83`)."""
    fmatrix: Optional[np.ndarray] = None   # [3,3]
    hmatrix: Optional[np.ndarray] = None   # [3,3]
    num_inliers: int = 0
    inlier_ratio: float = 0.0


@dataclasses.dataclass
class CameraPose:
    """Finalized per-image camera (role of `CameraInfo`, `src/Camera.h:31`)."""
    adjusted: bool = False
    R: Optional[np.ndarray] = None       # [3,3] world->cam
    center: Optional[np.ndarray] = None  # [3]
    f: float = 0.0
    k: Tuple[float, float] = (0.0, 0.0)


@dataclasses.dataclass
class Scene:
    config: BundlerConfig
    entries: List[ImageEntry]
    dims: List[Tuple[int, int]]                  # (width, height) per image
    key_xy: List[np.ndarray]                     # centered coords [n_i, 2]
    key_color: Optional[List[np.ndarray]] = None  # uint8 [n_i, 3] or None
    matches: Dict[Tuple[int, int], np.ndarray] = dataclasses.field(
        default_factory=dict)
    transforms: Dict[Tuple[int, int], TransformInfo] = dataclasses.field(
        default_factory=dict)
    tracks: List[List[Tuple[int, int]]] = dataclasses.field(
        default_factory=list)
    visible_points: List[List[int]] = dataclasses.field(default_factory=list)
    visible_keys: List[List[int]] = dataclasses.field(default_factory=list)
    key_track: List[Dict[int, int]] = dataclasses.field(default_factory=list)
    ignore_in_bundle: Optional[np.ndarray] = None  # [N] bool
    cameras: List[CameraPose] = dataclasses.field(default_factory=list)
    # Device of the stages that run on tensors (verification).
    device: str = "cuda"

    @property
    def num_images(self) -> int:
        return len(self.entries)

    def num_keys(self, i: int) -> int:
        return len(self.key_xy[i])

    def init_focal(self, i: int) -> float:
        return self.entries[i].init_focal

    def has_init_focal(self, i: int) -> bool:
        return self.entries[i].has_init_focal

    def color_of_key(self, img: int, key: int) -> np.ndarray:
        if self.key_color is not None and self.key_color[img] is not None \
                and key < len(self.key_color[img]):
            return self.key_color[img][key].astype(np.float64)
        return np.array([128.0, 128.0, 128.0])

    def __post_init__(self):
        n = self.num_images
        if self.ignore_in_bundle is None:
            self.ignore_in_bundle = np.zeros(n, dtype=bool)
        if not self.cameras:
            self.cameras = [CameraPose() for _ in range(n)]

"""Typed configuration covering the reference's tuning surface.

Every knob corresponds to a BundlerApp option; defaults mirror the reference
constructor (`src/BundlerApp.h:32-157`) and the RunBundler.sh options file
(`RunBundler.sh:119-137`).  The RANSAC budgets / thresholds here are the parity
surface called out in SURVEY.md §5 ("Config / flag system").
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class BundlerConfig:
    # ---- camera / focal handling (src/BundlerApp.h:36-37, 55-57, 72-75) ----
    fixed_focal_length: bool = True
    init_focal_length: float = 532.0
    use_focal_estimate: bool = False
    trust_focal_estimate: bool = False
    estimate_distortion: bool = False
    constrain_focal: bool = False
    constrain_focal_weight: float = 100.0
    distortion_weight: float = 1.0e2
    only_bundle_init_focal: bool = False
    factor_essential: bool = True

    # ---- pairwise geometry (src/BundlerApp.h:61-67) ----
    homography_threshold: float = 6.0
    homography_rounds: int = 256
    fmatrix_threshold: float = 9.0
    fmatrix_rounds: int = 2048
    skip_fmatrix: bool = False
    skip_homographies: bool = False
    # 5-point budget: 512 rounds at 0.25*fmatrix_threshold
    # (src/RelativePose.cpp:221-222)
    fivepoint_rounds: int = 512
    # DLT resection: 4096 rounds (src/Bundle.cpp:2903)
    projection_rounds: int = 4096
    projection_estimation_threshold: float = 4.0
    min_proj_error_threshold: float = 8.0
    max_proj_error_threshold: float = 16.0

    # ---- matching (src/keys2a.h:101-102, src/KeyMatchFull.cpp:131) ----
    match_ratio: float = 0.6
    min_num_feat_matches: int = 16
    match_window_radius: int = -1  # -1 = all pairs (RunBundler.sh:15)

    # ---- track / registration thresholds (src/BundlerApp.h:78-83) ----
    min_track_views: int = 2
    max_track_views: int = 100000
    min_max_matches: int = 16
    num_matches_add_camera: int = -1
    ray_angle_threshold: float = 2.0  # degrees

    # ---- incremental loop ----
    initial_pair: Tuple[int, int] = (-1, -1)
    fast_bundle: bool = True
    skip_full_bundle: bool = False
    skip_add_points: bool = False
    panorama_mode: bool = False
    estimate_ignored: bool = False
    fix_necker: bool = False
    use_angular_score: bool = False
    # Slow-bundle next-image selection by frontier connectivity
    # (FindCameraWithMostConnectivity, src/Bundle.cpp:1209,2318-2322).
    construct_max_connectivity: bool = False

    # ---- constraints (src/BundlerApp.h:45-53) ----
    use_constraints: bool = False
    use_point_constraints: bool = False
    point_constraint_weight: float = 0.0
    point_constraint_file: Optional[str] = None

    # ---- keypoint filtering (src/BundlerApp.h:85-86) ----
    keypoint_border_width: int = 0
    keypoint_border_bottom: int = 0

    # ---- optimizer (lib/sfm-driver/sfm.c:705-714, 814) ----
    # use_ceres selects the Ceres-equivalent robust backend: Huber(25) loss,
    # num_vis-scaled priors, iterative Schur/CG for >200 cameras
    # (src/BundleCeres.cpp:99-445, --use_ceres src/BundlerApp.cpp).
    use_ceres: bool = False
    ceres_huber_param: float = 25.0     # HUBER_PARAM src/BundleCeres.cpp:125
    ceres_dense_max_cameras: int = 200  # SPARSE_SCHUR cutover :132-134
    sfm_max_iters: int = 150
    sfm_mu0_tau: float = 1.0e-3
    sfm_eps1: float = 1.0e-10
    sfm_eps2: float = 1.0e-12
    # RunSFM outlier loop (src/Bundle.cpp:586, 762-771, 913)
    sfm_min_points: int = 20
    sfm_min_outliers: int = 40  # re-bundle while > this many outliers removed
    outlier_percentile: float = 0.8
    outlier_num_stddev: float = 2.0  # threshold = 1.2 * 2.0 * p80, clamped

    # ---- directories / files (src/BundlerApp.h:89-97) ----
    image_directory: str = "."
    key_directory: str = "."
    match_directory: str = "."
    output_directory: str = "."
    bundle_output_file: Optional[str] = "bundle.out"
    bundle_output_base: Optional[str] = "bundle_"
    intrinsics_file: Optional[str] = None
    ignore_file: Optional[str] = None
    use_intrinsics: bool = False
    output_all: bool = True

    # ---- misc / tools ----
    fisheye: bool = False
    optimize_for_fisheye: bool = False
    scale_focal: float = 1.0
    zero_distortion_params: bool = False
    ann_max_pts_visit: int = 400  # kept for CLI parity; the matcher is exact

    # ---- execution knobs (no reference analogue) ----
    # In-process SIFT detector (replaces the external `sift` binary the
    # reference shells out to).  contrast_thr 0.02 (vs Lowe's 0.04)
    # compensates for the single-step sub-pixel refinement: on kermit/ET it
    # brings key counts and reconstruction density to (or past) what the
    # reference gets from Lowe's binary.
    sift_max_keys: int = 4096
    sift_contrast_thr: float = 0.02
    sift_edge_thr: float = 10.0
    match_block_keys: int = 1024   # keys per matcher block
    ba_dtype: str = "float64"      # bundle-adjustment / verification precision
    ransac_dtype: str = "float32"  # hypothesis scoring precision
    max_point_views: int = 32      # padded per-point view count in BA
    # Ranks of the default process group that share each bundle
    # adjustment (points sharded, cameras replicated; parallel/ba_sharded);
    # 0 = every rank of the group.
    num_devices: int = 1

    def validate(self) -> "BundlerConfig":
        assert self.match_ratio > 0.0 and self.match_ratio < 1.0
        assert self.min_proj_error_threshold <= self.max_proj_error_threshold
        assert self.sfm_max_iters > 0
        return self


# The options written by RunBundler.sh:119-137 into options.txt.
RUNBUNDLER_DEFAULTS = dict(
    fixed_focal_length=False,   # "--variable_focal_length"
    use_focal_estimate=True,
    constrain_focal=True,
    constrain_focal_weight=0.0001,
    estimate_distortion=True,
    ray_angle_threshold=2.0,
)


def default_pipeline_config(**overrides) -> BundlerConfig:
    """Config matching a stock `RunBundler.sh` run."""
    cfg = dataclasses.replace(BundlerConfig(), **{**RUNBUNDLER_DEFAULTS, **overrides})
    return cfg.validate()

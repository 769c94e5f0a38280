"""`bundler` executable equivalent — port of `bundler_sfm_tpu/bundler.py`:
option parsing and top-level control flow, every stage on `--device`.

Mirrors `BundlerApp::ProcessOptions` (`src/BundlerApp.cpp:208-738`, ~70 long
options, recursive `--options_file`) and `OnInit` (`:747-1046`).  Usage:

    python -m bundler_sfm_tpu_torch.bundler list.txt --options_file options.txt
        [--device cuda|cpu]
    python -m bundler_sfm_tpu_torch.bundler list.txt --match_table \\
        matches.init.txt --run_bundle --output bundle.out --output_dir bundle \\
        --variable_focal_length --use_focal_estimate --constrain_focal \\
        --constrain_focal_weight 0.0001 --estimate_distortion

The option table is the JAX package's plus `--device` and the multihost
options of `run_bundler`.  --num_devices D > 1 (0: every visible card)
runs one process per device under the launch rules that `run_bundler`
shares (`parallel.mesh.run_entry`): `main` starts D ranks, or joins the
process group that exists (torchrun, --multihost_coordinator); every rank runs the same reconstruction with
point-sharded bundle adjustment, and only rank 0 writes files (bundle
surgery runs on rank 0 alone).  --compute_covariance (with --bundle)
writes covariance.txt in surgery mode, the Schur system inverted on
`--device`; --fisheye PARAM_FILE rectifies the keypoints of list entries
flagged fisheye once at load, on `--device`.  --optimize_for_fisheye is
carried into the config, where nothing reads it, as in the JAX package.
"""

from __future__ import annotations

import argparse
import functools
import os
import shlex
import sys
from typing import Callable, List, Optional

import numpy as np
import torch

from bundler_sfm_tpu_torch.config import BundlerConfig
from bundler_sfm_tpu_torch.export import process as ops
from bundler_sfm_tpu_torch.export.scene_geometry import estimate_axes
from bundler_sfm_tpu_torch.io.bundlefile import (
    read_bundle_file, write_bundle_file,
)
from bundler_sfm_tpu_torch.io.keyfile import keys_to_centered, read_key_file
from bundler_sfm_tpu_torch.io.listfile import (
    ImageEntry, read_list_file, write_list_file,
)
from bundler_sfm_tpu_torch.io.matchfile import (
    read_match_file, read_match_indexes, read_pair_match_files,
)
from bundler_sfm_tpu_torch.ops.fisheye import (
    read_fisheye_file, undistort_points,
)
from bundler_sfm_tpu_torch.pipeline.incremental import (
    bundle_adjust_fast, bundle_adjust_slow, run_sfm, to_bundle_arrays,
)
from bundler_sfm_tpu_torch.pipeline.resume import (
    continue_reconstruction, resume_from_bundle,
)
from bundler_sfm_tpu_torch.pipeline.scene import Scene
from bundler_sfm_tpu_torch.pipeline.tracks import (
    tracks_from_points, write_track_file,
)
from bundler_sfm_tpu_torch.pipeline.two_frame import (
    scene_covariance, write_covariance_file,
)
from bundler_sfm_tpu_torch.pipeline.verify import (
    compute_geometric_constraints,
)
from bundler_sfm_tpu_torch.parallel.mesh import run_entry
from bundler_sfm_tpu_torch.utils import counter, resolve_device, stage


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bundler", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("list_file")
    p.add_argument("--options_file", default=None)
    # Control flow
    p.add_argument("--run_bundle", action="store_true")
    p.add_argument("--rerun_bundle", action="store_true")
    p.add_argument("--slow_bundle", action="store_true")
    p.add_argument("--construct_max_connectivity", action="store_true",
                   help="slow-bundle next-image selection by frontier "
                        "connectivity (src/Bundle.cpp:1209,2318)")
    p.add_argument("--match_table", default=None)
    p.add_argument("--match_dir", default=".")
    p.add_argument("--key_dir", default=".")
    p.add_argument("--image_dir", default=".")
    p.add_argument("--output_dir", default=".")
    p.add_argument("--num_devices", type=int, default=1,
                   help="ranks (one process and one device each) for "
                        "point-sharded BA (0 = every visible card)")
    p.add_argument("--multihost_coordinator", default=None,
                   help="host:port of rank 0 — start ONE bundler per GPU, "
                        "on every host, with identical arguments plus "
                        "--process_id")
    p.add_argument("--num_processes", type=int, default=None,
                   help="with --multihost_coordinator: the number of GPUs "
                        "over all hosts (one process each)")
    p.add_argument("--process_id", type=int, default=None,
                   help="with --multihost_coordinator: this process's rank")
    p.add_argument("--output", default=None)
    p.add_argument("--output_all", default=None)
    p.add_argument("--bundle", default=None)
    # Focal / intrinsics
    p.add_argument("--variable_focal_length", action="store_true")
    p.add_argument("--fixed_focal_length", action="store_true")
    p.add_argument("--init_focal_length", type=float, default=532.0)
    p.add_argument("--use_focal_estimate", action="store_true")
    p.add_argument("--trust_focal_estimate", action="store_true")
    p.add_argument("--constrain_focal", action="store_true")
    p.add_argument("--constrain_focal_weight", type=float, default=100.0)
    p.add_argument("--only_bundle_init_focal", action="store_true")
    p.add_argument("--estimate_distortion", action="store_true")
    p.add_argument("--intrinsics", default=None)
    # Geometry thresholds
    p.add_argument("--homography_threshold", type=float, default=6.0)
    p.add_argument("--homography_rounds", type=int, default=256)
    p.add_argument("--fmatrix_threshold", type=float, default=9.0)
    p.add_argument("--fmatrix_rounds", type=int, default=2048)
    p.add_argument("--skip_fmatrix", action="store_true")
    p.add_argument("--skip_homographies", action="store_true")
    p.add_argument("--projection_estimation_threshold", type=float, default=4.0)
    p.add_argument("--min_proj_error_threshold", type=float, default=8.0)
    p.add_argument("--max_proj_error_threshold", type=float, default=16.0)
    p.add_argument("--ray_angle_threshold", type=float, default=2.0)
    # Matching / tracks
    p.add_argument("--min_num_feat_matches", type=int, default=16)
    p.add_argument("--min_max_matches", type=int, default=16)
    p.add_argument("--num_matches_add_camera", type=int, default=-1)
    p.add_argument("--min_track_views", type=int, default=2)
    p.add_argument("--max_track_views", type=int, default=100000)
    p.add_argument("--keypoint_border_width", type=int, default=0)
    p.add_argument("--keypoint_border_bottom", type=int, default=0)
    p.add_argument("--ann_max_pts_visit", type=int, default=400)
    # Loop behavior
    p.add_argument("--init_pair1", type=int, default=-1)
    p.add_argument("--init_pair2", type=int, default=-1)
    p.add_argument("--panorama_mode", action="store_true")
    p.add_argument("--estimate_ignored", action="store_true")
    p.add_argument("--skip_full_bundle", action="store_true")
    p.add_argument("--skip_add_points", action="store_true")
    p.add_argument("--ignore_file", default=None)
    p.add_argument("--add_images", default=None,
                   help="file of image names to register against --bundle "
                        "(src/BundlerApp.cpp:996-1021)")
    p.add_argument("--use_ceres", action="store_true",
                   help="Ceres-equivalent robust backend: Huber(25) loss, "
                        "num_vis-scaled priors, iterative Schur/CG for "
                        ">200 cameras (src/BundleCeres.cpp)")
    # Bundle-surgery ops (ProcessBundle.cpp) — applied to a loaded --bundle.
    p.add_argument("--scale_focal", type=float, default=1.0)
    p.add_argument("--zero_distortion_params", action="store_true")
    p.add_argument("--prune_bad_points", action="store_true")
    p.add_argument("--compress_list", action="store_true")
    p.add_argument("--reposition_scene", action="store_true")
    p.add_argument("--estimate_up_vector_szeliski", action="store_true")
    p.add_argument("--output_relposes", default=None)
    p.add_argument("--seed", type=int, default=0)

    p.add_argument("--no_factor_essential", action="store_true",
                   help="disable 5-point initialization "
                        "(src/BundlerApp.cpp:~500 factor_essential=false)")
    p.add_argument("--fix_necker", action="store_true")
    p.add_argument("--distortion_weight", type=float, default=1.0e2)
    p.add_argument("--use_constraints", action="store_true")
    p.add_argument("--point_constraint_file", default=None)
    p.add_argument("--point_constraint_weight", type=float, default=0.0)
    p.add_argument("--use_angular_score", action="store_true")
    p.add_argument("--fisheye", default=None, metavar="PARAM_FILE",
                   help="fisheye parameter file (FisheyeCenter/Radius/"
                        "Angle/Focal lines, src/BundlerApp.cpp:60-110)")
    p.add_argument("--optimize_for_fisheye", action="store_true")
    p.add_argument("--match_index_dir", default=None,
                   help="directory of per-pair match index files "
                        "(LoadMatchIndexes, src/BundleIO.cpp:168)")
    p.add_argument("--sift_binary", default=None,
                   help="external SIFT binary run for missing .key files "
                        "(images without keys are skipped when absent)")
    # Bundle-surgery ops on --bundle (src/BundlerApp.cpp:876-1026).
    p.add_argument("--rotate_cameras", default=None, metavar="FILE",
                   help="per-image `name degrees` in-plane rolls "
                        "(RotateCameras, src/ProcessBundle.cpp:30)")
    p.add_argument("--scale_focal_file", default=None, metavar="FILE",
                   help="per-image `name scale` focal scaling "
                        "(src/ProcessBundle.cpp:144)")
    p.add_argument("--write_tracks", default=None, metavar="FILE",
                   help="rebuild tracks from points and write them "
                        "(CreateTracksFromPoints + WriteTracks)")
    p.add_argument("--compute_covariance", action="store_true",
                   help="write covariance.txt with per-camera position "
                        "covariance (ComputeCameraCovariance)")
    p.add_argument("--up_image", type=int, default=-1,
                   help="reference image whose y-axis defines 'up' for "
                        "scene repositioning (src/BaseGeometry.cpp:569)")
    # Options the reference parses but whose code paths are compiled out or
    # dead upstream — accepted for drop-in CLI compatibility.
    for flag in ("analyze_matches", "assemble", "enrich_points",
                 "detect_duplicates", "classify_photos", "compare_histograms",
                 "compute_color_statistics", "day_photos", "night_photos",
                 "cloudy_photos", "bundle_from_points", "bundle_from_tracks",
                 "projective_cameras", "projective_points", "use_fit_plane"):
        p.add_argument(f"--{flag}", action="store_true",
                       help="accepted for reference CLI parity "
                            "(inert in the reference; see SURVEY.md §2.1)")
    for flag, typ, dflt in (("min_camera_distance_ratio", float, 0.0),
                            ("baseline_threshold", float, -1.0),
                            ("covariance_fix1", int, -1),
                            ("covariance_fix2", int, -1),
                            ("min_feature_matches", int, 16),
                            ("image_rescale", float, 1.0),
                            ("morph_steps", int, 0),
                            ("stretch_factor", float, 1.0)):
        p.add_argument(f"--{flag}", type=typ, default=dflt,
                       help="accepted for reference CLI parity "
                            "(inert in the reference; see SURVEY.md §2.1)")
    p.add_argument("--device", default="cuda",
                   help="torch device of every stage (default cuda; a bare "
                        "'cuda' is each rank's own card)")
    return p


def parse_with_options_file(argv: List[str]) -> argparse.Namespace:
    """Recursive --options_file expansion (src/BundlerApp.cpp:678-731):
    each line of the file is `key value...`, becoming `--key value...`."""
    parser = build_parser()
    args = parser.parse_args(argv)
    seen = set()
    while args.options_file:
        path = args.options_file
        if path in seen:
            break
        seen.add(path)
        extra: List[str] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                toks = shlex.split(line)
                key = toks[0]
                if not key.startswith("--"):
                    key = "--" + key
                extra.append(key)
                extra.extend(toks[1:])
        args.options_file = None
        args = parser.parse_args(argv + extra, namespace=args)
        if args.options_file == path:
            args.options_file = None
    return args


def scene_from_args(args, device=None, num_devices: int = 1) -> Scene:
    """The Scene of a bundler run: config from the options (num_devices
    ranks), list.txt, key files (centered coordinates and colors), ignore
    list, known intrinsics and the match source, on `device` (default
    `args.device`)."""
    cfg = BundlerConfig(
        fixed_focal_length=not args.variable_focal_length,
        init_focal_length=args.init_focal_length,
        use_focal_estimate=args.use_focal_estimate,
        trust_focal_estimate=args.trust_focal_estimate,
        estimate_distortion=args.estimate_distortion,
        constrain_focal=args.constrain_focal,
        constrain_focal_weight=args.constrain_focal_weight,
        only_bundle_init_focal=args.only_bundle_init_focal,
        homography_threshold=args.homography_threshold,
        homography_rounds=args.homography_rounds,
        fmatrix_threshold=args.fmatrix_threshold,
        fmatrix_rounds=args.fmatrix_rounds,
        skip_fmatrix=args.skip_fmatrix,
        skip_homographies=args.skip_homographies,
        projection_estimation_threshold=args.projection_estimation_threshold,
        min_proj_error_threshold=args.min_proj_error_threshold,
        max_proj_error_threshold=args.max_proj_error_threshold,
        ray_angle_threshold=args.ray_angle_threshold,
        min_num_feat_matches=args.min_num_feat_matches,
        min_max_matches=args.min_max_matches,
        num_matches_add_camera=args.num_matches_add_camera,
        min_track_views=args.min_track_views,
        max_track_views=args.max_track_views,
        initial_pair=(args.init_pair1, args.init_pair2),
        panorama_mode=args.panorama_mode,
        use_ceres=args.use_ceres,
        factor_essential=not args.no_factor_essential,
        fix_necker=args.fix_necker,
        distortion_weight=args.distortion_weight,
        use_constraints=args.use_constraints,
        use_point_constraints=args.point_constraint_file is not None,
        point_constraint_file=args.point_constraint_file,
        point_constraint_weight=args.point_constraint_weight,
        use_angular_score=args.use_angular_score,
        fisheye=args.fisheye is not None,
        optimize_for_fisheye=args.optimize_for_fisheye,
        construct_max_connectivity=args.construct_max_connectivity,
        estimate_ignored=args.estimate_ignored,
        skip_full_bundle=args.skip_full_bundle,
        skip_add_points=args.skip_add_points,
        image_directory=args.image_dir,
        key_directory=args.key_dir,
        match_directory=args.match_dir,
        output_directory=args.output_dir,
        bundle_output_file=args.output or "bundle.out",
        bundle_output_base=args.output_all or "bundle_",
        output_all=args.output_all is not None,
        num_devices=num_devices,
    ).validate()

    entries = read_list_file(args.list_file, args.image_dir)
    if args.intrinsics:
        # Known intrinsics: assign nearest-focal record per image and pin
        # the focal (the reference's known_intrinsics camera path;
        # src/BundleIO.cpp:1297-1360).
        from bundler_sfm_tpu_torch.io.intrinsics import (
            assign_intrinsics, read_intrinsics_file,
        )
        recs = read_intrinsics_file(args.intrinsics)
        assigned = assign_intrinsics(recs, [e.init_focal for e in entries])
        for e, rec in zip(entries, assigned):
            if rec is not None:
                e.init_focal = rec.focal
        cfg.use_focal_estimate = True
        cfg.trust_focal_estimate = True
    dev = resolve_device(args.device if device is None else device)
    fisheye_params = read_fisheye_file(args.fisheye) if args.fisheye else None
    dims: List[tuple] = []
    key_xy: List[np.ndarray] = []
    key_color: List[Optional[np.ndarray]] = []
    for e in entries:
        with stage("key_colors"):
            w, h = _image_dims(e.name)
        dims.append((w, h))
        with stage("load_keys"):
            info = _read_keys(e, args)
            if info is not None:
                xy = keys_to_centered(info, w, h)[:, 0:2].astype(np.float64)
                if fisheye_params is not None and e.fisheye:
                    # Rectify fisheye keypoints once at load (UndistortPoint
                    # applied to match geometry,
                    # src/ImageData.cpp:1171-1192).
                    xy = undistort_points(torch.as_tensor(xy, device=dev),
                                          fisheye_params).cpu().numpy()
        if info is None:
            key_xy.append(np.zeros((0, 2)))
            key_color.append(None)
            continue
        counter("keys_loaded", len(info))
        key_xy.append(xy)
        with stage("key_colors"):
            key_color.append(_key_colors(e.name, info))

    scene = Scene(config=cfg, entries=entries, dims=dims, key_xy=key_xy,
                  key_color=key_color, device=str(dev))
    if args.ignore_file:
        with open(args.ignore_file) as f:
            for line in f:
                line = line.strip()
                if line:
                    scene.ignore_in_bundle[int(line)] = True
    # Match-source dispatch (LoadMatches, src/BundleIO.cpp:235-288):
    # match_table > match_index_dir > per-pair match-###-###.txt files.
    with stage("read_matches"):
        if args.match_table:
            scene.matches = read_match_file(args.match_table)
        elif args.match_index_dir:
            scene.matches = read_match_indexes(args.match_index_dir,
                                               len(entries))
        elif args.match_dir and args.match_dir != ".":
            pair_matches = read_pair_match_files(args.match_dir,
                                                 len(entries))
            if pair_matches:
                scene.matches = pair_matches
    counter("matches_loaded", sum(len(m) for m in scene.matches.values()))
    return scene


def _read_keys(entry, args) -> Optional[np.ndarray]:
    """The entry's keypoints (`read_key_file`'s info) from its key file
    (`ImageEntry.key_name`; .gz, .bin), or None where it has none and no
    --sift_binary makes one."""
    try:
        return read_key_file(entry.key_name(args.key_dir))[0]
    except FileNotFoundError:
        pass
    return _extract_keys_external(entry, args) if args.sift_binary else None


def _extract_keys_external(entry, args):
    """Shell out to an external SIFT binary for a missing .key file
    (`ImageData::ExtractFeatures` via m_sift_binary, `src/Bundle.cpp:3698`;
    `bin/ToSift.sh:30-35`: pgm on stdin, Lowe-format keys on stdout)."""
    import subprocess
    import tempfile
    try:
        from PIL import Image
        key_path = entry.key_name(args.key_dir)
        with tempfile.NamedTemporaryFile(suffix=".pgm") as pgm:
            with Image.open(entry.name) as img:
                img.convert("L").save(pgm.name)
            with open(pgm.name, "rb") as fin, open(key_path, "w") as fout:
                subprocess.run([args.sift_binary], stdin=fin, stdout=fout,
                               check=True, timeout=600)
        info, _ = read_key_file(key_path)
        return info
    except Exception as exc:   # missing binary/image: match the reference's
        print(f"[bundler] external SIFT failed for {entry.name}: {exc}")
        return None            # skip-image behavior rather than aborting


def _image_dims(path):
    try:
        from PIL import Image
        with Image.open(path) as img:
            return img.size
    except Exception:
        return (1024, 768)


def _key_colors(path, info):
    """Sample pixel colors at keypoint locations (`ReadKeyColors`,
    `src/ImageData.cpp`)."""
    try:
        from PIL import Image
        with Image.open(path) as img:
            arr = np.asarray(img.convert("RGB"))
        h, w = arr.shape[:2]
        xs = np.clip(info[:, 0].astype(int), 0, w - 1)
        ys = np.clip(info[:, 1].astype(int), 0, h - 1)
        return arr[ys, xs]
    except Exception:
        return None


def _bundle_surgery(args, scene) -> int:
    """Apply ProcessBundle ops to a loaded bundle (`src/ProcessBundle.cpp`)."""
    bundle = read_bundle_file(args.bundle)
    out_dir = args.output_dir
    os.makedirs(out_dir, exist_ok=True)
    if args.scale_focal != 1.0:
        bundle = ops.scale_focal_lengths(bundle, args.scale_focal)
        write_bundle_file(os.path.join(out_dir, "bundle.scale.out"), bundle)
    if args.zero_distortion_params:
        bundle = ops.zero_distortion_params(bundle)
    if args.prune_bad_points:
        bundle = ops.prune_bad_points(bundle)
        write_bundle_file(os.path.join(out_dir, "bundle.pruned.out"), bundle)
    if args.scale_focal_file:
        scales = ops.read_per_image_values(args.scale_focal_file,
                                           len(bundle.cameras))
        bundle = ops.scale_focal_lengths(bundle, scales)
        write_bundle_file(os.path.join(out_dir, "bundle.scale.out"), bundle)
    if args.rotate_cameras:
        degs = ops.read_per_image_values(args.rotate_cameras,
                                         len(bundle.cameras))
        bundle = ops.rotate_cameras_roll(bundle, degs)
    if args.reposition_scene:
        bundle = ops.reposition_scene(bundle)
    if args.estimate_up_vector_szeliski:
        # The axes are computed for their failure modes only (an --up_image
        # out of range raises), as in the JAX package.
        if args.up_image >= 0:
            estimate_axes(bundle, up_image=args.up_image)
        bundle = ops.transform_scene_canonical(bundle)
    if args.write_tracks:
        views = [[(int(v[0]), int(v[1])) for v in np.atleast_2d(p.views)]
                 for p in bundle.points]
        tracks, _, _, _ = tracks_from_points(views, len(bundle.cameras))
        write_track_file(args.write_tracks, len(bundle.cameras), tracks)
        print(f"[bundler] wrote {len(tracks)} tracks to {args.write_tracks}")
    if args.compute_covariance:
        regs, _, blocks = scene_covariance(
            bundle, estimate_distortion=args.estimate_distortion,
            device=args.device)
        write_covariance_file(os.path.join(out_dir, "covariance.txt"),
                              regs, blocks)
        print(f"[bundler] wrote covariance.txt ({len(regs)} cameras)")
    if args.compress_list:
        comp, names = ops.compress(bundle, [e.name for e in scene.entries])
        write_bundle_file(os.path.join(out_dir, "bundle.compressed.out"),
                          comp)
        write_list_file(os.path.join(out_dir, "list.compressed.txt"),
                        [ImageEntry(n) for n in names])
        print(f"[bundler] compressed to {len(comp.cameras)} cameras")
    out = os.path.join(out_dir, args.output or "bundle.processed.out")
    write_bundle_file(out, bundle)
    print(f"[bundler] wrote {out}")
    return 0


def _read_point_constraints(path: str, recon) -> dict:
    """`x0 y0 z0 x y z` lines anchoring the point nearest (x0, y0, z0) to
    (x, y, z) (ReadPointConstraints, src/BundleIO.cpp:1241-1290)."""
    pos = np.stack([p if p is not None else np.zeros(3)
                    for p in recon.points])
    pt_con = {}
    with open(path) as f:
        for line in f:
            v = [float(t) for t in line.split()]
            if len(v) != 6:
                continue
            d = ((pos - np.array(v[:3])) ** 2).sum(axis=1)
            pt_con[int(np.argmin(d))] = np.array(v[3:])
    return pt_con


def main(argv: Optional[List[str]] = None, sampler: Callable = None) -> int:
    """Run bundler.  `sampler` replaces every RANSAC draw (verification and
    reconstruction) for tests that replay another implementation's draw;
    the command line never sets it."""
    return run_entry(argv if argv is not None else sys.argv[1:],
                     parse_with_options_file,
                     functools.partial(_run, sampler=sampler))


def _run(args, mesh, sampler: Callable = None) -> int:
    """bundler on this rank: one device when `mesh` is None."""
    sharded = mesh is not None and mesh.size > 1
    writer = mesh is None or mesh.rank == 0
    scene = scene_from_args(
        args, device=None if mesh is None else str(mesh.device),
        num_devices=mesh.size if sharded else 1)
    print(f"[bundler] {scene.num_images} images, "
          f"{len(scene.matches)} matched pairs")
    # Pure bundle-surgery mode (ProcessBundle.cpp ops on a loaded bundle).
    surgery = (args.scale_focal != 1.0 or args.zero_distortion_params or
               args.prune_bad_points or args.compress_list or
               args.reposition_scene or args.estimate_up_vector_szeliski or
               args.output_relposes or args.scale_focal_file or
               args.rotate_cameras or args.write_tracks or
               args.compute_covariance)
    if args.bundle and surgery and not (args.run_bundle or
                                        args.rerun_bundle):
        return _bundle_surgery(args, scene) if writer else 0

    if not (args.run_bundle or args.rerun_bundle or args.bundle):
        print("[bundler] --run_bundle not given; nothing to do")
        return 0
    out_dir = args.output_dir if writer else None
    if writer:
        os.makedirs(args.output_dir, exist_ok=True)
    # constraints.txt checkpoint in the working directory, like the
    # reference (BundlerGeometry.cpp:105); .prune/.ransac/.corresp
    # match-table snapshots for < 40000 images (BundlerGeometry.cpp:112-188).
    # Every rank reads the checkpoint if it was there before any rank
    # started (the barrier: rank 0 writes it after verifying); rank 0 alone
    # writes.
    cache = "constraints.txt"
    if sharded:
        cached = os.path.exists(cache)
        mesh.barrier()
        if not writer and not cached:
            cache = None
    snap = "." if scene.num_images < 40000 and writer else None
    compute_geometric_constraints(scene, seed=args.seed,
                                  cache_path=cache,
                                  snapshot_dir=snap,
                                  scores_path="pairwise_scores.txt"
                                  if writer else None,
                                  sampler=sampler)
    print(f"[bundler] {len(scene.tracks)} tracks")

    if args.bundle:
        # Resume path: --bundle file [+ --rerun_bundle to reoptimize], then
        # continue adding any unregistered images.
        recon = resume_from_bundle(scene, read_bundle_file(args.bundle))
        if args.add_images:
            # Only the listed images may join (BundleImagesFromFile,
            # src/Bundle.cpp:3623).
            with open(args.add_images) as f:
                allowed = {line.split()[0] for line in f if line.strip()}
            for i, e in enumerate(scene.entries):
                if recon.slot_of_image(i) is None and \
                        os.path.basename(e.name) not in allowed and \
                        e.name not in allowed:
                    scene.ignore_in_bundle[i] = True
        if args.rerun_bundle:
            pt_con = None
            if args.point_constraint_file:
                pt_con = _read_point_constraints(args.point_constraint_file,
                                                 recon)
            run_sfm(recon, scene, pt_constraints=pt_con,
                    pt_weight=args.point_constraint_weight)
        recon = continue_reconstruction(scene, recon, out_dir=out_dir,
                                        seed=args.seed, sampler=sampler)
        if writer:
            out = os.path.join(args.output_dir, scene.config.
                               bundle_output_file or "bundle.out")
            write_bundle_file(out, to_bundle_arrays(recon, scene))
            print(f"[bundler] wrote {out}")
        return 0

    if args.slow_bundle:
        bundle_adjust_slow(scene, out_dir=out_dir, seed=args.seed,
                           sampler=sampler)
    else:
        bundle_adjust_fast(scene, out_dir=out_dir, seed=args.seed,
                           sampler=sampler)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""State carried across from the JAX package.

The system has no weights: its state is the configuration, the per-image
keypoint tables and the match dictionary, and during reconstruction the
cameras, points and their views.  These helpers build the port's objects
from plain Python / numpy state (for example `dataclasses.asdict(jax_config)`
and the JAX package's scene and reconstruction fields), so both packages can
be handed the same inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from bundler_sfm_tpu_torch.config import BundlerConfig
from bundler_sfm_tpu_torch.io.listfile import ImageEntry
from bundler_sfm_tpu_torch.ops.ba import BAProblem, build_problem
from bundler_sfm_tpu_torch.pipeline.incremental import Reconstruction
from bundler_sfm_tpu_torch.pipeline.scene import Scene
from bundler_sfm_tpu_torch.utils.device import resolve_device


def config_from_dict(d: Dict) -> BundlerConfig:
    """BundlerConfig from a field dict; raises on unknown fields."""
    known = {f.name for f in dataclasses.fields(BundlerConfig)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown config fields: {sorted(unknown)}")
    d = dict(d)
    if "initial_pair" in d:
        d["initial_pair"] = tuple(d["initial_pair"])
    return BundlerConfig(**d).validate()


def scene_from_numpy(entries: Sequence, dims: Sequence[Tuple[int, int]],
                     key_xy: Sequence[np.ndarray],
                     matches: Dict[Tuple[int, int], np.ndarray],
                     config, device="cuda") -> Scene:
    """A port Scene from numpy state.

    entries: objects with `name`, `fisheye`, `init_focal` (list.txt rows);
    dims: (width, height) per image; key_xy: centered [n_i, 2] keypoint
    coordinates; matches: {(i, j): int [m, 2]}; config: a BundlerConfig of
    either package or a field dict.  Arrays are copied, so later stages
    never write into the caller's state."""
    if not isinstance(config, dict):
        config = dataclasses.asdict(config)
    return Scene(
        config=config_from_dict(config),
        entries=[ImageEntry(e.name, bool(e.fisheye), float(e.init_focal))
                 for e in entries],
        dims=[(int(w), int(h)) for w, h in dims],
        key_xy=[np.array(k, dtype=np.float64) for k in key_xy],
        matches={(int(i), int(j)): np.array(m, dtype=np.int32)
                 for (i, j), m in matches.items()},
        device=str(resolve_device(device)),
    )


def reconstruction_from_numpy(added_order: Sequence[int],
                              cam_R: Sequence[np.ndarray],
                              cam_params: Sequence[np.ndarray],
                              points: Sequence[np.ndarray],
                              colors: Sequence[np.ndarray],
                              pt_views: Sequence[Sequence[Tuple[int, int]]],
                              track_extra: np.ndarray,
                              key_extra: Sequence[Dict[int, int]]
                              ) -> Reconstruction:
    """A port Reconstruction from the fields of either package's (for
    example `dataclasses.asdict(jax_recon)`), copied to f64 numpy."""
    def f64(xs) -> List[np.ndarray]:
        return [np.array(x, dtype=np.float64) for x in xs]
    return Reconstruction(
        added_order=[int(i) for i in added_order], cam_R=f64(cam_R),
        cam_params=f64(cam_params), points=f64(points), colors=f64(colors),
        pt_views=[[(int(s), int(k)) for s, k in v] for v in pt_views],
        track_extra=np.array(track_extra, dtype=np.int64),
        key_extra=[{int(k): int(v) for k, v in d.items()} for d in key_extra])


def ba_problem_from_numpy(R0, cam0, pts0, obs_cam, obs_pt, obs_xy,
                          device="cuda", **options) -> BAProblem:
    """A port BAProblem on `device` from the host arrays the JAX package's
    `ops.ba.build_problem` takes (flat observations in input order);
    `options` are build_problem's keywords that both packages share
    (est_focal, est_distortion, cam_constrained, cam_constraints,
    cam_weights, pt_constrained, pt_constraints, pt_weight), and
    `schur_plan`: a `plan_schur_windows` result of either package for
    these points, which the JAX package applies by laying pts0 out at
    row_of and remapping obs_pt (`benchmarks/ba_vs_sba.py::run_ours`) and
    the port carries beside points in input order."""
    return build_problem(R0, cam0, pts0, obs_cam, obs_pt, obs_xy,
                         device=device, **options)

"""State carried across from the JAX package.

The system has no weights: its state is the configuration, the per-image
keypoint tables and the match dictionary.  These helpers build the port's
objects from plain Python / numpy state (for example
`dataclasses.asdict(jax_config)` and the JAX package's scene fields), so
both packages can be handed the same inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

from bundler_sfm_tpu_torch.config import BundlerConfig
from bundler_sfm_tpu_torch.io.listfile import ImageEntry
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

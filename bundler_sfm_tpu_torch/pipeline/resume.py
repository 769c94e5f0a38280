"""Resume / extend an existing reconstruction — port of
`bundler_sfm_tpu/pipeline/resume.py`.

`resume_from_bundle` rebuilds the reconstruction state from a loaded bundle
file — the role of `InitializeBundleAdjust` (`src/Bundle.cpp:989-1108`, used
by `--bundle file` + `--rerun_bundle`/`--add_images`,
`src/BundlerApp.cpp:839-853, 996-1021`); `continue_reconstruction` runs the
incremental loop on from it.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from bundler_sfm_tpu_torch.io.bundlefile import BundleFile
from bundler_sfm_tpu_torch.pipeline import incremental as inc
from bundler_sfm_tpu_torch.pipeline.incremental import Reconstruction, log
from bundler_sfm_tpu_torch.pipeline.scene import Scene
from bundler_sfm_tpu_torch.utils import resolve_device


def resume_from_bundle(scene: Scene, bundle: BundleFile) -> Reconstruction:
    """Rebuild a Reconstruction from a BundleFile against `scene`'s tracks.

    Needs scene.key_track (geometric constraints computed or loaded) to
    re-link existing points to tracks; a view whose (image, key) no longer
    maps to a track keeps its observation but no track link."""
    added_order = [i for i, c in enumerate(bundle.cameras) if c.registered]
    slot_of_img = {img: s for s, img in enumerate(added_order)}
    cam_R: List[np.ndarray] = []
    cam_params: List[np.ndarray] = []
    for img in added_order:
        cam = bundle.cameras[img]
        cam_R.append(cam.R.copy())
        cam_params.append(np.concatenate([
            cam.center, np.zeros(3), [cam.f], [cam.k1], [cam.k2]]))
    recon = Reconstruction(
        added_order=added_order, cam_R=cam_R, cam_params=cam_params,
        points=[], colors=[], pt_views=[],
        track_extra=np.full(len(scene.tracks), -1, dtype=np.int64),
        key_extra=[dict() for _ in range(scene.num_images)])
    n_linked = 0
    for p in bundle.points:
        pt_idx = len(recon.points)
        recon.points.append(p.pos.copy())
        recon.colors.append(p.color.copy())
        views = []
        for v in p.views:
            img, key = int(v[0]), int(v[1])
            slot = slot_of_img.get(img)
            if slot is None:
                continue
            views.append((slot, key))
            recon.key_extra[img][key] = pt_idx
            tr = scene.key_track[img].get(key) if scene.key_track else None
            if tr is not None:
                recon.track_extra[tr] = pt_idx
                n_linked += 1
        recon.pt_views.append(views)
    log(f"[InitializeBundleAdjust] Resumed {len(added_order)} cameras, "
        f"{len(recon.points)} points ({n_linked} track links)")
    return recon


def continue_reconstruction(scene: Scene, recon: Reconstruction,
                            out_dir: Optional[str] = None, seed: int = 0,
                            sampler: Callable = None) -> Reconstruction:
    """Continue the incremental loop from a resumed state (the
    num_init_cams > 0 branch of BundleAdjustFast, `src/BundleFast.cpp:
    236-260`): each round's candidates register one at a time (the
    "resection_one" draw from seed + 31·image), then points are added and
    the scene re-bundled, on `scene.device`."""
    cfg = scene.config
    sampler = sampler or inc.StageSampler(resolve_device(scene.device))
    while recon.num_cameras < scene.num_images:
        counts = inc.find_candidate_images(recon, scene)
        if not counts:
            break
        max_matches = max(counts.values())
        if max_matches < cfg.min_max_matches:
            break
        n_needed = int(round(0.75 * max_matches))
        if cfg.num_matches_add_camera > 0:
            n_needed = min(n_needed, cfg.num_matches_add_camera)
        added_any = False
        for img in [i for i, c in counts.items() if c >= n_needed]:
            if inc.bundle_initialize_image(
                    recon, scene, img, recon.num_cameras,
                    seed=seed + inc.SLOW_SEED_STRIDE * img, sampler=sampler):
                added_any = True
            else:
                scene.ignore_in_bundle[img] = True
        if not added_any:
            continue
        if not cfg.skip_add_points:
            inc.add_all_new_points(recon, scene)
        if not cfg.skip_full_bundle:
            inc.run_sfm(recon, scene)
            inc.remove_bad_points(recon, scene)
        if out_dir:
            inc.dump_round(recon, scene, out_dir, recon.num_cameras)
    return recon

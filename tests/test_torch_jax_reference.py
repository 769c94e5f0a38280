"""The JAX package's reconstruction of a scene the port verified — the
CPU reference that `chip_smoke.py` holds the port's camera count to.

    python3 chip_smoke.py --dump-scene scene.pkl          # on the card
    JAX_PLATFORMS=cpu python -m tests.test_torch_jax_reference \\
        scene.pkl OUT_DIR build/smoke/images/gt.json      # on a CPU host

runs the JAX package's `bundle_adjust_fast` (f64, the JAX package's own
RANSAC draw, seed 0) on the dumped scene and prints the registered cameras,
points, mean reprojection error and the relative centre error against
gt.json, measured as `chip_smoke.py` measures the port's.  The test below
holds the loader: the JAX scene it builds equals the port scene dumped.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import json
import os
import pickle
import sys

import numpy as np

from bundler_sfm_tpu.config import default_pipeline_config
from bundler_sfm_tpu.io.listfile import ImageEntry
from bundler_sfm_tpu.pipeline.scene import Scene, TransformInfo


def jax_scene(state) -> Scene:
    """A JAX package Scene (default pipeline config) from the state that
    `chip_smoke.dump_scene` writes."""
    scene = Scene(config=default_pipeline_config(),
                  entries=[ImageEntry(*e) for e in state["entries"]],
                  dims=[tuple(d) for d in state["dims"]],
                  key_xy=state["key_xy"], key_color=state["key_color"])
    scene.transforms = {k: TransformInfo(num_inliers=n, inlier_ratio=r)
                        for k, (n, r) in state["transforms"].items()}
    scene.tracks = state["tracks"]
    scene.visible_points = state["visible_points"]
    scene.visible_keys = state["visible_keys"]
    scene.key_track = state["key_track"]
    return scene


def test_loader_rebuilds_the_dumped_scene(tmp_path):
    from bundler_sfm_tpu_torch.config import default_pipeline_config as cfg
    from bundler_sfm_tpu_torch.io.listfile import ImageEntry as PortEntry
    from bundler_sfm_tpu_torch.pipeline.scene import Scene as PortScene
    from bundler_sfm_tpu_torch.pipeline.scene import TransformInfo as PortTI
    import chip_smoke
    rng = np.random.default_rng(0)
    port = PortScene(config=cfg(), entries=[PortEntry(f"i{k}.jpg",
                                                      init_focal=700.0)
                                            for k in range(3)],
                     dims=[(640, 480)] * 3,
                     key_xy=[rng.normal(size=(20, 2)) for _ in range(3)],
                     device="cpu")
    port.transforms = {(0, 1): PortTI(num_inliers=12, inlier_ratio=0.4)}
    port.tracks = [[(0, 1), (1, 2)], [(1, 3), (2, 4), (0, 5)]]
    port.visible_points = [[0, 1], [0, 1], [1]]
    port.visible_keys = [[1, 5], [2, 3], [4]]
    port.key_track = [{1: 0, 5: 1}, {2: 0, 3: 1}, {4: 1}]
    path = str(tmp_path / "scene.pkl")
    chip_smoke.dump_scene(port, path)
    with open(path, "rb") as f:
        js = jax_scene(pickle.load(f))
    assert [e.init_focal for e in js.entries] == [700.0] * 3
    assert js.tracks == port.tracks and js.key_track == port.key_track
    assert js.visible_keys == port.visible_keys
    assert js.transforms[(0, 1)].inlier_ratio == 0.4
    for a, b in zip(js.key_xy, port.key_xy):
        np.testing.assert_array_equal(a, b)


def main(argv):
    from bundler_sfm_tpu.pipeline.incremental import bundle_adjust_fast
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import bundle_quality
    scene_path, out_dir, gt_path = argv
    with open(scene_path, "rb") as f:
        scene = jax_scene(pickle.load(f))
    bundle_adjust_fast(scene, out_dir=out_dir, seed=0)
    with open(gt_path) as f:
        gt = json.load(f)
    q = bundle_quality(os.path.join(out_dir, "bundle.out"), gt)
    print("[reference] JAX package, CPU: " + json.dumps(
        {k: v for k, v in q.items() if k != "centers"}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

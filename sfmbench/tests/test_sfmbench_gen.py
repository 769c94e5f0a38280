"""The frozen renderer against the program's, byte for byte (also in
worker processes), and the key file writer through the program's
reader."""

from __future__ import annotations

import numpy as np

from bundler_sfm_tpu_torch.io.keyfile import read_key_file
from bundler_sfm_tpu_torch.utils.render_scene import render_box_room

from sfmbench.gen import keys, room, views


def test_room_copy_renders_the_same_bytes(tmp_path):
    a = render_box_room(str(tmp_path / "a"), n=3, W=96, H=64, seed=5,
                        f=60.0, sheet_size=128)
    b = room.render_box_room(str(tmp_path / "b"), n=3, W=96, H=64, seed=5,
                             f=60.0, sheet_size=128)
    assert a == b
    for i in range(3):
        name = f"img{i:04d}.jpg"
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes()


def test_views_render_the_copy_in_worker_processes(tmp_path):
    config = {"width": 96, "height": 64, "focal": 60.0, "scene_seed": 5,
              "sheet_size": 128}
    gt = room.render_box_room(str(tmp_path / "a"), n=3, W=96, H=64, seed=5,
                              f=60.0, sheet_size=128)
    centers = views.render(config, 3, str(tmp_path / "b"))
    np.testing.assert_array_equal(centers, gt["centers"])
    for i in range(3):
        name = f"img{i:04d}.jpg"
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes()


def test_key_files_read_back(tmp_path):
    rng = np.random.default_rng(7)
    for k in range(3):
        info = np.column_stack([rng.uniform(0, 800, (200, 2)),
                                rng.uniform(1, 9, 200),
                                rng.uniform(-3, 3, 200)])
        desc = rng.integers(0, 256, (200, 128)).astype(np.uint8)
        path = str(tmp_path / f"{k}.key")
        keys.write_key_file(path, info, desc)
        got_info, got_desc = read_key_file(path)
        np.testing.assert_array_equal(got_desc, desc)
        np.testing.assert_allclose(got_info[:, :2], info[:, :2], atol=0.006)
